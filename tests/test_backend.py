"""The one backend decision, what routes through it, and the settings
that keep the GPU path's numbers and builds honest: pinned matmul
precision, the compile-cache rule, the native library key, and entry
points that refuse to run without a GPU."""

import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jsvx.pipeline import gop
from jsvx.tools.encoder import EncoderConfig, JsvEncoder

from conftest import synthetic_frames

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def two_gop_stream():
    """8 frames of 64x96, GOP 4, half-pel motion search."""
    clip = synthetic_frames(8, 64, 96, seed=21)
    return JsvEncoder(96, 64, EncoderConfig(
        gop_size=4, quantizer_scale=6, me_range=4,
        half_pel_refine=True)).encode(clip)


# ---------------------------------------------------------------------------
# decode_backend

@pytest.mark.parametrize("platform,expected", [
    ("cpu", "mvset"),
    ("gpu", "gather"),
    ("tpu", None),
])
def test_decode_backend_per_platform(monkeypatch, platform, expected):
    monkeypatch.setattr(gop.jax, "devices",
                        lambda *a: [types.SimpleNamespace(platform=platform)])
    if expected is None:
        with pytest.raises(ValueError, match=repr(platform)):
            gop.decode_backend()
    else:
        assert gop.decode_backend() == expected
        assert gop.decode_backend(platform) == expected


def _call_transcode(data, tmp_path):
    from jsvx.pipeline.transcode import transcode

    transcode(data)


def _call_decoder(use_gop_scan):
    def call(data, tmp_path):
        from jsvx.api import Decoder, PlayerConfig

        dec = Decoder(PlayerConfig(use_gop_scan=use_gop_scan))
        dec.feed(0, data, len(data))
        dec.decode_frame()
    return call


def _call_stream_decoder(data, tmp_path):
    from jsvx.pipeline.stream import JaxStreamDecoder

    JaxStreamDecoder(data).decode()


def _call_cli_decode(data, tmp_path):
    from jsvx.__main__ import main as cli_main

    path = str(tmp_path / "clip.jsv")
    open(path, "wb").write(data)
    cli_main(["decode", path, str(tmp_path / "out")])


def _gops(data):
    import bench

    gops, seq, _ = bench.load_fixture_gops(data, mv_capacity=0)
    from jsvx.kernels.decode import make_constants

    return gops, seq, make_constants(seq)


def _call_gop_scan(data, tmp_path):
    gops, seq, consts = _gops(data)
    gop.decode_gop_scan(gops[0], gop.zero_refs(seq.coded_height,
                                                seq.coded_width), consts)


def _call_gops_parallel(data, tmp_path):
    from jsvx.shard import build_mesh, decode_gops_parallel

    gops, seq, consts = _gops(data)
    batch = jax.tree.map(lambda *xs: np.stack(xs), *gops)
    decode_gops_parallel(batch, seq.coded_height, seq.coded_width, consts,
                         build_mesh({"gop": 2}, devices=jax.devices()[:2]))


def _call_rows_sharded(data, tmp_path):
    from jsvx.shard import build_mesh, decode_gop_rows_sharded

    gops, seq, consts = _gops(data)
    decode_gop_rows_sharded(
        gops[0], gop.zero_refs(seq.coded_height, seq.coded_width), consts,
        build_mesh({"rows": 2}, devices=jax.devices()[:2]), halo_y=16)


@pytest.mark.parametrize("call", [
    _call_transcode, _call_decoder(True), _call_decoder(False),
    _call_stream_decoder, _call_cli_decode, _call_gop_scan,
    _call_gops_parallel, _call_rows_sharded,
], ids=["transcode", "decoder_gop_batch", "decoder_per_frame",
        "stream_decoder", "cli_decode", "gop_scan", "gops_parallel",
        "rows_sharded"])
def test_callers_route_through_decode_backend(monkeypatch, tmp_path,
                                              two_gop_stream, call):
    """With no backend for the platform every entry point refuses,
    naming the platform: none of them picks kernels on its own."""
    monkeypatch.setattr(gop, "BACKENDS", {})
    with pytest.raises(ValueError, match="'cpu'"):
        call(two_gop_stream, tmp_path)


# ---------------------------------------------------------------------------
# precision

def _dot_precisions(fn, *args):
    jaxpr = jax.make_jaxpr(fn)(*args)
    out = []

    def walk(jp):
        for eqn in jp.eqns:
            if eqn.primitive.name == "dot_general":
                out.append(eqn.params["precision"])
            for sub in jax.core.jaxprs_in_params(eqn.params):
                walk(sub)

    walk(jaxpr.jaxpr)
    return out


@pytest.mark.parametrize("which", ["idct_plane", "ycbcr_to_rgb_jax"])
def test_f32_products_pin_highest_precision(which):
    from jsvx.kernels.color import ycbcr_to_rgb_jax
    from jsvx.kernels.decode import idct_plane, make_constants

    if which == "idct_plane":
        consts = make_constants()
        precs = _dot_precisions(lambda d: idct_plane(d, consts),
                                jnp.zeros((16, 16), jnp.float32))
    else:
        y = jnp.zeros((16, 16), jnp.uint8)
        c = jnp.zeros((8, 8), jnp.uint8)
        precs = _dot_precisions(ycbcr_to_rgb_jax, y, c, c)
    hi = jax.lax.Precision.HIGHEST
    assert precs and all(p == (hi, hi) for p in precs), precs


# ---------------------------------------------------------------------------
# compile cache

@pytest.mark.parametrize("env", [None, "custom"])
def test_compile_cache_dir_rule(monkeypatch, tmp_path, env):
    from jsvx.runtime.compile_cache import CHECKOUT, compile_cache_dir

    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert compile_cache_dir() == os.path.join(CHECKOUT, ".jax_cache")
        assert CHECKOUT == REPO
    else:
        want = str(tmp_path / env)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
        assert compile_cache_dir() == want


# ---------------------------------------------------------------------------
# native parser library key

@pytest.mark.parametrize("change", ["source", "flags", "host_cpu"])
def test_native_library_name_keys_source_flags_and_cpu(monkeypatch,
                                                       change):
    from jsvx.bitstream import native

    src = open(native._SRC, "rb").read()
    base = native.library_path(src)
    assert base == native.library_path(src)
    if change == "source":
        other = native.library_path(src + b"\n// edit\n")
    elif change == "flags":
        monkeypatch.setattr(native, "_FLAGS", native._FLAGS + ("-g",))
        other = native.library_path(src)
    else:
        monkeypatch.setattr(native, "_host_cpu", lambda: "another cpu")
        other = native.library_path(src)
    assert other != base
    assert os.path.dirname(other) == os.path.dirname(base)


def test_native_parser_loads_the_keyed_library():
    from jsvx.bitstream import native

    if native.get_native_parser() is None:
        pytest.skip("no C++ compiler")
    so = native.library_path(open(native._SRC, "rb").read())
    assert os.path.exists(so)
    assert native._lib._name == so


# ---------------------------------------------------------------------------
# chip_smoke.py: the --four phase on virtual devices; refusals on the CPU

def test_chip_smoke_multi_device_on_four_cpu_devices(two_gop_stream):
    import chip_smoke

    res = chip_smoke.multi_device(two_gop_stream, jax.devices()[:4])
    assert res["devices"] == 4 and res["gops"] == 2
    assert res["gop_rows_2d_bit_equal"] and res["gop_parallel_bit_equal"]


@pytest.mark.parametrize("script,bare", [
    ("chip_smoke.py", False), ("chip_smoke.py", True), ("bench.py", False),
])
def test_entry_points_refuse_without_gpu(tmp_path, script, bare):
    """No GPU (or no checkout around chip_smoke.py): non-zero exit and
    no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    if bare:
        import shutil

        shutil.copy(os.path.join(REPO, script), tmp_path)
        cwd, env["PYTHONPATH"] = str(tmp_path), ""
    else:
        cwd = REPO
    p = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout and '"value"' not in p.stdout


@pytest.mark.gpu
def test_gpu_decode_matches_oracle_on_the_card():
    """The 96x128 gate stream and a 1920x1088 synthetic P frame decode on
    the card within 1 LSB of the float64 oracle (chip_smoke's phase 4)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (JSVX_TEST_ON_GPU=1 pytest -m gpu)")
    import chip_smoke

    chip_smoke.correctness("gate 96x128",
                           *chip_smoke.stream_frames(chip_smoke.gate_stream()))
    chip_smoke.correctness("synthetic P 1920x1088",
                           *chip_smoke.synthetic_p_frame())
