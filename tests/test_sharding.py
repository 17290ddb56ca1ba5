"""Multi-chip decode tests on the virtual 8-device CPU mesh.

Slice-row sharding with halo exchange and GOP-parallel sharding must be
bit-identical to the single-device decode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jsvx.kernels.decode import frame_to_device, make_constants
from jsvx.pipeline.gop import decode_gop_scan, stack_device_frames, zero_refs
from jsvx.shard import (build_mesh, decode_gop_rows_sharded,
                        decode_gops_parallel, exchange_row_halo)
from jsvx.tools.encoder import EncoderConfig, JsvEncoder

from conftest import synthetic_frames


@pytest.fixture(scope="module")
def tall_stream():
    """128x64 clip (8 MB rows) with motion, 2 GOPs of 3 frames."""
    clip = synthetic_frames(6, 128, 64, seed=11)
    data = JsvEncoder(64, 128, EncoderConfig(
        gop_size=3, quantizer_scale=4, me_range=4)).encode(clip)
    return data, clip


def _parse_stream(data):
    from jsvx.pipeline.stream import JaxStreamDecoder
    d = JaxStreamDecoder(data)
    fts = d.parse_all()
    return fts, d.parser.seq


def test_mesh_builder():
    mesh = build_mesh({"gop": 2, "rows": 4})
    assert mesh.devices.shape == (2, 4)
    assert mesh.axis_names == ("gop", "rows")
    with pytest.raises(ValueError):
        build_mesh({"gop": 16})


def test_exchange_row_halo():
    mesh = build_mesh({"rows": 4})
    h_local, w, halo = 8, 16, 2
    full = np.arange(4 * h_local * w, dtype=np.int32).reshape(4 * h_local, w)

    @jax.jit
    def run(x):
        return jax.shard_map(
            lambda lx: exchange_row_halo(lx, halo, "rows"),
            mesh=mesh,
            in_specs=jax.sharding.PartitionSpec("rows", None),
            out_specs=jax.sharding.PartitionSpec("rows", None),
            check_vma=False)(x)

    ext = np.asarray(run(full)).reshape(4, h_local + 2 * halo, w)
    for dev in range(4):
        lo = dev * h_local
        # interior halo rows must match global neighbours
        if dev > 0:
            assert np.array_equal(ext[dev][:halo], full[lo - halo:lo])
        if dev < 3:
            assert np.array_equal(ext[dev][-halo:],
                                  full[lo + h_local:lo + h_local + halo])
        assert np.array_equal(ext[dev][halo:halo + h_local],
                              full[lo:lo + h_local])


def test_slice_row_sharded_equals_single_device(tall_stream):
    data, _ = tall_stream
    fts, seq = _parse_stream(data)
    consts = make_constants(seq)
    gop = fts[:3]
    stacked = stack_device_frames([frame_to_device(ft) for ft in gop])
    refs0 = zero_refs(seq.coded_height, seq.coded_width)

    single, _ = decode_gop_scan(stacked, refs0, consts)

    mesh = build_mesh({"rows": 4})
    sharded, final = decode_gop_rows_sharded(
        stacked, refs0, consts, mesh, halo_y=32)
    for a, b in zip(single, sharded):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_slice_row_sharded_8way(tall_stream):
    data, _ = tall_stream
    fts, seq = _parse_stream(data)
    consts = make_constants(seq)
    stacked = stack_device_frames([frame_to_device(ft) for ft in fts[:3]])
    refs0 = zero_refs(seq.coded_height, seq.coded_width)
    single, _ = decode_gop_scan(stacked, refs0, consts)
    mesh = build_mesh({"rows": 8})
    sharded, _ = decode_gop_rows_sharded(
        stacked, refs0, consts, mesh, halo_y=8)
    # halo 8 covers the f_code=3 (f=4 -> |fy|<=31/2... ) small search range
    # used by the fixture (me_range=4 full-pel -> |fy| <= 5)
    for a, b in zip(single, sharded):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_gop_parallel_equals_sequential(tall_stream):
    data, _ = tall_stream
    fts, seq = _parse_stream(data)
    consts = make_constants(seq)
    gops = [fts[:3], fts[3:]]
    # sequential per-GOP decode
    want = []
    for gop in gops:
        stacked = stack_device_frames([frame_to_device(ft) for ft in gop])
        outs, _ = decode_gop_scan(
            stacked, zero_refs(seq.coded_height, seq.coded_width), consts)
        want.append(outs)

    batch = jax.tree.map(
        lambda *xs: np.stack(xs),
        *[stack_device_frames([frame_to_device(ft) for ft in gop])
          for gop in gops])
    mesh = build_mesh({"gop": 2})
    outs, _ = decode_gops_parallel(batch, seq.coded_height, seq.coded_width,
                                   consts, mesh)
    for g in range(2):
        for comp in range(3):
            assert np.array_equal(np.asarray(outs[comp][g]),
                                  np.asarray(want[g][comp]))


def test_two_axis_mesh_gop_and_rows(tall_stream):
    """dp (gop) x sp (rows) on one 2x4 mesh: both axes at once."""
    data, _ = tall_stream
    fts, seq = _parse_stream(data)
    consts = make_constants(seq)
    gops = [fts[:3], fts[3:]]
    stacks = [stack_device_frames([frame_to_device(ft) for ft in gop])
              for gop in gops]
    singles = [decode_gop_scan(
        s, zero_refs(seq.coded_height, seq.coded_width), consts)[0]
        for s in stacks]

    mesh = build_mesh({"gop": 2, "rows": 4})
    refs0 = zero_refs(seq.coded_height, seq.coded_width)
    outs = []
    for g, stacked in enumerate(stacks):
        with jax.sharding.set_mesh(mesh):
            sharded, _ = decode_gop_rows_sharded(
                stacked, refs0, consts, mesh, halo_y=32)
        outs.append(sharded)
    for got, want in zip(outs, singles):
        for a, b in zip(want, got):
            assert np.array_equal(np.asarray(a), np.asarray(b))


def test_derived_halo_and_allgather_fallback():
    """f_code=3 motion large enough to corrupt under halo_y=16 decodes
    bit-exactly via the automatic f_code-derived halo, which exceeds the
    local shard height and engages the all-gather fallback."""
    from jsvx.kernels.decode import mv_bucket
    from jsvx.shard.slice_rows import derive_halo_y, halo_for_f_code

    clip = synthetic_frames(3, 128, 64, seed=23)
    # big vertical shifts between frames -> large real MVs
    rolled = [tuple(np.roll(p, 20 * t, axis=0) for p in f)
              for t, f in enumerate(clip)]
    data = JsvEncoder(64, 128, EncoderConfig(
        gop_size=3, quantizer_scale=4, me_range=24, f_code=3)).encode(rolled)
    fts, seq = _parse_stream(data)
    assert max(ft.f_code for ft in fts) == 3
    # full-pel vertical displacement beyond a 16-row halo
    assert max(abs(int(v)) >> 1 for ft in fts
               for v in ft.mb_mv.reshape(-1)) > 16
    cap = mv_bucket(max(
        len(np.unique(ft.mb_mv.reshape(-1, 2), axis=0)) + 1 for ft in fts))
    consts = make_constants(seq)
    stacked = stack_device_frames(
        [frame_to_device(ft, mv_capacity=cap) for ft in fts])
    refs0 = zero_refs(seq.coded_height, seq.coded_width)
    single, _ = decode_gop_scan(stacked, refs0, consts, mc_impl="mvset")

    assert derive_halo_y(stacked) == halo_for_f_code(3) == 48
    mesh = build_mesh({"rows": 4})           # h_local = 32 < halo 48
    for mc in ("mvset", "gather"):
        sharded, _ = decode_gop_rows_sharded(
            stacked, refs0, consts, mesh, mc_impl=mc)   # halo derived
        for a, b in zip(single, sharded):
            assert np.array_equal(np.asarray(a), np.asarray(b)), mc

    # an under-sized explicit halo really does corrupt this stream
    # (the scenario automatic derivation protects against)
    bad, _ = decode_gop_rows_sharded(
        stacked, refs0, consts, mesh, halo_y=16, mc_impl="mvset")
    assert any(not np.array_equal(np.asarray(a), np.asarray(b))
               for a, b in zip(single, bad))


def test_slice_row_sharded_mvset_mc(tall_stream):
    """mvset MC on halo-extended shards and gather MC with global
    clamping both == the single-device decode."""
    from jsvx.kernels.decode import mv_bucket

    data, _ = tall_stream
    fts, seq = _parse_stream(data)
    consts = make_constants(seq)
    cap = 1
    for ft in fts[:3]:
        cap = max(cap, len(np.unique(ft.mb_mv.reshape(-1, 2), axis=0)) + 1)
    cap = mv_bucket(cap)
    stacked = stack_device_frames(
        [frame_to_device(ft, mv_capacity=cap) for ft in fts[:3]])
    refs0 = zero_refs(seq.coded_height, seq.coded_width)
    single, _ = decode_gop_scan(stacked, refs0, consts, mc_impl="mvset")
    mesh = build_mesh({"rows": 4})
    for mc in ("mvset", "gather"):
        sharded, _ = decode_gop_rows_sharded(
            stacked, refs0, consts, mesh, halo_y=32, mc_impl=mc)
        for a, b in zip(single, sharded):
            assert np.array_equal(np.asarray(a), np.asarray(b)), mc


# ---------------------------------------------------------------------------
# 1080p-shape sharded decode: the sharded path at the product shape.


def _1080p_gop(n_frames=2, max_mv=20, mv_capacity=8, seed=40):
    from __graft_entry__ import _synthetic_frame_inputs

    frames = [_synthetic_frame_inputs(68, 120, is_p=(i > 0),
                                      seed=seed + i, max_mv=max_mv,
                                      mv_capacity=mv_capacity)
              for i in range(n_frames)]
    return stack_device_frames(frames)


def test_1080p_rows_sharded_mvset_bit_equal():
    """1920x1088 GOP row-sharded over 4 devices == single-device scan,
    bit-exactly (halo derived from f_code)."""
    stacked = _1080p_gop()
    consts = make_constants()
    refs0 = zero_refs(1088, 1920)
    single, _ = decode_gop_scan(stacked, refs0, consts, mc_impl="mvset")
    mesh = build_mesh({"rows": 4})
    sharded, _ = decode_gop_rows_sharded(stacked, refs0, consts, mesh,
                                         mc_impl="mvset")
    for a, b in zip(single, sharded):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_1080p_rows_sharded_gather_fallback():
    """Motion range beyond the 272-row local shard (f_code=6 -> halo 272
    >= h_local) engages gather_row_halo at 1080p shape; still bit-exact."""
    from jsvx.shard.slice_rows import derive_halo_y

    stacked = _1080p_gop(max_mv=200, mv_capacity=8, seed=60)
    assert int(np.asarray(stacked["f_code"]).max()) >= 6
    halo = derive_halo_y(stacked)
    assert halo >= 1088 // 4, "fixture must force the all-gather fallback"
    consts = make_constants()
    refs0 = zero_refs(1088, 1920)
    single, _ = decode_gop_scan(stacked, refs0, consts, mc_impl="mvset")
    mesh = build_mesh({"rows": 4})
    sharded, _ = decode_gop_rows_sharded(stacked, refs0, consts, mesh,
                                         mc_impl="mvset")
    for a, b in zip(single, sharded):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_yuva_rows_sharded():
    """4-component (YUVA) GOP row-sharded == single-device scan."""
    from conftest import synthetic_frames_yuva

    clip = synthetic_frames_yuva(3, 128, 64, seed=31)
    data = JsvEncoder(64, 128, EncoderConfig(
        gop_size=3, quantizer_scale=4, me_range=4)).encode(clip)
    fts, seq = _parse_stream(data)
    assert fts[0].n_comps == 4
    consts = make_constants(seq)
    stacked = stack_device_frames([frame_to_device(ft) for ft in fts])
    refs0 = zero_refs(seq.coded_height, seq.coded_width, n_comps=4)
    single, _ = decode_gop_scan(stacked, refs0, consts)
    mesh = build_mesh({"rows": 4})
    sharded, _ = decode_gop_rows_sharded(stacked, refs0, consts, mesh,
                                         halo_y=32)
    assert len(sharded) == 4
    for a, b in zip(single, sharded):
        assert np.array_equal(np.asarray(a), np.asarray(b))
