"""Single-buffer host->device wire (jsvx/pipeline/wire.py).

The compact GOP pytree has ~17 leaves; ``jax.device_put`` of the pytree
is one transfer per leaf, which on high-latency links costs a round trip
each.  The wire packs everything into ONE uint8 buffer (one transfer)
and rebuilds the pytree with static slices + bitcasts inside the decode
jit.  These tests pin exact round-tripping (every dtype the GOP uses,
including 0-d scalars), spec stability/hashability (the spec is a jit
static argument), and bit-equality of the wire decode path against the
per-leaf compact path.
"""

import numpy as np
import pytest

import jax

from jsvx.bitstream.native import get_native_parser
from jsvx.pipeline.wire import flatten_wire, unflatten_wire, wire_spec


def _tree(seed=0):
    r = np.random.default_rng(seed)
    return {
        "is_p": np.array([0, 1, 1], np.int32),
        "mv_table": r.integers(-512, 512, (3, 16, 2)).astype(np.int32),
        "mv_count": np.array([1, 5, 7], np.int32),
        "mb": {
            "q": r.integers(1, 32, (3, 4, 5)).astype(np.uint8),
            "mv": r.integers(-128, 128, (3, 4, 5, 2)).astype(np.int16),
        },
        "coef": {"y": {
            "cpk": r.integers(0, 1 << 16, (777,)).astype(np.uint16),
            "n": np.int32(431),                      # 0-d scalar leaf
            "counts": r.integers(0, 64, (3, 80)).astype(np.uint8),
        }},
    }


def _cmp(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _cmp(a[k], b[k], path + "/" + str(k))
    else:
        got = np.asarray(b)
        want = np.asarray(a)
        assert got.dtype == want.dtype, (path, got.dtype, want.dtype)
        assert got.shape == want.shape, (path, got.shape, want.shape)
        assert np.array_equal(want, got), path


def test_wire_round_trip_exact():
    tree = _tree()
    spec = wire_spec(tree)
    buf = flatten_wire(tree, spec)

    @jax.jit
    def rt(b):
        return unflatten_wire(b, spec)

    _cmp(tree, rt(jax.device_put(buf)))


def test_wire_spec_static_and_stable():
    s1, s2 = wire_spec(_tree(1)), wire_spec(_tree(2))
    assert s1 == s2                      # same layout -> same spec
    assert hash(s1) == hash(s2)          # usable as a jit static arg
    grown = _tree(1)
    grown["coef"]["y"]["cpk"] = np.zeros((1024,), np.uint16)
    assert wire_spec(grown) != s1        # bucket growth -> new spec


def test_wire_layout_change_is_loud():
    tree = _tree()
    spec = wire_spec(tree)
    tree["mb"]["q"] = tree["mb"]["q"].astype(np.int16)
    with pytest.raises(AssertionError, match="changed layout"):
        flatten_wire(tree, spec)


def test_wire_reuses_caller_buffer():
    tree = _tree()
    spec = wire_spec(tree)
    out = np.empty((spec[1],), np.uint8)
    assert flatten_wire(tree, spec, out=out) is out


@pytest.mark.skipif(get_native_parser() is None, reason="no C++ parser")
def test_wire_decode_matches_compact_decode():
    """decode_gop_scan_wire(flatten(gop)) == decode_gop_scan_compact(gop)
    bit-for-bit on a real encoded GOP."""
    from jsvx.kernels.decode import make_constants, mv_bucket
    from jsvx.pipeline.gop import (decode_gop_scan_compact,
                                   decode_gop_scan_wire, zero_refs)
    from jsvx.pipeline.packed_parse import (BufferPool, _mv_unique,
                                            parse_gop_compact, walk_stream)
    from jsvx.tools.encoder import EncoderConfig, JsvEncoder

    from conftest import synthetic_frames

    clip = synthetic_frames(4, 48, 64, seed=21)
    data = JsvEncoder(64, 48, EncoderConfig(
        gop_size=4, quantizer_scale=5, me_range=4,
        half_pel_refine=True)).encode(clip)
    arr = np.frombuffer(data, np.uint8)
    meta, seq, groups = walk_stream(data)
    consts = make_constants(seq)
    g = parse_gop_compact(arr, groups[0], seq, meta, BufferPool(), {}, 0)
    assert not g.dirty
    mb_mv = g.stacked["mb"]["mv"]
    n = mb_mv.shape[0]
    cap = mv_bucket(max(len(_mv_unique(mb_mv[i])[0]) + 1
                        for i in range(n)))
    tables = np.zeros((n, cap, 2), np.int32)
    counts = np.zeros((n,), np.int32)
    mv_idx = np.zeros(mb_mv.shape[:3], np.int16)
    for i in range(n):
        uniq, inv = _mv_unique(mb_mv[i])
        tables[i, :len(uniq)] = uniq
        counts[i] = len(uniq)
        mv_idx[i] = inv.reshape(mb_mv.shape[1:3]).astype(np.int16)
    g.stacked["mv_table"] = tables
    g.stacked["mv_count"] = counts
    g.stacked["mb"]["mv_idx"] = mv_idx

    refs = zero_refs(seq.coded_height, seq.coded_width)
    old, _ = decode_gop_scan_compact(
        jax.device_put(g.stacked), refs, consts, seq.mb_height,
        seq.mb_width, mc_impl="mvset")
    spec = wire_spec(g.stacked)
    new, _ = decode_gop_scan_wire(
        jax.device_put(flatten_wire(g.stacked, spec)), spec, refs, consts,
        seq.mb_height, seq.mb_width, mc_impl="mvset")
    for a, b in zip(old, new):
        assert np.array_equal(np.asarray(a), np.asarray(b))
