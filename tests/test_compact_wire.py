"""Compact coefficient wire format: parse, device expansion, fallback.

The compact wire (``jsvx/kernels/expand.py`` +
``jsv_parse_picture_slices_compact`` in ``jsvx/native/jsv_parse.cc``)
ships one uint16 per *coded* coefficient instead of dense int16 planes;
the dense planes are reconstituted on device by one scatter.  These
tests pin bit-exactness against the dense path (the round-1/2 wire) at
the plane level and end-to-end, for 3- and 4-component streams, with
slice/frame threading, and for the corrupt-stream fallback.  The
reference uploads dense coefficient textures per picture
(``decoders/jsv.js:1206-1243``); the compact wire is an improvement on
it.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from jsvx.bitstream.native import get_native_parser
from jsvx.coding import tables as T
from jsvx.kernels.decode import COMP_KEYS
from jsvx.kernels.expand import expand_compact_gop, expand_levels
from jsvx.pipeline.packed_parse import (BufferPool, coef_bucket,
                                        parse_gop_compact, parse_gop_packed,
                                        walk_stream)
from jsvx.pipeline.transcode import _transcode_packed, transcode
from jsvx.runtime.profiler import Metrics
from jsvx.tools.encoder import EncoderConfig, JsvEncoder

from conftest import synthetic_frames, synthetic_frames_yuva

pytestmark = pytest.mark.skipif(get_native_parser() is None,
                                reason="no C++ parser")


def _encode(clip, **kw):
    h, w = clip[0][0].shape
    return JsvEncoder(w, h, EncoderConfig(**kw)).encode(clip)


def _dense_valid_mask(lnz: np.ndarray, luma_like: bool) -> np.ndarray:
    """(n, Hb, Wb) lnz -> (n, H, W) bool: True where the pooled dense
    plane holds defined data (block coded AND scan pos < lnz)."""
    zz_inv = T.ZIG_ZAG_INVERSE.reshape(8, 8)      # spatial -> scan pos
    n, hb, wb = lnz.shape
    scan = np.tile(zz_inv, (hb, wb))               # (H, W)
    per_block = np.repeat(np.repeat(lnz, 8, axis=1), 8, axis=2)
    return scan[None] < per_block


def _assert_planes_match(dense_gop, compact_gop, mb_h, mb_w, n_comps):
    expanded = expand_compact_gop(compact_gop.stacked, mb_h, mb_w)
    for c in range(n_comps):
        key = COMP_KEYS[c]
        exp = np.asarray(expanded[key]["levels"])
        ref = np.asarray(dense_gop.stacked[key]["levels"])
        mask = _dense_valid_mask(dense_gop.stacked[key]["lnz"],
                                 key in ("y", "a"))
        assert np.array_equal(exp[mask], ref[mask]), key
        # outside the coded region the expansion must be true zeros
        assert not exp[~mask].any(), key


@pytest.mark.parametrize("yuva", [False, True])
@pytest.mark.parametrize("slice_threads", [1, 2])
def test_compact_parse_matches_dense(yuva, slice_threads):
    clip = (synthetic_frames_yuva if yuva else synthetic_frames)(8, 64, 96,
                                                                 seed=11)
    data = _encode(clip, gop_size=4, quantizer_scale=5, me_range=6,
                   half_pel_refine=True)
    arr = np.frombuffer(data, np.uint8)
    meta, seq, groups = walk_stream(data)
    pool = BufferPool()
    buckets = {}
    for gi, group in enumerate(groups):
        dense = parse_gop_packed(arr, group, seq, meta, 0, pool=pool)
        comp = parse_gop_compact(arr, group, seq, meta, pool, buckets,
                                 slice_threads=slice_threads, index=gi)
        assert not comp.dirty
        _assert_planes_match(dense, comp, seq.mb_height, seq.mb_width,
                             meta.n_components)
        # sideband identical to the dense path's per-MB source arrays
        for i, ft in enumerate(dense.fts):
            assert np.array_equal(comp.stacked["mb"]["mv"][i], ft.mb_mv)
            assert np.array_equal(comp.stacked["mb"]["q"][i], ft.mb_quant)


def test_compact_wire_is_smaller_than_dense():
    clip = synthetic_frames(8, 128, 160, seed=2)
    data = _encode(clip, gop_size=8, quantizer_scale=8, me_range=6)
    arr = np.frombuffer(data, np.uint8)
    meta, seq, groups = walk_stream(data)
    comp = parse_gop_compact(arr, groups[0], seq, meta, BufferPool(), {})
    dense_bytes = 8 * (seq.coded_height * seq.coded_width * 3 // 2) * 2
    assert 0 < comp.wire_bytes < dense_bytes


def test_coef_bucket_monotone_low_waste():
    assert coef_bucket(1) == 1 << 14
    assert coef_bucket(1 << 14) == 1 << 14
    prev = 0
    for n in (3, 20000, 100000, 2_703_902, 9_000_000):
        b = coef_bucket(n)
        assert b >= n and b % 8192 == 0
        assert b >= prev                      # monotone in n
        prev = b
        if n > 1 << 14:
            # padding waste is bounded by the 1.25x step (+ alignment)
            assert b <= n * 5 // 4 + 8192, (n, b)


def test_expand_levels_padding_is_dropped():
    # entries past n_coef scatter into the sacrificial slot, not planes
    counts = np.zeros((1, 4), np.uint8)
    counts[0, 0] = 1
    zz = int(T.ZIG_ZAG[5])                 # wire carries SPATIAL positions
    cpk = np.full((8,), (zz << 10) | (7 + 512), np.uint16)
    out = np.asarray(expand_levels(jnp.asarray(cpk), jnp.int32(1),
                                   jnp.asarray(counts), 1, 1, True))
    assert out.shape == (1, 16, 16)
    assert out[0, zz >> 3, zz & 7] == 7
    assert out.sum() == 7                      # exactly one write


@pytest.mark.parametrize("yuva", [False, True])
def test_transcode_compact_equals_dense_end_to_end(yuva):
    clip = (synthetic_frames_yuva if yuva else synthetic_frames)(10, 64, 96,
                                                                 seed=5)
    data = _encode(clip, gop_size=5, quantizer_scale=6, me_range=8,
                   half_pel_refine=True)
    got_c, got_d = {}, {}
    rc = transcode(data, lambda g, o: got_c.__setitem__(
        g, [np.asarray(x) for x in o]))
    rd = _transcode_packed(data, lambda g, o: got_d.__setitem__(
        g, [np.asarray(x) for x in o]), mc_impl="mvset",
        manifest=None,
        process_id=0, process_count=1, n_parse_threads=2,
        quirk_oddify_zeros=False, metrics=Metrics())
    assert rc.n_frames == rd.n_frames == 10
    assert rc.metrics.gauges.get("wire_bytes", 0) > 0
    for g in got_d:
        for a, b in zip(got_c[g], got_d[g]):
            assert np.array_equal(a, b)


def test_transcode_quirk_uses_dense_path():
    # the oddify-zeros quirk oddifies positions the compact wire elides;
    # transcode must route quirk runs through the dense wire
    clip = synthetic_frames(4, 48, 64, seed=9)
    data = _encode(clip, gop_size=4, quantizer_scale=4)
    got = {}
    r = transcode(data, lambda g, o: got.__setitem__(g, o),
                  quirk_oddify_zeros=True)
    assert r.n_frames == 4 and got


def _duplicate_first_slice(data: bytes) -> bytes:
    """Duplicate the first slice of the first picture (a legal-looking
    but overlapping stream: the same MBs are emitted twice)."""
    raw = bytes(data)
    # first slice start code (0x01..0xAF) after the first picture header
    pic = raw.find(b"\x00\x00\x01\x00")
    assert pic >= 0
    s0 = raw.find(b"\x00\x00\x01\x01", pic)
    assert s0 > 0
    nxt = s0 + 4
    while True:
        n = raw.find(b"\x00\x00\x01", nxt)
        assert n > 0
        if 0x01 <= raw[n + 3] <= 0xAF or raw[n + 3] in (0x00, 0xB8):
            break
        nxt = n + 4
    return raw[:n] + raw[s0:n] + raw[n:]


def test_dirty_stream_falls_back_to_dense():
    clip = synthetic_frames(3, 48, 64, seed=13)
    data = _duplicate_first_slice(_encode(clip, gop_size=3,
                                          quantizer_scale=4))
    arr = np.frombuffer(data, np.uint8)
    meta, seq, groups = walk_stream(data)
    comp = parse_gop_compact(arr, groups[0], seq, meta, BufferPool(), {})
    assert comp.dirty
    # transcode still completes via the per-GOP dense fallback and
    # agrees with the dense path bit for bit
    got_c, got_d = {}, {}
    transcode(data, lambda g, o: got_c.__setitem__(
        g, [np.asarray(x) for x in o]))
    _transcode_packed(data, lambda g, o: got_d.__setitem__(
        g, [np.asarray(x) for x in o]), mc_impl="mvset",
        manifest=None,
        process_id=0, process_count=1, n_parse_threads=1,
        quirk_oddify_zeros=False, metrics=Metrics())
    for g in got_d:
        for a, b in zip(got_c[g], got_d[g]):
            assert np.array_equal(a, b)
