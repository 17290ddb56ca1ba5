"""MC formulations and the fused GPU kernel vs the spec paths (CPU,
Pallas interpret mode)."""

import numpy as np

import jax.numpy as jnp

from jsvx.kernels.decode import (decode_frame_planes, frame_to_device,
                                 make_constants, mv_bucket,
                                 predict_plane, predict_plane_mvset)
from jsvx.tools.encoder import EncoderConfig, JsvEncoder
from jsvx.tools.oracle import reconstruct_frame

from conftest import synthetic_frames
from test_kernels import _walk


def _stream_frames(clip, **cfg):
    h, w = clip[0][0].shape
    data = JsvEncoder(w, h, EncoderConfig(**cfg)).encode(clip)
    return list(_walk(data))


def test_mv_bucket():
    assert mv_bucket(1) == 8
    assert mv_bucket(8) == 8
    assert mv_bucket(9) == 16
    assert mv_bucket(257) == 0


def test_frame_to_device_mv_table(tiny_clip):
    frames = _stream_frames(tiny_clip, gop_size=3, quantizer_scale=4)
    for ft, seq in frames:
        n = len(np.unique(ft.mb_mv.reshape(-1, 2), axis=0)) + 1
        cap = mv_bucket(n)
        d = frame_to_device(ft, mv_capacity=cap)
        tbl, idx = d["mv_table"], d["y"]["mv_idx"]
        assert np.array_equal(tbl[0], [0, 0])
        # table lookup reproduces the per-block vectors
        assert np.array_equal(tbl[idx], d["y"]["mv"])


def test_mv_bounds_sound_and_equal(tiny_clip):
    """Half-pel, motion-searched stream: the distinct-MV table reproduces
    every block's vector, and the XLA mvset and gather formulations
    decode bit-identically along the whole chain."""
    frames = _stream_frames(tiny_clip, gop_size=3, quantizer_scale=4,
                            me_range=4, half_pel_refine=True)
    consts = make_constants(frames[0][1])
    seq = frames[0][1]
    z = lambda h, w: np.zeros((h, w), np.uint8)  # noqa: E731
    refs = (z(seq.coded_height, seq.coded_width),
            z(seq.coded_height // 2, seq.coded_width // 2),
            z(seq.coded_height // 2, seq.coded_width // 2))
    saw_half_pel = False
    for ft, seq in frames:
        cap = mv_bucket(len(np.unique(ft.mb_mv.reshape(-1, 2),
                                      axis=0)) + 1)
        d = frame_to_device(ft, mv_capacity=cap)
        for key in ("y", "cb", "cr"):
            tbl, idx = d["mv_table"], np.asarray(d[key]["mv_idx"])
            assert np.array_equal(tbl[idx], d[key]["mv"])
        saw_half_pel |= bool((ft.mb_mv & 1).any())
        a = decode_frame_planes(d, refs, consts, mc_impl="gather")
        b = decode_frame_planes(d, refs, consts, mc_impl="mvset")
        for pa, pb in zip(a, b):
            assert np.array_equal(np.asarray(pa), np.asarray(pb))
        refs = tuple(np.asarray(p) for p in a)
    assert saw_half_pel, "fixture never produced a half-pel vector"


def test_mvset_equals_gather_on_stream(tiny_clip):
    frames = _stream_frames(tiny_clip, gop_size=3, quantizer_scale=4)
    consts = None
    refs = None
    ref_o = None
    for ft, seq in frames:
        if consts is None:
            consts = make_constants(seq)
            z = lambda h, w: np.zeros((h, w), np.uint8)
            refs = (z(seq.coded_height, seq.coded_width),
                    z(seq.coded_height // 2, seq.coded_width // 2),
                    z(seq.coded_height // 2, seq.coded_width // 2))
        cap = mv_bucket(len(np.unique(ft.mb_mv.reshape(-1, 2), axis=0)) + 1)
        d = frame_to_device(ft, mv_capacity=cap)
        a = decode_frame_planes(d, refs, consts, mc_impl="gather")
        b = decode_frame_planes(d, refs, consts, mc_impl="mvset")
        for pa, pb in zip(a, b):
            assert np.array_equal(np.asarray(pa), np.asarray(pb))
        oracle = reconstruct_frame(ft, seq, ref_o)
        for pb, po in zip(b, oracle):
            assert np.abs(np.asarray(pb).astype(int)
                          - po.astype(int)).max() <= 1
        refs = tuple(np.asarray(p) for p in b)
        ref_o = oracle


def test_mvset_out_of_bounds_clamp(rng):
    """mvset must reproduce CLAMP_TO_EDGE exactly for out-of-picture MVs."""
    h, w = 32, 32
    ref = rng.integers(0, 256, (h, w)).astype(np.uint8)
    mv_tbl = np.array([[0, 0], [-13, -9], [15, 21]], np.int32)
    mv_tbl = np.vstack([mv_tbl, np.zeros((5, 2), np.int32)])
    idx = rng.integers(0, 3, (h // 8, w // 8)).astype(np.int32)
    rep = np.zeros((h // 8, w // 8), np.int32)
    mv_blk = mv_tbl[idx]
    a = np.asarray(predict_plane(jnp.asarray(ref), jnp.asarray(mv_blk),
                                 jnp.asarray(rep), False))
    b = np.asarray(predict_plane_mvset(jnp.asarray(ref),
                                       jnp.asarray(mv_tbl),
                                       jnp.asarray(idx), jnp.asarray(rep),
                                       False, pad=24))
    assert np.array_equal(a, b)
