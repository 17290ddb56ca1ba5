"""Device decode path vs the float64 oracle.

The accuracy gate (BASELINE.md): the device path must match the oracle at
least as closely as the reference's integer shader path does.
"""

import numpy as np
import pytest

from jsvx.coding import tables as T
from jsvx.kernels.color import ycbcr_to_rgb_jax
from jsvx.kernels.decode import (decode_frame_jit, frame_to_device,
                                 make_constants)
from jsvx.pipeline.stream import JaxStreamDecoder
from jsvx.tools import refmath
from jsvx.tools.encoder import EncoderConfig, JsvEncoder
from jsvx.tools.oracle import (OracleDecoder, reconstruct_frame,
                               reconstruct_frame_intsim)
from jsvx.tools.psnr import psnr


def _walk(data):
    """(FrameTensors, seq) pairs via the shared parser."""
    dec = OracleDecoder(data)
    r, idx, parser = dec.reader, dec.index, dec.parser
    while True:
        nxt = idx.next_code(r.byte_pos)
        if nxt is None:
            return
        off, code = nxt
        r.seek_bits((off + 4) << 3)
        if code == T.START_SEQUENCE:
            parser.parse_sequence_header(r)
        elif code == T.START_GOP:
            parser.parse_gop_header(r)
        elif code == T.START_PICTURE:
            ft = parser.parse_picture(r, idx, len(data))
            if ft is not None:
                yield ft, parser.seq


def _encode(clip, **kw):
    h, w = clip[0][0].shape
    return JsvEncoder(w, h, EncoderConfig(**kw)).encode(clip)


def test_device_decode_matches_oracle(tiny_clip):
    data = _encode(tiny_clip, gop_size=3, quantizer_scale=4)
    consts = None
    ref_o = None
    refs_d = None
    worst_gap = np.inf
    for ft, seq in _walk(data):
        if consts is None:
            consts = make_constants(seq)
            z = lambda h, w: np.zeros((h, w), np.uint8)
            refs_d = (z(seq.coded_height, seq.coded_width),
                      z(seq.coded_height // 2, seq.coded_width // 2),
                      z(seq.coded_height // 2, seq.coded_width // 2))
        oracle = reconstruct_frame(ft, seq, ref_o)
        device = decode_frame_jit(frame_to_device(ft), refs_d, consts)
        device = tuple(np.asarray(p) for p in device)
        for comp, (a, b) in enumerate(zip(device, oracle)):
            diff = np.abs(a.astype(np.int64) - b.astype(np.int64))
            assert diff.max() <= 1, (
                f"comp {comp}: device deviates by {diff.max()}")
            frac = np.mean(diff > 0)
            assert frac < 5e-3, f"comp {comp}: {frac:.4f} pixels off by one"
            worst_gap = min(worst_gap, psnr(a, b))
        ref_o, refs_d = oracle, device
    assert worst_gap > 50.0


def test_device_beats_intsim_vs_oracle(tiny_clip):
    """North-star accuracy gate: PSNR(device, oracle) >= PSNR(intsim, oracle)."""
    data = _encode(tiny_clip, gop_size=3, quantizer_scale=6)
    consts = None
    ref_o = ref_i = None
    refs_d = None
    dev_psnrs, int_psnrs = [], []
    for ft, seq in _walk(data):
        if consts is None:
            consts = make_constants(seq)
            z = lambda h, w: np.zeros((h, w), np.uint8)
            refs_d = (z(seq.coded_height, seq.coded_width),
                      z(seq.coded_height // 2, seq.coded_width // 2),
                      z(seq.coded_height // 2, seq.coded_width // 2))
        oracle = reconstruct_frame(ft, seq, ref_o)
        intsim = reconstruct_frame_intsim(ft, seq, ref_i)
        device = tuple(np.asarray(p) for p in decode_frame_jit(
            frame_to_device(ft), refs_d, consts))
        for a, b in zip(device, oracle):
            dev_psnrs.append(psnr(a, b))
        for a, b in zip(intsim, oracle):
            int_psnrs.append(psnr(a, b))
        ref_o, ref_i, refs_d = oracle, intsim, device
    dev = min(dev_psnrs)
    ref = min(int_psnrs)
    assert dev >= ref, f"device {dev:.1f} dB < reference int path {ref:.1f} dB"


def test_gop_scan_equals_framewise(tiny_clip):
    data = _encode(tiny_clip, gop_size=3, quantizer_scale=4)
    a = JaxStreamDecoder(data).decode(use_gop_scan=True)
    b = JaxStreamDecoder(data).decode(use_gop_scan=False)
    assert len(a.frames) == len(b.frames) == len(tiny_clip)
    for fa, fb in zip(a.frames, b.frames):
        for pa, pb in zip(fa, fb):
            assert np.array_equal(np.asarray(pa), np.asarray(pb))


def test_quirk_mode_matches_intsim_dequant(tiny_clip):
    """With the quirk flag the device dequant reproduces the reference
    shader's oddify-zeros behaviour (checked against the quirk oracle)."""
    data = _encode(tiny_clip[:2], gop_size=2, quantizer_scale=6)
    ref_o = None
    refs_d = None
    consts = None
    for ft, seq in _walk(data):
        if consts is None:
            consts = make_constants(seq)
            z = lambda h, w: np.zeros((h, w), np.uint8)
            refs_d = (z(seq.coded_height, seq.coded_width),
                      z(seq.coded_height // 2, seq.coded_width // 2),
                      z(seq.coded_height // 2, seq.coded_width // 2))
        oracle = reconstruct_frame(ft, seq, ref_o, quirk_oddify_zeros=True)
        device = tuple(np.asarray(p) for p in decode_frame_jit(
            frame_to_device(ft), refs_d, consts, quirk_oddify_zeros=True))
        for a, b in zip(device, oracle):
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
        ref_o, refs_d = oracle, device


def test_color_convert_matches_reference_math(rng):
    y = rng.integers(0, 256, (32, 48)).astype(np.uint8)
    cb = rng.integers(0, 256, (16, 24)).astype(np.uint8)
    cr = rng.integers(0, 256, (16, 24)).astype(np.uint8)
    a = np.asarray(ycbcr_to_rgb_jax(y, cb, cr))
    b = refmath.ycbcr_to_rgb(y, cb, cr)
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    rgba = np.asarray(ycbcr_to_rgb_jax(y, cb, cr, alpha=True))
    assert rgba.shape == (32, 48, 4) and np.all(rgba[..., 3] == 255)


def test_halfpel_mc_against_blockwise(rng):
    """Vectorised device MC == blockwise reference MC for random MVs."""
    import jax.numpy as jnp
    from jsvx.kernels.decode import predict_plane

    h, w = 64, 96
    ref = rng.integers(0, 256, (h, w)).astype(np.uint8)
    mb_h, mb_w = h // 16, w // 16
    mv_mb = rng.integers(-20, 21, (mb_h, mb_w, 2)).astype(np.int32)
    # luma: per-block grid = 2x MB grid
    mv_blk = np.repeat(np.repeat(mv_mb, 2, axis=0), 2, axis=1)
    rep = np.zeros((mb_h * 2, mb_w * 2), dtype=np.int32)
    got = np.asarray(predict_plane(jnp.asarray(ref), jnp.asarray(mv_blk),
                                   jnp.asarray(rep), is_chroma=False))
    want = np.zeros((h, w))
    for r in range(mb_h):
        for c in range(mb_w):
            want[r * 16:(r + 1) * 16, c * 16:(c + 1) * 16] = (
                refmath.mc_luma_block(ref, r, c, mv_mb[r, c]))
    assert np.array_equal(got, want.astype(np.int64))

    # chroma plane
    ref_c = rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8)
    rep_c = np.zeros((mb_h, mb_w), dtype=np.int32)
    got_c = np.asarray(predict_plane(jnp.asarray(ref_c), jnp.asarray(mv_mb),
                                     jnp.asarray(rep_c), is_chroma=True))
    want_c = np.zeros((h // 2, w // 2))
    for r in range(mb_h):
        for c in range(mb_w):
            want_c[r * 8:(r + 1) * 8, c * 8:(c + 1) * 8] = (
                refmath.mc_chroma_block(ref_c, r, c, mv_mb[r, c]))
    assert np.array_equal(got_c, want_c.astype(np.int64))
