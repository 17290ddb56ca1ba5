"""YUVA (4-component) decode, end-to-end.

The reference parses the container's alpha flag and sizes its GL pools by
``n_comps = yuva ? 4 : 3`` (``decoders/jsv.js:256-259,60-75``) but leaves
the alpha coding undefined; jsvx defines it concretely (4 extra luma-like
blocks per macroblock — see :class:`jsvx.bitstream.parser.StreamParser`)
and implements it through every layer: encoder, both parser back-ends,
oracle, both MC formulations of the device path, color convert, and the
Decoder API.
"""

import numpy as np
import pytest

from jsvx.kernels.decode import (decode_frame_jit, decode_frame_planes,
                                 frame_to_device, make_constants, mv_bucket)
from jsvx.tools.encoder import EncoderConfig, JsvEncoder
from jsvx.tools.oracle import OracleDecoder, reconstruct_frame
from jsvx.tools.psnr import psnr

from test_kernels import _walk


def _encode(clip, **kw):
    h, w = clip[0][0].shape
    return JsvEncoder(w, h, EncoderConfig(**kw)).encode(clip)


def test_yuva_container_flag_and_oracle_roundtrip(tiny_clip_yuva):
    data = _encode(tiny_clip_yuva, gop_size=3, quantizer_scale=4)
    dec = OracleDecoder(data)
    assert dec.meta.yuva and dec.meta.n_components == 4
    outs = list(dec.frames())
    assert len(outs) == len(tiny_clip_yuva)
    for f, src in zip(outs, tiny_clip_yuva):
        assert len(f.planes) == 4
        for c in (0, 3):                   # full-res planes vs source
            assert psnr(f.planes[c], np.asarray(src[c])) > 38.0


def test_yuva_python_and_native_parsers_identical(tiny_clip_yuva):
    from jsvx.bitstream.bitio import BitReader
    from jsvx.bitstream.container import (StartCodeIndex,
                                          parse_container_header)
    from jsvx.bitstream.native import get_native_parser
    from jsvx.bitstream.parser import StreamParser
    from jsvx.coding import tables as T

    if get_native_parser() is None:
        pytest.skip("native parser unavailable")
    data = _encode(tiny_clip_yuva, gop_size=3, quantizer_scale=4)

    def walk(use_native):
        r = BitReader(data)
        meta = parse_container_header(r)
        idx = StartCodeIndex.scan(data)
        p = StreamParser(use_native=use_native, yuva=meta.yuva)
        out = []
        while True:
            nxt = idx.next_code(r.byte_pos)
            if nxt is None:
                return out
            off, code = nxt
            r.seek_bits((off + 4) << 3)
            if code == T.START_SEQUENCE:
                p.parse_sequence_header(r)
            elif code == T.START_GOP:
                p.parse_gop_header(r)
            elif code == T.START_PICTURE:
                ft = p.parse_picture(r, idx, len(data))
                if ft is not None:
                    out.append(ft)

    a, b = walk(False), walk(True)
    assert len(a) == len(b) == len(tiny_clip_yuva)
    for fa, fb in zip(a, b):
        assert fa.n_comps == fb.n_comps == 4
        for c in range(4):
            np.testing.assert_array_equal(fa.levels[c], fb.levels[c])
            np.testing.assert_array_equal(fa.lnz[c], fb.lnz[c])
        np.testing.assert_array_equal(fa.mb_mv, fb.mb_mv)
        np.testing.assert_array_equal(fa.mb_rep_add, fb.mb_rep_add)


def test_yuva_device_paths_match_oracle(tiny_clip_yuva):
    """The gather and mvset MC formulations both decode the alpha
    plane, agree bit for bit, and match the oracle within the usual
    1 LSB."""

    data = _encode(tiny_clip_yuva, gop_size=3, quantizer_scale=4)
    consts = refs = ref_o = None
    for ft, seq in _walk(data):
        assert ft.n_comps == 4
        if consts is None:
            consts = make_constants(seq)
            z = lambda h, w: np.zeros((h, w), np.uint8)
            refs = (z(seq.coded_height, seq.coded_width),
                    z(seq.coded_height // 2, seq.coded_width // 2),
                    z(seq.coded_height // 2, seq.coded_width // 2),
                    z(seq.coded_height, seq.coded_width))
        cap = mv_bucket(len(np.unique(ft.mb_mv.reshape(-1, 2), axis=0)) + 1)
        d = frame_to_device(ft, mv_capacity=cap)
        assert "a" in d
        oracle = reconstruct_frame(ft, seq, ref_o)
        xla = decode_frame_planes(d, refs, consts, mc_impl="mvset")
        gat = decode_frame_planes(d, refs, consts, mc_impl="gather")
        assert len(xla) == len(gat) == 4
        for c in range(4):
            a = np.asarray(xla[c])
            assert np.array_equal(a, np.asarray(gat[c]))
            assert np.abs(a.astype(int)
                          - oracle[c].astype(int)).max() <= 1
        ref_o = oracle
        refs = tuple(np.asarray(p) for p in xla)


def test_yuva_gop_scan_and_decoder_api(tiny_clip_yuva):
    from jsvx.api import Decoder
    from jsvx.pipeline.stream import JaxStreamDecoder

    data = _encode(tiny_clip_yuva, gop_size=3, quantizer_scale=4)
    res = JaxStreamDecoder(data).decode(use_gop_scan=True)
    assert len(res.frames) == len(tiny_clip_yuva)
    assert all(len(f) == 4 for f in res.frames)

    dec = Decoder()
    dec.feed(0, data, total=len(data))
    outs = list(dec.iter_frames())
    assert dec.ended and len(outs) == len(tiny_clip_yuva)
    for f, g in zip(outs, res.frames):
        assert len(f.planes) == 4
        for c in range(4):
            np.testing.assert_array_equal(np.asarray(f.planes[c]),
                                          np.asarray(g[c]))


def test_yuva_color_rgba_uses_decoded_alpha(tiny_clip_yuva):
    from jsvx.kernels.color import ycbcr_to_rgb_jax

    data = _encode(tiny_clip_yuva[:1], gop_size=1, quantizer_scale=4)
    f = next(OracleDecoder(data).frames())
    rgba = np.asarray(ycbcr_to_rgb_jax(*[np.asarray(p)
                                         for p in f.planes[:3]],
                                       alpha=f.planes[3]))
    assert rgba.shape[-1] == 4
    np.testing.assert_array_equal(rgba[..., 3], f.planes[3])


def test_yuva_transcode_pipeline(tiny_clip_yuva):
    from jsvx.pipeline.transcode import transcode

    data = _encode(tiny_clip_yuva, gop_size=3, quantizer_scale=4)
    got = {}

    def sink(gi, frames):
        got[gi] = tuple(np.asarray(p) for p in frames)

    res = transcode(data, sink=sink)
    assert res.n_frames == len(tiny_clip_yuva)
    assert all(len(v) == 4 for v in got.values())
    oracle = list(OracleDecoder(data).frames())
    flat = [tuple(p[i] for p in got[gi])
            for gi in sorted(got) for i in range(got[gi][0].shape[0])]
    assert len(flat) == len(oracle)
    for dev, orc in zip(flat, oracle):
        for c in range(4):
            assert np.abs(dev[c].astype(int)
                          - orc.planes[c].astype(int)).max() <= 1
