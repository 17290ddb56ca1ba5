"""Encoder fixture -> parser -> oracle round-trip tests.

These pin the executable specification: streams produced by the fixture
encoder parse correctly and reconstruct close to the source, the integer
reference simulation tracks the float oracle, and the encoder's internal
closed-loop reconstruction matches the oracle exactly (no P-frame drift).
"""

import numpy as np
import pytest

from jsvx.bitstream.bitio import BitReader
from jsvx.bitstream.container import StartCodeIndex, parse_container_header
from jsvx.coding import tables as T
from jsvx.tools.encoder import EncoderConfig, JsvEncoder
from jsvx.tools.oracle import (OracleDecoder, decode_stream_oracle,
                               reconstruct_frame_intsim)
from jsvx.tools.psnr import frames_psnr, psnr


def _encode(clip, **kw):
    cfg = EncoderConfig(**kw)
    h, w = clip[0][0].shape
    return JsvEncoder(w, h, cfg).encode(clip), cfg


def test_container_meta(tiny_clip):
    data, cfg = _encode(tiny_clip, gop_size=3)
    meta = parse_container_header(BitReader(data))
    assert meta.width == 64 and meta.height == 48
    assert meta.key_map is not None
    assert meta.key_map.count == 2          # 6 frames, gop 3
    # key-map offsets must land on sequence-header start codes
    for off in meta.key_map.offsets:
        assert data[off:off + 4] == bytes([0, 0, 1, T.START_SEQUENCE])


def test_stream_structure(tiny_clip):
    data, _ = _encode(tiny_clip, gop_size=3)
    idx = StartCodeIndex.scan(data)
    codes = idx.entries[:, 1]
    assert np.count_nonzero(codes == T.START_SEQUENCE) == 2
    assert np.count_nonzero(codes == T.START_GOP) == 2
    assert np.count_nonzero(codes == T.START_PICTURE) == 6


def test_intra_only_roundtrip(tiny_clip):
    data, _ = _encode(tiny_clip, gop_size=1, quantizer_scale=4)
    frames = decode_stream_oracle(data)
    assert len(frames) == len(tiny_clip)
    assert all(f.picture_type == T.PICTURE_TYPE_I for f in frames)
    p = frames_psnr([f.planes for f in frames], tiny_clip)
    assert p > 32.0, f"intra PSNR too low: {p}"


def test_ip_roundtrip(tiny_clip):
    data, _ = _encode(tiny_clip, gop_size=3, quantizer_scale=4)
    frames = decode_stream_oracle(data)
    assert len(frames) == len(tiny_clip)
    types = [f.picture_type for f in frames]
    assert types[0] == T.PICTURE_TYPE_I
    assert T.PICTURE_TYPE_P in types
    p = frames_psnr([f.planes for f in frames], tiny_clip)
    assert p > 30.0, f"I/P PSNR too low: {p}"


def test_encoder_reconstruction_matches_oracle(tiny_clip):
    """The encoder's closed-loop reference must equal the oracle decode:
    this is the no-drift property for P chains."""
    h, w = tiny_clip[0][0].shape
    enc = JsvEncoder(w, h, EncoderConfig(gop_size=6, quantizer_scale=4))
    data = enc.encode(tiny_clip)
    frames = decode_stream_oracle(data)
    # re-encode last GOP state is enc._ref == final reconstruction
    final = frames[-1].planes
    for a, b in zip(enc._ref, final):
        assert np.array_equal(np.asarray(a, dtype=np.uint8), b)


def test_motion_vectors_exercised(small_clip):
    """Moving content must produce nonzero MVs and P-frame savings."""
    data, _ = _encode(small_clip, gop_size=5, quantizer_scale=6)
    dec = OracleDecoder(data)
    mvs = []
    n_p = 0
    # walk parser manually to look at FrameTensors
    from jsvx.coding import tables as TT
    r, idx, parser = dec.reader, dec.index, dec.parser
    while True:
        nxt = idx.next_code(r.byte_pos)
        if nxt is None:
            break
        off, code = nxt
        r.seek_bits((off + 4) << 3)
        if code == TT.START_SEQUENCE:
            parser.parse_sequence_header(r)
        elif code == TT.START_GOP:
            parser.parse_gop_header(r)
        elif code == TT.START_PICTURE:
            ft = parser.parse_picture(r, idx, len(data))
            if ft is not None and ft.picture_type == TT.PICTURE_TYPE_P:
                n_p += 1
                mvs.append(ft.mb_mv.copy())
    assert n_p > 0
    assert any(np.any(m != 0) for m in mvs), "no motion vectors coded"


def test_intsim_tracks_oracle(tiny_clip):
    """Reference integer-path simulation stays close to the float oracle
    (this gap is the accuracy budget the device kernels must beat)."""
    data, _ = _encode(tiny_clip[:2], gop_size=2, quantizer_scale=4)
    dec = OracleDecoder(data)
    r, idx, parser = dec.reader, dec.index, dec.parser
    from jsvx.tools.oracle import reconstruct_frame
    ref_f = ref_i = None
    gaps = []
    while True:
        nxt = idx.next_code(r.byte_pos)
        if nxt is None:
            break
        off, code = nxt
        r.seek_bits((off + 4) << 3)
        if code == T.START_SEQUENCE:
            parser.parse_sequence_header(r)
        elif code == T.START_GOP:
            parser.parse_gop_header(r)
        elif code == T.START_PICTURE:
            ft = parser.parse_picture(r, idx, len(data))
            if ft is None:
                continue
            ora = reconstruct_frame(ft, parser.seq, ref_f)
            isim = reconstruct_frame_intsim(ft, parser.seq, ref_i)
            ref_f, ref_i = ora, isim
            for a, b in zip(ora, isim):
                gaps.append(psnr(a, b))
    assert gaps and min(gaps) > 35.0, f"int sim diverges: {gaps}"


def test_custom_quant_matrices(tiny_clip):
    iq = np.clip(T.DEFAULT_INTRA_QUANT_MATRIX.astype(np.int64) * 2, 1,
                 255).astype(np.uint8)
    nq = np.full(64, 24, dtype=np.uint8)
    data, _ = _encode(tiny_clip[:2], gop_size=2, quantizer_scale=4,
                      custom_intra_q=iq, custom_non_intra_q=nq)
    dec = OracleDecoder(data)
    frames = list(dec.frames())
    assert dec.parser.seq.custom_intra
    assert dec.parser.seq.custom_non_intra
    assert np.array_equal(dec.parser.seq.intra_q, iq)
    assert len(frames) == 2


def test_no_skip_config(tiny_clip):
    data, _ = _encode(tiny_clip, gop_size=3, use_skips=False)
    frames = decode_stream_oracle(data)
    assert len(frames) == len(tiny_clip)


def test_b_picture_skipped():
    """Pictures with type B/D are skipped like the reference
    (decoders/jsv.js:613) — and unlike it, without livelocking."""
    from jsvx.bitstream.bitio import BitWriter
    from jsvx.coding import tables as TT

    clip = [(np.full((48, 64), 100, np.uint8),
             np.full((24, 32), 128, np.uint8),
             np.full((24, 32), 128, np.uint8))] * 2
    data = bytearray(JsvEncoder(64, 48, EncoderConfig(
        gop_size=2)).encode(clip))
    # splice a bogus B picture between the two coded pictures
    w = BitWriter()
    w.put_start_code(TT.START_PICTURE)
    w.put_bits(1, 10)          # temporal ref
    w.put_bits(TT.PICTURE_TYPE_B, 3)
    w.put_bits(0xFFFF, 16)
    w.byte_align()
    from jsvx.bitstream.bitio import BitReader
    header_end = parse_container_header(BitReader(bytes(data))).header_bytes
    idx = StartCodeIndex.scan(bytes(data))
    pics = [int(o) for o, c in idx.entries
            if c == TT.START_PICTURE and o >= header_end]
    assert len(pics) == 2
    spliced = bytes(data[:pics[1]]) + w.getvalue() + bytes(data[pics[1]:])
    frames = decode_stream_oracle(spliced)
    assert len(frames) == 2                # B picture ignored
