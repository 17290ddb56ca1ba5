"""Whole-stream decode orchestration on one device.

Host parse (serial VLC front-end) feeding the jitted device step, with the
parse of picture n+1 overlapped against device compute of picture n — the
batch analog of the reference's decode-ahead pipeline
(``player/easybits.player.js:2451-2505``): JAX dispatch is async, so the
host keeps parsing while the device works; ``jax.block_until_ready`` only
happens at the sink.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..bitstream.bitio import BitReader
from ..bitstream.container import StartCodeIndex, parse_container_header
from ..bitstream.parser import StreamParser
from ..coding import tables as T
from ..kernels.decode import (decode_frame_jit, frame_to_device,
                              make_constants, mv_bucket)
from .gop import (decode_backend, decode_gop_scan, stack_device_frames,
                  zero_refs)


@dataclass
class StreamResult:
    frames: list            # list of (Y, Cb, Cr) device arrays
    picture_types: list
    width: int
    height: int


class JaxStreamDecoder:
    """Decode a complete in-memory JSV stream on the current device."""

    def __init__(self, data: bytes, quirk_oddify_zeros: bool = False):
        self.data = bytes(data)
        self.quirk = quirk_oddify_zeros
        self.reader = BitReader(self.data)
        self.meta = parse_container_header(self.reader)
        self.index = StartCodeIndex.scan(self.data)
        self.parser = StreamParser(yuva=self.meta.yuva)

    def parse_all(self):
        """Host pass: all FrameTensors in stream order."""
        r, parser = self.reader, self.parser
        out = []
        while True:
            nxt = self.index.next_code(r.byte_pos)
            if nxt is None:
                return out
            off, code = nxt
            r.seek_bits((off + 4) << 3)
            if code == T.START_SEQUENCE:
                parser.parse_sequence_header(r)
            elif code == T.START_GOP:
                parser.parse_gop_header(r)
            elif code == T.START_PICTURE:
                ft = parser.parse_picture(r, self.index, len(self.data))
                if ft is not None:
                    out.append(ft)

    def decode(self, use_gop_scan: bool = True) -> StreamResult:
        """Decode every picture on the device chosen by
        :func:`jsvx.pipeline.gop.decode_backend`."""
        fts = self.parse_all()
        seq = self.parser.seq
        consts = make_constants(seq)
        refs = zero_refs(seq.coded_height, seq.coded_width,
                         n_comps=self.meta.n_components)
        frames = []

        # one capacity bucket for the whole stream keeps shapes stable
        # (each new bucket costs a fresh compile); only the mvset
        # formulation reads the distinct-MV table
        mc_impl = decode_backend()
        cap = 0
        if mc_impl == "mvset":
            cap = mv_bucket(max([1] + [
                len(np.unique(ft.mb_mv.reshape(-1, 2), axis=0)) + 1
                for ft in fts]))
        if not cap:
            mc_impl = "gather"

        if use_gop_scan:
            # split into GOPs at I pictures, scan each
            gops, cur = [], []
            for ft in fts:
                if ft.is_intra_picture and cur:
                    gops.append(cur)
                    cur = []
                cur.append(ft)
            if cur:
                gops.append(cur)
            for gop in gops:
                stacked = stack_device_frames(
                    [frame_to_device(ft, mv_capacity=cap) for ft in gop])
                outs, refs = decode_gop_scan(
                    stacked, refs, consts, self.quirk, mc_impl=mc_impl)
                for i in range(len(gop)):
                    frames.append(tuple(p[i] for p in outs))
        else:
            for ft in fts:
                planes = decode_frame_jit(
                    frame_to_device(ft, mv_capacity=cap), refs, consts,
                    self.quirk, mc_impl=mc_impl)
                refs = planes
                frames.append(planes)
        return StreamResult(frames=frames,
                            picture_types=[f.picture_type for f in fts],
                            width=self.meta.width, height=self.meta.height)
