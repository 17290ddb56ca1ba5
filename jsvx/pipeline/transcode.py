"""End-to-end batch decode: parallel parse -> device GOP scan -> sink.

The production-serving shape of the framework: a complete (or assigned
slice of a) stream is parsed with picture-level thread parallelism,
decoded GOP-by-GOP on the device (:func:`jsvx.pipeline.gop.decode_backend`
picks the kernels), and delivered to a sink, with GOP-granular checkpoint/resume via
:class:`jsvx.runtime.multihost.GopManifest` and stage metrics from
:mod:`jsvx.runtime.profiler`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..kernels.decode import frame_to_device, make_constants, mv_bucket
from ..runtime.multihost import GopManifest
from ..runtime.profiler import Metrics
from .gop import decode_backend, decode_gop_scan, zero_refs
from .parallel_parse import parse_stream_parallel


@dataclass
class TranscodeResult:
    n_frames: int
    n_gops: int
    metrics: Metrics
    width: int
    height: int


def transcode(data: bytes, sink=None, *,
              manifest: GopManifest | None = None,
              process_id: int = 0, process_count: int = 1,
              n_parse_threads: int | None = None,
              quirk_oddify_zeros: bool = False,
              metrics: Metrics | None = None) -> TranscodeResult:
    """Decode every (assigned, pending) GOP of ``data``.

    ``sink(gop_index, frames)`` receives each GOP's decoded (Y, Cb, Cr)
    stacks (device arrays).  With a ``manifest``, completed GOPs are
    journaled and skipped on resume; with ``process_count > 1`` only this
    process's round-robin share is decoded (multi-host operation).
    """
    from ..bitstream.native import get_native_parser

    metrics = metrics or Metrics()
    mc_impl = decode_backend()

    if get_native_parser() is not None:
        # the compact wire format cannot express the oddify-zeros quirk
        # (it oddifies positions the compact wire elides by design)
        run = _transcode_packed if quirk_oddify_zeros else _transcode_compact
        return run(data, sink, mc_impl=mc_impl, manifest=manifest,
                   process_id=process_id, process_count=process_count,
                   n_parse_threads=n_parse_threads,
                   quirk_oddify_zeros=quirk_oddify_zeros, metrics=metrics)

    import jax

    with metrics.timers.stage("parse"):
        parsed = parse_stream_parallel(data, n_threads=n_parse_threads)
    meta, seq = parsed.meta, parsed.seq
    bounds = parsed.gop_starts or [0]
    if bounds[0] != 0:
        bounds = [0] + bounds
    fgroups = [parsed.frames[bounds[i]:
                             (bounds[i + 1] if i + 1 < len(bounds)
                              else len(parsed.frames))]
               for i in range(len(bounds))]
    fgroups = [g for g in fgroups if g]
    # one distinct-MV capacity bucket for the whole stream: stable
    # shapes -> one compiled executable for every GOP
    cap = 0
    if mc_impl == "mvset":
        cap = mv_bucket(max([1] + [
            len(np.unique(ft.mb_mv.reshape(-1, 2), axis=0)) + 1
            for ft in parsed.frames]))
    if not cap:
        mc_impl = "gather"
    groups = []
    for g in fgroups:
        with metrics.timers.stage("pack"):
            groups.append((jax.tree.map(
                lambda *xs: np.stack(xs),
                *[frame_to_device(ft, mv_capacity=cap)
                  for ft in g]), len(g)))

    consts = make_constants(seq)
    if manifest is None:
        todo = list(range(len(groups)))
    else:
        todo = [s.index for s in manifest.pending(process_id, process_count)
                if s.index < len(groups)]

    n_frames = 0
    for gi in todo:
        stacked, group_len = groups[gi]
        with metrics.timers.stage("device_decode"):
            refs = zero_refs(seq.coded_height, seq.coded_width,
                             n_comps=meta.n_components)
            outs, _ = decode_gop_scan(
                stacked, refs, consts, quirk_oddify_zeros,
                mc_impl=mc_impl)
            jax.block_until_ready(outs)
        if sink is not None:
            with metrics.timers.stage("sink"):
                sink(gi, outs)
        n_frames += group_len
        metrics.count("frames", group_len)
        metrics.count("gops")
        if manifest is not None:
            manifest.mark_done(gi, frames=group_len)

    metrics.gauge("width", meta.width)
    metrics.gauge("height", meta.height)
    return TranscodeResult(n_frames=n_frames, n_gops=len(todo),
                           metrics=metrics, width=meta.width,
                           height=meta.height)


def _mv_plan(mc_impl: str, uniqs: list, sticky: int) -> tuple:
    """``(gop_capacity, new_sticky, gop_mc_impl)``: the distinct-MV
    table is built only for the mvset formulation, with a sticky
    grow-only bucket (few recompiles); a GOP that overflows every bucket
    decodes with the exact gather MC."""
    from ..kernels.decode import mv_capacity_for

    if mc_impl != "mvset":
        return 0, sticky, mc_impl
    gcap, sticky = mv_capacity_for(
        max((len(u[0]) + 1 for u in uniqs), default=1), sticky)
    return gcap, sticky, ("mvset" if gcap else "gather")


def _transcode_compact(data: bytes, sink, *, mc_impl: str,
                       manifest: GopManifest | None, process_id: int,
                       process_count: int, n_parse_threads: int | None,
                       quirk_oddify_zeros: bool,
                       metrics: Metrics) -> TranscodeResult:
    """Fastest path: compact coefficient wire (host->device bytes scale
    with *coded* content, not plane area — see :mod:`jsvx.kernels.expand`)
    + parse(g+1) pipelined against device decode(g).  GOPs whose streams
    emit blocks out of order (overlapping slices in corrupt streams) fall
    back to the dense wire per GOP.
    """
    import jax

    from .gop import decode_gop_scan_wire
    from .packed_parse import (BufferPool, attach_mvset,
                               attach_mvset_compact, parse_gop_compact,
                               parse_gop_packed, walk_stream, _mv_unique)
    from .wire import flatten_wire, wire_spec

    assert not quirk_oddify_zeros
    arr = np.frombuffer(bytes(data), dtype=np.uint8)
    with metrics.timers.stage("parse"):
        meta, seq, groups = walk_stream(data)
    consts = make_constants(seq)
    if manifest is None:
        todo = list(range(len(groups)))
    else:
        todo = [s.index for s in manifest.pending(process_id, process_count)
                if s.index < len(groups)]

    cap = 0              # sticky distinct-MV bucket (few recompiles)
    buckets: dict = {}   # sticky per-component coef-entry buckets
    wire_total = 0

    def parse_one(gi: int, pool: BufferPool):
        nonlocal cap, wire_total
        with metrics.timers.stage("parse"):
            # MV capacity must be known before the mvset sideband is
            # built; parse fills mb_mv either way, so derive the bucket
            # from a capacity-0 parse and attach the sideband after.
            g = parse_gop_compact(arr, groups[gi], seq, meta, pool,
                                  buckets, 0, n_threads=n_parse_threads,
                                  index=gi)
            if g.dirty:
                g = parse_gop_packed(arr, groups[gi], seq, meta, 0,
                                     pool=pool, n_threads=n_parse_threads,
                                     index=gi)
                uniqs = ([_mv_unique(ft.mb_mv) for ft in g.fts]
                         if mc_impl == "mvset" else [])
                gcap, cap, g.mc_impl = _mv_plan(mc_impl, uniqs, cap)
                if gcap:
                    attach_mvset(g, gcap, seq, meta, uniqs=uniqs)
                # dense fallback; async upload overlaps the next parse
                g.device_stacked = jax.device_put(g.stacked)
            else:
                mb = g.stacked["mb"]
                uniqs = ([_mv_unique(m) for m in mb["mv"]]
                         if mc_impl == "mvset" else [])
                gcap, cap, g.mc_impl = _mv_plan(mc_impl, uniqs, cap)
                if gcap:
                    attach_mvset_compact(g.stacked, mb, gcap, uniqs=uniqs)
                # ONE contiguous buffer -> ONE host->device transfer per
                # GOP (vs one per pytree leaf)
                g.wire_spec = wire_spec(g.stacked)
                buf = pool.acquire((g.wire_spec[1],), np.uint8)
                flatten_wire(g.stacked, g.wire_spec, out=buf)
                g.pooled.append(buf)
                g.device_wire = jax.device_put(buf)
                wire_total += buf.nbytes
        return g

    pool = BufferPool()
    n_frames = 0

    def flush(pending):
        """Complete + deliver a dispatched GOP (runs one GOP behind the
        dispatch, so the fetch overlaps the NEXT GOP's device work —
        the batch analog of the reference's display(n) overlapping
        decode(n+1), easybits.player.js:2451-2505)."""
        nonlocal n_frames
        gi, g, outs, compact = pending
        with metrics.timers.stage("device_wait"):
            jax.block_until_ready(outs)
        for buf in g.pooled:               # dense fallback: freed here;
            pool.release(buf)              # compact GOPs freed earlier
        if sink is not None:
            with metrics.timers.stage("sink"):
                sink(gi, outs)
        nf = len(g.hdrs) if compact else len(g.fts)
        n_frames += nf
        metrics.count("frames", nf)
        metrics.count("gops")
        if manifest is not None:
            manifest.mark_done(gi, frames=nf)

    pending = None
    nxt = parse_one(todo[0], pool) if todo else None
    for i, gi in enumerate(todo):
        g = nxt
        compact = hasattr(g, "device_wire")
        if compact:
            # the wire upload was dispatched asynchronously during
            # parse; whatever is
            # left of it here is the un-overlapped transfer tail,
            # separated from the expand+decode time in device_wait
            with metrics.timers.stage("wire_wait"):
                jax.block_until_ready(g.device_wire)
            # the upload is complete -> the pooled host buffers are free
            # NOW, in time for the next parse to reuse them (releasing
            # in flush() — one GOP later — made every parse allocate
            # fresh multi-MB buffers: parse stage 0.13 -> 0.30 s).
            # ONLY where device_put actually copies: the CPU backend
            # ALIASES the host buffer zero-copy (measured: mutating the
            # numpy array after block_until_ready changes the "device"
            # array), so there the buffers stay live until flush().
            if jax.devices()[0].platform != "cpu":
                for buf in g.pooled:
                    pool.release(buf)
                g.pooled = []
        with metrics.timers.stage("device_dispatch"):
            refs = zero_refs(seq.coded_height, seq.coded_width,
                             n_comps=meta.n_components)
            if compact:
                outs, _ = decode_gop_scan_wire(
                    g.device_wire, g.wire_spec, refs, consts,
                    seq.mb_height, seq.mb_width,
                    mc_impl=g.mc_impl)
            else:
                outs, _ = decode_gop_scan(
                    g.device_stacked, refs, consts, False,
                    mc_impl=g.mc_impl)
        nxt = parse_one(todo[i + 1], pool) if i + 1 < len(todo) else None
        if pending is not None:
            flush(pending)
        pending = (gi, g, outs, compact)
    if pending is not None:
        flush(pending)

    metrics.gauge("width", meta.width)
    metrics.gauge("height", meta.height)
    metrics.gauge("wire_bytes", wire_total)
    return TranscodeResult(n_frames=n_frames, n_gops=len(todo),
                           metrics=metrics, width=meta.width,
                           height=meta.height)


def _transcode_packed(data: bytes, sink, *, mc_impl: str,
                      manifest: GopManifest | None, process_id: int,
                      process_count: int, n_parse_threads: int | None,
                      quirk_oddify_zeros: bool,
                      metrics: Metrics) -> TranscodeResult:
    """Fast path: zero-copy stacked parse pipelined against async device
    decode — while the device crunches GOP g, the host parses GOP g+1
    (the batch analog of the reference's 1-frame decode-ahead,
    ``player/easybits.player.js:2504``); coefficient buffers recycle
    through a pool once the device step that read them completes.
    """
    import jax

    from .packed_parse import (BufferPool, attach_mvset, parse_gop_packed,
                               walk_stream, _mv_unique)

    arr = np.frombuffer(bytes(data), dtype=np.uint8)
    with metrics.timers.stage("parse"):
        meta, seq, groups = walk_stream(data)
    consts = make_constants(seq)
    if manifest is None:
        todo = list(range(len(groups)))
    else:
        todo = [s.index for s in manifest.pending(process_id, process_count)
                if s.index < len(groups)]

    cap = 0          # sticky grow-only distinct-MV bucket (few recompiles)

    def parse_one(gi: int, pool: BufferPool):
        nonlocal cap
        with metrics.timers.stage("parse"):
            g = parse_gop_packed(arr, groups[gi], seq, meta, 0, pool=pool,
                                 n_threads=n_parse_threads, index=gi)
            uniqs = ([_mv_unique(ft.mb_mv) for ft in g.fts]
                     if mc_impl == "mvset" else [])
            gcap, cap, g.mc_impl = _mv_plan(mc_impl, uniqs, cap)
            if gcap:
                attach_mvset(g, gcap, seq, meta, uniqs=uniqs)
            # start the host->device transfer now (async): it overlaps
            # the next GOP's parse instead of serialising into dispatch
            g.device_stacked = jax.device_put(g.stacked)
        return g

    pool = BufferPool()
    n_frames = 0
    nxt = parse_one(todo[0], pool) if todo else None
    for i, gi in enumerate(todo):
        g = nxt
        with metrics.timers.stage("device_dispatch"):
            refs = zero_refs(seq.coded_height, seq.coded_width,
                             n_comps=meta.n_components)
            outs, _ = decode_gop_scan(
                g.device_stacked, refs, consts, quirk_oddify_zeros,
                mc_impl=g.mc_impl)
        # overlap: host parses the next GOP while the device decodes
        nxt = parse_one(todo[i + 1], pool) if i + 1 < len(todo) else None
        with metrics.timers.stage("device_wait"):
            jax.block_until_ready(outs)
        for buf in g.pooled:
            pool.release(buf)
        if sink is not None:
            with metrics.timers.stage("sink"):
                sink(gi, outs)
        n_frames += len(g.fts)
        metrics.count("frames", len(g.fts))
        metrics.count("gops")
        if manifest is not None:
            manifest.mark_done(gi, frames=len(g.fts))

    metrics.gauge("width", meta.width)
    metrics.gauge("height", meta.height)
    return TranscodeResult(n_frames=n_frames, n_gops=len(todo),
                           metrics=metrics, width=meta.width,
                           height=meta.height)
