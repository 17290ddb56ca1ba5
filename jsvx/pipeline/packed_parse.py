"""Zero-copy host front-end: parse straight into stacked GOP tensors.

The picture-at-a-time path (:mod:`.parallel_parse` + ``frame_to_device``
+ ``np.stack``) copies every coefficient plane three times: fresh
``np.zeros`` at allocation, ``astype`` in packing, and ``np.stack`` into
the GOP batch.  At 1080p those copies cost more than the VLC decode
itself.  Here the stacked per-GOP arrays are allocated ONCE (and reused
across GOPs via a buffer pool), every picture's FrameTensors are numpy
VIEWS of its row of the stack, and the C++ parser writes coefficients
directly into their final resting place.  The "pack" stage shrinks to
the per-MB sideband expansions (a few hundred KB per GOP).

Zeroing invariant: coefficient planes are NOT cleared between uses.
This is safe because the device dequantiser masks every position whose
zig-zag scan index is at/after the block's ``lnz`` ("last non-zero",
``decoders/jsv.js:1488``), coded blocks are fully written by the parser
(the 8x8 is zeroed then scattered), and intra blocks — the only readers
of the DC override — are always coded.  Only the small per-MB sideband
arrays (lnz, quant, intra, mv, rep_add) are reset per picture.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

import numpy as np

from ..bitstream.bitio import BitReader
from ..bitstream.container import StartCodeIndex, parse_container_header
from ..bitstream.parser import FrameTensors, StreamParser
from ..bitstream.native import get_native_parser
from ..coding import tables as T
from ..kernels.decode import COMP_KEYS, comp_is_chroma, mv_bucket
from .parallel_parse import _parse_picture_header, _picture_end


class BufferPool:
    """Reusable host-array pool keyed by (shape, dtype).

    Release buffers only after the device has consumed them (after
    ``jax.block_until_ready`` on the step that read them).
    """

    def __init__(self):
        self._free: dict = {}
        self._lock = threading.Lock()

    def acquire(self, shape: tuple, dtype) -> np.ndarray:
        key = (tuple(shape), np.dtype(dtype).str)
        with self._lock:
            lst = self._free.get(key)
            if lst:
                return lst.pop()
        return np.empty(shape, dtype)

    def release(self, arr: np.ndarray) -> None:
        key = (arr.shape, arr.dtype.str)
        with self._lock:
            self._free.setdefault(key, []).append(arr)

    def release_tree(self, tree) -> None:
        import jax

        for leaf in jax.tree.leaves(tree):
            if isinstance(leaf, np.ndarray) and leaf.ndim >= 3:
                self.release(leaf)


@dataclass
class PackedGop:
    stacked: dict                # device-ready stacked pytree (numpy)
    fts: list                    # FrameTensors views into the stack
    index: int = 0
    pooled: list = field(default_factory=list)   # pool-owned buffers
    mc_impl: str = "gather"      # MC formulation decided at parse time


@dataclass
class PackedStream:
    meta: object
    seq: object
    gops: list                   # list[PackedGop]
    mv_capacity: int = 0

    @property
    def n_frames(self) -> int:
        return sum(len(g.fts) for g in self.gops)


def _mb_to_blocks(a: np.ndarray, comp: int) -> np.ndarray:
    if comp_is_chroma(comp):
        return a
    return np.repeat(np.repeat(a, 2, axis=-2 if a.ndim == 2 else 1),
                     2, axis=-1 if a.ndim == 2 else 2)


def _mv_unique(mb_mv: np.ndarray):
    """Distinct (vy, vx) rows + inverse index, (0,0) forced to row 0.

    ~40x faster than ``np.unique(..., axis=0)`` (which sorts void
    views): vectors pack into one int32 key, unique runs in 1-D.
    """
    flat = mb_mv.reshape(-1, 2)
    key = ((flat[:, 0].astype(np.int32) << 16)
           | flat[:, 1].astype(np.uint16).astype(np.int32))
    uk, inv = np.unique(key, return_inverse=True)
    uniq = np.empty((len(uk), 2), np.int32)
    uniq[:, 0] = uk >> 16
    uniq[:, 1] = (uk & 0xFFFF).astype(np.uint16).view(np.int16)
    zi = int(np.searchsorted(uk, 0))
    if zi < len(uk) and uk[zi] == 0:
        if zi != 0:
            uniq[[0, zi]] = uniq[[zi, 0]]
            inv = np.where(inv == zi, -1, inv)
            inv = np.where(inv == 0, zi, inv)
            inv = np.where(inv == -1, 0, inv)
    else:
        uniq = np.concatenate([np.zeros((1, 2), np.int32), uniq])
        inv = inv + 1
    return uniq, inv


def mvset_tables(mb_mvs, mv_capacity: int, uniqs: list | None = None):
    """Distinct-MV decomposition of a GOP's per-MB vector fields.

    Returns ``(tables (n, K, 2) int32, counts (n,) int32, mv_idx (n,
    mb_h, mb_w) int16)``: per frame the unique vectors with (0, 0) at
    row 0 (:func:`_mv_unique`) and each macroblock's row index."""
    n = len(mb_mvs)
    mb_h, mb_w = mb_mvs[0].shape[:2]
    tables = np.zeros((n, mv_capacity, 2), np.int32)
    counts = np.zeros((n,), np.int32)
    mv_idx = np.zeros((n, mb_h, mb_w), np.int16)
    for i, mb_mv in enumerate(mb_mvs):
        uniq, inv = (uniqs[i] if uniqs is not None
                     else _mv_unique(mb_mv))
        if len(uniq) > mv_capacity:
            raise ValueError(
                f"{len(uniq)} distinct MVs exceed {mv_capacity}")
        tables[i, :len(uniq)] = uniq
        counts[i] = len(uniq)
        mv_idx[i] = inv.reshape(mb_h, mb_w)
    return tables, counts, mv_idx


def walk_stream(data: bytes):
    """Serial header walk: (meta, seq, groups) where ``groups[g]`` is the
    list of (picture-header FrameTensors stub, start_bit) of GOP g."""
    data = bytes(data)
    r = BitReader(data)
    meta = parse_container_header(r)
    index = StartCodeIndex.scan(data)
    parser = StreamParser(use_native=False)
    parser.yuva = meta.yuva
    groups: list[list] = []
    pos = r.byte_pos
    while True:
        nxt = index.next_code(pos)
        if nxt is None:
            break
        off, code = nxt
        rr = BitReader(data, pos_bits=(off + 4) << 3)
        if code == T.START_SEQUENCE:
            parser.parse_sequence_header(rr)
            pos = rr.byte_pos
        elif code == T.START_GOP:
            parser.parse_gop_header(rr)
            groups.append([])
            pos = rr.byte_pos
        elif code == T.START_PICTURE:
            hdr, start_bit = _parse_picture_header(parser, rr)
            if hdr is None:
                pos = rr.byte_pos
                continue
            if not groups:
                groups.append([])
            groups[-1].append((hdr, start_bit))
            pos = _picture_end(index, rr.byte_pos, len(data))
        else:
            pos = off + 4
    return meta, parser.seq, [g for g in groups if g]


def parse_gop_packed(arr: np.ndarray, group: list, seq, meta,
                     mv_capacity: int,
                     pool: BufferPool | None = None,
                     n_threads: int | None = None,
                     slice_threads: int = 1, index: int = 0) -> PackedGop:
    """Parse one GOP's pictures into freshly-acquired stacked arrays.

    ``mv_capacity``: distinct-MV table rows (0 = no mvset sideband).
    Small per-MB arrays are zeroed; coefficient planes rely on the lnz
    masking invariant (module docstring) and are NOT cleared.
    """
    native = get_native_parser()
    if native is None:
        raise RuntimeError("packed parse requires the C++ parser")
    pool = pool or BufferPool()
    n_comps = meta.n_components
    mb_h, mb_w = seq.mb_height, seq.mb_width
    ch, cw = seq.coded_height, seq.coded_width
    plane_shapes = [(ch, cw), (ch >> 1, cw >> 1), (ch >> 1, cw >> 1),
                    (ch, cw)][:n_comps]
    lnz_shapes = [(2 * mb_h, 2 * mb_w), (mb_h, mb_w), (mb_h, mb_w),
                  (2 * mb_h, 2 * mb_w)][:n_comps]

    n = len(group)
    levels = [pool.acquire((n,) + plane_shapes[c], np.int16)
              for c in range(n_comps)]
    lnzs = [np.zeros((n,) + lnz_shapes[c], np.uint8)
            for c in range(n_comps)]
    mb_quant = np.ones((n, mb_h, mb_w), np.uint8)
    mb_intra = np.zeros((n, mb_h, mb_w), np.uint8)
    mb_mv = np.zeros((n, mb_h, mb_w, 2), np.int16)
    mb_rep_add = np.zeros((n, mb_h, mb_w), np.uint8)
    fts, jobs = [], []
    for i, (hdr, start_bit) in enumerate(group):
        ft = FrameTensors(
            picture_type=hdr.picture_type,
            temporal_ref=hdr.temporal_ref,
            full_pel=hdr.full_pel, f_code=hdr.f_code,
            gop_time_ms=hdr.gop_time_ms,
            levels=tuple(lv[i] for lv in levels),
            lnz=tuple(lz[i] for lz in lnzs),
            mb_quant=mb_quant[i], mb_intra=mb_intra[i],
            mb_mv=mb_mv[i], mb_rep_add=mb_rep_add[i])
        fts.append(ft)
        jobs.append((ft, start_bit))

    def run(job):
        ft, start_bit = job
        native.parse_picture_slices(arr, start_bit, ft, mb_w, mb_h,
                                    n_threads=slice_threads)

    if n_threads == 1 or len(jobs) == 1:
        for job in jobs:
            run(job)
    else:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=n_threads) as tp:
            list(tp.map(run, jobs))

    # ---- distinct-MV decomposition + device-dict assembly ---------------
    out = dict(
        is_p=np.array([0 if ft.is_intra_picture else 1 for ft in fts],
                      np.int32),
        f_code=np.array([ft.f_code for ft in fts], np.int32),
    )
    mv_idx = None
    if mv_capacity:
        tables, counts, mv_idx = mvset_tables(
            [ft.mb_mv for ft in fts], mv_capacity)
        out["mv_table"] = tables
        out["mv_count"] = counts
    for c in range(n_comps):
        # narrow dtypes: these cross the host->device link every GOP;
        # kernels promote as needed
        comp = dict(
            levels=levels[c],
            lnz=lnzs[c],
            q=np.ascontiguousarray(_mb_to_blocks(mb_quant, c)),
            intra=np.ascontiguousarray(_mb_to_blocks(mb_intra, c)),
            mv=np.ascontiguousarray(_mb_to_blocks(mb_mv, c)),
            rep_add=np.ascontiguousarray(_mb_to_blocks(mb_rep_add, c)),
        )
        if mv_idx is not None:
            comp["mv_idx"] = np.ascontiguousarray(_mb_to_blocks(mv_idx, c))
        out[COMP_KEYS[c]] = comp
    return PackedGop(stacked=out, fts=fts, index=index, pooled=levels)


@dataclass
class CompactGop:
    """One GOP in the compact coefficient wire format (see
    :mod:`jsvx.kernels.expand`): ``stacked`` is the device-ready pytree,
    ``wire_bytes`` the actual host->device payload, ``dirty`` whether the
    stream emitted blocks out of order (caller must fall back to the
    dense parse for this GOP)."""

    stacked: dict
    hdrs: list
    index: int = 0
    pooled: list = field(default_factory=list)
    wire_bytes: int = 0
    dirty: bool = False
    mc_impl: str = "gather"      # MC formulation decided at parse time


def coef_bucket(n: int) -> int:
    """Static entry-capacity buckets for the compact wire (limits
    recompilation to a handful of sizes per stream).

    1.25x geometric steps (8192-entry aligned): power-of-two buckets
    wasted up to ~50% of the wire as padding — on bandwidth-bound
    host->device links the padding is paid in real transfer time.  The
    sticky per-stream bucket map still bounds recompiles to a handful.
    """
    b = 1 << 14
    while b < n:
        b = -(-(b + b // 4) // 8192) * 8192
    return b


def parse_gop_compact(arr: np.ndarray, group: list, seq, meta,
                      pool: BufferPool, buckets: dict,
                      mv_capacity: int = 0,
                      n_threads: int | None = None,
                      slice_threads: int = 1,
                      index: int = 0) -> CompactGop:
    """Parse one GOP into the compact wire format.

    ``buckets`` maps component key -> sticky entry-capacity bucket; it is
    grown in place so successive GOPs keep stable shapes (one compiled
    expansion+decode program per bucket set).  ``mv_capacity`` as in
    :func:`parse_gop_packed`; 0 leaves it to the caller
    (:func:`attach_mvset_compact`).
    """
    native = get_native_parser()
    if native is None:
        raise RuntimeError("compact parse requires the C++ parser")
    n_comps = meta.n_components
    mb_h, mb_w = seq.mb_height, seq.mb_width
    n = len(group)
    nblk = [mb_h * mb_w * 4, mb_h * mb_w, mb_h * mb_w,
            mb_h * mb_w * 4][:n_comps]

    counts = [np.zeros((n, nblk[c]), np.uint8) for c in range(n_comps)]
    mb_quant = np.ones((n, mb_h, mb_w), np.uint8)
    mb_intra = np.zeros((n, mb_h, mb_w), np.uint8)
    mb_mv = np.zeros((n, mb_h, mb_w, 2), np.int16)
    mb_rep_add = np.zeros((n, mb_h, mb_w), np.uint8)

    # per-frame scratch is worst-case sized (nblk * 64 entries) but
    # pooled; only the bucket-padded concatenation crosses the wire
    scratch = [[pool.acquire((nblk[c] * 64,), np.uint16)
                for c in range(n_comps)] for _ in range(n)]
    ns = [None] * n
    dirty = [False] * n

    def run(i):
        hdr, start_bit = group[i]
        ns[i], dirty[i] = native.parse_picture_compact(
            arr, start_bit, hdr, mb_w, mb_h, n_comps == 4,
            tuple(scratch[i]) + (None,) * (4 - n_comps),
            tuple(counts[c][i] for c in range(n_comps))
            + (None,) * (4 - n_comps),
            mb_quant[i], mb_intra[i], mb_mv[i], mb_rep_add[i],
            n_threads=slice_threads)

    if n_threads == 1 or n == 1:
        for i in range(n):
            run(i)
    else:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=n_threads) as tp:
            list(tp.map(run, range(n)))

    hdrs = [hdr for hdr, _ in group]
    out = dict(
        is_p=np.array([0 if h.picture_type == 1 else 1 for h in hdrs],
                      np.int32),
        f_code=np.array([h.f_code for h in hdrs], np.int32),
    )
    mb = dict(q=mb_quant, intra=mb_intra, rep_add=mb_rep_add, mv=mb_mv)
    if mv_capacity:
        attach_mvset_compact(out, mb, mv_capacity)
    out["mb"] = mb

    coef = {}
    pooled = []
    for c in range(n_comps):
        key = COMP_KEYS[c]
        total = sum(int(ns[i][c]) for i in range(n))
        bucket = max(buckets.get(key, 0), coef_bucket(total))
        buckets[key] = bucket
        wire = pool.acquire((bucket,), np.uint16)
        off = 0
        for i in range(n):
            cnt = int(ns[i][c])
            wire[off:off + cnt] = scratch[i][c][:cnt]
            off += cnt
        coef[key] = dict(cpk=wire, n=np.int32(total), counts=counts[c])
        pooled.append(wire)
    out["coef"] = coef
    # scratch is host-side only (already concatenated): recycle now;
    # the wire buffers in `pooled` recycle after the device reads them
    for row in scratch:
        for s in row:
            pool.release(s)

    wire_bytes = sum(int(np.asarray(leaf).nbytes)
                     for leaf in _tree_leaves(out))
    return CompactGop(stacked=out, hdrs=hdrs, index=index, pooled=pooled,
                      wire_bytes=wire_bytes, dirty=any(dirty))


def _tree_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tree_leaves(v)
    else:
        yield tree


def attach_mvset(g: PackedGop, mv_capacity: int, seq, meta,
                 uniqs: list | None = None) -> None:
    """Add the distinct-MV sideband to a GOP parsed with capacity 0."""
    tables, counts, mv_idx = mvset_tables(
        [ft.mb_mv for ft in g.fts], mv_capacity, uniqs=uniqs)
    g.stacked["mv_table"] = tables
    g.stacked["mv_count"] = counts
    for c in range(meta.n_components):
        g.stacked[COMP_KEYS[c]]["mv_idx"] = np.ascontiguousarray(
            _mb_to_blocks(mv_idx, c))


def attach_mvset_compact(stacked: dict, mb: dict, mv_capacity: int,
                         uniqs: list | None = None) -> None:
    """Add the distinct-MV sideband to a compact-wire GOP pytree (its
    per-MB sideband dict ``mb`` carries the index grid)."""
    tables, counts, mb["mv_idx"] = mvset_tables(
        list(mb["mv"]), mv_capacity, uniqs=uniqs)
    stacked["mv_table"] = tables
    stacked["mv_count"] = counts


def gop_mv_capacity(fts) -> int:
    return max((len(_mv_unique(ft.mb_mv)[0]) + 1 for ft in fts),
               default=1)


def parse_stream_packed(data: bytes, n_threads: int | None = None,
                        mv_capacity: int | None = None,
                        pool: BufferPool | None = None,
                        slice_threads: int = 1) -> PackedStream:
    """Parse a complete stream into device-ready stacked GOP pytrees.

    Requires the native parser (raises otherwise — the Python slice
    parser is the spec, not a production path).  ``mv_capacity=None``
    derives one stable distinct-MV bucket for the whole stream;
    ``0`` disables the mvset decomposition (gather MC).
    """
    data = bytes(data)
    arr = np.frombuffer(data, dtype=np.uint8)
    meta, seq, groups = walk_stream(data)
    pool = pool or BufferPool()
    # parse with the maximal capacity derivation: two passes would parse
    # twice, so parse every GOP first with capacity 0 (MVs land in mb_mv
    # regardless), then rebuild the mvset sideband once the stream-wide
    # bucket is known.
    gops = [parse_gop_packed(arr, g, seq, meta, 0, pool=pool,
                             n_threads=n_threads,
                             slice_threads=slice_threads, index=gi)
            for gi, g in enumerate(groups)]
    if mv_capacity is None:
        mv_capacity = mv_bucket(max(
            (gop_mv_capacity(g.fts) for g in gops), default=1))
    if mv_capacity:
        for g in gops:
            attach_mvset(g, mv_capacity, seq, meta)
    return PackedStream(meta=meta, seq=seq, gops=gops,
                        mv_capacity=mv_capacity)
