"""Smoke test of the 1080p decode path on one GPU.

Runs in one process, phase by phase, and fails (non-zero exit, no result
line) at the first phase that fails:

1. device facts: platform, kind, count, JAX version, ``XLA_FLAGS``, the
   compile cache, the native parser, and the card's name and power limit;
2. refusals: no GPU, or no native parser, is a failure;
3. a short compile check of the GOP step at 1080p for both MC
   formulations, with its ``memory_analysis()``;
4. correctness of both MC formulations (per-pixel gather, the GPU's,
   and distinct-MV mvset) on the 96x128 gate stream, a 1920x1088
   synthetic P frame and GOP 0 of the 1080p fixture: each plane within
   +-1 of the float64
   oracle carried along its own reference chain, min PSNR at least the
   reference integer path's; and the count of planes that differ from
   the same decode on the CPU;
5. the main path through the user entry points: ``transcode()`` cold
   and warm, ``Decoder`` (GOP-batch and per-frame; planes must equal
   transcode's) and a headless ``Player`` at rate 1.0;
6. timing of the resident 1080p GOP scan per MC formulation, and the
   gather-vs-mvset MC table (``jsvx.tools.bench_mc``);
7. the last line: ``{"ok": true, "device": {...}}``.

``--four`` runs only the multi-device path (``jsvx.shard``) on four
devices: ``decode_gops_2d_sharded`` on a (gop=2, rows=2) mesh and
``decode_gops_parallel`` on a gop=4 mesh over the fixture's GOPs, each
compared bit for bit with the single-device scan.

Run: ``python chip_smoke.py [--four]``
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import time

import numpy as np

import jsvx  # noqa: F401  (fails at once outside a checkout)


def log(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}, default=str), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


# ---------------------------------------------------------------------------
# 1-2. device facts and refusals

def device_facts() -> dict:
    import jax

    import bench
    from jsvx.bitstream.native import get_native_parser
    from jsvx.runtime.compile_cache import enable_compile_cache

    cache_dir = enable_compile_cache()
    devs = jax.devices()
    facts = {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs), "jax": jax.__version__,
        "XLA_FLAGS": os.environ.get("XLA_FLAGS", ""),
        "compile_cache": cache_dir,
        "native_parser": get_native_parser() is not None,
    }
    check(facts["platform"] == "gpu",
          f"needs a GPU, JAX found platform {facts['platform']!r}")
    check(facts["native_parser"], "the native parser did not build/load")
    facts["card"] = bench.card()
    log("device", **facts)
    print(facts["card"], flush=True)
    return facts


# ---------------------------------------------------------------------------
# inputs

MC_IMPLS = ("gather", "mvset")


def gate_stream() -> bytes:
    """The 96x128 correctness-gate stream (6 frames, GOP 3, q=6)."""
    from jsvx.tools.encoder import EncoderConfig, JsvEncoder

    rng = np.random.default_rng(7)
    h, w = 96, 128
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for t in range(6):
        y = np.clip(110 + 70 * np.sin(2 * np.pi * (xx + 4 * t) / w)
                    + rng.normal(0, 6, (h, w)), 0, 255)
        cb = np.clip(128 + 30 * np.sin(2 * np.pi * xx[::2, ::2] / w), 0, 255)
        cr = np.clip(128 + 30 * np.cos(2 * np.pi * yy[::2, ::2] / h), 0, 255)
        frames.append(tuple(p.astype(np.uint8) for p in (y, cb, cr)))
    return JsvEncoder(w, h, EncoderConfig(
        gop_size=3, quantizer_scale=6, me_range=4,
        half_pel_refine=True)).encode(frames)


def stream_frames(data: bytes) -> tuple:
    """(FrameTensors list, seq) of a whole stream via the shared parser."""
    from jsvx.pipeline.stream import JaxStreamDecoder

    d = JaxStreamDecoder(data)
    fts = d.parse_all()
    return fts, d.parser.seq


def synthetic_p_frame(mb_h: int = 68, mb_w: int = 120, seed: int = 23):
    """A 1920x1088 P picture with macroblock-consistent random sideband
    (5% intra MBs, vectors up to +-24 half-pel incl. out-of-picture
    reach, low-frequency coefficients) and random reference planes."""
    from jsvx.bitstream.parser import FrameTensors, SequenceInfo
    from jsvx.coding import tables as T

    rng = np.random.default_rng(seed)
    seq = SequenceInfo(width=mb_w * 16, height=mb_h * 16, picture_rate=30.0,
                       bit_rate=0, vbv_buffer_bytes=0,
                       intra_q=T.DEFAULT_INTRA_QUANT_MATRIX,
                       non_intra_q=T.DEFAULT_NON_INTRA_QUANT_MATRIX)
    intra = (rng.random((mb_h, mb_w)) < 0.05).astype(np.uint8)
    mv = rng.integers(-24, 25, (mb_h, mb_w, 2)).astype(np.int16)
    mv[intra > 0] = 0
    levels, lnz = [], []
    for rep in (2, 1, 1):
        bh, bw = mb_h * rep, mb_w * rep
        lv = np.zeros((bh * 8, bw * 8), np.int16)
        lv.reshape(bh, 8, bw, 8).swapaxes(1, 2)[:, :, :3, :3] = \
            rng.integers(-80, 81, (bh, bw, 3, 3))
        levels.append(lv)
        lnz.append(rng.integers(1, 12, (bh, bw)).astype(np.uint8))
    ft = FrameTensors(
        picture_type=T.PICTURE_TYPE_P, temporal_ref=1, full_pel=False,
        f_code=2, gop_time_ms=0.0, levels=tuple(levels), lnz=tuple(lnz),
        mb_quant=rng.integers(2, 12, (mb_h, mb_w)).astype(np.uint8),
        mb_intra=intra, mb_mv=mv, mb_rep_add=intra.copy())
    refs = tuple(rng.integers(0, 256, s, np.uint8)
                 for s in ((mb_h * 16, mb_w * 16), (mb_h * 8, mb_w * 8),
                           (mb_h * 8, mb_w * 8)))
    return [ft], seq, refs


# ---------------------------------------------------------------------------
# 3. compile check

def compile_check(fts, seq) -> None:
    from jsvx.kernels.decode import frame_to_device, make_constants, \
        mv_bucket
    from jsvx.pipeline import gop
    from jsvx.pipeline.gop import stack_device_frames, zero_refs

    consts = make_constants(seq)
    refs = zero_refs(seq.coded_height, seq.coded_width)
    cap = mv_bucket(max(len(np.unique(ft.mb_mv.reshape(-1, 2), axis=0)) + 1
                        for ft in fts))
    for mc_impl in MC_IMPLS:
        stacked = stack_device_frames([frame_to_device(
            ft, mv_capacity=cap if mc_impl == "mvset" else 0) for ft in fts])
        t0 = time.perf_counter()
        compiled = gop._decode_gop_scan.lower(
            stacked, refs, consts, False, mc_impl).compile()
        ma = compiled.memory_analysis()
        log("compile", step=f"GOP scan, {mc_impl} MC, {len(fts)} frames "
            f"{seq.coded_width}x{seq.coded_height}",
            seconds=time.perf_counter() - t0,
            memory_analysis={k: getattr(ma, k) for k in (
                "argument_size_in_bytes", "output_size_in_bytes",
                "temp_size_in_bytes", "generated_code_size_in_bytes")})


# ---------------------------------------------------------------------------
# 4. correctness

def decode_chain(fts, seq, refs, mc_impl: str, device=None) -> list:
    """Per-frame decode carrying the path's own reference chain."""
    import jax

    from jsvx.kernels.decode import (decode_frame_jit, frame_to_device,
                                     make_constants, mv_bucket)
    from jsvx.pipeline.gop import zero_refs

    out = []
    with jax.default_device(device) if device is not None \
            else contextlib.nullcontext():
        consts = make_constants(seq)
        if refs is None:
            refs = zero_refs(seq.coded_height, seq.coded_width)
        for ft in fts:
            cap = 0
            if mc_impl == "mvset":
                cap = mv_bucket(len(np.unique(ft.mb_mv.reshape(-1, 2),
                                              axis=0)) + 1)
            planes = decode_frame_jit(frame_to_device(ft, mv_capacity=cap),
                                      refs, consts, mc_impl=mc_impl)
            planes = tuple(np.asarray(p) for p in planes)
            out.append(planes)
            refs = planes
    return out


def oracle_chains(fts, seq, refs) -> tuple:
    from jsvx.tools.oracle import reconstruct_frame, reconstruct_frame_intsim

    oracle, intsim = [], []
    ro = ri = refs
    for ft in fts:
        ro = reconstruct_frame(ft, seq, ro)
        ri = reconstruct_frame_intsim(ft, seq, ri)
        oracle.append(ro)
        intsim.append(ri)
    return oracle, intsim


def correctness(name: str, fts, seq, refs=None) -> None:
    import jax

    from jsvx.tools.psnr import psnr

    oracle, intsim = oracle_chains(fts, seq, refs)
    int_psnr = min(psnr(s, o) for fs, fo in zip(intsim, oracle)
                   for s, o in zip(fs, fo))
    cpu = decode_chain(fts, seq, refs, "gather",
                       device=jax.devices("cpu")[0])
    for mc_impl in MC_IMPLS:
        got = decode_chain(fts, seq, refs, mc_impl)
        max_err = max(int(np.abs(g.astype(int) - o.astype(int)).max())
                      for fg, fo in zip(got, oracle)
                      for g, o in zip(fg, fo))
        dev_psnr = min(psnr(g, o) for fg, fo in zip(got, oracle)
                       for g, o in zip(fg, fo))
        diffs = [(int((g != c).sum()),
                  int(np.abs(g.astype(int) - c.astype(int)).max()))
                 for fg, fc in zip(got, cpu) for g, c in zip(fg, fc)]
        bad = [d for d in diffs if d[0]]
        log("correctness", input=name, mc_impl=mc_impl,
            planes=len(diffs), max_abs_err_vs_oracle=max_err,
            min_psnr_db=dev_psnr, intsim_min_psnr_db=int_psnr,
            planes_differing_from_cpu=len(bad),
            cpu_diff_pixels_and_max=bad)
        check(max_err <= 1, f"{name} {mc_impl}: |err| {max_err} > 1")
        check(dev_psnr >= int_psnr,
              f"{name} {mc_impl}: PSNR {dev_psnr} < {int_psnr}")


# ---------------------------------------------------------------------------
# 5. main path

def main_path(data: bytes, path: str) -> None:
    from jsvx.__main__ import main as cli_main
    from jsvx.api import Decoder, PlayerConfig
    from jsvx.pipeline.transcode import transcode

    got = {}

    def sink(gi, outs):
        got[gi] = [np.asarray(p) for p in outs]

    for run in ("cold", "warm"):
        t0 = time.perf_counter()
        res = transcode(data, sink=sink)
        dt = time.perf_counter() - t0
        log("transcode", run=run, frames=res.n_frames, seconds=dt,
            frames_per_s=res.n_frames / dt,
            stage_seconds={k: v["total_s"] for k, v in
                           res.metrics.timers.report().items()})
    ref = [tuple(p[i] for p in got[gi]) for gi in sorted(got)
           for i in range(got[gi][0].shape[0])]
    check(len(ref) == 8, f"transcode gave {len(ref)} frames, not 8")

    for use_gop_scan in (True, False):
        dec = Decoder(PlayerConfig(use_gop_scan=use_gop_scan))
        dec.feed(0, data, len(data))
        frames = [tuple(np.asarray(p) for p in f.planes)
                  for f in dec.iter_frames()]
        same = len(frames) == len(ref) and all(
            np.array_equal(a, b) for fa, fb in zip(frames, ref)
            for a, b in zip(fa, fb))
        log("decoder", gop_batch=use_gop_scan, frames=len(frames),
            ended=dec.ended, equals_transcode=same)
        check(same and dec.ended,
              f"Decoder(use_gop_scan={use_gop_scan}) != transcode")

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli_main(["play", path, "--seconds", "60", "--rate", "1.0"])
    rep = json.loads(out.getvalue().strip().splitlines()[-1])
    log("player", rc=rc, frames_shown=rep["frames_shown"],
        late_skips=rep["late_skips"], ended=rep["ended"],
        error=rep["error"], wall_seconds=rep["wall_seconds"])
    check(rc == 0 and rep["error"] is None, f"Player error {rep['error']}")
    check(rep["ended"] and rep["frames_shown"] > 0,
          "Player did not play the fixture to its end")


# ---------------------------------------------------------------------------
# 6. timing

def timing(gops_by_mc: dict, seq, card: str) -> None:
    import bench
    from jsvx.kernels.decode import make_constants
    from jsvx.tools.bench_mc import mc_table

    consts = make_constants(seq)
    hw = (seq.coded_height, seq.coded_width)
    for mc_impl in MC_IMPLS:
        stacked = gops_by_mc[mc_impl][0]
        n = int(stacked["is_p"].shape[0])
        s = bench.time_gop_scan(stacked, consts, hw, mc_impl=mc_impl)
        log("timing", what="resident 1080p GOP scan",
            mc_impl=mc_impl, frames=n, median_s=s,
            frames_per_s=n / s, card=card)
    log("timing", what="MC per 1920x1088 luma plane (median ms)",
        rows=mc_table(), card=card)


# ---------------------------------------------------------------------------
# --four: the multi-device path

def multi_device(data: bytes, devices) -> dict:
    """The ``jsvx.shard`` path over ``devices`` (4 on the card, any even
    count >= 2 on virtual CPU devices), each compared bit for bit with
    the single-device scan of the same GOPs."""
    import jax

    import bench
    from jsvx.kernels.decode import make_constants
    from jsvx.pipeline.gop import decode_backend, decode_gop_scan, zero_refs
    from jsvx.shard import (build_mesh, decode_gops_2d_sharded,
                            decode_gops_parallel)
    from jsvx.shard.slice_rows import derive_halo_y

    n = len(devices)
    mc_impl = decode_backend()
    gops, seq, _ = bench.load_fixture_gops(
        data, mv_capacity=None if mc_impl == "mvset" else 0)
    consts = make_constants(seq)
    h, w = seq.coded_height, seq.coded_width
    batch = jax.tree.map(lambda *xs: np.stack(xs), *gops)
    n_gops = len(gops)
    with jax.default_device(devices[0]):
        single = [[np.asarray(p) for p in decode_gop_scan(
            g, zero_refs(h, w), consts)[0]] for g in gops]

    def same(outs, ref, gop_ids):
        return all(np.array_equal(np.asarray(outs[c][i]), ref[g][c])
                   for i, g in enumerate(gop_ids) for c in range(3))

    mesh = build_mesh({"gop": 2, "rows": n // 2}, devices=devices)
    refs = tuple(np.zeros((n_gops,) + s, np.uint8)
                 for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2)))
    halo_y = derive_halo_y(batch)          # static: outside the jit
    outs, _ = jax.jit(lambda b, r: decode_gops_2d_sharded(
        b, r, consts, mesh, halo_y=halo_y))(batch, refs)
    rows_ok = same(outs, single, range(n_gops))

    mesh = build_mesh({"gop": n}, devices=devices)
    ids = [i % n_gops for i in range(n)]
    tiled = jax.tree.map(lambda x: x[np.array(ids)], batch)
    outs, _ = decode_gops_parallel(tiled, h, w, consts, mesh)
    gop_ok = same(outs, single, ids)
    res = {"devices": n, "gops": n_gops, "mc_impl": mc_impl,
           "gop_rows_2d_bit_equal": rows_ok,
           "gop_parallel_bit_equal": gop_ok}
    log("multi_device", **res)
    check(rows_ok, "decode_gops_2d_sharded != single-device scan")
    check(gop_ok, "decode_gops_parallel != single-device scan")
    return res


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-device jsvx.shard path")
    args = ap.parse_args(argv)

    import jax

    import bench

    t_start = time.monotonic()
    facts = device_facts()
    path = bench.ensure_fixture()
    data = open(path, "rb").read()
    if args.four:
        check(facts["count"] >= 4, f"--four needs 4 devices, "
              f"found {facts['count']}")
        multi_device(data, jax.devices()[:4])
        count = 4                      # the devices the path ran on
    else:
        fix_fts, fix_seq = stream_frames(data)
        syn_fts, syn_seq, syn_refs = synthetic_p_frame()
        compile_check(fix_fts[:4], fix_seq)
        correctness("gate 96x128", *stream_frames(gate_stream()))
        correctness("synthetic P 1920x1088", syn_fts, syn_seq, syn_refs)
        correctness("fixture GOP 0 1920x1088", fix_fts[:4], fix_seq)
        main_path(data, path)
        gops_by_mc = {mc: bench.load_fixture_gops(
            data, mv_capacity=None if mc == "mvset" else 0)[0]
            for mc in ("gather", "mvset")}
        timing(gops_by_mc, fix_seq, facts["card"])
        count = facts["count"]
    log("done", wall_seconds=time.monotonic() - t_start)
    print(json.dumps({"ok": True, "device": {
        "platform": facts["platform"], "kind": facts["kind"],
        "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
