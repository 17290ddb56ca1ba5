"""jsvx benchmark: 1080p decode throughput on one GPU.

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "frames/s", "vs_baseline": N, ...}

Baseline: the reference WebGL player publishes no numbers; its implied
throughput is real-time playback (30 fps at 1080p).  The north star is
10x that on one device, so ``vs_baseline`` is fps / 300 (BASELINE.md).

Two measurements, in turn, in this one process (a second process on the
card would find three quarters of its memory already reserved):

1. the device metric: the resident 1080p GOP scan — GOP 0 of the bench
   fixture (1920x1088, zoom + half-pel pan, native-parsed) already on the
   device, decoded by ``decode_gop_scan`` with the platform's MC,
   median of several runs each ending in ``block_until_ready``;
2. end to end: ``transcode()`` of the whole fixture (host parse, wire
   upload, device decode), warm, median of three runs.

A run without a GPU exits non-zero: no number is ever reported under
the device metric's name from another platform.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

_T0 = time.monotonic()


def _stage(msg: str) -> None:
    """Stage progress to stderr (stdout stays the one JSON line)."""
    print(f"[bench +{time.monotonic() - _T0:.0f}s] {msg}",
          file=sys.stderr, flush=True)


def _zoom_clip(h: int, w: int, n: int, seed: int = 3) -> list:
    """Zooming + half-pel-translating band-limited pattern.

    A zoom makes the motion field vary across the frame (many distinct
    MVs) and a 1.5 px/frame pan lands on half-pel positions, so the
    4-tap interpolation path is inside the measured number (reference
    decoders/shaders/mpeg1video.js INTER_1).
    """
    rng = np.random.default_rng(seed)
    cy, cx = h / 2, w / 2
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    # rich 1/f texture: low components steer the motion search, high
    # components lose energy under half-pel interpolation (real residual
    # load), per-frame sensor noise keeps the coefficient planes dense
    n_comp = 40
    freq = rng.uniform(0.02, 1.4, (n_comp, 2))
    ph = rng.uniform(0, 2 * np.pi, n_comp)
    mag = np.linalg.norm(freq, axis=1)
    amp = 9.0 / np.sqrt(mag / mag.min())

    def tex(u, v):
        out = np.full(u.shape, 120.0)
        for (kyy, kxx), p, a in zip(freq, ph, amp):
            out += a * np.sin(kyy * u + kxx * v + p)
        return out

    zoom_rate = 3.0 / (w / 2)            # ~3 px at the side midpoints
    frames = []
    for t in range(n):
        s = 1.0 / (1.0 + zoom_rate * t)  # sample source = inverse zoom
        u = (yy - cy) * s + cy + 1.5 * t
        v = (xx - cx) * s + cx + 1.5 * t
        y = np.clip(tex(u, v) + rng.normal(0, 4, u.shape), 0, 255)
        cb = np.clip(128 + 24 * np.sin(0.05 * v[::2, ::2])
                     + rng.normal(0, 2, (h // 2, w // 2)), 0, 255)
        cr = np.clip(128 + 24 * np.cos(0.05 * u[::2, ::2])
                     + rng.normal(0, 2, (h // 2, w // 2)), 0, 255)
        frames.append(tuple(p.astype(np.uint8) for p in (y, cb, cr)))
    return frames


def _fixture_path() -> str:
    """Bench fixture path in the checkout, versioned by the encoder
    source + clip params so a fixture from an older encoder can never
    silently change the measured workload."""
    import hashlib

    import jsvx.tools.encoder as enc_mod
    from jsvx.runtime.compile_cache import CHECKOUT

    with open(enc_mod.__file__, "rb") as f:
        src = f.read()
    tag = hashlib.sha256(
        src + b"|1088x1920x8|gop4|q6|me8|halfpel|zoomclip-v1"
    ).hexdigest()[:10]
    return os.path.join(CHECKOUT, ".fixtures",
                        f"jsvx_bench_1080p_{tag}.jsv")


def ensure_fixture() -> str:
    """Create the 1080p bench fixture (8 frames, GOP 4, q=6, half-pel
    zoom) if missing; return its path."""
    fix = _fixture_path()
    if not os.path.exists(fix):
        from jsvx.tools.encoder import EncoderConfig, JsvEncoder

        _stage("encoding the 1080p fixture")
        h, w = 1088, 1920
        frames = _zoom_clip(h, w, 8)
        data = JsvEncoder(w, h, EncoderConfig(
            gop_size=4, quantizer_scale=6, me_range=8,
            half_pel_refine=True)).encode(frames)
        os.makedirs(os.path.dirname(fix), exist_ok=True)
        tmp = fix + f".tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, fix)
    return fix


def load_fixture_gops(data: bytes, mv_capacity: int | None = None):
    """Every GOP of a stream as dense ``decode_gop_scan`` inputs.

    Returns ``(stacked_gops, seq, stats)``: native-parsed coefficient
    planes plus, when ``mv_capacity`` is not 0, the distinct-MV sideband
    at one stream-wide capacity (``None`` derives it); and the content
    statistics (coded coefficients and distinct MVs per frame).
    """
    import jax

    from jsvx.pipeline.packed_parse import _mv_unique, parse_stream_packed

    parsed = parse_stream_packed(data, mv_capacity=mv_capacity)
    fts = [ft for g in parsed.gops for ft in g.fts]
    stats = {
        "coded_coefficients_per_frame": [
            sum(int(np.count_nonzero(lv)) for lv in ft.levels)
            for ft in fts],
        "distinct_mvs_per_frame": [len(_mv_unique(ft.mb_mv)[0])
                                   for ft in fts],
        "mv_capacity_bucket": parsed.mv_capacity,
    }
    # deep-copy out of the parser's pooled buffers
    gops = [jax.tree.map(np.array, g.stacked) for g in parsed.gops]
    return gops, parsed.seq, stats


def time_gop_scan(stacked, consts, coded_hw: tuple, reps: int = 7,
                  **kw) -> float:
    """Median seconds of one resident GOP scan (``decode_gop_scan``
    keyword arguments in ``kw``), each run ending in
    ``block_until_ready``; the first call compiles and is not timed."""
    import jax

    from jsvx.pipeline.gop import decode_gop_scan, zero_refs

    stacked = jax.device_put(stacked)
    refs = jax.device_put(zero_refs(*coded_hw))
    jax.block_until_ready(decode_gop_scan(stacked, refs, consts, **kw))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(decode_gop_scan(stacked, refs, consts, **kw))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def card() -> str:
    """``name, power.limit`` of the GPUs as nvidia-smi reports them (a
    child process that stays off JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def bench_end_to_end(data: bytes, runs: int = 3) -> dict:
    """``transcode()`` of the whole stream: one warm-up (compiles), then
    the median of ``runs`` timed runs.  The sink reads one pixel of
    every GOP, as a consumer of the frames would."""
    from jsvx.pipeline.transcode import transcode

    sink = lambda gi, outs: int(np.asarray(outs[0][-1][0, 0]))  # noqa: E731
    t0 = time.perf_counter()
    transcode(data, sink=sink)
    cold = time.perf_counter() - t0
    times, stages = [], []
    for _ in range(runs):
        t0 = time.perf_counter()
        res = transcode(data, sink=sink)
        times.append(time.perf_counter() - t0)
        stages.append({k: v["total_s"]
                       for k, v in res.metrics.timers.report().items()})
    i = int(np.argsort(times)[len(times) // 2])
    return {
        "end_to_end_1080p_frames_per_s": res.n_frames / times[i],
        "end_to_end_cold_s": cold,
        "stage_seconds": stages[i],
        "n_frames": res.n_frames,
        "wire_bytes": int(res.metrics.gauges.get("wire_bytes", 0)),
    }


def main() -> int:
    import jax

    from jsvx.kernels.decode import make_constants
    from jsvx.pipeline.gop import decode_backend
    from jsvx.runtime.compile_cache import enable_compile_cache

    cache_dir = enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py: needs a GPU, found platform {dev.platform!r}",
              file=sys.stderr)
        return 1
    mc_impl = decode_backend()
    data = open(ensure_fixture(), "rb").read()
    gops, seq, stats = load_fixture_gops(
        data, mv_capacity=None if mc_impl == "mvset" else 0)
    consts = make_constants(seq)
    n_frames = int(gops[0]["is_p"].shape[0])
    _stage("fixture parsed")
    scan_s = time_gop_scan(gops[0], consts,
                           (seq.coded_height, seq.coded_width))
    fps = n_frames / scan_s
    _stage("device metric done")
    e2e = bench_end_to_end(data)
    _stage("end to end done")
    out = {
        "metric": "1080p_device_decode_frames_per_s_per_chip",
        "value": fps,
        "unit": "frames/s",
        "vs_baseline": fps / 300.0,
        "gop_scan_s": scan_s,
        "frames_per_gop": n_frames,
        "mc_impl": mc_impl,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card(),
        "compile_cache": cache_dir,
        "device_metric_content": {
            "source": "1080p bench fixture GOP 0 (native parse)", **stats},
        "host_cores": os.cpu_count(),
        "bench_wall_s": time.monotonic() - _T0,
    }
    out.update(e2e)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
