"""jsvx command line: info / decode / encode / bench / play / warm.

Usage:
  python -m jsvx info CLIP.jsv
  python -m jsvx decode CLIP.jsv OUT_DIR [--rgb] [--impl device|oracle]
  python -m jsvx encode FRAMES.npy CLIP.jsv [--gop 12] [--q 8]
  python -m jsvx bench CLIP.jsv
  python -m jsvx play CLIP.jsv [--seconds 30] [--rate 1.0] [--audio X.wav]
  python -m jsvx warm CLIP.jsv | --shape 1920x1088 [--gop 4] [--q 6]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def cmd_info(args) -> int:
    from .bitstream.bitio import BitReader
    from .bitstream.container import StartCodeIndex, parse_container_header
    from .coding import tables as T

    data = open(args.stream, "rb").read()
    meta = parse_container_header(BitReader(data))
    idx = StartCodeIndex.scan(data)
    codes = idx.entries[:, 1]
    info = {
        "bytes": len(data),
        "width": meta.width,
        "height": meta.height,
        "duration_s": meta.duration,
        "yuva": meta.yuva,
        "gop_key_map": meta.key_map.count if meta.key_map else 0,
        "sequences": int(np.count_nonzero(codes == T.START_SEQUENCE)),
        "gops": int(np.count_nonzero(codes == T.START_GOP)),
        "pictures": int(np.count_nonzero(codes == T.START_PICTURE)),
    }
    print(json.dumps(info, indent=2))
    return 0


def cmd_decode(args) -> int:
    data = open(args.stream, "rb").read()
    os.makedirs(args.out_dir, exist_ok=True)
    t0 = time.perf_counter()
    if args.impl == "oracle":
        from .tools.oracle import decode_stream_oracle

        frames = [(f.planes, f.picture_type)
                  for f in decode_stream_oracle(data)]
    else:
        from .pipeline.stream import JaxStreamDecoder

        res = JaxStreamDecoder(data).decode()
        frames = [(tuple(np.asarray(p) for p in f), t)
                  for f, t in zip(res.frames, res.picture_types)]
    dt = time.perf_counter() - t0

    from .tools.refmath import ycbcr_to_rgb

    for i, (planes, _ptype) in enumerate(frames):
        if args.rgb:
            rgb = ycbcr_to_rgb(*planes)
            _write_ppm(os.path.join(args.out_dir, f"frame_{i:05d}.ppm"),
                       rgb)
        else:
            np.savez(os.path.join(args.out_dir, f"frame_{i:05d}.npz"),
                     y=planes[0], cb=planes[1], cr=planes[2])
    print(json.dumps({"frames": len(frames), "seconds": round(dt, 3),
                      "fps": round(len(frames) / dt, 1)}))
    return 0


def _write_ppm(path: str, rgb: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (rgb.shape[1], rgb.shape[0]))
        f.write(rgb.tobytes())


def cmd_encode(args) -> int:
    from .tools.encoder import EncoderConfig, JsvEncoder

    arr = np.load(args.frames)
    if isinstance(arr, np.lib.npyio.NpzFile):
        ys, cbs, crs = arr["y"], arr["cb"], arr["cr"]
        frames = [(ys[i], cbs[i], crs[i]) for i in range(ys.shape[0])]
    else:
        # (N, H, W, 3) RGB
        from .tools.encoder import rgb_to_ycbcr

        frames = [rgb_to_ycbcr(arr[i]) for i in range(arr.shape[0])]
    h, w = frames[0][0].shape
    data = JsvEncoder(w, h, EncoderConfig(
        gop_size=args.gop, quantizer_scale=args.q)).encode(frames)
    with open(args.out, "wb") as f:
        f.write(data)
    print(json.dumps({"frames": len(frames), "bytes": len(data)}))
    return 0


def cmd_bench(args) -> int:
    from .pipeline.transcode import transcode
    from .runtime.profiler import device_trace

    data = open(args.stream, "rb").read()
    t0 = time.perf_counter()
    with device_trace(args.trace):
        res = transcode(data)
    dt = time.perf_counter() - t0
    out = res.metrics.to_dict()
    out["fps_end_to_end"] = round(res.n_frames / dt, 1)
    if args.trace:
        out["trace_dir"] = args.trace
    print(json.dumps(out, indent=2))
    return 0


def cmd_play(args) -> int:
    """Drive ``Player.run_realtime`` over a file/HTTP source with the
    A/V clock and a headless frame sink — the user-facing loop that ties
    network -> buffer -> decode -> display together outside pytest (the
    reference's demo page role, ``/root/reference/README.md:10``;
    render loop ``player/easybits.player.js:2451-2505``).

    Prints a JSON report at exit: frames shown, effective display fps,
    late-frame skips, played ranges, and the event stream counts.
    """
    from .api.player import Player, PlayerConfig, WallClockAudio

    cfg = PlayerConfig(skip_hard=args.skip_hard, emit_rgb=args.rgb)
    audio = None
    if args.audio:
        audio = WallClockAudio(open(args.audio, "rb").read())
    p = Player(config=cfg, audio_clock=audio)
    counts: dict[str, int] = {}
    order: list[str] = []
    for ev in ("loadstart", "progress", "loadedmetadata", "canplay",
               "canplaythrough", "playing", "waiting", "stalled",
               "unstalled", "seeking", "seeked", "timeupdate", "ended",
               "error", "bitratechange", "suspend"):
        def bump(*a, _e=ev):
            counts[_e] = counts.get(_e, 0) + 1
            if _e != "timeupdate" and (not order or order[-1] != _e):
                order.append(_e)
        p.on(ev, bump)
    shown: list[float] = []
    p.set_frame_sink(lambda f, t: shown.append(t))
    p.src = args.stream
    p.playback_rate = args.rate
    if args.start:
        # seek before playback (GOP-key-map assisted, <= 150 ms
        # precision — decoders/jsv.js:1618-1648)
        p.current_time = args.start
    p.play()
    p.run_realtime()
    t0 = time.monotonic()
    try:
        while (time.monotonic() - t0 < args.seconds
               and not counts.get("ended") and p.error is None):
            time.sleep(0.02)
    finally:
        wall = time.monotonic() - t0
        p.stop_realtime()
        pr = p.played
        ranges = [(pr.start(i), pr.end(i)) for i in range(pr.length)]
        report = {
            "stream": args.stream,
            "wall_seconds": round(wall, 2),
            "playback_rate": args.rate,
            "frames_shown": len(shown),
            "display_fps": round(len(shown) / wall, 1) if wall else 0.0,
            "media_seconds_played": round(
                sum(b - a for a, b in ranges), 2),
            "played_ranges": [[round(a, 2), round(b, 2)]
                              for a, b in ranges],
            "late_skips": int(p.metrics.counters.get("late_skips", 0)),
            "current_time": round(p.current_time, 2),
            "ended": bool(counts.get("ended")),
            "error": str(p.error) if p.error else None,
            "events": counts,
            "event_order": order[:24],
        }
        p.destroy()
        print(json.dumps(report))
    return 0 if report["error"] is None else 1


def cmd_warm(args) -> int:
    """Populate the persistent XLA compile cache for the decode + wire
    programs at a given shape: a deployment runs
    ``jsvx warm`` ahead of traffic (with a representative stream — the
    compiled program identity depends on the stream's coefficient-bucket
    and MV-capacity shapes) so the first real decode starts in seconds.

    Prints the cold (this run's compile) and warm (second transcode)
    wall times.
    """
    from .runtime.compile_cache import enable_compile_cache

    # warming is the point: persist every program, even fast ones
    cache_dir = enable_compile_cache(min_compile_time_secs=0.0)
    if args.stream:
        data = open(args.stream, "rb").read()
        src = args.stream
    else:
        if not args.shape:
            print("warm: need a stream path or --shape WxH",
                  file=sys.stderr)
            return 2
        w, h = (int(x) for x in args.shape.lower().split("x"))
        import hashlib
        import tempfile

        from .tools.encoder import EncoderConfig, JsvEncoder

        tag = hashlib.sha256(
            f"{w}x{h}|g{args.gop}|q{args.q}".encode()).hexdigest()[:8]
        src = os.path.join(tempfile.gettempdir(), f"jsvx_warm_{tag}.jsv")
        if not os.path.exists(src):
            rng = np.random.default_rng(11)
            yy, xx = np.mgrid[0:h, 0:w]
            frames = []
            for t in range(2 * args.gop):
                y = np.clip(120 + 60 * np.sin(2 * np.pi * (xx + 3 * t) / w)
                            + rng.normal(0, 5, (h, w)), 0, 255)
                cb = np.clip(128 + 24 * np.sin(
                    2 * np.pi * xx[::2, ::2] / w), 0, 255)
                cr = np.clip(128 + 24 * np.cos(
                    2 * np.pi * yy[::2, ::2] / h), 0, 255)
                frames.append(tuple(p.astype(np.uint8)
                                    for p in (y, cb, cr)))
            data = JsvEncoder(w, h, EncoderConfig(
                gop_size=args.gop, quantizer_scale=args.q,
                me_range=4, half_pel_refine=True)).encode(frames)
            tmp = src + f".tmp{os.getpid()}"
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, src)
        data = open(src, "rb").read()

    from .pipeline.transcode import transcode

    sink = lambda gi, outs: np.asarray(outs[0][-1][0, 0])  # noqa: E731
    t0 = time.perf_counter()
    res = transcode(data, sink=sink)
    cold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = transcode(data, sink=sink)
    warm_s = time.perf_counter() - t0
    print(json.dumps({
        "stream": src,
        "cache_dir": cache_dir,
        "frames": res.n_frames,
        "compile_plus_first_decode_s": round(cold_s, 1),
        "warm_decode_s": round(warm_s, 2),
        "warm_fps": round(res.n_frames / warm_s, 1),
        "note": ("re-run this command after restarts that clear the "
                 "cache dir; compiled-program identity follows the "
                 "stream's shape + coefficient buckets"),
    }))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="jsvx")
    sub = p.add_subparsers(dest="cmd", required=True)

    pi = sub.add_parser("info")
    pi.add_argument("stream")
    pi.set_defaults(fn=cmd_info)

    pd = sub.add_parser("decode")
    pd.add_argument("stream")
    pd.add_argument("out_dir")
    pd.add_argument("--rgb", action="store_true")
    pd.add_argument("--impl", default="device",
                    choices=["device", "oracle"],
                    help="decode on the JAX device (kernels chosen by "
                         "platform) or with the float64 oracle")
    pd.set_defaults(fn=cmd_decode)

    pe = sub.add_parser("encode")
    pe.add_argument("frames")
    pe.add_argument("out")
    pe.add_argument("--gop", type=int, default=12)
    pe.add_argument("--q", type=int, default=8)
    pe.set_defaults(fn=cmd_encode)

    pb = sub.add_parser("bench")
    pb.add_argument("stream")
    pb.add_argument("--trace", default=None, metavar="DIR",
                    help="write a jax.profiler device trace to DIR")
    pb.set_defaults(fn=cmd_bench)

    pp = sub.add_parser("play")
    pp.add_argument("stream")
    pp.add_argument("--seconds", type=float, default=30.0,
                    help="max wall-clock run time")
    pp.add_argument("--rate", type=float, default=1.0,
                    help="playback rate (>1 = faster than realtime)")
    pp.add_argument("--start", type=float, default=0.0,
                    help="seek to this time (s) before playing")
    pp.add_argument("--audio", default=None, metavar="WAV",
                    help="companion WAV for the A/V clock")
    pp.add_argument("--skip-hard", action="store_true",
                    help="drop late frames aggressively")
    pp.add_argument("--rgb", action="store_true",
                    help="convert frames to RGB in the sink")
    pp.set_defaults(fn=cmd_play)

    pw = sub.add_parser("warm")
    pw.add_argument("stream", nargs="?", default=None,
                    help="representative stream to warm with")
    pw.add_argument("--shape", default=None, metavar="WxH",
                    help="synthesize a warm stream at this size")
    pw.add_argument("--gop", type=int, default=4)
    pw.add_argument("--q", type=int, default=6)
    pw.set_defaults(fn=cmd_warm)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
