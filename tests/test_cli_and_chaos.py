"""CLI tool, fault injection, iter_frames, 2-axis sharded decode."""

import json
import os

import numpy as np
import pytest

from jsvx.__main__ import main as cli_main
from jsvx.api import Decoder, Player, PlayerConfig
from jsvx.runtime.source import ChaosSource, MemorySource
from jsvx.tools.encoder import EncoderConfig, JsvEncoder

from conftest import synthetic_frames


@pytest.fixture(scope="module")
def stream_file(tmp_path_factory):
    clip = synthetic_frames(6, 48, 64, seed=31)
    data = JsvEncoder(64, 48, EncoderConfig(
        gop_size=3, quantizer_scale=4)).encode(clip)
    path = tmp_path_factory.mktemp("cli") / "clip.jsv"
    path.write_bytes(data)
    return str(path), data, clip


def test_cli_info(stream_file, capsys):
    path, data, clip = stream_file
    assert cli_main(["info", path]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["width"] == 64 and info["height"] == 48
    assert info["pictures"] == 6 and info["gops"] == 2
    assert info["gop_key_map"] == 2


def test_cli_decode_rgb(stream_file, tmp_path, capsys):
    path, data, clip = stream_file
    out = str(tmp_path / "frames")
    assert cli_main(["decode", path, out, "--rgb", "--impl", "oracle"]) == 0
    res = json.loads(capsys.readouterr().out)
    assert res["frames"] == 6
    ppms = sorted(os.listdir(out))
    assert len(ppms) == 6 and ppms[0].endswith(".ppm")
    head = open(os.path.join(out, ppms[0]), "rb").read(20)
    assert head.startswith(b"P6\n64 48\n255\n")


def test_cli_bench_with_device_trace(stream_file, tmp_path, capsys):
    """`jsvx bench --trace DIR` wraps the run in jax.profiler.trace and
    leaves a trace artifact behind."""
    path, _, _ = stream_file
    trace_dir = str(tmp_path / "trace")
    assert cli_main(["bench", path, "--trace", trace_dir]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["trace_dir"] == trace_dir
    assert out["fps_end_to_end"] > 0
    found = [f for _, _, fs in os.walk(trace_dir) for f in fs]
    assert found, "profiler wrote no trace files"


def test_cli_play_realtime(stream_file, capsys):
    """`jsvx play` drives Player.run_realtime over a file source with a
    headless sink in faster-than-realtime mode and reports the played
    range + event stream at exit (VERDICT r4 #7; the reference's demo
    page as integration test, README.md:10)."""
    path, _, _ = stream_file
    assert cli_main(["play", path, "--seconds", "20",
                     "--rate", "16"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["ended"] is True and rep["error"] is None
    assert rep["frames_shown"] == 6
    # 6 frames at 30 fps = 0.2 s of media, one contiguous played range
    assert rep["played_ranges"] == [[0.0, 0.2]]
    assert rep["events"]["playing"] >= 1 and rep["events"]["ended"] == 1
    assert rep["event_order"][0] == "loadstart"
    assert rep["event_order"][-1] == "ended"
    assert rep["events"].get("canplay", 0) >= 1


def test_cli_play_over_http(stream_file, capsys):
    """`jsvx play http://...` ties the WHOLE stack together: ranged
    HTTP fetch -> sparse buffer -> decode -> realtime clock -> sink
    (the reference's demo-page loop over its XHR loader)."""
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    _, data, _ = stream_file

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_HEAD(self):
            self.send_response(200)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()

        def do_GET(self):
            rng = self.headers.get("Range")
            if rng:
                s, e = rng.split("=")[1].split("-")
                s = int(s)
                e = min(int(e) if e else len(data) - 1, len(data) - 1)
                body = data[s:e + 1]
                self.send_response(206)
                self.send_header("Content-Range",
                                 f"bytes {s}-{e}/{len(data)}")
            else:
                body = data
                self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}/clip.jsv"
        assert cli_main(["play", url, "--seconds", "20",
                         "--rate", "16"]) == 0
        rep = json.loads(capsys.readouterr().out)
        assert rep["ended"] is True and rep["error"] is None
        assert rep["frames_shown"] == 6
        # ranged-HTTP chunk delivery fired progress events
        assert rep["events"].get("progress", 0) >= 1
    finally:
        srv.shutdown()
        srv.server_close()


def test_cli_play_with_start_seek(stream_file, capsys):
    """`jsvx play --start T` seeks (key-map assisted, <=150 ms) before
    the realtime loop: played range starts at the second GOP."""
    path, _, _ = stream_file
    # 6 frames at 30 fps, gop_size 3 -> GOP 1 starts at t=0.1; a target
    # of 0.19 is > 150 ms from GOP 0, so the key-map seek must land on
    # GOP 1 (within precision), skipping the first GOP's frames
    assert cli_main(["play", path, "--seconds", "20", "--rate", "16",
                     "--start", "0.19"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["ended"] is True and rep["error"] is None
    assert rep["frames_shown"] == 3
    (a, b), = rep["played_ranges"]
    assert abs(a - 0.1) <= 0.151 and abs(b - 0.2) < 1e-6


def test_cli_play_with_wav_audio_clock(stream_file, tmp_path, capsys):
    """`jsvx play --audio X.wav` drives the A/V sync against a
    WallClockAudio parsed from a RIFF/WAVE header."""
    path, _, _ = stream_file
    byte_rate = 8000
    fmt = (b"fmt " + (16).to_bytes(4, "little")
           + (1).to_bytes(2, "little") + (1).to_bytes(2, "little")
           + (8000).to_bytes(4, "little")
           + byte_rate.to_bytes(4, "little")
           + (1).to_bytes(2, "little") + (8).to_bytes(2, "little"))
    dat = b"data" + (4000).to_bytes(4, "little") + bytes(4000)  # 0.5 s
    body = b"WAVE" + fmt + dat
    wav = tmp_path / "a.wav"
    wav.write_bytes(b"RIFF" + len(body).to_bytes(4, "little") + body)
    assert cli_main(["play", path, "--seconds", "20", "--rate", "8",
                     "--audio", str(wav)]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["ended"] is True and rep["frames_shown"] == 6


def test_cli_play_wall_clock_pacing(stream_file, capsys):
    """At rate 1.0 the realtime loop paces frames by the stream clock:
    a 0.2 s clip must take >= 0.15 s wall and show every frame."""
    import time as _t

    path, _, _ = stream_file
    t0 = _t.monotonic()
    assert cli_main(["play", path, "--seconds", "20"]) == 0
    wall = _t.monotonic() - t0
    rep = json.loads(capsys.readouterr().out)
    assert rep["frames_shown"] == 6 and rep["ended"] is True
    assert wall >= 0.15


def test_cli_warm_populates_cache(tmp_path, capsys, monkeypatch):
    """`jsvx warm STREAM` compiles the decode+wire programs into the
    persistent cache and reports cold vs warm decode times (VERDICT r4
    #4: first-touch compile is a product cost; deployments warm ahead
    of traffic).  Uses a shape no other test compiles so the programs
    are genuinely fresh in this process."""
    clip = synthetic_frames(4, 80, 96, seed=77)
    data = JsvEncoder(96, 80, EncoderConfig(
        gop_size=4, quantizer_scale=5)).encode(clip)
    path = str(tmp_path / "warmclip.jsv")
    open(path, "wb").write(data)
    cache = str(tmp_path / "jit_cache")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", cache)
    assert cli_main(["warm", path]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["frames"] == 4
    assert rep["warm_decode_s"] < rep["compile_plus_first_decode_s"]
    assert os.path.isdir(cache) and os.listdir(cache), \
        "warm must populate the persistent compile cache"


def test_cli_encode_roundtrip(stream_file, tmp_path, capsys):
    _, _, clip = stream_file
    npz = str(tmp_path / "frames.npz")
    np.savez(npz, y=np.stack([f[0] for f in clip]),
             cb=np.stack([f[1] for f in clip]),
             cr=np.stack([f[2] for f in clip]))
    out = str(tmp_path / "enc.jsv")
    assert cli_main(["encode", npz, out, "--gop", "3", "--q", "4"]) == 0
    enc_line = capsys.readouterr().out.splitlines()[0]
    assert json.loads(enc_line)["frames"] == 6
    from jsvx.tools.oracle import decode_stream_oracle

    frames = decode_stream_oracle(open(out, "rb").read())
    assert len(frames) == 6


def test_decoder_iter_frames(stream_file):
    _, data, clip = stream_file
    dec = Decoder(PlayerConfig(), backend="oracle")
    dec.feed(0, data, len(data))
    frames = list(dec.iter_frames())
    assert len(frames) == 6 and dec.ended


def test_player_survives_chaotic_network(stream_file):
    """Dropped chunks create buffer holes; stall/refill must self-heal."""
    _, data, clip = stream_file
    p = Player(PlayerConfig(chunk_size=300), backend="oracle")
    chaotic = ChaosSource(MemorySource(data), drop_rate=0.4, seed=3)
    # inject by bypassing source_for
    p._sources = [type("V", (), {"src": data, "bitrate": 0})()]
    p._reset_for_source()
    p.emit("loadstart")
    p._source = chaotic
    p._request_range(0)
    p.play()
    shown = []
    p.set_frame_sink(lambda f, t: shown.append(t))
    t = 0.0
    for _ in range(400):
        t += 1 / 30.0
        p.tick(t)
        if p.ended:
            break
    assert len(shown) == len(clip), f"only {len(shown)} frames shown"
    assert p.ended


def test_chaos_error_path(stream_file):
    _, data, _ = stream_file
    p = Player(PlayerConfig(), backend="oracle")
    errors = []
    p.on("error", errors.append)
    p._sources = [type("V", (), {"src": data, "bitrate": 0})()]
    p._reset_for_source()
    p._source = ChaosSource(MemorySource(data), error_rate=1.0)
    p._request_range(0)
    assert errors and errors[0].code == errors[0].MEDIA_ERR_NETWORK


def test_two_axis_sharded_equals_single():
    """decode_gops_2d_sharded == per-GOP single-device decode."""
    import jax

    from jsvx.kernels.decode import frame_to_device, make_constants
    from jsvx.pipeline.gop import (decode_gop_scan, stack_device_frames,
                                   zero_refs)
    from jsvx.pipeline.stream import JaxStreamDecoder
    from jsvx.shard import build_mesh
    from jsvx.shard.slice_rows import decode_gops_2d_sharded

    clip = synthetic_frames(6, 128, 64, seed=41)
    data = JsvEncoder(64, 128, EncoderConfig(
        gop_size=3, quantizer_scale=4, me_range=4)).encode(clip)
    d = JaxStreamDecoder(data)
    fts = d.parse_all()
    seq = d.parser.seq
    consts = make_constants(seq)
    gops = [fts[:3], fts[3:]]
    stacks = [stack_device_frames([frame_to_device(ft) for ft in g])
              for g in gops]
    singles = [decode_gop_scan(
        s, zero_refs(seq.coded_height, seq.coded_width), consts,
        mc_impl="gather")[0] for s in stacks]

    batch = jax.tree.map(lambda *xs: np.stack(xs), *stacks)
    init = tuple(
        np.zeros((2,) + np.asarray(z).shape, np.uint8)
        for z in zero_refs(seq.coded_height, seq.coded_width))
    mesh = build_mesh({"gop": 2, "rows": 4})
    outs, final = decode_gops_2d_sharded(batch, init, consts, mesh,
                                         halo_y=32)
    for g in range(2):
        for comp in range(3):
            assert np.array_equal(np.asarray(outs[comp][g]),
                                  np.asarray(singles[g][comp]))
