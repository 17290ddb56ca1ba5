"""Motion-compensation formulations at 1080p: per-pixel gather vs mvset.

The XLA decode path can predict a plane two ways
(:func:`jsvx.kernels.decode.decode_frame_plane`): a per-pixel gather, or
the distinct-MV decomposition ("mvset": one slice + blend per distinct
vector, so its cost grows with the table capacity K).  This bench times
one 1920x1088 luma prediction both ways at K in {8, 32, 64, 128, 255}
on device-resident inputs, checks the two agree bit for bit, and is what
:data:`jsvx.pipeline.gop.BACKENDS` chooses a platform's formulation from.

Run on the device: ``python -m jsvx.tools.bench_mc``
"""

from __future__ import annotations

import json
import time

import numpy as np


def _median_s(fn, args, reps: int) -> float:
    import jax

    for _ in range(3):                               # compile, clocks up
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def mc_table(h: int = 1088, w: int = 1920,
             ks: tuple = (8, 32, 64, 128, 255), reps: int = 5) -> list:
    """One row per K: median milliseconds per plane for gather and
    mvset, with the K distinct vectors spread at random over the
    macroblocks (half-pel components in [-48, 48])."""
    import jax

    from ..kernels.decode import predict_plane, predict_plane_mvset

    gather = jax.jit(lambda ref, mv, rep: predict_plane(ref, mv, rep, False))
    mvset = jax.jit(lambda ref, tbl, idx, rep: predict_plane_mvset(
        ref, tbl, idx, rep, False))
    rows = []
    for k in ks:
        rng = np.random.default_rng(k)
        hb, wb = h // 8, w // 8
        tbl = np.zeros((k, 2), np.int32)
        tbl[1:] = rng.integers(-48, 49, (k - 1, 2))
        idx = rng.integers(0, k, (hb, wb)).astype(np.int32)
        ref = jax.device_put(rng.integers(0, 256, (h, w)).astype(np.uint8))
        rep = jax.device_put(np.zeros((hb, wb), np.int32))
        g_args = (ref, jax.device_put(tbl[idx]), rep)
        m_args = (ref, jax.device_put(tbl), jax.device_put(idx), rep)
        if not np.array_equal(np.asarray(gather(*g_args)),
                              np.asarray(mvset(*m_args))):
            raise AssertionError(f"gather != mvset at K={k}")
        rows.append({
            "k": k,
            "gather_ms": _median_s(gather, g_args, reps) * 1e3,
            "mvset_ms": _median_s(mvset, m_args, reps) * 1e3,
        })
    return rows


def main() -> None:
    import jax

    d = jax.devices()[0]
    print(json.dumps({"platform": d.platform, "kind": d.device_kind,
                      "plane": "1920x1088 luma", "rows": mc_table()}))


if __name__ == "__main__":
    main()
