"""Test configuration: force an 8-device virtual CPU platform.

Sharding tests run on a virtual CPU mesh (the standard JAX pattern for
testing multi-device code without the devices); the fused GPU kernel is
tested in Pallas interpret mode.  Tests that need the card carry the
``gpu`` marker and skip here (run them on the card with
``JSVX_TEST_ON_GPU=1 python -m pytest tests -m gpu``).
"""

import os

# Tests run on a virtual 8-device CPU platform, even where a GPU is
# visible, unless JSVX_TEST_ON_GPU asks for the card.
if not os.environ.get("JSVX_TEST_ON_GPU"):
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

if not os.environ.get("JSVX_TEST_ON_GPU"):
    jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


def synthetic_frames(n_frames: int, height: int, width: int,
                     seed: int = 7, motion: bool = True):
    """Moving-pattern YCbCr 4:2:0 clip for encoder fixtures.

    A smooth gradient background plus a few moving rectangles, designed to
    exercise DC prediction, AC coefficients, and nonzero motion vectors.
    """
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width]
    base = (96 + 48 * np.sin(2 * np.pi * xx / width)
            + 32 * np.cos(2 * np.pi * yy / height))
    rects = []
    for _ in range(4):
        rects.append((
            rng.integers(0, height - 24), rng.integers(0, width - 24),
            int(rng.integers(12, 32)), int(rng.integers(12, 32)),
            float(rng.uniform(-2.5, 2.5)), float(rng.uniform(-2.5, 2.5)),
            float(rng.uniform(30, 220)),
        ))
    frames = []
    for t in range(n_frames):
        y = base.copy()
        cb = np.full((height, width), 128.0) + 24 * np.sin(
            2 * np.pi * (xx + 3 * t) / width)
        cr = np.full((height, width), 128.0) + 24 * np.cos(
            2 * np.pi * (yy + 2 * t) / height)
        for (r0, c0, rh, rw, vy, vx, lum) in rects:
            dy = int(round(vy * t)) if motion else 0
            dx = int(round(vx * t)) if motion else 0
            r = int(np.clip(r0 + dy, 0, height - rh))
            c = int(np.clip(c0 + dx, 0, width - rw))
            y[r:r + rh, c:c + rw] = lum
            cb[r:r + rh, c:c + rw] = 255 - lum
        to8 = lambda p: np.clip(np.round(p), 0, 255).astype(np.uint8)
        half = lambda p: p.reshape(height // 2, 2, width // 2, 2).mean(
            axis=(1, 3))
        frames.append((to8(y), to8(half(cb)), to8(half(cr))))
    return frames


def synthetic_frames_yuva(n_frames: int, height: int, width: int,
                          seed: int = 7):
    """YUVA clip: the synthetic YCbCr frames plus a moving alpha plane."""
    yy, xx = np.mgrid[0:height, 0:width]
    out = []
    for t, (y, cb, cr) in enumerate(
            synthetic_frames(n_frames, height, width, seed)):
        a = np.clip(128 + 80 * np.sin(2 * np.pi * (xx + 5 * t) / width)
                    + 40 * (yy > 4 * t), 0, 255).astype(np.uint8)
        out.append((y, cb, cr, a))
    return out


@pytest.fixture(scope="session")
def tiny_clip_yuva():
    """5 frames of 48x64 YUVA video."""
    return synthetic_frames_yuva(5, 48, 64)


@pytest.fixture(scope="session")
def tiny_clip():
    """6 frames of 48x64 video (3x4 macroblocks)."""
    return synthetic_frames(6, 48, 64)


@pytest.fixture(scope="session")
def small_clip():
    """10 frames of 96x112 video."""
    return synthetic_frames(10, 96, 112)
