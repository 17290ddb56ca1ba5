"""Display-time colour conversion (BT.601 limited range).

Device analog of the reference's YCbCrToRGBA fragment shader
(``player/parts/end.js:77-156``): chroma nearest-upsample + the exact
matrix constants of its ``_ak`` mat4.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..tools import refmath

_M = jnp.asarray(refmath.YCBCR_TO_RGB, dtype=jnp.float32)
_OFF = jnp.asarray(refmath.YCBCR_OFFSET, dtype=jnp.float32)


def ycbcr_to_rgb_jax(y: jax.Array, cb: jax.Array, cr: jax.Array,
                     alpha=False) -> jax.Array:
    """(H,W) + 2x(H/2,W/2) uint8 planes -> (H, W, 3|4) uint8 RGB(A).

    ``alpha`` may be ``True`` (opaque 255 channel, the reference's
    default RGBA output) or a decoded (H, W) uint8 alpha plane from a
    YUVA stream's 4th component."""
    h, w = y.shape
    up = lambda p: jnp.repeat(jnp.repeat(p, 2, axis=0), 2, axis=1)[:h, :w]
    ycc = jnp.stack([y.astype(jnp.float32),
                     up(cb).astype(jnp.float32),
                     up(cr).astype(jnp.float32)], axis=-1) / 255.0
    # HIGHEST: a GPU may otherwise run this f32 product in TF32
    rgb = jnp.matmul(ycc, _M.T, precision=jax.lax.Precision.HIGHEST) + _OFF
    rgb = jnp.clip(jnp.round(rgb * 255.0), 0, 255).astype(jnp.uint8)
    if alpha is not False and alpha is not None:
        if alpha is True:
            a = jnp.full((h, w, 1), 255, dtype=jnp.uint8)
        else:
            a = jnp.asarray(alpha).astype(jnp.uint8)[:h, :w, None]
        rgb = jnp.concatenate([rgb, a], axis=-1)
    return rgb


ycbcr_to_rgb_jit = jax.jit(functools.partial(ycbcr_to_rgb_jax))
