"""GOP-level recurrent decode.

The reference repaints P pictures against a rotating framebuffer pool
(``prev_pic_framebuffer``, decoders/jsv.js:639-673).  Here a GOP is a
``lax.scan`` over its frames with the three reconstructed reference
planes as carry: I frames reset the carry (their prediction term is
zeroed), P frames consume it.  Frames of a GOP are stacked on a leading
axis so one compiled scan decodes the whole GOP without host round-trips.

:func:`decode_backend` is the one place that maps the device platform to
the decode path's motion-compensation formulation.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..kernels.decode import DecodeConstants, decode_frame_planes

#: platform -> motion-compensation formulation of the decode path:
#: "mvset" (distinct-MV slices; the only one that needs the distinct-MV
#: table) or "gather" (per-pixel gather), both in
#: :mod:`jsvx.kernels.decode`.  The GPU's comes from
#: ``jsvx.tools.bench_mc`` on an H100: gather wins from K=32 distinct
#: vectors up, by 11x at the K=255 bucket of the 1080p fixture (PERF.md).
BACKENDS = {
    "cpu": "mvset",
    "gpu": "gather",
}


def decode_backend(platform: str | None = None) -> str:
    """The MC formulation for ``platform`` (default: that of
    ``jax.devices()[0]``).  Any platform without a backend is an error."""
    if platform is None:
        platform = jax.devices()[0].platform
    try:
        return BACKENDS[platform]
    except KeyError:
        raise ValueError(
            f"jsvx has no decode backend for platform {platform!r} "
            f"(supported: {', '.join(BACKENDS)})") from None


def stack_device_frames(frames: list[dict]) -> dict:
    """List of per-frame pytrees (from ``frame_to_device``) -> stacked."""
    return jax.tree.map(lambda *xs: np.stack(xs), *frames)


def zero_refs(coded_h: int, coded_w: int, n_comps: int = 3) -> tuple:
    refs = [jnp.zeros((coded_h, coded_w), dtype=jnp.uint8),
            jnp.zeros((coded_h // 2, coded_w // 2), dtype=jnp.uint8),
            jnp.zeros((coded_h // 2, coded_w // 2), dtype=jnp.uint8)]
    if n_comps == 4:                       # YUVA alpha plane (full-res)
        refs.append(jnp.zeros((coded_h, coded_w), dtype=jnp.uint8))
    return tuple(refs)


def _gop_scan(stacked: dict, init_refs: tuple, consts: DecodeConstants,
              quirk_oddify_zeros: bool, mc_impl: str) -> tuple:
    def step(refs, frame):
        planes = decode_frame_planes(frame, refs, consts, quirk_oddify_zeros,
                                     mc_impl=mc_impl)
        return planes, planes

    final_refs, outs = jax.lax.scan(step, init_refs, stacked)
    return outs, final_refs


def decode_gop_scan(stacked: dict, init_refs: tuple,
                    consts: DecodeConstants,
                    quirk_oddify_zeros: bool = False,
                    mc_impl: str | None = None) -> tuple:
    """Decode a stacked GOP; returns ((Y, Cb, Cr) stacks, final refs).

    The sequential P->I dependence is the scan carry; everything inside a
    step is dense math over whole planes (dequant + IDCT + MC).
    ``mc_impl=None`` takes :func:`decode_backend`'s formulation; it is
    resolved here, outside the jit, so a cached compilation never hides
    the platform check.
    """
    return _decode_gop_scan(stacked, init_refs, consts, quirk_oddify_zeros,
                            mc_impl or decode_backend())


@functools.partial(jax.jit, static_argnums=(3, 4))
def _decode_gop_scan(stacked, init_refs, consts, quirk_oddify_zeros,
                     mc_impl):
    return _gop_scan(stacked, init_refs, consts, quirk_oddify_zeros,
                     mc_impl)


def decode_gop_scan_compact(stacked: dict, init_refs: tuple,
                            consts: DecodeConstants, mb_h: int, mb_w: int,
                            mc_impl: str | None = None) -> tuple:
    """Decode a compact-wire GOP (see :mod:`jsvx.kernels.expand`).

    The coefficient planes are reconstituted on device (one scatter)
    inside the same compiled program as the scan, so the host->device
    transfer carries only coded coefficients + per-MB sideband.
    ``quirk_oddify_zeros`` is unsupported here: the quirk oddifies
    positions outside the coded scan range, which the compact wire (by
    design) does not distinguish — use the dense path for quirk decode.
    """
    return _decode_gop_scan_compact(stacked, init_refs, consts, mb_h, mb_w,
                                    mc_impl or decode_backend())


@functools.partial(jax.jit, static_argnums=(3, 4, 5))
def _decode_gop_scan_compact(stacked, init_refs, consts, mb_h, mb_w,
                             mc_impl):
    from ..kernels.expand import expand_compact_gop

    dense = expand_compact_gop(stacked, mb_h, mb_w)
    return _gop_scan(dense, init_refs, consts, False, mc_impl)


def decode_gop_scan_wire(buf, spec: tuple, init_refs: tuple,
                         consts: DecodeConstants, mb_h: int, mb_w: int,
                         mc_impl: str | None = None) -> tuple:
    """Decode a compact GOP shipped as ONE contiguous uint8 buffer.

    ``buf`` is the single-transfer wire (:mod:`jsvx.pipeline.wire`);
    ``spec`` the static layout.  Unpacking is static slices + bitcasts
    that XLA fuses into the expansion scatter, so against
    :func:`decode_gop_scan_compact` this costs nothing on device and
    replaces one transfer per pytree leaf with one per GOP.
    """
    return _decode_gop_scan_wire(buf, spec, init_refs, consts, mb_h, mb_w,
                                 mc_impl or decode_backend())


@functools.partial(jax.jit, static_argnums=(1, 4, 5, 6))
def _decode_gop_scan_wire(buf, spec, init_refs, consts, mb_h, mb_w,
                          mc_impl):
    from ..kernels.expand import expand_compact_gop
    from .wire import unflatten_wire

    stacked = unflatten_wire(buf, spec)
    dense = expand_compact_gop(stacked, mb_h, mb_w)
    return _gop_scan(dense, init_refs, consts, False, mc_impl)
