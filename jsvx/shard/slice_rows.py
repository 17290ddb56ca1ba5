"""Slice-row sharding: one frame's rows across chips, halo exchange for MC.

BASELINE.md config 3: "slice-rows of one frame sharded across 8 chips,
boundary-row exchange".  Dequant and IDCT are block-local, so a row shard
needs no communication; only P-frame motion compensation reads up to
``halo`` rows past the shard boundary.  Those boundary strips of the
*reconstructed reference planes* are exchanged once per frame with
``lax.ppermute`` over the ``rows`` mesh axis — the multi-device equivalent
of the reference's single-GPU texture rebind (``decoders/jsv.js:1320``).

The required halo is ``8 * forward_f + 1`` pixels of luma (motion range is
``+/-(16*forward_f - 1)`` half-pel, jsv.js:850-855).  By default the halo
is DERIVED from the stream's f_code (``frame_to_device`` records it), and
when the derived halo reaches the local shard height — neighbour exchange
can no longer cover the motion range — the reference planes are instead
``all_gather``-ed per frame (the safe fallback), transparently producing
the same bit-exact result.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..kernels.decode import DecodeConstants, decode_frame_plane


def halo_for_f_code(f_code: int) -> int:
    """Luma halo rows covering f_code's vertical motion range.

    Motion is bounded by ``+/-(16*F - 1)`` half-pel (``F = 1 <<
    (f_code-1)``, jsv.js:850-855) = ``8*F - 1`` full-pel, +1 row for the
    half-pel interpolation tap; rounded up to a multiple of 16 so the
    chroma halo (half) stays a multiple of the 8-pixel block grid.
    """
    full = 8 * (1 << (max(int(f_code), 1) - 1)) + 1
    return -(-full // 16) * 16


def derive_halo_y(stacked: dict) -> int:
    """Halo from the stacked frames' recorded f_code (host-side).

    Must run on concrete (pre-jit) arrays: the halo is a static shape
    parameter.  Raises with guidance when traced.
    """
    fc = stacked.get("f_code")
    if fc is None:
        return 16                          # no P pictures recorded
    try:
        mx = int(np.asarray(fc).max())
    except Exception as e:                 # tracer: cannot derive under jit
        raise ValueError(
            "halo_y must be derived from concrete f_code values before "
            "jit — call derive_halo_y(stacked) outside the jitted "
            "function and pass halo_y explicitly") from e
    if mx <= 0:
        return 16
    return halo_for_f_code(mx)


def gather_row_halo(local: jax.Array, halo: int,
                    axis_name: str) -> jax.Array:
    """All-gather fallback: halo >= local shard height, so neighbour
    ppermute cannot cover the motion range.  Gathers the full plane,
    edge-pads, and slices this shard's (h_local + 2*halo) window —
    downstream code is identical to the exchange path."""
    h_local, w = local.shape
    full = jax.lax.all_gather(local, axis_name, tiled=True)
    padded = jnp.pad(full, ((halo, halo), (0, 0)), mode="edge")
    row0 = jax.lax.axis_index(axis_name) * h_local
    return jax.lax.dynamic_slice(padded, (row0, 0),
                                 (h_local + 2 * halo, w))


def exchange_row_halo(local: jax.Array, halo: int,
                      axis_name: str) -> jax.Array:
    """Extend a local row shard with ``halo`` rows from each neighbour.

    Devices at the global edges edge-replicate their own boundary row
    into the halo, so the extended shard reproduces CLAMP_TO_EDGE
    locally (required by the mvset prediction path; the gather path
    clamps in global coordinates and never reads those rows).
    """
    n = jax.lax.axis_size(axis_name)
    if halo == 0:
        return local
    w = local.shape[1]
    top_rep = jnp.broadcast_to(local[0:1], (halo, w))
    bot_rep = jnp.broadcast_to(local[-1:], (halo, w))
    if n == 1:
        return jnp.concatenate([top_rep, local, bot_rep], axis=0)
    idx = jax.lax.axis_index(axis_name)
    down = [(i, i + 1) for i in range(n - 1)]
    up = [(i + 1, i) for i in range(n - 1)]
    # rows just above my shard live on device i-1 (its bottom halo rows)
    from_above = jax.lax.ppermute(local[-halo:], axis_name, down)
    # rows just below my shard live on device i+1 (its top halo rows)
    from_below = jax.lax.ppermute(local[:halo], axis_name, up)
    top = jnp.where(idx == 0, top_rep, from_above)
    bot = jnp.where(idx == n - 1, bot_rep, from_below)
    return jnp.concatenate([top, local, bot], axis=0)


def _decode_frame_local(frame, refs, consts, halo_y, axis_name, h_globals,
                        quirk, mc_impl: str):
    """Per-device body: decode one frame's local row shard of all planes.

    ``mc_impl`` selects the per-shard prediction:

    * ``"mvset"``  — distinct-MV slices of the halo-extended shard;
    * ``"gather"`` — exact per-pixel path, global-coordinate clamping.
    """
    from ..kernels.decode import (comp_is_chroma, dequant_plane,
                                  frame_comp_keys, idct_plane,
                                  predict_plane_mvset)

    idx = jax.lax.axis_index(axis_name)
    outs = []
    use_mvset = mc_impl == "mvset" and "mv_table" in frame
    for comp, key in enumerate(frame_comp_keys(frame)):
        halo = halo_y // 2 if comp_is_chroma(comp) else halo_y
        local_ref = refs[comp]
        h_local = local_ref.shape[0]
        if halo < h_local:
            ext = exchange_row_halo(local_ref, halo, axis_name)
        else:
            # motion range exceeds the neighbour shard: all-gather the
            # reference plane instead (bit-identical, more traffic)
            ext = gather_row_halo(local_ref, halo, axis_name)
        if use_mvset:
            ci = frame[key]
            pad_blk = ((halo // 8, halo // 8), (0, 0))
            idx_ext = jnp.pad(ci["mv_idx"], pad_blk, mode="edge")
            rep_ext = jnp.pad(ci["rep_add"], pad_blk, mode="edge")
            pred = predict_plane_mvset(
                ext, frame["mv_table"], idx_ext, rep_ext,
                comp_is_chroma(comp),
                pad=max(halo, 8))[halo:halo + h_local]
            pred = pred * frame["is_p"].astype(jnp.int32)
            d = dequant_plane(ci["levels"], ci["q"], ci["intra"],
                              ci["lnz"], consts, quirk)
            res = idct_plane(d, consts)
            out = jnp.round(pred.astype(jnp.float32) + res)
            outs.append(jnp.clip(out, 0.0, 255.0).astype(jnp.uint8))
        else:
            row0 = idx * h_local
            outs.append(decode_frame_plane(
                frame[key], ext, frame["is_p"], consts,
                comp_is_chroma(comp), quirk,
                halo=halo, row0=row0, h_global=h_globals[comp]))
    return tuple(outs)


def _comp_spec(lead: tuple, rows_axis: str, has_mvset: bool) -> dict:
    """PartitionSpecs of one component's arrays: ``lead`` axes, then the
    plane/block rows sharded over ``rows_axis``."""
    d = dict(levels=P(*lead, rows_axis, None),
             lnz=P(*lead, rows_axis, None),
             q=P(*lead, rows_axis, None),
             intra=P(*lead, rows_axis, None),
             mv=P(*lead, rows_axis, None, None),
             rep_add=P(*lead, rows_axis, None))
    if has_mvset:
        d["mv_idx"] = P(*lead, rows_axis, None)
    return d


def _top_spec(tree: dict, lead: tuple, rows_axis: str) -> dict:
    """PartitionSpecs of a stacked frame pytree (components + per-frame
    scalars and the replicated distinct-MV table)."""
    from ..kernels.decode import frame_comp_keys

    has_mvset = "mv_table" in tree
    spec = {k: _comp_spec(lead, rows_axis, has_mvset)
            for k in frame_comp_keys(tree)}
    spec["is_p"] = P(*lead)
    if "f_code" in tree:
        spec["f_code"] = P(*lead)
    if has_mvset:
        spec["mv_table"] = P(*lead, None, None)
        if "mv_count" in tree:
            spec["mv_count"] = P(*lead)
    return spec


def _halo_and_mc(tree: dict, halo_y: int | None,
                 mc_impl: str | None) -> tuple[int, str]:
    if halo_y is None:
        halo_y = derive_halo_y(tree)
    if mc_impl is None:
        from ..pipeline.gop import decode_backend

        mc_impl = decode_backend()
    if mc_impl == "mvset" and "mv_table" in tree and halo_y % 16:
        raise ValueError("mvset MC needs halo_y a multiple of 16")
    return halo_y, mc_impl


def decode_gop_rows_sharded(stacked: dict, init_refs: tuple,
                            consts: DecodeConstants, mesh: Mesh,
                            axis_name: str = "rows",
                            halo_y: int | None = None,
                            quirk_oddify_zeros: bool = False,
                            mc_impl: str | None = None):
    """Decode a stacked GOP with every plane row-sharded over ``axis_name``.

    ``stacked`` as produced by :func:`jsvx.pipeline.gop.stack_device_frames`
    (leading frame axis); plane/sideband arrays are sharded on their row
    axis, the scan carry (reference planes) stays sharded, and each P frame
    performs one halo exchange per plane.  Returns (stacked planes, final
    refs) with the same shardings.

    ``halo_y=None`` (default) derives the halo from the GOP's recorded
    f_code (:func:`derive_halo_y`); when it reaches the local shard
    height the per-frame exchange transparently becomes an all-gather of
    the reference planes (:func:`gather_row_halo`).  ``mc_impl=None``
    takes :func:`jsvx.pipeline.gop.decode_backend`'s formulation.
    """
    halo_y, mc_impl = _halo_and_mc(stacked, halo_y, mc_impl)
    n_comps = len(init_refs)
    h_globals = tuple(r.shape[0] for r in init_refs)

    in_specs = (_top_spec(stacked, (None,), axis_name),
                (P(axis_name, None),) * n_comps)
    out_specs = ((P(None, axis_name, None),) * n_comps,
                 (P(axis_name, None),) * n_comps)

    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
        check_vma=False)
    def run(stacked_local, refs_local):
        def step(refs, frame):
            planes = _decode_frame_local(frame, refs, consts, halo_y,
                                         axis_name, h_globals,
                                         quirk_oddify_zeros, mc_impl)
            return planes, planes

        final, outs = jax.lax.scan(step, refs_local, stacked_local)
        return outs, final

    return run(stacked, init_refs)


def decode_gops_2d_sharded(batch: dict, init_refs: tuple,
                           consts: DecodeConstants, mesh: Mesh,
                           gop_axis: str = "gop", rows_axis: str = "rows",
                           halo_y: int | None = None,
                           quirk_oddify_zeros: bool = False,
                           mc_impl: str | None = None):
    """The full two-axis step: GOP batch data-parallel over ``gop_axis``
    (DP) x slice-rows over ``rows_axis`` (SP) with per-frame halo exchange.

    ``batch`` leaves have leading axes ``(n_gops, n_frames, ...)``;
    ``init_refs`` planes are ``(n_gops, H, W)``.  This is the layout a
    multi-host deployment runs: GOPs across hosts (distributed manifest),
    rows across each host's devices (halo exchange).
    """
    halo_y, mc_impl = _halo_and_mc(batch, halo_y, mc_impl)
    n_comps = len(init_refs)
    h_globals = tuple(r.shape[1] for r in init_refs)

    in_specs = (_top_spec(batch, (gop_axis, None), rows_axis),
                (P(gop_axis, rows_axis, None),) * n_comps)
    out_specs = ((P(gop_axis, None, rows_axis, None),) * n_comps,
                 (P(gop_axis, rows_axis, None),) * n_comps)

    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
        check_vma=False)
    def run(batch_local, refs_local):
        def one_gop(stacked_local, refs0):
            def step(refs, frame):
                planes = _decode_frame_local(frame, refs, consts, halo_y,
                                             rows_axis, h_globals,
                                             quirk_oddify_zeros, mc_impl)
                return planes, planes

            final, outs = jax.lax.scan(step, refs0, stacked_local)
            return outs, final

        return jax.vmap(one_gop)(batch_local, refs_local)

    return run(batch, init_refs)
