"""Device-side expansion of the compact coefficient wire format.

Dense int16 coefficient planes are ~6.3 MB per 1080p frame, while the
encoded stream itself is ~14x smaller.  The compact wire format
(produced by ``jsv_parse_picture_slices_compact`` in
``jsvx/native/jsv_parse.cc``) ships only the *coded* coefficients:

* per component: ``cpk`` uint16 entries, one per coded coefficient,
  ``(spatial_pos:6 << 10) | (level + 512)`` — the zig-zag is undone by
  the parser (one C++ table lookup) so no per-entry gather happens on
  device — concatenated in (frame, macroblock-raster, block-within-MB)
  order, padded to a stable bucket; ``counts`` uint8 per-block entry
  counts giving each entry its block; ``n`` the true entry total
  (entries past it are padding);
* per frame: ONE copy of the per-macroblock sideband (quant scale,
  intra flags, motion vectors, distinct-MV indices, rep_add) instead of
  the per-block-grid copies per component.

This module reconstitutes, inside the decode jit, exactly the dense
per-component tensors the kernels consume.  Entry->block assignment
uses a scatter-add + cumsum rank over the (sorted) per-block boundary
positions rather than ``searchsorted``, whose binary search is a chain of
dependent gathers over every entry; with the parser-side zig-zag undo the
expansion costs one scatter.  A single scatter then builds the
coefficient plane stack.  Expanded planes are *exact* (true zeros
everywhere uncoded), so the last-non-zero masking the dense path needs
for its pooled buffers (jsvx/pipeline/packed_parse.py zeroing
invariant) degenerates to a
constant full-scan mask here — outputs are bit-identical.

The reference uploads dense coefficient textures every picture
(``decoders/jsv.js:1206-1243``); this wire format is an improvement on
it, not a translation.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

#: compact-wire component keys in plane order
COEF_KEYS = ("y", "cb", "cr", "a")


def expand_levels(cpk: jax.Array, n_coef: jax.Array, counts: jax.Array,
                  mb_h: int, mb_w: int, luma_like: bool) -> jax.Array:
    """Packed entries -> dense int16 coefficient plane stack (n, H, W).

    ``counts`` is (n_frames, n_blocks) with blocks in (mb*4 + b) order
    for luma-like components and mb order for chroma.  Padding entries
    (index >= ``n_coef``) scatter into a sacrificial slot.
    """
    n, n_blocks = counts.shape
    rep = 2 if luma_like else 1
    hb, wb = mb_h * rep, mb_w * rep
    h, w = hb * 8, wb * 8

    # entry i's block = #{b : ends[b] <= i}.  Blocks are emitted in
    # strictly increasing order (the parser flags violations as dirty),
    # so this rank is computable with one scatter-add of the boundary
    # positions + a cumsum — no searchsorted gather.
    ends = jnp.cumsum(counts.reshape(-1).astype(jnp.int32))
    marks = jnp.zeros((cpk.shape[0],), jnp.int32).at[ends].add(
        1, mode="drop")
    blk = jnp.cumsum(marks)
    blk = jnp.minimum(blk, n * n_blocks - 1)
    i = jnp.arange(cpk.shape[0], dtype=jnp.int32)

    ent = cpk.astype(jnp.int32)
    zz = ent >> 10                         # spatial position (parser
    lvl = (ent & 1023) - 512               # undoes the zig-zag)

    frame = blk // n_blocks
    r = blk % n_blocks
    if luma_like:
        mb = r >> 2
        b = r & 3
        by = (mb // mb_w) * 2 + (b >> 1)
        bx = (mb % mb_w) * 2 + (b & 1)
    else:
        by = r // mb_w
        bx = r % mb_w
    dest = (frame * (h * w) + (by * 8 + (zz >> 3)) * w + bx * 8 + (zz & 7))
    dest = jnp.where(i < n_coef, dest, n * h * w)

    plane = jnp.zeros((n * h * w + 1,), jnp.int16)
    plane = plane.at[dest].set(lvl.astype(jnp.int16), mode="drop")
    return plane[:-1].reshape(n, h, w)


def expand_compact_gop(stacked: dict, mb_h: int, mb_w: int) -> dict:
    """Compact wire pytree -> the dense stacked-GOP pytree the kernels eat.

    Per-MB sideband expands to per-block grids with broadcast reshapes
    (these fuse into the consuming kernels); ``lnz`` is synthesised as a
    constant full-scan mask (planes are exact — see module docstring).
    """
    mb = stacked["mb"]
    n = mb["q"].shape[0]
    out = {"is_p": stacked["is_p"], "f_code": stacked["f_code"]}
    if "mv_table" in stacked:
        out["mv_table"] = stacked["mv_table"]
        out["mv_count"] = stacked["mv_count"]

    def up(a, rep):
        if rep == 1:
            return a
        tail = a.shape[3:]
        bc = jnp.broadcast_to(
            a[:, :, None, :, None],
            (n, mb_h, rep, mb_w, rep) + tail)
        return bc.reshape((n, mb_h * rep, mb_w * rep) + tail)

    for ci, key in enumerate(COEF_KEYS):
        if key not in stacked["coef"]:
            continue
        luma_like = key in ("y", "a")
        rep = 2 if luma_like else 1
        c = stacked["coef"][key]
        comp = dict(
            levels=expand_levels(c["cpk"], c["n"], c["counts"],
                                 mb_h, mb_w, luma_like),
            lnz=jnp.full((n, mb_h * rep, mb_w * rep), 64, jnp.uint8),
            q=up(mb["q"], rep),
            intra=up(mb["intra"], rep),
            mv=up(mb["mv"], rep),
            rep_add=up(mb["rep_add"], rep),
        )
        if "mv_idx" in mb:
            comp["mv_idx"] = up(mb["mv_idx"], rep)
        out[key] = comp
    return out
