"""Device decode path (pure XLA formulation).

One fused, jit-able step per plane: integer dequantisation -> 8x8 IDCT as
two small matmuls -> half-pel motion compensation (vectorised gather) ->
residual add + clamp.  This replaces the reference's four WebGL fragment
passes (``decoders/shaders/mpeg1video.js``) with math on dense planes:

* no byte-pair int16 emulation, no 0.4 packing scale, no 4-pixels-per-texel
  repacking — those are WebGL1 workarounds, not format semantics;
* the two 1-D IDCT passes become ``C @ X`` / ``X @ C^T`` contractions,
  batched over all 8-row / 8-column block strips of the plane at once;
* the per-macroblock motion vectors become a per-pixel gather with
  edge-clamped indices (CLAMP_TO_EDGE semantics, ``decoders/jsv.js:216``).

This module is the device implementation on every platform and the
numerical spec.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..coding import tables as T
from ..tools import refmath


@dataclass(frozen=True)
class DecodeConstants:
    """Per-sequence constants.

    Quant matrices are *static* (pytree aux data, hashed into the jit
    cache key), so under trace they are compile-time constants usable
    for host-side table construction; only the IDCT basis is a device
    array leaf.
    """

    c_basis: jax.Array       # f32[8, 8] IDCT basis (spatial = C @ F @ C.T)
    intra_q_key: tuple       # 64 ints, spatial order
    non_intra_q_key: tuple

    @property
    def intra_q(self) -> jax.Array:
        return jnp.asarray(np.array(self.intra_q_key, np.int32)
                           .reshape(8, 8))

    @property
    def non_intra_q(self) -> jax.Array:
        return jnp.asarray(np.array(self.non_intra_q_key, np.int32)
                           .reshape(8, 8))

    @property
    def scan_pos(self) -> jax.Array:
        return jnp.asarray(T.ZIG_ZAG_INVERSE.reshape(8, 8)
                           .astype(np.int32))


def make_constants(seq=None) -> DecodeConstants:
    intra_q = (seq.intra_q if seq is not None
               else T.DEFAULT_INTRA_QUANT_MATRIX)
    non_intra_q = (seq.non_intra_q if seq is not None
                   else T.DEFAULT_NON_INTRA_QUANT_MATRIX)
    return DecodeConstants(
        c_basis=jnp.asarray(refmath.C_BASIS, dtype=jnp.float32),
        intra_q_key=tuple(int(x) for x in np.asarray(intra_q).reshape(-1)),
        non_intra_q_key=tuple(int(x)
                              for x in np.asarray(non_intra_q).reshape(-1)),
    )


jax.tree_util.register_pytree_node(
    DecodeConstants,
    lambda c: ((c.c_basis,), (c.intra_q_key, c.non_intra_q_key)),
    lambda aux, xs: DecodeConstants(xs[0], aux[0], aux[1]),
)


# ---------------------------------------------------------------------------
# Host -> device packing

#: Component key per plane index; [3] is the YUVA alpha plane (full
#: resolution, luma-like block grid, NOT halved motion vectors).
COMP_KEYS = ("y", "cb", "cr", "a")


def frame_comp_keys(frame: dict) -> tuple:
    """The component keys present in a device-frame pytree."""
    return tuple(k for k in COMP_KEYS if k in frame)


def comp_is_chroma(comp: int) -> bool:
    return comp in (1, 2)


def mv_bucket(n: int) -> int:
    """Static distinct-MV capacity buckets (limits recompilation)."""
    for k in (8, 16, 32, 64, 128, 255):
        if n <= k:
            return k
    return 0                               # too many: gather fallback


def mv_capacity_for(needed: int, sticky: int = 0) -> tuple[int, int]:
    """Distinct-MV capacity decision for one frame/GOP.

    Returns ``(cap, new_sticky)``: ``cap`` is the mvset table size for
    this unit (0 = distinct-MV count exceeds the top bucket, so this
    unit must use the exact per-pixel gather MC instead), and
    ``new_sticky`` the grow-only bucket callers carry forward so shapes
    stay stable across frames.

    An overflowing unit must NOT inherit the (smaller) sticky cap: the
    reference decoder accepts any in-range motion vector
    (``decoders/jsv.js:831-893``), so a legal high-motion frame with
    >255 distinct MVs has to decode — through the gather path — rather
    than raise out of ``frame_to_device``.
    """
    b = mv_bucket(needed)
    if b == 0:
        return 0, sticky
    cap = max(sticky, b)
    return cap, cap


def frame_to_device(ft, dtype_levels=np.int16, mv_capacity: int = 0) -> dict:
    """FrameTensors -> pytree of device-ready arrays.

    Per-MB sideband is expanded to the per-block grid on the host (for luma
    each MB covers 2x2 blocks) so the device kernels see one uniform block
    grid per plane.

    ``mv_capacity`` > 0 additionally emits the distinct-motion-vector
    decomposition used by the fast MC path: ``mv_table`` (K, 2) of unique
    half-pel vectors (row 0 is always (0,0)) and a per-block ``mv_idx``
    into it.  Pass the same capacity for every frame of a GOP stack.
    """

    def mb_to_blocks(a, comp):
        return a if comp_is_chroma(comp) \
            else np.repeat(np.repeat(a, 2, axis=0), 2, axis=1)

    mv_table = mv_idx = None
    if mv_capacity:
        flat = ft.mb_mv.reshape(-1, 2).astype(np.int32)
        uniq, inv = np.unique(flat, axis=0, return_inverse=True)
        # force (0,0) to index 0 (skipped MBs, I frames)
        zero = np.nonzero((uniq == 0).all(axis=1))[0]
        if len(zero) == 0:
            uniq = np.concatenate([np.zeros((1, 2), np.int32), uniq])
            inv = inv + 1
        elif zero[0] != 0:
            z = zero[0]
            uniq[[0, z]] = uniq[[z, 0]]
            inv = np.where(inv == z, -1, inv)
            inv = np.where(inv == 0, z, inv)
            inv = np.where(inv == -1, 0, inv)
        if len(uniq) > mv_capacity:
            raise ValueError(
                f"{len(uniq)} distinct MVs exceed capacity {mv_capacity}")
        mv_idx = inv.reshape(ft.mb_mv.shape[:2]).astype(np.int32)
        mv_table = np.zeros((mv_capacity, 2), np.int32)
        mv_table[:len(uniq)] = uniq
        mv_count = np.int32(len(uniq))

    # narrow wire dtypes: these arrays cross the host->device link every
    # frame; kernels promote as needed (copy=False skips the redundant
    # same-dtype copies the old int32 widening forced)
    out = dict(is_p=np.int32(0 if ft.is_intra_picture else 1),
               f_code=np.int32(ft.f_code))
    for comp in range(len(ft.levels)):
        c = dict(
            levels=ft.levels[comp].astype(dtype_levels, copy=False),
            lnz=ft.lnz[comp],
            q=mb_to_blocks(ft.mb_quant, comp),
            intra=mb_to_blocks(ft.mb_intra, comp),
            mv=mb_to_blocks(ft.mb_mv, comp).astype(np.int16, copy=False),
            rep_add=mb_to_blocks(ft.mb_rep_add, comp),
        )
        if mv_capacity:
            c["mv_idx"] = mb_to_blocks(mv_idx, comp).astype(np.int16)
        out[COMP_KEYS[comp]] = c
    if mv_capacity:
        out["mv_table"] = mv_table
        out["mv_count"] = mv_count
    return out


# ---------------------------------------------------------------------------
# Dequantisation (integer, reference semantics)

def dequant_plane(levels: jax.Array, q_blk: jax.Array, intra_blk: jax.Array,
                  lnz_blk: jax.Array, consts: DecodeConstants,
                  quirk_oddify_zeros: bool = False) -> jax.Array:
    """int16 level plane -> f32 dequantised coefficient plane.

    Shader parity (COL_* fragments): x2 (+sign for non-intra), xq, xM/16
    with floor, mismatch control, clamp to [-2048, 2047], zero outside the
    coded scan range, intra DC = 8*level.
    """
    h, w = levels.shape
    hb, wb = h // 8, w // 8
    lv = levels.astype(jnp.int32).reshape(hb, 8, wb, 8)

    q = q_blk.reshape(hb, 1, wb, 1)
    intra = intra_blk.reshape(hb, 1, wb, 1) > 0
    lnz = lnz_blk.reshape(hb, 1, wb, 1)
    mi = consts.intra_q.reshape(1, 8, 1, 8)
    mn = consts.non_intra_q.reshape(1, 8, 1, 8)
    scan = consts.scan_pos.reshape(1, 8, 1, 8)

    sign = jnp.sign(lv)
    if quirk_oddify_zeros:
        pre_sign = jnp.where(lv < 0, -1, 1)
    else:
        pre_sign = sign
    pre = jnp.where(intra, 2 * lv, 2 * lv + pre_sign)
    m = jnp.where(intra, mi, mn)
    d = jnp.floor_divide(pre * q * m, 16)

    even = (d % 2) == 0
    if quirk_oddify_zeros:
        d = jnp.where(even, d - jnp.where(d > 0, 1, -1), d)
    else:
        d = jnp.where(even & (lv != 0), d - jnp.sign(d), d)
    d = jnp.clip(d, -2048, 2047)

    d = jnp.where(scan < lnz, d, 0)
    # intra DC override (COL_INT_31: dc at quant step 8)
    is_dc = (jnp.arange(8)[:, None] == 0) & (jnp.arange(8)[None, :] == 0)
    d = jnp.where(is_dc.reshape(1, 8, 1, 8) & intra, 8 * lv, d)
    return d.reshape(h, w).astype(jnp.float32)


# ---------------------------------------------------------------------------
# IDCT (two contractions over block strips)

def idct_plane(d: jax.Array, consts: DecodeConstants) -> jax.Array:
    """Separable 8x8 IDCT of a dequantised plane (spatial = C F C^T).

    Both contractions pin ``Precision.HIGHEST``: at default precision a
    GPU may run f32 products in TF32 (about three decimal digits), and
    the reconstructed planes would stop matching the CPU path.
    """
    h, w = d.shape
    c = consts.c_basis
    hi = jax.lax.Precision.HIGHEST
    cols = jnp.einsum("xu,bul->bxl", c, d.reshape(h // 8, 8, w),
                      preferred_element_type=jnp.float32, precision=hi)
    rows = jnp.einsum("yv,hbv->hby", c, cols.reshape(h, w // 8, 8),
                      preferred_element_type=jnp.float32, precision=hi)
    return rows.reshape(h, w)


# ---------------------------------------------------------------------------
# Motion compensation (per-pixel gather, MPEG half-pel rounding)

def predict_plane(ref: jax.Array, mv_blk: jax.Array, rep_add_blk: jax.Array,
                  is_chroma: bool, *, halo: int = 0, row0=0,
                  h_global: int | None = None) -> jax.Array:
    """Edge-clamped half-pel prediction of a (possibly row-sharded) plane.

    ``ref`` is the previous reconstructed plane (uint8).  ``mv_blk`` is the
    per-8x8-block motion vector in luma half-pel units; chroma planes halve
    it with trunc-toward-zero first (shader INTER_1 with mv_coef=0.5).

    Sharded use (slice-row sharding over a mesh axis): ``ref`` is the local
    row shard extended by ``halo`` exchanged boundary rows on each side,
    ``row0`` is the global row of the shard's first output row and
    ``h_global`` the full plane height — edge clamping then happens in
    global coordinates, so results are bit-identical to the single-device
    decode as long as ``halo`` covers the vertical motion range.
    """
    ext_h, w = ref.shape
    h = ext_h - 2 * halo                   # local output rows
    if h_global is None:
        h_global = h
    mv_blk = mv_blk.astype(jnp.int32)      # wire dtype may be int16
    mvy = jnp.repeat(jnp.repeat(mv_blk[..., 0], 8, axis=0), 8, axis=1)
    mvx = jnp.repeat(jnp.repeat(mv_blk[..., 1], 8, axis=0), 8, axis=1)
    if is_chroma:
        mvy = jax.lax.div(mvy, 2)          # trunc toward zero
        mvx = jax.lax.div(mvx, 2)
    fy, oy = mvy >> 1, mvy & 1
    fx, ox = mvx >> 1, mvx & 1

    yy = jnp.arange(h, dtype=jnp.int32)[:, None] + row0 + fy   # global rows
    xx = jnp.arange(w, dtype=jnp.int32)[None, :] + fx
    ref_i = ref.astype(jnp.int32)

    def at(dy, dx):
        iy = jnp.clip(yy + dy, 0, h_global - 1) - row0 + halo
        iy = jnp.clip(iy, 0, ext_h - 1)
        ix = jnp.clip(xx + dx, 0, w - 1)
        return jnp.take(ref_i.reshape(-1), iy * w + ix)

    a = at(0, 0)
    b = at(0, 1)
    c = at(1, 0)
    d = at(1, 1)
    pred = jnp.where(
        (oy == 0) & (ox == 0), a,
        jnp.where((oy == 0) & (ox == 1), (a + b + 1) >> 1,
                  jnp.where((oy == 1) & (ox == 0), (a + c + 1) >> 1,
                            (a + b + c + d + 2) >> 2)))
    rep = jnp.repeat(jnp.repeat(rep_add_blk, 8, axis=0), 8, axis=1)
    return jnp.where(rep > 0, 0, pred)


def predict_plane_mvset(ref: jax.Array, mv_table: jax.Array,
                        mv_idx_blk: jax.Array, rep_add_blk: jax.Array,
                        is_chroma: bool, pad: int = 72) -> jax.Array:
    """MC via distinct-motion-vector decomposition.

    Motion vectors are per macroblock, so a frame has few *distinct*
    values.  For each entry of ``mv_table`` this takes ONE dynamic slice
    of the edge-padded reference (a contiguous copy) and blends it in
    where ``mv_idx`` matches: a lax.scan of K vectorised steps in place
    of a per-pixel gather.  The CPU backend takes this formulation; a
    GPU gathers per pixel (see :func:`jsvx.pipeline.gop.decode_backend`).

    ``pad`` must be a static bound on full-pel displacement + 1
    (``pad >= 8 * (1 << (f_code - 1)) + 1``); edge-replication padding
    reproduces the reference's CLAMP_TO_EDGE semantics exactly.
    """
    h, w = ref.shape
    mv_table = jnp.asarray(mv_table)       # allow un-jitted numpy input
    k_cap = mv_table.shape[0]
    hb, wb = mv_idx_blk.shape
    ref_pad = jnp.pad(ref.astype(jnp.int16), pad, mode="edge")
    idx_px = jnp.broadcast_to(
        mv_idx_blk[:, None, :, None], (hb, 8, wb, 8)).reshape(h, w)

    def step(pred, k):
        vy = mv_table[k, 0]
        vx = mv_table[k, 1]
        if is_chroma:
            vy = jax.lax.div(vy, 2)        # trunc toward zero
            vx = jax.lax.div(vx, 2)
        fy, oy = vy >> 1, vy & 1
        fx, ox = vx >> 1, vx & 1
        win = jax.lax.dynamic_slice(ref_pad, (pad + fy, pad + fx),
                                    (h + 1, w + 1))
        a = win[:h, :w]
        b = win[:h, 1:]
        c = win[1:, :w]
        d = win[1:, 1:]
        bias = (ox + oy + ox * oy + 1) >> 1
        interp = ((a + ox * b + oy * c + (ox * oy) * d + bias)
                  >> (ox + oy)).astype(jnp.int16)
        return jnp.where(idx_px == k, interp, pred), None

    pred0 = jnp.zeros((h, w), jnp.int16)
    pred, _ = jax.lax.scan(step, pred0, jnp.arange(k_cap))
    rep = jnp.broadcast_to(
        rep_add_blk[:, None, :, None], (hb, 8, wb, 8)).reshape(h, w)
    return jnp.where(rep > 0, 0, pred).astype(jnp.int32)


# ---------------------------------------------------------------------------
# Full frame step

def decode_frame_plane(comp_inputs: dict, ref: jax.Array, is_p: jax.Array,
                       consts: DecodeConstants, is_chroma: bool,
                       quirk_oddify_zeros: bool = False, *, halo: int = 0,
                       row0=0, h_global: int | None = None,
                       mv_table: jax.Array | None = None,
                       mv_pad: int = 72,
                       mc_impl: str = "gather") -> jax.Array:
    """One plane of one picture -> reconstructed uint8 plane.

    Uniform over I/P so a ``lax.scan`` over a GOP can carry the reference
    planes: for I pictures ``is_p`` zeroes the prediction term.  The
    ``halo``/``row0``/``h_global`` kwargs enable slice-row-sharded use
    (see :func:`predict_plane`).

    ``mc_impl`` selects the prediction formulation:

    * ``"mvset"``  — distinct-MV dynamic slices (exact incl. edge clamps;
      needs ``mv_table``/``mv_idx`` from ``frame_to_device``);
    * ``"gather"`` — per-pixel gather (exact; supports sharded halo
      decoding).
    """
    d = dequant_plane(comp_inputs["levels"], comp_inputs["q"],
                      comp_inputs["intra"], comp_inputs["lnz"], consts,
                      quirk_oddify_zeros)
    res = idct_plane(d, consts)
    if mc_impl == "mvset":
        pred = predict_plane_mvset(ref, mv_table, comp_inputs["mv_idx"],
                                   comp_inputs["rep_add"], is_chroma,
                                   pad=mv_pad)
    else:
        pred = predict_plane(ref, comp_inputs["mv"],
                             comp_inputs["rep_add"], is_chroma, halo=halo,
                             row0=row0, h_global=h_global)
    pred = pred * is_p.astype(jnp.int32)
    out = jnp.round(pred.astype(jnp.float32) + res)
    return jnp.clip(out, 0.0, 255.0).astype(jnp.uint8)


def decode_frame_planes(frame: dict, refs: tuple, consts: DecodeConstants,
                        quirk_oddify_zeros: bool = False,
                        mv_pad: int = 72, mc_impl: str = "mvset") -> tuple:
    """All planes of one picture; ``refs`` = (Y, Cb, Cr[, A]) uint8."""
    is_p = frame["is_p"]
    mv_table = frame.get("mv_table")
    if mc_impl == "mvset" and (
            mv_table is None or "mv_idx" not in frame["y"]):
        mc_impl = "gather"
    kw = dict(quirk_oddify_zeros=quirk_oddify_zeros, mv_table=mv_table,
              mv_pad=mv_pad, mc_impl=mc_impl)
    return tuple(
        decode_frame_plane(frame[k], refs[i], is_p, consts,
                           comp_is_chroma(i), **kw)
        for i, k in enumerate(frame_comp_keys(frame)))


@functools.partial(jax.jit, static_argnames=("quirk_oddify_zeros",
                                             "mc_impl"))
def decode_frame_jit(frame: dict, refs: tuple, consts: DecodeConstants,
                     quirk_oddify_zeros: bool = False,
                     mc_impl: str = "mvset") -> tuple:
    return decode_frame_planes(frame, refs, consts, quirk_oddify_zeros,
                               mc_impl=mc_impl)
