"""GOP-parallel decode: independent GOPs data-sharded across chips.

BASELINE.md config 4.  GOPs are closed decode units (I-led, per-slice
predictor resets), so a batch of GOPs shards trivially on its leading axis:
no collectives inside a step, perfect scaling.  The sequential P
recurrence runs privately per shard via the same ``lax.scan`` as the
single-chip path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..kernels.decode import DecodeConstants, decode_frame_planes


def _decode_gop_core(stacked, init_refs, consts, quirk, mc_impl):
    def step(refs, frame):
        planes = decode_frame_planes(frame, refs, consts, quirk,
                                     mc_impl=mc_impl)
        return planes, planes

    final, outs = jax.lax.scan(step, init_refs, stacked)
    return outs, final


def decode_gops_parallel(batch: dict, coded_h: int, coded_w: int,
                         consts: DecodeConstants, mesh: Mesh,
                         axis_name: str = "gop",
                         quirk_oddify_zeros: bool = False):
    """Decode a batch of GOPs sharded over ``axis_name``.

    ``batch`` is a pytree whose leaves have leading axes
    ``(n_gops, n_frames, ...)`` — n_gops must divide by the mesh axis size
    (pad short batches with repeated GOPs and drop the extras).  Returns
    stacked planes ``(n_gops, n_frames, H, W)`` sharded the same way.
    Each GOP decodes with :func:`jsvx.pipeline.gop.decode_backend`'s
    MC formulation, exactly as the single-device scan does.
    """
    from ..pipeline.gop import decode_backend

    mc_impl = decode_backend()
    n_gops = batch["is_p"].shape[0]
    n_comps = 4 if "a" in batch else 3
    batch = jax.tree.map(
        lambda x: jax.device_put(x, NamedSharding(
            mesh, P(*([axis_name] + [None] * (x.ndim - 1))))), batch)

    def refs_for(n):
        refs = [jnp.zeros((n, coded_h, coded_w), jnp.uint8),
                jnp.zeros((n, coded_h // 2, coded_w // 2), jnp.uint8),
                jnp.zeros((n, coded_h // 2, coded_w // 2), jnp.uint8)]
        if n_comps == 4:
            refs.append(jnp.zeros((n, coded_h, coded_w), jnp.uint8))
        return tuple(refs)

    @jax.jit
    def run(batch, refs):
        fn = jax.vmap(lambda s, r: _decode_gop_core(
            s, r, consts, quirk_oddify_zeros, mc_impl))
        return fn(batch, refs)

    refs = jax.device_put(
        refs_for(n_gops),
        (NamedSharding(mesh, P(axis_name)),) * n_comps)
    outs, final = run(batch, refs)
    return outs, final
