"""Single-buffer host->device wire packing.

``jax.device_put`` of a GOP pytree issues one transfer per leaf; the
compact GOP has ~17 leaves, so a GOP pays ~17 transfer setups even
though the payload is small.  The reference has the same problem shape
— one WebGL ``texSubImage2D`` upload per texture per picture
(``decoders/jsv.js:1206-1243``).  Here the host->device boundary is ONE
contiguous buffer: the host packs every leaf into a single uint8 array
(one copy), and the device-side program rebuilds the pytree with static
slices + bitcasts that XLA folds into the consumers (no extra device
memory traffic after fusion).

Offsets are static per (shape, dtype) layout, which the sticky
coefficient/MV buckets already keep stable across GOPs — so the decode
program compiles once and every GOP is one transfer + one dispatch.
"""

from __future__ import annotations

import numpy as np

#: alignment for each packed leaf; device slices at lane multiples are
#: free, and 128 keeps any dtype's itemsize divisible
_ALIGN = 128


def _walk(tree: dict, path: tuple = ()):  # deterministic dict order
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), v


def wire_spec(tree: dict) -> tuple:
    """Static layout for ``tree``: ((path, dtype, shape, offset), total).

    Hashable (usable as a jit static argument); identical for every GOP
    whose leaf shapes/dtypes match.
    """
    entries = []
    off = 0
    for path, leaf in _walk(tree):
        a = np.asarray(leaf)
        entries.append((path, a.dtype.str, a.shape, off))
        off += a.nbytes
        off = -(-off // _ALIGN) * _ALIGN
    return tuple(entries), off


def flatten_wire(tree: dict, spec: tuple, out: np.ndarray | None = None
                 ) -> np.ndarray:
    """Pack every leaf of ``tree`` into one uint8 buffer per ``spec``."""
    entries, total = spec
    if out is None:
        out = np.empty((total,), np.uint8)
    assert out.nbytes >= total
    for path, dtype, shape, off in entries:
        node = tree
        for k in path:
            node = node[k]
        a = np.asarray(node)
        assert a.dtype.str == dtype and a.shape == tuple(shape), \
            f"leaf {path} changed layout: {a.dtype}/{a.shape}"
        a = np.ascontiguousarray(a).reshape(-1)   # 0-d -> 1-d too
        out[off:off + a.nbytes] = a.view(np.uint8)
    return out


def unflatten_wire(buf, spec: tuple) -> dict:
    """Rebuild the pytree from a device buffer (inside jit).

    Static slices + ``bitcast_convert_type`` — XLA fuses these into the
    consumers, so the expansion costs no extra device passes.
    """
    import jax
    import jax.numpy as jnp

    entries, total = spec
    out: dict = {}
    for path, dtype, shape, off in entries:
        dt = np.dtype(dtype)
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        raw = jax.lax.slice(buf, (off,), (off + n * dt.itemsize,))
        if dt.itemsize == 1:
            leaf = jax.lax.bitcast_convert_type(raw, dt)
        else:
            leaf = jax.lax.bitcast_convert_type(
                raw.reshape(n, dt.itemsize), dt)
        leaf = leaf.reshape(shape)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out
