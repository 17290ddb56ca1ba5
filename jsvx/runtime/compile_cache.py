"""Where JAX keeps its persistent compilation cache.

One rule for every entry point (``bench.py``, ``chip_smoke.py``,
``jsvx warm``): ``JAX_COMPILATION_CACHE_DIR`` when it is set, else
``.jax_cache`` in the checkout.  The path is fixed: it is part of the cache key, so a
directory named after a PID, a temporary name or the time never hits.
"""

from __future__ import annotations

import os

#: the checkout (or installed tree) that holds the ``jsvx`` package
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def compile_cache_dir() -> str:
    """The directory the persistent compilation cache uses."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(CHECKOUT, ".jax_cache"))


def enable_compile_cache(min_compile_time_secs: float = 1.0) -> str:
    """Turn the persistent compilation cache on; returns its directory.

    Programs that compile faster than ``min_compile_time_secs`` are not
    persisted (0 persists everything)."""
    import jax

    cache_dir = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_time_secs)
    return cache_dir
