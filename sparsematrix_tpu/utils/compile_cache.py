"""Where JAX keeps its persistent compilation cache for this checkout."""
from __future__ import annotations

import os

__all__ = ["enable_compile_cache"]

# the checkout root: sparsematrix_tpu/utils/ → two levels up
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR`` wins when set (JAX reads it itself, so
    nothing is changed); otherwise the cache lives in ``.jax_cache`` at
    the checkout root, whatever the working directory.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = os.path.join(_CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
