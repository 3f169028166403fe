"""Persistent XLA compilation cache, shared by every entry point.

JAX keys its persistent cache by directory, so the directory must not move
between runs: it is either the one ``JAX_COMPILATION_CACHE_DIR`` names or a
fixed directory inside the checkout (listed in ``.gitignore``).
"""

from __future__ import annotations

import os

__all__ = ["CHECKOUT", "enable_compile_cache"]

#: Root of the checkout this package lives in.
CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache and return its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses it and nothing
    else is set. Otherwise the cache goes to ``<checkout>/.jax_cache``.
    """
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if path:
        return path
    import jax

    path = os.path.join(CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
