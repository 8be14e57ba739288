"""Persistent XLA compilation cache location, shared by every entry point."""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at a fixed directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, wins and nothing is set here
    (JAX reads the variable itself). Otherwise the cache goes to
    ``<checkout>/.jax_cache``. Call before the first compilation. Returns
    the directory in use.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = os.path.join(CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
