"""Persistent XLA compilation cache at a fixed place.

If `JAX_COMPILATION_CACHE_DIR` is set, JAX already reads it and this module
sets no other directory. Otherwise the cache lives at `<checkout>/.jax_cache`:
a fixed path, so a later process on the same checkout finds its entries
again. Disable entirely with FEM_TPU_NO_CACHE=1.
"""

import os

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def cache_dir() -> str:
    """The directory the compile cache uses: the environment's, if set."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(_ROOT, ".jax_cache"))


def enable() -> str | None:
    """Turn on jax's persistent compilation cache; return its directory.

    Returns None when FEM_TPU_NO_CACHE=1. Call before any compilation.
    """
    if os.environ.get("FEM_TPU_NO_CACHE", "0") == "1":
        return None
    import jax

    cache = cache_dir()
    os.makedirs(cache, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return cache
