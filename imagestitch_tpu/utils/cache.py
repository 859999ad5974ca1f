"""Persistent XLA compilation cache.

Compiling the flagship's programs takes seconds to minutes; caching the
serialized executables on disk lets every later process start warm.  Call
once before the first dispatch.
"""
from __future__ import annotations

import os

_DEFAULT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), ".jax_cache")


def enable_compilation_cache() -> str:
    """Turn the persistent cache on and return its directory.

    ``$JAX_COMPILATION_CACHE_DIR``, when set, is the directory: JAX reads
    it itself and no other is set.  Otherwise the cache lives at the fixed
    in-checkout ``.jax_cache/`` (a fixed path, because the path is part of
    the cache key).
    """
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = _DEFAULT
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path
