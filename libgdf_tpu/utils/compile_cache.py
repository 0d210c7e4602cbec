"""Persistent XLA compilation cache, shared by every entry point.

Where `JAX_COMPILATION_CACHE_DIR` is set, JAX already reads it and the
cache lives there; nothing here overrides it. Otherwise the cache goes
to one fixed directory in the checkout (`.jax_cache/`, listed in
`.gitignore`): the directory is part of the cache's key, so a path that
moved between runs would never hit.
"""
from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")
ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def enable_compile_cache() -> str:
    """Turn on the persistent compile cache; return its directory."""
    import jax

    path = os.environ.get(ENV_VAR) or DEFAULT_DIR
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", path)
    # Cache every program that takes measurable compile time, whatever
    # its size.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.3)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return path
