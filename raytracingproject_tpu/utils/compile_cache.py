"""The persistent XLA compile cache, set up the same way by every entry
point (CLI, bench.py, chip_smoke.py, __graft_entry__.py, the tests and
the tools).

Where `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and no
other directory is set here. Otherwise the cache lives at the fixed
`<repo>/.jax_cache` (listed in .gitignore): the path is part of the
cache key, so a directory that moved would never hit.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def cache_dir():
    """The directory the cache uses: the variable's, else the default."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable_compile_cache():
    """Turn the cache on for this process and cache every compile."""
    import jax
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return cache_dir()
