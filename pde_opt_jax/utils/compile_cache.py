"""Persistent XLA compilation cache for the repo's scripts.

The library itself sets no cache when it is imported; entry-point scripts
(``chip_smoke.py``, ``bench.py``, ``examples/``) call
:func:`enable_compile_cache` once at start-up.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

__all__ = ["enable_compile_cache", "DEFAULT_CACHE_DIR"]

# ``<repo>/.jax_cache`` (listed in .gitignore).  A fixed path: the cache
# key includes it, so a directory that moves between runs never hits.
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses that
    directory and nothing else is set here.  Otherwise the cache goes to
    :data:`DEFAULT_CACHE_DIR`.
    """
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)
