"""JAX persistent compilation cache, set up in one place.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this module
sets no other directory.  Otherwise the cache lives at a fixed path inside the
checkout, ``<repo>/.jax_cache/`` (listed in .gitignore): the path is part of
the cache key, so it must not move between runs.
"""

from __future__ import annotations

import os
import pathlib

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def setup() -> str:
    """Enable the persistent cache; returns the directory in use.  Call
    before the first compilation."""
    path = os.environ.get(ENV_VAR)
    if not path:
        path = str(DEFAULT_DIR)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path
