"""Where JAX keeps its persistent compilation cache.

Every entry point calls ``setup_compile_cache()`` before its first
compile.  ``JAX_COMPILATION_CACHE_DIR``, when set, is honoured as it is
(JAX reads it itself).  Otherwise the cache sits at one fixed path in the
checkout, ``<repo>/.jax_cache``: the path is part of the cache key, so a
temporary or per-process directory would never hit.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def setup_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory; return it."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    return str(CACHE_DIR)
