"""Where the persistent XLA compilation cache lives.

``JAX_COMPILATION_CACHE_DIR`` wins when it is set, and then no other
directory is configured. Otherwise the cache goes to ``.jax_cache`` at the
root of the checkout (listed in ``.gitignore``): a fixed path, because the
path is part of the cache key and a directory that moves never hits.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

CHECKOUT = Path(__file__).resolve().parents[2]


def cache_dir() -> str:
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or str(CHECKOUT / ".jax_cache"))


def enable_compile_cache(min_compile_secs: float = 1.0) -> str:
    """Point JAX's persistent cache at ``cache_dir()``; returns the path.
    Executables that compile faster than ``min_compile_secs`` are not
    written."""
    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      float(min_compile_secs))
    return path
