"""Where JAX keeps its persistent compilation cache.

The full-size programs take minutes to compile and are identical from one
run to the next, so every entry point (the CLI, bench.py, bench_fullsize,
chip_smoke.py) shares one cache. The cache key includes the directory, so
the default is a fixed path inside the checkout, listed in .gitignore.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache and return its directory.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and this
    sets nothing; otherwise the cache goes to DEFAULT_DIR."""
    if os.environ.get(ENV_VAR):
        return os.environ[ENV_VAR]
    import jax
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
