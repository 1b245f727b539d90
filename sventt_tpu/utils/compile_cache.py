"""Where JAX keeps its persistent compilation cache: one rule for every script.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
here sets another directory.  Otherwise the cache goes to ``.jax_cache`` at
the repository root (git-ignored).  The path is fixed, never temporary or
per-process, because it is part of what a later run must find again.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV = "JAX_COMPILATION_CACHE_DIR"

#: The cache directory when ``JAX_COMPILATION_CACHE_DIR`` is not set.
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; return its directory.

    Call before the first compilation of the process: JAX latches the
    cache configuration when it first compiles.
    """
    path = os.environ.get(ENV)
    if path:
        return path
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
