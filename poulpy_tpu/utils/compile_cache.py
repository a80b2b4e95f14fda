"""Where JAX keeps its persistent compilation cache.

`JAX_COMPILATION_CACHE_DIR` wins when it is set.  Otherwise the cache lives
at a fixed directory inside the checkout (`<repo>/.jax_cache`, listed in
`.gitignore`): the path is part of what a later process looks up, so it is
never built from a temp name, a pid or the time.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def compile_cache_dir() -> str:
    """The cache directory this process should use."""
    return os.environ.get(ENV_VAR) or str(DEFAULT_DIR)


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at `compile_cache_dir()`
    and return that path."""
    import jax

    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
