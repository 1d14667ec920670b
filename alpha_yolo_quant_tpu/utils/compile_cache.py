"""Where JAX keeps its persistent compilation cache.

The cache key includes the directory, so a directory that moves between
runs never hits: the fallback is one fixed path inside the checkout
(listed in .gitignore), never a temp name, a pid or a time.
"""

from __future__ import annotations

import os

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def configure_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory. When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX
    reads it itself and nothing else is set here; otherwise the cache
    goes to ``<checkout>/.jax_cache``. Call before the first compile: JAX
    fixes the cache directory at its first compilation."""
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
