"""Persistent XLA compile cache shared by every entry point.

The CLI, ``bench.py``, ``chip_smoke.py`` and the scripts call
:func:`enable_compile_cache` once at start-up. When
``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing is
set here. Otherwise the cache lives at the fixed
``<checkout>/.jax_compile_cache`` (git-ignored): a fixed path, because a
cache directory that moves between runs never hits.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_compile_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at its one directory and
    return that directory."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
