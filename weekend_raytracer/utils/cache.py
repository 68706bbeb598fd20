"""Persistent compilation cache setup.

The first compile of each (shape, kernel) signature takes seconds; the
persistent cache lets later processes reuse it. Enabled by the Renderer
(and so by the CLI, viewer and bench entry points):

 - where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already keeps its cache
   there and nothing here changes it;
 - otherwise the cache lives in ``.jax_cache`` at the root of the checkout
   (git-ignored). A fixed path matters: the path is part of the cache key,
   so a directory that moves never hits.
"""
from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", ".jax_cache"))


def enable_persistent_cache() -> None:
    """Point JAX at ``DEFAULT_DIR`` unless a cache directory is already
    configured (by ``JAX_COMPILATION_CACHE_DIR`` or by the caller)."""
    if os.environ.get(ENV_VAR) or jax.config.jax_compilation_cache_dir:
        return
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
