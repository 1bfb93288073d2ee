"""Persistent XLA compilation-cache location.

A fused decode program takes seconds to compile, and a corpus needs a
handful of them, so scripts and tests keep compiled programs across
processes. Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it
itself and nothing here overrides it. Otherwise the cache lives in the
checkout, at ``<checkout>/.jax_cache`` (gitignored), and nowhere else.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"


def jit_cache_dir() -> str:
    """The cache directory in use: ``$JAX_COMPILATION_CACHE_DIR`` if set,
    else ``<checkout>/.jax_cache``."""
    if os.environ.get(ENV):
        return os.environ[ENV]
    repo = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    return os.path.join(repo, ".jax_cache")


def configure(jax) -> str:
    """Point jax's persistent compilation cache at jit_cache_dir().

    With ``JAX_COMPILATION_CACHE_DIR`` set this changes no setting: JAX
    already reads that variable. Returns the directory in use."""
    d = jit_cache_dir()
    if os.environ.get(ENV):
        return d
    os.makedirs(d, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", d)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return d
