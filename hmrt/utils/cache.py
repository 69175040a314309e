"""The persistent compile cache, kept at a fixed path in the checkout.

A cold process on the card spends much of its first minute compiling. JAX
keys cache entries by program and by the cache's own path, so the cache
stays at one fixed directory: `JAX_COMPILATION_CACHE_DIR` when it is set
(JAX reads it itself and nothing is set here), else `.jax_cache/` at the
root of the checkout.
"""

from __future__ import annotations

import os

import jax

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at its fixed directory and
    return that directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
