"""Persistent XLA compilation cache location, shared by every entry point."""

from __future__ import annotations

import os

import jax

# <checkout>/.jax_cache: fixed, because the path is part of what makes a
# cached program findable again by the next process.
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing else is set here. Otherwise the cache goes to the checkout's
    ``.jax_cache`` directory (listed in ``.gitignore``). Call before the
    first compilation: JAX fixes the cache location when it first uses it.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
