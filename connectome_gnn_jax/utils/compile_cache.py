"""Persistent compilation cache at a fixed place.

JAX keys cached executables partly by the cache directory, so a cache
that moves between runs never hits.  Entry points (``chip_smoke.py``,
``bench.py``, ``benchmarks/suite.py``, ``examples/*.py``) call
:func:`enable_compile_cache` once, before their first compile.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"

#: Default cache directory, inside the checkout (listed in .gitignore).
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and no
    other directory is set here.  Otherwise the cache goes to
    :data:`DEFAULT_DIR`.
    """
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
