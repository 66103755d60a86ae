"""Where the persistent XLA compile cache lives.

JAX reads `JAX_COMPILATION_CACHE_DIR` itself, so when it is set nothing is
configured here.  Otherwise the cache is one fixed directory inside the
checkout (listed in `.gitignore`): the path is part of the cache key, so a
directory that moves between runs never hits.
"""

from __future__ import annotations

import os

import jax

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CACHE_ROOT = os.path.join(CHECKOUT, ".cache")
DEFAULT_DIR = os.path.join(CACHE_ROOT, "jax")


def cache_dir() -> str:
    """The directory the compile cache uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable() -> str:
    """Turn on the persistent compile cache; returns its directory."""
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return cache_dir()
