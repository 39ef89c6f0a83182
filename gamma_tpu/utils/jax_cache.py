"""Persistent XLA compilation cache location.

Capacity growth and new batch shapes recompile; the persistent cache
keeps those compiles across processes.  One policy for every entry
point (the engine, bench.py, chip_smoke.py):

  * `JAX_COMPILATION_CACHE_DIR` set (or the cache directory already
    configured in this process): used as is, nothing else is set;
  * otherwise `.jax_cache/` at the checkout root — a fixed path, since
    the path is part of the cache key and a moving directory never hits.
"""

from __future__ import annotations

import os

import jax

CHECKOUT_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = os.path.join(CHECKOUT_ROOT, ".jax_cache")


def enable_compilation_cache() -> str:
    """Turn the persistent compilation cache on → the directory in use."""
    configured = jax.config.jax_compilation_cache_dir
    if configured:
        return configured
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return DEFAULT_CACHE_DIR
