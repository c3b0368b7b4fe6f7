"""Where JAX keeps its persistent compilation cache.

Entry points (CLI, chip_smoke.py, bench.py, examples/) call
``configure()`` before their first compile, so repeated runs of the same
shapes load compiled executables instead of recompiling them.
"""

from __future__ import annotations

import os
import pathlib

import jax

# Fixed and checkout-relative: a temporary, pid- or time-derived directory
# would never be found again by the next run.
DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "jax_cache"


def configure() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory. A set ``JAX_COMPILATION_CACHE_DIR`` is left to
    JAX, which reads it itself; otherwise the cache lives in
    ``<checkout>/build/jax_cache``."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
