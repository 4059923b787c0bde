"""Where the persistent XLA compilation cache lives.

One rule for every entry point (bench, chip smoke test, CLI, scripts):
``JAX_COMPILATION_CACHE_DIR`` when the environment sets it, else a fixed
directory in the checkout.  The path is part of the cache's key, so it
never depends on a temp dir, a pid or the time.
"""

from __future__ import annotations

import os
import pathlib
from typing import Mapping

CHECKOUT = pathlib.Path(__file__).resolve().parents[2]


def compile_cache_dir(environ: Mapping[str, str] = os.environ) -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` if set, else ``<checkout>/.jax_cache``."""
    return environ.get("JAX_COMPILATION_CACHE_DIR") or str(CHECKOUT / ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at :func:`compile_cache_dir`
    and return the directory."""
    import jax

    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
