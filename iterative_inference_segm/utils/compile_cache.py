"""Where JAX's persistent compilation cache lives.

A cold compile of the VGG16 backbone at 360x480, with XLA's GPU autotuning,
is a large share of a short run, so every entry point keeps compiled
programs on disk. The cache directory is part of each entry's lookup, so it
must not move between runs: either the deployment names it through
``JAX_COMPILATION_CACHE_DIR`` (which JAX reads itself), or it is the fixed
in-checkout directory ``<repo>/.jax_compile_cache`` (gitignored).
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_compile_cache"


def configure_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory; return it.

    With ``JAX_COMPILATION_CACHE_DIR`` set, JAX already uses that directory
    and nothing is changed. Otherwise the cache goes to ``DEFAULT_DIR``.
    """
    env_dir = os.environ.get(ENV_VAR)
    if env_dir:
        return env_dir
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
