"""Repo-root conftest: make the package importable and pick the test backend.

Tests run on the CPU with a faked 8-device platform so the data-parallel
path is exercised without a multi-card host (standard JAX practice,
SURVEY.md §5). XLA_FLAGS is read when the backend initializes, which has not
happened yet, so setting it here still takes effect; the platform is also
pinned through ``jax.config`` in case an interpreter start-up hook imported
jax before this file ran.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(__file__))

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["JAX_PLATFORM_NAME"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# Persistent XLA compilation cache: the suite's time is mostly CPU compiles
# of the same FCN-8/DAE graphs on every run. Keyed by HLO + jax/XLA version,
# so code changes recompile exactly what they touch. JAX_COMPILATION_CACHE_DIR
# wins when set; JAX_TEST_COMPILATION_CACHE=off disables the cache.
if os.environ.get("JAX_TEST_COMPILATION_CACHE") != "off":
    from iterative_inference_segm.utils.compile_cache import (  # noqa: E402
        configure_compile_cache,
    )

    configure_compile_cache()
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)
