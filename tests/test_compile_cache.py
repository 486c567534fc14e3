"""utils.compile_cache: the persistent compilation cache is placed from
outside (JAX_COMPILATION_CACHE_DIR) or at one fixed in-checkout path."""

import os
import pathlib
import subprocess
import sys

import jax

from iterative_inference_segm.utils import compile_cache
from iterative_inference_segm.utils.compile_cache import (
    DEFAULT_DIR,
    ENV_VAR,
    configure_compile_cache,
)

REPO = pathlib.Path(__file__).resolve().parent.parent

_JIT_ONCE = (
    "import sys; sys.path.insert(0, {repo!r});"
    "from iterative_inference_segm.utils.compile_cache import configure_compile_cache;"
    "print(configure_compile_cache());"
    "import jax; jax.config.update('jax_persistent_cache_min_compile_time_secs', 0);"
    "jax.jit(lambda x: x * 3 + 1)(jax.numpy.ones(5)).block_until_ready()"
)


def test_default_dir_is_fixed_inside_the_checkout():
    assert DEFAULT_DIR == REPO / ".jax_compile_cache"


def test_unset_env_uses_default_dir(monkeypatch):
    monkeypatch.delenv(ENV_VAR, raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        assert configure_compile_cache() == str(DEFAULT_DIR)
        assert jax.config.jax_compilation_cache_dir == str(DEFAULT_DIR)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_set_env_changes_nothing(monkeypatch, tmp_path):
    monkeypatch.setenv(ENV_VAR, str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert configure_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_entry_point_caches_only_in_env_dir(tmp_path):
    cache = tmp_path / "cache"
    env = {**os.environ, ENV_VAR: str(cache), "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    out = subprocess.run(
        [sys.executable, "-c", _JIT_ONCE.format(repo=str(REPO))],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == str(cache)
    assert any(cache.iterdir()), "nothing was cached in JAX_COMPILATION_CACHE_DIR"
    assert [p.name for p in tmp_path.iterdir()] == ["cache"]


def test_conftest_follows_env():
    if os.environ.get("JAX_TEST_COMPILATION_CACHE") == "off":
        expected = None
    else:
        expected = os.environ.get(ENV_VAR) or str(compile_cache.DEFAULT_DIR)
    assert jax.config.jax_compilation_cache_dir == expected
