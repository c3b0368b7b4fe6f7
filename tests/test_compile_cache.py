"""The compile-cache helper: a set JAX_COMPILATION_CACHE_DIR is left to
JAX; otherwise the cache goes to the fixed <checkout>/build/jax_cache."""

from __future__ import annotations

import pathlib

import jax
import pytest

from dct_tpu.utils import compile_cache

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_env_dir_is_left_to_jax(monkeypatch, tmp_path, restore_cache_dir):
    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.configure() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir is None


def test_default_is_fixed_checkout_path(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = str(REPO / "build" / "jax_cache")
    assert compile_cache.configure() == want
    assert jax.config.jax_compilation_cache_dir == want
    assert compile_cache.configure() == want  # stable across calls
