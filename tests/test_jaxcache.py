"""Persistent compilation cache placement (utils/jaxcache)."""
import os

import jax
import pytest

from wenet_tpu.utils import jaxcache

_KEYS = ("jax_compilation_cache_dir",
         "jax_persistent_cache_min_compile_time_secs",
         "jax_persistent_cache_min_entry_size_bytes")


@pytest.fixture
def restore_config():
    saved = {k: getattr(jax.config, k) for k in _KEYS}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


def test_env_dir_wins_and_nothing_is_set(monkeypatch, restore_config,
                                         tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = {k: getattr(jax.config, k) for k in _KEYS}
    assert jaxcache.enable_persistent_cache() == str(tmp_path)
    assert {k: getattr(jax.config, k) for k in _KEYS} == before


def test_default_is_repo_dot_jax_cache(monkeypatch, restore_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    expect = os.path.join(repo, ".jax_cache")
    assert jaxcache.enable_persistent_cache() == expect
    assert jax.config.jax_compilation_cache_dir == expect
    assert os.path.isdir(expect)
