"""utils/cache.py: the environment's cache directory wins; otherwise the
fixed in-checkout .jax_cache/."""
import os

import jax
import pytest

from imagestitch_tpu.utils import cache


@pytest.fixture
def restore_config():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_env_dir_is_used_and_nothing_else_set(monkeypatch, tmp_path,
                                              restore_config):
    jax.config.update("jax_compilation_cache_dir", str(tmp_path / "env"))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    assert cache.enable_compilation_cache() == str(tmp_path / "env")
    assert jax.config.jax_compilation_cache_dir == str(tmp_path / "env")
    assert not os.path.exists(tmp_path / "env")   # JAX's to create, not ours


def test_unset_uses_the_checkout_dir(monkeypatch, restore_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = cache.enable_compilation_cache()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(root, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert os.path.isdir(path)
