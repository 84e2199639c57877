"""The compile-cache helper: JAX_COMPILATION_CACHE_DIR wins; otherwise a
fixed directory inside the checkout that git ignores."""

import os

import jax

from connectome_gnn_jax.utils import compile_cache


def test_env_var_set_sets_no_other_directory(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert calls == []


def test_env_var_unset_uses_the_fixed_checkout_directory(monkeypatch):
    calls = []
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    assert compile_cache.enable_compile_cache() == compile_cache.DEFAULT_DIR
    assert calls == [("jax_compilation_cache_dir", compile_cache.DEFAULT_DIR)]


def test_default_directory_is_in_the_checkout_and_ignored():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert os.path.dirname(compile_cache.DEFAULT_DIR) == root
    name = os.path.basename(compile_cache.DEFAULT_DIR)
    with open(os.path.join(root, ".gitignore")) as f:
        assert f"{name}/" in f.read().split()
