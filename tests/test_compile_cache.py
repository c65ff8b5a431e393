"""The persistent compile cache helper: the environment variable wins and
nothing is set in code; otherwise the repository's `.jax_cache`."""

import jax

from mpf_tpu.utils import compile_cache


def test_env_variable_is_left_to_jax(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert calls == []


def test_default_is_repo_cache(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = compile_cache.enable_compile_cache()
    assert got == str(compile_cache.DEFAULT_DIR)
    assert compile_cache.DEFAULT_DIR.name == ".jax_cache"
    assert compile_cache.DEFAULT_DIR.parent.joinpath("mpf_tpu").is_dir()
    assert calls == [("jax_compilation_cache_dir", got)]
