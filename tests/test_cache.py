"""The persistent compile-cache helper: ``$JAX_COMPILATION_CACHE_DIR`` when
set, else the fixed ``<repo>/.jax_cache``."""
import os

import jax

from ninwavelets_tpu.utils import cache

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def test_env_var_wins():
    env = {cache.ENV_VAR: "/somewhere/cache"}
    assert cache.compile_cache_dir(env) == "/somewhere/cache"


def test_default_is_repo_jax_cache():
    assert cache.compile_cache_dir({}) == os.path.join(REPO, ".jax_cache")
    assert cache.compile_cache_dir({cache.ENV_VAR: ""}) == os.path.join(
        REPO, ".jax_cache")


def test_repo_jax_cache_is_gitignored():
    with open(os.path.join(REPO, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


def _updates(monkeypatch):
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    return calls


def test_enable_sets_no_dir_when_env_set(monkeypatch):
    monkeypatch.setenv(cache.ENV_VAR, "/from/env")
    calls = _updates(monkeypatch)
    assert cache.enable_compile_cache() == "/from/env"
    assert "jax_compilation_cache_dir" not in calls


def test_enable_sets_repo_dir_when_env_unset(monkeypatch):
    monkeypatch.delenv(cache.ENV_VAR, raising=False)
    calls = _updates(monkeypatch)
    assert cache.enable_compile_cache() == os.path.join(REPO, ".jax_cache")
    assert calls["jax_compilation_cache_dir"] == os.path.join(
        REPO, ".jax_cache")
