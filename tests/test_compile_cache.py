"""The one compile-cache helper every entry point calls."""

import os
import tempfile

import jax

from realisticaudioraytracing2d_tpu.utils import compile_cache as cc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _record(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    return calls


def test_env_var_is_honoured_and_nothing_is_set(monkeypatch):
    calls = _record(monkeypatch)
    monkeypatch.setenv(cc.ENV_VAR, "/some/where")
    assert cc.enable_compile_cache() == "/some/where"
    assert calls == []


def test_default_is_the_fixed_in_checkout_path(monkeypatch):
    calls = _record(monkeypatch)
    monkeypatch.delenv(cc.ENV_VAR, raising=False)
    path = cc.enable_compile_cache()
    assert path == os.path.join(REPO, ".jax_compile_cache")
    assert calls == [("jax_compilation_cache_dir", path)]


def test_default_path_is_stable(monkeypatch):
    _record(monkeypatch)
    monkeypatch.delenv(cc.ENV_VAR, raising=False)
    a, b = cc.enable_compile_cache(), cc.enable_compile_cache()
    assert a == b
    assert not a.startswith(tempfile.gettempdir())
    assert str(os.getpid()) not in a
