"""Compile-cache location (utils.compile_cache) and the GPU-only smoke run."""

import os
import subprocess
import sys

import jax
import pytest

from sgtd_tpu.utils.compile_cache import CHECKOUT, enable_compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_var_wins_and_nothing_is_set(monkeypatch, tmp_path,
                                         restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_default_is_checkout_jax_cache(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = enable_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert CHECKOUT == REPO
    assert jax.config.jax_compilation_cache_dir == path


def test_chip_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
