"""Entry-point plumbing: the compile-cache placement and the GPU-only
scripts' refusal to run anywhere else."""

import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

from lfinterpolator_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cache_dir_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    assert compile_cache.cache_dir() == str(tmp_path / "c")


@pytest.mark.parametrize("env", [None, ""])
def test_cache_dir_defaults_to_checkout(monkeypatch, env):
    """Without the variable (or with it empty) the cache is the checkout's
    git-ignored .jax_cache -- a fixed path, never a temporary one."""
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
    assert compile_cache.cache_dir() == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_enable_sets_jax_config(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    try:
        assert compile_cache.enable() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_cli_enables_the_cache(monkeypatch, tmp_path):
    from lfinterpolator_tpu import cli

    calls = []
    monkeypatch.setattr(compile_cache, "enable", lambda: calls.append(1))
    rc = cli.main(["-i", str(tmp_path / "missing"), "-o", str(tmp_path),
                   "-t", "0,0,1,1", "-m", "STD"])
    assert rc == 1 and calls == [1]


def _run(args, cwd, **env):
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, capture_output=True, text=True,
        timeout=240, env=dict(os.environ, JAX_PLATFORMS="cpu", **env),
    )


def _printed_result(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            if isinstance(json.loads(line), dict):
                return True
        except ValueError:
            pass
    return False


def test_chip_smoke_refuses_cpu_backend():
    out = _run(["chip_smoke.py"], REPO)
    assert out.returncode != 0
    assert not _printed_result(out.stdout)
    assert "needs a GPU" in out.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """Copied away from the package it cannot pass, nor print a result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run(["chip_smoke.py"], str(tmp_path))
    assert out.returncode != 0
    assert not _printed_result(out.stdout)


def test_bench_refuses_cpu_backend():
    out = _run(["bench.py", "--config", "headline"], REPO)
    assert out.returncode == 2
    assert out.stdout == ""
    assert "needs a GPU" in out.stderr


def test_compare_engines_refuses_cpu_backend():
    out = _run(["scripts/compare_engines.py", "--only", "blend"], REPO)
    assert out.returncode == 2
    assert "compile only for a GPU" in out.stderr
