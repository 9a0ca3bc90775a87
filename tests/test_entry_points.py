"""Entry-point plumbing: the compile-cache location, the native codec
build, and chip_smoke.py's refusal to run without a GPU."""

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import jax
import pytest

from scale_letkf_tpu.utils import compile_cache, native

REPO = Path(__file__).resolve().parents[1]


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, JAX reads it itself and the
    helper sets nothing."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a, **k: calls.append(a))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert calls == []


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch):
    """Without the variable the cache goes to one fixed directory inside
    the checkout (listed in .gitignore), never under /tmp."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a, **k: calls.append(a))
    first = compile_cache.enable_compile_cache()
    assert first == compile_cache.enable_compile_cache()
    assert Path(first) == REPO / ".jax_cache"
    assert not first.startswith("/tmp")
    assert calls[0] == ("jax_compilation_cache_dir", first)
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


def _native_copy(tmp_path):
    d = tmp_path / "native"
    d.mkdir()
    for f in ("Makefile", "fortseq.cpp"):
        shutil.copy(REPO / "native" / f, d / f)
    return d


@pytest.mark.parametrize("state", ["missing", "stale"])
def test_native_build_when_missing_or_stale(tmp_path, state):
    """The codec library is a build product: built when missing, rebuilt
    when older than its source, left alone when current."""
    if shutil.which("make") is None or shutil.which("g++") is None:
        pytest.skip("no C++ toolchain")
    d = _native_copy(tmp_path)
    so = d / "libfortseq.so"
    if state == "stale":
        so.write_bytes(b"stale")
        old = time.time() - 3600
        os.utime(so, (old, old))
    assert native.build(d) == so
    assert so.stat().st_size > 100
    built = so.stat().st_mtime
    assert built >= (d / "fortseq.cpp").stat().st_mtime
    native.build(d)                        # current: no rebuild
    assert so.stat().st_mtime == built


def test_chip_smoke_refuses_cpu():
    """Without a GPU the smoke test exits non-zero and reports ok=false:
    nothing continues on the CPU."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0
    last = json.loads(p.stdout.strip().splitlines()[-1])
    assert last["ok"] is False
    assert p.stdout.splitlines()[0].startswith("card:")


def test_chip_smoke_needs_the_repo(tmp_path):
    """Alone in a directory, without the package, it fails."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert json.loads(p.stdout.strip().splitlines()[-1])["ok"] is False
