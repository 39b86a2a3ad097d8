"""The compile-cache switch of the port's entry points
(``utils/compilation_cache.py``): the nvcc libraries go to a cache
directory, ``ops/_build/`` by default, and ``MT_NO_COMPILE_CACHE`` sends
a process's builds to a fresh directory of its own. On the CPU a stand-in
``nvcc`` on ``PATH`` writes each library, so ``ops/_build.py`` runs its
whole build here; the card test in ``tests/test_torch_cuda.py`` builds the
real libraries."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from masters_thesis_tpu.utils.compilation_cache import (
    enable_persistent_compilation_cache as jax_enable,
)
from masters_thesis_tpu_torch.cli import test as cli_test
from masters_thesis_tpu_torch.cli import train as cli_train
from masters_thesis_tpu_torch.ops import _build
from masters_thesis_tpu_torch.utils import compilation_cache as cc

REPO = Path(__file__).resolve().parent.parent

# A stand-in for nvcc: writes the library named by -o, and logs the call.
FAKE_NVCC = """#!{python}
import os, sys
out = sys.argv[sys.argv.index("-o") + 1]
with open(os.environ["FAKE_NVCC_LOG"], "a") as log:
    log.write(os.path.basename(sys.argv[-1]) + "\\n")
with open(out, "wb") as lib:
    lib.write(b"library of " + sys.argv[-1].encode())
print("ptxas info    : Used 1 registers")
"""


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """``nvcc`` on ``PATH`` (here and in children); returns its call log."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    log = tmp_path / "nvcc.log"
    log.write_text("")
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setenv("FAKE_NVCC_LOG", str(log))
    # Whatever a test sets, this process builds where it did before.
    monkeypatch.setattr(_build, "_build_dir", _build.build_dir())
    return log


def _snapshot(path: Path) -> dict:
    if not path.is_dir():
        return {}
    return {p.name: p.stat().st_mtime_ns for p in path.iterdir()}


CHILD = """
import json
from masters_thesis_tpu_torch.ops import _build
from masters_thesis_tpu_torch.utils import compilation_cache as cc
enabled = cc.enable_persistent_compilation_cache()
again = cc.enable_persistent_compilation_cache()
libs = _build.build_all()
print(json.dumps({"enabled": enabled, "again": again,
                  "dir": str(_build.build_dir()),
                  "libs": {k: str(v) for k, v in libs.items()},
                  "built": all(v.is_file() for v in libs.values())}))
"""


def test_no_cache_builds_each_process_in_a_fresh_directory(fake_nvcc,
                                                           monkeypatch):
    monkeypatch.setenv("MT_NO_COMPILE_CACHE", "1")
    monkeypatch.setenv("PYTHONPATH", str(REPO))
    before = _snapshot(_build.BUILD_DIR)
    runs = []
    for _ in range(2):
        proc = subprocess.run([sys.executable, "-c", CHILD], cwd=REPO,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        runs.append(json.loads(proc.stdout.splitlines()[-1]))
    for run in runs:
        assert run["enabled"] is False and run["again"] is False
        assert run["built"]
        build_dir = Path(run["dir"])
        assert build_dir.resolve() != _build.BUILD_DIR.resolve()
        assert all(Path(lib).parent == build_dir
                   for lib in run["libs"].values())
        # Removed when its process exited.
        assert not build_dir.exists()
    assert runs[0]["dir"] != runs[1]["dir"]
    # Every source built afresh in each process; nothing in ops/_build/.
    calls = fake_nvcc.read_text().split()
    assert sorted(calls) == sorted(2 * [s.name for s in _build.sources()])
    assert _snapshot(_build.BUILD_DIR) == before
    # The same names (the digest) in both directories.
    names = [{k: Path(v).name for k, v in run["libs"].items()}
             for run in runs]
    assert names[0] == names[1] == {
        s.stem: _build.library_path(s).name for s in _build.sources()}


def test_no_cache_in_process_keeps_one_private_directory(fake_nvcc,
                                                         monkeypatch):
    monkeypatch.setenv("MT_NO_COMPILE_CACHE", "1")
    monkeypatch.setattr(cc, "_private", None)
    assert cc.enable_persistent_compilation_cache() is False
    first = _build.build_dir()
    assert first.is_dir() and not any(first.iterdir())
    assert first.resolve() != _build.BUILD_DIR.resolve()
    # A cache directory asked for is not used while the switch is on.
    assert cc.enable_persistent_compilation_cache(first.parent / "x") is False
    assert _build.build_dir() == first


def test_cache_dir_is_honoured_and_reused(fake_nvcc, monkeypatch, tmp_path):
    monkeypatch.delenv("MT_NO_COMPILE_CACHE", raising=False)
    default_names = {s.stem: _build.library_path(s).name
                     for s in _build.sources()}
    cache = tmp_path / "cache"
    assert cc.enable_persistent_compilation_cache(cache) is True
    assert _build.build_dir() == cache
    libs = _build.build_all()
    assert {k: v.name for k, v in libs.items()} == default_names
    assert all(v.parent == cache and v.is_file() for v in libs.values())
    assert all(v.with_suffix(".log").is_file() for v in libs.values())
    calls = fake_nvcc.read_text().split()
    assert len(calls) == len(default_names)
    # A second build (this process or the next) reuses the cache.
    assert _build.build_all() == libs
    assert fake_nvcc.read_text().split() == calls
    # No argument: ops/_build/, as before.
    assert cc.enable_persistent_compilation_cache() is True
    assert _build.build_dir() == _build.BUILD_DIR == cc.DEFAULT_CACHE_DIR


def test_the_jax_switch_is_off_under_the_same_variable(monkeypatch):
    # Only with the variable set: the JAX tests run without a persistent
    # cache (tests/conftest.py).
    monkeypatch.setenv("MT_NO_COMPILE_CACHE", "1")
    monkeypatch.setattr(_build, "_build_dir", _build.build_dir())
    assert jax_enable() is False
    assert cc.enable_persistent_compilation_cache() is False


class _Called(Exception):
    pass


def _refuse(cache_dir=None):
    raise _Called


def test_the_entry_points_call_the_switch(monkeypatch):
    monkeypatch.setattr(cc, "enable_persistent_compilation_cache", _refuse)
    with pytest.raises(_Called):
        cli_train.run(cli_train.compose_config([]), device="cpu")
    with pytest.raises(_Called):
        cli_test.main(["checkpoint=/nonexistent", "--device", "cpu"])
