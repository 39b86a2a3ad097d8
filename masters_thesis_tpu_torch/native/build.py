"""Build of the window engine's shared library, at first use, cached.

``g++`` (or ``c++``, ``clang++``) compiles ``window_engine.cpp`` with
``-O3 -std=c++17`` into ``<package>/native/_build/
window_engine_<arch>_<source hash>.so``: a changed source, or another
machine architecture on a shared file system, builds its own library. The
engine has a plain C interface (``engine.py`` binds it with ``ctypes``),
so a C++ compiler is the only build dependency.
"""

from __future__ import annotations

import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path

_NATIVE_DIR = Path(__file__).resolve().parent
_SOURCE = _NATIVE_DIR / "window_engine.cpp"
_BUILD_DIR = _NATIVE_DIR / "_build"

_CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
              "-fvisibility=hidden"]


class NativeBuildError(RuntimeError):
    """No compiler, or the compiler refused the source."""


def _source_hash() -> str:
    return hashlib.sha256(_SOURCE.read_bytes()).hexdigest()[:16]


def library_path() -> Path:
    return _BUILD_DIR / f"window_engine_{platform.machine()}_{_source_hash()}.so"


def compiler() -> str | None:
    return shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")


def ensure_built() -> Path:
    """The library's path, compiling it first when its build is missing."""
    lib = library_path()
    if lib.exists():
        return lib
    cxx = compiler()
    if cxx is None:
        raise NativeBuildError("no C++ compiler found (g++/c++/clang++)")
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # A name of this process's own, renamed into place: concurrent first
    # builders (test workers) each write their own file.
    tmp = lib.with_suffix(f".so.tmp{os.getpid()}")
    cmd = [cxx, *_CXX_FLAGS, str(_SOURCE), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(
            f"native engine build failed (exit {proc.returncode}):\n"
            f"{proc.stderr}")
    tmp.replace(lib)
    return lib
