"""Build the CUDA sources under ``ops/csrc`` at first use and load them.

Each ``csrc/*.cu`` file compiles with ``nvcc`` into its own shared library
with a plain C interface (no PyTorch headers, so a build takes seconds), named
by a hash of the source, the shared headers ``csrc/*.cuh`` and the flags:
``ops/_build/lib<stem>-<hash>.so``. A changed source or flag therefore gets a
fresh build, and an unchanged one is reused. Stale sources compile in
parallel, one ``nvcc`` each. A failed build raises with ``nvcc``'s output;
nothing falls back to another implementation.

The libraries are loaded with ``ctypes``; the kernel wrappers in
``ops/lstm_kernel.py`` declare each function's argument types.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # Registers, shared memory and spills of every kernel go to the build
    # log (build_log) so a run on the card can print them.
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


class NvccError(RuntimeError):
    """nvcc is missing or refused a source."""


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise NvccError(
        "nvcc not found on PATH or in /usr/local/cuda/bin; the CUDA kernels "
        "cannot be built"
    )


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path(source: Path) -> Path:
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(
        source.read_bytes() + headers + "\0".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}-{digest}.so"


def build_log(name: str) -> str:
    """nvcc's output (ptxas register and spill report) for ``csrc/<name>.cu``."""
    return library_path(CSRC_DIR / f"{name}.cu").with_suffix(".log").read_text()


def build_all() -> dict[str, Path]:
    """Compile every stale source, all at once; returns ``{stem: library}``."""
    libs = {src.stem: library_path(src) for src in sources()}
    stale = [src for src in sources() if not libs[src.stem].is_file()]
    if not stale:
        return libs
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in stale:
        out = libs[src.stem]
        # Build under a private name and rename: a concurrent process never
        # loads a half-written library.
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        procs.append((src, out, tmp, proc))
    failures = []
    for src, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{src.name} (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if failures:
        raise NvccError("nvcc failed on " + "\n".join(failures))
    return libs


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built if needed)."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            libs = build_all()
            if name not in libs:
                raise NvccError(f"no CUDA source csrc/{name}.cu")
            lib = ctypes.CDLL(str(libs[name]))
            _loaded[name] = lib
        return lib
