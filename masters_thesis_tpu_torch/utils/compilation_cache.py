"""The compile cache of the command lines: where the CUDA libraries are built.

Counterpart of ``masters_thesis_tpu/utils/compilation_cache.py``. What the
port compiles is its kernels: ``ops/_build.py`` builds each ``csrc/*.cu``
with nvcc into a shared library named by a hash of the source, the shared
headers and the flags, and reuses a library whose name is already in its
directory. That directory is the persistent cache: a process after the
first one starts without building. The entry points (``cli/train.py``,
``cli/test.py``) opt in through :func:`enable_persistent_compilation_cache`
where the JAX ``train.py`` and ``test.py`` do; library code and
``chip_smoke.py`` build into ``ops/_build/`` as before.

``MT_NO_COMPILE_CACHE=1`` turns the cache off: the process builds into a
fresh directory of its own, so that nothing is read from the cache or
written to it, and a run measures the build itself (as the JAX switch lets
a run measure the XLA compile). The directory is removed when the process
exits.

Two things of the JAX module have no counterpart here:

- its ``XLA_FLAGS`` guard, which keeps the cache off on XLA's forced
  multi-device host platform, whose deserialized executables diverged from
  fresh compiles; it concerns XLA's host platform only (a card test holds
  a library built afresh against the cached one, bit for bit);
- an on-disk cache of what the port captures at run time, its CUDA graphs:
  a graph cannot leave the process that captured it, so the serving
  program cache (``serve/program_cache.py``) keeps them in the process.
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile
from pathlib import Path

from masters_thesis_tpu_torch.ops import _build

DEFAULT_CACHE_DIR = _build.BUILD_DIR

#: This process's private build directory under ``MT_NO_COMPILE_CACHE``:
#: (pid, path), made once a process.
_private: tuple[int, Path] | None = None


def _private_dir() -> Path:
    global _private
    if _private is None or _private[0] != os.getpid():
        path = Path(tempfile.mkdtemp(prefix="mtt_nvcc_"))
        atexit.register(shutil.rmtree, path, ignore_errors=True)
        _private = (os.getpid(), path)
    return _private[1]


def enable_persistent_compilation_cache(cache_dir: Path | None = None) -> bool:
    """Build the CUDA libraries into ``cache_dir`` (default
    ``ops/_build/``, made at the first build) and reuse what it holds;
    returns False, with the builds sent to a fresh private directory, when
    ``MT_NO_COMPILE_CACHE`` is set."""
    if os.environ.get("MT_NO_COMPILE_CACHE"):
        _build.set_build_dir(_private_dir())
        return False
    _build.set_build_dir(cache_dir or DEFAULT_CACHE_DIR)
    return True
