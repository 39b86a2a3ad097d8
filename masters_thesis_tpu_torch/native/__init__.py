"""The host-side C++ window engine: windows, features and OLS labels of the
scalar market series in one threaded pass (``window_engine.cpp``), built
at first use with the system C++ compiler and loaded with ``ctypes``.
Importing this package builds nothing."""

from masters_thesis_tpu_torch.native.build import NativeBuildError, ensure_built
from masters_thesis_tpu_torch.native.engine import (
    available,
    build_dataset,
    num_windows,
)

__all__ = [
    "NativeBuildError",
    "available",
    "build_dataset",
    "ensure_built",
    "num_windows",
]
