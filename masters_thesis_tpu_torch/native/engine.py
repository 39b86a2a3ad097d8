"""ctypes bindings of the C++ window engine.

``build_dataset`` makes in one call what the data module's python engine
makes from the scalar market series (``ops/windows.py``): the
feature-expanded lookback windows, the raw target windows and the
per-window OLS labels, as fresh numpy arrays. ``available()`` says whether
the engine is built or can be.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from masters_thesis_tpu_torch.native.build import (
    NativeBuildError,
    compiler,
    ensure_built,
    library_path,
)

_i64 = ctypes.c_longlong
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")


@functools.cache
def _load() -> ctypes.CDLL:
    try:
        lib = ctypes.CDLL(str(ensure_built()))
    except OSError:
        # A corrupt or foreign cached build: rebuild it once.
        library_path().unlink(missing_ok=True)
        lib = ctypes.CDLL(str(ensure_built()))
    lib.mt_num_windows.restype = _i64
    lib.mt_num_windows.argtypes = [_i64, _i64, _i64]
    lib.mt_build_dataset.restype = ctypes.c_int
    lib.mt_build_dataset.argtypes = [
        _f32p, _f32p,  # stocks, market
        _i64, _i64, _i64, _i64, _i64,  # K, T, L, Tt, stride
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # prediction, interaction_only, n_threads
        _f32p, _f32p, _f32p, _f32p, _f32p, _f32p,  # x, y, alphas, betas, factor, inv_psi
    ]
    return lib


def available() -> bool:
    """True when the engine is built or a C++ compiler is on the PATH."""
    return library_path().exists() or compiler() is not None


def num_windows(n_samples: int, total_window: int, stride: int) -> int:
    return int(_load().mt_num_windows(n_samples, total_window, stride))


def build_dataset(
    stocks: np.ndarray,
    market: np.ndarray,
    lookback_window: int,
    target_window: int,
    stride: int,
    prediction: bool = True,
    interaction_only: bool = True,
) -> dict[str, np.ndarray]:
    """The fused window, feature and OLS pass over ``stocks`` ``(K, T)``
    and ``market`` ``(T,)``, on as many threads as the engine picks.

    Returns float32 ``x (n_win, K, L, F)``, ``y (n_win, K, Tt, 2)``,
    ``alphas``, ``betas``, ``inv_psi`` ``(n_win, K)`` and ``factor (n_win,
    2)``.
    """
    stocks = np.ascontiguousarray(stocks, np.float32)
    market = np.ascontiguousarray(market, np.float32)
    if stocks.ndim != 2 or market.ndim != 1 or stocks.shape[1] != market.shape[0]:
        raise ValueError(
            f"expected stocks (K, T) and market (T,); got {stocks.shape} "
            f"and {market.shape}")
    k, t = stocks.shape
    total = lookback_window + target_window if prediction else lookback_window
    lib = _load()
    n_win = int(lib.mt_num_windows(t, total, stride))
    if n_win < 1:
        raise ValueError(
            f"series of length {t} is shorter than one window ({total} steps)")
    n_features = 3 if interaction_only else 5

    x = np.empty((n_win, k, lookback_window, n_features), np.float32)
    y = np.empty((n_win, k, target_window, 2), np.float32)
    alphas = np.empty((n_win, k), np.float32)
    betas = np.empty((n_win, k), np.float32)
    factor = np.empty((n_win, 2), np.float32)
    inv_psi = np.empty((n_win, k), np.float32)
    rc = lib.mt_build_dataset(
        stocks, market, k, t, lookback_window, target_window, stride,
        int(prediction), int(interaction_only), 0,  # 0: the engine's pick
        x, y, alphas, betas, factor, inv_psi,
    )
    if rc != 0:
        raise NativeBuildError(f"mt_build_dataset failed with code {rc}")
    return {"x": x, "y": y, "alphas": alphas, "betas": betas,
            "factor": factor, "inv_psi": inv_psi}
