"""The port's C++ window engine against the JAX package's build of the same
source, and the data module's engine choice.

The two builds compile one C++ body (the port keeps its own copy), so the
port's output equals the JAX build's bit for bit. The data module takes the
engine for the scalar market series under ``engine="auto"`` and
``"native"``, never for K-factor windows, and says so when it cannot build
it.
"""

import numpy as np
import pytest

from masters_thesis_tpu import native as jax_native
from masters_thesis_tpu_torch import native
from masters_thesis_tpu_torch.data.pipeline import (
    FinancialWindowDataModule,
    bootstrap_synthetic,
)
from masters_thesis_tpu_torch.native import build as native_build

KEYS = ("x", "y", "alphas", "betas", "factor", "inv_psi")


def _series(seed=0, n_stocks=7, n_samples=500):
    rng = np.random.default_rng(seed)
    market = rng.normal(0, 0.01, size=n_samples).astype(np.float32)
    stocks = (0.001 + rng.normal(1, 0.3, size=(n_stocks, 1)) * market
              + rng.normal(0, 0.01, size=(n_stocks, n_samples)))
    return stocks.astype(np.float32), market


@pytest.mark.parametrize("prediction", [True, False])
@pytest.mark.parametrize("interaction_only", [True, False])
def test_port_build_equals_the_jax_build(interaction_only, prediction):
    stocks, market = _series()
    kw = dict(lookback_window=30, target_window=10, stride=25,
              prediction=prediction, interaction_only=interaction_only)
    got = native.build_dataset(stocks, market, **kw)
    want = jax_native.build_dataset(stocks, market, **kw)
    for key in KEYS:
        assert got[key].dtype == np.float32
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["x"].shape == (19, 7, 30, 3 if interaction_only else 5)
    assert native.num_windows(500, 40, 25) == jax_native.num_windows(500, 40, 25)
    assert native_build.library_path().parent.name == "_build"
    assert native_build.library_path().parent.parent == (
        native_build._NATIVE_DIR)


def test_engine_refuses_bad_series():
    stocks, market = _series()
    with pytest.raises(ValueError, match="expected stocks"):
        native.build_dataset(stocks, market[:-1], 30, 10, 25)
    with pytest.raises(ValueError, match="shorter than one window"):
        native.build_dataset(stocks[:, :20], market[:20], 30, 10, 25)


def _data(tmp_path, n_factors=1):
    bootstrap_synthetic(tmp_path / "data", n_stocks=5, n_samples=1500, seed=1,
                        n_factors=n_factors)
    return tmp_path / "data"


WINDOWS = dict(lookback_window=30, target_window=15, stride=45)


@pytest.mark.parametrize("engine", ["auto", "native"])
def test_datamodule_builds_scalar_windows_through_the_engine(tmp_path, engine):
    """``auto`` and ``native`` cache the engine's arrays (the labels of the
    ground truth appended), and the python engine's x and y are the same
    bits."""
    data = _data(tmp_path)
    dm = FinancialWindowDataModule(data, engine=engine, **WINDOWS)
    dm.prepare_data()
    dm.setup()
    want = native.build_dataset(np.load(data / "stocks.npy"),
                                np.load(data / "market.npy"),
                                **{k: v for k, v in WINDOWS.items()})
    arrays = dm.train_arrays()
    n = len(dm.train_range)
    np.testing.assert_array_equal(arrays.x, want["x"][:n])
    np.testing.assert_array_equal(arrays.y[..., :2], want["y"][:n])
    np.testing.assert_array_equal(arrays.factor, want["factor"][:n])
    np.testing.assert_array_equal(arrays.inv_psi, want["inv_psi"][:n])
    python = FinancialWindowDataModule(data, engine="python", **WINDOWS)
    out = python.build_windows(np.load(data / "stocks.npy"),
                               np.load(data / "market.npy"))
    np.testing.assert_array_equal(out[0], want["x"])
    np.testing.assert_array_equal(out[1], want["y"])


def test_native_engine_refuses_factors_and_auto_takes_python(tmp_path):
    data = _data(tmp_path, n_factors=3)
    with pytest.raises(ValueError, match="scalar market series"):
        FinancialWindowDataModule(data, engine="native", **WINDOWS).prepare_data()
    dm = FinancialWindowDataModule(data, engine="auto", **WINDOWS)
    dm.prepare_data()
    dm.setup()
    assert dm.train_arrays().y.shape[-1] == 8 and dm.n_features == 7


def test_a_failed_build_prints_under_auto_and_raises_under_native(
        tmp_path, monkeypatch, capsys):
    data = _data(tmp_path)

    def refuse(*args, **kwargs):
        raise native.NativeBuildError("native engine build failed (exit 1)")

    monkeypatch.setattr(native, "build_dataset", refuse)
    dm = FinancialWindowDataModule(data, engine="auto", **WINDOWS)
    dm.prepare_data()
    assert ("native engine unavailable (native engine build failed (exit 1)); "
            "using the python engine") in capsys.readouterr().out
    dm.setup()
    assert dm.train_arrays().x.shape[1:] == (5, 30, 3)
    with pytest.raises(native.NativeBuildError, match="build failed"):
        FinancialWindowDataModule(data, engine="native", lookback_window=20,
                                  target_window=10, stride=30).prepare_data()
    monkeypatch.setattr(native_build, "compiler", lambda: None)
    monkeypatch.setattr(native_build, "library_path",
                        lambda: tmp_path / "absent.so")
    with pytest.raises(native.NativeBuildError, match="no C\\+\\+ compiler"):
        native_build.ensure_built()
