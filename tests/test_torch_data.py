"""The port's DGP copy and window functions against the JAX package's: equal
bit for bit on the same seed and the same inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masters_thesis_tpu.data.synthetic import (
    SyntheticKFactorReturns as JaxKFactor,
    SyntheticLogReturns as JaxLogReturns,
)
from masters_thesis_tpu.ops.windows import (
    add_quadratic_features as jax_quadratic,
    lookback_target_split as jax_split,
)
from masters_thesis_tpu_torch.data.synthetic import (
    SyntheticKFactorReturns,
    SyntheticLogReturns,
)
from masters_thesis_tpu_torch.ops.windows import (
    add_quadratic_features,
    lookback_target_split,
)


@pytest.mark.parametrize("variant", ["no_outliers", "outliers"])
def test_dgp_is_bitwise_the_jax_packages(variant):
    got = SyntheticLogReturns.generate(7, 300, seed=3, variant=variant)
    want = JaxLogReturns.generate(7, 300, seed=3, variant=variant)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)


def test_kfactor_dgp_is_bitwise_the_jax_packages():
    got = SyntheticKFactorReturns.generate(9, 200, n_factors=3, seed=4)
    want = JaxKFactor.generate(9, 200, n_factors=3, seed=4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n_factors", [1, 3])
@pytest.mark.parametrize("prediction", [True, False])
@pytest.mark.parametrize("interaction_only", [True, False])
def test_windows_are_bitwise_the_jax_packages(n_factors, prediction, interaction_only):
    if n_factors == 1:
        r_stocks, r_market, _, _ = SyntheticLogReturns.generate(6, 400, seed=1)
    else:
        r_stocks, r_market, _, _ = SyntheticKFactorReturns.generate(
            6, 400, n_factors=n_factors, seed=1
        )
    kw = dict(lookback_window=20, target_window=10, stride=15, prediction=prediction)
    x, y = lookback_target_split(
        torch.from_numpy(r_stocks), torch.from_numpy(r_market), **kw
    )
    jx, jy = jax_split(jnp.asarray(r_stocks), jnp.asarray(r_market), **kw)
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    feats = add_quadratic_features(x, interaction_only=interaction_only,
                                   include_bias=not interaction_only)
    jfeats = jax_quadratic(jx, interaction_only=interaction_only,
                           include_bias=not interaction_only)
    assert feats.shape == jfeats.shape
    np.testing.assert_array_equal(feats.numpy(), np.asarray(jfeats))


def test_window_split_refuses_what_the_jax_function_refuses():
    r = torch.zeros((2, 10))
    with pytest.raises(ValueError, match="shorter than one window"):
        lookback_target_split(r, torch.zeros(10), 8, 5)
    with pytest.raises(ValueError, match="reconstruction"):
        lookback_target_split(r, torch.zeros(10), 4, 5, prediction=False)


def test_pipeline_matches_the_jax_python_engine(tmp_path):
    """Bootstrap files, cache key, split ranges and window arrays of the
    port's data module against FinancialWindowDataModule(engine="python").
    x and y (with the ground-truth label channels) are equal bit for bit;
    the OLS factor stats and inverse idiosyncratic variances come from other
    reductions (torch vs XLA) and are held at 1e-5 relative."""
    from masters_thesis_tpu.data.pipeline import (
        FinancialWindowDataModule as JaxDataModule,
        bootstrap_synthetic as jax_bootstrap,
    )
    from masters_thesis_tpu_torch.data.pipeline import (
        FinancialWindowDataModule,
        bootstrap_synthetic,
    )

    bootstrap_synthetic(tmp_path / "port", n_stocks=5, n_samples=1500, seed=2)
    jax_bootstrap(tmp_path / "jax", n_stocks=5, n_samples=1500, seed=2)
    for name in ("stocks.npy", "market.npy", "alphas.npy", "betas.npy"):
        np.testing.assert_array_equal(np.load(tmp_path / "port" / name),
                                      np.load(tmp_path / "jax" / name))
    assert ((tmp_path / "port" / "dgp.json").read_text()
            == (tmp_path / "jax" / "dgp.json").read_text())

    kw = dict(lookback_window=30, target_window=15, stride=45)
    port = FinancialWindowDataModule(tmp_path / "port", **kw)
    ref = JaxDataModule(tmp_path / "jax", engine="python", **kw)
    assert port._hparams_hash() == ref._hparams_hash()
    port.prepare_data()
    ref.prepare_data(verbose=False)
    for dm in (port, ref):
        dm.setup()
    assert (port.train_range, port.val_range, port.test_range) == (
        ref.train_range, ref.val_range, ref.test_range)
    for split in ("train", "val", "test"):
        got = getattr(port, f"{split}_arrays")()
        want = getattr(ref, f"{split}_arrays")()
        np.testing.assert_array_equal(got.x, want.x)
        np.testing.assert_array_equal(got.y, want.y)
        np.testing.assert_allclose(got.factor, want.factor, rtol=1e-5, atol=0)
        np.testing.assert_allclose(got.inv_psi, want.inv_psi, rtol=1e-5, atol=0)


def test_bootstrap_and_cache_refuse_and_reuse(tmp_path):
    from masters_thesis_tpu_torch.data.pipeline import (
        FinancialWindowDataModule,
        bootstrap_synthetic,
    )

    bootstrap_synthetic(tmp_path, n_stocks=3, n_samples=400, seed=0)
    bootstrap_synthetic(tmp_path, n_stocks=3, n_samples=400, seed=0)
    with pytest.raises(ValueError, match="was requested"):
        bootstrap_synthetic(tmp_path, n_stocks=3, n_samples=400, seed=1)
    dm = FinancialWindowDataModule(tmp_path, lookback_window=20,
                                   target_window=10, stride=30)
    dm.prepare_data()
    cache = tmp_path / "datasets" / "dataset.npz"
    stamp = cache.stat().st_mtime_ns
    dm.prepare_data()
    assert cache.stat().st_mtime_ns == stamp
    other = FinancialWindowDataModule(tmp_path, lookback_window=20,
                                      target_window=10, stride=20)
    other.prepare_data()
    other.setup("fit")
    assert other.train_arrays().x.shape[1:] == (3, 20, 3)
    (tmp_path / "dgp.json").unlink()
    with pytest.raises(ValueError, match="without a dgp.json"):
        bootstrap_synthetic(tmp_path, n_stocks=3, n_samples=400, seed=0)
