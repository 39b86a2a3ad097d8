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
