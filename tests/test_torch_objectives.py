"""The port's OLS, covariance, loss and window-objective functions against
the JAX package's, on the same numpy inputs.

Tolerances: 1e-5 abs plus 1e-5 relative (f32 on both sides; the NLL sums
K*n terms of order 1-100, and the pseudo-inverse and reductions run in
another order), gradients the same.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masters_thesis_tpu.models.objectives import (
    batched_objective as jax_batched,
    make_combined_window as jax_combined,
    mse_window as jax_mse,
    nll_window as jax_nll,
)
from masters_thesis_tpu.ops.linalg import (
    inverse_returns_covariance as jax_inv_cov,
    ols as jax_ols,
)
from masters_thesis_tpu.ops.losses import (
    mean_squared_error as jax_mean_squared_error,
    single_factor_gaussian_nll as jax_sf_nll,
)
from masters_thesis_tpu.ops.windows import ols_features as jax_ols_features
from masters_thesis_tpu_torch.models import objectives as obj
from masters_thesis_tpu_torch.ops.linalg import inverse_returns_covariance, ols
from masters_thesis_tpu_torch.ops.losses import (
    mean_squared_error,
    single_factor_gaussian_nll,
)
from masters_thesis_tpu_torch.ops.windows import ols_features

TOL = dict(atol=1e-5, rtol=1e-5)
B, K, N = 3, 6, 10


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def _windows(seed):
    """Model outputs and labels for B windows, in the Batch schema."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    alpha = rng.normal(0, 0.1, size=(B, K, 1)).astype(f32)
    beta = rng.normal(1, 0.3, size=(B, K, 1)).astype(f32)
    y = rng.normal(0.1, 0.5, size=(B, K, N, 4)).astype(f32)
    factor = np.stack([rng.normal(size=B), rng.uniform(0.5, 2, size=B)],
                      axis=-1).astype(f32)
    inv_psi = rng.uniform(1, 2, size=(B, K)).astype(f32)
    return alpha, beta, y, factor, inv_psi


@pytest.mark.parametrize("batched", [False, True])
def test_ols_matches_jax(batched):
    rng = np.random.default_rng(1)
    shape = (4,) if batched else ()
    x = rng.normal(size=shape + (N,)).astype(np.float32)
    y = (0.3 + 1.7 * x[..., None, :]
         + rng.normal(0, 0.1, size=shape + (K, N))).astype(np.float32)
    got = ols(torch.from_numpy(x), torch.from_numpy(y))
    want = jax_ols(jnp.asarray(x), jnp.asarray(y))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g, w)


def test_inverse_returns_covariance_matches_jax():
    rng = np.random.default_rng(2)
    beta = rng.normal(1, 0.3, size=(K, 1)).astype(np.float32)
    inv_psi = np.diag(rng.uniform(1, 2, size=K)).astype(np.float32)
    got = inverse_returns_covariance(torch.from_numpy(beta),
                                     torch.from_numpy(inv_psi),
                                     torch.tensor(0.7))
    _close(got, jax_inv_cov(jnp.asarray(beta), jnp.asarray(inv_psi),
                            jnp.float32(0.7)))


def test_ols_features_matches_jax():
    rng = np.random.default_rng(3)
    market = rng.normal(size=(4, 1, N, 1))
    stocks = 0.1 + 1.3 * market + rng.normal(0, 0.2, size=(4, K, N, 1))
    target = np.concatenate([stocks, np.broadcast_to(market, stocks.shape)],
                            axis=-1).astype(np.float32)
    got = ols_features(torch.from_numpy(target))
    want = jax_ols_features(jnp.asarray(target))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g, w)


def test_losses_match_jax():
    alpha, beta, y, factor, inv_psi = _windows(4)
    mean = alpha + beta * factor[:, 0, None, None]
    got = single_factor_gaussian_nll(*(torch.from_numpy(a) for a in (
        mean, beta, inv_psi, factor[:, 1], y[..., 0])))
    for b in range(B):
        _close(got[b], jax_sf_nll(mean[b], beta[b], inv_psi[b], factor[b, 1],
                                  y[b, :, :, 0]))
    _close(mean_squared_error(torch.from_numpy(y[..., 0]),
                              torch.from_numpy(y[..., 1])),
           jax_mean_squared_error(y[..., 0], y[..., 1]))
    bad = inv_psi.copy()
    bad[0, 0] = -1.0
    nan = single_factor_gaussian_nll(*(torch.from_numpy(a) for a in (
        mean, beta, bad, factor[:, 1], y[..., 0])))
    assert torch.isnan(nan[0]) and torch.isfinite(nan[1:]).all()


PAIRS = {
    "mse": (obj.mse_window, jax_mse),
    "nll": (obj.nll_window, jax_nll),
    "combined": (obj.make_combined_window(1e2), jax_combined(1e2)),
}


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_window_objectives_and_grads_match_jax(name):
    """Per-window losses and metric sums against jax.vmap of the JAX
    window function, and d(mean loss)/d(alpha, beta) against jax.grad."""
    port_fn, jax_fn = PAIRS[name]
    arrays = _windows(5)
    losses, metrics = port_fn(*(torch.from_numpy(a) for a in arrays))
    want_losses, want_metrics = jax.vmap(jax_fn)(*map(jnp.asarray, arrays))
    _close(losses, want_losses)
    assert set(metrics) == set(want_metrics)
    for k, (v, w) in metrics.items():
        _close(v, want_metrics[k][0])
        _close(w, want_metrics[k][1])

    alpha, beta = (torch.from_numpy(a).requires_grad_(True) for a in arrays[:2])
    loss, _ = obj.batched_objective(port_fn)(
        alpha, beta, *(torch.from_numpy(a) for a in arrays[2:]))
    loss.backward()
    want = jax.grad(
        lambda a, b: jax_batched(jax_fn)(a, b, *map(jnp.asarray, arrays[2:]))[0],
        argnums=(0, 1),
    )(jnp.asarray(arrays[0]), jnp.asarray(arrays[1]))
    _close(alpha.grad, want[0])
    _close(beta.grad, want[1])


@pytest.mark.parametrize("weighted", [False, True])
def test_batched_objective_matches_jax(weighted):
    """The batch lifting with and without ``weights``; a zero-weight window
    contributes nothing to the loss, its gradient or the sums."""
    arrays = _windows(6)
    weights = np.array([1.0, 0.0, 1.0], np.float32) if weighted else None
    fn = obj.batched_objective(obj.make_combined_window(1e2))
    alpha = torch.from_numpy(arrays[0]).requires_grad_(True)
    kw = {} if weights is None else {"weights": torch.from_numpy(weights)}
    loss, sums = fn(alpha, *(torch.from_numpy(a) for a in arrays[1:]), **kw)
    jkw = {} if weights is None else {"weights": jnp.asarray(weights)}
    want_loss, want_sums = jax_batched(jax_combined(1e2))(
        *map(jnp.asarray, arrays), **jkw)
    _close(loss.detach(), want_loss)
    assert set(sums) == set(want_sums) == {"mse", "nll", "total"}
    for k, (v, w) in sums.items():
        _close(v.detach(), want_sums[k][0])
        _close(w, want_sums[k][1])
    loss.backward()
    if weighted:
        assert float(alpha.grad[1].abs().max()) == 0.0
    assert float(alpha.grad[0].abs().max()) > 0.0


def test_spec_objectives_and_metric_keys():
    for name, keys in (("mse", ("mse",)), ("nll", ("nll",)),
                       ("combined", ("mse", "nll"))):
        spec = obj.ModelSpec(objective=name)
        assert spec.metric_keys == keys
        _, metrics = spec.window_objective()(
            *(torch.from_numpy(a) for a in _windows(7)))
        assert set(metrics) == set(keys)
    with pytest.raises(ValueError, match="unknown objective"):
        obj.ModelSpec(objective="nope").window_objective()
    # Two loadings read the factor channels y[..., 1:3] (the K-factor
    # branch; tests/test_torch_kfactor.py holds it against the JAX package).
    alpha, beta, y, factor, inv_psi = (torch.from_numpy(a) for a in _windows(8))
    beta2 = beta.repeat(1, 1, 2)
    loss, _ = obj.mse_window(alpha, beta2, y, factor, inv_psi)
    pred = alpha + beta2[..., :1] * y[..., 1] + beta2[..., 1:] * y[..., 2]
    torch.testing.assert_close(
        loss, torch.square(pred - y[..., 0]).mean(dim=(-2, -1)))
