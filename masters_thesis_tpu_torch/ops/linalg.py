"""Batched linear algebra of the single-factor model.

Counterpart of ``ols`` and ``inverse_returns_covariance`` in
``masters_thesis_tpu/ops/linalg.py``. The JAX functions pin these small,
accuracy-sensitive contractions to full f32 (``precision="highest"``); the
port's ``torch.matmul`` is full f32 as long as TF32 stays off, which the
port never turns on. The multi-factor ``ols_k`` is not ported yet.
"""

from __future__ import annotations

import torch


def ols(x: torch.Tensor, y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Least-squares intercept + slope of ``y`` on ``x``, batched.

    Solves ``y ≈ alpha + beta * x`` per stock via the normal equations with a
    pseudo-inverse (robust to a constant regressor).

    Args:
        x: regressor series, ``(n_samples,)`` or ``(batch, n_samples)``.
        y: regressand series, ``(n_stocks, n_samples)`` or
            ``(batch, n_stocks, n_samples)``.

    Returns:
        ``(alphas, betas)``, each ``(n_stocks,)`` / ``(batch, n_stocks)``;
        size-1 dims are squeezed in the unbatched path, as in the JAX
        function.
    """
    if x.ndim <= 2 and y.ndim <= 2:
        alphas, betas = _batched_ols(x[None, ...], y[None, ...])
        return alphas.squeeze(), betas.squeeze()
    return _batched_ols(x, y)


def _batched_ols(x: torch.Tensor, y: torch.Tensor):
    """``(XᵀX)⁺ Xᵀ yᵀ`` with an intercept column; x (batch, n), y (batch, k, n)."""
    design = torch.stack([torch.ones_like(x), x], dim=-1)  # (batch, n, 2)
    gram = design.mT @ design  # (batch, 2, 2)
    moment = design.mT @ y.mT  # (batch, 2, k)
    coef = torch.linalg.pinv(gram) @ moment
    return coef[:, 0, :], coef[:, 1, :]


def inverse_returns_covariance(
    beta: torch.Tensor, inv_psi: torch.Tensor, f_var: torch.Tensor
) -> torch.Tensor:
    """Inverse of ``Sigma = f_var * beta betaᵀ + Psi`` by Woodbury:
    ``Psi⁻¹ − (Psi⁻¹ beta betaᵀ Psi⁻¹) / (1/f_var + betaᵀ Psi⁻¹ beta)``.

    Args:
        beta: ``(n_stocks, 1)`` factor loadings.
        inv_psi: ``(n_stocks, n_stocks)`` diagonal inverse idiosyncratic cov.
        f_var: scalar factor variance.

    Returns:
        ``(n_stocks, n_stocks)`` inverse covariance.
    """
    inv_psi_beta = inv_psi @ beta  # (K, 1)
    beta_t_inv_psi = beta.T @ inv_psi  # (1, K)
    denominator = 1.0 / f_var + beta_t_inv_psi @ beta  # (1, 1)
    return inv_psi - (inv_psi_beta @ beta_t_inv_psi) / denominator
