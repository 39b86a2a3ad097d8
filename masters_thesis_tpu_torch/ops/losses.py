"""Differentiable loss cores as plain functions.

Counterpart of ``single_factor_gaussian_nll`` and ``mean_squared_error`` in
``masters_thesis_tpu/ops/losses.py``. Where the JAX functions take one
window and are lifted with ``vmap``, these take any leading batch dims
(the batch axis written out). The rank-F ``kfactor_gaussian_nll`` is not
ported yet.
"""

from __future__ import annotations

import math

import torch

LOG_2PI = math.log(2.0 * math.pi)


def single_factor_gaussian_nll(
    mean: torch.Tensor,
    beta: torch.Tensor,
    inv_psi: torch.Tensor,
    f_var: torch.Tensor,
    target: torch.Tensor,
) -> torch.Tensor:
    """Gaussian NLL under ``Σ = f_var·β βᵀ + diag(1/inv_psi)``, in O(K·n).

    The matrix determinant lemma gives
    ``logdet Σ⁻¹ = Σ log inv_psi − log1p(f_var · βᵀΨ⁻¹β)`` and the rank-1
    Woodbury form ``dᵀΣ⁻¹d = dᵀΨ⁻¹d − (βᵀΨ⁻¹d)² / (1/f_var + βᵀΨ⁻¹β)``.
    Non-PSD inputs (``inv_psi ≤ 0`` or a non-positive denominator) give NaN.

    Args:
        mean: ``(..., K, 1)`` predicted mean per stock.
        beta: ``(..., K, 1)`` factor loadings.
        inv_psi: ``(..., K)`` inverse idiosyncratic variances.
        f_var: ``(...)`` factor variance.
        target: ``(..., K, n)`` observed returns, one column per day.

    Returns:
        ``(...)`` NLL, summed over the n columns.
    """
    k, n = target.shape[-2:]
    diff = target - mean  # (..., K, n)
    b = beta[..., 0]
    b_ip = b * inv_psi  # βᵀΨ⁻¹, (..., K)
    bt_ip_b = torch.sum(b * b_ip, dim=-1)
    denom = 1.0 / f_var + bt_ip_b
    proj = (b_ip[..., None, :] @ diff)[..., 0, :]  # (..., n)
    quadratic = (
        torch.sum(inv_psi[..., None] * torch.square(diff), dim=(-2, -1))
        - torch.sum(torch.square(proj), dim=-1) / denom
    )
    log_det = torch.sum(torch.log(inv_psi), dim=-1) - torch.log1p(f_var * bt_ip_b)
    valid = (torch.amin(inv_psi, dim=-1) > 0) & (denom > 0)
    log_det = torch.where(valid, log_det, torch.nan)
    return 0.5 * (n * (k * LOG_2PI - log_det) + quadratic)


def mean_squared_error(pred: torch.Tensor, target: torch.Tensor,
                       dim=None) -> torch.Tensor:
    """Plain MSE over all elements, or over ``dim`` (the last two axes of a
    window batch give one value per window)."""
    sq = torch.square(pred - target)
    return sq.mean() if dim is None else sq.mean(dim=dim)
