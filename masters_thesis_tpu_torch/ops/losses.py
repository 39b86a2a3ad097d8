"""Differentiable loss cores as plain functions.

Counterpart of ``single_factor_gaussian_nll``, ``kfactor_gaussian_nll`` and
``mean_squared_error`` in ``masters_thesis_tpu/ops/losses.py``. Where the JAX
functions take one window and are lifted with ``vmap``, these take any
leading batch dims (the batch axis written out).

The rank-F NLL needs ``slogdet``, ``inv`` and ``solve`` of F×F matrices
inside the training step's CUDA graph. ``torch.linalg``'s CUDA paths read
their ``info`` on the host, a synchronisation a capture refuses, so the
port factors the F×F matrices itself: LU with partial pivoting (LAPACK's
``getrf``, which the JAX package's CPU and TPU paths run, with its pivot
rule, ties to the first row) unrolled into elementwise tensor ops over the
batch (F is static and small: 3 in ``model=kfactor``). Autograd goes
through the same ops.
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


def _lu(a: torch.Tensor):
    """LU with partial pivoting of ``a`` ``(..., F, F)``, unrolled.

    Returns ``(m, sign, swaps)``: ``m[i][j]`` the packed factors as
    ``(...)`` tensors (unit-lower L below the diagonal, U on and above it),
    ``sign`` the permutation's parity (±1), and ``swaps`` the row exchanges
    ``(k, i, take)`` in the order they were made (``take`` a ``(...)``
    bool: rows k and i swapped). At column k row k is swapped with each
    later row whose entry is larger in magnitude, in turn, which leaves the
    first largest entry on the diagonal, as ``getrf`` does.
    """
    n = a.shape[-1]
    m = [[a[..., i, j] for j in range(n)] for i in range(n)]
    sign = torch.ones_like(m[0][0])
    swaps = []
    for k in range(n):
        for i in range(k + 1, n):
            take = m[i][k].abs() > m[k][k].abs()
            m[k], m[i] = ([torch.where(take, x, y) for x, y in zip(m[i], m[k])],
                          [torch.where(take, y, x) for x, y in zip(m[i], m[k])])
            sign = torch.where(take, -sign, sign)
            swaps.append((k, i, take))
        for i in range(k + 1, n):
            m[i][k] = m[i][k] / m[k][k]
            for j in range(k + 1, n):
                m[i][j] = m[i][j] - m[i][k] * m[k][j]
    return m, sign, swaps


def _slogdet(lu) -> tuple[torch.Tensor, torch.Tensor]:
    """``(sign, log|det|)`` from ``_lu``'s factors: 0 and -inf where a
    pivot is 0, as ``slogdet`` gives for a singular matrix."""
    m, sign, _ = lu
    logdet = torch.zeros_like(sign)
    for k in range(len(m)):
        sign = sign * torch.sign(m[k][k])
        logdet = logdet + torch.log(torch.abs(m[k][k]))
    return sign, logdet


def _solve(lu, b: torch.Tensor) -> torch.Tensor:
    """``a⁻¹ b`` for ``b`` ``(..., F, n)`` from ``_lu(a)``: the row swaps,
    then forward and back substitution."""
    m, _, swaps = lu
    n = len(m)
    rows = [b[..., i, :] for i in range(n)]
    for k, i, take in swaps:
        t = take[..., None]
        rows[k], rows[i] = (torch.where(t, rows[i], rows[k]),
                            torch.where(t, rows[k], rows[i]))
    for i in range(n):
        for k in range(i):
            rows[i] = rows[i] - m[i][k][..., None] * rows[k]
    for i in reversed(range(n)):
        for j in range(i + 1, n):
            rows[i] = rows[i] - m[i][j][..., None] * rows[j]
        rows[i] = rows[i] / m[i][i][..., None]
    return torch.stack(rows, dim=-2)


def kfactor_gaussian_nll(
    mean: torch.Tensor,
    beta: torch.Tensor,
    inv_psi: torch.Tensor,
    f_cov: torch.Tensor,
    target: torch.Tensor,
) -> torch.Tensor:
    """Gaussian NLL under ``Σ = B F Bᵀ + diag(1/inv_psi)``, rank-F Woodbury.

    With the capacitance ``C = F⁻¹ + BᵀΨ⁻¹B`` (F×F), the determinant lemma
    gives ``logdet Σ⁻¹ = Σ log inv_psi − logdet F − logdet C`` and Woodbury
    ``dᵀΣ⁻¹d = dᵀΨ⁻¹d − (BᵀΨ⁻¹d)ᵀ C⁻¹ (BᵀΨ⁻¹d)``: O(K·n·F + F³). NaN where
    ``min(inv_psi) ≤ 0`` or the sign of ``det F`` or ``det C`` is not
    positive (the JAX function's rule).

    Args:
        mean: ``(..., K, 1)`` predicted mean per stock.
        beta: ``(..., K, F)`` factor loadings.
        inv_psi: ``(..., K)`` inverse idiosyncratic variances.
        f_cov: ``(..., F, F)`` factor covariance.
        target: ``(..., K, n)`` observed returns, one column per day.

    Returns:
        ``(...)`` NLL, summed over the n columns.
    """
    k, n = target.shape[-2:]
    n_f = beta.shape[-1]
    diff = target - mean  # (..., K, n)
    b_ip = beta * inv_psi[..., None]  # Ψ⁻¹B, (..., K, F)
    btipb = beta.mT @ b_ip  # BᵀΨ⁻¹B, (..., F, F)
    lu_f = _lu(f_cov)
    sign_f, logdet_f = _slogdet(lu_f)
    eye = torch.eye(n_f, dtype=f_cov.dtype, device=f_cov.device)
    cap = _solve(lu_f, eye.expand(f_cov.shape)) + btipb  # C, (..., F, F)
    lu_c = _lu(cap)
    sign_c, logdet_c = _slogdet(lu_c)
    proj = b_ip.mT @ diff  # BᵀΨ⁻¹d, (..., F, n)
    solve = _solve(lu_c, proj)  # C⁻¹ BᵀΨ⁻¹d
    quadratic = (
        torch.sum(inv_psi[..., None] * torch.square(diff), dim=(-2, -1))
        - torch.sum(proj * solve, dim=(-2, -1))
    )
    log_det = torch.sum(torch.log(inv_psi), dim=-1) - logdet_f - logdet_c
    valid = (torch.amin(inv_psi, dim=-1) > 0) & (sign_f > 0) & (sign_c > 0)
    log_det = torch.where(valid, log_det, torch.nan)
    return 0.5 * (n * (k * LOG_2PI - log_det) + quadratic)


def mean_squared_error(pred: torch.Tensor, target: torch.Tensor,
                       dim=None) -> torch.Tensor:
    """Plain MSE over all elements, or over ``dim`` (the last two axes of a
    window batch give one value per window)."""
    sq = torch.square(pred - target)
    return sq.mean() if dim is None else sq.mean(dim=dim)
