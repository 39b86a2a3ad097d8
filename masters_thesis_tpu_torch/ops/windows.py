"""Windowed-dataset construction: lookback/target splitting and feature maps.

Counterpart of ``masters_thesis_tpu/ops/windows.py``. Windows are gathered
with precomputed start indices, op for op as in the JAX functions, so the
results are equal to theirs bit for bit. ``ols_features`` fits the scalar
market model at F=1 and the multi-factor regression (``ols_k``) above it.
"""

from __future__ import annotations

import torch

from masters_thesis_tpu_torch.ops.linalg import ols, ols_k


def lookback_target_split(
    r_stocks: torch.Tensor,
    r_market: torch.Tensor,
    lookback_window: int,
    target_window: int,
    stride: int | None = None,
    prediction: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Slice return series into strided (lookback, target) window pairs.

    Args:
        r_stocks: ``(n_stocks, n_samples)`` stock return series.
        r_market: ``(n_samples,)`` market return series (broadcast to
            stocks), or ``(n_factors, n_samples)`` factor series (each factor
            becomes one channel).
        lookback_window: encoder context length.
        target_window: supervision horizon length.
        stride: window start spacing; defaults to ``lookback + target``.
        prediction: if True, the target is the ``target_window`` steps after
            the lookback; if False (reconstruction), the trailing
            ``target_window`` steps inside it.

    Returns:
        ``X``: ``(n_windows, n_stocks, lookback_window, 1+n_factors)`` and
        ``y``: ``(n_windows, n_stocks, target_window or lookback_window,
        1+n_factors)`` with channels ``[r_stock, f_1 .. f_F]``.
    """
    if stride is None:
        stride = lookback_window + target_window
    if not prediction and target_window > lookback_window:
        raise ValueError(
            f"reconstruction task requires target_window ({target_window}) <= "
            f"lookback_window ({lookback_window})"
        )
    total_window = lookback_window + target_window if prediction else lookback_window

    if r_market.ndim == 1:
        stacked = torch.stack(torch.broadcast_tensors(r_stocks, r_market), dim=-1)
    else:
        factors = r_market.T[None, :, :].expand(
            (r_stocks.shape[0],) + tuple(r_market.T.shape)
        )
        stacked = torch.cat([r_stocks[..., None], factors], dim=-1)
    n_samples = stacked.shape[1]
    n_windows = (n_samples - total_window) // stride + 1
    if n_windows < 1:
        raise ValueError(
            f"series of length {n_samples} is shorter than one window "
            f"({total_window} steps); no windows can be formed"
        )

    starts = torch.arange(n_windows, device=stacked.device) * stride
    gather = starts[:, None] + torch.arange(total_window, device=stacked.device)[None, :]
    windowed = stacked[:, gather, :].permute(1, 0, 2, 3)  # (n_win, n_stocks, tw, C)

    if prediction:
        x = windowed[:, :, :lookback_window, :]
        y = windowed[:, :, lookback_window:, :]
    else:
        x = windowed
        y = windowed[:, :, lookback_window - target_window:, :]
    return x, y


def add_quadratic_features(
    x: torch.Tensor, interaction_only: bool = False, include_bias: bool = False
) -> torch.Tensor:
    """Expand the ``1+F``-channel window into polynomial features.

    ``[r_stock, f_1..f_F, r_stock*f_1 .. r_stock*f_F]``, plus the squares
    (``r_stock², f_1² .. f_F²``) when not ``interaction_only``, plus an
    optional all-ones bias channel: ``2F+1`` or ``3F+2`` features (+1).
    """
    r_stock = x[..., 0]
    factors = [x[..., 1 + i] for i in range(x.shape[-1] - 1)]
    features = [r_stock, *factors, *[r_stock * f for f in factors]]
    if not interaction_only:
        features.extend([r_stock * r_stock, *[f * f for f in factors]])
    if include_bias:
        features.append(torch.ones_like(r_stock))
    return torch.stack(features, dim=-1)


def ols_features(target: torch.Tensor):
    """Per-window OLS supervision features from the target window.

    Fits ``r_stock ≈ alpha + beta * r_market`` on each target window, then
    summarizes the factor (mean and unbiased variance of the market returns)
    and the inverse idiosyncratic variance of the fit residuals (unbiased).
    With ``F > 1`` factor channels the fit is ``r_stock ≈ alpha + Σ_f
    beta_f * f`` and the factor summary the mean vector and the flattened
    (ddof=1) covariance; the F=1 branch is the scalar code, op for op.

    Args:
        target: ``(n_windows, n_stocks, target_window, 1+F)`` with channels
            ``[r_stock, f_1 .. f_F]``.

    Returns:
        ``alphas`` ``(n_windows, n_stocks)``, ``betas`` ``(n_windows,
        n_stocks)`` at F=1 else ``(n_windows, n_stocks, F)``, ``factor``
        ``(n_windows, 2)`` = (market mean, market var) at F=1 else
        ``(n_windows, F + F²)`` = ``[f_mean | f_cov.ravel()]``, and
        ``inv_psi`` ``(n_windows, n_stocks)`` = 1 / var(residuals).
    """
    n_f = target.shape[-1] - 1
    r_stocks = target[:, :, :, 0]
    if n_f == 1:
        r_market = target[:, 0, :, 1]  # market identical across stocks
        alphas, betas = ols(r_market, r_stocks)
        r_pred = alphas[..., None] + betas[..., None] * r_market[:, None, :]
        residuals = r_stocks - r_pred
        factor = torch.stack(
            [r_market.mean(dim=-1), r_market.var(dim=-1, correction=1)], dim=-1
        )
        inv_psi = 1.0 / residuals.var(dim=-1, correction=1)
        return alphas, betas, factor, inv_psi

    f = target[:, 0, :, 1:]  # (n_win, tw, F), identical across stocks
    alphas, betas = ols_k(f, r_stocks)  # (n_win, k), (n_win, k, F)
    r_pred = alphas[..., None] + torch.einsum("wkf,wtf->wkt", betas, f)
    residuals = r_stocks - r_pred
    f_mean = f.mean(dim=1)  # (n_win, F)
    centered = f - f_mean[:, None, :]
    f_cov = torch.einsum("wtf,wtg->wfg", centered, centered) / (f.shape[1] - 1)
    factor = torch.cat([f_mean, f_cov.reshape(f_cov.shape[0], -1)], dim=-1)
    inv_psi = 1.0 / residuals.var(dim=-1, correction=1)
    return alphas, betas, factor, inv_psi
