"""Windowed-dataset construction: lookback/target splitting and feature maps.

Counterpart of ``masters_thesis_tpu/ops/windows.py``. Windows are gathered
with precomputed start indices, op for op as in the JAX functions, so the
results are equal to theirs bit for bit. ``ols_features`` takes the scalar
market series (F=1); its multi-factor branch is not ported yet.
"""

from __future__ import annotations

import torch

from masters_thesis_tpu_torch.ops.linalg import ols


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

    Args:
        target: ``(n_windows, n_stocks, target_window, 2)`` with channels
            ``[r_stock, r_market]``.

    Returns:
        ``alphas``, ``betas`` ``(n_windows, n_stocks)``, ``factor``
        ``(n_windows, 2)`` = (market mean, market var) and ``inv_psi``
        ``(n_windows, n_stocks)`` = 1 / var(residuals).
    """
    if target.shape[-1] != 2:
        raise NotImplementedError(
            "ols_features takes one market channel; the multi-factor branch "
            "(ols_k) is not ported"
        )
    r_stocks = target[:, :, :, 0]
    r_market = target[:, 0, :, 1]  # market identical across stocks
    alphas, betas = ols(r_market, r_stocks)
    r_pred = alphas[..., None] + betas[..., None] * r_market[:, None, :]
    residuals = r_stocks - r_pred
    factor = torch.stack(
        [r_market.mean(dim=-1), r_market.var(dim=-1, correction=1)], dim=-1
    )
    inv_psi = 1.0 / residuals.var(dim=-1, correction=1)
    return alphas, betas, factor, inv_psi
