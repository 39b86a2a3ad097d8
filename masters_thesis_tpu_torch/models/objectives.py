"""Window objectives, their batch lifting, and the model specs.

Counterpart of ``masters_thesis_tpu/models/objectives.py``: MSE, the
single-factor Gaussian NLL (Woodbury form) and the combined
``NLL + mse_weight * MSE``. Each objective maps one or many windows' model
outputs and labels to a loss and metric sums; the JAX package lifts the
per-window function with ``vmap``, the port writes the batch axis out: every
function takes any leading batch dims and returns one value per window.

Batch window schema (``data/pipeline.py`` ``Batch``): ``y``
``(..., K, T, 4)`` channels ``[r_stock, r_market, alpha, beta]``; ``factor``
``(..., 2)`` = (market mean, market var); ``inv_psi`` ``(..., K)``. The
K-factor branches (F > 1 loadings) are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from masters_thesis_tpu_torch.ops.losses import (
    mean_squared_error,
    single_factor_gaussian_nll,
)

# (loss (...,), metric sums {name: (value (...,), weight (...,))}) for a
# batch of windows: the (value_sum, weight) pairs of torchmetrics' sum states.
WindowObjective = Callable[..., tuple[torch.Tensor, dict]]


def _single_factor(beta: torch.Tensor) -> None:
    if beta.shape[-1] != 1:
        raise NotImplementedError(
            f"{beta.shape[-1]} factor loadings: the K-factor objectives are "
            "not ported"
        )


def _predicted_returns(alpha, beta, y):
    _single_factor(beta)
    return alpha + beta * y[..., 1]  # (..., K, 1) broadcast over (..., K, T)


def mse_window(alpha, beta, y, factor, inv_psi):
    """MSE of ``alpha + beta · r_market`` against realized returns over each
    target window."""
    r_target = y[..., 0]
    loss = mean_squared_error(_predicted_returns(alpha, beta, y), r_target,
                              dim=(-2, -1))
    n = torch.full_like(loss, float(r_target.shape[-2] * r_target.shape[-1]))
    return loss, {"mse": (loss * n, n)}


def nll_window(alpha, beta, y, factor, inv_psi):
    """Multivariate-Gaussian NLL with the single-factor Woodbury inverse
    covariance, in the fused O(K·n) form."""
    _single_factor(beta)
    f_mean, f_var = factor[..., 0], factor[..., 1]
    r_mean = alpha + beta * f_mean[..., None, None]  # (..., K, 1)
    loss = single_factor_gaussian_nll(r_mean, beta, inv_psi, f_var, y[..., 0])
    return loss, {"nll": (loss, torch.ones_like(loss))}


def make_combined_window(mse_weight: float) -> WindowObjective:
    """``NLL + mse_weight * MSE``."""

    def combined_window(alpha, beta, y, factor, inv_psi):
        mse_loss, mse_metrics = mse_window(alpha, beta, y, factor, inv_psi)
        nll_loss, nll_metrics = nll_window(alpha, beta, y, factor, inv_psi)
        return nll_loss + mse_weight * mse_loss, {**mse_metrics, **nll_metrics}

    return combined_window


def batched_objective(window_fn: WindowObjective):
    """Lift a window objective over a batch: ``fn(alpha (B,K,1), beta
    (B,K,1), y, factor, inv_psi, weights=None) -> (mean loss, metric sums)``.

    The metric sums aggregate over the batch and include ``"total"``, the
    objective itself. ``weights`` ``(B,)`` turns the mean into a weighted
    mean; a zero-weight window adds nothing to the loss, its gradient or the
    sums (its data must be finite: ``0 * nan`` is nan).
    """

    def fn(alpha, beta, y, factor, inv_psi, weights=None):
        losses, metrics = window_fn(alpha, beta, y, factor, inv_psi)
        if weights is None:
            loss = losses.mean()
            summed = {k: (v.sum(), w.sum()) for k, (v, w) in metrics.items()}
            # A fill on the device: a host scalar copied in would
            # synchronise the stream every step.
            summed["total"] = (losses.sum(),
                               losses.new_full((), float(losses.shape[0])))
        else:
            wsum = torch.clamp(weights.sum(), min=1.0)
            loss = (weights * losses).sum() / wsum
            summed = {k: ((weights * v).sum(), (weights * w).sum())
                      for k, (v, w) in metrics.items()}
            summed["total"] = ((weights * losses).sum(), wsum)
        return loss, summed

    return fn


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Hyperparameter bundle for one configured model + objective."""

    objective: str  # 'mse' | 'nll' | 'combined'
    input_size: int = 3
    hidden_size: int = 64
    num_layers: int = 2
    dropout: float = 0.2
    n_factors: int = 1  # loadings per row (beta head width)
    learning_rate: float = 1e-4
    weight_decay: float = 1e-5
    mse_weight: float = 1e2
    remat: bool = False  # recompute recurrences in the backward (memory)

    def build_module(self, device=None, generator: torch.Generator | None = None):
        from masters_thesis_tpu_torch.models.lstm import LstmEncoder

        return LstmEncoder(
            input_size=self.input_size,
            hidden_size=self.hidden_size,
            num_layers=self.num_layers,
            dropout=self.dropout,
            n_factors=self.n_factors,
            device=device,
            generator=generator,
            remat=self.remat,
        )

    @property
    def metric_keys(self) -> tuple:
        """Per-objective logged metric names."""
        return {
            "mse": ("mse",),
            "nll": ("nll",),
            "combined": ("mse", "nll"),
        }[self.objective]

    def window_objective(self) -> WindowObjective:
        if self.objective == "mse":
            return mse_window
        if self.objective == "nll":
            return nll_window
        if self.objective == "combined":
            return make_combined_window(self.mse_weight)
        raise ValueError(f"unknown objective: {self.objective}")


# The reference's CLI class names.
MODEL_REGISTRY: dict[str, str] = {
    "FinancialLstmMse": "mse",
    "FinancialLstmNll": "nll",
    "FinancialLstmCombined": "combined",
}


def get_model_spec(module_class_name: str, **hparams) -> ModelSpec:
    """Map a reference-style class name to a configured ModelSpec."""
    if module_class_name not in MODEL_REGISTRY:
        raise ValueError(
            f"Unknown module class: {module_class_name}. "
            f"Available: {list(MODEL_REGISTRY.keys())}"
        )
    return ModelSpec(objective=MODEL_REGISTRY[module_class_name], **hparams)
