"""Test-split result collection: model against OLS against ground truth, and
the thesis's ΔL table.

Counterpart of ``masters_thesis_tpu/evaluation.py``, with the same results:
for every test window the model's (alpha, beta), the analytical OLS fit on
the same lookback window, the ground-truth coefficients and the residuals
(``collect_test_results``); and the losses above the target-window OLS
baseline (``delta_losses``). The JAX package evaluates fixed chunks of
``CHUNK`` windows, zero-padding the tail so that one XLA program serves
every chunk; PyTorch runs eagerly, so here each chunk is a batch of tensors
on the encoder's device and the tail chunk is simply shorter.
"""

from __future__ import annotations

from typing import Callable, Mapping

import numpy as np
import torch

from masters_thesis_tpu_torch.data.pipeline import FinancialWindowDataModule
from masters_thesis_tpu_torch.models.objectives import ModelSpec, mse_window, nll_window
from masters_thesis_tpu_torch.ops.linalg import ols
from masters_thesis_tpu_torch.train.steps import forward_rows

CHUNK = 64


def _test_split(dm: FinancialWindowDataModule):
    if dm.test_range is None:
        dm.setup("test")
    return dm.test_arrays()


def _encoder(spec: ModelSpec, state: Mapping[str, torch.Tensor], device):
    module = spec.build_module(device=device)
    module.load_state_dict(state)
    module.eval()
    return module


def _eval_in_chunks(arrays: dict, device, fn: Callable[[dict], dict]) -> dict:
    """``fn`` over chunks of ``CHUNK`` windows of ``arrays`` (numpy, leading
    axis the windows) moved to ``device``; its nested dict of per-window
    tensors concatenated into numpy arrays."""
    n = len(next(iter(arrays.values())))
    if n == 0:
        raise ValueError("empty split: nothing to evaluate")
    chunks = []
    with torch.inference_mode():
        for start in range(0, n, CHUNK):
            piece = {k: torch.as_tensor(np.asarray(a[start:start + CHUNK],
                                                   np.float32)).to(device)
                     for k, a in arrays.items()}
            chunks.append(fn(piece))

    def gather(parts):
        if isinstance(parts[0], dict):
            return {k: gather([p[k] for p in parts]) for k in parts[0]}
        return np.concatenate([p.cpu().numpy() for p in parts])

    return gather(chunks)


def _model_and_history_ols(module, x):
    """The model's and the lookback-window OLS's (alpha, beta), each (C, K):
    OLS regresses each stock's return (feature 0) on the market return
    (feature 1, the same for every stock)."""
    alpha_m, beta_m = forward_rows(module, x)
    alpha_o, beta_o = ols(x[:, 0, :, 1], x[:, :, :, 0])
    return alpha_m[..., 0], beta_m[..., 0], alpha_o, beta_o


def collect_test_results(spec: ModelSpec, state: Mapping[str, torch.Tensor],
                         dm: FinancialWindowDataModule, device=None) -> dict:
    """Evaluate the test split with the encoder's ``state``; numpy arrays
    shaped (n_windows, K), under the JAX function's keys:
    ``recon_residuals`` (averaged over the target window), ``alpha_residuals``
    and ``beta_residuals`` (each ``model``/``ols``), and ``alpha``/``beta``
    (``model``/``ols``/``true``)."""
    arrays = _test_split(dm)
    module = _encoder(spec, state, device)

    def chunk(t):
        x, y = t["x"], t["y"]
        alpha_m, beta_m, alpha_o, beta_o = _model_and_history_ols(module, x)
        r_target, r_market = y[..., 0], y[..., 1]  # (C, K, T)
        alpha_t, beta_t = y[:, :, 0, 2], y[:, :, 0, 3]
        r_pred_m = alpha_m[..., None] + beta_m[..., None] * r_market
        r_pred_o = alpha_o[..., None] + beta_o[..., None] * r_market
        return {
            "recon_residuals": {
                "model": torch.mean(r_target - r_pred_m, dim=-1),
                "ols": torch.mean(r_target - r_pred_o, dim=-1),
            },
            "alpha_residuals": {"model": alpha_t - alpha_m, "ols": alpha_t - alpha_o},
            "beta_residuals": {"model": beta_t - beta_m, "ols": beta_t - beta_o},
            "alpha": {"model": alpha_m, "ols": alpha_o, "true": alpha_t},
            "beta": {"model": beta_m, "ols": beta_o, "true": beta_t},
        }

    return _eval_in_chunks({"x": arrays.x, "y": arrays.y}, module.w_hh_l0.device,
                           chunk)


def delta_losses(spec: ModelSpec, state: Mapping[str, torch.Tensor],
                 dm: FinancialWindowDataModule, zeta: float = 1e5,
                 estimates: dict | None = None, device=None) -> dict:
    """The thesis's headline metrics: the test split's mean MSE and NLL of
    the model's and of the lookback-window OLS's estimates above those of
    the target-window OLS (the baseline), and ΔL_MIX = ΔL_NLL + ζ·ΔL_MSE.

    ``estimates``: the dict of :func:`collect_test_results`, whose model and
    historical-OLS coefficients are then reused instead of recomputed.

    Returns ``{"model": {"delta_mse", "delta_nll", "delta_mix"}, "ols":
    {...}, "baseline": {"mse", "nll"}, "zeta": zeta}``, as the JAX function.
    """
    arrays = _test_split(dm)
    module = _encoder(spec, state, device)
    tree = {"y": arrays.y, "factor": arrays.factor, "inv_psi": arrays.inv_psi}
    if estimates is None:
        tree["x"] = arrays.x
    else:
        tree.update({
            "alpha_m": estimates["alpha"]["model"],
            "beta_m": estimates["beta"]["model"],
            "alpha_h": estimates["alpha"]["ols"],
            "beta_h": estimates["beta"]["ols"],
        })

    def chunk(t):
        y, factor, inv_psi = t["y"], t["factor"], t["inv_psi"]
        if estimates is None:
            alpha_m, beta_m, alpha_h, beta_h = _model_and_history_ols(module, t["x"])
        else:
            alpha_m, beta_m = t["alpha_m"], t["beta_m"]
            alpha_h, beta_h = t["alpha_h"], t["beta_h"]
        # The ΔL baseline: OLS on the target window itself.
        alpha_t, beta_t = ols(y[:, 0, :, 1], y[:, :, :, 0])
        out = {}
        for key, (a, b) in {"model": (alpha_m, beta_m), "ols": (alpha_h, beta_h),
                            "baseline": (alpha_t, beta_t)}.items():
            args = (a[..., None], b[..., None], y, factor, inv_psi)
            out[key] = {"mse": mse_window(*args)[0], "nll": nll_window(*args)[0]}
        return out

    per_window = _eval_in_chunks(tree, module.w_hh_l0.device, chunk)
    mean = {k: {m: float(np.mean(v)) for m, v in d.items()}
            for k, d in per_window.items()}
    result: dict = {"baseline": mean["baseline"], "zeta": zeta}
    for key in ("model", "ols"):
        d_mse = mean[key]["mse"] - mean["baseline"]["mse"]
        d_nll = mean[key]["nll"] - mean["baseline"]["nll"]
        result[key] = {"delta_mse": d_mse, "delta_nll": d_nll,
                       "delta_mix": d_nll + zeta * d_mse}
    return result
