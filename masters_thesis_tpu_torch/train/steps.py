"""Step functions: the encoder on a window batch, the training epoch and the
evaluation pass.

Counterpart of ``forward_rows``, the scan epoch (``_flat_epoch_body``),
``window_eval_metrics`` and ``make_eval_fn`` in
``masters_thesis_tpu/train/steps.py``. The JAX package compiles an epoch into
one program; the port runs it eagerly, with the same discipline: the train
split lives on the device, the epoch's shuffle is drawn there, metric sums
stay there, and the host reads them once per epoch. The mesh, the pmean and
the stacked replicas are not ported (single device).
"""

from __future__ import annotations

import torch

from masters_thesis_tpu_torch.data.pipeline import Batch
from masters_thesis_tpu_torch.models.objectives import (
    batched_objective,
    mse_window,
    nll_window,
)


def forward_rows(module, x: torch.Tensor, *, deterministic: bool = True,
                 generator: torch.Generator | None = None, masks=None):
    """Apply the encoder to a window batch: ``(B, K, T, F) -> (B, K, 1)``
    alpha and ``(B, K, n_factors)`` beta.

    Flattens (batch, stocks) into rows like the reference's ``flatten(0, 1)``
    and passes ``window_rows=k``, as the JAX function does, so the encoder
    groups its layers as the JAX encoder does at this window shape.
    ``deterministic=False`` is the training forward: dropout masks drawn
    from ``generator`` (or ``masks``).
    """
    b, k = x.shape[:2]
    alpha, beta = module(x.reshape(b * k, *x.shape[2:]),
                         deterministic=deterministic, generator=generator,
                         masks=masks, window_rows=k)
    return alpha.reshape(b, k, 1), beta.reshape(b, k, -1)


def _accumulate(sums: dict | None, new: dict) -> dict:
    if sums is None:
        return new
    return {k: (sums[k][0] + new[k][0], sums[k][1] + new[k][1]) for k in sums}


def metric_means(sums: dict) -> dict:
    """Host side: (value_sum, weight) pairs to means. One device read."""
    host = {k: torch.stack([v, w]).double().cpu() for k, (v, w) in sums.items()}
    return {k: float(vw[0]) / max(float(vw[1]), 1e-30) for k, vw in host.items()}


def train_step(module, optimizer, loss_fn, batch: Batch, lr: float,
               generator: torch.Generator | None = None, masks=None) -> dict:
    """One update: training forward, loss, backward through the kernels, the
    flat optimizer step. Returns the step's metric sums (on the device).
    ``masks`` injects the dropout planes instead of drawing them."""
    alpha, beta = forward_rows(module, batch.x, deterministic=False,
                               generator=generator, masks=masks)
    loss, sums = loss_fn(alpha, beta, batch.y, batch.factor, batch.inv_psi)
    optimizer.zero_grad()
    loss.backward()
    optimizer.step(lr)
    return {k: (v.detach(), w.detach()) for k, (v, w) in sums.items()}


def train_epoch(module, optimizer, window_objective, data: Batch,
                batch_size: int, lr: float,
                generator: torch.Generator | None = None) -> tuple[dict, int]:
    """One epoch over the device-resident train split.

    The counterpart of the scan epoch: one ``torch.randperm`` on the device
    from ``generator``, ``n // batch_size`` steps (the tail dropped, as in
    scan mode), each gathering its windows on the device; the dropout masks
    are drawn from the same generator. Returns the epoch's metric sums,
    still on the device, and the number of steps.
    """
    loss_fn = batched_objective(window_objective)
    n = data.x.shape[0]
    n_steps = n // batch_size
    perm = torch.randperm(n, generator=generator, device=data.x.device)
    idx = perm[: n_steps * batch_size].view(n_steps, batch_size)
    module.train()
    sums = None
    for i in range(n_steps):
        batch = Batch(*(a.index_select(0, idx[i]) for a in data))
        sums = _accumulate(sums, train_step(module, optimizer, loss_fn, batch,
                                            lr, generator))
    return sums, n_steps


def window_eval_metrics(alpha, beta, y, factor, inv_psi) -> dict:
    """Per-window evaluation metrics: the objective components plus the
    MAE of ``alpha + beta · r_market`` against realized returns."""
    r_target = y[..., 0]
    mse_loss, mse_metrics = mse_window(alpha, beta, y, factor, inv_psi)
    nll_loss, _ = nll_window(alpha, beta, y, factor, inv_psi)
    n = mse_metrics["mse"][1]
    mae = torch.mean(torch.abs(alpha + beta * y[..., 1] - r_target), dim=(-2, -1))
    return {
        "mse": (mse_loss * n, n),
        "nll": (nll_loss, torch.ones_like(nll_loss)),
        "mae": (mae * n, n),
    }


@torch.no_grad()
def evaluate(module, window_objective, data: Batch, chunk: int = 32) -> dict:
    """Metric sums (``mse``, ``nll``, ``mae``, ``total``) over a split on the
    device, ``chunk`` windows a forward, deterministic. The sums stay on the
    device; ``metric_means`` reads them."""
    module.eval()
    sums = None
    for start in range(0, data.x.shape[0], chunk):
        batch = Batch(*(a[start:start + chunk] for a in data))
        alpha, beta = forward_rows(module, batch.x)
        args = (alpha, beta, batch.y, batch.factor, batch.inv_psi)
        metrics = window_eval_metrics(*args)
        loss, _ = window_objective(*args)
        metrics["total"] = (loss, torch.ones_like(loss))
        sums = _accumulate(sums, {k: (v.sum(), w.sum())
                                  for k, (v, w) in metrics.items()})
    return sums
