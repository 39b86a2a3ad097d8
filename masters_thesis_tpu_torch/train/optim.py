"""Optimizer chain and LR plateau scheduling.

Counterpart of ``masters_thesis_tpu/train/optim.py``: grad clip → L2 decay →
Adam (the port's ``FlatAdam``; the learning rate is applied by the caller,
so the plateau scheduler can change it between epochs) and a host-side
``ReduceLROnPlateau`` with torch's defaults.
"""

from __future__ import annotations

import math

from torch import nn

from masters_thesis_tpu_torch.train.flatparams import FlatAdam


def make_optimizer(module: nn.Module, gradient_clip_val: float | None,
                   weight_decay: float) -> FlatAdam:
    """Grad-clip -> L2 decay -> Adam moments over ``module``'s parameters."""
    return FlatAdam(module, gradient_clip_val, weight_decay)


class PlateauScheduler:
    """ReduceLROnPlateau, torch defaults: factor 0.5, patience 2, mode 'min',
    threshold 1e-4 relative, no cooldown, min_lr 0."""

    def __init__(
        self,
        init_lr: float,
        factor: float = 0.5,
        patience: int = 2,
        threshold: float = 1e-4,
        min_lr: float = 0.0,
    ):
        self.lr = float(init_lr)
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.best = math.inf
        self.num_bad_epochs = 0

    def step(self, metric: float) -> float:
        """Record one monitored value; returns the (possibly reduced) LR."""
        metric = float(metric)
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.num_bad_epochs = 0
        return self.lr

    def state_dict(self) -> dict:
        return {
            "lr": self.lr,
            "best": self.best,
            "num_bad_epochs": self.num_bad_epochs,
        }

    def load_state_dict(self, state: dict) -> None:
        self.lr = state["lr"]
        self.best = state["best"]
        self.num_bad_epochs = state["num_bad_epochs"]
