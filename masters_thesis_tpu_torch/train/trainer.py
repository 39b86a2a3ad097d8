"""The training loop: fit, validation, plateau LR, checkpoints, test.

Counterpart of ``Trainer`` and ``TrainResult`` in
``masters_thesis_tpu/train/trainer.py``, on one device, f32 only. Per epoch:
one device-resident epoch (``train_epoch``), one host read of its metric
sums; every ``check_val_every_n_epoch`` epochs an evaluation of the val
split, a ``PlateauScheduler`` step on its loss, a ``best`` checkpoint when it
improves and a ``last`` one; ``last`` again at the end. History rows use the
JAX trainer's keys (``loss/<metric>/train``, ``loss/<metric>/val``,
``lr-Adam``); the trainer prints nothing, the caller reads them from
``TrainResult.history``. The stream epoch mode, prefetch, resume, the
divergence halt, telemetry, the profiler window, preflight, bf16,
multi-device and stacked training are not ported.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from pathlib import Path

import numpy as np
import torch

from masters_thesis_tpu_torch import resolve_device
from masters_thesis_tpu_torch.data.pipeline import Batch, FinancialWindowDataModule
from masters_thesis_tpu_torch.models.objectives import ModelSpec
from masters_thesis_tpu_torch.train import checkpoint as ckpt_lib
from masters_thesis_tpu_torch.train.optim import PlateauScheduler, make_optimizer
from masters_thesis_tpu_torch.train.steps import evaluate, metric_means, train_epoch

EVAL_CHUNK = 32


@dataclasses.dataclass
class TrainResult:
    state: dict  # the encoder's final state dict (CPU tensors)
    opt_state: dict
    best_val_loss: float
    history: list
    steps_per_sec: float  # train steps per second, first epoch excluded
    windows_per_sec: float
    test_metrics: dict | None = None


def device_split(arrays: Batch, device) -> Batch:
    """A split's arrays as f32 tensors on ``device``, moved once."""
    return Batch(*(torch.as_tensor(np.asarray(a, np.float32)).to(device)
                   for a in arrays))


class Trainer:
    def __init__(
        self,
        max_epochs: int,
        gradient_clip_val: float | None = None,
        check_val_every_n_epoch: int = 1,
        ckpt_dir: str | Path | None = None,
        seed: int = 0,
        device=None,
    ):
        self.max_epochs = max_epochs
        self.gradient_clip_val = gradient_clip_val
        self.check_val_every_n_epoch = max(1, int(check_val_every_n_epoch))
        self.ckpt_dir = Path(ckpt_dir) if ckpt_dir else None
        self.seed = seed
        self.device = resolve_device(device)

    def _generator(self, offset: int = 0) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(self.seed + offset)

    def build(self, spec: ModelSpec):
        """The encoder with its seeded initial weights, on the device."""
        init = torch.Generator().manual_seed(self.seed)
        return spec.build_module(device=self.device, generator=init)

    def fit(self, spec: ModelSpec, dm: FinancialWindowDataModule,
            module=None) -> TrainResult:
        """Train ``module`` (default: ``build(spec)``) on ``dm``'s train
        split, validating on its val split."""
        dm.prepare_data()
        dm.setup("fit")
        module = self.build(spec) if module is None else module
        optimizer = make_optimizer(module, self.gradient_clip_val,
                                   spec.weight_decay)
        scheduler = PlateauScheduler(spec.learning_rate)
        objective = spec.window_objective()
        train = device_split(dm.train_arrays(), self.device)
        val = device_split(dm.val_arrays(), self.device)
        has_val = val.x.shape[0] > 0
        if not has_val:
            warnings.warn("val split is empty — LR plateau scheduling is "
                          "inactive and 'best' is the final checkpoint")
        # One generator drives the epoch shuffles and the dropout masks.
        generator = self._generator()
        history: list[dict] = []
        best_val = float("inf")
        steady_steps, steady_s, total_steps = 0, 0.0, 0
        for epoch in range(self.max_epochs):
            row = {"epoch": epoch, "lr-Adam": scheduler.lr}
            t0 = time.perf_counter()
            sums, n_steps = train_epoch(module, optimizer, objective, train,
                                        dm.batch_size, scheduler.lr, generator)
            row.update({f"loss/{k}/train": v
                        for k, v in metric_means(sums).items()})
            elapsed = time.perf_counter() - t0  # the read above synchronised
            total_steps += n_steps
            if epoch > 0 or self.max_epochs == 1:
                steady_steps += n_steps
                steady_s += elapsed
            if has_val and (epoch + 1) % self.check_val_every_n_epoch == 0:
                val_metrics = metric_means(
                    evaluate(module, objective, val, EVAL_CHUNK))
                row.update({f"loss/{k}/val": v for k, v in val_metrics.items()})
                val_loss = val_metrics["total"]
                row["lr-Adam"] = scheduler.step(val_loss)
                if val_loss < best_val:
                    best_val = val_loss
                    self._save("best", module, optimizer, scheduler, epoch,
                               val_loss, best_val, dm)
                self._save("last", module, optimizer, scheduler, epoch,
                           val_loss, best_val, dm)
            history.append(row)
        if not has_val and history:
            best_val = history[-1]["loss/total/train"]
            self._save("best", module, optimizer, scheduler,
                       self.max_epochs - 1, best_val, best_val, dm)
        self._save("last", module, optimizer, scheduler, self.max_epochs - 1,
                   best_val, best_val, dm)
        steps_per_sec = steady_steps / steady_s if steady_s > 0 else 0.0
        return TrainResult(
            state={k: v.detach().cpu().clone()
                   for k, v in module.state_dict().items()},
            opt_state=optimizer.state_dict(),
            best_val_loss=best_val,
            history=history,
            steps_per_sec=steps_per_sec,
            windows_per_sec=steps_per_sec * dm.batch_size,
        )

    def test(self, spec: ModelSpec, state: dict,
             dm: FinancialWindowDataModule) -> dict:
        """Test-split metrics (``mse``, ``nll``, ``mae``, ``total``) of the
        encoder with ``state``."""
        dm.setup("test")
        module = spec.build_module(device=self.device)
        module.load_state_dict(state)
        test = device_split(dm.test_arrays(), self.device)
        if test.x.shape[0] == 0:
            return {}
        return metric_means(evaluate(module, spec.window_objective(), test,
                                     EVAL_CHUNK))

    def _save(self, tag, module, optimizer, scheduler, epoch, val_loss,
              best_val, dm) -> None:
        if not self.ckpt_dir:
            return
        ckpt_lib.save_checkpoint(
            self.ckpt_dir, tag, module.state_dict(), optimizer.state_dict(),
            scheduler.state_dict(),
            meta={
                "epoch": epoch,
                "val_loss": float(val_loss),
                "best_val": float(best_val),
                "datamodule": {
                    "lookback_window": dm.lookback_window,
                    "target_window": dm.target_window,
                    "stride": dm.stride,
                    "prediction_task": dm.prediction_task,
                    "interaction_only": dm.interaction_only,
                    "batch_size": dm.batch_size,
                },
            },
        )
