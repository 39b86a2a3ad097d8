"""The training loop: fit, validation, plateau LR, checkpoints, test.

Counterpart of ``Trainer`` and ``TrainResult`` in
``masters_thesis_tpu/train/trainer.py``, on one device, f32 only. Per epoch:
one epoch of training steps, then one host read of its metric sums. The
``scan`` epoch (the default) trains on the device-resident train split
(``train_epoch``), ``n // batch_size`` steps, the tail dropped; the
``stream`` epoch draws host batches in the ``(seed, epoch)`` shuffle
(``train_batches``), prefetches them to the device (``prefetch_to_device``,
whose wait and depth go into the epoch row) and runs ``ceil(n /
batch_size)`` weighted steps (``StreamProgram``), the tail padded with
zero-weight windows; over a window store its rows also carry the page-in
bytes and wait (``data/mmap_bytes``, ``data/fault_wait_s``). Every
``check_val_every_n_epoch`` epochs: an evaluation of the val split, a
``PlateauScheduler`` step on its loss, a ``best`` checkpoint when it
improves and a ``last`` one; ``last`` also every
``checkpoint_every_n_epochs`` epochs and at the end. History rows use the
JAX trainer's keys (``loss/<metric>/train``, ``loss/<metric>/val``,
``lr-Adam``), go to the logger, and with ``enable_progress_bar`` print as
the JAX trainer's ``epoch N | ...`` lines. On the card the training step
and the evaluation chunk each run as one CUDA graph (``TrainProgram``,
``EvalProgram``), captured in the first epoch; ``cuda_graphs=False`` runs the
same steps eagerly, the reference the graphs are held to bit for bit.

As in the JAX trainer: ``fit(init_state=)`` starts from given weights (and
optimizer state); ``resume`` continues from the ``last`` checkpoint that
verifies (``checkpoint_restorable``, which also finishes an interrupted
publish) at its epoch + 1 with its weights, FlatAdam state, scheduler and
best val; a non-finite epoch loss halts the run before anything is saved
from it, so ``last`` keeps the last finite weights. Each epoch's shuffle
and dropout masks come from a generator seeded by ``(seed, epoch)``, the
counterpart of ``jax.random.fold_in(dropout_rng, epoch)``: a resumed run
draws what an unbroken one draws. The fault points
``trainer.epoch_dispatched`` and ``trainer.loss`` fire as in the JAX
trainer. Telemetry, the profiler window, preflight, bf16 and multi-device
are not ported; stacked replicas are ``train/stacked.py``'s.
"""

from __future__ import annotations

import dataclasses
import math
import time
import warnings
from pathlib import Path

import numpy as np
import torch

from masters_thesis_tpu_torch import resolve_device
from masters_thesis_tpu_torch.data.pipeline import Batch, FinancialWindowDataModule
from masters_thesis_tpu_torch.data.prefetch import PrefetchStats, prefetch_to_device
from masters_thesis_tpu_torch.models.objectives import ModelSpec
from masters_thesis_tpu_torch.resilience import faults
from masters_thesis_tpu_torch.train import checkpoint as ckpt_lib
from masters_thesis_tpu_torch.train.optim import PlateauScheduler, make_optimizer
from masters_thesis_tpu_torch.train.steps import (
    EvalProgram,
    StreamProgram,
    TrainProgram,
    metric_means,
    train_epoch,
    weighted_batches,
)

EPOCH_MODES = ("scan", "stream")

EVAL_CHUNK = 32


@dataclasses.dataclass
class TrainResult:
    state: dict  # the encoder's final state dict (CPU tensors)
    opt_state: dict
    best_val_loss: float
    history: list
    steps_per_sec: float  # train steps per second, first epoch excluded
    windows_per_sec: float  # real windows (a padded tail's copies excluded)
    test_metrics: dict | None = None


def device_split(arrays: Batch, device) -> Batch:
    """A split's arrays as f32 tensors on ``device``, moved once (a
    read-only memmap of the window store is copied first)."""
    def host(a) -> np.ndarray:
        a = np.asarray(a, np.float32)
        return a if a.flags.writeable else a.copy()

    return Batch(*(torch.as_tensor(host(a)).to(device) for a in arrays))


def epoch_seed(seed: int, epoch: int) -> int:
    """The seed of epoch ``epoch``'s generator: a function of ``(seed,
    epoch)`` only."""
    return int(np.random.SeedSequence([seed & 0xFFFFFFFF, epoch])
               .generate_state(1)[0])


class Trainer:
    def __init__(
        self,
        max_epochs: int,
        gradient_clip_val: float | None = None,
        check_val_every_n_epoch: int = 1,
        ckpt_dir: str | Path | None = None,
        seed: int = 0,
        device=None,
        logger=None,
        resume: bool = False,
        checkpoint_every_n_epochs: int | None = None,
        enable_progress_bar: bool = False,
        enable_model_summary: bool = False,
        cuda_graphs: bool = True,
        epoch_mode: str = "scan",
        prefetch: int = 2,
    ):
        if epoch_mode not in EPOCH_MODES:
            raise ValueError(f"unknown epoch_mode: {epoch_mode!r} "
                             f"(expected one of {EPOCH_MODES})")
        self.max_epochs = max_epochs
        self.gradient_clip_val = gradient_clip_val
        self.check_val_every_n_epoch = max(1, int(check_val_every_n_epoch))
        self.ckpt_dir = Path(ckpt_dir) if ckpt_dir else None
        self.seed = seed
        self.device = resolve_device(device)
        self.logger = logger
        self.resume = resume
        self.checkpoint_every_n_epochs = (
            max(1, int(checkpoint_every_n_epochs))
            if checkpoint_every_n_epochs else None
        )
        self.enable_progress_bar = enable_progress_bar
        self.enable_model_summary = enable_model_summary
        #: Run the steps as CUDA graphs on the card (never on the CPU).
        self.graphed = cuda_graphs and self.device.type == "cuda"
        self.epoch_mode = epoch_mode
        #: Batches the stream epoch keeps dispatched ahead of its step.
        self.prefetch = prefetch

    def build(self, spec: ModelSpec):
        """The encoder with its seeded initial weights, on the device."""
        init = torch.Generator().manual_seed(self.seed)
        return spec.build_module(device=self.device, generator=init)

    def fit(self, spec: ModelSpec, dm: FinancialWindowDataModule,
            init_state: tuple[dict, dict | None] | None = None) -> TrainResult:
        """Train on ``dm``'s train split, validating on its val split.

        ``init_state=(state_dict, opt_state)`` starts from those weights and
        that FlatAdam state; ``(state_dict, None)`` warm-starts the weights
        with a fresh optimizer. Either way the scheduler is fresh and
        training starts at epoch 0. Without it, the weights are
        ``build(spec)``'s.
        """
        dm.prepare_data()
        dm.setup("fit")
        module = self.build(spec)
        if init_state is not None:
            module.load_state_dict(init_state[0])
        optimizer = make_optimizer(module, self.gradient_clip_val,
                                   spec.weight_decay)
        if init_state is not None and init_state[1] is not None:
            optimizer.load_state_dict(init_state[1])
        if self.enable_model_summary:
            n_params = sum(p.numel() for p in module.parameters())
            self._print(f"model: {spec.objective} | params: {n_params:,} "
                        f"| device: {self.device}")
        scheduler = PlateauScheduler(spec.learning_rate)
        start_epoch, best_val = 0, float("inf")
        if (self.resume and self.ckpt_dir
                and ckpt_lib.checkpoint_restorable(self.ckpt_dir, "last")):
            state, opt_state, _, meta = ckpt_lib.restore_checkpoint(
                self.ckpt_dir, "last")
            module.load_state_dict(state)
            optimizer.load_state_dict(opt_state)
            scheduler.load_state_dict(meta["scheduler"])
            start_epoch = int(meta["epoch"]) + 1
            best_val = float(meta["best_val"])
            self._print(f"resuming from {self.ckpt_dir / 'last'} at epoch "
                        f"{start_epoch}")
        objective = spec.window_objective()
        val = device_split(dm.val_arrays(), self.device)
        has_val = val.x.shape[0] > 0
        if not has_val:
            warnings.warn("val split is empty — LR plateau scheduling is "
                          "inactive and 'best' is the final checkpoint")
        # One generator for the run, re-seeded each epoch: a CUDA graph
        # holds the state of the generator it was captured with.
        generator = torch.Generator(device=self.device)
        if self.epoch_mode == "stream":
            n_windows = len(dm.train_range)
            if n_windows == 0:
                raise ValueError("train split has 0 windows")
            program = StreamProgram(module, optimizer, objective,
                                    dm.train_arrays(), dm.batch_size,
                                    generator, self.graphed)
        else:
            train = device_split(dm.train_arrays(), self.device)
            program = TrainProgram(module, optimizer, objective, train,
                                   dm.batch_size, generator, self.graphed)
            n_windows = program.n_steps * dm.batch_size
        validation = (EvalProgram(module, objective, val, EVAL_CHUNK,
                                  self.graphed) if has_val else None)
        history: list[dict] = []
        diverged = False
        steady_steps, steady_windows, steady_s = 0, 0, 0.0
        for epoch in range(start_epoch, self.max_epochs):
            row = {"epoch": epoch, "lr-Adam": scheduler.lr}
            t0 = time.perf_counter()
            generator.manual_seed(epoch_seed(self.seed, epoch))
            if self.epoch_mode == "stream":
                stats = PrefetchStats()
                batches = weighted_batches(
                    dm.train_batches(epoch, self.seed), dm.batch_size)
                sums, n_steps = program.epoch(scheduler.lr, prefetch_to_device(
                    batches, self.prefetch, self.device, stats))
            else:
                sums, n_steps = train_epoch(module, optimizer, objective,
                                            train, dm.batch_size, scheduler.lr,
                                            generator, program=program)
            # The epoch is queued, nothing of it read or saved: a kill here
            # loses exactly this epoch.
            faults.fire("trainer.epoch_dispatched", epoch=epoch)
            row.update({f"loss/{k}/train": v
                        for k, v in metric_means(sums).items()})
            elapsed = time.perf_counter() - t0  # the read above synchronised
            if self.epoch_mode == "stream":
                row["data/get_wait_s"] = stats.get_wait_s
                row["data/prefetch_mean_depth"] = stats.mean_depth
                if dm.store is not None:
                    # The window store's page-ins (the JAX trainer's
                    # window_store event).
                    row["data/mmap_bytes"] = stats.mmap_bytes
                    row["data/fault_wait_s"] = stats.fault_wait_s
            if faults.fire("trainer.loss", epoch=epoch) == "nan":
                row["loss/total/train"] = float("nan")
            if epoch > start_epoch or self.max_epochs - start_epoch == 1:
                steady_steps += n_steps
                steady_windows += n_windows
                steady_s += elapsed
            if not math.isfinite(row["loss/total/train"]):
                # Divergence halts the run before anything is saved from
                # it; the poisoned row is still logged, so the curve shows
                # why it ends.
                self._emit(row, history)
                self._print(f"epoch {epoch}: non-finite training loss "
                            f"({row['loss/total/train']}); halting (diverged)")
                diverged = True
                break
            if has_val and (epoch + 1) % self.check_val_every_n_epoch == 0:
                val_metrics = metric_means(validation.run())
                row.update({f"loss/{k}/val": v for k, v in val_metrics.items()})
                val_loss = val_metrics["total"]
                row["lr-Adam"] = scheduler.step(val_loss)
                if val_loss < best_val:
                    best_val = val_loss
                    self._save("best", module, optimizer, scheduler, epoch,
                               val_loss, best_val, dm, spec)
                self._save("last", module, optimizer, scheduler, epoch,
                           val_loss, best_val, dm, spec)
            elif (self.checkpoint_every_n_epochs
                  and (epoch + 1) % self.checkpoint_every_n_epochs == 0):
                self._save("last", module, optimizer, scheduler, epoch,
                           row["loss/total/train"], best_val, dm, spec)
            self._emit(row, history)
        if not has_val and history and not diverged:
            best_val = history[-1]["loss/total/train"]
            self._save("best", module, optimizer, scheduler,
                       self.max_epochs - 1, best_val, best_val, dm, spec)
        if not diverged:
            self._save("last", module, optimizer, scheduler,
                       self.max_epochs - 1, best_val, best_val, dm, spec)
        steps_per_sec = steady_steps / steady_s if steady_s > 0 else 0.0
        windows_per_sec = steady_windows / steady_s if steady_s > 0 else 0.0
        return TrainResult(
            state={k: v.detach().cpu().clone()
                   for k, v in module.state_dict().items()},
            opt_state=optimizer.state_dict(),
            best_val_loss=best_val,
            history=history,
            steps_per_sec=steps_per_sec,
            windows_per_sec=windows_per_sec,
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
        metrics = metric_means(EvalProgram(module, spec.window_objective(),
                                           test, EVAL_CHUNK, self.graphed).run())
        if self.logger:
            self.logger.log_scalars({f"test/{k}": v for k, v in metrics.items()},
                                    0)
        return metrics

    def _emit(self, row: dict, history: list) -> None:
        if self.logger:
            self.logger.log_scalars(
                {k: v for k, v in row.items() if k != "epoch"}, row["epoch"])
        history.append(row)
        self._print(
            f"epoch {row['epoch']:4d} | "
            + " | ".join(f"{k.split('/')[1]}/{k.split('/')[2]} {v:.5g}"
                         for k, v in row.items() if k.startswith("loss/"))
        )

    def _print(self, msg: str) -> None:
        if self.enable_progress_bar:
            print(msg, flush=True)

    def _save(self, tag, module, optimizer, scheduler, epoch, val_loss,
              best_val, dm, spec) -> None:
        if not self.ckpt_dir:
            return
        ckpt_lib.save_checkpoint(
            self.ckpt_dir, tag, module.state_dict(), optimizer.state_dict(),
            scheduler.state_dict(),
            meta={
                "epoch": epoch,
                "val_loss": float(val_loss),
                "best_val": float(best_val),
                "datamodule": datamodule_meta(dm),
            },
            spec=spec,
        )


def datamodule_meta(dm) -> dict:
    """The window keys a checkpoint's sidecar records (``test`` and the
    engines size themselves from them)."""
    return {
        "lookback_window": dm.lookback_window,
        "target_window": dm.target_window,
        "stride": dm.stride,
        "prediction_task": dm.prediction_task,
        "interaction_only": dm.interaction_only,
        "batch_size": dm.batch_size,
    }
