"""Stacked-replica training: R independent runs in one graphed step.

Counterpart of ``masters_thesis_tpu/train/stacked.py``. R replicas (grid
cells that differ in learning rate and seed, or ensemble members) train as
one program over ``[R, n]`` buffers (``StackedTrainProgram``,
``StackedFlatAdam``): on the card one CUDA graph a step, each layer
group's recurrence one replica-axis launch of each of its kernels (the
pair's, the single layer's, the time-blocked single layer's or the
stack's). Replicas share the model
architecture, the loss, the gradient clip and the weight decay (one
program); the learning rate and the seed are each replica's own.

What stays per replica, as in the JAX trainer:

- the initial weights, drawn from the replica's seed exactly as a solo
  ``Trainer`` with that seed draws them, and each epoch's shuffle and
  dropout masks from a generator seeded by ``(seed, epoch)``, the solo
  trainer's streams: replica r's run is the solo run of its seed and rate;
- the learning rate (each replica's ``PlateauScheduler``), Adam moments and
  count, metric sums, history rows and checkpoints (``<ckpt_dir>/<name>/``
  ``best`` and ``last``, the solo trainer's crash-safe trees, each a solo
  checkpoint that ``Trainer``, ``PredictEngine`` and the stacked engine
  restore);
- divergence: a replica whose epoch loss is not finite is rolled back to
  the last fenced snapshot and retried at half its rate; past
  ``max_replica_rollbacks`` it is masked (its row frozen, parameters,
  moments and count) while its siblings train on untouched. The fault
  point ``stacked.replica_loss`` (kind ``nan``) fakes such a loss.

Where the port differs, each noted in ROADMAP queue 3: a masked row is
frozen whatever its gradient holds (the JAX update ``p - 0 * u`` turns a
non-finite ``u`` into NaN, and its moments and count move on); the first
snapshot is the initial state, so an epoch-0 divergence rolls back too
(the JAX trainer has no snapshot before its first fenced epoch); every
epoch's sums are read as it ends (the JAX trainer defers the read of a
non-validation epoch by one epoch); and ``last`` is saved at each
validation as the solo trainer saves it, so a killed run resumes at its
last common epoch. Resume takes every replica's ``last`` only when all
are restorable at one epoch, and starts fresh otherwise.

With ``telemetry`` (a ``TelemetryRun``, which the caller closes) ``fit``
writes the JAX stacked trainer's events: ``run_started`` (with
``stacked_replicas`` and ``replicas``), ``epoch`` through the
``EpochRecorder`` (captures of the stacked step), ``memory``, the
per-replica ``replica_epoch`` (loss, LR, status), ``replica_status`` (each
transition, with the rollbacks so far) and ``replica_eval``,
``checkpoint_saved`` a replica and tag, and ``run_finished`` (with each
replica's final status), under a ``trainer.fit`` span, with the flight
recorder's beats. ``preflight`` runs the trace audit of the solo and the
stacked step (TA201–TA207, ``analysis/traceaudit.py``) before any real
epoch, with the JAX stacked trainer's ``preflight`` event.

Data-parallel (``strategy``, ``n_devices``, as in the JAX class): each
rank holds its block of the train split's windows (window sharding only),
every replica's shuffle and dropout are folded by rank (the identity at
rank 0), the ``[R, n]`` gradient is all-reduced once a step (TA207) and
the ``[R]`` metric sums once an epoch, so every rank reads the same
losses and takes the same rollback and mask decisions; a replica masked
on every rank stays frozen whatever another rank's gradient row holds.
Rank 0 prints and writes the checkpoints; with telemetry a ``grad_sync``
event gives the step's all-reduce.
"""

from __future__ import annotations

import dataclasses
import math
import time
import warnings
from pathlib import Path
from typing import Sequence

import torch

from masters_thesis_tpu_torch.data.pipeline import FinancialWindowDataModule
from masters_thesis_tpu_torch.models.lstm import StackedLstmEncoder
from masters_thesis_tpu_torch.models.objectives import ModelSpec
from masters_thesis_tpu_torch.parallel.mesh import (
    data_mesh,
    distributed_run_context,
)
from masters_thesis_tpu_torch.resilience import faults
from masters_thesis_tpu_torch.telemetry.run import (
    CaptureTracker,
    EpochRecorder,
    TelemetryRun,
)
from masters_thesis_tpu_torch.train import checkpoint as ckpt_lib
from masters_thesis_tpu_torch.train.flatparams import StackedFlatAdam
from masters_thesis_tpu_torch.train.optim import PlateauScheduler
from masters_thesis_tpu_torch.train.steps import (
    EvalProgram,
    StackedTrainProgram,
    metric_means,
    stacked_metric_means,
)
from masters_thesis_tpu_torch.train.trainer import (
    EVAL_CHUNK,
    EVAL_KEYS,
    SINGLE_PROCESS,
    datamodule_meta,
    device_split,
    device_train_split,
    epoch_seed,
    fold_rank,
    prepare_eval_split,
)


@dataclasses.dataclass(frozen=True)
class ReplicaSpec:
    """One replica riding the stack: its name and free hyperparameters."""

    name: str
    seed: int
    learning_rate: float


@dataclasses.dataclass
class ReplicaResult:
    name: str
    state: dict  # the replica's final encoder state dict (CPU tensors)
    opt_state: dict  # its solo FlatAdam state
    best_val_loss: float
    history: list
    status: str  # active | recovering | masked
    rollbacks: int


@dataclasses.dataclass
class StackedResult:
    replicas: list
    steps_per_sec: float  # program steps a second, first epoch excluded
    epochs: int

    @property
    def replica_steps_per_sec(self) -> float:
        return self.steps_per_sec * len(self.replicas)


class StackedTrainer:
    """Drive one stacked training program over R replicas: scan epochs on
    the device-resident train split, ``StackedFlatAdam``, no stream path
    (as narrow as the JAX class)."""

    def __init__(
        self,
        max_epochs: int,
        gradient_clip_val: float | None = None,
        check_val_every_n_epoch: int = 1,
        ckpt_dir: str | Path | None = None,
        device=None,
        resume: bool | str = False,
        enable_progress_bar: bool = False,
        max_replica_rollbacks: int = 1,
        cuda_graphs: bool = True,
        telemetry: TelemetryRun | None = None,
        preflight: bool = False,
        hang_timeout_s: float | None = None,
        strategy: str = "auto",
        n_devices: int | None = None,
    ):
        self.max_epochs = max_epochs
        self.gradient_clip_val = gradient_clip_val
        self.check_val_every_n_epoch = max(1, int(check_val_every_n_epoch))
        self.ckpt_dir = Path(ckpt_dir) if ckpt_dir else None
        #: The data axis: this rank, the world, the rank's device.
        self.mesh = data_mesh(strategy, n_devices, device)
        self.strategy = self.mesh.strategy
        self.n_dev = self.mesh.world
        self.device = self.mesh.device
        if isinstance(resume, str):
            resume = resume.lower() in ("true", "auto", "1", "yes")
        self.resume = resume
        self.enable_progress_bar = enable_progress_bar and self.mesh.is_main
        #: Divergences a replica survives (each a rollback and a halved
        #: rate) before it is masked.
        self.max_replica_rollbacks = max(0, int(max_replica_rollbacks))
        self.graphed = cuda_graphs and self.device.type == "cuda"
        self.telemetry = telemetry
        #: The flight recorder's hang watchdog (None: heartbeats only).
        self.hang_timeout_s = hang_timeout_s
        #: Audit the single and the stacked step before ``fit``.
        self.preflight = preflight

    def build(self, spec: ModelSpec, replicas: Sequence[ReplicaSpec]
              ) -> StackedLstmEncoder:
        """The stacked encoder, replica r drawn from its own seed as
        ``Trainer.build`` draws a solo run's weights."""
        return StackedLstmEncoder([
            spec.build_module(device=self.device,
                              generator=torch.Generator().manual_seed(rep.seed))
            for rep in replicas])

    def fit(self, spec: ModelSpec, dm: FinancialWindowDataModule,
            replicas: Sequence[ReplicaSpec]) -> StackedResult:
        if not replicas:
            raise ValueError("a stacked fit needs at least one ReplicaSpec")
        names = [r.name for r in replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"replica names must be unique: {names}")
        n_rep = len(replicas)
        if self.preflight:
            from masters_thesis_tpu_torch.analysis.traceaudit import preflight

            # The solo and the stacked step, before any real epoch.
            preflight(self.telemetry, self._print, spec=spec, mesh=self.mesh,
                      device=self.device, graphed=self.graphed,
                      gradient_clip_val=self.gradient_clip_val,
                      stacked_replicas=n_rep)
        dm.prepare_data()
        dm.setup("fit")
        module = self.build(spec, replicas)
        optimizer = StackedFlatAdam(module.replicas, self.gradient_clip_val,
                                    spec.weight_decay)
        schedulers = [PlateauScheduler(rep.learning_rate) for rep in replicas]
        best_vals = [math.inf] * n_rep
        start_epoch = self._try_resume(replicas, module, optimizer,
                                       schedulers, best_vals)
        objective = spec.window_objective()
        mesh = self.mesh
        train = device_split(device_train_split(mesh, dm.train_arrays())[0],
                             self.device)
        val_arrays = dm.val_arrays()
        has_val = val_arrays.x.shape[0] > 0
        val = device_split(prepare_eval_split(mesh, val_arrays), self.device)
        if not has_val:
            warnings.warn("val split is empty — LR plateau scheduling is "
                          "inactive and 'best' is the final checkpoint")
        # One generator a replica for the run, re-seeded each epoch: the
        # step's graph holds their states.
        generators = [torch.Generator(device=self.device) for _ in replicas]
        program = StackedTrainProgram(
            module, optimizer, objective, train, dm.batch_size, generators,
            self.graphed, mesh=mesh if mesh.distributed else None)
        validations = ([EvalProgram(enc, objective, val, EVAL_CHUNK,
                                    self.graphed) for enc in module.replicas]
                       if val.x.shape[0] > 0 else [])
        statuses = ["active"] * n_rep
        rollbacks = [0] * n_rep
        histories: list[list[dict]] = [[] for _ in replicas]
        tel = self.telemetry
        flight = rec = fit_span = tracker = None
        if tel:
            flight = tel.attach_flight_recorder(
                hang_timeout_s=self.hang_timeout_s)
            flight.beat(phase="setup")
            fit_span = tel.tracer.start("trainer.fit", trainer="stacked",
                                        stacked_replicas=n_rep)
            tel.event(
                "run_started",
                platform=self.device.type,
                n_devices=self.n_dev,
                strategy=self.strategy,
                epoch_mode="stacked_scan",
                steps_per_epoch=program.n_steps,
                max_epochs=self.max_epochs,
                start_epoch=start_epoch,
                objective=spec.objective,
                trainer="stacked",
                seed=replicas[0].seed,
                resumed_from=(str(self.ckpt_dir) if start_epoch else None),
                distributed=(distributed_run_context() if mesh.distributed
                             else dict(SINGLE_PROCESS)),
                stacked_replicas=n_rep,
                replicas=[dataclasses.asdict(r) for r in replicas],
                trace_id=tel.tracer.trace_id,
            )
            if mesh.distributed:
                # One all-reduce of the [R, n] gradient a step (TA207), its
                # rows with their alignment padding.
                grad_bytes = optimizer.grad_storage.numel() * 4
                tel.gauge("train/collectives_per_step").set(1)
                tel.gauge("train/grad_reduce_bytes").set(grad_bytes)
                tel.event("grad_sync", collectives_per_step=1,
                          grad_reduce_bytes=grad_bytes, flat_buffers=1,
                          stacked_replicas=n_rep)
            tracker = CaptureTracker([program.step])
            rec = EpochRecorder(tel, program.n_steps, span_parent=fit_span)
        total_steps = 0
        # Fenced snapshots: the state as the run starts, then after each
        # validated epoch (and the first), every replica's row clean.
        last_good = optimizer.snapshot()
        steady_steps, steady_s = 0, 0.0
        all_masked = False
        for epoch in range(start_epoch, self.max_epochs):
            for generator, rep in zip(generators, replicas):
                generator.manual_seed(fold_rank(epoch_seed(rep.seed, epoch),
                                                mesh.rank))
            lrs = [0.0 if s == "masked" else sch.lr
                   for s, sch in zip(statuses, schedulers)]
            optimizer.set_active([s != "masked" for s in statuses])
            if tel:
                flight.beat(phase="epoch", epoch=epoch)
                rec.begin(epoch)
            t0 = time.perf_counter()
            sums, n_steps = program.epoch(lrs)
            total_steps += n_steps
            if tel:
                rec.dispatched(compiles=tracker.poll())
            t_read = time.perf_counter()
            sums = mesh.all_reduce_sums(sums)
            means = stacked_metric_means(sums, n_rep)  # one device read
            elapsed = time.perf_counter() - t0
            if tel:
                rec.fenced(time.perf_counter() - t_read)
                tel.sample_memory(epoch, self.device)
            if epoch > start_epoch or self.max_epochs - start_epoch == 1:
                steady_steps += n_steps
                steady_s += elapsed
            rows = []
            for r, rep in enumerate(replicas):
                row = {"epoch": epoch, "lr-Adam": lrs[r]}
                row.update({f"loss/{k}/train": v for k, v in means[r].items()})
                rows.append(row)
            all_masked = self._readback(epoch, rows, replicas, statuses,
                                        rollbacks, schedulers, optimizer,
                                        last_good)
            if not all_masked:
                is_val = has_val and (epoch + 1) % self.check_val_every_n_epoch == 0
                if is_val or epoch == start_epoch:
                    last_good = optimizer.snapshot()
                if is_val:
                    self._validate(epoch, rows, module, optimizer, replicas,
                                   statuses, rollbacks, schedulers, best_vals,
                                   validations, dm, spec)
            for r, row in enumerate(rows):
                histories[r].append(row)
                if tel:
                    tel.event("replica_epoch", epoch=epoch, replica=r,
                              name=replicas[r].name,
                              loss=row.get("loss/total/train"),
                              lr=row["lr-Adam"], status=statuses[r])
                self._print(f"epoch {epoch:4d} | {replicas[r].name} "
                            f"[{statuses[r]}] | " + " | ".join(
                                f"{k.split('/')[1]}/{k.split('/')[2]} {v:.5g}"
                                for k, v in row.items() if k.startswith("loss/")))
            if all_masked:
                break
        results = []
        for r, rep in enumerate(replicas):
            if not has_val and histories[r] and statuses[r] != "masked":
                best_vals[r] = histories[r][-1]["loss/total/train"]
                self._save(rep, "best", module, optimizer, r, schedulers[r],
                           self.max_epochs - 1, best_vals[r], statuses[r],
                           rollbacks[r], dm, spec)
            self._save(rep, "last", module, optimizer, r, schedulers[r],
                       self.max_epochs - 1, best_vals[r], statuses[r],
                       rollbacks[r], dm, spec)
            results.append(ReplicaResult(
                name=rep.name,
                state={k: v.detach().cpu().clone()
                       for k, v in module.replicas[r].state_dict().items()},
                opt_state=optimizer.replica_state_dict(r),
                best_val_loss=best_vals[r],
                history=histories[r],
                status=statuses[r],
                rollbacks=rollbacks[r],
            ))
        steps_per_sec = steady_steps / steady_s if steady_s > 0 else 0.0
        if tel:
            rec.finish()
            flight.beat(phase="finished")
            tel.sample_memory(None, self.device)
            epochs_run = max((len(h) for h in histories), default=0)
            tel.tracer.end(fit_span, status="error" if all_masked else "ok",
                           epochs=epochs_run)
            finite = [v for v in best_vals if math.isfinite(v)]
            tel.event(
                "run_finished",
                epochs=epochs_run,
                total_steps=total_steps,
                steps_per_sec=steps_per_sec,
                diverged=all_masked,
                best_val=min(finite) if finite else None,
                epoch_compiles=tracker.total,
                eval_compiles=0,
                stacked_replicas=n_rep,
                replica_status={rep.name: statuses[r]
                                for r, rep in enumerate(replicas)},
            )
            tel.snapshot_metrics()
        return StackedResult(
            replicas=results,
            steps_per_sec=steps_per_sec,
            epochs=self.max_epochs - start_epoch,
        )

    # ------------------------------------------------------------ helpers

    def _readback(self, epoch, rows, replicas, statuses, rollbacks,
                  schedulers, optimizer, last_good) -> bool:
        """Each replica's divergence check on its epoch row; True when no
        replica is left. A non-finite replica's row of the stack goes back
        to ``last_good`` and its rate halves, or, past the rollback budget,
        it is masked; its siblings' rows are not touched."""
        for r, row in enumerate(rows):
            if statuses[r] == "masked":
                continue
            if faults.fire("stacked.replica_loss", epoch=epoch,
                           replica=r) == "nan":
                row["loss/total/train"] = float("nan")
            if math.isfinite(row.get("loss/total/train", math.nan)):
                if statuses[r] == "recovering":
                    self._status(replicas, statuses, rollbacks, r, "active",
                                 epoch, "finite loss again")
                continue
            rollbacks[r] += 1
            optimizer.restore_row(r, last_good)
            if rollbacks[r] > self.max_replica_rollbacks:
                self._status(replicas, statuses, rollbacks, r, "masked",
                             epoch, "rollback budget exhausted; frozen at "
                             "its last good state")
            else:
                schedulers[r].lr *= 0.5
                self._status(replicas, statuses, rollbacks, r, "recovering",
                             epoch, "non-finite loss; rolled back, lr "
                             f"halved to {schedulers[r].lr:.3g}")
        return all(s == "masked" for s in statuses)

    def _status(self, replicas, statuses, rollbacks, r, status, epoch,
                reason) -> None:
        statuses[r] = status
        self._print(f"epoch {epoch}: replica {replicas[r].name!r} -> "
                    f"{status} ({reason}; rollbacks {rollbacks[r]})")
        if self.telemetry:
            self.telemetry.event("replica_status", epoch=epoch, replica=r,
                                 name=replicas[r].name, status=status,
                                 reason=reason, rollbacks=rollbacks[r])

    def _validate(self, epoch, rows, module, optimizer, replicas, statuses,
                  rollbacks, schedulers, best_vals, validations, dm,
                  spec) -> None:
        """Each unmasked replica's val split through its own eval program:
        its scheduler steps, ``best`` when it improves, ``last``."""
        for r, rep in enumerate(replicas):
            if statuses[r] == "masked":
                continue
            val_metrics = metric_means(self.mesh.all_reduce_sums(
                validations[r].run() if validations else None, EVAL_KEYS))
            rows[r].update({f"loss/{k}/val": v for k, v in val_metrics.items()})
            val_loss = val_metrics["total"]
            if self.telemetry:
                self.telemetry.event("replica_eval", epoch=epoch, replica=r,
                                     name=rep.name, val_loss=float(val_loss))
            rows[r]["lr-Adam"] = schedulers[r].step(val_loss)
            if val_loss < best_vals[r]:
                best_vals[r] = val_loss
                self._save(rep, "best", module, optimizer, r, schedulers[r],
                           epoch, best_vals[r], statuses[r], rollbacks[r], dm,
                           spec)
            self._save(rep, "last", module, optimizer, r, schedulers[r], epoch,
                       best_vals[r], statuses[r], rollbacks[r], dm, spec)

    def replica_dir(self, rep: ReplicaSpec) -> Path:
        return self.ckpt_dir / rep.name

    def _try_resume(self, replicas, module, optimizer, schedulers,
                    best_vals) -> int:
        """The epoch to start at: every replica's ``last`` restored in place
        when all are restorable at one epoch (then that epoch + 1), else 0
        and nothing restored."""
        if not (self.resume and self.ckpt_dir):
            return 0
        restorable = [ckpt_lib.checkpoint_restorable(self.replica_dir(rep),
                                                     "last")
                      for rep in replicas]
        if not self.mesh.agree([all(restorable)])[0]:
            return 0
        restored = [ckpt_lib.restore_checkpoint(self.replica_dir(rep), "last")
                    for rep in replicas]
        epochs = {int(meta.get("epoch", -1)) for _, _, _, meta in restored}
        if len(epochs) != 1:
            self._print(f"resume skipped: replica checkpoints at mixed epochs "
                        f"{sorted(epochs)}; starting fresh")
            return 0
        for r, (state, opt_state, _, meta) in enumerate(restored):
            module.replicas[r].load_state_dict(state)
            optimizer.load_replica_state_dict(r, opt_state)
            if meta.get("scheduler"):
                schedulers[r].load_state_dict(meta["scheduler"])
            if meta.get("best_val") is not None:
                best_vals[r] = float(meta["best_val"])
        start = epochs.pop() + 1
        self._print(f"resuming all {len(replicas)} replicas at epoch {start}")
        return start

    def _save(self, rep, tag, module, optimizer, r, scheduler, epoch,
              best_val, status, rollbacks, dm, spec) -> None:
        if not self.ckpt_dir:
            return
        ckpt_lib.save_checkpoint(
            self.replica_dir(rep), tag, module.replicas[r].state_dict(),
            optimizer.replica_state_dict(r), scheduler.state_dict(),
            meta={
                "epoch": epoch,
                "val_loss": float(best_val),
                "best_val": float(best_val) if math.isfinite(best_val) else None,
                "trainer": "stacked",
                "replica": dataclasses.asdict(rep),
                "replica_status": status,
                "rollbacks": rollbacks,
                "datamodule": datamodule_meta(dm),
            },
            spec=spec,
        )
        if self.telemetry:
            self.telemetry.event("checkpoint_saved", tag=tag, epoch=epoch,
                                 replica=rep.name,
                                 path=str(self.replica_dir(rep) / tag))

    def _print(self, msg: str) -> None:
        if self.enable_progress_bar:
            print(msg, flush=True)
