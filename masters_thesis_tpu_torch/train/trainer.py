"""The training loop: fit, validation, plateau LR, checkpoints, test.

Counterpart of ``Trainer`` and ``TrainResult`` in
``masters_thesis_tpu/train/trainer.py``, on one device. ``precision`` takes
the JAX trainer's values: ``32-true`` (``32``, ``fp32``), ``bf16-mixed``
(``bf16``: the encoder's recurrences and input projections in bf16 through
the pair's and the stack's bf16 kernels, f32 parameters, optimizer and
loss; ``fit`` and
``test`` build it so) and ``auto`` (``preferred_compute_dtype``: f32 until a
card A/B records a bf16 win in ``MEASURED_BF16_WAVEFRONT_WINS``). Per epoch:
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
draws what an unbroken one draws; a relaunch by the run supervisor after a
divergence carries ``MTT_LR_SCALE``, which scales the restored rate. The
fault points ``trainer.epoch_dispatched`` and ``trainer.loss`` fire as in
the JAX trainer, and each dispatched epoch chains one ``pmean`` entry
(``grads.flat`` over the data axis) into the collective schedule
(``telemetry/schedule.py``), at any world size, as the JAX trainer does.

With ``telemetry`` (a ``TelemetryRun``, which the caller closes) ``fit``
writes the JAX trainer's events (``run_started``, ``cost_profile``,
``epoch`` through the ``EpochRecorder``, ``memory``, ``eval``,
``checkpoint_saved`` with its seconds, ``run_finished``; ``test`` from
``test``) and spans (``trainer.fit``, ``train.epoch``, ``train.eval``,
``train.checkpoint``), and runs the flight recorder (beats ``setup``, ``epoch``, ``eval``,
``checkpoint``, ``finished``; the loss and the LR as tracked scalars; the
hang watchdog after ``hang_timeout_s``). None of it adds a read of the
card: each epoch's ``device_s`` comes from two CUDA events around its
work, read after the epoch's existing read of its sums, and compiles are
the captures of the run's CUDA graphs. ``profile_steps=(N, M)`` (or
``profile``: the first epoch after the capture) traces epochs N..M with
``torch.profiler``; ``cost_profile`` (on with telemetry unless False)
writes the analytic cost of the step (``telemetry/costs.py``). The seconds
the host spends on all of this are summed in the ``telemetry/host_s``
gauge. With a checkpoint directory and a val split, every save writes
the model-quality fingerprint (``telemetry/quality.py``: the first 128
val windows and 32 golden windows through the weights being saved, in
chunks of ``EVAL_CHUNK`` windows, eagerly, outside every graph) as
``quality.json`` inside the tree, covered by its manifest, a
``quality_fingerprint`` event and its seconds in the
``quality/fingerprint_s`` histogram; a fingerprint that fails
prints one line and the save goes on without it. ``metrics_port`` (with
telemetry) starts the telemetry plane: an SLO engine over the run's
stream (``slo_rules``, default ``default_train_rules()``) and the
``/metrics``, ``/healthz`` and ``/slo`` server. ``preflight`` runs the
trace audit (``analysis/traceaudit.py``) of the configured model's step on
this trainer's device and mesh before ``fit`` touches the data, writes the
JAX trainer's ``preflight`` event (``ok``, ``failed`` with its rules and
findings, or ``skipped`` for the stream epoch) and raises
``PreflightError`` on a finding. Stacked replicas are ``train/stacked.py``'s
(f32 whatever the precision, as in the JAX package).

Data-parallel training (``strategy``, ``n_devices``, ``shard_axis``, the
JAX trainer's arguments; ``parallel/mesh.py``): under ``tpu_xla`` this
process is one rank of ``n_devices`` and holds only its shard of the train
split on its device (``device_train_split``: a block of windows, the split
truncated to a multiple of the world size, or with ``shard_axis="asset"``
a block of asset rows of every window). Each step all-reduces its flat
gradient once; each epoch's metric sums are all-reduced at its read, and
each evaluation's (``prepare_eval_split``: a rank evaluates its
``shard_bounds`` slice, an empty one joining with zero sums). Under window
sharding both the shuffle and the dropout stream are the rank's own (the
epoch's seed folded by rank, ``fold_rank``); under asset sharding the
shuffle is common and only the dropout is folded. The fold is the
identity at rank 0, so world size 1 is the solo run bit for bit. The
stream epoch's global batch is ``batch_size × world``: every rank draws
the same host sequence and trains its slice. Every host decision reads
all-reduced values (the plateau schedule, ``best``, the divergence halt;
resume agrees across ranks), so every rank takes the same branch. Rank 0
alone prints, logs and writes checkpoints; with telemetry ``run_started``
carries the world and the rank, and a ``grad_sync`` event and the
``train/collectives_per_step`` and ``train/grad_reduce_bytes`` gauges give
the step's all-reduce.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
import warnings
from pathlib import Path

import numpy as np
import torch

from masters_thesis_tpu_torch.data.pipeline import Batch, FinancialWindowDataModule
from masters_thesis_tpu_torch.data.prefetch import PrefetchStats, prefetch_to_device
from masters_thesis_tpu_torch.models.lstm import preferred_compute_dtype
from masters_thesis_tpu_torch.models.objectives import ModelSpec
from masters_thesis_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    SHARD_AXES,
    DataMesh,
    data_mesh,
    distributed_run_context,
    shard_bounds,
)
from masters_thesis_tpu_torch.resilience import faults
from masters_thesis_tpu_torch.telemetry import costs
from masters_thesis_tpu_torch.telemetry import quality as quality_lib
from masters_thesis_tpu_torch.telemetry.exposition import (
    start_telemetry_plane,
    stop_telemetry_plane,
)
from masters_thesis_tpu_torch.telemetry.profiling import ProfilerWindow
from masters_thesis_tpu_torch.telemetry.run import (
    CaptureTracker,
    EpochRecorder,
    TelemetryRun,
)
from masters_thesis_tpu_torch.telemetry.schedule import record_collective
from masters_thesis_tpu_torch.telemetry.slo import default_train_rules
from masters_thesis_tpu_torch.train import checkpoint as ckpt_lib
from masters_thesis_tpu_torch.train.optim import PlateauScheduler, make_optimizer
from masters_thesis_tpu_torch.train.steps import (
    EvalProgram,
    StreamProgram,
    TrainProgram,
    forward_rows,
    metric_means,
    sharded_weighted_batches,
    train_epoch,
    weighted_batches,
)

EPOCH_MODES = ("scan", "stream")

EVAL_CHUNK = 32

#: The fingerprint's windows: the first val windows and the golden ones.
FINGERPRINT_VAL_WINDOWS = 128
FINGERPRINT_GOLDEN_WINDOWS = 32


@dataclasses.dataclass
class TrainResult:
    state: dict  # the encoder's final state dict (CPU tensors)
    opt_state: dict
    best_val_loss: float
    history: list
    steps_per_sec: float  # train steps per second, first epoch excluded
    windows_per_sec: float  # real windows (a padded tail's copies excluded)
    test_metrics: dict | None = None
    cost_profile: dict | None = None  # the cost_profile event's payload


def device_split(arrays: Batch, device) -> Batch:
    """A split's arrays as f32 tensors on ``device``, moved once (a
    read-only memmap of the window store is copied first)."""
    def host(a) -> np.ndarray:
        a = np.asarray(a, np.float32)
        return a if a.flags.writeable else a.copy()

    return Batch(*(torch.as_tensor(host(a)).to(device) for a in arrays))


#: The ``run_started`` event's ``distributed`` on one device, as the JAX
#: trainer writes it outside a cluster.
SINGLE_PROCESS = {"process_index": None, "process_count": None,
                  "coordinator": None}

#: The evaluation's metric sums (``EvalProgram``), which a rank with no
#: windows to evaluate joins the all-reduce with as zeros.
EVAL_KEYS = ("mae", "mse", "nll", "total")


def device_train_split(mesh: DataMesh, arrays: Batch, axis: str = "window"
                       ) -> tuple[Batch, int]:
    """This rank's shard of the train split (numpy) and its window count.

    ``window``: the split truncated to a multiple of the world size (at
    most world − 1 windows dropped), then the rank's contiguous block of
    ``n // world`` windows. ``asset``: every window, its asset rows
    (``x``, ``y``, ``inv_psi`` on axis 1) truncated to a multiple of the
    world size and the rank's block of them taken; the per-window
    ``factor`` stats, which have no asset axis, whole. As the JAX
    function shards them over its mesh."""
    world, rank = mesh.world, mesh.rank
    if axis == "asset":
        n_assets = arrays.x.shape[1]
        k_local = n_assets // world
        if k_local == 0:
            raise ValueError(f"train split has {n_assets} assets < mesh "
                             f"size {world}")
        lo, hi = rank * k_local, (rank + 1) * k_local
        return (Batch(arrays.x[:, lo:hi], arrays.y[:, lo:hi], arrays.factor,
                      arrays.inv_psi[:, lo:hi]), arrays.x.shape[0])
    if axis != "window":
        raise ValueError(f"unknown shard axis: {axis!r}")
    n_local = arrays.x.shape[0] // world
    if n_local == 0:
        raise ValueError(f"train split has {arrays.x.shape[0]} windows < "
                         f"mesh size {world}")
    lo, hi = rank * n_local, (rank + 1) * n_local
    return Batch(*(a[lo:hi] for a in arrays)), n_local


def prepare_eval_split(mesh: DataMesh, arrays: Batch) -> Batch:
    """This rank's slice of an evaluation split (``shard_bounds``: sizes
    differ by at most one; a rank may get none). The ranks' metric sums
    add up to the whole split's, as the JAX function's padded and masked
    chunks do."""
    lo, hi = shard_bounds(arrays.x.shape[0], mesh.world, mesh.rank)
    return Batch(*(a[lo:hi] for a in arrays))


def fold_rank(seed: int, rank: int) -> int:
    """``seed`` folded by ``rank``, the counterpart of
    ``jax.random.fold_in(rng, axis_index)``; the identity at rank 0."""
    if rank == 0:
        return seed
    return int(np.random.SeedSequence([seed & 0xFFFFFFFF, 1 << 31, rank])
               .generate_state(1)[0])


class HostClock:
    """Sums the host seconds spent inside ``with clock:`` blocks."""

    def __init__(self):
        self.seconds = 0.0
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds += time.perf_counter() - self._t0
        return False


def epoch_seed(seed: int, epoch: int) -> int:
    """The seed of epoch ``epoch``'s generator: a function of ``(seed,
    epoch)`` only."""
    return int(np.random.SeedSequence([seed & 0xFFFFFFFF, epoch])
               .generate_state(1)[0])


#: ``trainer.precision``'s values and their compute dtype (None: ``auto``,
#: resolved a model and window shape at a time), the JAX trainer's.
PRECISIONS = {"32-true": torch.float32, "32": torch.float32,
              "fp32": torch.float32, "bf16-mixed": torch.bfloat16,
              "bf16": torch.bfloat16, "auto": None}


def precision_dtype(precision: str) -> torch.dtype | None:
    """The compute dtype of ``precision`` (None for ``auto``)."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision: {precision!r}")
    return PRECISIONS[precision]


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
        name: str = "fast",
        telemetry: TelemetryRun | None = None,
        cost_profile: bool | None = None,
        profile: bool = False,
        profile_steps: tuple[int, int] | None = None,
        hang_timeout_s: float | None = None,
        metrics_port: int | None = None,
        slo_rules=None,
        strategy: str = "auto",
        n_devices: int | None = None,
        shard_axis: str = "window",
        preflight: bool = False,
        precision: str = "32-true",
    ):
        if epoch_mode not in EPOCH_MODES:
            raise ValueError(f"unknown epoch_mode: {epoch_mode!r} "
                             f"(expected one of {EPOCH_MODES})")
        if shard_axis not in SHARD_AXES:
            raise ValueError(f"unknown shard_axis: {shard_axis!r}")
        if shard_axis == "asset" and epoch_mode != "scan":
            raise ValueError(
                "shard_axis='asset' requires epoch_mode='scan' (the stream "
                "path prefetches window batches, which shard on windows)")
        self.max_epochs = max_epochs
        self.precision = precision
        #: The encoder's compute dtype; None: ``auto``, resolved at fit
        #: and test (``resolve_dtype``).
        self.compute_dtype = precision_dtype(precision)
        self.gradient_clip_val = gradient_clip_val
        self.check_val_every_n_epoch = max(1, int(check_val_every_n_epoch))
        self.ckpt_dir = Path(ckpt_dir) if ckpt_dir else None
        self.seed = seed
        #: The data axis: this rank, the world, the rank's device.
        self.mesh = data_mesh(strategy, n_devices, device)
        self.strategy = self.mesh.strategy
        self.n_dev = self.mesh.world
        self.shard_axis = shard_axis
        self.device = self.mesh.device
        self.logger = logger if self.mesh.is_main else None
        self.resume = resume
        self.checkpoint_every_n_epochs = (
            max(1, int(checkpoint_every_n_epochs))
            if checkpoint_every_n_epochs else None
        )
        self.enable_progress_bar = enable_progress_bar and self.mesh.is_main
        self.enable_model_summary = enable_model_summary
        #: Run the steps as CUDA graphs on the card (never on the CPU).
        self.graphed = cuda_graphs and self.device.type == "cuda"
        self.epoch_mode = epoch_mode
        #: Batches the stream epoch keeps dispatched ahead of its step.
        self.prefetch = prefetch
        #: The trainer config's name (``run_started``'s ``trainer``).
        self.name = name
        #: The caller's run (the caller closes it); None: no telemetry.
        self.telemetry = telemetry
        #: The analytic cost profile; None follows ``telemetry``.
        self.cost_profile = cost_profile
        #: Audit the training step before ``fit`` (``analysis/traceaudit``).
        self.preflight = preflight
        self.profile = profile
        self.profile_steps = (
            (int(profile_steps[0]), int(profile_steps[1]))
            if profile_steps is not None else None
        )
        #: The flight recorder's hang watchdog (None: heartbeats only).
        self.hang_timeout_s = hang_timeout_s
        #: The telemetry plane's port (0: a free one; None: no plane).
        self.metrics_port = metrics_port
        self._slo_rules = slo_rules
        self._exposition = self._slo_engine = None
        #: (val windows, golden windows) a save fingerprints, or None.
        self._quality_windows = None
        self._fit_span = None
        self._clock = HostClock()

    def resolve_dtype(self, spec: ModelSpec, dm) -> torch.dtype:
        """The compute dtype for this model on ``dm``'s windows: the
        precision's, or for ``auto`` the measured per-shape policy
        (``preferred_compute_dtype``) at the windows' lookback and rows
        (``dm`` set up, so that its windows' rows are known)."""
        if self.compute_dtype is not None:
            return self.compute_dtype
        return preferred_compute_dtype(
            spec.num_layers, spec.hidden_size, dm.lookback_window,
            dm.n_stocks, device=self.device)

    def build(self, spec: ModelSpec,
              compute_dtype: torch.dtype = torch.float32):
        """The encoder with its seeded initial weights (f32 at any
        ``compute_dtype``), on the device."""
        init = torch.Generator().manual_seed(self.seed)
        return spec.build_module(device=self.device, generator=init,
                                 compute_dtype=compute_dtype)

    def fit(self, spec: ModelSpec, dm: FinancialWindowDataModule,
            init_state: tuple[dict, dict | None] | None = None) -> TrainResult:
        """Train on ``dm``'s train split, validating on its val split.

        ``init_state=(state_dict, opt_state)`` starts from those weights and
        that FlatAdam state; ``(state_dict, None)`` warm-starts the weights
        with a fresh optimizer. Either way the scheduler is fresh and
        training starts at epoch 0. Without it, the weights are
        ``build(spec)``'s.
        """
        tel = self.telemetry
        clock = self._clock = HostClock()
        flight = None
        if self.logger is not None:
            # Open TensorBoard's writer before the hang watch starts: its
            # first use imports tensorboardX (seconds on some hosts), which
            # would otherwise fall inside the first epoch, with no beat.
            self.logger.writer
        if tel:
            with clock:
                # Attached before the data loads, so that a hang or a
                # signal there still leaves a crashdump, and the
                # supervisor sees this attempt's heartbeat early.
                flight = tel.attach_flight_recorder(
                    hang_timeout_s=self.hang_timeout_s)
                flight.beat(phase="setup")
        if self.preflight:
            self._preflight(spec)
        dm.prepare_data()
        dm.setup("fit")
        module = self.build(spec, self.resolve_dtype(spec, dm))
        if init_state is not None:
            module.load_state_dict(init_state[0])
        optimizer = make_optimizer(module, self.gradient_clip_val,
                                   spec.weight_decay)
        if init_state is not None and init_state[1] is not None:
            optimizer.load_state_dict(init_state[1])
        if self.enable_model_summary:
            n_params = sum(p.numel() for p in module.parameters())
            self._print(f"model: {spec.objective} | params: {n_params:,} "
                        f"| device: {self.device}"
                        + (f" | mesh: {self.n_dev}x{self.shard_axis} | "
                           f"{self.strategy}" if self.mesh.distributed
                           else ""))
        mesh = self.mesh
        step_mesh = mesh if mesh.distributed else None
        scheduler = PlateauScheduler(spec.learning_rate)
        start_epoch, best_val = 0, float("inf")
        resumed_from = None
        if (self.resume and self.ckpt_dir and mesh.agree(
                [ckpt_lib.checkpoint_restorable(self.ckpt_dir, "last")])[0]):
            state, opt_state, _, meta = ckpt_lib.restore_checkpoint(
                self.ckpt_dir, "last")
            module.load_state_dict(state)
            optimizer.load_state_dict(opt_state)
            scheduler.load_state_dict(meta["scheduler"])
            start_epoch = int(meta["epoch"]) + 1
            best_val = float(meta["best_val"])
            # Divergence rollback: the supervisor's relaunch carries
            # MTT_LR_SCALE, so the restored run retries the diverged
            # stretch at a lower rate instead of replaying the blow-up.
            lr_scale = float(os.environ.get("MTT_LR_SCALE", "1") or 1.0)
            if lr_scale != 1.0:
                scheduler.lr *= lr_scale
                self._print(f"rollback: LR scaled by {lr_scale:g} -> "
                            f"{scheduler.lr:.3g}")
            resumed_from = str(self.ckpt_dir / "last")
            self._print(f"resuming from {resumed_from} at epoch "
                        f"{start_epoch}")
        objective = spec.window_objective()
        val_arrays = dm.val_arrays()
        has_val = val_arrays.x.shape[0] > 0
        val = device_split(prepare_eval_split(mesh, val_arrays), self.device)
        if not has_val:
            warnings.warn("val split is empty — LR plateau scheduling is "
                          "inactive and 'best' is the final checkpoint")
        self._quality_windows = None
        if self.ckpt_dir and has_val and mesh.is_main:
            qx = np.asarray(dm.val_arrays().x[:FINGERPRINT_VAL_WINDOWS],
                            np.float32)
            self._quality_windows = (qx, quality_lib.golden_windows(
                FINGERPRINT_GOLDEN_WINDOWS, *qx.shape[1:], seed=0))
        # One generator for the run, re-seeded each epoch: a CUDA graph
        # holds the state of the generator it was captured with.
        generator = torch.Generator(device=self.device)
        if self.epoch_mode == "stream":
            n_windows = len(dm.train_range)
            if n_windows == 0:
                raise ValueError("train split has 0 windows")
            program = StreamProgram(module, optimizer, objective,
                                    dm.train_arrays(), dm.batch_size,
                                    generator, self.graphed, mesh=step_mesh)
            steps_per_epoch = -(-n_windows // (dm.batch_size * self.n_dev))
            train_call = program.run
        else:
            shard, n_local = device_train_split(mesh, dm.train_arrays(),
                                                self.shard_axis)
            train = device_split(shard, self.device)
            program = TrainProgram(module, optimizer, objective, train,
                                   dm.batch_size, generator, self.graphed,
                                   mesh=step_mesh)
            n_windows = program.n_steps * dm.batch_size * (
                self.n_dev if self.shard_axis == "window" else 1)
            steps_per_epoch = program.n_steps
            train_call = program.step
        validation = (EvalProgram(module, objective, val, EVAL_CHUNK,
                                  self.graphed)
                      if val.x.shape[0] > 0 else None)
        rec = fit_span = tracker = eval_tracker = None
        cuda_events = tel is not None and self.device.type == "cuda"
        if tel:
            with clock:
                fit_span = tel.tracer.start(
                    "trainer.fit", trainer=self.name,
                    attempt_resume=bool(resumed_from))
                self._fit_span = fit_span
                tel.event(
                    "run_started",
                    platform=self.device.type,
                    n_devices=self.n_dev,
                    strategy=self.strategy,
                    epoch_mode=self.epoch_mode,
                    steps_per_epoch=steps_per_epoch,
                    max_epochs=self.max_epochs,
                    start_epoch=start_epoch,
                    objective=spec.objective,
                    trainer=self.name,
                    seed=self.seed,
                    resumed_from=resumed_from,
                    distributed=(distributed_run_context()
                                 if mesh.distributed
                                 else dict(SINGLE_PROCESS)),
                    trace_id=tel.tracer.trace_id,
                )
                if mesh.distributed:
                    # One all-reduce of the flat gradient a step (TA206),
                    # moving the whole flat buffer.
                    grad_bytes = optimizer.grads.numel() * 4
                    tel.gauge("train/collectives_per_step").set(1)
                    tel.gauge("train/grad_reduce_bytes").set(grad_bytes)
                    tel.event("grad_sync", collectives_per_step=1,
                              grad_reduce_bytes=grad_bytes, flat_buffers=1)
                tracker = CaptureTracker([train_call])
                eval_tracker = CaptureTracker(
                    [part[1] for part in validation.parts]
                    if validation else [])
                rec = EpochRecorder(tel, steps_per_epoch,
                                    on_epoch=self._mirror_epoch,
                                    span_parent=fit_span)
                if self.metrics_port is not None:
                    self._exposition, self._slo_engine = (
                        start_telemetry_plane(
                            tel, self.metrics_port,
                            rules=self._slo_rules or default_train_rules()))
        cost_payload = None
        if (self.cost_profile if self.cost_profile is not None
                else bool(tel)):
            with clock:
                cost_payload = self._cost_profile(
                    spec, dm, steps_per_epoch, module.compute_dtype.itemsize)
        window = self.profile_steps
        if window is None and self.profile:
            # The legacy flag: the first epoch after the capture.
            window = (start_epoch + 1, start_epoch + 1)
        prof = ProfilerWindow(
            window,
            (tel.run_dir if tel else
             (self.logger.log_dir if self.logger else Path("logs")))
            / "profile",
            telemetry=tel, cuda=self.device.type == "cuda")

        def fence() -> None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

        history: list[dict] = []
        diverged = False
        total_steps = 0
        steady_steps, steady_windows, steady_s = 0, 0, 0.0
        for epoch in range(start_epoch, self.max_epochs):
            row = {"epoch": epoch, "lr-Adam": scheduler.lr}
            prof.maybe_start(epoch)
            if tel:
                with clock:
                    flight.beat(phase="epoch", epoch=epoch)
                    rec.begin(epoch)
                    if cuda_events:
                        started = torch.cuda.Event(enable_timing=True)
                        ended = torch.cuda.Event(enable_timing=True)
                        started.record()
            t0 = time.perf_counter()
            seed = epoch_seed(self.seed, epoch)
            if self.shard_axis == "asset":
                # The shuffle common to every rank, the dropout the rank's.
                generator.manual_seed(seed)
                dropout_seed = fold_rank(seed, mesh.rank) if mesh.rank else None
            else:
                generator.manual_seed(fold_rank(seed, mesh.rank))
                dropout_seed = None
            if self.epoch_mode == "stream":
                stats = PrefetchStats()
                if self.n_dev > 1:
                    batches = sharded_weighted_batches(
                        dm.train_order(epoch, self.seed), dm.take,
                        dm.batch_size, self.n_dev, mesh.rank)
                else:
                    batches = weighted_batches(
                        dm.train_batches(epoch, self.seed), dm.batch_size)
                sums, n_steps = program.epoch(scheduler.lr, prefetch_to_device(
                    batches, self.prefetch, self.device, stats))
            else:
                sums, n_steps = train_epoch(module, optimizer, objective,
                                            train, dm.batch_size, scheduler.lr,
                                            generator, program=program,
                                            dropout_seed=dropout_seed)
            if cuda_events:
                with clock:
                    ended.record()
            # The epoch is queued, nothing of it read or saved: a kill here
            # loses exactly this epoch.
            faults.fire("trainer.epoch_dispatched", epoch=epoch)
            # One schedule entry an epoch for its steps' gradient all-reduce,
            # as the JAX trainer records its epoch program's pmean: a hash
            # update in host memory, outside every graph (a replay runs no
            # Python), no read of the card.
            record_collective("pmean", name="grads.flat", axes=(DATA_AXIS,),
                              step=epoch)
            total_steps += n_steps
            if tel:
                with clock:
                    compiles = tracker.poll()
                    rec.dispatched(
                        compiles=compiles,
                        data_wait_s=(stats.get_wait_s
                                     if self.epoch_mode == "stream" else 0.0))
                    if compiles:
                        flight.note(epoch_compiles=tracker.total,
                                    last_compile_epoch=epoch)
            t_read = time.perf_counter()
            sums = mesh.all_reduce_sums(sums)
            row.update({f"loss/{k}/train": v
                        for k, v in metric_means(sums).items()})
            elapsed = time.perf_counter() - t0  # the read above synchronised
            if tel:
                with clock:
                    # The read above waited for the epoch: its events are
                    # complete, so reading them waits for nothing.
                    rec.fenced(started.elapsed_time(ended) / 1e3
                               if cuda_events
                               else time.perf_counter() - t_read)
                    tel.sample_memory(epoch, self.device)
            if self.epoch_mode == "stream":
                row["data/get_wait_s"] = stats.get_wait_s
                row["data/prefetch_mean_depth"] = stats.mean_depth
                if dm.store is not None:
                    # The window store's page-ins (the JAX trainer's
                    # window_store event).
                    row["data/mmap_bytes"] = stats.mmap_bytes
                    row["data/fault_wait_s"] = stats.fault_wait_s
                    if tel:
                        with clock:
                            tel.event(
                                "window_store", epoch=epoch,
                                bytes_read=stats.mmap_bytes,
                                fault_wait_s=round(stats.fault_wait_s, 6),
                                get_wait_s=round(stats.get_wait_s, 6))
            if faults.fire("trainer.loss", epoch=epoch) == "nan":
                row["loss/total/train"] = float("nan")
            if tel:
                with clock:
                    # The divergence context of a crashdump.
                    flight.track_scalar("loss/total/train",
                                        row["loss/total/train"])
                    flight.track_scalar("lr", row["lr-Adam"])
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
                if tel:
                    with clock:
                        flight.beat(phase="eval", epoch=epoch)
                t_eval_wall, t_eval = time.time(), time.perf_counter()
                val_metrics = metric_means(mesh.all_reduce_sums(
                    validation.run() if validation else None, EVAL_KEYS))
                row.update({f"loss/{k}/val": v for k, v in val_metrics.items()})
                val_loss = val_metrics["total"]
                if tel:
                    with clock:
                        tel.event("eval", epoch=epoch,
                                  compile_events=eval_tracker.poll(),
                                  val_loss=float(val_loss))
                        tel.tracer.emit_span(
                            "train.eval", start_ts=t_eval_wall,
                            dur_s=time.perf_counter() - t_eval,
                            parent=fit_span, epoch=epoch)
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
            prof.maybe_stop(epoch, fence)
        # A divergence halt can leave a profiled window open: close it so
        # the trace is written.
        prof.close(fence)
        if not has_val and history and not diverged:
            best_val = history[-1]["loss/total/train"]
            self._save("best", module, optimizer, scheduler,
                       self.max_epochs - 1, best_val, best_val, dm, spec)
        if not diverged:
            self._save("last", module, optimizer, scheduler,
                       self.max_epochs - 1, best_val, best_val, dm, spec)
        steps_per_sec = steady_steps / steady_s if steady_s > 0 else 0.0
        windows_per_sec = steady_windows / steady_s if steady_s > 0 else 0.0
        if tel:
            with clock:
                rec.finish()
                flight.beat(phase="finished")
                tel.sample_memory(None, self.device)
                tel.tracer.end(fit_span, status="error" if diverged else "ok",
                               epochs=len(history), diverged=diverged)
                self._fit_span = None
                tel.event(
                    "run_finished",
                    epochs=len(history),
                    total_steps=total_steps,
                    steps_per_sec=steps_per_sec,
                    diverged=diverged,
                    best_val=float(best_val) if math.isfinite(best_val)
                    else None,
                    epoch_compiles=tracker.total,
                    eval_compiles=eval_tracker.total,
                )
                if self.logger:
                    self.logger.log_scalars(
                        {"perf/steps_per_sec": steps_per_sec},
                        self.max_epochs - 1)
            tel.gauge("telemetry/host_s").set(clock.seconds)
            tel.snapshot_metrics()
        stop_telemetry_plane(self._exposition, self._slo_engine)
        self._exposition = self._slo_engine = None
        return TrainResult(
            state={k: v.detach().cpu().clone()
                   for k, v in module.state_dict().items()},
            opt_state=optimizer.state_dict(),
            best_val_loss=best_val,
            history=history,
            steps_per_sec=steps_per_sec,
            windows_per_sec=windows_per_sec,
            cost_profile=cost_payload,
        )

    def _preflight(self, spec: ModelSpec) -> None:
        """The trace audit of ``spec``'s training step on this trainer's
        device and mesh, before any real epoch: a ``preflight`` event
        either way, and ``PreflightError`` on a finding. The stream epoch
        is skipped: its step takes host batches by design."""
        tel = self.telemetry
        if self.epoch_mode == "stream":
            self._print("preflight: skipped (epoch_mode='stream' streams "
                        "batches through the host by design)")
            if tel:
                tel.event("preflight", status="skipped",
                          reason="epoch_mode=stream")
            return
        from masters_thesis_tpu_torch.analysis.traceaudit import preflight

        preflight(tel, self._print, spec=spec, mesh=self.mesh,
                  device=self.device, graphed=self.graphed,
                  gradient_clip_val=self.gradient_clip_val)

    def _cost_profile(self, spec: ModelSpec, dm, steps_per_epoch: int,
                      itemsize: int = 4) -> dict | None:
        """The analytic cost of the run's training program
        (``telemetry/costs.py``) as a ``cost_profile`` event: an epoch of
        ``train_epoch_scan`` steps, or one ``train_step_stream`` step, over
        one batch of windows (their rows flattened, as ``forward_rows``
        does). Never fails the run: a failure is printed and written as
        ``cost_unavailable``."""
        tel = self.telemetry
        try:
            stocks, n_t = dm.train_arrays().x.shape[1:3]
            rows = dm.batch_size * stocks
            scan = self.epoch_mode == "scan"
            cost = costs.step_cost_model(
                spec, rows, n_t, window_rows=stocks,
                program="train_epoch_scan" if scan else "train_step_stream",
                steps_per_execution=steps_per_epoch if scan else 1,
                itemsize=itemsize,
                meta={
                    "platform": self.device.type,
                    "device": (torch.cuda.get_device_name(self.device)
                               if self.device.type == "cuda" else None),
                    "n_devices": 1,
                    "epoch_mode": self.epoch_mode,
                    "objective": spec.objective,
                    "batch_size": dm.batch_size,
                    "rows": rows,
                    "n_t": n_t,
                    "precision": self.precision,
                })
            if tel:
                costs.emit_cost_profile(tel, cost)
            return cost.to_payload()
        except Exception as exc:  # observation must never stop a run
            self._print(f"cost profile failed: {exc!r}")
            if tel:
                tel.event("cost_unavailable", program="train",
                          error=repr(exc))
            return None

    def _mirror_epoch(self, ev: dict) -> None:
        """The epoch's perf scalars beside the loss curves. The logger's
        time is its own (its first write opens the writer the loss rows
        open otherwise): it leaves the telemetry clock."""
        if self.logger and ev.get("steps_per_sec") is not None:
            t0 = time.perf_counter()
            self.logger.log_scalars(
                {"perf/epoch_wall_s": ev["wall_s"],
                 "perf/steps_per_sec": ev["steps_per_sec"]}, ev["epoch"])
            self._clock.seconds -= time.perf_counter() - t0

    def test(self, spec: ModelSpec, state: dict,
             dm: FinancialWindowDataModule) -> dict:
        """Test-split metrics (``mse``, ``nll``, ``mae``, ``total``) of the
        encoder with ``state``; over a launch each rank evaluates its
        slice and the sums are all-reduced."""
        dm.setup("test")
        module = spec.build_module(device=self.device,
                                   compute_dtype=self.resolve_dtype(spec, dm))
        module.load_state_dict(state)
        arrays = dm.test_arrays()
        if arrays.x.shape[0] == 0:
            return {}
        test = device_split(prepare_eval_split(self.mesh, arrays), self.device)
        sums = (EvalProgram(module, spec.window_objective(), test, EVAL_CHUNK,
                            self.graphed).run()
                if test.x.shape[0] > 0 else None)
        metrics = metric_means(self.mesh.all_reduce_sums(sums, EVAL_KEYS))
        if self.logger:
            self.logger.log_scalars({f"test/{k}": v for k, v in metrics.items()},
                                    0)
        if self.telemetry:
            self.telemetry.event(
                "test", metrics={k: float(v) for k, v in metrics.items()})
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
        tel = self.telemetry
        if tel and tel.recorder is not None:
            with self._clock:
                tel.recorder.beat(phase="checkpoint", epoch=epoch)
        t0_wall, t0 = time.time(), time.perf_counter()
        fp = extra = None
        if self._quality_windows is not None and self.mesh.is_main:
            try:
                fp = fingerprint(module, *self._quality_windows)
                extra = {quality_lib.FINGERPRINT_FILENAME:
                         quality_lib.fingerprint_to_json(fp)}
            except Exception as exc:  # noqa: BLE001 -- never lose the save
                fp = extra = None
                self._print(f"quality fingerprint failed for {tag!r}: {exc}")
        fp_s = time.perf_counter() - t0
        ckpt_lib.save_checkpoint(
            self.ckpt_dir, tag, module.state_dict(), optimizer.state_dict(),
            scheduler.state_dict(), extra_files=extra,
            meta={
                "epoch": epoch,
                "val_loss": float(val_loss),
                "best_val": float(best_val),
                "datamodule": datamodule_meta(dm),
            },
            spec=spec,
        )
        if tel:
            with self._clock:
                # The save's seconds; the report's lost-work accounting
                # reads these events.
                wall_s = time.perf_counter() - t0
                tel.event("checkpoint_saved", tag=tag, epoch=epoch,
                          wall_s=wall_s, path=str(self.ckpt_dir / tag))
                if fp is not None:
                    tel.event("quality_fingerprint", tag=tag, epoch=int(epoch),
                              windows=int(fp["windows"]),
                              shadow_err=float(fp["shadow"]["err_mean"]))
                    tel.histogram("quality/fingerprint_s").observe(fp_s)
                tel.tracer.emit_span("train.checkpoint", start_ts=t0_wall,
                                     dur_s=wall_s, parent=self._fit_span,
                                     tag=tag, epoch=epoch)


def predict_windows(module, x: np.ndarray, chunk: int = EVAL_CHUNK):
    """The encoder's alpha and beta (the first factor's loading) on windows
    ``x`` ``(n, K, T, F)`` as numpy ``(n, K)`` each: eager forwards of
    ``chunk`` windows on the module's device, with no gradient."""
    device = next(module.parameters()).device
    alphas, betas = [], []
    with torch.inference_mode():
        for start in range(0, len(x), chunk):
            piece = torch.as_tensor(x[start:start + chunk]).to(device)
            alpha, beta = forward_rows(module, piece)
            alphas.append(alpha[..., 0].cpu().numpy())
            betas.append(beta[..., 0].cpu().numpy())
    return np.concatenate(alphas), np.concatenate(betas)


def fingerprint(module, qx: np.ndarray, gx: np.ndarray) -> dict:
    """The model-quality fingerprint of ``module``'s weights: the val
    windows ``qx`` and the golden windows ``gx`` (seed 0) through it, as
    the JAX trainer builds it."""
    a_v, b_v = predict_windows(module, qx)
    a_g, b_g = predict_windows(module, gx)
    return quality_lib.build_fingerprint(qx, a_v, b_v, golden=(gx, a_g, b_g),
                                         golden_seed=0)


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
