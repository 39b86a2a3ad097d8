"""Serve and train model=small and model=medium on one NVIDIA GPU through the
PyTorch/CUDA port, model=small at a one-year lookback, and model=medium on
Fama-French data through the stream epoch.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``masters_thesis_tpu_torch/ops/csrc`` (at
first use, with nvcc, one process a source) and holds each against its plain
PyTorch version on the card. Then it drives the port's paths: serving
(``PredictServer`` -> ``PredictEngine`` -> ``LstmEncoder`` -> forward
kernels) on requests made from the synthetic DGP, checked against the same
engine on the CPU; and training (``Trainer.fit`` -> ``train_epoch`` ->
``LstmEncoder`` in training mode -> forward and backward kernels) on
synthetic windows, followed by ``Trainer.test`` and serving the ``best``
checkpoint. model=small runs on 100-row windows (pairs); model=medium on
25-row windows, the shape of the 25 Fama-French portfolios, where the
encoder groups its 4 layers into one 4-deep stack; model=large at that shape
runs the 7- and 8-deep stacks. At a 252-day lookback model=small runs every
layer alone through the time-blocked kernels, as the reference routes it:
served, trained (with and without remat) and evaluated (the ΔL table).
Trajectories and gradients are held against the CPU port. After
model=small's training phases the default composition goes through the
port's own entry point, ``python -m masters_thesis_tpu_torch train``, then
``test`` and a warm start, each in a child process (``phase_driver``).
The training step, the evaluation chunk and each serving bucket run as
CUDA graphs by default; the ``graphs_*`` phases hold 20 graphed training
steps of small, medium, large (7 + 1) and long bit for bit against the
same steps run eagerly, the val split's graphed sums against eager ones,
and time ``Trainer.fit`` both ways; the serve phases hold every bucket's
graph against the eager engine, and the breakdowns time both.
The stream epoch (host batches, the pinned-memory prefetcher, the padded
tail, one graphed weighted step) runs in ``stream`` (model=small, batch 3:
prefetch two ahead against none and graphed against eager bit for bit, the
card against the CPU port) and in ``real_medium``: the slice's path, ``train
datamodule=real model=medium trainer.epoch_mode=stream`` on Fama-French
CSVs in the data library's layout written here from a seed, then ``test``
and a warm start from the synthetic model=medium checkpoint, each a child
process, and the best checkpoint served through
``PredictEngine.from_checkpoint``. ``resilience`` runs ``train`` under the
run supervisor (``python -m masters_thesis_tpu_torch.resilience run``),
whose attempt 1 is killed in the middle of a checkpoint's publish
(``MTT_FAULT_PLAN``) and whose attempt 2 resumes it bit for bit, reads the
child's ``events.jsonl`` back with ``telemetry summarize`` (one restart)
and prints the time to recover; it also corrupts a published checkpoint,
which the restore and the server must catch. ``fleet``, beside those
children, runs the training fleet (``python -m
masters_thesis_tpu_torch.resilience fleet --nprocs 1``) around one NCCL
rank of ``train``, kills generation 0 after epoch 1 and holds the
relaunched generation 1 to the unbroken run bit for bit, its collective
schedule, ``telemetry postmortem`` and ``aggregate``, and its kernels'
launches. Beside it
``telemetry_profile`` runs a short ``train`` child with the profiler
window on one epoch, whose trace must name the pair path's kernels. Every
``train`` child writes its ``events.jsonl`` (``trainer.telemetry=auto``);
``driver`` reads its child's back (one capture of the train program, a
FLOP share of the card's peak). The rest of serving closes the run: ``serve_faults`` (a fault plan
on ``serve.admit`` and ``serve.dispatch``, its counts held to the plan's),
``serve_preflight`` (``python -m masters_thesis_tpu_torch.serve
preflight`` as a child), ``serve_swap`` (the canaried hot-swap through the
bucket graphs under steady load: the ``driver`` phase's trained ``best``
committed through the quality gate against its own fingerprint, then a
corrupted, a NaN, a model=medium and a diverged candidate (heads scaled by
50 under the old fingerprint) refused, every answer bit-equal to an engine
on the old or the new checkpoint; model=medium commits under load too),
``serve_knee``
(an open-loop ramp with telemetry on: the knee, ``/metrics`` against
``stats()``, the request spans checked and attributed, telemetry on
against off), ``serve_quality`` (``PredictEngine.warmup()`` per bucket;
the serving ``QualityMonitor``'s host seconds a sampled window, bursts with
it off and on, the knee with it on) and ``serve_slo`` (the telemetry plane
of a server: a burst of sheds fires a burn-rate alert, read on ``/slo``,
``/metrics`` and ``/healthz``, which then resolves). Every ``train`` child's
``best`` and ``last`` carry a manifest-covered ``quality.json``, whose
seconds a save are printed.
The universe path, ``datamodule=universe model=kfactor`` (2,048 assets,
K=3 factors, 7 inputs, a 3-wide beta head; 12,000 samples), runs each
layer alone through the single-layer kernels: ``universe_kernels`` holds
them against their plain versions and cuDNN at 2,048 and 8,192 rows (the
forward also at 131,072, serving's top bucket); ``universe_data`` builds
the K-factor DGP's 8-shard window store (while nvcc builds) and opens it
with every shard re-hashed; ``universe_train`` runs ``train
datamodule=universe model=kfactor loss=combined`` (2 epochs, graphed)
and ``test`` as children, a 5-step card-against-CPU trajectory
(``universe_parity``) and a stream epoch over the memmapped store;
``universe_serve`` serves the run's ``best`` on the ``serve=universe``
ladder (1–64 windows, a graph a bucket) against the CPU engine, with
bursts of 64 requests and the allocator's peak.
Stacked replicas run the pair, single-layer and stack kernels with a
replica axis (grid (row tiles, R)): ``stacked_kernels`` holds each
replica-axis kernel (the pair's forward, sweep and pass on 100 and 800
rows; the single layer's on 100 and 800; the 4-deep stack's on 25 and
200; the time-blocked forward and backward at T=252 on 100 and 800; the
pair's at R = 1, 2, 4, 8, the others' at R = 1, 8) against its plain
version and each replica
against its solo launch bit for bit, and times one launch against R solo
launches; ``stacked_train`` runs ``StackedTrainer.fit`` at R = 1, 8
on train small's data (replica 0 bit for bit ``train``'s
``Trainer.fit``; a ``stacked.replica_loss`` fault plan that masks a
replica); ``stacked_groupings`` fits R = 4 replicas of one layer and of
model=medium, and runs 5-step trajectories of R = 2 replicas of
model=large and model=kfactor, each replica against its solo run;
``stacked_tblocked`` runs model=small at a one-year lookback (both layers
time-blocked) through the replica axis: a 5-step trajectory of R = 2 and
a one-epoch fit of R = 4, each replica against its solo run;
``stacked_driver`` runs ``python -m masters_thesis_tpu_torch stacked``
at R = 4 as a child; ``stacked_serve`` serves its four ``best``s as the
lanes of one ``StackedPredictEngine`` (each lane bit for bit a solo
engine, ``try_swap_lane`` under load), then lanes of one layer, of
model=medium and of model=small at a one-year lookback.
Data-parallel training runs at world size 1 on NCCL (one card): the
``data_parallel`` lines. ``world1`` is the driver's train command with
``trainer.strategy=tpu_xla trainer.n_devices=1`` added (beside the
driver's test and warm start), whose rows and ``best``/``last`` weights
must be the driver child's bit for bit, with one capture, a ``grad_sync``
event over the flat gradient's bytes, and one gradient all-reduce a step
counted through the graph's replays (NCCL does an in-place SUM at one
rank with no work on the card). ``asset_world1`` is the universe
train command with ``trainer.shard_axis=asset`` at world size 1 (beside
the universe test child), whose first row must be the universe child's bit
for bit. ``sweeps`` (beside ``resilience``): ``-m seed=0,1`` through
``launcher=joblib launcher.n_jobs=2`` (two children on the card at once)
equal to the sequential launcher's jobs (a job that parts prints the
first differing key, both values, every differing key, the worst abs and
relative error, and whether the two runs' weights are bit-equal),
and ``trainer.n_devices=2`` on the one card refused, naming the key.
The serving fleet (``serve_fleet``, last): three model=small replicas
share the card behind one ``FleetServer``; ``r0`` is crashed under
closed-loop bursts and comes back at generation 2 (``boot_s``, its
captures), then ``r0`` and ``r1`` together, so that two restarts boot at
once while ``r2`` serves (their captures take turns); every request
resolved explicitly, none late, every ok answer within 1e-5 of a solo
engine, the launch counts exactly each graph's runs times its launches;
two stacked replicas of R = 4 lanes the same way; and the fleet's
answers/s, p50 and p99 against one
``PredictServer`` (off / on / on / off); ``r0``'s first restart boots
warm from the factories' shared program cache (no capture, one hit a
bucket). ``serve_preflight`` also holds SV306 (two replicas of the
preflight engine on the card, ``r0`` crashed) and SV305 (a warm boot from
the program cache captures nothing). ``serve_cache`` (after
``serve_fleet``): model=small's ladder booted cold, closed into a
``ProgramCache`` and booted warm (0 captures, 4 hits, answers bit for bit,
the seconds of each bucket), a planted ``cache.load`` corruption refused,
the card's probe (its seconds), and a planted probe wedge after a breaker
trip that declares the device lost (``degradation`` with ``fallback:
null``, ``device_lost``, no engine built). ``universe_serve`` closes its
1-64 ladder into a cache and boots it again (``universe_serve_warm``:
cold and warm boot seconds, the allocator's peak).
``preflight`` (after ``serve_fleet``) runs the trainer preflight
(``analysis/traceaudit.py``) on the card at model=small and at R = 2
stacked: one capture, every later step a replay under the raising sync
check, one gradient all-reduce a step; a host read planted in the step
fails it with TA202, and a capture that fails for another cause is TA205;
beside it, the port's lint gate (``python -m
masters_thesis_tpu_torch.analysis --concurrency --contracts --spmd``, and
the default run: the graph-path lint and the audit on the card) as
children, both exit 0.
``ledger`` (after ``serve_fleet``) writes one round of the run's own numbers
to a perf ledger in a temporary directory (``telemetry/ledger.py``):
``mse/bs=1`` from ``train`` (steps/s, the counted cost a step, its share
of the card's peak, the allocator's peak), ``serve/knee_qps`` from
``serve_knee`` and ``serve/restart_s`` from ``serve_fleet``'s warm
restart; then ``python -m masters_thesis_tpu_torch.telemetry ledger``, as
a child that cannot import torch or JAX, must pass it, pass a repeat of it,
and exit 2 on a doctored third round naming exactly the four metrics moved.
``trainer.precision=bf16-mixed`` runs the pair's bf16 instances:
``training_kernels`` holds each (the forward maskless and masked with its
stashes, the sweep, the pass) against its plain bf16 version at 100 and 800
rows (every stored entry within one bf16 ulp, at least 99% equal; the
sweep's f32 d_pre planes as the f32 sweep's), beside cuDNN's bf16 LSTM as
a time; ``train_bf16`` fits model=small for one graphed epoch in bf16 (the
bf16 counters launched, no f32 pair kernel) and holds 5 card steps to the
CPU port's bf16 steps; ``train_bf16_driver`` runs ``train
trainer.precision=bf16-mixed`` as a child, ``model=medium`` at bf16 as
another (one 4-deep stack in bf16), and ``model.num_layers=5`` at bf16
([4, 1]: a single layer), which must be refused by key.
The L-deep stack's bf16 instances: ``stack_bf16_kernels`` holds
each (the maskless forward, the masked forward with its stashes, the
sweep, the pass over 2L - 1 jobs) against its plain bf16 version at the
shapes a bf16 fit launches them (``BF16_STACK_SHAPES``: L = 4 at one
100-row window and a 3,200-row evaluation chunk, L = 8 at 25 and 800 rows,
L = 6 at 3,200), by the pair's bar, beside cuDNN's bf16 LSTM;
``train_medium_bf16`` fits model=medium (one 4-deep stack in training and
in evaluation) for one graphed epoch in bf16 and one in f32 (two pairs) on
``train``'s set, their windows/s side by side, the bf16 stack counters
launched and no f32 or pair kernel, and holds 5 card steps and an
evaluation chunk to the CPU port's bf16; ``train_large_bf16`` does the
same for model=large's 5 steps and a chunk on 25-row windows ([8]) and on
100-row windows ([4, 4], evaluation [6, 2]).
Each phase prints one JSON line; the last line is
``{"ok": true, "device": {...}}``. Any failure raises, so the exit code is
non-zero; without CUDA the script exits 2 before doing anything. The
training data is generated under ``data/chip_smoke/<stocks>x<samples>/``
next to this script.

Imports only torch, numpy and the port (never JAX or the JAX package).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import functools
import gc
import hashlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

from masters_thesis_tpu_torch.data.pipeline import (
    Batch,
    FinancialWindowDataModule,
    bootstrap_synthetic,
)
from masters_thesis_tpu_torch import evaluation
from masters_thesis_tpu_torch.data.synthetic import SyntheticLogReturns
from masters_thesis_tpu_torch.models.objectives import ModelSpec, batched_objective
from masters_thesis_tpu_torch.ops import _build
from masters_thesis_tpu_torch.ops import lstm_kernel as lk
from masters_thesis_tpu_torch.ops.windows import (
    add_quadratic_features,
    lookback_target_split,
)
from masters_thesis_tpu_torch.serve.engine import PredictEngine
from masters_thesis_tpu_torch.serve.server import PredictServer
from masters_thesis_tpu_torch.serve.stacked import StackedPredictEngine
from masters_thesis_tpu_torch.serve.swap import CheckpointSwapper
from masters_thesis_tpu_torch.telemetry import costs
from masters_thesis_tpu_torch.telemetry import ledger
from masters_thesis_tpu_torch.telemetry.signals import knee_from_ledger
from masters_thesis_tpu_torch.telemetry.costs import (
    PEAK_SOURCE,
    bound_ms as bound,
)
from masters_thesis_tpu_torch.telemetry import quality as quality_lib
from masters_thesis_tpu_torch.telemetry.events import read_events
from masters_thesis_tpu_torch.telemetry.run import TelemetryRun
from masters_thesis_tpu_torch.telemetry.trace import (
    SERVE_COMPONENTS,
    collect_spans,
    serve_attribution,
    validate_spans,
)
from masters_thesis_tpu_torch.cli import train as cli_train
from masters_thesis_tpu_torch.data.fama_french import FamaFrench25Portfolios
from masters_thesis_tpu_torch.data.prefetch import PrefetchStats, prefetch_to_device
from masters_thesis_tpu_torch.resilience import faults
from masters_thesis_tpu_torch.train.checkpoint import (
    CorruptCheckpointError,
    load_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from masters_thesis_tpu_torch.train.manifest import (
    last_verified_checkpoint,
    verify_checkpoint,
)
from masters_thesis_tpu_torch.train.logging import read_records
from masters_thesis_tpu_torch.models.lstm import LstmEncoder, StackedLstmEncoder
from masters_thesis_tpu_torch.train.flatparams import StackedFlatAdam
from masters_thesis_tpu_torch.train.optim import make_optimizer
from masters_thesis_tpu_torch.train.stacked import ReplicaSpec, StackedTrainer
from masters_thesis_tpu_torch.train.steps import (
    EvalProgram,
    StackedTrainProgram,
    StreamProgram,
    TrainProgram,
    evaluate,
    forward_rows,
    metric_means,
    train_step,
    weighted_batches,
)
from masters_thesis_tpu_torch.train.trainer import (
    EVAL_CHUNK,
    Trainer,
    device_split,
    epoch_seed,
)

# Forwards: 2e-5 abs (f32, summation order differs over 60 dependent steps).
# Backward sweeps and weight gradients: 2e-5 of the largest entry (at least
# 2e-5 abs): their entries grow with the cotangents summed over the steps
# and, for the weight gradients, over T * rows terms.
KERNEL_TOL = 2e-5
SERVE_TOL = 5e-5  # f32 end to end: input projection, recurrence, heads
T, H = 60, 64
K_STOCKS = 100
K_MEDIUM = 25  # stocks a window for model=medium and model=large
STACK_LAYERS = 4  # model=medium: one 4-deep stack at 25 rows
FWD_SOURCE = "masters_thesis_tpu_torch/ops/csrc/lstm_fwd.cu"
BWD_SOURCE = "masters_thesis_tpu_torch/ops/csrc/lstm_bwd.cu"
STACK_SOURCE = "masters_thesis_tpu_torch/ops/csrc/lstm_stack.cu"
STACK_BWD_SOURCE = "masters_thesis_tpu_torch/ops/csrc/lstm_stack_bwd.cu"
TB_SOURCE = "masters_thesis_tpu_torch/ops/csrc/lstm_tb.cu"
FWD_BF16_SOURCE = "masters_thesis_tpu_torch/ops/csrc/lstm_fwd_bf16.cu"
BWD_BF16_SOURCE = "masters_thesis_tpu_torch/ops/csrc/lstm_bwd_bf16.cu"
STACK_BF16_SOURCE = "masters_thesis_tpu_torch/ops/csrc/lstm_stack_bf16.cu"
STACK_BWD_BF16_SOURCE = "masters_thesis_tpu_torch/ops/csrc/lstm_stack_bwd_bf16.cu"
TPU = "masters_thesis_tpu/ops/lstm_kernel.py"
# Each kernel of the port: (its source, the TPU kernel it replaces).
# lstm_wgrad_stack is lstm_wgrad at a stack's 2L - 1 jobs, and
# lstm_wgrad_single at one layer's one job; their launches count under
# lstm_wgrad.
KERNELS = {
    "lstm_pair_fwd": (FWD_SOURCE, f"{TPU}:719"),
    "lstm_fwd": (FWD_SOURCE, f"{TPU}:140"),
    "lstm_pair_fwd_masked": (FWD_SOURCE, f"{TPU}:719"),
    "lstm_pair_bwd": (BWD_SOURCE, f"{TPU}:845"),
    "lstm_wgrad": (BWD_SOURCE, f"{TPU}:845"),
    "lstm_bwd": (BWD_SOURCE, f"{TPU}:204"),
    "lstm_stack_fwd": (STACK_SOURCE, f"{TPU}:1118"),
    "lstm_stack_fwd_masked": (STACK_SOURCE, f"{TPU}:1118"),
    "lstm_stack_bwd": (STACK_BWD_SOURCE, f"{TPU}:1239"),
    "lstm_wgrad_stack": (BWD_SOURCE, f"{TPU}:1239"),
    "lstm_wgrad_single": (BWD_SOURCE, f"{TPU}:204"),
    "lstm_tb_fwd": (TB_SOURCE, f"{TPU}:339"),
    "lstm_tb_bwd": (TB_SOURCE, f"{TPU}:404"),
    # The pair's bf16 instances (trainer.precision=bf16-mixed): the same TPU
    # kernels at their bf16 compute dtype.
    "lstm_pair_fwd_bf16": (FWD_BF16_SOURCE, f"{TPU}:719"),
    "lstm_pair_fwd_masked_bf16": (FWD_BF16_SOURCE, f"{TPU}:719"),
    "lstm_pair_bwd_bf16": (BWD_BF16_SOURCE, f"{TPU}:845"),
    "lstm_wgrad_bf16": (BWD_BF16_SOURCE, f"{TPU}:845"),
    # The stack's bf16 instances; lstm_wgrad_stack_bf16 is
    # lstm_wgrad_bf16 at the stack's 2L - 1 jobs.
    "lstm_stack_fwd_bf16": (STACK_BF16_SOURCE, f"{TPU}:1118"),
    "lstm_stack_fwd_masked_bf16": (STACK_BF16_SOURCE, f"{TPU}:1118"),
    "lstm_stack_bwd_bf16": (STACK_BWD_BF16_SOURCE, f"{TPU}:1239"),
    "lstm_wgrad_stack_bf16": (BWD_BF16_SOURCE, f"{TPU}:1239"),
}
#: The bf16 counters, which the bf16 fit must launch and the f32 pair
#: counters, which it must not.
BF16_COUNTERS = ("lstm_pair_fwd_bf16", "lstm_pair_fwd_masked_bf16",
                 "lstm_pair_bwd_bf16", "lstm_wgrad_bf16")
F32_PAIR_COUNTERS = ("lstm_pair_fwd", "lstm_pair_fwd_masked", "lstm_pair_bwd",
                     "lstm_wgrad")
# bf16 against its plain version: every stored entry within one bf16 ulp of
# the plain entry (or 1e-6 abs), at least 99% of them equal; the f32 d_pre
# planes as the f32 sweeps (KERNEL_TOL of the largest entry). Card against
# CPU over 5 bf16 steps: 1e-5 relative on the losses, the CPU tests' bar for
# the port against JAX; the card's f32 steps must fall outside it, so that a
# fit that lost the bf16 semantics (f32 compute, other roundings) fails.
BF16_EQUAL_SHARE = 0.99
BF16_PARITY_RTOL = 1e-5
# The kernels the stream epoch's phases run, by phase.
STREAM_PATHS = {
    "lstm_pair_fwd": "stream", "lstm_pair_fwd_masked": "stream",
    "lstm_pair_bwd": "stream", "lstm_wgrad": "stream",
    "lstm_stack_fwd": "real_medium", "lstm_stack_fwd_masked": "real_medium",
    "lstm_stack_bwd": "real_medium", "lstm_wgrad_stack": "real_medium",
}
# The long lookback: datamodule.lookback_window=252 (one trading year),
# target 30, stride 282 (non-overlapping windows, as the default's 60 + 30).
T_LONG, STRIDE_LONG = 252, 282

# Training: configs/model/small.yaml, configs/loss/mse.yaml and
# configs/trainer/fast.yaml (clip 5.0), on configs/datamodule/synthetic.yaml
# windows cut from 100 stocks x 200,000 samples instead of 1,000,000.
TRAIN_SAMPLES = 200_000
TRAIN_EPOCHS = 2
CLIP, LR, WD = 5.0, 1e-4, 1e-5
PARITY_STEPS = 20
LONG_PARITY_STEPS = 5  # at T=252 the CPU side dominates the script's time
# Card against CPU over the same steps from the same weights. Losses: 1e-5
# relative (f32 sums over 3,000 terms in another order). Parameters: 1e-5
# abs, a tenth of one Adam step (lr): equal gradients up to f32 rounding
# move both copies alike, while a wrong gradient entry moves its weight by
# about lr a step in another direction. Gradients: 1e-4 of the step's
# largest entry (sums over 6,000 row-steps in another order reach ~1e-6).
PARITY_LOSS_RTOL = 1e-5
PARITY_PARAM_TOL = 1e-5
GRAD_RTOL = 1e-4
DEVICE = "cuda"  # the card the phases run on


def swap_root() -> Path:
    """Checkpoints of the serve_swap phase (the driver's ``best`` and
    seeded saves), under the git-ignored data directory."""
    return Path(__file__).resolve().parent / "data" / "chip_smoke" / "serve_swap"


def data_dir(stocks: int) -> Path:
    """The training data's directory, keyed by the generation parameters, so
    a set made at another size is never reused and never blocks a run."""
    return (Path(__file__).resolve().parent / "data" / "chip_smoke"
            / f"{stocks}x{TRAIN_SAMPLES}")


_T0 = time.perf_counter()


def emit(obj: dict) -> None:
    """One JSON line; a phase's line carries ``t_s``, the script's seconds
    so far."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - _T0}
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int = 20, loops: int = 5,
            warmup: int = 3) -> tuple[float, float, float]:
    """Milliseconds per call from CUDA events around each of ``loops`` loops
    of ``iters`` back-to-back calls, after ``warmup`` calls: the median over
    the loops, its min and its max. Where the host takes longer to launch a
    call than the card takes to run it, this is the host's rate."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    per_loop = []
    for _ in range(loops):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        per_loop.append(start.elapsed_time(end) / iters)
    return float(np.median(per_loop)), min(per_loop), max(per_loop)


def device_ops(call, calls: int = 10, attempts: int = 3) -> list[dict]:
    """Device time per call by operation, from a torch.profiler trace of
    ``calls`` calls: device-side events only (kernels, copies), so an
    operator's time is its kernels' time, counted once. Largest first. A
    trace that holds no device event is taken again (up to ``attempts``
    traces); late in a long run the profiler can record none at all, and
    then the card's time a call comes from CUDA events (``spin_ms``), as
    one entry without the split by operation."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        # Device activity only: the host's events are not read here, and
        # recording them costs seconds on a plain version's thousands of
        # operators.
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                call()
            torch.cuda.synchronize()
        device = sorted(
            ((e.key, e.self_device_time_total / 1e3 / calls)
             for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
            key=lambda kv: -kv[1],
        )
        if device:
            return [{"name": name[:80], "ms": ms} for name, ms in device]
    return [{"name": f"all operations (CUDA events: {attempts} profiler "
                     "traces recorded no device time)", "ms": spin_ms(call)}]


def spin_ms(fn, calls: int = 5) -> float:
    """The card's milliseconds for one call, with no host delay in them: CUDA
    events around the call, queued behind a spin kernel
    (``torch.cuda._sleep``) that outlasts the host's time to queue the call,
    so the events bracket only the call's work on the card. The median of
    ``calls`` calls. For calls of a few kernels: a plain version's
    thousands of launches would fill the launch queue during the spin.
    Unlike the profiler's, its readings hold over a long run."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    # About twice the host's time at the card's clock (<= 2 GHz).
    cycles = int(4e9 * max(host_s, 1e-4))
    per_call = []
    for _ in range(calls):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end))
    return float(np.median(per_call))


def timed(key: str, fn, calls: int = 10, spin: bool = True, **loop) -> dict:
    """``key`` (ms a call over back-to-back loops, the median), its spread
    ``[min, max]`` over the loops, and the card's own time a call, which no
    host delay enters: ``spin_ms`` for a call of a few kernels, the
    profiler's device time of ``calls`` calls for a plain version
    (``spin=False``)."""
    median, low, high = cuda_ms(fn, **loop)
    busy = (spin_ms(fn) if spin
            else sum(op["ms"] for op in device_ops(fn, calls)))
    return {key: median, f"{key}_spread": [low, high],
            key.replace("ms", "device_ms"): busy}


def host_probe_ms() -> float:
    """Host milliseconds of a fixed pure-Python loop, which touches neither
    torch nor the card: its spread over a run is the host's own."""
    t0 = time.perf_counter()
    total = 0
    for i in range(20_000):
        total += i
    return 1e3 * (time.perf_counter() - t0)


def cost(name: str, rows: int, n_t: int = T, n_layers: int = STACK_LAYERS,
         with_c: bool = False) -> tuple[int, int]:
    """A kernel row's operations and bytes at width H: the cost model of
    the run report (``telemetry/costs.py`` ``kernel_cost``), behind every
    row's ``bound_ms`` (at the H100 peaks, ``bound``); a ``_bf16`` name is
    its kernel at itemsize 2."""
    bf16 = name.endswith("_bf16")
    return costs.kernel_cost(name.removesuffix("_bf16"), rows, n_t, H,
                             n_layers=n_layers, with_c=with_c,
                             itemsize=2 if bf16 else 4)


# ------------------------------------------------------------------ phases


def _card() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def phase_device() -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = _card()
    # The card's name and power limit as nvidia-smi prints them.
    print(smi, flush=True)
    info = {
        "phase": "device",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "allow_tf32": False,
        "host_cpus": os.cpu_count(),
    }
    emit(info)
    return info


def phase_build() -> None:
    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {
        name: [
            line.strip() for line in _build.build_log(name).splitlines()
            if "registers" in line or "spill" in line
        ]
        for name in libs
    }
    emit({"phase": "build", "seconds": build_s, "ptxas": ptxas})


def _kernel_case(rows: int, seed: int):
    rng = np.random.default_rng(seed)
    scale = 1.0 / np.sqrt(H)

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).cuda()

    x = t(rng.standard_normal((T, rows, 4 * H)))
    w1, wi2, w2 = (t(rng.uniform(-scale, scale, (H, 4 * H))) for _ in range(3))
    b2 = t(rng.uniform(-scale, scale, (4 * H,)))
    return x, w1, wi2, b2, w2


def _cudnn_module(layers, dtype=torch.float32) -> torch.nn.LSTM:
    """torch.nn.LSTM (cuDNN) computing the kernels' function: layer 1's
    input weight is the identity on the 4H-wide projections (one extra
    (T*B, 4H) @ (4H, 4H) product), all of layer 1's bias sits in x.
    ``layers``: ``[(w_hh,), (w_hh, w_in, bias), ...]``, bottom first; its
    weights in ``dtype`` (bf16: cuDNN's bf16 LSTM, a time only)."""
    four_h = 4 * H
    lstm = torch.nn.LSTM(four_h, H, num_layers=len(layers)).cuda()
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(torch.eye(four_h))
        lstm.bias_ih_l0.zero_()
        lstm.bias_hh_l0.zero_()
        lstm.weight_hh_l0.copy_(layers[0][0].T)
        for n, (w_hh, w_in, bias) in enumerate(layers[1:], start=1):
            getattr(lstm, f"weight_ih_l{n}").copy_(w_in.T)
            getattr(lstm, f"bias_ih_l{n}").copy_(bias)
            getattr(lstm, f"bias_hh_l{n}").zero_()
            getattr(lstm, f"weight_hh_l{n}").copy_(w_hh.T)
    return lstm.to(dtype)


def _cudnn_forward(x, layers):
    """cuDNN's forward on a copy of x that asks for a gradient: under
    inference mode the inference forward, else the forward as training runs
    it (it keeps what its backward needs)."""
    lstm = _cudnn_module(layers, x.dtype)
    xg = x.detach().clone().requires_grad_(True)
    return lambda: lstm(xg)[0]


def _inference(fn):
    """``fn`` called under inference mode: cuDNN's inference forward, the
    yardstick of a serving kernel."""
    def call():
        with torch.inference_mode():
            return fn()
    return call


def _cudnn_backward(x, layers, dh, weights: bool):
    """torch.autograd.grad through cuDNN's backward, the forward run once
    outside the timed calls: the gradient of x (which, through the identity
    input weight, is layer 1's d_pre), and with ``weights`` every weight
    gradient too."""
    lstm = _cudnn_module(layers, x.dtype)
    for p in lstm.parameters():
        p.requires_grad_(weights)
    xg = x.detach().clone().requires_grad_(True)
    out = lstm(xg)[0]
    inputs = [xg] + (list(lstm.parameters()) if weights else [])
    return lambda: torch.autograd.grad(out, inputs, dh, retain_graph=True)


def _as_tuple(t) -> tuple:
    """The tensors of ``t``: a tensor, or nested tuples and lists of them."""
    if torch.is_tensor(t):
        return (t,)
    return tuple(x for part in t for x in _as_tuple(part))


def _max_abs_err(got, want) -> float:
    return max(float((g - w).abs().max())
               for g, w in zip(_as_tuple(got), _as_tuple(want)))


def _largest(want) -> float:
    return max(float(w.abs().max()) for w in _as_tuple(want))


def phase_kernels() -> dict:
    results = {}
    for rows in (100, 800):
        x, w1, wi2, b2, w2 = _kernel_case(rows, seed=rows)
        cases = {
            "lstm_pair_fwd": (
                lambda: lk.lstm_pair_fwd_cuda(x, w1, wi2, b2, w2),
                lambda: lk.lstm_pair_ref(x, w1, wi2, b2, w2),
                _cudnn_forward(x, [(w1,), (w2, wi2, b2)]),
                *cost("lstm_pair_fwd", rows),
            ),
            "lstm_fwd": (
                lambda: lk.lstm_fwd_cuda(x, w1),
                lambda: lk.lstm_recurrence_ref(x, w1),
                _cudnn_forward(x, [(w1,)]),
                *cost("lstm_fwd", rows),
            ),
        }
        with torch.inference_mode():
            for name, (kernel, plain, library, flops, nbytes) in cases.items():
                got = kernel()
                torch.cuda.synchronize()
                want = plain()
                err = float((got - want).abs().max())
                lib_err = float((library() - want).abs().max())
                if name == "lstm_fwd":
                    # The optional c output, held against the plain version.
                    _, cs = lk.lstm_fwd_cuda(x, w1, return_c=True)
                    _, cs_ref = lk.lstm_recurrence_ref(x, w1, return_c=True)
                    err = max(err, float((cs - cs_ref).abs().max()))
                bound_ms, bound_by = bound(flops, nbytes)
                row = {
                    "phase": "kernel",
                    "name": name,
                    "rows": rows,
                    "T": T,
                    "H": H,
                    "max_abs_err": err,
                    "tol": KERNEL_TOL,
                    **timed("ms", kernel),
                    **timed("plain_ms", plain, calls=1, spin=False, iters=3,
                            loops=3, warmup=1),
                    **timed("library_ms", library),
                    "library_max_abs_err": lib_err,
                    "bound_ms": bound_ms,
                    "bound_by": bound_by,
                    "flops": flops,
                    "bytes": nbytes,
                    "peaks": PEAK_SOURCE,
                }
                emit(row)
                if not err <= KERNEL_TOL:
                    raise AssertionError(
                        f"{name} at rows={rows}: max abs err {err} > {KERNEL_TOL}"
                    )
                results[(name, rows)] = row
    return results


def _wgrad_library(dx1, d_pre2, h1s, h2s, mask):
    """The pair's weight gradients as PyTorch computes them: one cuBLAS
    product a weight on the stashes' shifted views (the mask applied once),
    and the bias sum."""
    def rows_of(t):
        return t.reshape(-1, t.shape[-1])

    return lambda: (
        rows_of(h1s[:-1]).T @ rows_of(dx1[1:]),
        rows_of(h1s * mask).T @ rows_of(d_pre2),
        d_pre2.sum(dim=(0, 1)),
        rows_of(h2s[:-1]).T @ rows_of(d_pre2[1:]),
    )


def _training_inputs(rows: int):
    """The kernel case plus a pre-scaled keep-mask (p = 0.2), a cotangent of
    h at every step, and the stashes and d_pre planes the plain versions
    make from them."""
    x, w1, wi2, b2, w2 = _kernel_case(rows, seed=rows)
    rng = np.random.default_rng(rows + 1)
    mask = torch.from_numpy(
        ((rng.random((T, rows, H)) >= 0.2) / 0.8).astype(np.float32)).cuda()
    dh = torch.from_numpy(
        (0.1 * rng.standard_normal((T, rows, H))).astype(np.float32)).cuda()
    with torch.no_grad():
        h2s, h1s, c1s, c2s = lk.lstm_pair_ref(x, w1, wi2, b2, w2, mask,
                                              return_stash=True)
        dx1, d_pre2 = lk.lstm_pair_bwd_ref(dh, x, mask, h1s, c1s, h2s, c2s,
                                           w1, wi2, b2, w2)
        hs, cs = lk.lstm_recurrence_ref(x, w1, return_c=True)
        dx = lk.lstm_bwd_ref(dh, x, hs, cs, w1)
    return dict(x=x, w1=w1, wi2=wi2, b2=b2, w2=w2, mask=mask, dh=dh, h1s=h1s,
                c1s=c1s, h2s=h2s, c2s=c2s, dx1=dx1, d_pre2=d_pre2, hs=hs,
                cs=cs, dx=dx)


def _bf16_inputs(v: dict) -> dict:
    """``_training_inputs``' operands rounded to bf16 (the mask's 0 and 1.25
    are exact), and the stashes and planes the plain bf16 versions make from
    them: h and c stashes and dx1 in bf16, both layers' d_pre in f32."""
    b = {k: v[k].to(torch.bfloat16)
         for k in ("x", "w1", "wi2", "b2", "w2", "mask", "dh")}
    with torch.no_grad():
        b["h2s"], b["h1s"], b["c1s"], b["c2s"] = lk.lstm_pair_ref(
            b["x"], b["w1"], b["wi2"], b["b2"], b["w2"], b["mask"],
            return_stash=True)
        b["dx1"], b["d_pre1"], b["d_pre2"] = lk.lstm_pair_bwd_bf16_ref(
            *_bf16_bwd_args(b))
    return b


def _bf16_bwd_args(b: dict) -> tuple:
    return (b["dh"], b["x"], b["mask"], b["h1s"], b["c1s"], b["h2s"], b["c2s"],
            b["w1"], b["wi2"], b["b2"], b["w2"])


def _bf16_ulp(want: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at each ``|want|`` (8 significant bits)."""
    mag = want.double().abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def _bf16_judge(got, want) -> tuple[float, float, bool, dict]:
    """A bf16 kernel row's check: each bf16 output within one bf16 ulp of
    the plain version's entry (or 1e-6 abs) and at least BF16_EQUAL_SHARE
    of its entries equal; each f32 output (the sweep's d_pre planes)
    within KERNEL_TOL of its largest entry. ``(max abs err, the f32 tol,
    ok, fields)``."""
    ok, err, f32_tol, shares, ulps = True, 0.0, KERNEL_TOL, [], [0.0]
    for g, w in zip(_as_tuple(got), _as_tuple(want)):
        diff = (g.double() - w.double()).abs()
        err = max(err, float(diff.max()))
        if w.dtype == torch.bfloat16:
            ulp = _bf16_ulp(w)
            ok = ok and bool((diff <= torch.clamp(ulp, min=1e-6)).all())
            shares.append(float((diff == 0).double().mean()))
            # In ulps, over the entries beyond the 1e-6 floor.
            ulps.append(float(torch.where(diff > 1e-6, diff / ulp, 0.0).max()))
        else:
            f32_tol = KERNEL_TOL * max(1.0, float(w.abs().max()))
            ok = ok and float(diff.max()) <= f32_tol
    ok = ok and min(shares) >= BF16_EQUAL_SHARE
    return err, f32_tol, ok, {"bf16_equal_share": min(shares),
                              "bf16_max_ulps": max(ulps),
                              "bf16_equal_share_min": BF16_EQUAL_SHARE}


def _measure(name: str, rows: int, kernel, plain, library, same: bool,
             flops: float, nbytes: float, relative: bool, full=None,
             note: str | None = None, check=None, n_t: int = T,
             extra: dict | None = None, loop: dict | None = None,
             judge=None) -> dict:
    """One kernel row: the kernel against its plain version on the same
    inputs, then the kernel's, the plain version's and the library call's
    times, and the bound. ``same`` says whether the library call computes
    the same function (then its own error is reported); ``relative`` holds
    the error to KERNEL_TOL of the largest entry instead of KERNEL_TOL abs;
    ``full`` is the whole cuDNN backward (data and weight gradients);
    ``check`` returns ``(got, want)`` of further outputs to hold; ``extra``
    fields join the row; ``loop`` sets the kernel's and the library's
    timing loops (``cuda_ms``'s keywords); ``judge(got, want)`` replaces
    the error check (``_bf16_judge``)."""
    with torch.no_grad():
        got = kernel()
        torch.cuda.synchronize()
        want = plain()
    judged = {}
    if judge is not None:
        err, tol, ok, judged = judge(got, want)
    else:
        err = _max_abs_err(got, want)
        if check is not None:
            extra_got, extra_want = check()
            err = max(err, _max_abs_err(extra_got, extra_want))
            want = _as_tuple(want) + _as_tuple(extra_want)
        tol = KERNEL_TOL * (max(1.0, _largest(want)) if relative else 1.0)
        ok = err <= tol
    row = {
        "phase": "kernel",
        "name": name,
        "rows": rows,
        "T": n_t,
        "H": H,
        "max_abs_err": err,
        "tol": tol,
        **judged,
        **(extra or {}),
        **timed("ms", kernel, **(loop or {})),
        **timed("plain_ms", plain, calls=1, spin=False, iters=3, loops=3,
                warmup=1),
        **timed("library_ms", library, **(loop or {})),
        "library_same_function": same,
    }
    if note is not None:
        row["library_note"] = note
    if same:
        with torch.no_grad():
            row["library_max_abs_err"] = _max_abs_err(library(), want)
    if full is not None:
        row["library_full_backward_ms"] = cuda_ms(full)[0]
    row["bound_ms"], row["bound_by"] = bound(flops, nbytes)
    row.update({"flops": flops, "bytes": nbytes, "peaks": PEAK_SOURCE})
    emit(row)
    if not ok:
        raise AssertionError(f"{name} at rows={rows}: max abs err {err} "
                             f"(tol {tol}, {judged})")
    return row


def phase_training_kernels() -> dict:
    """The training kernels against their plain versions at the shapes of
    the training path (100 rows: one window a step) and of 8 windows; the
    maskless bf16 forward also at its own path's, a bf16 fit's evaluation
    chunk (EVAL_CHUNK windows, 3,200 rows).

    FLOPs (``cost``, from telemetry/costs.py) count each (rows, H) @ (H, 4H)
    product of a step as 2*H*4H a row:
    3 in the masked pair forward, 6 in the pair's backward sweep (both
    layers' gates, layer 2's input projection, three transposed products),
    3 in the pair's weight-gradient pass, 2 and 1 for the single layer.
    Bytes count each input read once and each output written once."""
    results = {}
    for rows in (100, 800):
        v = _training_inputs(rows)
        x, w1, wi2, b2, w2, mask, dh = (v[k] for k in (
            "x", "w1", "wi2", "b2", "w2", "mask", "dh"))
        pair = [(w1,), (w2, wi2, b2)]
        bwd_args = (dh, x, mask, v["h1s"], v["c1s"], v["h2s"], v["c2s"], w1,
                    wi2, b2, w2)
        wgrad_args = (v["dx1"], v["d_pre2"], v["h1s"], v["h2s"], mask)
        no_mask = "cuDNN takes no seam mask: the maskless pair"
        rows_out = [
            _measure(
                "lstm_pair_fwd_masked", rows,
                lambda: lk.lstm_pair_fwd_cuda(x, w1, wi2, b2, w2, mask,
                                              stash=True),
                lambda: lk.lstm_pair_ref(x, w1, wi2, b2, w2, mask,
                                         return_stash=True),
                _cudnn_forward(x, pair), False,
                *cost("lstm_pair_fwd_masked", rows), False, note=no_mask,
            ),
            # cuDNN's backward gives x's gradient only, held against the
            # sweep's first output; the whole cuDNN backward (data and weight
            # gradients) is timed beside it.
            _measure(
                "lstm_pair_bwd", rows,
                lambda: lk.lstm_pair_bwd_cuda(*bwd_args),
                lambda: lk.lstm_pair_bwd_ref(*bwd_args),
                _cudnn_backward(x, pair, dh, weights=False), False,
                *cost("lstm_pair_bwd", rows), True,
                full=_cudnn_backward(x, pair, dh, weights=True), note=no_mask,
            ),
            _measure(
                "lstm_wgrad", rows,
                lambda: lk.lstm_pair_wgrad(*wgrad_args),
                lambda: lk.lstm_pair_wgrad_ref(*wgrad_args),
                _wgrad_library(*wgrad_args), True,
                *cost("lstm_wgrad", rows), True,
                # The single-layer job of the same pass.
                check=lambda: (lk.lstm_single_wgrad(v["dx"], v["hs"]),
                               lk.lstm_wgrad_ref(v["dx"], v["hs"], 1)),
            ),
            _measure(
                "lstm_bwd", rows,
                lambda: lk.lstm_bwd_cuda(dh, x, v["hs"], v["cs"], w1),
                lambda: lk.lstm_bwd_ref(dh, x, v["hs"], v["cs"], w1),
                _cudnn_backward(x, [(w1,)], dh, weights=False), True,
                *cost("lstm_bwd", rows), True,
                full=_cudnn_backward(x, [(w1,)], dh, weights=True),
            ),
        ]
        rows_out += _bf16_rows(v, rows)
        for row in rows_out:
            results[(row["name"], rows)] = row
    # The maskless bf16 forward's own path: a bf16 fit's validation,
    # fingerprint and test chunks, EVAL_CHUNK windows a launch.
    rows = EVAL_CHUNK * K_STOCKS
    _, w1, wi2, b2, w2 = _kernel_case(1, seed=rows)
    x = torch.randn((T, rows, 4 * H), device=DEVICE,
                    generator=torch.Generator(device=DEVICE).manual_seed(rows))
    x, w1, wi2, b2, w2 = (t.to(torch.bfloat16) for t in (x, w1, wi2, b2, w2))
    results[("lstm_pair_fwd_bf16", rows)] = _bf16_fwd_row(
        rows, (x, w1, wi2, b2, w2), [(w1,), (w2, wi2, b2)])
    return results


def _bf16_fwd_row(rows: int, pair: tuple, layers: list) -> dict:
    """The maskless bf16 pair forward on ``pair`` (x1_proj and the weights,
    bf16) against its plain bf16 version, beside cuDNN's bf16 LSTM on
    ``layers`` under inference mode (a time only)."""
    return _measure(
        "lstm_pair_fwd_bf16", rows,
        lambda: lk.lstm_pair_fwd_cuda(*pair),
        lambda: lk.lstm_pair_ref(*pair),
        _inference(_cudnn_forward(pair[0], layers)), False,
        *cost("lstm_pair_fwd_bf16", rows), False,
        note="cuDNN's bf16 LSTM (no seam mask), a time only",
        judge=_bf16_judge)


def _bf16_rows(v: dict, rows: int) -> list[dict]:
    """The pair's bf16 instances (trainer.precision=bf16-mixed) on the
    training inputs rounded to bf16 (``_bf16_inputs``), each against its
    plain bf16 version (``_bf16_judge``), beside cuDNN's bf16 LSTM (a time
    only) and the bound at itemsize 2."""
    b = _bf16_inputs(v)
    pair = (b["x"], b["w1"], b["wi2"], b["b2"], b["w2"])
    layers = [(b["w1"],), (b["w2"], b["wi2"], b["b2"])]
    wgrad = (b["d_pre1"], b["d_pre2"], b["h1s"], b["h2s"], b["mask"])
    note = "cuDNN's bf16 LSTM (no seam mask), a time only"
    return [
        _bf16_fwd_row(rows, pair, layers),
        _measure(
            "lstm_pair_fwd_masked_bf16", rows,
            lambda: lk.lstm_pair_fwd_cuda(*pair, b["mask"], stash=True),
            lambda: lk.lstm_pair_ref(*pair, b["mask"], return_stash=True),
            _cudnn_forward(b["x"], layers), False,
            *cost("lstm_pair_fwd_masked_bf16", rows), False, note=note,
            judge=_bf16_judge),
        _measure(
            "lstm_pair_bwd_bf16", rows,
            lambda: lk.lstm_pair_bwd_bf16_cuda(*_bf16_bwd_args(b)),
            lambda: lk.lstm_pair_bwd_bf16_ref(*_bf16_bwd_args(b)),
            _cudnn_backward(b["x"], layers, b["dh"], False), False, *cost("lstm_pair_bwd_bf16", rows), True, note=note,
            judge=_bf16_judge),
        _measure(
            "lstm_wgrad_bf16", rows,
            lambda: lk.lstm_pair_wgrad(*wgrad),
            lambda: lk.lstm_pair_wgrad_ref(*wgrad),
            _wgrad_library(b["d_pre1"], b["d_pre2"], b["h1s"].float(),
                           b["h2s"].float(), b["mask"].float()), False,
            *cost("lstm_wgrad_bf16", rows), True,
            note="cuBLAS f32 products on the stashes' values, unrounded",
            judge=_bf16_judge),
    ]


# ------------------------------------------------------------ stack kernels


def _stack_inputs(n_layers: int, rows: int, seed: int) -> dict:
    """An L-deep stack at T=60, H=64: x1_proj, the weights, pre-scaled
    keep-masks (p = 0.3, model=medium's dropout), a cotangent of the top
    layer's h, and the stashes and d_pre planes the plain versions make."""
    rng = np.random.default_rng(seed)
    scale = 1.0 / np.sqrt(H)

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(DEVICE)

    v = {
        "x": t(rng.standard_normal((T, rows, 4 * H))),
        "w_hh": [t(rng.uniform(-scale, scale, (H, 4 * H)))
                 for _ in range(n_layers)],
        "w_in": [t(rng.uniform(-scale, scale, (H, 4 * H)))
                 for _ in range(n_layers - 1)],
        "biases": [t(rng.uniform(-scale, scale, (4 * H,)))
                   for _ in range(n_layers - 1)],
        "masks": [t((rng.random((T, rows, H)) >= 0.3) / 0.7)
                  for _ in range(n_layers - 1)],
        "dh": t(0.1 * rng.standard_normal((T, rows, H))),
    }
    weights = (v["w_hh"], v["w_in"], v["biases"])
    with torch.no_grad():
        v["hs"], v["cs"] = lk.lstm_stack_ref(v["x"], *weights, v["masks"],
                                             return_stash=True)
        v["d_pres"] = lk.lstm_stack_bwd_ref(v["dh"], v["x"], v["masks"],
                                            v["hs"], v["cs"], *weights)
    v["layers"] = [(v["w_hh"][0],)] + list(zip(v["w_hh"][1:], v["w_in"],
                                               v["biases"]))
    return v


def _stack_wgrad_library(d_pres, hs, masks):
    """The stack's weight gradients as PyTorch computes them: one cuBLAS
    product a job on the stashes' shifted views (the mask applied once), and
    the bias sums."""
    def rows_of(t):
        return t.reshape(-1, t.shape[-1])

    n = len(d_pres)
    return lambda: (
        [rows_of(hs[l][:-1]).T @ rows_of(d_pres[l][1:]) for l in range(n)]
        + [rows_of(hs[l - 1] * masks[l - 1]).T @ rows_of(d_pres[l])
           for l in range(1, n)]
        + [d_pres[l].sum(dim=(0, 1)) for l in range(1, n)]
    )


def phase_stack_kernels() -> dict:
    """The stack kernels at model=medium's depth against their plain versions
    at one 25-row window (training, serving bucket 1) and at 8 windows
    (serving's bucket 8, 200 rows).

    FLOPs per row and step, each (rows, H) @ (H, 4H) product 2*H*4H: 2L - 1
    products forward (L recurrent, L - 1 seam projections), 4L - 2 in the
    backward sweep (the recomputed gates and the transposed products), 2L - 1
    in the weight-gradient pass. Bytes: each input read once, each output
    written once."""
    results = {}
    n = STACK_LAYERS
    for rows in (K_MEDIUM, 8 * K_MEDIUM):
        v = _stack_inputs(n, rows, seed=rows)
        x, masks, dh = v["x"], v["masks"], v["dh"]
        weights = (v["w_hh"], v["w_in"], v["biases"])
        bwd_args = (dh, x, masks, v["hs"], v["cs"], *weights)
        wgrad_args = (v["d_pres"], v["hs"], masks)
        no_mask = "cuDNN takes no seam mask: the maskless stack"
        dev = torch.device(DEVICE)

        def tile(backward, masked, stash=False):
            return {"tile": lk.lstm_stack_row_tile_cuda(
                n, rows, H, dev, backward, masked, stash)}

        rows_out = [
            _measure(
                "lstm_stack_fwd", rows,
                lambda: lk.lstm_stack_fwd_cuda(x, *weights),
                lambda: lk.lstm_stack_ref(x, *weights),
                _inference(_cudnn_forward(x, v["layers"])), True,
                *cost("lstm_stack_fwd", rows, n_layers=n), False,
                extra=tile(False, False),
            ),
            _measure(
                "lstm_stack_fwd_masked", rows,
                lambda: lk.lstm_stack_fwd_cuda(x, *weights, masks, stash=True),
                lambda: lk.lstm_stack_ref(x, *weights, masks, return_stash=True),
                _cudnn_forward(x, v["layers"]), False,
                *cost("lstm_stack_fwd_masked", rows, n_layers=n), False,
                note=no_mask, extra=tile(False, True, stash=True),
            ),
            _measure(
                "lstm_stack_bwd", rows,
                lambda: lk.lstm_stack_bwd_cuda(*bwd_args),
                lambda: lk.lstm_stack_bwd_ref(*bwd_args),
                _cudnn_backward(x, v["layers"], dh, weights=False), False,
                *cost("lstm_stack_bwd", rows, n_layers=n), True,
                full=_cudnn_backward(x, v["layers"], dh, weights=True),
                note=no_mask, extra=tile(True, True),
            ),
            _measure(
                "lstm_wgrad_stack", rows,
                lambda: lk.lstm_stack_wgrad(*wgrad_args),
                lambda: lk.lstm_stack_wgrad_ref(*wgrad_args),
                _stack_wgrad_library(*wgrad_args), True,
                *cost("lstm_wgrad_stack", rows, n_layers=n), True,
            ),
        ]
        for row in rows_out:
            results[(row["name"], rows)] = row
    return results


def phase_stack_depths() -> list[dict]:
    """The other depths the encoder runs (3 at a 3-layer model, 7 and 8 at
    model=large) at one 25-row window: every stack kernel against its plain
    version, correctness only."""
    out = []
    for n in (3, 7, 8):
        v = _stack_inputs(n, K_MEDIUM, seed=100 + n)
        weights = (v["w_hh"], v["w_in"], v["biases"])
        masks = v["masks"]
        bwd_args = (v["dh"], v["x"], masks, v["hs"], v["cs"], *weights)
        with torch.no_grad():
            checks = {
                "lstm_stack_fwd": (lk.lstm_stack_fwd_cuda(v["x"], *weights),
                                   lk.lstm_stack_ref(v["x"], *weights), False),
                "lstm_stack_fwd_masked": (
                    lk.lstm_stack_fwd_cuda(v["x"], *weights, masks, stash=True),
                    (v["hs"], v["cs"]), False),
                "lstm_stack_bwd": (lk.lstm_stack_bwd_cuda(*bwd_args),
                                   v["d_pres"], True),
                "lstm_wgrad_stack": (
                    lk.lstm_stack_wgrad(v["d_pres"], v["hs"], masks),
                    lk.lstm_stack_wgrad_ref(v["d_pres"], v["hs"], masks), True),
            }
        torch.cuda.synchronize()
        errs, tols = {}, {}
        for name, (got, want, relative) in checks.items():
            got, want = _as_tuple(got), _as_tuple(want)
            errs[name] = _max_abs_err(got, want)
            tols[name] = KERNEL_TOL * (max(1.0, _largest(want)) if relative else 1.0)
        dev = torch.device(DEVICE)
        row = {"phase": "stack_check", "n_layers": n, "rows": K_MEDIUM, "T": T,
               "H": H, "max_abs_err": errs, "tol": tols,
               "tile": {"lstm_stack_fwd": lk.lstm_stack_row_tile_cuda(
                            n, K_MEDIUM, H, dev, False, False),
                        "lstm_stack_bwd": lk.lstm_stack_row_tile_cuda(
                            n, K_MEDIUM, H, dev, True, True)}}
        emit(row)
        bad = {k: e for k, e in errs.items() if not e <= tols[k]}
        if bad:
            raise AssertionError(f"{n}-deep stack differs from plain: {bad}")
        out.append(row)
    return out


def phase_stack_vs_pairs() -> list[dict]:
    """Device time (``spin_ms``) of one 4-deep stack forward against the
    same 4 layers as pair + pair (the port's own kernels and the seam
    projection between them, maskless, the same weights), at 25 and 100
    rows, with the profiler's operations of each. A measurement for a later
    routing decision: the encoder follows the reference's grouping."""
    out = []
    for rows in (K_MEDIUM, 100):
        v = _stack_inputs(STACK_LAYERS, rows, seed=200 + rows)
        x, (w0, w1, w2, w3), (i1, i2, i3), (b1, b2, b3) = (
            v["x"], v["w_hh"], v["w_in"], v["biases"])

        def pairs():
            low = lk.lstm_pair_fwd_cuda(x, w0, i1, b1, w1)
            return lk.lstm_pair_fwd_cuda(torch.matmul(low, i2) + b2, w2, i3, b3, w3)

        def stack():
            return lk.lstm_stack_fwd_cuda(x, v["w_hh"], v["w_in"], v["biases"])

        with torch.no_grad():
            diff = _max_abs_err(stack(), pairs())
            row = {"phase": "stack_vs_pairs", "rows": rows, "n_layers": STACK_LAYERS,
                   "max_abs_diff": diff}
            for name, fn in (("stack", stack), ("pair_pair", pairs)):
                row[name] = {"device_ms": spin_ms(fn), "ops": device_ops(fn)}
        emit(row)
        if not diff <= KERNEL_TOL:
            raise AssertionError(f"stack and pair + pair differ: {diff}")
        out.append(row)
    return out


# ------------------------------------------------------ the stack in bf16

#: The shapes a bf16 fit launches the stack's bf16 instances at (T=60,
#: H=64): (depth, rows, training). model=medium groups [4] over one
#: 100-row window (the masked forward with its stashes, the sweep, the pass
#: over 7 jobs) and over an evaluation chunk of EVAL_CHUNK windows (the
#: maskless forward); model=large groups [8] over one 25-row window (the
#: pass over 15 jobs) and its chunk, and [6, 2] over a chunk of 100-row
#: windows.
BF16_STACK_ROWS = ("lstm_stack_fwd_bf16", "lstm_stack_fwd_masked_bf16",
                   "lstm_stack_bwd_bf16", "lstm_wgrad_stack_bf16")
BF16_STACK_SHAPES = ((4, K_STOCKS, True), (4, EVAL_CHUNK * K_STOCKS, False),
                     (8, K_MEDIUM, True), (8, EVAL_CHUNK * K_MEDIUM, False),
                     (6, EVAL_CHUNK * K_STOCKS, False))


def _bf16_stack_inputs(n_layers: int, rows: int, seed: int, training: bool,
                       bf16: bool = True) -> dict:
    """An L-deep stack at T=60, H=64 drawn on the card (the scales of
    ``_stack_inputs``) and rounded to bf16: under ``"f32"`` its operands'
    values in f32 (and with ``training`` the masks, p = 0.3, a cotangent of
    the top layer's h and the f32 stashes and d_pre planes); with ``bf16``
    the bf16 operands, and with ``training`` the planes the plain bf16
    versions make: h and c stashes and dx1 in bf16, every d_pre in f32 (a
    parent checkout without the bf16 stack asks for none, ``--ab``)."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    scale = 1.0 / np.sqrt(H)

    def draw(shape, kind="normal"):
        if kind == "uniform":
            t = (torch.rand(shape, device=DEVICE, generator=gen) * 2 - 1) * scale
        elif kind == "mask":
            t = (torch.rand(shape, device=DEVICE, generator=gen) >= 0.3) / 0.7
        else:
            t = torch.randn(shape, device=DEVICE, generator=gen)
        return t.to(torch.bfloat16).float()

    f = {"x": draw((T, rows, 4 * H)),
         "weights": ([draw((H, 4 * H), "uniform") for _ in range(n_layers)],
                     [draw((H, 4 * H), "uniform") for _ in range(n_layers - 1)],
                     [draw((4 * H,), "uniform") for _ in range(n_layers - 1)])}
    if training:
        f["masks"] = [draw((T, rows, H), "mask") for _ in range(n_layers - 1)]
        f["dh"] = (0.1 * draw((T, rows, H))).to(torch.bfloat16).float()
        with torch.no_grad():
            f["hs"], f["cs"] = lk.lstm_stack_ref(f["x"], *f["weights"],
                                                 f["masks"], return_stash=True)
            f["d_pres"] = lk.lstm_stack_bwd_ref(*_bf16_stack_bwd_args(f))
    v = {"f32": f}
    if bf16:
        def low(t):
            return t.to(torch.bfloat16)

        v["x"] = low(f["x"])
        v["weights"] = tuple([low(t) for t in group] for group in f["weights"])
        w_hh, w_in, biases = v["weights"]
        v["layers"] = [(w_hh[0],)] + list(zip(w_hh[1:], w_in, biases))
        if training:
            v["masks"] = [low(m) for m in f["masks"]]
            v["dh"] = low(f["dh"])
            with torch.no_grad():
                v["hs"], v["cs"] = lk.lstm_stack_ref(v["x"], *v["weights"],
                                                     v["masks"], return_stash=True)
                v["dx1"], v["d_pres"] = lk.lstm_stack_bwd_bf16_ref(
                    *_bf16_stack_bwd_args(v))
    return v


def _bf16_stack_bwd_args(v: dict) -> tuple:
    return (v["dh"], v["x"], v["masks"], v["hs"], v["cs"], *v["weights"])


def phase_stack_bf16_kernels() -> dict:
    """The stack's bf16 instances (trainer.precision=bf16-mixed) at
    ``BF16_STACK_SHAPES``, each against its plain bf16 version
    (``_bf16_judge``: every bf16 entry within one bf16 ulp, at least 99%
    equal; the sweep's f32 d_pre planes as the f32 sweep's), beside cuDNN's
    bf16 LSTM (a time only) and the bound at itemsize 2; each row with the
    row tile its launch takes. ``{(name, rows, depth): row}``."""
    results = {}
    note = "cuDNN's bf16 LSTM (no seam mask), a time only"
    dev = torch.device(DEVICE)
    for n, rows, training in BF16_STACK_SHAPES:
        v = _bf16_stack_inputs(n, rows, seed=300 + n + rows, training=training)
        x, weights = v["x"], v["weights"]

        def tile(backward, masked, stash=False):
            return {"n_layers": n, "tile": lk.lstm_stack_row_tile_cuda(
                n, rows, H, dev, backward, masked, stash, dtype=torch.bfloat16)}

        def stack_cost(name):
            return cost(name, rows, n_layers=n)

        measured = [_measure(
            "lstm_stack_fwd_bf16", rows,
            lambda: lk.lstm_stack_fwd_cuda(x, *weights),
            lambda: lk.lstm_stack_ref(x, *weights),
            _inference(_cudnn_forward(x, v["layers"])), False,
            *stack_cost("lstm_stack_fwd_bf16"), False, note=note,
            extra=tile(False, False), judge=_bf16_judge)]
        if training:
            masks = v["masks"]
            wgrad = (v["d_pres"], v["hs"], masks)
            measured += [
                _measure(
                    "lstm_stack_fwd_masked_bf16", rows,
                    lambda: lk.lstm_stack_fwd_cuda(x, *weights, masks, stash=True),
                    lambda: lk.lstm_stack_ref(x, *weights, masks, return_stash=True),
                    _cudnn_forward(x, v["layers"]), False,
                    *stack_cost("lstm_stack_fwd_masked_bf16"), False, note=note,
                    extra=tile(False, True, stash=True), judge=_bf16_judge),
                _measure(
                    "lstm_stack_bwd_bf16", rows,
                    lambda: lk.lstm_stack_bwd_bf16_cuda(*_bf16_stack_bwd_args(v)),
                    lambda: lk.lstm_stack_bwd_bf16_ref(*_bf16_stack_bwd_args(v)),
                    _cudnn_backward(x, v["layers"], v["dh"], weights=False),
                    False, *stack_cost("lstm_stack_bwd_bf16"), True, note=note,
                    extra=tile(True, True), judge=_bf16_judge),
                _measure(
                    "lstm_wgrad_stack_bf16", rows,
                    lambda: lk.lstm_stack_wgrad(*wgrad),
                    lambda: lk.lstm_stack_wgrad_ref(*wgrad),
                    _stack_wgrad_library(v["d_pres"], [h.float() for h in v["hs"]],
                                         [m.float() for m in masks]), False,
                    *stack_cost("lstm_wgrad_stack_bf16"), True,
                    note="cuBLAS f32 products on the stashes' values, unrounded",
                    extra={"n_layers": n, "jobs": 2 * n - 1}, judge=_bf16_judge),
            ]
        for row in measured:
            results[(row["name"], rows, n)] = row
        del v
    return results


# -------------------------------------------------- time-blocked kernels


def _long_inputs(rows: int, seed: int) -> dict:
    """One layer at T=252, H=64: x_proj, the weight, a cotangent of h at
    every step, and the stashes the plain forward makes."""
    rng = np.random.default_rng(seed)
    scale = 1.0 / np.sqrt(H)

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(DEVICE)

    v = {"x": t(rng.standard_normal((T_LONG, rows, 4 * H))),
         "w": t(rng.uniform(-scale, scale, (H, 4 * H))),
         "dh": t(0.1 * rng.standard_normal((T_LONG, rows, H)))}
    dev = torch.device(DEVICE)
    v["fwd_chunk"] = lk.lstm_tb_time_chunk_cuda(T_LONG, rows, H, dev, False)
    v["bwd_chunk"] = lk.lstm_tb_time_chunk_cuda(T_LONG, rows, H, dev, True)
    with torch.no_grad():
        v["hs"], v["cs"] = lk.lstm_tb_fwd_ref(v["x"], v["w"], v["fwd_chunk"])
    return v


def _cudnn_backward_hh(x, w, dh):
    """torch.autograd.grad through cuDNN's one-layer backward for x and the
    recurrent weight, the forward run once outside the timed calls: x's
    gradient (layer 0's d_pre, through the identity input weight) and
    dW_hh, transposed to the kernels' (H, 4H)."""
    lstm = _cudnn_module([(w,)])
    for p in lstm.parameters():
        p.requires_grad_(p is lstm.weight_hh_l0)
    xg = x.detach().clone().requires_grad_(True)
    out = lstm(xg)[0]

    def call():
        gx, gw = torch.autograd.grad(out, [xg, lstm.weight_hh_l0], dh,
                                     retain_graph=True)
        return gx, gw.T
    return call


def phase_tblocked_kernels() -> dict:
    """The time-blocked kernels against their plain versions at a one-year
    lookback (T=252, H=64), on one 100-row window (training) and on 800
    rows (serving's bucket 8), each beside the resident kernels on the same
    inputs (``resident_ms``: lstm_fwd; lstm_bwd and the single weight-
    gradient job) and cuDNN.

    FLOPs: one (rows, H) @ (H, 4H) product a step forward, three backward
    (the recomputed gates, the transposed product, the dw update). Bytes:
    each input read once, each output written once (dw the summed
    (H, 4H))."""
    results = {}
    for rows in (100, 800):
        v = _long_inputs(rows, seed=rows)
        x, w, dh, hs, cs = (v[k] for k in ("x", "w", "dh", "hs", "cs"))
        with torch.no_grad():
            # The resident and time-blocked kernels run one step on one
            # tile, forward and backward, so they agree bit for bit.
            tb_hc = lk.lstm_tb_fwd_cuda(x, w, return_c=True)
            resident_hc = lk.lstm_fwd_cuda(x, w, return_c=True)
            same_as_resident = (
                all(map(torch.equal, tb_hc, resident_hc)),
                torch.equal(lk.lstm_tb_bwd_cuda(dh, x, hs, cs, w)[0],
                            lk.lstm_bwd_cuda(dh, x, hs, cs, w)))
            resident_gap = _max_abs_err(tb_hc, resident_hc)

        def resident_bwd():
            dx = lk.lstm_bwd_cuda(dh, x, hs, cs, w)
            return dx, lk.lstm_single_wgrad(dx, hs)

        rows_out = [
            _measure(
                "lstm_tb_fwd", rows,
                lambda: lk.lstm_tb_fwd_cuda(x, w),
                lambda: lk.lstm_tb_fwd_ref(x, w, v["fwd_chunk"])[0],
                _inference(_cudnn_forward(x, [(w,)])), True,
                *cost("lstm_tb_fwd", rows, T_LONG), False,
                check=lambda: (lk.lstm_tb_fwd_cuda(x, w, return_c=True)[1], cs),
                n_t=T_LONG,
                extra={"time_chunk": v["fwd_chunk"],
                       "bit_equal_to_resident": same_as_resident[0],
                       "max_abs_diff_to_resident": resident_gap,
                       **timed("resident_ms", lambda: lk.lstm_fwd_cuda(x, w))},
            ),
            _measure(
                "lstm_tb_bwd", rows,
                lambda: lk.lstm_tb_bwd_cuda(dh, x, hs, cs, w),
                lambda: lk.lstm_tb_bwd_ref(dh, x, hs, cs, w, v["bwd_chunk"],
                                           lk._row_tile(rows)),
                _cudnn_backward_hh(x, w, dh), True,
                *cost("lstm_tb_bwd", rows, T_LONG), True,
                note="cuDNN's weight backward also forms the identity input "
                     "weight's (4H, 4H) gradient and the biases'",
                n_t=T_LONG,
                extra={"time_chunk": v["bwd_chunk"],
                       "dx_bit_equal_to_resident": same_as_resident[1],
                       **timed("resident_ms", resident_bwd)},
            ),
        ]
        for row in rows_out:
            results[(row["name"], rows)] = row
        # The single-layer forwards, and the sweeps, run one step on one
        # tile: a route between them changes time, not results.
        if not same_as_resident[0]:
            raise AssertionError(
                f"lstm_tb_fwd at rows={rows}: h or c differs from lstm_fwd's "
                f"(max abs diff {resident_gap})")
        if not same_as_resident[1]:
            raise AssertionError(
                f"lstm_tb_bwd at rows={rows}: dx differs from lstm_bwd's")
    return results


# ----------------------------------------------------------------- serving


def _synthetic_windows(stocks: int = K_STOCKS, lookback: int = T,
                       stride: int = 90) -> np.ndarray:
    """configs/datamodule/synthetic.yaml windows: lookback 60, target 30,
    stride 90 (or ``lookback`` and ``stride``), interaction-only features,
    from ``stocks`` stocks x 20,000 samples."""
    r_stocks, r_market, _, _ = SyntheticLogReturns.generate(
        stocks, 20_000, seed=0
    )
    x, _ = lookback_target_split(
        torch.from_numpy(r_stocks), torch.from_numpy(r_market),
        lookback_window=lookback, target_window=30, stride=stride,
    )
    return add_quadratic_features(x, interaction_only=True).numpy()


def _routes(module, n_t: int, rows: int, has_mask: bool,
            window_rows: int | None) -> list:
    """The route of each layer group of a forward: ``stack``, ``pair``, or
    the reference's single-layer route."""
    return [lk.single_layer_route(n_t, rows, H, window_rows) if depth == 1
            else ("pair" if depth == 2 else "stack")
            for depth in module.layer_groups(n_t, rows, has_mask, window_rows)]


def _small_spec(num_layers: int = 2):
    # configs/model/small.yaml: H=64, 2 layers, dropout 0.2, 3 inputs.
    return ModelSpec(
        objective="mse", input_size=3, hidden_size=H, num_layers=num_layers,
        dropout=0.2,
    )


def _medium_spec(num_layers: int = STACK_LAYERS, dropout: float = 0.3):
    # configs/model/medium.yaml (large.yaml with 8 layers): H=64, dropout
    # 0.3, 3 inputs, with configs/loss/mse.yaml.
    return ModelSpec(
        objective="mse", input_size=3, hidden_size=H, num_layers=num_layers,
        dropout=dropout, learning_rate=LR, weight_decay=WD,
    )


def _engines(spec, seed: int, stocks: int = K_STOCKS, lookback: int = T):
    """The engine on the card (a CUDA graph a bucket), the same engine run
    eagerly on the card (``cuda_graphs=False``) and on the CPU."""
    state = spec.build_module(
        device="cpu", generator=torch.Generator().manual_seed(seed)
    ).state_dict()
    kw = dict(n_stocks=stocks, lookback=lookback, n_features=3,
              buckets=(1, 2, 4, 8))
    return (
        PredictEngine(spec, state, device=DEVICE, **kw),
        PredictEngine(spec, state, device="cpu", **kw),
        PredictEngine(spec, state, device=DEVICE, cuda_graphs=False, **kw),
    )


def _max_err(got, want) -> float:
    return float(max(np.abs(g - w).max() for g, w in zip(got, want)))


def _burst(engine, windows: np.ndarray, telemetry=None,
           quality_monitor=None) -> tuple[list, list, dict, float]:
    """Bursts of requests through a PredictServer on ``engine`` (with
    ``telemetry`` and ``quality_monitor``, if given): the responses, the
    windows sent, the server's stats and the seconds."""
    server = PredictServer(engine, max_wait_s=0.002, telemetry=telemetry,
                           quality_monitor=quality_monitor)
    bursts = (1, 2, 4, 8, 3, 8, 5, 1, 6, 8, 2, 7, 4, 1, 8)
    sent, responses = [], []
    server.start()
    t0 = time.perf_counter()
    try:
        for burst in bursts:
            idx = [(len(sent) + i) % len(windows) for i in range(burst)]
            pending = [server.submit(windows[i], deadline_s=5.0) for i in idx]
            responses += [p.result(timeout=60.0) for p in pending]
            sent += idx
        serve_s = time.perf_counter() - t0
    finally:
        stats = server.stop()
    return responses, sent, stats, serve_s


def _bucket_gaps(graphed, eager, windows: np.ndarray) -> dict:
    """Each bucket's graph against the eager engine on the same batch, full
    and, below the bucket, padded: the largest difference (0 when
    bit-equal)."""
    gaps = {}
    for n in (1, 2, 3, 4, 5, 8):
        x = windows[:n]
        gaps[n] = _max_err(graphed.predict(x), eager.predict(x))
    return gaps


def _serve(spec, windows: np.ndarray, stocks: int, phase: str, model: str,
           kernel: str, absent: tuple = ()) -> dict:
    """Bursts of requests through PredictServer on the card, each bucket a
    CUDA graph, every answer held against the CPU engine; each bucket's
    graph bit-equal to the eager engine; the same bursts through the eager
    engine for its latencies. ``kernel`` must launch, ``absent`` must
    not."""
    lookback = windows.shape[2]
    gpu, cpu, eager = _engines(spec, seed=0, stocks=stocks, lookback=lookback)
    lk.reset_launch_counts()
    responses, sent, stats, serve_s = _burst(gpu, windows)
    launches = dict(lk.LAUNCHES)
    _, _, eager_stats, eager_s = _burst(eager, windows)

    statuses = [r.status for r in responses]
    if any(not r.ok for r in responses):
        raise AssertionError(f"not every response is ok: {statuses}")
    alpha = np.stack([r.outputs[0] for r in responses])
    beta = np.stack([r.outputs[1] for r in responses])
    if not (np.isfinite(alpha).all() and np.isfinite(beta).all()):
        raise AssertionError("non-finite served outputs")
    ref_a, ref_b = [], []
    for i in range(0, len(sent), 8):
        a, b = cpu.predict(windows[sent[i:i + 8]])
        ref_a.append(a)
        ref_b.append(b)
    err = _max_err((alpha, beta), (np.concatenate(ref_a), np.concatenate(ref_b)))
    gaps = _bucket_gaps(gpu, eager, windows)
    buckets = sorted({gpu.bucket_for(n) for n in stats["batch_size_counts"]})
    out = {
        "phase": phase,
        "model": model,
        "stocks": stocks,
        "lookback": lookback,
        "layer_groups": {b: gpu._module.layer_groups(lookback, b * stocks, False,
                                                     stocks)
                         for b in buckets},
        "routes": {b: _routes(gpu._module, lookback, b * stocks, False, stocks)
                   for b in buckets},
        "requests": len(responses),
        "ok": statuses.count("ok"),
        "max_abs_err_vs_cpu": err,
        "tol": SERVE_TOL,
        "graphed_vs_eager_max_abs_gap": gaps,
        "compile_events": gpu.compile_events,
        "late_deliveries": stats["late_deliveries"],
        "dispatches": stats["dispatches"],
        "buckets_used": buckets,
        "p50_ms": stats["p50_ms"],
        "p99_ms": stats["p99_ms"],
        "answers_per_s": len(responses) / serve_s,
        "eager": {"p50_ms": eager_stats["p50_ms"], "p99_ms": eager_stats["p99_ms"],
                  "answers_per_s": len(responses) / eager_s,
                  "late_deliveries": eager_stats["late_deliveries"]},
        "launches": launches,
    }
    emit(out)
    if not err <= SERVE_TOL:
        raise AssertionError(f"served answers differ from the CPU engine: {err}")
    if any(gaps.values()):
        raise AssertionError(f"a bucket's graph differs from the eager engine: "
                             f"{gaps}")
    if gpu.compile_events != len(gpu.buckets):
        raise AssertionError(f"{gpu.compile_events} buckets captured, not "
                             f"{len(gpu.buckets)}")
    if stats["late_deliveries"] != 0:
        raise AssertionError(f"late deliveries: {stats['late_deliveries']}")
    if launches[kernel] < stats["dispatches"]:
        raise AssertionError(f"{kernel} launched {launches[kernel]} times for "
                             f"{stats['dispatches']} dispatches")
    if any(launches[name] for name in absent):
        raise AssertionError(f"the serving path launched one of {absent}: "
                             f"{launches}")
    if len(responses) < 32 or len(buckets) < 2:
        raise AssertionError(f"too little traffic: {len(responses)}, {buckets}")
    return out


def phase_serve(windows: np.ndarray) -> dict:
    return _serve(_small_spec(), windows, K_STOCKS, "serve", "small",
                  "lstm_pair_fwd")


def phase_serve_medium(windows: np.ndarray) -> dict:
    """model=medium on 25-stock windows: every request through the maskless
    4-deep stack, no pair kernel."""
    return _serve(_medium_spec(), windows, K_MEDIUM, "serve_medium", "medium",
                  "lstm_stack_fwd", absent=("lstm_pair_fwd", "lstm_fwd"))


def phase_serve_long(windows: np.ndarray) -> dict:
    """model=small at a 252-day lookback: every layer alone through the
    time-blocked forward at every bucket, no resident kernel."""
    return _serve(_small_spec(), windows, K_STOCKS, "serve_long", "small",
                  "lstm_tb_fwd", absent=("lstm_fwd", "lstm_pair_fwd"))


def phase_odd_layers(windows: np.ndarray) -> dict:
    gpu, cpu, eager = _engines(_small_spec(num_layers=3), seed=1)
    batch = windows[:8]
    lk.reset_launch_counts()
    got = gpu.predict(batch)
    launches = dict(lk.LAUNCHES)
    err = _max_err(got, cpu.predict(batch))
    gaps = _bucket_gaps(gpu, eager, windows)
    out = {
        "phase": "odd_layers",
        "num_layers": 3,
        "windows": len(batch),
        "layer_groups": gpu._module.layer_groups(T, 8 * K_STOCKS, False, K_STOCKS),
        "max_abs_err_vs_cpu": err,
        "tol": SERVE_TOL,
        "graphed_vs_eager_max_abs_gap": gaps,
        "launches": launches,
    }
    emit(out)
    if not err <= SERVE_TOL:
        raise AssertionError(f"3-layer encoder differs from the CPU: {err}")
    if any(gaps.values()):
        raise AssertionError(f"a bucket's graph differs from the eager engine: "
                             f"{gaps}")
    if launches["lstm_fwd"] < 1 or launches["lstm_pair_fwd"] < 1:
        raise AssertionError(f"3-layer path missed a kernel: {launches}")
    return out


def phase_breakdown(windows: np.ndarray) -> list[dict]:
    """Where one predict call's time goes, at buckets 1 and 8, for the
    graphed engine and the eager one: host wall clock per call (numpy in,
    numpy out, so it ends synchronized) beside the device time by kernel
    from a torch.profiler trace of 10 calls."""
    gpu, _, eager = _engines(_small_spec(), seed=0)
    rows = []
    for bucket in (1, 8):
        x = windows[:bucket]
        row = {"phase": "breakdown", "bucket": bucket, "rows": bucket * K_STOCKS}
        for name, engine in (("graphed", gpu), ("eager", eager)):
            host, busy_ms, device = _wall_and_device(lambda: engine.predict(x))
            row[name] = {
                "predict_wall_ms_p50": host["wall_ms_p50"],
                "predict_wall_ms_spread": host["wall_ms_spread"],
                "host_probe_ms_p50": host["host_probe_ms_p50"],
                "host_probe_ms_spread": host["host_probe_ms_spread"],
                "device_busy_ms": busy_ms,
                "device_idle_share": 1.0 - busy_ms / host["wall_ms_p50"],
                "device_ms_by_kernel": device[:8],
            }
        emit(row)
        rows.append(row)
    return rows


def _wall_and_device(call, calls: int = 10):
    """Host clock over 30 calls of ``call`` (each ends synchronized), after
    3 warm-up calls, each followed by a ``host_probe_ms``: the wall ms
    median and spread ``[min, max]``, and the probe's; then the device time
    per call by kernel from a torch.profiler trace of ``calls`` calls:
    ``(host, busy_ms, [{name, ms}, ...])``."""
    for _ in range(3):
        call()
    walls, probes = [], []
    for _ in range(30):
        t0 = time.perf_counter()
        call()
        walls.append(1e3 * (time.perf_counter() - t0))
        probes.append(host_probe_ms())
    host = {
        "wall_ms_p50": float(np.median(walls)),
        "wall_ms_spread": [min(walls), max(walls)],
        "host_probe_ms_p50": float(np.median(probes)),
        "host_probe_ms_spread": [min(probes), max(probes)],
    }
    device = device_ops(call, calls)
    return host, sum(op["ms"] for op in device), device


# ---------------------------------------------------------------- training


def _train_datamodule(stocks: int = K_STOCKS, lookback: int = T,
                      stride: int = 90) -> FinancialWindowDataModule:
    """configs/datamodule/synthetic.yaml windows (lookback 60, target 30,
    stride 90, interaction-only, batch_size 1; or ``lookback`` and
    ``stride``) from ``stocks`` stocks x 200,000 samples of the DGP with
    dgp_seed 0, generated next to this script."""
    t0 = time.perf_counter()
    root = data_dir(stocks)
    bootstrap_synthetic(root, n_stocks=stocks, n_samples=TRAIN_SAMPLES, seed=0)
    dm = FinancialWindowDataModule(root, lookback_window=lookback,
                                   target_window=30, stride=stride, batch_size=1)
    dm.prepare_data()
    dm.setup()
    emit({"phase": "train_data", "seconds": time.perf_counter() - t0,
          "lookback": lookback, "stride": stride,
          "windows": {"train": len(dm.train_range), "val": len(dm.val_range),
                      "test": len(dm.test_range)},
          "stocks": stocks, "samples": TRAIN_SAMPLES})
    return dm


def _train_spec(num_layers: int = 2, dropout: float = 0.2) -> ModelSpec:
    # configs/model/small.yaml with configs/loss/mse.yaml.
    return ModelSpec(objective="mse", input_size=3, hidden_size=H,
                     num_layers=num_layers, dropout=dropout,
                     learning_rate=LR, weight_decay=WD)


def _run_steps(spec, state, batches, device, masks=None, before=None,
               compute_dtype=torch.float32):
    """``len(batches)`` train_step updates of a model with ``state`` on
    ``device`` in ``compute_dtype``: per-step losses, per-step flat
    gradients (CPU) and the final parameters (CPU). ``before``, a list,
    gets each step's starting weights (CPU)."""
    module = spec.build_module(device=device, compute_dtype=compute_dtype)
    module.load_state_dict(state)
    optimizer = make_optimizer(module, CLIP, spec.weight_decay)
    loss_fn = batched_objective(spec.window_objective())
    losses, grads = [], []
    for i, arrays in enumerate(batches):
        if before is not None:
            before.append({k: v.detach().cpu().clone()
                           for k, v in module.state_dict().items()})
        batch = Batch(*(torch.from_numpy(a).to(device) for a in arrays))
        step_masks = None if masks is None else [m.to(device) for m in masks[i]]
        sums = train_step(module, optimizer, loss_fn, batch, spec.learning_rate,
                          masks=step_masks)
        losses.append(float(sums["total"][0] / sums["total"][1]))
        grads.append(optimizer.grads.detach().cpu().clone())
    state = {k: v.detach().cpu() for k, v in module.state_dict().items()}
    return losses, grads, state, module


def _grad_gap(got: list, want: list) -> float:
    """Largest gradient difference of any step, relative to that step's
    largest entry."""
    return max(float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
               for g, w in zip(got, want))


def _window_batches(dm, n: int, batch: int = 1) -> list:
    """The first ``n`` batches of ``batch`` train windows, in order."""
    train = dm.train_arrays()
    return [tuple(np.ascontiguousarray(a[i * batch:(i + 1) * batch])
                  for a in train) for i in range(n)]


def _train_parity(dm, spec, phase: str, kernels: tuple, per_step: int = 1,
                  steps: int = PARITY_STEPS, batch: int = 1) -> dict:
    """``spec`` with dropout 0: ``steps`` steps of ``batch`` windows, the
    same windows in the same order, from the same weights, on the card and
    on the CPU (plain versions); each of ``kernels`` launches ``per_step``
    times a step on the card."""
    state = spec.build_module(
        device="cpu", generator=torch.Generator().manual_seed(0)).state_dict()
    batches = _window_batches(dm, steps, batch)
    lk.reset_launch_counts()
    gpu_losses, gpu_grads, gpu_state, _ = _run_steps(spec, state, batches, DEVICE)
    launches = dict(lk.LAUNCHES)
    cpu_losses, cpu_grads, cpu_state, _ = _run_steps(spec, state, batches, "cpu")
    loss_gap = max(abs(g - c) / abs(c) for g, c in zip(gpu_losses, cpu_losses))
    param_gap = max(float((gpu_state[k] - cpu_state[k]).abs().max())
                    for k in cpu_state)
    grad_gap = _grad_gap(gpu_grads, cpu_grads)
    moved = max(float((cpu_state[k] - state[k]).abs().max()) for k in state)
    rows = batch * batches[0][0].shape[1]
    out = {
        "phase": phase,
        "num_layers": spec.num_layers,
        "lookback": dm.lookback_window,
        "steps": steps,
        "rows_per_step": rows,
        "loss_first": cpu_losses[0],
        "loss_last": cpu_losses[-1],
        "max_loss_rel_gap": loss_gap,
        "loss_rtol": PARITY_LOSS_RTOL,
        "max_param_abs_gap": param_gap,
        "param_tol": PARITY_PARAM_TOL,
        "max_param_move": moved,
        "max_grad_rel_gap": grad_gap,
        "grad_rtol": GRAD_RTOL,
        "launches": launches,
    }
    emit(out)
    if not (loss_gap <= PARITY_LOSS_RTOL and param_gap <= PARITY_PARAM_TOL
            and grad_gap <= GRAD_RTOL):
        raise AssertionError(f"card and CPU trajectories differ: {out}")
    missed = {k: launches[k] for k in kernels
              if launches[k] != per_step * steps}
    if missed:
        raise AssertionError(f"{phase}: not {per_step} a step: {missed}")
    return out


def phase_train_parity(dm) -> dict:
    """model=small at full width with dropout 0 on 100-row windows."""
    return _train_parity(dm, _train_spec(dropout=0.0), "train_parity",
                         ("lstm_pair_fwd", "lstm_pair_bwd", "lstm_wgrad"))


def phase_train_medium_parity(dm) -> dict:
    """model=medium at full width with dropout 0 on 25-row windows: one
    4-deep stack (its maskless instance with stashes) a step."""
    return _train_parity(dm, _medium_spec(dropout=0.0), "train_medium_parity",
                         ("lstm_stack_fwd", "lstm_stack_bwd", "lstm_wgrad"))


def _train(dm, spec, phase: str, model: str, kernels: tuple,
           per_step: int = 1) -> dict:
    """Trainer.fit for 2 epochs with the configs' defaults, Trainer.test,
    and the best checkpoint served by PredictEngine; each of ``kernels``
    launches ``per_step`` times a training step."""
    stocks = dm.train_arrays().x.shape[1]
    lookback = dm.lookback_window
    ckpt_dir = Path(dm.data_dir) / f"ckpt_{phase}"
    trainer = Trainer(max_epochs=TRAIN_EPOCHS, gradient_clip_val=CLIP,
                      check_val_every_n_epoch=1, ckpt_dir=ckpt_dir, seed=0,
                      device=DEVICE)
    module = trainer.build(spec)
    val = device_split(dm.val_arrays(), DEVICE)
    init_val = metric_means(evaluate(module, spec.window_objective(), val))["total"]
    lk.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(DEVICE)
    t0 = time.perf_counter()
    result = trainer.fit(spec, dm)  # from build(spec)'s seeded weights
    fit_s = time.perf_counter() - t0
    peak_memory = torch.cuda.max_memory_allocated(DEVICE)
    launches = dict(lk.LAUNCHES)
    steps = TRAIN_EPOCHS * len(dm.train_range)
    for row in result.history:
        emit({"phase": f"{phase}_epoch", "epoch": row["epoch"],
              "train_loss": row["loss/total/train"],
              "val_loss": row["loss/total/val"], "lr": row["lr-Adam"]})
    test_metrics = trainer.test(spec, result.state, dm)

    best, *_ = load_checkpoint(ckpt_dir, "best")
    engine = PredictEngine(spec, best, n_stocks=stocks, lookback=lookback,
                           device=DEVICE, buckets=(1, 2, 4, 8))
    x = dm.test_arrays().x[:8]
    reference = spec.build_module(device=DEVICE)
    reference.load_state_dict(best)
    reference.eval()
    with torch.no_grad():
        alpha, beta = forward_rows(reference, torch.from_numpy(x).to(DEVICE))
    served_err = _max_err(engine.predict(x), (alpha[..., 0].cpu().numpy(),
                                              beta[..., 0].cpu().numpy()))
    losses = [v for row in result.history for k, v in row.items()
              if k.startswith("loss/")] + list(test_metrics.values())
    final_val = result.history[-1]["loss/total/val"]
    out = {
        "phase": phase,
        "model": model,
        "num_layers": spec.num_layers,
        "lookback": lookback,
        "layer_groups": {
            "train": module.layer_groups(lookback, stocks, True, stocks),
            "eval": module.layer_groups(lookback, stocks, False, stocks),
        },
        "routes": {
            "train": _routes(module, lookback, stocks, True, stocks),
            "eval": _routes(module, lookback, EVAL_CHUNK * stocks, False,
                            stocks),
        },
        "epochs": TRAIN_EPOCHS,
        "steps": steps,
        "rows_per_step": stocks,
        "fit_seconds": fit_s,
        "steps_per_s": result.steps_per_sec,
        "windows_per_s": result.windows_per_sec,
        "step_wall_ms": 1e3 / result.steps_per_sec,
        # The allocator's peak over the fit.
        "peak_memory_bytes": peak_memory,
        "val_loss_initial": init_val,
        "val_loss_final": final_val,
        "best_val_loss": result.best_val_loss,
        "test": test_metrics,
        "served_best_max_abs_err": served_err,
        "served_tol": SERVE_TOL,
        "checkpoints": str(ckpt_dir),
        "launches": launches,
    }
    emit(out)
    out["fit"] = result  # not in the line: stacked_train's solo reference
    if not all(np.isfinite(losses)) or len(test_metrics) != 4:
        raise AssertionError(f"non-finite or missing losses: {out}")
    if not final_val < init_val:
        raise AssertionError(f"val loss did not fall: {init_val} -> {final_val}")
    missed = {k: launches[k] for k in kernels if launches[k] != per_step * steps}
    if missed:
        raise AssertionError(f"{phase}: not {per_step} in each of {steps} "
                             f"steps: {missed}")
    if not served_err <= SERVE_TOL:
        raise AssertionError(f"served best checkpoint differs: {served_err}")
    return out


def phase_train(dm) -> dict:
    return _train(dm, _train_spec(), "train", "small",
                  ("lstm_pair_fwd_masked", "lstm_pair_bwd", "lstm_wgrad"))


BF16_PARITY_STEPS = 5


def phase_train_bf16(dm, train: dict) -> dict:
    """trainer.precision=bf16-mixed on model=small at full width: a
    graphed ``Trainer.fit`` of one epoch on the set ``train`` ran (its
    windows/s, the bf16 counters, which must be > 0, and the f32 pair
    counters, which must be 0; the allocator's peak beside ``train``'s),
    ``Trainer.test``, the graphed step's breakdown (device idle share, one
    replay under the raising sync check), and 5 steps of one window
    (dropout 0) against the CPU port's bf16 steps from the same weights,
    with the f32 steps' losses beside."""
    spec = _train_spec()
    ckpt_dir = Path(dm.data_dir) / "ckpt_train_bf16"
    trainer = Trainer(max_epochs=1, gradient_clip_val=CLIP,
                      check_val_every_n_epoch=1, ckpt_dir=ckpt_dir, seed=0,
                      device=DEVICE, precision="bf16-mixed")
    lk.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(DEVICE)
    t0 = time.perf_counter()
    result = trainer.fit(spec, dm)
    fit_s = time.perf_counter() - t0
    peak_memory = torch.cuda.max_memory_allocated(DEVICE)
    launches = dict(lk.LAUNCHES)
    test_metrics = trainer.test(spec, result.state, dm)
    breakdown = _graphed_step_breakdown(dm, spec, torch.bfloat16)

    state = spec.build_module(
        device="cpu", generator=torch.Generator().manual_seed(0)).state_dict()
    batches = _window_batches(dm, BF16_PARITY_STEPS)
    parity = dataclasses.replace(spec, dropout=0.0)
    card, _, _, _ = _run_steps(parity, state, batches, DEVICE,
                               compute_dtype=torch.bfloat16)
    cpu, _, _, _ = _run_steps(parity, state, batches, "cpu",
                              compute_dtype=torch.bfloat16)
    f32, _, _, _ = _run_steps(parity, state, batches, DEVICE)
    loss_gap = max(abs(g - c) / abs(c) for g, c in zip(card, cpu))
    f32_gap = max(abs(g - c) / abs(c) for g, c in zip(f32, cpu))
    losses = [v for row in result.history for k, v in row.items()
              if k.startswith("loss/")] + list(test_metrics.values())
    out = {
        "phase": "train_bf16",
        "model": "small",
        "precision": "bf16-mixed",
        "layer_groups": {
            "train": LstmEncoder(hidden_size=H, num_layers=2, device=DEVICE,
                                 compute_dtype=torch.bfloat16).layer_groups(
                T, K_STOCKS, True, K_STOCKS)},
        "epochs": 1,
        "steps": len(dm.train_range),
        "fit_seconds": fit_s,
        "steps_per_s": result.steps_per_sec,
        "windows_per_s": result.windows_per_sec,
        "f32_windows_per_s": train["windows_per_s"],
        "peak_memory_bytes": peak_memory,
        "f32_peak_memory_bytes": train["peak_memory_bytes"],
        "val_loss": result.history[-1]["loss/total/val"],
        "test": test_metrics,
        "device_idle_share": breakdown["device_idle_share"],
        "step_breakdown": breakdown,
        "parity_losses_card": card,
        "parity_losses_cpu": cpu,
        "parity_losses_f32_card": f32,
        "parity_max_loss_rel_gap": loss_gap,
        "parity_f32_max_loss_rel_gap": f32_gap,
        "parity_rtol": BF16_PARITY_RTOL,
        "launches": launches,
    }
    emit(out)
    if not all(np.isfinite(losses)) or len(test_metrics) != 4:
        raise AssertionError(f"train_bf16: non-finite or missing losses: {out}")
    missed = [k for k in BF16_COUNTERS if not launches[k]]
    f32_ran = {k: launches[k] for k in F32_PAIR_COUNTERS if launches[k]}
    if missed or f32_ran:
        raise AssertionError(f"train_bf16: bf16 counters not launched {missed}"
                             f" or f32 pair kernels launched {f32_ran}")
    if not loss_gap <= BF16_PARITY_RTOL:
        raise AssertionError(f"train_bf16: card and CPU bf16 steps part: "
                             f"{loss_gap} > {BF16_PARITY_RTOL}")
    if not f32_gap > BF16_PARITY_RTOL:
        raise AssertionError(f"train_bf16: the f32 steps are within "
                             f"{BF16_PARITY_RTOL} of the CPU's bf16 steps "
                             f"({f32_gap}): the bar cannot tell bf16 from f32")
    return out


def _start_bf16_driver() -> dict:
    """The entry point with trainer.precision=bf16-mixed, 1 epoch on the
    100 x 200,000 set at model=small (the pair) and at model=medium (one
    4-deep stack), and model.num_layers=5 at bf16 ([4, 1]), which must be
    refused by key: three children, side by side."""
    root = Path(__file__).resolve().parent / "data" / "chip_smoke"
    save_dir = Path(tempfile.mkdtemp(prefix="bf16_driver_", dir=root))
    common = [f"datamodule.data_dir={data_dir(K_STOCKS)}",
              f"datamodule.n_samples={TRAIN_SAMPLES}",
              f"logger.save_dir={save_dir}", "trainer.precision=bf16-mixed"]
    return {"train": _Child("train", *common, "trainer.max_epochs=1",
                            side_by_side=3),
            "medium": _Child("train", *common, "model=medium",
                             "trainer.max_epochs=1", side_by_side=3),
            "refused": _Child("train", *common, "model.num_layers=5",
                              "logger.version=five", side_by_side=3),
            "save_dir": save_dir}


def phase_train_bf16_driver(children: dict) -> dict:
    """``train trainer.precision=bf16-mixed`` ends in its ``done:`` line
    with the bf16 counters launched and no f32 pair kernel, at model=small
    and (the stack's bf16 counters, no f32 or pair kernel) at model=medium;
    ``model.num_layers=5`` at bf16 exits non-zero naming
    ``trainer.precision`` and its grouping and writes no run."""
    lines, launches, seconds = _cli_result(children["train"].wait())
    m_lines, m_launches, m_seconds = _cli_result(children["medium"].wait())
    refused, refused_s = children["refused"].wait()
    refused_dir = children["save_dir"] / "FinancialLstm" / "synthetic" / "five"
    out = {
        "phase": "train_bf16_driver",
        "seconds": seconds,
        "done": _done(lines),
        "launches": launches,
        "medium": {"seconds": m_seconds, "done": _done(m_lines),
                   "launches": m_launches},
        "layers5_refused": {
            "exit": refused.returncode, "seconds": refused_s,
            "stderr_last": (refused.stderr.strip().splitlines() or [""])[-1][:400],
            "wrote": refused_dir.exists()},
    }
    emit(out)
    missed = [k for k in BF16_COUNTERS if not launches[k]]
    f32_ran = {k: launches[k] for k in F32_PAIR_COUNTERS if launches[k]}
    if missed or f32_ran:
        raise AssertionError(f"bf16 driver: {missed} not launched, f32 pair "
                             f"kernels {f32_ran}")
    medium_faults = _bf16_stack_fit_faults(m_launches)
    if medium_faults["not_launched"] or medium_faults["launched"]:
        raise AssertionError(f"bf16 driver at model=medium: {medium_faults}")
    if (refused.returncode == 0 or "trainer.precision=bf16-mixed" not in
            refused.stderr or "group as [4, 1]" not in refused.stderr
            or out["layers5_refused"]["wrote"]):
        raise AssertionError(f"model.num_layers=5 at bf16 not refused: {out}")
    return out


#: The stack's bf16 counters, which a bf16 fit of model=medium must launch
#: (the pass counts as lstm_wgrad_bf16 whatever its jobs), and what it must
#: not: the f32 stack and pair counters and the pair's bf16 ones.
BF16_STACK_COUNTERS = ("lstm_stack_fwd_bf16", "lstm_stack_fwd_masked_bf16",
                       "lstm_stack_bwd_bf16", "lstm_wgrad_bf16")
NOT_IN_BF16_STACK_FIT = ("lstm_stack_fwd", "lstm_stack_fwd_masked",
                         "lstm_stack_bwd", "lstm_pair_fwd_bf16",
                         "lstm_pair_fwd_masked_bf16", "lstm_pair_bwd_bf16"
                         ) + F32_PAIR_COUNTERS


def _bf16_stack_fit_faults(launches: dict) -> dict:
    """The stack's bf16 counters that did not launch and the counters that
    must not launch in a bf16 fit of model=medium but did."""
    return {"not_launched": [k for k in BF16_STACK_COUNTERS if not launches[k]],
            "launched": {k: launches[k] for k in NOT_IN_BF16_STACK_FIT
                         if launches[k]}}


def _bf16_parity(spec, data, seed: int, masks=None) -> dict:
    """``BF16_PARITY_STEPS`` one-window steps of ``spec`` in bf16 on the
    card and on the CPU (the port's plain versions) from the same weights,
    on ``masks`` (bf16, one list a step) or dropout 0, and the card's f32
    steps beside; then one evaluation chunk (EVAL_CHUNK validation windows)
    on the trained card and CPU modules. The losses' and the chunk's
    metrics' largest relative gaps, and the card's launches in each."""
    init = spec.build_module(device="cpu",
                             generator=torch.Generator().manual_seed(seed))
    state = init.state_dict()
    batches = _window_batches(data, BF16_PARITY_STEPS)
    bf16 = torch.bfloat16
    lk.reset_launch_counts()
    card, _, _, module = _run_steps(spec, state, batches, DEVICE, masks,
                                    compute_dtype=bf16)
    launches = dict(lk.LAUNCHES)
    cpu, _, _, cpu_module = _run_steps(spec, state, batches, "cpu", masks,
                                       compute_dtype=bf16)
    f32_masks = None if masks is None else [[m.float() for m in step]
                                            for step in masks]
    f32, _, _, _ = _run_steps(spec, state, batches, DEVICE, f32_masks)
    chunk = Batch(*(np.ascontiguousarray(a[:EVAL_CHUNK])
                    for a in data.val_arrays()))
    lk.reset_launch_counts()
    got = metric_means(evaluate(module, spec.window_objective(),
                                device_split(chunk, DEVICE)))
    eval_launches = dict(lk.LAUNCHES)
    want = metric_means(evaluate(cpu_module, spec.window_objective(),
                                 device_split(chunk, "cpu")))
    stocks = chunk.x.shape[1]
    return {
        "rows_per_window": stocks,
        "layer_groups": {
            "train": module.layer_groups(T, stocks, masks is not None, stocks),
            "eval": module.layer_groups(T, EVAL_CHUNK * stocks, False, stocks)},
        "parity_losses_card": card,
        "parity_losses_cpu": cpu,
        "parity_losses_f32_card": f32,
        "parity_max_loss_rel_gap": max(abs(g - c) / abs(c)
                                       for g, c in zip(card, cpu)),
        "parity_f32_max_loss_rel_gap": max(abs(g - c) / abs(c)
                                           for g, c in zip(f32, cpu)),
        "eval_chunk_card": got,
        "eval_chunk_cpu": want,
        "eval_chunk_total_rel_gap": (abs(float(got["total"]) - float(want["total"]))
                                     / abs(float(want["total"]))),
        "parity_rtol": BF16_PARITY_RTOL,
        "launches": launches,
        "eval_launches": eval_launches,
    }


def _check_bf16_parity(phase: str, run: dict) -> None:
    if not (run["parity_max_loss_rel_gap"] <= BF16_PARITY_RTOL
            and run["eval_chunk_total_rel_gap"] <= BF16_PARITY_RTOL):
        raise AssertionError(f"{phase}: card and CPU bf16 part: {run}")
    if not run["parity_f32_max_loss_rel_gap"] > BF16_PARITY_RTOL:
        raise AssertionError(f"{phase}: the f32 steps are within "
                             f"{BF16_PARITY_RTOL} of the CPU's bf16 steps: the "
                             "bar cannot tell bf16 from f32")


def phase_train_medium_bf16(dm) -> dict:
    """trainer.precision=bf16-mixed on model=medium at full width (H=64, 4
    layers, dropout 0.3) on the 100-stock set ``train`` uses: a graphed
    ``Trainer.fit`` of one epoch in bf16 (one 4-deep stack in training and
    in evaluation), then one in f32 (two pairs) in the same phase, windows/s
    each; ``Trainer.test`` of the bf16 run; the graphed bf16 step's
    breakdown (device idle share, one replay under the raising sync check);
    and 5 one-window steps at dropout 0 on the card against the CPU port's
    bf16 steps (the f32 steps outside the bar), with one evaluation chunk
    after them."""
    spec = _medium_spec()
    fits, t_phase = {}, time.perf_counter()
    for precision in ("bf16-mixed", "32-true"):
        trainer = Trainer(max_epochs=1, gradient_clip_val=CLIP,
                          check_val_every_n_epoch=1, seed=0, device=DEVICE,
                          ckpt_dir=Path(dm.data_dir) / f"ckpt_medium_{precision}",
                          precision=precision)
        lk.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats(DEVICE)
        t0 = time.perf_counter()
        result = trainer.fit(spec, dm)
        fits[precision] = {
            "fit_seconds": time.perf_counter() - t0,
            "steps_per_s": result.steps_per_sec,
            "windows_per_s": result.windows_per_sec,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(DEVICE),
            "val_loss": result.history[-1]["loss/total/val"],
            "launches": dict(lk.LAUNCHES),
        }
        if precision == "bf16-mixed":
            test_metrics = trainer.test(spec, result.state, dm)
            history = result.history
    breakdown = _graphed_step_breakdown(dm, spec, torch.bfloat16)
    parity = _bf16_parity(dataclasses.replace(spec, dropout=0.0), dm, seed=0)
    groups = {run: LstmEncoder(hidden_size=H, num_layers=STACK_LAYERS,
                               device=DEVICE, compute_dtype=dtype).layer_groups(
        T, rows, masked, K_STOCKS)
        for run, dtype, rows, masked in (
            ("train", torch.bfloat16, K_STOCKS, True),
            ("eval", torch.bfloat16, EVAL_CHUNK * K_STOCKS, False),
            ("f32_train", torch.float32, K_STOCKS, True),
            ("f32_eval", torch.float32, EVAL_CHUNK * K_STOCKS, False))}
    launches = fits["bf16-mixed"]["launches"]
    losses = [v for row in history for k, v in row.items()
              if k.startswith("loss/")] + list(test_metrics.values())
    out = {
        "phase": "train_medium_bf16",
        "model": "medium",
        "precision": "bf16-mixed",
        "layer_groups": groups,
        "epochs": 1,
        "steps": len(dm.train_range),
        "rows_per_step": K_STOCKS,
        "fit": fits["bf16-mixed"],
        "f32_fit": fits["32-true"],
        "windows_per_s": fits["bf16-mixed"]["windows_per_s"],
        "f32_windows_per_s": fits["32-true"]["windows_per_s"],
        "bf16_over_f32_windows_per_s": (fits["bf16-mixed"]["windows_per_s"]
                                        / fits["32-true"]["windows_per_s"]),
        "test": test_metrics,
        "device_idle_share": breakdown["device_idle_share"],
        "step_breakdown": breakdown,
        **{k: v for k, v in parity.items() if k != "layer_groups"},
        "parity_layer_groups": parity["layer_groups"],
        "launches": launches,
        "phase_seconds": time.perf_counter() - t_phase,
    }
    emit(out)
    if not all(np.isfinite(losses)) or len(test_metrics) != 4:
        raise AssertionError(f"train_medium_bf16: non-finite or missing losses: {out}")
    want_groups = {"train": [4], "eval": [4], "f32_train": [2, 2],
                   "f32_eval": [2, 2]}
    if groups != want_groups or parity["layer_groups"] != {"train": [4],
                                                           "eval": [4]}:
        raise AssertionError(f"train_medium_bf16: grouped otherwise: {groups}, "
                             f"{parity['layer_groups']}")
    wrong = _bf16_stack_fit_faults(launches)
    if wrong["not_launched"] or wrong["launched"]:
        raise AssertionError(f"train_medium_bf16: {wrong}")
    _check_bf16_parity("train_medium_bf16", parity)
    return out


def phase_train_large_bf16(dm_medium, dm) -> dict:
    """model=large (8 layers, dropout 0.3) at bf16-mixed, on 25-row windows
    ([8] in training and evaluation) and on 100-row windows ([4, 4] in
    training, [6, 2] in evaluation): ``BF16_PARITY_STEPS`` one-window steps
    on injected masks and one evaluation chunk, on the card against the CPU
    port's bf16 (the card's f32 steps outside the bar), with the card's
    launches: the bf16 stack's (and the bf16 pair's maskless forward in the
    [6, 2] evaluation), nothing f32."""
    spec = _medium_spec(num_layers=8)
    t0 = time.perf_counter()
    runs = {}
    for data in (dm_medium, dm):
        stocks = data.train_arrays().x.shape[1]
        draw = spec.build_module(device="cpu", compute_dtype=torch.bfloat16)
        masks = [draw.draw_masks(T, stocks, torch.Generator().manual_seed(20 + i))
                 for i in range(BF16_PARITY_STEPS)]
        runs[stocks] = _bf16_parity(spec, data, seed=2, masks=masks)
    out = {"phase": "train_large_bf16", "model": "large",
           "precision": "bf16-mixed", "windows": runs,
           "seconds": time.perf_counter() - t0}
    emit(out)
    want = {K_MEDIUM: ({"train": [8], "eval": [8]}, {"lstm_stack_fwd_bf16": 1}),
            K_STOCKS: ({"train": [4, 4], "eval": [6, 2]},
                       {"lstm_stack_fwd_bf16": 1, "lstm_pair_fwd_bf16": 1})}
    for stocks, run in runs.items():
        groups, eval_counts = want[stocks]
        per_step = len(groups["train"]) * BF16_PARITY_STEPS
        train_counts = {"lstm_stack_fwd_masked_bf16": per_step,
                        "lstm_stack_bwd_bf16": per_step,
                        "lstm_wgrad_bf16": per_step}
        if run["layer_groups"] != groups:
            raise AssertionError(f"train_large_bf16 at {stocks} rows: grouped "
                                 f"{run['layer_groups']}, not {groups}")
        for counts, got in ((train_counts, run["launches"]),
                            (eval_counts, run["eval_launches"])):
            if got != dict.fromkeys(got, 0) | counts:
                raise AssertionError(f"train_large_bf16 at {stocks} rows: "
                                     f"launches {got}, not {counts}")
        _check_bf16_parity(f"train_large_bf16 at {stocks} rows", run)
    return out


def phase_train_medium(dm) -> dict:
    """model=medium (dropout 0.3) on 25-row windows: the masked 4-deep
    stack, its sweep and one weight-gradient pass each step."""
    return _train(dm, _medium_spec(), "train_medium", "medium",
                  ("lstm_stack_fwd_masked", "lstm_stack_bwd", "lstm_wgrad"))


def phase_train_long_parity(dm) -> dict:
    """model=small at full width with dropout 0 on 100-row windows of 252
    days: both layers alone, each through the time-blocked forward and
    backward once a step, LONG_PARITY_STEPS steps."""
    return _train_parity(dm, _train_spec(dropout=0.0), "train_long_parity",
                         ("lstm_tb_fwd", "lstm_tb_bwd"), per_step=2,
                         steps=LONG_PARITY_STEPS)


def _print_delta_table(delta: dict) -> None:
    print("ΔL on the test split, above the target-window OLS "
          f"(ζ = {delta['zeta']:g}):", flush=True)
    print(f"{'':8}{'ΔL_MSE':>16}{'ΔL_NLL':>16}{'ΔL_MIX':>16}", flush=True)
    for key in ("model", "ols"):
        d = delta[key]
        print(f"{key:8}{d['delta_mse']:16.6e}{d['delta_nll']:16.6e}"
              f"{d['delta_mix']:16.6e}", flush=True)


def phase_train_long(dm) -> dict:
    """model=small (dropout 0.2) at a 252-day lookback: Trainer.fit (every
    step two time-blocked forwards and backwards, validation through the
    forward), Trainer.test, the best checkpoint served, evaluation's ΔL
    table on it, and where one step's time goes."""
    spec = _train_spec()
    out = _train(dm, spec, "train_long", "small", ("lstm_tb_bwd",), per_step=2)
    launches = out["launches"]
    if launches["lstm_tb_fwd"] < 2 * out["steps"] or any(
            launches[k] for k in ("lstm_fwd", "lstm_bwd", "lstm_pair_fwd",
                                  "lstm_pair_fwd_masked", "lstm_pair_bwd",
                                  "lstm_wgrad")):
        raise AssertionError(f"train_long left the time-blocked kernels: "
                             f"{launches}")
    best, *_ = load_checkpoint(out["checkpoints"], "best")
    t0 = time.perf_counter()
    estimates = evaluation.collect_test_results(spec, best, dm, device=DEVICE)
    delta = evaluation.delta_losses(spec, best, dm, estimates=estimates,
                                    device=DEVICE)
    eval_s = time.perf_counter() - t0
    _print_delta_table(delta)
    values = [v for key in ("model", "ols") for v in delta[key].values()]
    values += list(delta["baseline"].values())
    emit({"phase": "train_long_delta_losses", "windows": len(dm.test_range),
          "seconds": eval_s, "delta_losses": delta,
          "alpha_model_shape": list(estimates["alpha"]["model"].shape)})
    if not np.isfinite(values).all():
        raise AssertionError(f"non-finite ΔL: {delta}")
    breakdown = _train_breakdown(dm, spec, "train_long_breakdown")
    out.update(delta_losses=delta, device_idle_share=breakdown["device_idle_share"],
               step_wall_ms_p50=breakdown["step_wall_ms_p50"])
    return out


def _remat_run(spec, state, batches, masks) -> dict:
    """``len(batches)`` train steps on the card with injected masks: the
    losses, the launches, and the device memory the first step allocated
    at its peak above what was allocated before it."""
    module = spec.build_module(device=DEVICE)
    module.load_state_dict(state)
    optimizer = make_optimizer(module, CLIP, spec.weight_decay)
    loss_fn = batched_objective(spec.window_objective())
    losses = []
    lk.reset_launch_counts()
    for i, arrays in enumerate(batches):
        batch = Batch(*(torch.from_numpy(a).to(DEVICE) for a in arrays))
        step_masks = [m.to(DEVICE) for m in masks[i]]
        torch.cuda.synchronize()
        if i == 0:
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
        sums = train_step(module, optimizer, loss_fn, batch, spec.learning_rate,
                          masks=step_masks)
        losses.append(float(sums["total"][0] / sums["total"][1]))
        if i == 0:
            peak = torch.cuda.max_memory_allocated() - before
    return {"losses": losses, "launches": dict(lk.LAUNCHES),
            "step_peak_bytes": peak}


def phase_train_long_remat(dm, steps: int = 5) -> dict:
    """model=small (dropout 0.2, injected masks) at a 252-day lookback:
    ``steps`` steps with remat against the same steps without it. The
    losses are bit-equal, the forward runs twice a layer with remat."""
    plain_spec = _train_spec()
    stocks = dm.train_arrays().x.shape[1]
    init = plain_spec.build_module(device="cpu",
                                   generator=torch.Generator().manual_seed(3))
    masks = [init.draw_masks(T_LONG, stocks, torch.Generator().manual_seed(20 + i))
             for i in range(steps)]
    batches = _window_batches(dm, steps)
    runs = {remat: _remat_run(dataclasses.replace(plain_spec, remat=remat),
                              init.state_dict(), batches, masks)
            for remat in (False, True)}
    out = {
        "phase": "train_long_remat",
        "steps": steps,
        "losses": runs[False]["losses"],
        "losses_bit_equal": runs[True]["losses"] == runs[False]["losses"],
        "tb_fwd_launches": {str(k): r["launches"]["lstm_tb_fwd"]
                            for k, r in runs.items()},
        "tb_bwd_launches": {str(k): r["launches"]["lstm_tb_bwd"]
                            for k, r in runs.items()},
        "step_peak_bytes": {str(k): r["step_peak_bytes"] for k, r in runs.items()},
    }
    emit(out)
    if not out["losses_bit_equal"]:
        raise AssertionError(f"remat changed the losses: {runs}")
    fwd = out["tb_fwd_launches"]
    if fwd["True"] != 2 * fwd["False"] or fwd["False"] != 2 * steps or (
            out["tb_bwd_launches"]["True"] != 2 * steps):
        raise AssertionError(f"remat did not recompute the forward: {out}")
    return out


def _grad_parity(dm, spec, seed: int, phase: str, steps: int = 5):
    """``spec`` with its dropout on injected masks: ``steps`` steps on the
    card and on the CPU, gradients compared at every step."""
    stocks = dm.train_arrays().x.shape[1]
    init = spec.build_module(device="cpu",
                             generator=torch.Generator().manual_seed(seed))
    masks = [init.draw_masks(T, stocks, torch.Generator().manual_seed(10 + i))
             for i in range(steps)]
    batches = _window_batches(dm, steps)
    lk.reset_launch_counts()
    _, gpu_grads, _, module = _run_steps(spec, init.state_dict(), batches,
                                         DEVICE, masks)
    launches = dict(lk.LAUNCHES)
    _, cpu_grads, _, _ = _run_steps(spec, init.state_dict(), batches, "cpu", masks)
    gap = _grad_gap(gpu_grads, cpu_grads)
    out = {
        "phase": phase,
        "num_layers": spec.num_layers,
        "steps": steps,
        "layer_groups": module.layer_groups(T, stocks, True, stocks),
        "max_grad_rel_gap": gap,
        "grad_rtol": GRAD_RTOL,
        "launches": launches,
    }
    if not gap <= GRAD_RTOL:
        emit(out)
        raise AssertionError(f"{phase}: gradients differ from the CPU: {gap}")
    return out, module, steps


def phase_train_odd_layers(dm) -> dict:
    """A 3-layer model (pair, then one) with dropout 0.2 on injected masks:
    5 steps on the card and on the CPU, gradients compared at every step."""
    out, _, steps = _grad_parity(dm, _train_spec(num_layers=3), 1,
                                 "train_odd_layers")
    emit(out)
    launches = out["launches"]
    if launches["lstm_bwd"] < steps or launches["lstm_pair_fwd_masked"] < steps:
        raise AssertionError(f"3-layer training missed a kernel: {launches}")
    return out


def phase_train_large(dm) -> dict:
    """model=large (8 layers, dropout 0.3) on 25-row windows: 5 training
    steps (a 7-deep stack, then one layer) on the card and on the CPU,
    gradients compared at every step; then one eval forward (one 8-deep
    stack) on the card against the CPU."""
    spec = _medium_spec(num_layers=8)
    out, module, steps = _grad_parity(dm, spec, 2, "train_large")
    x = torch.from_numpy(dm.test_arrays().x[:1])
    module.eval()
    lk.reset_launch_counts()
    with torch.no_grad():
        got = forward_rows(module, x.to(DEVICE))
    eval_launches = dict(lk.LAUNCHES)
    cpu = spec.build_module(device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in module.state_dict().items()})
    cpu.eval()
    with torch.no_grad():
        want = forward_rows(cpu, x)
    err = _max_abs_err(tuple(g.cpu() for g in got), want)
    out.update({
        "eval_layer_groups": module.layer_groups(T, x.shape[1], False,
                                                 x.shape[1]),
        "eval_max_abs_err_vs_cpu": err,
        "eval_tol": SERVE_TOL,
        "eval_launches": eval_launches,
    })
    emit(out)
    train, ev = out["launches"], eval_launches
    if out["layer_groups"] != [7, 1] or out["eval_layer_groups"] != [8]:
        raise AssertionError(f"model=large grouped otherwise: {out}")
    if not (train["lstm_stack_fwd_masked"] == train["lstm_stack_bwd"]
            == train["lstm_bwd"] == train["lstm_fwd"] == steps):
        raise AssertionError(f"model=large training missed a kernel: {train}")
    if ev["lstm_stack_fwd"] != 1 or ev["lstm_fwd"] or ev["lstm_pair_fwd"]:
        raise AssertionError(f"model=large eval missed the 8-deep stack: {ev}")
    if not err <= SERVE_TOL:
        raise AssertionError(f"model=large eval differs from the CPU: {err}")
    return out


def _train_breakdown(dm, spec, phase: str) -> dict:
    """Where one training step's time goes (batch_size 1, one window,
    ``spec``'s dropout): host wall clock per step, ending synchronized,
    split into the host's time to queue each part and its wait for the card,
    beside the device time by kernel from a torch.profiler trace of 10
    steps."""
    module = spec.build_module(device=DEVICE,
                               generator=torch.Generator().manual_seed(0))
    optimizer = make_optimizer(module, CLIP, spec.weight_decay)
    loss_fn = batched_objective(spec.window_objective())
    data = device_split(Batch(*(a[:64] for a in dm.train_arrays())), DEVICE)
    generator = torch.Generator(device=DEVICE).manual_seed(0)
    position = [0]

    def next_batch() -> Batch:
        i = position[0] % data.x.shape[0]
        position[0] += 1
        return Batch(*(a[i:i + 1] for a in data))

    def step():
        train_step(module, optimizer, loss_fn, next_batch(), LR, generator)
        torch.cuda.synchronize()

    def timed_step() -> list:
        """train_step's parts, each timed on the host clock: the time to
        queue the forward and loss, the backward and the optimizer update,
        then the wait for the card to finish."""
        batch = next_batch()
        t = [time.perf_counter()]
        alpha, beta = forward_rows(module, batch.x, deterministic=False,
                                   generator=generator)
        loss, _ = loss_fn(alpha, beta, batch.y, batch.factor, batch.inv_psi)
        t.append(time.perf_counter())
        optimizer.zero_grad()
        loss.backward()
        t.append(time.perf_counter())
        optimizer.step(LR)
        t.append(time.perf_counter())
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        return [1e3 * (b - a) for a, b in zip(t, t[1:])]

    host, busy_ms, device = _wall_and_device(step)
    parts = np.median([timed_step() for _ in range(30)], axis=0)
    # One more step with PyTorch's synchronisation check set to raise: the
    # step waits on the card nowhere (the epoch reads its sums once).
    torch.cuda.set_sync_debug_mode("error")
    try:
        batch = Batch(*(a[:1] for a in data))
        train_step(module, optimizer, loss_fn, batch, LR, generator)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    graphed = _graphed_step_breakdown(dm, spec)
    out = {
        "phase": phase,
        "num_layers": spec.num_layers,
        "rows": data.x.shape[1],
        "host_syncs_per_step": 0,
        "step_wall_ms_p50": host["wall_ms_p50"],
        "step_wall_ms_spread": host["wall_ms_spread"],
        "host_probe_ms_p50": host["host_probe_ms_p50"],
        "host_probe_ms_spread": host["host_probe_ms_spread"],
        "host_ms_p50": dict(zip(
            ("queue_forward_and_loss", "queue_backward", "queue_optimizer",
             "wait_for_card"), map(float, parts))),
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / host["wall_ms_p50"],
        "device_ms_by_kernel": device[:12],
        "distinct_device_ops": len(device),
        "graphed": graphed,
    }
    emit(out)
    return out


def _graphed_step_breakdown(dm, spec, compute_dtype=torch.float32) -> dict:
    """The same step as ``TrainProgram``'s CUDA graph (128 windows, one a
    step, re-shuffled when they run out): host wall clock per step, ending
    synchronized, split into the host's time to replay and its wait for
    the card, and the device time by kernel; one replay under the
    synchronisation check set to raise."""
    module = spec.build_module(device=DEVICE,
                               generator=torch.Generator().manual_seed(0),
                               compute_dtype=compute_dtype)
    optimizer = make_optimizer(module, CLIP, spec.weight_decay)
    data = device_split(Batch(*(a[:128] for a in dm.train_arrays())), DEVICE)
    program = TrainProgram(module, optimizer, spec.window_objective(), data, 1,
                           torch.Generator(device=DEVICE).manual_seed(0),
                           graphed=True)
    taken = [0]

    def replay() -> None:
        if taken[0] % program.n_steps == 0:
            program.begin_epoch(LR)
        taken[0] += 1
        program.step()

    def step():
        replay()
        torch.cuda.synchronize()

    def timed_step() -> list:
        t = [time.perf_counter()]
        replay()
        t.append(time.perf_counter())
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        return [1e3 * (b - a) for a, b in zip(t, t[1:])]

    host, busy_ms, device = _wall_and_device(step)  # its warm-up captures
    parts = np.median([timed_step() for _ in range(30)], axis=0)
    torch.cuda.set_sync_debug_mode("error")
    try:
        replay()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return {
        "host_syncs_per_step": 0,
        "step_wall_ms_p50": host["wall_ms_p50"],
        "step_wall_ms_spread": host["wall_ms_spread"],
        "host_probe_ms_p50": host["host_probe_ms_p50"],
        "host_ms_p50": dict(zip(("replay", "wait_for_card"), map(float, parts))),
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / host["wall_ms_p50"],
        "device_ms_by_kernel": device[:12],
        "launches_per_step": program.step.launches,
    }


# ---------------------------------------------------------------- graphs

GRAPH_STEPS = 20


def _program_steps(spec, state, data, graphed: bool) -> dict:
    """GRAPH_STEPS steps of ``TrainProgram`` (graphed or eager) from
    ``state`` on ``data``'s windows, one a step, shuffled and masked from
    a generator seeded 7: each step's loss sum and weight, the parameters,
    the Adam moments and the launch counts."""
    module = spec.build_module(device=DEVICE)
    module.load_state_dict(state)
    optimizer = make_optimizer(module, CLIP, spec.weight_decay)
    program = TrainProgram(module, optimizer, spec.window_objective(), data, 1,
                           torch.Generator(device=DEVICE).manual_seed(7),
                           graphed)
    lk.reset_launch_counts()
    program.begin_epoch(LR)
    losses = []
    for _ in range(program.n_steps):
        program.step()
        losses.append(program.step_total.clone())
    torch.cuda.synchronize()
    return {"module": module, "optimizer": optimizer,
            "losses": torch.stack(losses), "launches": dict(lk.LAUNCHES)}


def _fit_rate(spec, dm, graphed: bool) -> float:
    """``Trainer.fit`` windows/s over one epoch, no checkpoints, timed
    whole (a graphed epoch's capture is ~1 ms of it; 2 graphed epochs,
    the second timed, before PR 15)."""
    trainer = Trainer(max_epochs=1, gradient_clip_val=CLIP, seed=0,
                      device=DEVICE, cuda_graphs=graphed)
    return trainer.fit(spec, dm).windows_per_sec


def phase_graphs(dm, spec, phase: str, kernels: dict) -> dict:
    """``spec`` with its own dropout: GRAPH_STEPS steps of the training
    step as one CUDA graph against the same steps run eagerly, from the
    same weights, windows and generator seed: every loss, parameter and
    Adam moment bit-equal (``torch.equal``), and each of ``kernels``
    launched its count a step in both, replays counted. Then the val split's metric sums,
    graphed (full chunks and the short tail, each its own graph) against
    eager, bit-equal, on a second pass too; and ``Trainer.fit``'s
    windows/s, eager then graphed."""
    state = spec.build_module(
        device="cpu", generator=torch.Generator().manual_seed(5)).state_dict()
    data = device_split(Batch(*(a[:GRAPH_STEPS] for a in dm.train_arrays())),
                        DEVICE)
    t0 = time.perf_counter()
    runs = {g: _program_steps(spec, state, data, g) for g in (True, False)}
    steps_s = time.perf_counter() - t0
    graphed, eager = runs[True], runs[False]
    params_equal = all(
        torch.equal(a, b) for a, b in zip(graphed["module"].parameters(),
                                          eager["module"].parameters()))
    moments_equal = all(
        torch.equal(getattr(graphed["optimizer"], k), getattr(eager["optimizer"], k))
        for k in ("mu", "nu", "count_t"))
    losses_equal = torch.equal(graphed["losses"], eager["losses"])
    val = device_split(dm.val_arrays(), DEVICE)
    objective = spec.window_objective()
    module = eager["module"]
    want = EvalProgram(module, objective, val, EVAL_CHUNK).run()
    program = EvalProgram(module, objective, val, EVAL_CHUNK, graphed=True)
    passes = [program.run(), program.run()]  # capture, then replays only
    eval_equal = all(torch.equal(got[k][i], want[k][i]) for got in passes
                     for k in want for i in (0, 1))
    rates = {"eager": _fit_rate(spec, dm, False), "graphed": _fit_rate(spec, dm, True)}
    n_rows = dm.train_arrays().x.shape[1]
    out = {
        "phase": phase,
        "num_layers": spec.num_layers,
        "dropout": spec.dropout,
        "lookback": dm.lookback_window,
        "layer_groups": {
            "train": module.layer_groups(dm.lookback_window, n_rows, True, n_rows),
            "eval": module.layer_groups(dm.lookback_window, EVAL_CHUNK * n_rows,
                                        False, n_rows),
        },
        "steps": GRAPH_STEPS,
        "losses": (eager["losses"][:, 0] / eager["losses"][:, 1]).tolist(),
        "losses_bit_equal": losses_equal,
        "params_bit_equal": params_equal,
        "adam_moments_bit_equal": moments_equal,
        "launches": {"graphed": graphed["launches"], "eager": eager["launches"]},
        "eval_windows": val.x.shape[0],
        "eval_programs": [(runs_, p.launches) for runs_, p, _ in program.parts],
        "eval_sums_bit_equal": eval_equal,
        "eval_total": metric_means(want)["total"],
        "steps_seconds": steps_s,
        "trainer_fit_windows_per_s": rates,
    }
    emit(out)
    if not (losses_equal and params_equal and moments_equal and eval_equal):
        raise AssertionError(f"{phase}: graphed and eager differ: {out}")
    if graphed["launches"] != eager["launches"] or any(
            graphed["launches"][k] != n * GRAPH_STEPS for k, n in kernels.items()):
        raise AssertionError(f"{phase}: launches not {kernels} a step: "
                             f"{out['launches']}")
    if val.x.shape[0] % EVAL_CHUNK == 0 or len(program.parts) != 2:
        raise AssertionError(f"{phase}: the val split has no short tail")
    return out


def phase_train_breakdown(dm) -> dict:
    return _train_breakdown(dm, _train_spec(), "train_breakdown")


def phase_train_medium_breakdown(dm) -> dict:
    return _train_breakdown(dm, _medium_spec(), "train_medium_breakdown")


def phase_train_large_breakdown(dm) -> dict:
    """model=large's step: the 7-deep stack and the single layer."""
    return _train_breakdown(dm, _medium_spec(num_layers=8),
                            "train_large_breakdown")


# The entry point in a child process, as `python -m` runs it (runpy), which
# prints its kernels' launch counts as its last line when it exits.
_CLI_CHILD = (
    "import atexit, json, runpy\n"
    "from masters_thesis_tpu_torch.ops import lstm_kernel as lk\n"
    "from masters_thesis_tpu_torch.parallel import mesh\n"
    "atexit.register(lambda: print(json.dumps({'launches': dict(lk.LAUNCHES),"
    " 'collectives': dict(mesh.COLLECTIVES)}), flush=True))\n"
    "runpy.run_module('masters_thesis_tpu_torch', run_name='__main__',"
    " alter_sys=True)\n"
)
DRIVER_RTOL = 1e-4
# `phase_driver`'s train child: its `done:` windows/s before run telemetry
# was on by default (NVIDIA H100 80GB HBM3, 700.00 W), printed beside this
# run's.
DRIVER_DONE_BEFORE = 1532.2
DONE_LINE = re.compile(r"done: best_val=(\S+) test_mae=(\S+) test_nll=(\S+) "
                       r"steps/sec=(\S+)")
DELTA_LINE = re.compile(r"\s*(model|ols): dL_MSE\(x1e-5\)=\s*(\S+)\s+"
                        r"dL_NLL=\s*(\S+)\s+dL_MIX\(zeta=1e5\)=\s*(\S+)")


class _Child:
    """``python -m masters_thesis_tpu_torch <command> --device <DEVICE>
    <overrides>`` started from the repo root as a child process, through
    ``_CLI_CHILD``, with ``MTT_FAULT_PLAN`` set to ``plan`` or unset. Its
    output goes to files, so children can run side by side
    (``side_by_side`` of them)."""

    def __init__(self, command: str, *overrides: str, plan: str | None = None,
                 side_by_side: int = 1):
        env = {k: v for k, v in os.environ.items()
               if k not in (faults.FAULT_PLAN_ENV, faults.ATTEMPT_ENV)}
        if plan is not None:
            env[faults.FAULT_PLAN_ENV] = plan
        if side_by_side > 1:
            # The host's cores shared out: busy-waiting thread pools of
            # several children on every core slow them all many times over.
            env["OMP_NUM_THREADS"] = str(max(1, (os.cpu_count() or 1)
                                             // side_by_side))
        self.command = command
        self.out = tempfile.TemporaryFile("w+")
        self.err = tempfile.TemporaryFile("w+")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _CLI_CHILD, command, "--device", DEVICE,
             *overrides],
            cwd=Path(__file__).resolve().parent, env=env, stdout=self.out,
            stderr=self.err, text=True)

    def wait(self, timeout: float = 600) -> tuple[subprocess.CompletedProcess,
                                                  float]:
        """Its exit (killed at ``timeout``) and its seconds."""
        try:
            code = self.proc.wait(timeout)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
        seconds = time.perf_counter() - self.t0
        self.out.seek(0)
        self.err.seek(0)
        done = subprocess.CompletedProcess(self.proc.args, code,
                                           self.out.read(), self.err.read())
        self.out.close()
        self.err.close()
        return done, seconds


def _wait_all(children: list) -> list:
    """``wait()`` of each child; any child still running when one fails is
    killed."""
    try:
        return [child.wait() for child in children]
    finally:
        for child in children:
            if child.proc.poll() is None:
                child.proc.kill()
                child.proc.wait()


def _cli_result(child_result) -> tuple[list[str], dict, float]:
    """A child's output lines, its launch counts and its seconds; raises
    unless it exited 0."""
    proc, seconds = child_result
    if proc.returncode != 0:
        raise AssertionError(f"{proc.args[3]} exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    lines = proc.stdout.splitlines()
    return lines[:-1], json.loads(lines[-1])["launches"], seconds


def _cli(command: str, *overrides: str) -> tuple[list[str], dict, float]:
    """One child (``_Child``) run to its end: its output lines, its launch
    counts and its seconds; raises unless it exits 0."""
    return _cli_result(_Child(command, *overrides).wait())


def _quality_of_run(ckpts: Path, telemetry_dir: Path) -> dict:
    """A train child's fingerprints: for ``best`` and ``last`` whether the
    tree carries ``quality.json`` inside its verified manifest; the saves,
    the ``quality_fingerprint`` events, and the fingerprint's seconds a
    save (its ``quality/fingerprint_s`` histogram)."""
    trees = {}
    for tag in ("best", "last"):
        manifest = json.loads((ckpts / tag / "MANIFEST.json").read_text())
        trees[tag] = (quality_lib.read_fingerprint(ckpts / tag) is not None
                      and quality_lib.FINGERPRINT_FILENAME in manifest["files"]
                      and verify_checkpoint(ckpts / tag, require_manifest=True))
    events = read_events(telemetry_dir / "events.jsonl")
    prints = [e for e in events if e["kind"] == "quality_fingerprint"]
    saves = [e for e in events if e["kind"] == "checkpoint_saved"]
    timed = next(e["metrics"] for e in reversed(events)
                 if e["kind"] == "metrics").get("quality/fingerprint_s") or {}
    count = timed.get("count") or 0
    return {"trees_carry_fingerprint": trees, "saves": len(saves),
            "fingerprints": len(prints),
            "windows": prints[-1]["windows"] if prints else None,
            "fingerprint_s_mean": timed["sum"] / count if count else None,
            "fingerprint_s_p50": timed.get("p50"),
            "fingerprint_s_p99": timed.get("p99"),
            "save_s": [e["wall_s"] for e in saves]}


def _check_quality(phase: str, quality: dict) -> None:
    if (not all(quality["trees_carry_fingerprint"].values())
            or quality["fingerprints"] != quality["saves"]):
        raise AssertionError(f"{phase}: checkpoints without a fingerprint: "
                             f"{quality}")


def _done(lines: list[str]) -> dict:
    match = next(m for m in map(DONE_LINE.fullmatch, lines) if m)
    return dict(zip(("best_val", "test_mae", "test_nll", "steps_per_s"),
                    map(float, match.groups())))


def phase_driver(train: dict) -> dict:
    """The default composition (datamodule=synthetic, model=small, loss=mse,
    trainer=fast) through the port's entry point, each run a child process:
    ``train`` for 2 epochs on the 100 x 200,000 set the earlier phases
    made, ``test`` on its checkpoint root (the ΔL table), and a warm start
    (``checkpoint_mode=params``) from its ``best`` for 1 epoch into another
    version. ``train`` is phase_train's run of ``Trainer.fit``, for the
    windows/s the driver costs on top of the trainer and the val loss of
    the same initial weights."""
    root = Path(__file__).resolve().parent / "data" / "chip_smoke"
    root.mkdir(parents=True, exist_ok=True)
    save_dir = Path(tempfile.mkdtemp(prefix="driver_", dir=root))
    common = [f"datamodule.data_dir={data_dir(K_STOCKS)}",
              f"datamodule.n_samples={TRAIN_SAMPLES}",
              f"logger.save_dir={save_dir}"]
    try:
        run_lines, run_launches, run_s = _cli(
            "train", *common, f"trainer.max_epochs={TRAIN_EPOCHS}")
        run_dir = save_dir / "FinancialLstm" / "synthetic" / "mse_small_lr0.0001_fast"
        ckpts = run_dir / "checkpoints"
        # The test and the warm start side by side (both only read the
        # run's checkpoints), and the data-parallel run at world size 1.
        dp_child = _start_data_parallel_world1(common)
        test_run, warm_run, dp_run = _wait_all([
            _Child("test", *common, f"checkpoint={ckpts}", side_by_side=3),
            _Child("train", *common, f"checkpoint={ckpts / 'best'}",
                   "checkpoint_mode=params", "trainer.max_epochs=1",
                   "logger.version=warm_start", side_by_side=3),
            dp_child])
        phase_data_parallel_world1(dp_run, dp_child, run_dir, run_launches,
                                   train["steps"])
        test_lines, test_launches, test_s = _cli_result(test_run)
        warm_lines, warm_launches, warm_s = _cli_result(warm_run)
        warm_dir = run_dir.parent / "warm_start"
        done, warm_done = _done(run_lines), _done(warm_lines)
        # trainer.telemetry=auto: the train child's events, read back.
        sum_code, sum_text, report = _summarize_cli(run_dir / "telemetry")
        gauges = next(e["metrics"] for e in reversed(
            read_events(run_dir / "telemetry" / "events.jsonl"))
            if e["kind"] == "metrics")
        delta = {m.group(1): dict(zip(("delta_mse_x1e5", "delta_nll",
                                       "delta_mix"), map(float, m.groups()[1:])))
                 for m in map(DELTA_LINE.fullmatch, test_lines) if m}
        first_train = {
            name: [r for r in read_records(d) if "lr-Adam" in r][0]["loss/total/train"]
            for name, d in (("run", run_dir), ("warm_start", warm_dir))}
        files = {f"{d.name}/{tag}": verify_checkpoint(d / "checkpoints" / tag,
                                                     require_manifest=True)
                 for d in (run_dir, warm_dir) for tag in ("best", "last")}
        quality = _quality_of_run(ckpts, run_dir / "telemetry")
        # The trained ``best`` (its fingerprint with it) is serve_swap's
        # candidate.
        kept = swap_root() / "driver"
        shutil.rmtree(kept, ignore_errors=True)
        kept.mkdir(parents=True)
        shutil.copytree(ckpts / "best", kept / "best")
        shutil.copy2(ckpts / "best.json", kept / "best.json")
    finally:
        shutil.rmtree(save_dir, ignore_errors=True)
    out = {
        "phase": "driver",
        "seconds": {"train": run_s, "test": test_s, "warm_start": warm_s},
        "windows_per_s": {"train": done["steps_per_s"],
                          "train_before_telemetry": DRIVER_DONE_BEFORE,
                          "warm_start": warm_done["steps_per_s"],
                          "trainer_fit": train["windows_per_s"]},
        "telemetry": {
            "summarize_exit": sum_code,
            "compiles": report.get("compiles"),
            "utilization": {k: (report.get("utilization") or {}).get(k)
                            for k in ("program", "flops_per_step",
                                      "bytes_per_step",
                                      "flops_utilization_pct",
                                      "bytes_utilization_pct", "regime")},
            "utilization_line": next((ln for ln in sum_text.splitlines()
                                      if ln.startswith("utilization")), None),
            "host_s": gauges["telemetry/host_s"]["value"],
            "memory_peak_bytes": (report.get("memory") or {}).get("peak_bytes"),
        },
        "done": {"train": done, "warm_start": warm_done},
        "val_loss_initial": train["val_loss_initial"],
        "best_val_trainer_fit": train["best_val_loss"],
        "best_val_rel_gap": abs(done["best_val"] - train["best_val_loss"])
        / train["best_val_loss"],
        "first_epoch_train_loss": first_train,
        "delta_losses": delta,
        "checkpoints": files,
        "quality": quality,
        "launches": {"train": run_launches, "test": test_launches,
                     "warm_start": warm_launches},
    }
    emit(out)
    _check_quality("driver", quality)
    values = [*done.values(), *warm_done.values(), *first_train.values(),
              *(v for row in delta.values() for v in row.values())]
    if sorted(delta) != ["model", "ols"] or not np.isfinite(values).all():
        raise AssertionError(f"driver: missing or non-finite results: {out}")
    if not all(files.values()):
        raise AssertionError(f"driver: checkpoint missing: {files}")
    tel = out["telemetry"]
    if (sum_code != 0 or (tel["compiles"] or {}).get("train_epoch") != 1
            or not (tel["utilization"]["flops_utilization_pct"] or 0) > 0):
        raise AssertionError(f"driver: telemetry: {tel} {sum_text}")
    # The composed default is phase_train's spec, seed and data, and each
    # epoch's draws follow (seed, epoch): the driver's run is phase_train's
    # (its done line rounds to 6 digits; a wrong lr or dropout moves the
    # best val by far more than DRIVER_RTOL).
    if not out["best_val_rel_gap"] <= DRIVER_RTOL:
        raise AssertionError(f"driver: best val {done['best_val']} is not "
                             f"Trainer.fit's {train['best_val_loss']}")
    if not done["best_val"] < train["val_loss_initial"]:
        raise AssertionError("driver: val loss did not fall below the initial "
                             f"weights': {done['best_val']}")
    if not first_train["warm_start"] < first_train["run"]:
        raise AssertionError(f"driver: the warm start did not start lower: "
                             f"{first_train}")
    # Each training step of model=small runs the masked pair forward, its
    # sweep and its pass; val, test and the ΔL table the maskless pair.
    path = ("lstm_pair_fwd_masked", "lstm_pair_bwd", "lstm_wgrad")
    missed = {k: run_launches[k] for k in path
              if run_launches[k] != train["steps"]}
    missed.update({f"warm_start/{k}": warm_launches[k] for k in path
                   if warm_launches[k] != train["steps"] // TRAIN_EPOCHS})
    missed.update({f"{name}/lstm_pair_fwd": counts["lstm_pair_fwd"]
                   for name, counts in (("train", run_launches),
                                        ("test", test_launches))
                   if counts["lstm_pair_fwd"] == 0})
    if missed:
        raise AssertionError(f"driver: kernels off the path: {missed}")
    return out


# --------------------------------------- data-parallel training (one card)

# The one card runs the data-parallel path at world size 1 on NCCL: the
# driver's own train command with the strategy and the device count added,
# whose rows and weights must be the driver child's bit for bit.
DP_WORLD1 = ("trainer.strategy=tpu_xla", "+trainer.n_devices=1")


def _tensors_equal(a: Path, b: Path) -> bool:
    """The state dicts of two ``state.pt`` files, bit for bit."""
    sa = torch.load(a, map_location="cpu", weights_only=True)["state_dict"]
    sb = torch.load(b, map_location="cpu", weights_only=True)["state_dict"]
    return sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)


def _history_rows(log_dir: Path) -> list:
    return [r for r in read_records(log_dir) if "lr-Adam" in r]


def _rows_mismatch(got: list, want: list) -> dict:
    """Where two runs' history rows part: the first row and key that
    differ, both values, every differing key of the first row that parts
    (``keys``: got, want), and the worst abs and relative error over every
    numeric key the rows share."""
    out: dict = {"rows": [len(got), len(want)]}
    worst_abs = worst_rel = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        for key in sorted(set(a) | set(b)):
            va, vb = a.get(key), b.get(key)
            if va != vb and "first" not in out:
                out["first"] = {"row": i, "key": key, "got": va, "want": vb}
                out["keys"] = {k: [a.get(k), b.get(k)]
                               for k in sorted(set(a) | set(b))
                               if a.get(k) != b.get(k)}
            if (isinstance(va, (int, float)) and isinstance(vb, (int, float))
                    and va != vb):
                err = abs(float(va) - float(vb))
                worst_abs = max(worst_abs, err)
                worst_rel = max(worst_rel, err / max(abs(float(vb)), 1e-30))
    out.update(worst_abs=worst_abs, worst_rel=worst_rel)
    return out


def _start_data_parallel_world1(common: list) -> "_Child":
    """The driver's train command at world size 1 on NCCL, into its own save
    dir; started beside the driver's test and warm start."""
    save_dir = Path(tempfile.mkdtemp(
        prefix="dp_", dir=Path(__file__).resolve().parent / "data" / "chip_smoke"))
    overrides = [o for o in common if not o.startswith("logger.save_dir=")]
    child = _Child("train", *overrides, f"logger.save_dir={save_dir}",
                   f"trainer.max_epochs={TRAIN_EPOCHS}", *DP_WORLD1,
                   side_by_side=3)
    child.save_dir = save_dir
    return child


def phase_data_parallel_world1(child_result, child: "_Child", run_dir: Path,
                               run_launches: dict, steps: int) -> dict:
    """The world-1 NCCL child against the driver's train child (``run_dir``):
    every history row and the ``best`` and ``last`` weights bit for bit;
    one capture of the train program; a ``grad_sync`` event of one
    collective over the flat gradient's bytes; one gradient all-reduce a
    step, counted through the graph's replays, and one all-reduce of the
    metric sums for each epoch's train and val splits and for the test
    split."""
    try:
        lines, launches, seconds = _cli_result(child_result)
        collectives = json.loads(
            child_result[0].stdout.splitlines()[-1])["collectives"]
        dp_dir = child.save_dir / "FinancialLstm" / "synthetic" / run_dir.name
        tel_dir = dp_dir / "telemetry"
        events = read_events(tel_dir / "events.jsonl")
        started = next(e for e in events if e["kind"] == "run_started")
        sync = next((e for e in events if e["kind"] == "grad_sync"), {})
        epoch1 = next(e for e in events
                      if e["kind"] == "epoch" and e.get("epoch") == 1)
        sum_code, sum_text, report = _summarize_cli(tel_dir)
        rows_equal = _history_rows(dp_dir) == _history_rows(run_dir)
        weights_equal = {tag: _tensors_equal(
            dp_dir / "checkpoints" / tag / "state.pt",
            run_dir / "checkpoints" / tag / "state.pt")
            for tag in ("best", "last")}
        n_params = sum(p.numel() for p in _train_spec().build_module(
            device="cpu").parameters())
    finally:
        shutil.rmtree(child.save_dir, ignore_errors=True)
    steps_per_epoch = epoch1["steps"]
    device_s = epoch1.get("device_s")
    out = {
        "phase": "data_parallel", "part": "world1", "seconds": seconds,
        "backend": "nccl" if DEVICE == "cuda" else "gloo",
        "world": started.get("n_devices"),
        "strategy": started.get("strategy"),
        "distributed": started.get("distributed"),
        "rows_bit_equal_to_driver": rows_equal,
        "weights_bit_equal_to_driver": weights_equal,
        "grad_sync": {k: sync.get(k) for k in ("collectives_per_step",
                                              "grad_reduce_bytes",
                                              "flat_buffers")},
        "flat_gradient_bytes": 4 * n_params,
        "compiles": report.get("compiles"),
        "summarize_exit": sum_code,
        "steps_per_epoch": steps_per_epoch,
        "collectives": collectives,
        "epoch1_device_ms_per_step": (1e3 * device_s / steps_per_epoch
                                      if device_s else None),
        "launches": {k: v for k, v in launches.items() if v},
    }
    emit(out)
    if not (rows_equal and all(weights_equal.values())):
        raise AssertionError(f"data_parallel: the world-1 NCCL run is not the "
                             f"driver's solo run: {out}")
    if (started.get("strategy") != "tpu_xla" or started.get("n_devices") != 1
            or sync.get("collectives_per_step") != 1
            or sync.get("grad_reduce_bytes") != 4 * n_params
            or sum_code != 0
            or (report.get("compiles") or {}).get("train_epoch") != 1):
        raise AssertionError(f"data_parallel: telemetry: {out} {sum_text}")
    if (steps_per_epoch != steps // TRAIN_EPOCHS
            or collectives["all_reduce_grad"] != steps
            or collectives["all_reduce_sums"] != 2 * TRAIN_EPOCHS + 1):
        raise AssertionError(f"data_parallel: not one gradient all-reduce a "
                             f"graphed step: {collectives}")
    path = ("lstm_pair_fwd_masked", "lstm_pair_bwd", "lstm_wgrad",
            "lstm_pair_fwd")
    missed = {k: (launches[k], run_launches[k]) for k in path
              if launches[k] != run_launches[k]}
    if missed:
        raise AssertionError(f"data_parallel: kernels off the path: {missed}")
    return out


def phase_data_parallel_asset(child_result, child: "_Child",
                              records: list) -> dict:
    """The universe train child's command with asset sharding at world size
    1 on NCCL and one epoch: its first history row bit for bit the
    universe child's."""
    try:
        lines, launches, seconds = _cli_result(child_result)
        run_dir = (child.save_dir / "FinancialLstm" / "universe"
                   / "combined_kfactor_lr0.0001_fast")
        rows = _history_rows(run_dir)
        events = read_events(run_dir / "telemetry" / "events.jsonl")
        started = next(e for e in events if e["kind"] == "run_started")
        sync = next((e for e in events if e["kind"] == "grad_sync"), {})
    finally:
        shutil.rmtree(child.save_dir, ignore_errors=True)
    out = {
        "phase": "data_parallel", "part": "asset_world1", "seconds": seconds,
        "first_row": rows[0] if rows else None,
        "first_row_bit_equal_to_universe": bool(rows) and rows[0] == records[0],
        "strategy": started.get("strategy"), "world": started.get("n_devices"),
        "collectives_per_step": sync.get("collectives_per_step"),
        "launches": {k: v for k, v in launches.items() if v},
    }
    emit(out)
    if not (out["first_row_bit_equal_to_universe"] and len(rows) == 1
            and out["collectives_per_step"] == 1
            and out["strategy"] == "tpu_xla"):
        raise AssertionError(f"data_parallel: asset sharding at world size 1 "
                             f"is not the universe run: {out} {records[0]}")
    if not launches["lstm_fwd"] or not launches["lstm_bwd"]:
        raise AssertionError(f"data_parallel: asset run off the path: {out}")
    return out


def _start_data_parallel_sweeps() -> dict:
    """Beside the resilience phase, on its data: ``-m seed=0,1`` through
    ``launcher=joblib launcher.n_jobs=2`` (two child processes on the card
    at once) and through the sequential launcher, one epoch each; and
    ``trainer.n_devices=2`` on the one card, which must be refused."""
    data = _resilience_data()
    root = Path(tempfile.mkdtemp(
        prefix="dp_sweeps_",
        dir=Path(__file__).resolve().parent / "data" / "chip_smoke"))
    common = [f"datamodule.data_dir={data}",
              f"datamodule.n_samples={RESILIENCE_SAMPLES}",
              "trainer.max_epochs=1"]
    sweep = ["-m", "seed=0,1"]
    return {
        "root": root,
        "pool": _Child("train", *common, *sweep, "launcher=joblib",
                       "launcher.n_jobs=2", f"launcher.sweep_dir={root / 'pool'}",
                       side_by_side=4),
        "sequential": _Child("train", *common, *sweep,
                             f"launcher.sweep_dir={root / 'sequential'}",
                             side_by_side=4),
        "refused": _Child("train", *common, "+trainer.n_devices=2",
                          f"logger.save_dir={root / 'refused'}",
                          side_by_side=4),
    }


def phase_data_parallel_sweeps(children: dict) -> dict:
    """The two sweeps: each job's rows under ``joblib`` bit for bit its
    sequential run's, the two ``joblib`` jobs' runs overlapping in time;
    the two-card request on one card exits non-zero naming the key."""
    root = children["root"]
    try:
        pool_lines, _, pool_s = _cli_result(children["pool"].wait())
        _, _, seq_s = _cli_result(children["sequential"].wait())
        refused, refused_s = children["refused"].wait()
        run = ("logs", *RESILIENCE_RUN, "mse_small_lr0.0001_fast")
        jobs, spans = {}, []
        for job in ("0", "1"):
            pool_dir = root.joinpath("pool", job, *run)
            seq_dir = root.joinpath("sequential", job, *run)
            rows = _history_rows(pool_dir)
            want = _history_rows(seq_dir)
            jobs[job] = {"rows": len(rows),
                         "bit_equal_to_sequential": rows == want}
            if rows != want:
                # Whether the weights parted too, or only the metric rows.
                jobs[job]["mismatch"] = {
                    **_rows_mismatch(rows, want),
                    "weights_bit_equal": {
                        tag: _tensors_equal(
                            pool_dir / "checkpoints" / tag / "state.pt",
                            seq_dir / "checkpoints" / tag / "state.pt")
                        for tag in ("best", "last")}}
            events = read_events(pool_dir / "telemetry" / "events.jsonl")
            spans.append((next(e["ts"] for e in events
                               if e["kind"] == "run_started"),
                          next(e["ts"] for e in events
                               if e["kind"] == "run_finished")))
        refused_written = (root / "refused").exists()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    overlap = min(end for _, end in spans) - max(start for start, _ in spans)
    last_err = refused.stderr.strip().splitlines()[-1:] if refused.stderr else []
    out = {
        "phase": "data_parallel", "part": "sweeps",
        "seconds": {"joblib": pool_s, "sequential": seq_s,
                    "refused": refused_s},
        "joblib_jobs": jobs, "joblib_overlap_s": overlap,
        "joblib_line": next((ln for ln in pool_lines
                             if ln.startswith("multirun: ")), None),
        "two_devices_on_one_card": {"exit": refused.returncode,
                                    "stderr": last_err,
                                    "wrote": refused_written},
    }
    emit(out)
    if not all(j["rows"] == 1 and j["bit_equal_to_sequential"]
               for j in jobs.values()) or not overlap > 0:
        raise AssertionError(f"data_parallel: joblib sweep: {out}")
    if (refused.returncode == 0 or "trainer.n_devices=2" not in refused.stderr
            or refused_written):
        raise AssertionError(f"data_parallel: two devices on one card were "
                             f"not refused: {out}")
    return out


# ------------------------------------------------- stream epoch, real data

STREAM_BATCH = 3  # three windows a step: 1,553 train windows leave a tail
STREAM_EPOCHS = 1  # 518 steps, the last one padded (2 epochs before PR 15)
STREAM_CPU_SAMPLES = 5_000  # the CPU comparison's set: 38 train windows


def _stream_fit(spec, dm, device, epoch_mode="stream", epochs=TRAIN_EPOCHS,
                **kw):
    """``Trainer.fit`` for ``epochs`` epochs, no checkpoints: the result and
    the kernels' launches."""
    trainer = Trainer(max_epochs=epochs, gradient_clip_val=CLIP, seed=0,
                      device=device, epoch_mode=epoch_mode, **kw)
    lk.reset_launch_counts()
    result = trainer.fit(spec, dm)
    return result, dict(lk.LAUNCHES)


def _bit_equal(got, want) -> dict:
    """Which of the losses, the parameters and the Adam moments of two
    ``TrainResult``s are equal bit for bit (``torch.equal``)."""
    keys = ("loss/total/train", "loss/total/val")
    return {
        "losses": all(torch.equal(torch.tensor([g[k] for k in keys]),
                                  torch.tensor([w[k] for k in keys]))
                      for g, w in zip(got.history, want.history)),
        "params": all(torch.equal(got.state[k], v)
                      for k, v in want.state.items()),
        "adam_moments": all(torch.equal(got.opt_state[k], want.opt_state[k])
                            for k in ("mu", "nu")),
    }


def _stream_step_share(spec, dm, steps: int = 300) -> dict:
    """``steps`` stream steps (the epoch's first batches through the
    prefetcher, two ahead, into the graphed ``StreamProgram``), ending
    synchronized: the host wall clock a step, and the device's busy time
    a step from a torch.profiler trace of the same run; the idle share is
    what the card waits for the host. Then the same steps once more under
    the synchronisation check set to raise: no step waits for the card."""
    module = spec.build_module(device=DEVICE,
                               generator=torch.Generator().manual_seed(0))
    optimizer = make_optimizer(module, CLIP, spec.weight_decay)
    program = StreamProgram(module, optimizer, spec.window_objective(),
                            dm.train_arrays(), dm.batch_size,
                            torch.Generator(device=DEVICE).manual_seed(0),
                            graphed=True)

    def queue() -> int:
        batches = weighted_batches(dm.train_batches(0, seed=0), dm.batch_size)
        return program.epoch(LR, prefetch_to_device(
            (b for _, b in zip(range(steps), batches)), 2, DEVICE))[1]

    def run() -> int:
        n_steps = queue()
        torch.cuda.synchronize()
        return n_steps

    steps = run()  # the capture
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        walls.append(1e3 * (time.perf_counter() - t0) / steps)
    busy = sum(op["ms"] for op in device_ops(run, calls=1)) / steps
    wall = float(np.median(walls))
    torch.cuda.set_sync_debug_mode("error")
    try:
        queue()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return {"steps": steps, "host_syncs_per_step": 0,
            "step_wall_ms_p50": wall,
            "step_wall_ms_spread": [min(walls), max(walls)],
            "device_busy_ms": busy, "device_idle_share": 1.0 - busy / wall}


def phase_stream(dm) -> dict:
    """model=small (dropout 0.2) on the 100-stock set with batch_size 3:
    the stream epoch (host batches in the ``(seed, epoch)`` shuffle, the
    prefetcher, the tail padded with a zero-weight copy, one graphed
    weighted step) for one epoch with the prefetcher two batches ahead
    against none, and graphed against ``cuda_graphs=False``: losses,
    parameters and Adam moments bit-equal. With dropout 0, on a smaller
    set of the same DGP (100 x 5,000: the CPU's steps take ~0.2 s), the
    card's stream epoch against the CPU port's. Beside it the scan epoch's
    windows/s at the same batch, and where a stream step's time goes."""
    spec = _train_spec()
    dm3 = FinancialWindowDataModule(dm.data_dir, lookback_window=T,
                                    target_window=30, stride=90,
                                    batch_size=STREAM_BATCH)
    fit = functools.partial(_stream_fit, epochs=STREAM_EPOCHS)
    deep, deep_launches = fit(spec, dm3, DEVICE, prefetch=2)
    flat, flat_launches = fit(spec, dm3, DEVICE, prefetch=0)
    eager, eager_launches = fit(spec, dm3, DEVICE, cuda_graphs=False)
    scan, _ = fit(spec, dm3, DEVICE, epoch_mode="scan")
    n_train = len(dm3.train_range)
    steps = STREAM_EPOCHS * -(-n_train // STREAM_BATCH)

    root = data_dir(K_STOCKS).parent / f"{K_STOCKS}x{STREAM_CPU_SAMPLES}"
    bootstrap_synthetic(root, n_stocks=K_STOCKS, n_samples=STREAM_CPU_SAMPLES,
                        seed=0)
    small = FinancialWindowDataModule(root, lookback_window=T, target_window=30,
                                      stride=90, batch_size=STREAM_BATCH)
    spec0 = _train_spec(dropout=0.0)
    t0 = time.perf_counter()
    card, _ = fit(spec0, small, DEVICE)
    cpu, _ = fit(spec0, small, "cpu")
    cpu_s = time.perf_counter() - t0
    loss_gap = max(abs(g[k] - w[k]) / abs(w[k])
                   for g, w in zip(card.history, cpu.history)
                   for k in ("loss/total/train", "loss/total/val"))
    param_gap = max(float((card.state[k] - v).abs().max())
                    for k, v in cpu.state.items())
    share = _stream_step_share(spec, dm3)
    out = {
        "phase": "stream",
        "batch_size": STREAM_BATCH,
        "train_windows": n_train,
        "tail": n_train % STREAM_BATCH,
        "steps": steps,
        "depth2_vs_depth0_bit_equal": _bit_equal(deep, flat),
        "graphed_vs_eager_bit_equal": _bit_equal(deep, eager),
        "launches": {"depth2": deep_launches, "depth0": flat_launches,
                     "eager": eager_launches},
        "prefetch": [{k: r[k] for k in ("data/get_wait_s",
                                        "data/prefetch_mean_depth")}
                     for r in deep.history],
        "windows_per_s": {"stream": deep.windows_per_sec,
                          "stream_depth0": flat.windows_per_sec,
                          "stream_eager": eager.windows_per_sec,
                          "scan": scan.windows_per_sec},
        "val_loss": {"stream": deep.history[-1]["loss/total/val"],
                     "scan": scan.history[-1]["loss/total/val"]},
        "card_vs_cpu": {"windows": len(small.train_range),
                        "loss_rel_gap": loss_gap, "param_abs_gap": param_gap,
                        "loss_rtol": PARITY_LOSS_RTOL,
                        "param_atol": PARITY_PARAM_TOL, "seconds": cpu_s},
        "stream_step": share,
    }
    emit(out)
    for name in ("depth2_vs_depth0_bit_equal", "graphed_vs_eager_bit_equal"):
        if not all(out[name].values()):
            raise AssertionError(f"stream: {name} fails: {out[name]}")
    if deep_launches != flat_launches or deep_launches != eager_launches:
        raise AssertionError(f"stream: launches differ: {out['launches']}")
    path = ("lstm_pair_fwd_masked", "lstm_pair_bwd", "lstm_wgrad")
    missed = {k: deep_launches[k] for k in path if deep_launches[k] != steps}
    if missed:
        raise AssertionError(f"stream: not once in each of {steps} steps: "
                             f"{missed}")
    if not (loss_gap <= PARITY_LOSS_RTOL and param_gap <= PARITY_PARAM_TOL):
        raise AssertionError(f"stream: the card is not the CPU: {loss_gap}, "
                             f"{param_gap}")
    if not np.isfinite([r["loss/total/val"] for r in deep.history]).all():
        raise AssertionError("stream: non-finite losses")
    return out


FF_SENTINEL_DAYS = (9_000, 15_000, 21_000)  # inside the kept rows


def write_fama_french_csvs(raw_dir: Path, seed: int = 0) -> None:
    """``F-F_Research_Data_Factors_daily.csv`` and
    ``25_Portfolios_5x5_Daily.csv`` in the Ken French data library's
    layout, from a seeded generator: preambles of 4 and 18 lines (each
    closed by a blank line), a header, the published 26,129 daily rows in
    percent (two decimals, the risk-free rate three), -99.99 in every
    portfolio on a few days, and a footer. Returns follow a one-factor
    market model: a daily market excess return ~ N(0.03, 1.0), each
    portfolio's beta in [0.8, 1.3], alpha ~ N(0, 0.01), noise sd 0.3-0.9."""
    ff = FamaFrench25Portfolios
    n = ff.n_samples
    rng = np.random.default_rng(seed)
    market = rng.normal(0.03, 1.0, n)
    rf = rng.uniform(0.0, 0.03, n)
    betas = rng.uniform(0.8, 1.3, 25)
    alphas = rng.normal(0.0, 0.01, 25)
    noise = rng.uniform(0.3, 0.9, 25) * rng.standard_normal((n, 25))
    p25 = alphas + market[:, None] * betas + noise + rf[:, None]
    dates = 19260701 + np.arange(n)
    ff3 = ["This file was created by CMPT_ME_BEME_RETS_DAILY from a seeded",
           "generator in the layout of the Fama-French daily factors file.",
           "The Tbill return is the simple daily rate.", "",
           "," + ",".join(ff.ff3_cols[1:])]
    smb_hml = rng.normal(0.0, 0.5, (n, 2))
    ff3 += [f"{d},{m:8.2f},{a:8.2f},{b:8.2f},{r:9.3f}"
            for d, m, (a, b), r in zip(dates, market, smb_hml, rf)]
    ff3 += ["", "Copyright 2024 Kenneth R. French"]
    lines = ["This file was created by CMPT_ME_BEME_RETS_DAILY from a seeded"]
    lines += (["generator in the layout of the 25 portfolios file."]
              * (ff.p25_skip - 3))
    lines += ["  Average Value Weighted Returns -- Daily", "",
              "," + ",".join(ff.p25_cols[1:])]
    sentinel = ",".join(["  -99.99"] * 25)
    for i, d in enumerate(dates):
        values = (sentinel if i in FF_SENTINEL_DAYS
                  else ",".join(f"{v:8.2f}" for v in p25[i]))
        lines.append(f"{d},{values}")
    lines += ["", "  Average Equal Weighted Returns -- Daily"]
    raw_dir.mkdir(parents=True, exist_ok=True)
    (raw_dir / ff.ff3_filename).write_text("\n".join(ff3) + "\n")
    (raw_dir / ff.p25_filename).write_text("\n".join(lines) + "\n")


def phase_real_medium(train_medium: dict) -> dict:
    """The slice's path at full width: ``python -m masters_thesis_tpu_torch
    train datamodule=real model=medium trainer.epoch_mode=stream`` for 2
    epochs on Ken-French-format CSVs written here (26,129 rows, 25
    portfolios), then ``test`` on its checkpoint root, and the thesis's
    warm start (``checkpoint_mode=params``, 1 epoch) from the synthetic
    model=medium ``best`` of ``train_medium``, each a child process. In
    this process: the initial weights' val loss, the best checkpoint served
    through ``PredictEngine.from_checkpoint`` on the card and on the CPU,
    and the stream epoch against the scan epoch at this shape, with where
    a stream step's time goes."""
    root = Path(__file__).resolve().parent / "data" / "chip_smoke"
    raw, data = root / "ff_raw", root / "ff_real"
    shutil.rmtree(data, ignore_errors=True)
    t0 = time.perf_counter()
    write_fama_french_csvs(raw)
    write_s = time.perf_counter() - t0
    save_dir = Path(tempfile.mkdtemp(prefix="real_", dir=root))
    common = ["datamodule=real", "model=medium", "trainer.epoch_mode=stream",
              f"datamodule.raw_dir={raw}", f"datamodule.data_dir={data}",
              f"logger.save_dir={save_dir}"]
    try:
        run_lines, run_launches, run_s = _cli(
            "train", *common, f"trainer.max_epochs={TRAIN_EPOCHS}")
        run_dir = save_dir / "FinancialLstm" / "real" / "mse_medium_lr0.0001_fast"
        ckpts = run_dir / "checkpoints"
        # The test and the warm start side by side (they share nothing).
        test_run, warm_run = _wait_all([
            _Child("test", *common, f"checkpoint={ckpts}", side_by_side=2),
            _Child("train", *common,
                   f"checkpoint={Path(train_medium['checkpoints']) / 'best'}",
                   "checkpoint_mode=params", "trainer.max_epochs=1",
                   "logger.version=warm_start", side_by_side=2)])
        test_lines, test_launches, test_s = _cli_result(test_run)
        warm_lines, warm_launches, warm_s = _cli_result(warm_run)
        warm_dir = run_dir.parent / "warm_start"
        done, warm_done = _done(run_lines), _done(warm_lines)
        delta = {m.group(1): dict(zip(("delta_mse_x1e5", "delta_nll",
                                       "delta_mix"), map(float, m.groups()[1:])))
                 for m in map(DELTA_LINE.fullmatch, test_lines) if m}
        rows = {name: [r for r in read_records(d) if "lr-Adam" in r]
                for name, d in (("run", run_dir), ("warm_start", warm_dir))}
        trees = {f"{name}/{tag}": verify_checkpoint(d / "checkpoints" / tag,
                                                    require_manifest=True)
                 for name, d in (("run", run_dir), ("warm_start", warm_dir))
                 for tag in ("best", "last")}

        cfg = cli_train.compose_config(common)
        spec = cli_train.build_spec(cfg)
        dm = cli_train.build_datamodule(cfg)
        dm.prepare_data()
        dm.setup()
        n_train = len(dm.train_range)
        module = Trainer(max_epochs=0, seed=cfg.seed, device=DEVICE).build(spec)
        val = device_split(dm.val_arrays(), DEVICE)
        init_val = metric_means(evaluate(module, spec.window_objective(),
                                         val))["total"]
        x = dm.test_arrays().x[:8]
        served = [PredictEngine.from_checkpoint(ckpts, "best", n_stocks=K_MEDIUM,
                                                device=device)
                  for device in (DEVICE, "cpu")]
        served_err = _max_err(served[0].predict(x), served[1].predict(x))
    finally:
        shutil.rmtree(save_dir, ignore_errors=True)
    # One epoch each (timed whole, the capture included: ~1 ms of ~1.5 s).
    stream, stream_launches = _stream_fit(spec, dm, DEVICE, epochs=1)
    scan, _ = _stream_fit(spec, dm, DEVICE, epoch_mode="scan", epochs=1)
    share = _stream_step_share(spec, dm)
    steps = TRAIN_EPOCHS * n_train  # batch_size 1: no tail to pad
    out = {
        "phase": "real_medium",
        "csv_rows": FamaFrench25Portfolios.n_samples,
        "days": int(np.load(data / "market.npy").shape[0]),
        "windows": {"train": n_train, "val": len(dm.val_range),
                    "test": len(dm.test_range)},
        "x_mb": sum(getattr(dm, f"{split}_arrays")().x.nbytes
                    for split in ("train", "val", "test")) / 2**20,
        "csv_write_seconds": write_s,
        "seconds": {"train": run_s, "test": test_s, "warm_start": warm_s},
        "done": {"train": done, "warm_start": warm_done},
        "windows_per_s": {"driver_stream": done["steps_per_s"],
                          "trainer_fit_stream": stream.windows_per_sec,
                          "trainer_fit_scan": scan.windows_per_sec},
        "stream_step": share,
        "val_loss_initial": init_val,
        "epochs": {name: [{k: r[k] for k in r if k.startswith(("loss/total",
                                                               "data/"))}
                          for r in rs] for name, rs in rows.items()},
        "delta_losses": delta,
        "checkpoints_verified": trees,
        "served_best_max_abs_err": served_err,
        "served_tol": SERVE_TOL,
        "steps": steps,
        "launches": {"train": run_launches, "test": test_launches,
                     "warm_start": warm_launches,
                     "trainer_fit_stream": stream_launches},
    }
    emit(out)
    values = [*done.values(), *warm_done.values(),
              *(v for row in delta.values() for v in row.values())]
    if sorted(delta) != ["model", "ols"] or not np.isfinite(values).all():
        raise AssertionError(f"real_medium: missing or non-finite results: {out}")
    if not all(trees.values()):
        raise AssertionError(f"real_medium: a checkpoint does not verify: {trees}")
    if not done["best_val"] < init_val:
        raise AssertionError(f"real_medium: val loss {done['best_val']} not "
                             f"below the initial weights' {init_val}")
    path = ("lstm_stack_fwd_masked", "lstm_stack_bwd", "lstm_wgrad")
    missed = {f"train/{k}": run_launches[k] for k in path
              if run_launches[k] != steps}
    missed.update({f"warm_start/{k}": warm_launches[k] for k in path
                   if warm_launches[k] != n_train})
    missed.update({f"trainer_fit_stream/{k}": stream_launches[k] for k in path
                   if stream_launches[k] != n_train})
    missed.update({f"{name}/lstm_stack_fwd": counts["lstm_stack_fwd"]
                   for name, counts in (("train", run_launches),
                                        ("test", test_launches))
                   if counts["lstm_stack_fwd"] == 0})
    if missed:
        raise AssertionError(f"real_medium: kernels off the path: {missed}")
    if not served_err <= SERVE_TOL:
        raise AssertionError(f"real_medium: from_checkpoint on the card is "
                             f"not the CPU engine: {served_err}")
    return out


RESILIENCE_SAMPLES = 20_000  # 155 train windows: short child runs
RESILIENCE_RUN = ("FinancialLstm", "synthetic")
RESTARTS_LINE = "restarts       : 1 (2 attempts)"


def _resilience_data() -> Path:
    """The resilience phase's data (100 stocks x 20,000 samples), made and
    windowed once, before its children start."""
    data = (Path(__file__).resolve().parent / "data" / "chip_smoke"
            / f"{K_STOCKS}x{RESILIENCE_SAMPLES}")
    bootstrap_synthetic(data, n_stocks=K_STOCKS, n_samples=RESILIENCE_SAMPLES,
                        seed=0)
    FinancialWindowDataModule(data, lookback_window=T, target_window=30,
                              stride=90).prepare_data()
    return data


class _Supervised:
    """``python -m masters_thesis_tpu_torch.resilience run`` around a train
    child (``_CLI_CHILD``, as ``python -m masters_thesis_tpu_torch train``
    runs) on the card, with ``plan`` in the environment (attempt 1 only):
    its own ``events.jsonl`` and each attempt's output under ``run_dir``,
    the child's telemetry under ``<log_dir>/telemetry``."""

    def __init__(self, run_dir: Path, log_dir: Path, overrides: list,
                 plan: str, side_by_side: int):
        env = {k: v for k, v in os.environ.items()
               if k not in (faults.FAULT_PLAN_ENV, faults.ATTEMPT_ENV,
                            "MTT_LR_SCALE")}
        env[faults.FAULT_PLAN_ENV] = plan
        env["OMP_NUM_THREADS"] = str(max(1, (os.cpu_count() or 1)
                                         // side_by_side))
        self.run_dir, self.log_dir = run_dir, log_dir
        self.out = tempfile.TemporaryFile("w+")
        self.err = tempfile.TemporaryFile("w+")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "masters_thesis_tpu_torch.resilience",
             "run", "--run-dir", str(run_dir),
             "--watch-dir", str(log_dir / "telemetry"),
             "--ckpt-dir", str(log_dir / "checkpoints"),
             "--backoff-s", "0.5", "--attempt-timeout-s", "300",
             "--retry-budget-s", "600", "--quiet", "--",
             sys.executable, "-c", _CLI_CHILD, "train", "--device", DEVICE,
             *overrides, "trainer.resume=auto"],
            cwd=Path(__file__).resolve().parent, env=env, stdout=self.out,
            stderr=self.err, text=True)

    def wait(self, timeout: float = 700) -> tuple[int, str, float]:
        """The supervisor's exit code, its stderr and its seconds."""
        try:
            code = self.proc.wait(timeout)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
        seconds = time.perf_counter() - self.t0
        self.err.seek(0)
        err = self.err.read()
        self.out.close()
        self.err.close()
        return code, err, seconds


def _summarize_cli(run_dir: Path) -> tuple[int, str, dict]:
    """``python -m masters_thesis_tpu_torch.telemetry summarize`` on
    ``run_dir`` (a child that imports no torch): its exit code, its text
    and its report (``--json``)."""
    args = [sys.executable, "-m", "masters_thesis_tpu_torch.telemetry",
            "summarize", str(run_dir)]
    cwd = Path(__file__).resolve().parent
    text = subprocess.run(args, cwd=cwd, capture_output=True, text=True,
                          timeout=120)
    report = subprocess.run(args + ["--json"], cwd=cwd, capture_output=True,
                            text=True, timeout=120)
    return text.returncode, text.stdout, json.loads(report.stdout or "{}")


class _Fleet:
    """``python -m masters_thesis_tpu_torch.resilience fleet --nprocs 1``
    around one NCCL rank of the train child (``_CLI_CHILD``, as ``python -m
    masters_thesis_tpu_torch train`` runs) on the card, with ``plan`` in
    the environment (attempt 1, so generation 0 only): the supervisor's
    ``events.jsonl`` under ``<run_dir>/supervisor``, each generation's rank
    output and telemetry under ``<run_dir>/g<gen>/p0``."""

    def __init__(self, run_dir: Path, ckpt_dir: Path, overrides: list,
                 plan: str, side_by_side: int):
        env = {k: v for k, v in os.environ.items()
               if k not in (faults.FAULT_PLAN_ENV, faults.ATTEMPT_ENV,
                            "MTT_LR_SCALE", "MTT_GENERATION")}
        env[faults.FAULT_PLAN_ENV] = plan
        env["OMP_NUM_THREADS"] = str(max(1, (os.cpu_count() or 1)
                                         // side_by_side))
        self.run_dir = run_dir
        self.err = tempfile.TemporaryFile("w+")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "masters_thesis_tpu_torch.resilience",
             "fleet", "--nprocs", "1", "--min-nprocs", "1",
             "--run-dir", str(run_dir), "--ckpt-dir", str(ckpt_dir),
             "--hang-timeout-s", "120", "--backoff-s", "0.5",
             "--backoff-factor", "1", "--max-generations", "3", "--",
             sys.executable, "-c", _CLI_CHILD, "train", "--device", DEVICE,
             *overrides, *DP_WORLD1, "trainer.resume=auto",
             "trainer.telemetry={out}"],
            cwd=Path(__file__).resolve().parent, env=env,
            stdout=subprocess.DEVNULL, stderr=self.err, text=True)

    def wait(self, timeout: float = 700) -> tuple[int, str, float]:
        """The supervisor's exit code, its stderr and its seconds."""
        try:
            code = self.proc.wait(timeout)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
        seconds = time.perf_counter() - self.t0
        self.err.seek(0)
        err = self.err.read()
        self.err.close()
        return code, err, seconds


def _same_checkpoints(got: Path, want: Path) -> dict:
    """``best`` and ``last`` of two checkpoint dirs: weights, optimizer
    state, scheduler and meta, bit for bit."""
    equal = {}
    for tag in ("best", "last"):
        a, b = load_checkpoint(got, tag), load_checkpoint(want, tag)
        equal[tag] = (
            a[0].keys() == b[0].keys()
            and all(torch.equal(a[0][k], v) for k, v in b[0].items())
            and all(torch.equal(a[1][k], v) if torch.is_tensor(v)
                    else a[1][k] == v for k, v in b[1].items())
            and a[2:] == b[2:])
    return equal


def _fleet_view(command: str, run_dir: Path) -> tuple[int, str]:
    """``python -m masters_thesis_tpu_torch.telemetry <command> <run_dir>``
    (a child that imports no torch): its exit code and its text."""
    proc = subprocess.run(
        [sys.executable, "-m", "masters_thesis_tpu_torch.telemetry", command,
         str(run_dir)], cwd=Path(__file__).resolve().parent,
        capture_output=True, text=True, timeout=120)
    return proc.returncode, proc.stdout


#: The training kernels (rows 5-6 of the port's table) on the fleet's path.
FLEET_PATH = ("lstm_pair_fwd_masked", "lstm_pair_bwd", "lstm_wgrad")


def phase_fleet(fleet: "_Fleet", runs: Path, whole_launches: dict,
                resumed_launches: dict) -> dict:
    """The training fleet (``resilience fleet``) on the card: one NCCL rank
    of ``train`` at model=small's full width on the resilience phase's data
    (3 epochs), run beside that phase's children, its generation 0 killed
    right after epoch 1 is dispatched (``trainer.epoch_dispatched``).
    Held: ``verdict=completed`` in 2 generations, not resized; generation
    0's ``fleet_failure`` transient with rc 137; the relaunch resumed from
    ``last`` or ``last.prev``; the final ``best`` and ``last`` bit for bit
    the unbroken run's (``whole``); generation 1's ``run_started`` a rank
    of a group of 1 on the card; its last heartbeat's collective schedule
    the barriers and one ``pmean`` an epoch; ``telemetry postmortem`` and
    ``aggregate`` exit 0 with generation 0 ``superseded``; generation 1's
    launches of the pair's training kernels nonzero and equal to a run's
    resumed at epoch 1 (which trains 2 epochs, the mean of the unbroken
    run's 3 and the supervised run's resumed 1: a fit launches a fixed
    number, plus the same number an epoch). Printed: the time to recover
    (generation 0's failure to generation 1's first ``epoch`` event), the
    lost work and the teardown's seconds, beside the card."""
    code, err, seconds = fleet.wait()
    run_dir = fleet.run_dir
    if code != 0:
        raise AssertionError(f"fleet: the supervisor exited {code}: "
                             f"{err[-3000:]}")
    events = read_events(run_dir / "supervisor" / "events.jsonl")
    failures = [e for e in events if e["kind"] == "fleet_failure"]
    relaunches = [e for e in events if e["kind"] == "fleet_relaunch"]
    verdict = next(e for e in events if e["kind"] == "fleet_verdict")
    rank_events = read_events(run_dir / "g1" / "p0" / "events.jsonl")
    started = next(e for e in rank_events if e["kind"] == "run_started")
    first_epoch = next(e["ts"] for e in rank_events if e["kind"] == "epoch")
    heartbeat = json.loads((run_dir / "g1" / "p0" / "heartbeat.json")
                           .read_text())
    chain = heartbeat.get("collective_schedule") or {}
    tail = chain.get("tail") or []
    lines = (run_dir / "g1" / "p0.out").read_text().splitlines()
    launches = json.loads(lines[-1])["launches"]
    post_code, post_text = _fleet_view("postmortem", run_dir)
    agg_code, _ = _fleet_view("aggregate", run_dir)
    statuses = dict(re.findall(r"^\s+(g\d+/p\d+)\s+(\w+)", post_text,
                               re.MULTILINE))
    equal = _same_checkpoints(runs / "fleet" / "checkpoints",
                              runs / "whole" / "checkpoints")
    expected = {k: (whole_launches.get(k, 0) + resumed_launches.get(k, 0)) / 2
                for k in FLEET_PATH}
    fail = failures[0] if failures else {}
    out = {
        "phase": "fleet",
        "card": _card(),
        "seconds": seconds,
        "verdict": {k: verdict[k] for k in ("verdict", "generations",
                                            "final_nprocs", "resized")},
        "failures": [{k: f.get(k) for k in ("gen", "rank", "rc",
                                            "classification", "lost_work_s",
                                            "teardown_s")}
                     for f in failures],
        "resumed_from": relaunches[0]["resumed_from"] if relaunches else None,
        "time_to_recover_s": first_epoch - fail.get("failed_at_ts", first_epoch),
        "lost_work_s": fail.get("lost_work_s"),
        "teardown_s": fail.get("teardown_s"),
        "backoff_s": relaunches[0]["backoff_s"] if relaunches else None,
        "run_started": {k: started.get(k) for k in ("n_devices", "strategy",
                                                    "platform", "start_epoch",
                                                    "distributed")},
        "schedule": {"n": chain.get("n"),
                     "barriers": sum(e["kind"] == "barrier" for e in tail),
                     "pmean_steps": [e["step"] for e in tail
                                     if e["kind"] == "pmean"]},
        "postmortem_exit": post_code,
        "aggregate_exit": agg_code,
        "statuses": statuses,
        "bit_equal_to_unbroken": equal,
        "launches": {k: v for k, v in launches.items() if v},
        "launches_expected": expected,
    }
    emit(out)
    if (verdict["verdict"] != "completed" or verdict["generations"] != 2
            or verdict["resized"] or len(failures) != 1
            or (fail["gen"], fail["rc"], fail["classification"])
            != (0, 137, "transient")
            or Path(out["resumed_from"] or "").name not in ("last",
                                                            "last.prev")):
        raise AssertionError(f"fleet: supervision: {out}")
    dist = started.get("distributed") or {}
    if (started.get("n_devices") != 1 or started.get("platform") != "cuda"
            or started.get("start_epoch") != 1
            or dist.get("process_count") != 1
            or not str(dist.get("coordinator", "")).startswith("file://")):
        raise AssertionError(f"fleet: generation 1 is no rank of a group of "
                             f"1 on the card: {started}")
    if (out["schedule"]["pmean_steps"] != [1, 2] or chain.get("n") != len(tail)
            or chain["n"] != out["schedule"]["barriers"] + 2):
        raise AssertionError(f"fleet: the collective schedule: {out['schedule']}")
    if (post_code != 0 or agg_code != 0
            or statuses.get("g0/p0") != "superseded"
            or statuses.get("g1/p0") != "finished"):
        raise AssertionError(f"fleet: postmortem {post_code} aggregate "
                             f"{agg_code}: {post_text}")
    if not all(equal.values()):
        raise AssertionError(f"fleet: the relaunched fleet is not the "
                             f"unbroken run: {equal}")
    if not all(launches.get(k) for k in FLEET_PATH + ("lstm_pair_fwd",)) or \
            any(launches[k] != expected[k] for k in FLEET_PATH):
        raise AssertionError(f"fleet: generation 1's kernels: {launches} "
                             f"against {expected}")
    return out


def phase_resilience(profile_child: "_Child | None" = None) -> dict:
    """Crash-safe checkpoints and the run supervisor through the entry
    point (model=small, 100 stocks x 20,000 samples, child processes side
    by side): an unbroken 3-epoch run; a supervised run (``resilience
    run``) whose attempt 1 is killed by ``MTT_FAULT_PLAN`` (SIGKILL) at
    ``checkpoint.mid_publish`` of the epoch-1 save of ``last`` and which
    the supervisor relaunches with ``trainer.resume=auto``: 2 attempts,
    attempt 1 ``transient``, ``verdict=completed``, its final ``best`` and
    ``last`` bit for bit the unbroken run's, ``telemetry summarize`` exit 0
    with one restart; and a run whose last save of ``last`` (epoch 2;
    validation every 2 epochs, so ``last.prev`` is epoch 1's) is corrupted
    after its publish, after which the restore falls back to ``last.prev``
    with its stderr line and ``PredictEngine.from_checkpoint`` refuses the
    tree. The torn layout is the resumed child's report of what it found.
    Printed: the time to recover (attempt 1's end to attempt 2's first
    ``epoch`` event), the lost work as ``summarize`` reports it, and the
    seconds of each ``checkpoint_saved``."""
    root = Path(__file__).resolve().parent / "data" / "chip_smoke"
    data = _resilience_data()
    save_dir = Path(tempfile.mkdtemp(prefix="resilience_", dir=root))
    common = [f"datamodule.data_dir={data}",
              f"datamodule.n_samples={RESILIENCE_SAMPLES}",
              f"logger.save_dir={save_dir}", "trainer.max_epochs=3"]
    runs = save_dir.joinpath(*RESILIENCE_RUN)
    kill = json.dumps([{"point": "checkpoint.mid_publish", "kind": "kill",
                        "match": {"tag": "last", "epoch": 1}}])
    corrupt = json.dumps({"seed": 7, "faults": [
        {"point": "checkpoint.post_publish", "kind": "corrupt",
         "match": {"tag": "last", "epoch": 2}}]})
    fleet_kill = json.dumps([{"point": "trainer.epoch_dispatched",
                              "kind": "kill", "match": {"epoch": 1}}])
    fleet = None
    try:
        supervised = _Supervised(save_dir / "supervisor", runs / "split",
                                 [*common, "logger.version=split"], kill,
                                 side_by_side=3)
        fleet = _Fleet(save_dir / "fleet_run", runs / "fleet" / "checkpoints",
                       [*common, "logger.version=fleet"], fleet_kill,
                       side_by_side=3)
        (whole, whole_s), (corrupted, corrupted_s) = _wait_all([
            _Child("train", *common, "logger.version=whole", side_by_side=3),
            _Child("train", *common, "logger.version=corrupt",
                   "trainer.check_val_every_n_epoch=2", plan=corrupt,
                   side_by_side=3)])
        sup_code, sup_err, sup_s = supervised.wait()
        profile = (phase_telemetry_profile(profile_child)
                   if profile_child is not None else None)
        for name, proc in (("unbroken", whole), ("corrupted", corrupted)):
            if proc.returncode != 0:
                raise AssertionError(f"resilience: the {name} run exited "
                                     f"{proc.returncode}: {proc.stderr[-3000:]}")
        sup_dir = save_dir / "supervisor"
        if sup_code != 0:
            raise AssertionError(
                f"resilience: the supervisor exited {sup_code}: "
                f"{sup_err[-3000:]}")
        sup_events = read_events(sup_dir / "events.jsonl")
        attempts = [e for e in sup_events if e["kind"] == "attempt_finished"]
        killed_err = (sup_dir / "attempt_1.err").read_text()
        resumed_err = (sup_dir / "attempt_2.err").read_text()
        resumed_lines = (sup_dir / "attempt_2.out").read_text().splitlines()
        launches = json.loads(resumed_lines[-1])["launches"]
        torn = next((line.split(": found ", 1)[1].rsplit(";", 1)[0].split()
                     for line in resumed_err.splitlines()
                     if line.startswith("[checkpoint] interrupted publish")
                     and "/last:" in line), [])
        equal = _same_checkpoints(runs / "split" / "checkpoints",
                                  runs / "whole" / "checkpoints")
        child_events = read_events(runs / "split" / "telemetry" / "events.jsonl")
        attempt_1_end = next(e["ts"] for e in attempts if e["n"] == 1)
        first_epoch = next(e["ts"] for e in child_events
                           if e["kind"] == "epoch" and e["attempt"] == 2)
        attempt_2_start = next(e["ts"] for e in sup_events
                               if e["kind"] == "attempt_started" and e["n"] == 2)
        run_started_2 = next(e["ts"] for e in child_events
                             if e["kind"] == "run_started" and e["attempt"] == 2)
        sum_code, sum_text, report = _summarize_cli(runs / "split" / "telemetry")
        saves = [{"attempt": e["attempt"], "tag": e["tag"], "epoch": e["epoch"],
                  "wall_s": e["wall_s"]}
                 for e in child_events if e["kind"] == "checkpoint_saved"]
        ckpts = runs / "corrupt" / "checkpoints"
        picked = last_verified_checkpoint(ckpts)
        stderr = io.StringIO()
        with contextlib.redirect_stderr(stderr):
            _, _, _, meta = restore_checkpoint(ckpts, "last")
        try:
            PredictEngine.from_checkpoint(ckpts, "last", n_stocks=K_STOCKS,
                                          device=DEVICE)
            refused = False
        except CorruptCheckpointError:
            refused = True
        fleet_out = phase_fleet(
            fleet, runs, json.loads(whole.stdout.splitlines()[-1])["launches"],
            launches)
    finally:
        if fleet is not None and fleet.proc.poll() is None:
            fleet.proc.kill()
            fleet.proc.wait()
        shutil.rmtree(save_dir, ignore_errors=True)
    out = {
        "phase": "resilience",
        "seconds": {"unbroken": whole_s, "corrupted": corrupted_s,
                    "supervised": sup_s},
        "verdict_line": next((ln for ln in sup_err.splitlines()
                              if "verdict=" in ln), None),
        "attempts": [{k: a[k] for k in ("n", "rc", "classification",
                                        "wall_s", "lost_work_s")}
                     for a in attempts],
        "killed_fired": "[faults] firing kind=kill at point=checkpoint.mid_publish"
        in killed_err,
        "torn_layout": torn,
        "resumed_bit_equal": equal,
        "time_to_recover_s": first_epoch - attempt_1_end,
        "time_to_recover_parts_s": {
            "backoff_and_launch": attempt_2_start - attempt_1_end,
            "start_to_run_started": run_started_2 - attempt_2_start,
            "run_started_to_first_epoch": first_epoch - run_started_2},
        "lost_work_s": report.get("restarts", {}).get("lost_work_s"),
        "supervisor_lost_work_s": next(
            (e["lost_work_s"] for e in sup_events
             if e["kind"] == "supervisor_verdict"), None),
        "checkpoint_saved": saves,
        "summarize_exit": sum_code,
        "summarize_restarts": next((ln for ln in sum_text.splitlines()
                                    if ln.startswith("restarts")), None),
        "launches": {k: v for k, v in launches.items() if v},
        "corrupt_fired": "[faults] firing kind=corrupt" in corrupted.stderr,
        "last_verified_checkpoint": picked and Path(picked).name,
        "restored_epoch": meta["epoch"],
        "fallback_line": stderr.getvalue().strip(),
        "from_checkpoint_refused": refused,
    }
    emit(out)
    if (not out["killed_fired"] or attempts[0]["rc"] != -9
            or "last" in torn or "last.new" not in torn
            or "last.prev" not in torn):
        raise AssertionError(f"resilience: the kill did not tear the publish: "
                             f"{out}")
    if ("verdict=completed attempts=2" not in (out["verdict_line"] or "")
            or [a["classification"] for a in attempts]
            != ["transient", "success"]):
        raise AssertionError(f"resilience: supervision: {out}")
    if sum_code != 0 or out["summarize_restarts"] is None \
            or not out["summarize_restarts"].startswith(RESTARTS_LINE):
        raise AssertionError(f"resilience: summarize: {sum_code} {sum_text}")
    if not all(equal.values()):
        raise AssertionError(f"resilience: the resumed run is not the "
                             f"unbroken one: {equal}")
    if not (out["corrupt_fired"] and out["last_verified_checkpoint"] == "last.prev"
            and meta["epoch"] == 1 and "restoring previous good"
            in out["fallback_line"] and refused):
        raise AssertionError(f"resilience: corruption not caught: {out}")
    # The resumed attempt trains epochs 1-2 through the pair's kernels.
    path = ("lstm_pair_fwd_masked", "lstm_pair_bwd", "lstm_wgrad")
    if not all(launches.get(k) for k in path):
        raise AssertionError(f"resilience: kernels off the path: {launches}")
    out["profile"] = profile
    out["fleet"] = fleet_out
    return out


#: The pair path's kernels, as a profiler trace names them.
PAIR_KERNEL_NAMES = ("lstm_pair_fwd_kernel", "lstm_pair_bwd_kernel",
                     "lstm_wgrad_kernel")


def _start_telemetry_profile() -> "_Child":
    """A short ``train`` child with the profiler window on epoch 1 and the
    hang watchdog armed, on the resilience data, started beside the
    resilience phase's children."""
    save_dir = Path(tempfile.mkdtemp(
        prefix="profile_",
        dir=Path(__file__).resolve().parent / "data" / "chip_smoke"))
    child = _Child("train", f"datamodule.data_dir={_resilience_data()}",
                   f"datamodule.n_samples={RESILIENCE_SAMPLES}",
                   f"logger.save_dir={save_dir}", "trainer.max_epochs=2",
                   "trainer.profile_steps=[1,1]", "trainer.hang_timeout_s=120",
                   side_by_side=3)
    child.save_dir = save_dir
    return child


def phase_telemetry_profile(child: "_Child") -> dict:
    """The profiled child: its ``profile_window`` event points at a trace
    that names the pair path's three kernels, its ``heartbeat.json`` is the
    closed recorder's after a ``finished`` beat, and ``summarize`` exits
    0."""
    try:
        lines, launches, seconds = _cli_result(child.wait())
        tel_dir = child.save_dir.joinpath(*RESILIENCE_RUN,
                                          "mse_small_lr0.0001_fast",
                                          "telemetry")
        events = read_events(tel_dir / "events.jsonl")
        window = next(e for e in events if e["kind"] == "profile_window")
        traces = sorted(Path(window["trace_dir"]).glob("*.json"))
        names = set()
        for trace in traces:
            names.update(str(ev.get("name", ""))
                         for ev in json.loads(trace.read_text())["traceEvents"]
                         if ev.get("cat") == "kernel")
        named = {k: sorted(n for n in names if k in n)[:2]
                 for k in PAIR_KERNEL_NAMES}
        heartbeat = json.loads((tel_dir / "heartbeat.json").read_text())
        sum_code, _, report = _summarize_cli(tel_dir)
    finally:
        shutil.rmtree(child.save_dir, ignore_errors=True)
    out = {
        "phase": "telemetry_profile", "seconds": seconds,
        "trace_files": [p.name for p in traces],
        "trace_dir_is_run_dir": window["trace_dir"] == str(tel_dir / "profile"),
        "kernels_named": named,
        "kernel_events": len(names),
        "heartbeat": {k: heartbeat.get(k) for k in ("phase", "closed",
                                                     "hang_timeout_s", "beats")},
        "run_finished": any(e["kind"] == "run_finished" for e in events),
        "summarize_exit": sum_code,
        "compiles": report.get("compiles"),
        "launches": {k: v for k, v in launches.items() if v},
    }
    emit(out)
    if not (traces and out["trace_dir_is_run_dir"]
            and all(named.values())):
        raise AssertionError(f"telemetry_profile: the trace misses the pair "
                             f"kernels: {out}")
    if not (heartbeat.get("closed") and heartbeat.get("hang_timeout_s") == 120
            and out["run_finished"] and sum_code == 0):
        raise AssertionError(f"telemetry_profile: {out}")
    return out


# ------------------------------------------------------- the rest of serving

# The steady load under the swaps: open loop at 400 requests a second (the
# knee phase runs later, so not half the knee), a generous deadline.
SWAP_RATE = 400.0
SWAP_DEADLINE_S = 0.25
# The knee: bench.py's ramp (--serve-sustained) on one engine: stages of
# 1.5 s from 25% of max_bucket / batch_s, x1.4 a stage, at most 7; a stage
# is sustainable at <= 10% shed and p99 <= the deadline, max(50 ms, 20 x
# batch_s); plus one light stage at 400 requests a second first. Two
# departures, both because this server is bound by the host's Python and
# not by the card, so max_bucket / batch_s overstates what it can carry:
# "shed" counts every request not served (shed at admission, rejected late
# at dispatch, errors), where bench.py counts only the first (the first
# stage of the ramp, at 3,908 offered a second, answered half its requests
# and shed 2.3% at admission; NVIDIA H100 80GB HBM3, 700.00 W); and when
# the ramp's first stage is not sustainable, it steps down by 1.4 a stage
# to the first one that is.
KNEE_STAGE_S = 1.5
KNEE_RAMP = 1.4
KNEE_MAX_STAGES = 7
KNEE_SHED_PCT_MAX = 10.0
KNEE_LIGHT_RATE = 400.0
COMPLETED_METRIC = re.compile(r"^mtt_serve_completed\{[^}]*\} (\S+)$", re.M)


class _Recording:
    """An engine as served, keeping each batch the dispatch thread sent it
    and the answers it gave (the other callers', the canary's and the
    golden reads', are not kept): what the swap phases hold bit for bit
    against an engine on each checkpoint."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.dispatched: list[tuple] = []

    def predict(self, x, params=None):
        out = super().predict(x, params)
        if threading.current_thread().name == "serve-dispatch":
            self.dispatched.append((np.array(x, np.float32), *out))
        return out


class _RecordingEngine(_Recording, PredictEngine):
    pass


def _paced(server, windows: np.ndarray, rate: float, deadline_s: float,
           done) -> tuple[list, float, float]:
    """Submit ``windows`` in turn at ``rate`` a second, open loop, until
    ``done(seconds so far)``: the i-th request is due at i / rate from the
    start and goes as soon as it is due (a late pacer catches up). Returns
    the pending requests, the rate achieved and the seconds."""
    pendings = []
    t0 = time.perf_counter()
    while True:
        now = time.perf_counter()
        if done(now - t0):
            break
        due = t0 + len(pendings) / rate
        if due > now:
            time.sleep(due - now)
        pendings.append(server.submit(windows[len(pendings) % len(windows)],
                                      deadline_s=deadline_s))
    seconds = time.perf_counter() - t0
    return pendings, len(pendings) / seconds, seconds


def _latency_ms(responses: list) -> dict:
    lat = np.array([1e3 * r.latency_s for r in responses if r.ok])
    return {"p50_ms": float(np.percentile(lat, 50)) if lat.size else None,
            "p99_ms": float(np.percentile(lat, 99)) if lat.size else None,
            "max_ms": float(lat.max()) if lat.size else None,
            "ok": int(lat.size)}


def _seeded_save(ckpt_dir: Path, spec, seed: int, lookback: int = T,
                 nan: bool = False) -> Path:
    """A published ``best`` of seeded weights (the alpha head's bias NaN
    with ``nan``)."""
    state = spec.build_module(
        device="cpu", generator=torch.Generator().manual_seed(seed)
    ).state_dict()
    if nan:
        state["alpha_head.bias"] = torch.full_like(state["alpha_head.bias"],
                                                   float("nan"))
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    save_checkpoint(ckpt_dir, "best", state, spec=spec,
                    meta={"epoch": 0, "datamodule": {"lookback_window": lookback}})
    return ckpt_dir


@contextlib.contextmanager
def _fault_plan(plan: dict | None):
    """``MTT_FAULT_PLAN`` set to ``plan`` (JSON) inside, as a run would be
    given it; nothing set for ``None``."""
    if plan is None:
        yield
        return
    os.environ[faults.FAULT_PLAN_ENV] = json.dumps(plan)
    try:
        yield
    finally:
        del os.environ[faults.FAULT_PLAN_ENV]


def _swap_under_load(phase: str, live: _RecordingEngine, refs: dict,
                     windows: np.ndarray, swaps: list) -> dict:
    """Steady open-loop load (SWAP_RATE, SWAP_DEADLINE_S) through a
    PredictServer on ``live`` while each ``(name, ckpt_dir, plan, reason)``
    of ``swaps`` is tried in turn, 0.2 s apart; then the gates: each swap's
    reason; every request resolved and none late; no capture; every
    dispatch's answers bit-equal to the ``old`` or the ``new`` reference
    engine's on the same batch, and no old answer after the first new one;
    the golden answers unchanged by a refusal and, after a commit, the new
    engine's. ``launches`` counts the live engine's: the served batches,
    the canaries and the golden reads (the reference engines run outside
    the count). The few requests submitted inside the swaps' windows
    (``during_swaps``) get their count, p50 and maximum, no p99."""
    server = PredictServer(live, max_wait_s=0.002)
    swapper = CheckpointSwapper(live)
    golden = swapper.golden_x
    new_golden = refs["new"].predict(golden)
    server.start()
    captures = live.compile_events
    lk.reset_launch_counts()
    live.dispatched.clear()
    loaded: list = []
    stop = threading.Event()
    feeder = threading.Thread(target=lambda: loaded.append(_paced(
        server, windows, SWAP_RATE, SWAP_DEADLINE_S, lambda _: stop.is_set())))
    feeder.start()
    results = []
    try:
        for name, ckpt_dir, plan, reason in swaps:
            time.sleep(0.2)
            before = live.predict(golden)
            with _fault_plan(plan):
                t_a = time.monotonic()
                verdict = swapper.try_swap(ckpt_dir, "best")
                t_b = time.monotonic()
            after = live.predict(golden)
            want = new_golden if verdict.ok else before
            results.append({
                "swap": name, "reason": verdict.reason, "expected": reason,
                "detail": verdict.detail,
                "checks": {k: v for k, v in verdict.checks.items()
                           if k.startswith("quality_")},
                "step_s": dict(swapper.step_seconds),
                "window_s": [t_a, t_b],
                "golden_bit_equal": all(np.array_equal(g, w)
                                        for g, w in zip(after, want)),
            })
        time.sleep(0.2)
    finally:
        stop.set()
        feeder.join(timeout=30.0)
    pendings, achieved, load_s = loaded[0]
    responses = [p.result(timeout=60.0) for p in pendings]
    stats = server.stop()
    launches = dict(lk.LAUNCHES)
    # Each dispatch against both references on the same batch (the same
    # bucket's graph): bit-equal to one of them.
    labels, rows = [], {"old": set(), "new": set()}
    for x, a, b in live.dispatched:
        label = next((k for k in ("old", "new")
                      if all(np.array_equal(g, w) for g, w in
                             zip((a, b), refs[k].predict(x)))), "neither")
        labels.append(label)
        if label != "neither":
            rows[label].update((ai.tobytes(), bi.tobytes())
                               for ai, bi in zip(a, b))
    answers = []
    for p, r in sorted(zip(pendings, responses),
                       key=lambda pr: pr[1].delivered_ts):
        if r.ok:
            key = (r.outputs[0].tobytes(), r.outputs[1].tobytes())
            answers.append("old" if key in rows["old"] else
                           "new" if key in rows["new"] else "neither")
    first_new = answers.index("new") if "new" in answers else len(answers)
    in_swap = [any(t_a <= p.request.submitted_ts <= t_b
                   for t_a, t_b in (s["window_s"] for s in results))
               for p in pendings]
    during = [r for r, inside in zip(responses, in_swap) if inside]
    outside = [r for r, inside in zip(responses, in_swap) if not inside]
    out = {
        "phase": phase,
        "swaps": [{k: v for k, v in s.items() if k != "window_s"}
                  for s in results],
        "requests": len(responses),
        "offered_per_s": SWAP_RATE, "achieved_per_s": achieved,
        "load_s": load_s,
        "statuses": {st: sum(r.status == st for r in responses)
                     for st in sorted({r.status for r in responses})},
        "late_deliveries": stats["late_deliveries"],
        "handback_max_ms": stats["handback_max_ms"],
        "late_ok_seen": sum(r.ok and r.delivered_ts > p.request.deadline_ts
                            for p, r in zip(pendings, responses)),
        "new_captures": live.compile_events - captures,
        "dispatches": {k: labels.count(k) for k in ("old", "new", "neither")},
        "answers": {k: answers.count(k) for k in ("old", "new", "neither")},
        "old_after_new": answers[first_new:].count("old"),
        "during_swaps": {"requests": len(during), **{
            k: v for k, v in _latency_ms(during).items() if k != "p99_ms"}},
        "outside_swaps": {"requests": len(outside), **_latency_ms(outside)},
        "launches": launches,
    }
    emit(out)
    bad = [s for s in results if s["reason"] != s["expected"]
           or not s["golden_bit_equal"]]
    if bad:
        raise AssertionError(f"{phase}: swaps off their verdicts: {bad}")
    if out["late_deliveries"] or out["late_ok_seen"]:
        raise AssertionError(f"{phase}: late answers: {out}")
    if out["new_captures"]:
        raise AssertionError(f"{phase}: a swap captured a graph: {out}")
    if out["dispatches"]["neither"] or out["answers"]["neither"]:
        raise AssertionError(f"{phase}: answers of neither checkpoint: {out}")
    if out["old_after_new"] or labels != sorted(labels, key=["old", "new"].index):
        raise AssertionError(f"{phase}: an old answer after a new one: {out}")
    if not out["answers"]["old"] or not out["answers"]["new"]:
        raise AssertionError(f"{phase}: the load did not span the commit: {out}")
    return out


def _diverged_save(ckpt_dir: Path, source: Path) -> Path:
    """``source``'s ``best`` with both heads' weights and biases scaled by
    50, published with ``source``'s own fingerprint: finite and bounded,
    but far from the outputs the fingerprint ships."""
    state, _, spec, meta = restore_checkpoint(source, "best")
    for name in ("alpha_head.weight", "alpha_head.bias", "beta_head.weight",
                 "beta_head.bias"):
        state[name] = state[name] * 50.0
    fingerprint = (source / "best" / quality_lib.FINGERPRINT_FILENAME).read_text()
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    save_checkpoint(ckpt_dir, "best", state, spec=spec, meta=meta,
                    extra_files={quality_lib.FINGERPRINT_FILENAME: fingerprint})
    return ckpt_dir


def phase_serve_swap(windows: np.ndarray, windows_medium: np.ndarray) -> dict:
    """The canaried hot-swap on the card, graphs on, under steady load:
    model=small (100 stocks) serving seeded weights takes the driver
    phase's trained ``best`` through the quality gate against its own
    fingerprint, then refuses the same checkpoint corrupted by
    ``serve.pre_swap`` (verify_failed), a NaN save (canary_nonfinite), a
    model=medium save (shape_mismatch) and the ``driver`` phase's ``best``
    with its heads scaled by 50 under its old fingerprint (quality_self);
    model=medium (25 stocks) then commits one seeded save for another
    under load."""
    root = swap_root()
    spec, spec_m = _small_spec(), _medium_spec()
    old = _seeded_save(root / "small_seeded", spec, seed=11)
    new = root / "driver"
    corrupt = root / "driver_corrupt"
    shutil.rmtree(corrupt, ignore_errors=True)
    shutil.copytree(new, corrupt)
    diverged = _diverged_save(root / "driver_diverged", new)
    nan = _seeded_save(root / "small_nan", spec, seed=12, nan=True)
    medium_old = _seeded_save(root / "medium_seeded", spec_m, seed=21)
    medium_new = _seeded_save(root / "medium_other", spec_m, seed=22)

    def engines(ckpt_old, ckpt_new, stocks):
        kw = dict(n_stocks=stocks, device=DEVICE)
        live = _RecordingEngine.from_checkpoint(ckpt_old, **kw)
        return live, {"old": PredictEngine.from_checkpoint(ckpt_old, **kw),
                      "new": PredictEngine.from_checkpoint(ckpt_new, **kw)}

    live, refs = engines(old, new, K_STOCKS)
    plan = {"seed": 3, "faults": [{"point": "serve.pre_swap",
                                   "kind": "corrupt", "attempt": None}]}
    small = _swap_under_load("serve_swap", live, refs, windows, [
        ("driver_best", new, None, "committed"),
        ("driver_best_corrupted", corrupt, plan, "verify_failed"),
        ("nan", nan, None, "canary_nonfinite"),
        ("medium", medium_old, None, "shape_mismatch"),
        ("driver_best_diverged", diverged, None, "quality_self"),
    ])
    committed = small["swaps"][0]
    if "quality_self_ks" not in committed["checks"]:
        raise AssertionError(f"serve_swap: the gate did not score the "
                             f"fingerprinted candidate: {committed}")
    live, refs = engines(medium_old, medium_new, K_MEDIUM)
    medium = _swap_under_load("serve_swap_medium", live, refs, windows_medium,
                              [("medium_other", medium_new, None, "committed")])
    return {"small": small, "medium": medium}


def phase_serve_faults(windows: np.ndarray, n: int = 32) -> dict:
    """A fault plan (``MTT_FAULT_PLAN``) on the model=small server on the
    card, ``n`` requests one at a time (one dispatch each, so the dispatch
    numbers are the plan's): ``serve.admit`` wedge on rids 3, 7 and 11
    (shed, category ``fault``); ``serve.dispatch`` wedge on dispatches 5,
    6 and 7 (three ``error`` answers, one breaker trip at the default
    threshold 3); ``serve.dispatch`` nan on dispatches 12 and 13 (two
    answers withheld). The counts must equal the plan's."""
    spec = _small_spec()
    state = spec.build_module(
        device="cpu", generator=torch.Generator().manual_seed(0)).state_dict()
    engine = PredictEngine(spec, state, n_stocks=K_STOCKS, lookback=T,
                           n_features=3, device=DEVICE)
    plan = {"seed": 0, "faults": (
        [{"point": "serve.admit", "kind": "wedge", "attempt": None,
          "match": {"rid": rid}} for rid in (3, 7, 11)]
        + [{"point": "serve.dispatch", "kind": "wedge", "attempt": None,
            "match": {"seq": seq}} for seq in (5, 6, 7)]
        + [{"point": "serve.dispatch", "kind": "nan", "attempt": None,
            "match": {"seq": seq}} for seq in (12, 13)])}
    want = {"fault_sheds": 3, "injected_errors": 3, "withheld": 2,
            "breaker_trips": 1, "ok": n - 8, "unresolved": 0,
            "late_deliveries": 0}
    server = PredictServer(engine, max_wait_s=0.002)
    server.start()
    lk.reset_launch_counts()
    responses, unresolved = [], 0
    with _fault_plan(plan):
        try:
            for i in range(n):
                try:
                    responses.append(server.submit(
                        windows[i % len(windows)], deadline_s=5.0
                    ).result(timeout=30.0))
                except TimeoutError:
                    unresolved += 1
        finally:
            stats = server.stop()
    launches = dict(lk.LAUNCHES)
    got = {
        "fault_sheds": stats["shed_by_reason"].get("fault", 0),
        "injected_errors": sum("InjectedDeviceError" in r.detail
                               for r in responses if r.status == "error"),
        "withheld": sum("non-finite" in r.detail
                        for r in responses if r.status == "error"),
        "breaker_trips": stats["breaker_trips"],
        "ok": sum(r.ok for r in responses),
        "unresolved": unresolved,
        "late_deliveries": stats["late_deliveries"],
    }
    out = {"phase": "serve_faults", "plan": plan, "requests": n, "got": got,
           "want": want, "shed_by_reason": stats["shed_by_reason"],
           "dispatches": stats["dispatches"], "launches": launches}
    emit(out)
    if got != want:
        raise AssertionError(f"serve_faults: counts off the plan: {got} != "
                             f"{want}")
    return out


def _start_preflight() -> subprocess.Popen:
    """``python -m masters_thesis_tpu_torch.serve preflight`` as a child on
    the card, started now, waited for by ``phase_serve_preflight``."""
    return subprocess.Popen(
        [sys.executable, "-m", "masters_thesis_tpu_torch.serve", "preflight"],
        cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def phase_serve_preflight(child: subprocess.Popen) -> dict:
    """The serve preflight's child (``_start_preflight``): exit 0, one
    capture a bucket, every capture's peak within the card's memory (SV304
    held against ``mem_get_info``), the swap under load committed."""
    try:
        stdout, stderr = child.communicate(timeout=300)
    finally:
        if child.poll() is None:
            child.kill()
            child.communicate()
    facts = next((json.loads(line)["preflight"] for line in stdout.splitlines()
                  if line.startswith('{"preflight"')), {})
    out = {"phase": "serve_preflight", "exit": child.returncode,
           "facts": facts, "report": stdout.splitlines()[-2:]}
    emit(out)
    if child.returncode != 0:
        raise AssertionError(f"serve_preflight: exit {child.returncode}: "
                             f"{stdout[-2000:]} {stderr[-2000:]}")
    peaks = facts.get("capture_peak_bytes") or {}
    if (facts.get("captures") != len(peaks) or not peaks
            or not all(0 < v <= facts["device_total_bytes"]
                       for v in peaks.values())):
        raise AssertionError(f"serve_preflight: SV304 not held on the card: "
                             f"{facts}")
    if facts.get("swap", {}).get("reason") != "committed":
        raise AssertionError(f"serve_preflight: the swap rule did not run: "
                             f"{facts}")
    # SV307: one capture a bucket and one replica-axis launch a graph at
    # every lane count; SV308 for a lane.
    stacked = facts.get("stacked", {})
    lane = facts.get("lane_swap", {})
    if (sorted(stacked) != ["R1", "R2", "R4"]
            or any(r["captures"] != facts["captures"]
                   or len(r["launches"]) != facts["captures"]
                   or any(counts != {"lstm_pair_fwd_stacked": 1}
                          for counts in r["launches"].values())
                   for r in stacked.values())):
        raise AssertionError(f"serve_preflight: SV307 not held: {stacked}")
    depths = facts.get("stacked_depths", {})
    want = {"L1": "lstm_fwd_stacked", "L4": "lstm_stack_fwd_stacked"}
    if (sorted(depths) != sorted(want)
            or any(depths[k]["captures"] != facts["captures"]
                   or len(depths[k]["launches"]) != facts["captures"]
                   or any(counts != {counter: 1}
                          for counts in depths[k]["launches"].values())
                   for k, counter in want.items())):
        raise AssertionError(f"serve_preflight: SV307 not held for the other "
                             f"groupings: {depths}")
    if (lane.get("reason") != "committed" or lane.get("new_captures")
            or lane.get("late_deliveries") or not lane.get("siblings_bitwise")):
        raise AssertionError(f"serve_preflight: SV308 for a lane: {lane}")
    # SV306: two replicas on the card, r0 crashed under traffic.
    fleet = facts.get("fleet", {})
    if (fleet.get("deaths", 0) < 1 or fleet.get("unresolved")
            or fleet.get("late_deliveries") or not fleet.get("survivors")
            or not fleet.get("launches", {}).get("lstm_fwd")):
        raise AssertionError(f"serve_preflight: SV306 not held: {fleet}")
    # SV305: a warm boot from the program cache on the card.
    cached = facts.get("program_cache", {})
    if ((cached.get("cold_captures"), cached.get("warm_captures"),
         cached.get("warm_programs_made"), cached.get("warm_hits"))
            != (facts["captures"], 0, 0, facts["captures"])):
        raise AssertionError(f"serve_preflight: SV305 not held: {cached}")
    return out


def _start_analysis() -> dict:
    """The port's lint gate as two children, started now and waited for by
    ``phase_preflight``: the static passes (concurrency, event contract,
    SPMD) on the host, and the default run (the graph-path lint, then the
    trainer audit on the card, its default device)."""
    root = Path(__file__).resolve().parent
    cmd = [sys.executable, "-m", "masters_thesis_tpu_torch.analysis"]
    return {name: subprocess.Popen(cmd + args, cwd=root, text=True,
                                   stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT)
            for name, args in (("static", ["--concurrency", "--contracts",
                                           "--spmd"]),
                               ("default", []))}


def phase_preflight() -> dict:
    """The trainer preflight on the card: ``assert_trace_clean`` at
    model=small (one capture, every later step a replay under the raising
    sync check, one gradient all-reduce a step) and at R = 2 stacked (one
    capture, one ``[R, n]`` all-reduce a step); a planted host read in the
    step fails it with TA202 and a planted capture failure with TA205; and
    the lint gate's children exit 0."""
    from masters_thesis_tpu_torch.analysis import traceaudit
    from masters_thesis_tpu_torch.train import steps

    t0 = time.perf_counter()
    children = _start_analysis()
    try:
        before = dict(lk.LAUNCHES)
        facts: dict = {}
        traceaudit.assert_trace_clean(spec=_train_spec(), device=DEVICE,
                                      stacked_replicas=2, facts=facts)
        launches = {k: n - before[k] for k, n in lk.LAUNCHES.items()
                    if n != before[k]}
        real = steps.train_step

        def reading(*args, **kwargs):
            sums = real(*args, **kwargs)
            sums["total"][0].item()  # the planted host read
            return sums

        def refusing(*args, **kwargs):
            # A capture that fails for a cause that is no host read.
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError("planted capture failure")
            return real(*args, **kwargs)

        planted = {}
        for name, plant in (("host_read", reading),
                            ("capture_failure", refusing)):
            steps.train_step = plant
            try:
                planted[name] = traceaudit.run_trace_audit(
                    spec=_train_spec(), device=DEVICE)
            finally:
                steps.train_step = real
        lint = {}
        for name, child in children.items():
            out, _ = child.communicate(timeout=300)
            lint[name] = {"exit": child.returncode,
                          "last": out.strip().splitlines()[-1:]}
    finally:
        for child in children.values():
            if child.poll() is None:
                child.kill()
                child.communicate()
    stacked = facts["stacked"]
    out = {"phase": "preflight", "card": _card(),
           "seconds": time.perf_counter() - t0,
           "TA201": {"captures": facts.get("captures"),
                     "replays": facts.get("replays"),
                     "steps": facts["steps"]},
           "TA206": {"all_reduces_per_step": facts["all_reduces_per_step"]},
           "TA207": {"captures": stacked.get("captures"),
                     "replays": stacked.get("replays"),
                     "all_reduces_per_step": stacked["all_reduces_per_step"]},
           "launches": launches,
           "planted": {name: sorted({f.rule for f in found})
                       for name, found in planted.items()},
           "lint": lint}
    emit(out)
    if (facts.get("captures") != 1 or facts.get("replays") != facts["steps"]
            or stacked.get("captures") != 1):
        raise AssertionError(f"preflight: the steps were not captured once: "
                             f"{facts}")
    if out["planted"] != {"host_read": ["TA202"],
                          "capture_failure": ["TA205"]}:
        raise AssertionError(
            "preflight: a planted host read was not TA202 alone, or a "
            "planted capture failure not TA205 alone: "
            + str({name: [f.format() for f in found]
                   for name, found in planted.items()}))
    if any(v["exit"] != 0 for v in lint.values()):
        raise AssertionError(f"preflight: the lint gate failed: {lint}")
    return out


def _scrape_completed(url: str) -> float:
    body = urllib.request.urlopen(url + "/metrics", timeout=10).read().decode()
    match = COMPLETED_METRIC.search(body)
    return float(match.group(1)) if match else 0.0


def _knee_stage(server, windows: np.ndarray, rate: float,
                deadline_s: float) -> dict:
    pendings, achieved, seconds = _paced(server, windows, rate, deadline_s,
                                         lambda s: s >= KNEE_STAGE_S)
    t0 = time.perf_counter() - seconds
    responses = [p.result(timeout=60.0) for p in pendings]
    wall = time.perf_counter() - t0
    lat = _latency_ms(responses)
    scraped = _scrape_completed(server.metrics_url)
    completed = server.stats()["completed"]
    n = max(1, len(responses))
    shed = sum(r.status == "shed" for r in responses)
    stage = {
        "offered_per_s": rate, "achieved_per_s": achieved,
        "requests": len(responses), "completed": lat["ok"],
        "p50_ms": lat["p50_ms"], "p99_ms": lat["p99_ms"],
        "shed_pct": 100.0 * (len(responses) - lat["ok"]) / n,
        "admission_shed_pct": 100.0 * shed / n,
        "errors": sum(r.status == "error" for r in responses),
        "rejected_late": sum(r.status == "rejected_late" for r in responses),
        "delivered_per_s": lat["ok"] / wall,
        "metrics_completed": scraped, "stats_completed": completed,
        # The admission forecast's batch seconds at the stage's end.
        "forecast_batch_ms": 1e3 * server.service_model.batch_s,
    }
    stage["sustainable"] = (
        stage["completed"] > 0 and stage["shed_pct"] <= KNEE_SHED_PCT_MAX
        and stage["p99_ms"] <= deadline_s * 1e3)
    return stage


def phase_serve_knee(windows: np.ndarray) -> dict:
    """The serving knee of one model=small engine (graphs on) with
    telemetry on and a /metrics endpoint: the light stage, then the ramp
    (KNEE_*: up from its first stage while stages are sustainable, the
    knee the last that is; or down while they are not, the knee the first
    that is); the load comes from this process (``_paced``); each stage scrapes /metrics once, whose completed count must
    equal ``stats()``'s; then every request span must validate and tile its
    wall, and the attribution of the p50 and p99 request is printed. Last,
    p50 and p99 of the same closed-loop bursts with telemetry off and on
    (off, on, on, off), the cost of the spans."""
    spec = _small_spec()
    state = spec.build_module(
        device="cpu", generator=torch.Generator().manual_seed(0)).state_dict()
    engine = PredictEngine(spec, state, n_stocks=K_STOCKS, lookback=T,
                           n_features=3, device=DEVICE)
    tel_dir = Path(tempfile.mkdtemp(prefix="serve_knee_"))
    try:
        tel = TelemetryRun(tel_dir / "knee", run_id="serve-knee")
        server = PredictServer(engine, telemetry=tel, max_wait_s=0.002,
                               metrics_port=0)
        server.start()
        batch_s = server.service_model.batch_s
        deadline_s = max(0.05, 20.0 * batch_s)
        capacity = engine.max_bucket / batch_s
        lk.reset_launch_counts()
        # The cyclic collector's passes during the ramp (generation and
        # seconds): a pause stalls the dispatch thread with the rest.
        collections, started = [], {}

        def on_gc(stage, info):
            if stage == "start":
                started["t"] = time.perf_counter()
            else:
                collections.append((info["generation"],
                                    time.perf_counter() - started["t"]))

        gc.callbacks.append(on_gc)
        try:
            light = _knee_stage(server, windows, KNEE_LIGHT_RATE, deadline_s)
            stages, knee = [], None
            rate = 0.25 * capacity
            for _ in range(KNEE_MAX_STAGES):
                stage = _knee_stage(server, windows, rate, deadline_s)
                stages.append(stage)
                up = stages[0]["sustainable"]
                if stage["sustainable"]:
                    knee = stage
                if stage["sustainable"] != up:
                    break
                rate = rate * KNEE_RAMP if up else rate / KNEE_RAMP
        finally:
            gc.callbacks.remove(on_gc)
            stats = server.stop()
            memory = tel.sample_memory("serve_knee", engine.device)
            tel.close()
        launches = dict(lk.LAUNCHES)
        spans = collect_spans(tel_dir / "knee")["spans"]
        problems = validate_spans(spans)
        requests = [s for s in spans if s["name"] == "serve.request"]
        untiled = [s["span_id"] for s in requests if s["status"] == "ok"
                   and abs(sum(s["attrs"][k] for k in SERVE_COMPONENTS)
                           - s["dur_s"]) > 1e-9]
        attribution = serve_attribution(spans)
        device_ms = np.array([1e3 * s["dur_s"] for s in spans
                              if s["name"] == "serve.device"])
        bursts = {}
        for label in ("off", "on", "on", "off"):
            run = (TelemetryRun(tel_dir / f"burst_{len(bursts)}")
                   if label == "on" else None)
            _, _, burst, _ = _burst(engine, windows, telemetry=run)
            if run is not None:
                run.close()
            bursts.setdefault(label, []).append(
                {"p50_ms": burst["p50_ms"], "p99_ms": burst["p99_ms"]})
    finally:
        shutil.rmtree(tel_dir, ignore_errors=True)
    out = {
        "phase": "serve_knee", "batch_s": batch_s, "deadline_ms": deadline_s * 1e3,
        "capacity_per_s": capacity, "light": light, "stages": stages,
        "knee_offered_per_s": None if knee is None else knee["offered_per_s"],
        "knee_achieved_per_s": None if knee is None else knee["achieved_per_s"],
        "knee": knee,
        "spans": {"requests": len(requests), "total": len(spans),
                  "problems": problems[:5], "untiled": len(untiled)},
        "attribution": None if attribution is None else {
            "queue_wait_share": attribution["queue_wait_share"],
            "compute_share": attribution["compute_share"],
            "p50": attribution["p50"], "p99": attribution["p99"],
            "shed_by_reason": attribution["shed_by_reason"]},
        "stats": {k: stats[k] for k in ("requests", "completed", "shed",
                                        "late_converted", "late_deliveries",
                                        "handback_max_ms", "dispatches",
                                        "queue_wait_share", "compute_share")},
        "handback_guard_ms": 1e3 * server.handback_guard_s,
        "telemetry_off_on": bursts,
        # serve.device spans: the predict's wall a dispatch (what the
        # admission forecast is fed).
        "device_span_ms": {"p50": float(np.percentile(device_ms, 50)),
                           "p99": float(np.percentile(device_ms, 99)),
                           "max": float(device_ms.max()),
                           "n": int(device_ms.size)},
        "collections": {f"gen{g}": {"n": sum(c[0] == g for c in collections),
                                    "max_s": max((c[1] for c in collections
                                                  if c[0] == g), default=0.0)}
                        for g in range(3)},
        "memory": memory,
        "launches": launches,
    }
    emit(out)
    if knee is None:
        raise AssertionError(f"serve_knee: no sustainable stage: {stages}")
    scraped = [(s["metrics_completed"], s["stats_completed"])
               for s in [light] + stages]
    if any(m != c for m, c in scraped):
        raise AssertionError(f"serve_knee: /metrics off stats(): {scraped}")
    if problems or untiled or len(requests) != stats["requests"]:
        raise AssertionError(f"serve_knee: request spans broken: "
                             f"{out['spans']}, {stats['requests']} requests")
    if stats["late_deliveries"]:
        raise AssertionError(f"serve_knee: late answers: {stats}")
    return out


# The serving monitor at its default rate (1 in 16 delivered answers), and
# the knee search with it on: down from serve_knee's knee by this factor a
# stage, at most KNEE_MAX_STAGES stages.
QUALITY_SAMPLE_EVERY = 16
QUALITY_KNEE_RAMP = 3.0
QUALITY_MONITOR_WINDOWS = 8


def phase_serve_quality(windows: np.ndarray, knee: dict) -> dict:
    """The serve side of the quality plane, on the ``driver`` phase's
    ``best`` (its fingerprint the monitor's reference):
    PredictEngine.warmup() per bucket (a fresh graphed engine's first call
    of each bucket: its eager run and its capture, synchronized); the
    monitor's host seconds a sampled window
    (sample_every=1 over QUALITY_MONITOR_WINDOWS windows); closed-loop
    bursts with the monitor off, on, on, off (1 in QUALITY_SAMPLE_EVERY),
    their p50, p99 and answers/s; then the knee with the monitor on, from
    serve_knee's knee down by QUALITY_KNEE_RAMP a stage until one is
    sustainable (serve_knee's deadline and rule)."""
    ckpt = swap_root() / "driver"
    fingerprint = quality_lib.read_fingerprint(ckpt / "best")
    engine = PredictEngine.from_checkpoint(ckpt, n_stocks=K_STOCKS,
                                           device=DEVICE)
    k, t, f = engine.window_shape
    capture_s = {}
    for b in engine.buckets:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.predict(np.zeros((b, k, t, f), np.float32))
        torch.cuda.synchronize()
        capture_s[b] = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine.warmup()  # every bucket captured: the two timed predicts
    rest_s = time.perf_counter() - t0
    probe = quality_lib.QualityMonitor(fingerprint, sample_every=1)
    answers = engine.predict(windows[:QUALITY_MONITOR_WINDOWS])
    t0 = time.perf_counter()
    for i in range(QUALITY_MONITOR_WINDOWS):
        probe.sample(windows[i], answers[0][i], answers[1][i])
    sample_ms = 1e3 * (time.perf_counter() - t0) / QUALITY_MONITOR_WINDOWS
    bursts: dict[str, list] = {}
    monitors = []
    for label in ("off", "on", "on", "off"):
        monitor = (quality_lib.QualityMonitor(
            fingerprint, sample_every=QUALITY_SAMPLE_EVERY)
            if label == "on" else None)
        responses, _, _, serve_s = _burst(engine, windows,
                                          quality_monitor=monitor)
        ok = [r for r in responses if r.ok]
        bursts.setdefault(label, []).append(
            {**_latency_ms(responses), "requests": len(responses),
             "answers_per_s": len(ok) / serve_s,
             "sampled": None if monitor is None else
             (monitor.last_scores() or {}).get("sampled", 0)})
        if monitor is not None:
            monitors.append(monitor)
    tel_dir = Path(tempfile.mkdtemp(prefix="serve_quality_"))
    stages = []
    try:
        tel = TelemetryRun(tel_dir / "knee", run_id="serve-quality")
        monitor = quality_lib.QualityMonitor(
            fingerprint, sample_every=QUALITY_SAMPLE_EVERY, telemetry=tel)
        server = PredictServer(engine, telemetry=tel, max_wait_s=0.002,
                               metrics_port=0, quality_monitor=monitor)
        server.start()
        deadline_s = knee["deadline_ms"] / 1e3
        rate = knee["knee_offered_per_s"]
        try:
            for _ in range(KNEE_MAX_STAGES):
                stage = _knee_stage(server, windows, rate, deadline_s)
                stage["sampled"] = (monitor.last_scores() or {}).get("sampled", 0)
                stages.append(stage)
                if stage["sustainable"]:
                    break
                rate /= QUALITY_KNEE_RAMP
        finally:
            stats = server.stop()
            tel.close()
        samples = [e for e in read_events(tel_dir / "knee" / "events.jsonl")
                   if e["kind"] == "quality_sample"]
    finally:
        shutil.rmtree(tel_dir, ignore_errors=True)
    sustained = [st for st in stages if st["sustainable"]]
    out = {
        "phase": "serve_quality",
        "fingerprint_windows": fingerprint["windows"],
        "warmup": {"capture_s_by_bucket": capture_s,
                   "warmup_after_captures_s": rest_s},
        "monitor_sample_ms": sample_ms,
        "sample_every": QUALITY_SAMPLE_EVERY,
        "bursts_monitor_off_on": bursts,
        "knee_without_monitor_offered_per_s": knee["knee_offered_per_s"],
        "knee_with_monitor_offered_per_s":
            sustained[0]["offered_per_s"] if sustained else None,
        "knee_with_monitor": sustained[0] if sustained else None,
        "stages_with_monitor": stages,
        "quality_samples": len(samples),
        "last_scores": monitors[-1].last_scores() if monitors else None,
        "late_deliveries": stats["late_deliveries"],
    }
    emit(out)
    if fingerprint is None or stats["late_deliveries"]:
        raise AssertionError(f"serve_quality: {out}")
    if not samples or any(b["sampled"] == 0 for b in bursts["on"]):
        raise AssertionError(f"serve_quality: the monitor sampled nothing: "
                             f"{out}")
    return out


# One burn-rate rule with short windows, so that a burst of sheds fires it
# and the plane resolves it within seconds: the engine ticks every 2 s, so
# the fast window is longer than that (a tick always sees the burst).
SLO_RULE = dict(threshold=2.0, target=0.99, fast_window_s=3.0,
                slow_window_s=6.0, for_ticks=1, clear_ticks=2)
SLO_BURST = 64
SLO_WAIT_S = 20.0


def _slo_state(url: str) -> tuple[dict, str, dict]:
    """/slo, /metrics and /healthz of a server's plane."""
    def get(path):
        return urllib.request.urlopen(url + path, timeout=10).read().decode()
    return json.loads(get("/slo")), get("/metrics"), json.loads(get("/healthz"))


def phase_serve_slo(windows: np.ndarray) -> dict:
    """The SLO plane of a serving process: a model=small PredictServer with
    telemetry, metrics_port=0 and one burn-rate rule (SLO_RULE); answered
    requests, then a burst of SLO_BURST requests whose 0.1 ms deadline no
    batch can meet (shed at admission). /slo, /metrics and /healthz are read
    every 0.1 s: the rule fires after the burst (``mtt_slo_firing`` 1 for it,
    /healthz naming it) and resolves once the sheds leave its windows; the
    stream holds alert_fired then alert_resolved, with their burn rates."""
    from masters_thesis_tpu_torch.telemetry.slo import SLORule

    spec = _small_spec()
    state = spec.build_module(
        device="cpu", generator=torch.Generator().manual_seed(0)).state_dict()
    engine = PredictEngine(spec, state, n_stocks=K_STOCKS, lookback=T,
                           n_features=3, device=DEVICE)
    tel_dir = Path(tempfile.mkdtemp(prefix="serve_slo_"))
    seen = []
    try:
        tel = TelemetryRun(tel_dir / "serve", run_id="serve-slo")
        server = PredictServer(engine, telemetry=tel, max_wait_s=0.002,
                               metrics_port=0,
                               slo_rules=[SLORule("burn", "burn_rate",
                                                  **SLO_RULE)])
        server.start()
        try:
            url = server.metrics_url
            ok = [server.submit(windows[i % len(windows)], deadline_s=5.0)
                  for i in range(16)]
            ok = [p.result(timeout=60.0) for p in ok]
            t_burst = time.monotonic()
            shed = [server.submit(windows[i % len(windows)], deadline_s=1e-4)
                    for i in range(SLO_BURST)]
            shed = [p.result(timeout=60.0) for p in shed]
            fired = resolved = None
            firing_metric = healthz = None
            while time.monotonic() - t_burst < SLO_WAIT_S:
                state_now, metrics, health = _slo_state(url)
                firing = "burn" in (state_now.get("firing") or [])
                seen.append(firing)
                if firing and fired is None:
                    fired = time.monotonic() - t_burst
                    firing_metric = next(
                        (ln for ln in metrics.splitlines()
                         if ln.startswith("mtt_slo_firing")
                         and 'rule="burn"' in ln), None)
                    healthz = health
                if fired is not None and not firing:
                    resolved = time.monotonic() - t_burst
                    break
                time.sleep(0.1)
            final = state_now
        finally:
            stats = server.stop()
            tel.close()
        alerts = [{k: e.get(k) for k in ("kind", "rule", "burn_fast",
                                         "burn_slow", "active_s")}
                  for e in read_events(tel_dir / "serve" / "events.jsonl")
                  if e["kind"] in ("alert_fired", "alert_resolved")]
    finally:
        shutil.rmtree(tel_dir, ignore_errors=True)
    out = {
        "phase": "serve_slo", "rule": SLO_RULE,
        "answered": sum(r.ok for r in ok),
        "not_served": sum(not r.ok for r in shed),
        "statuses": {st: sum(r.status == st for r in shed)
                     for st in sorted({r.status for r in shed})},
        "fired_after_s": fired, "resolved_after_s": resolved,
        "firing_metric": firing_metric,
        "healthz_while_firing": healthz,
        "polls": len(seen), "ticks": final.get("ticks"),
        "alerts": alerts, "late_deliveries": stats["late_deliveries"],
    }
    emit(out)
    if (fired is None or resolved is None or firing_metric is None
            or not firing_metric.endswith(" 1")
            or "burn" not in (healthz or {}).get("firing", [])
            or [a["kind"] for a in alerts] != ["alert_fired", "alert_resolved"]
            or out["not_served"] < SLO_BURST // 2
            or stats["late_deliveries"]):
        raise AssertionError(f"serve_slo: {out}")
    return out


# ---------------------------------------------------------------- universe

# configs/datamodule/universe.yaml (2,048 synthetic assets, K=3 factors,
# lookback 32, target 16, stride 48, batch 4, an 8-shard window store) with
# configs/model/kfactor.yaml (H=64, 2 layers, 2K+1 = 7 inputs, a 3-wide beta
# head) and configs/loss/combined.yaml: the widths as configured, the depth
# cut from 50,000 samples to 12,000 (249 windows, 43 steps an epoch).
U_STOCKS, U_FACTORS, U_SAMPLES = 2048, 3, 12_000
U_T, U_TARGET, U_STRIDE, U_BATCH, U_SHARDS = 32, 16, 48, 4, 8
U_FEATURES = 2 * U_FACTORS + 1
U_BUCKETS = (1, 2, 4, 8, 16, 32, 64)  # configs/serve/universe.yaml
U_PARITY_STEPS = 5
U_BURSTS = 6  # bursts of 64 one-window requests through PredictServer
U_KERNEL_ROWS = (2048, 8192, 131072)  # a window, a training step, bucket 64
# The kernels a step of model=kfactor launches at 2,048-row windows: each
# layer alone (the grouping rule fuses no pair there).
U_PATH = ("lstm_fwd", "lstm_bwd", "lstm_wgrad")
U_ABSENT = ("lstm_pair_fwd", "lstm_pair_fwd_masked", "lstm_pair_bwd",
            "lstm_stack_fwd", "lstm_stack_fwd_masked", "lstm_stack_bwd",
            "lstm_tb_fwd", "lstm_tb_bwd")


def universe_dir() -> Path:
    """The universe data's directory, keyed by the generation parameters."""
    return (Path(__file__).resolve().parent / "data" / "chip_smoke"
            / f"universe{U_STOCKS}x{U_SAMPLES}k{U_FACTORS}")


def _kfactor_spec(dropout: float = 0.2) -> ModelSpec:
    # configs/model/kfactor.yaml with configs/loss/combined.yaml.
    return ModelSpec(objective="combined", input_size=U_FEATURES,
                     hidden_size=H, num_layers=2, dropout=dropout,
                     n_factors=U_FACTORS, learning_rate=LR, weight_decay=WD,
                     mse_weight=100.0)


def _universe_inputs(rows: int, seed: int):
    """x (T, rows, 4H), the layer's weight and a cotangent of h, at T=32,
    drawn on the card (numpy takes ~30 s for 131,072 rows' 10⁹ normals)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    scale = 1.0 / np.sqrt(H)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    w = (torch.rand((H, 4 * H), generator=gen, device="cuda") * 2 - 1) * scale
    return normal(U_T, rows, 4 * H), w, 0.1 * normal(U_T, rows, H)


def phase_universe_kernels() -> dict:
    """Rows 1 and 2 of the kernel table at the universe path's shapes, T=32,
    H=64, f32: the resident single-layer forward at 2,048 rows (a window:
    validation, test, bucket 1), 8,192 (a training step of 4 windows) and
    131,072 (bucket 64), its sweep and the sweep's one weight-gradient job
    at 2,048 and 8,192. Each against its plain version (forwards 2e-5 abs,
    h and c; dx and dW 2e-5 of the largest entry) and timed beside cuDNN's
    single layer (TF32 off; its forward under inference mode)."""
    results = {}
    for rows in U_KERNEL_ROWS:
        x, w1, dh = _universe_inputs(rows, seed=rows)
        extra = {"phase": "universe_kernels"}
        row = _measure(
            "lstm_fwd", rows,
            _inference(lambda: lk.lstm_fwd_cuda(x, w1)),
            _inference(lambda: lk.lstm_recurrence_ref(x, w1)),
            _inference(_cudnn_forward(x, [(w1,)])), True,
            *cost("lstm_fwd", rows, U_T), False, n_t=U_T, extra=extra,
            check=lambda: (lk.lstm_fwd_cuda(x, w1, return_c=True)[1],
                           lk.lstm_recurrence_ref(x, w1, return_c=True)[1]),
            # cuDNN takes ~29 ms a call at 131,072 rows: fewer loops there.
            loop=dict(iters=5, loops=3) if rows > U_BATCH * U_STOCKS else None)
        results[("lstm_fwd", rows)] = row
        if rows > U_BATCH * U_STOCKS:
            del x, w1, dh
            torch.cuda.empty_cache()
            continue  # serving only: no backward at 131,072 rows
        with torch.no_grad():
            hs, cs = lk.lstm_recurrence_ref(x, w1, return_c=True)
            dx = lk.lstm_bwd_ref(dh, x, hs, cs, w1)
        rows_out = [
            _measure(
                "lstm_bwd", rows,
                lambda: lk.lstm_bwd_cuda(dh, x, hs, cs, w1),
                lambda: lk.lstm_bwd_ref(dh, x, hs, cs, w1),
                _cudnn_backward(x, [(w1,)], dh, weights=False), True,
                *cost("lstm_bwd", rows, U_T), True,
                full=_cudnn_backward(x, [(w1,)], dh, weights=True), n_t=U_T,
                extra=extra),
            _measure(
                "lstm_wgrad_single", rows,
                lambda: lk.lstm_single_wgrad(dx, hs),
                lambda: lk.lstm_wgrad_ref(dx, hs, 1),
                lambda: (hs[:-1].reshape(-1, H).T
                         @ dx[1:].reshape(-1, 4 * H)), True,
                *cost("lstm_wgrad_single", rows, U_T), True, n_t=U_T,
                extra=extra),
        ]
        for r in rows_out:
            results[(r["name"], rows)] = r
    return results


def _universe_datamodule() -> FinancialWindowDataModule:
    """The universe windows in the port's window store (8 shards), built
    from the K-factor DGP (dgp_seed 0) next to this script, then opened
    with every shard re-hashed (``verify=True``)."""
    from masters_thesis_tpu_torch.data.window_store import WindowStore

    t0 = time.perf_counter()
    root = universe_dir()
    bootstrap_synthetic(root, n_stocks=U_STOCKS, n_samples=U_SAMPLES, seed=0,
                        n_factors=U_FACTORS)
    generated = time.perf_counter()
    dm = FinancialWindowDataModule(
        root, lookback_window=U_T, target_window=U_TARGET, stride=U_STRIDE,
        batch_size=U_BATCH, engine="python", store_shards=U_SHARDS)
    dm.prepare_data()
    built = time.perf_counter()
    store = WindowStore.open(root / "datasets" / "window_store", verify=True)
    verified = time.perf_counter()
    dm.setup()
    emit({"phase": "universe_data",
          "seconds": {"generate": generated - t0, "store": built - generated,
                      "verify": verified - built},
          "stocks": U_STOCKS, "factors": dm.n_factors, "features": dm.n_features,
          "samples": U_SAMPLES, "shards": store.n_shards,
          "store_bytes": store.nbytes,
          "windows": {"train": len(dm.train_range), "val": len(dm.val_range),
                      "test": len(dm.test_range)},
          "fields": {f: list(store.field_shape(f)) for f in
                     ("x", "y", "factor", "inv_psi")}})
    if (store.n_shards, dm.n_factors, dm.n_features) != (U_SHARDS, U_FACTORS,
                                                         U_FEATURES):
        raise AssertionError("the universe store is not the configured one")
    return dm


def phase_universe_train(dm) -> dict:
    """``python -m masters_thesis_tpu_torch train datamodule=universe
    model=kfactor loss=combined`` (2 epochs, graphed) and ``test`` on its
    checkpoints, each a child process; a 5-step card-against-CPU
    trajectory at full width (dropout 0, 4 windows a step); one stream
    epoch over the memmapped store, prefetch 2 against 0 bit for bit, and
    an in-order pass through the prefetcher for the page-ins. Returns the
    run's checkpoint root (copied out for universe_serve)."""
    root = Path(__file__).resolve().parent / "data" / "chip_smoke"
    save_dir = Path(tempfile.mkdtemp(prefix="universe_", dir=root))
    common = ["datamodule=universe", "model=kfactor", "loss=combined",
              f"datamodule.data_dir={universe_dir()}",
              f"datamodule.n_stocks={U_STOCKS}",
              f"datamodule.n_samples={U_SAMPLES}",
              f"logger.save_dir={save_dir}"]
    steps = len(dm.train_range) // U_BATCH * TRAIN_EPOCHS
    try:
        run_lines, run_launches, run_s = _cli(
            "train", *common, f"trainer.max_epochs={TRAIN_EPOCHS}")
        ckpts = (save_dir / "FinancialLstm" / "universe"
                 / "combined_kfactor_lr0.0001_fast" / "checkpoints")
        # The test child beside the trajectory (neither is timed), each
        # with half the host's cores: busy-waiting thread pools on every
        # core slow both many times over.
        test_child = _Child("test", *common, f"checkpoint={ckpts}",
                            side_by_side=3)
        # Beside them, the same command with asset sharding at world size 1.
        asset_child = _Child(
            "train", *(o for o in common if not o.startswith("logger.")),
            f"logger.save_dir={save_dir / 'asset'}", "trainer.max_epochs=1",
            *DP_WORLD1, "trainer.shard_axis=asset", side_by_side=3)
        asset_child.save_dir = save_dir / "asset"
        threads = torch.get_num_threads()
        torch.set_num_threads(max(1, threads // 3))
        try:
            t0 = time.perf_counter()
            parity = _universe_parity(dm)
            parity_s = time.perf_counter() - t0
        finally:
            torch.set_num_threads(threads)
            test_lines, test_launches, test_s = _cli_result(test_child.wait())
            asset_run = asset_child.wait()
        kept = root / "universe_best"
        shutil.rmtree(kept, ignore_errors=True)
        kept.mkdir(parents=True)
        shutil.copytree(ckpts / "best", kept / "best")
        shutil.copy2(ckpts / "best.json", kept / "best.json")
        records = [r for r in read_records(ckpts.parent) if "lr-Adam" in r]
        quality = _quality_of_run(ckpts, ckpts.parent / "telemetry")
        phase_data_parallel_asset(asset_run, asset_child, records)
    finally:
        shutil.rmtree(save_dir, ignore_errors=True)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        # universe_serve's CPU reference, made beside the stream epoch.
        reference = pool.submit(_universe_reference, kept, dm)
        stream = _universe_stream(dm)
        reference = reference.result()
    done = _done(run_lines)
    windows_per_s = done["steps_per_s"] * U_BATCH
    test_line = next(line for line in test_lines if line.startswith("test: "))
    test_metrics = {k: float(v) for k, v in
                    (kv.split("=") for kv in test_line[6:].split())}
    refusal = [line for line in test_lines if line.startswith("note: ")]
    module = _kfactor_spec().build_module(device="cpu")
    out = {
        "phase": "universe_train",
        "seconds": {"train": run_s, "test": test_s, "parity": parity_s},
        "steps": steps,
        "rows_per_step": U_BATCH * U_STOCKS,
        "layer_groups": module.layer_groups(U_T, U_BATCH * U_STOCKS, True,
                                            U_STOCKS),
        "done": done,
        "windows_per_s": windows_per_s,
        "asset_rows_per_s": windows_per_s * U_STOCKS,
        "epochs": [{k: v for k, v in r.items() if k.startswith("loss/")}
                   for r in records],
        "test": test_metrics,
        "test_note": refusal,
        "parity": {k: parity[k] for k in (
            "max_loss_rel_gap", "max_same_weights_grad_rel_gap",
            "max_param_abs_gap", "max_trajectory_grad_rel_gap")},
        "stream": stream,
        "quality": quality,
        "launches": {"train": run_launches, "test": test_launches},
    }
    emit(out)
    _check_quality("universe_train", quality)
    values = [*done.values(), *test_metrics.values()]
    if not (np.isfinite(values).all() and len(records) == TRAIN_EPOCHS):
        raise AssertionError(f"universe_train: missing or non-finite results: "
                             f"{out}")
    if out["layer_groups"] != [1, 1] or not refusal:
        raise AssertionError(f"universe_train: {out['layer_groups']}, "
                             f"{refusal}")
    missed = {k: run_launches[k] for k in ("lstm_bwd", "lstm_wgrad")
              if run_launches[k] != 2 * steps}
    if run_launches["lstm_fwd"] < 2 * steps:
        missed["lstm_fwd"] = run_launches["lstm_fwd"]
    if test_launches["lstm_fwd"] == 0:
        missed["test/lstm_fwd"] = 0
    missed.update({k: run_launches[k] for k in U_ABSENT if run_launches[k]})
    if missed:
        raise AssertionError(f"universe_train: kernels off the path: {missed}")
    return {**out, "checkpoints": kept, "reference": reference}


# The universe trajectory's tolerances. Losses 1e-5 relative, as for the
# other models. Gradients on both sides from the same weights (the CPU
# trajectory's), 2e-4 of the step's largest entry: at 8,192 rows the beta
# head's bias gradient is a sum of 8,192 rows' loadings gradients of both
# signs, which the card's f32 reduction (PyTorch's, not a port kernel) and
# the CPU's round apart; on an NVIDIA H100 80GB HBM3 at 700 W the two
# parted by 1.23e-4 there (step 2 of 5), and at the first step the card
# stood 2.0e-5 from float64, the CPU 6.4e-6 (``universe_parity`` prints
# the worst step and parameter and the float64 gaps). Parameters along the
# trajectories: 5e-5 abs, half an Adam step at lr 1e-4: summation order
# alone can flip a near-zero gradient's sign, which Adam turns into a step
# of lr in either direction (2.2e-5 on that card), while a wrong gradient
# moves a weight by about lr every step.
U_GRAD_RTOL = 2e-4
U_PARAM_TOL = 5e-5
# The beta head's bias gradient, the entry whose card-CPU gap set
# U_GRAD_RTOL, held on each side against float64 at steps 1 and 2: the CPU
# (the reference trajectory) at a tenth of that bound, the card at the
# bound itself. The gap's bound then cannot hide a drift of the reference
# side, nor the card's past it. Measured on an NVIDIA H100 80GB HBM3 at
# 700.00 W: the card 2.05e-5 and 1.13e-4, the CPU 6.4e-6 and 8.7e-6: the
# card's f32 sum of the bias gradient over 8,192 rows is the far side.
U_F64_STEPS = 2
U_F64_RTOL = {"card": U_GRAD_RTOL, "cpu": U_GRAD_RTOL / 10}


def _f64_grads(spec, state, arrays) -> torch.Tensor:
    """The flat gradient of one training step's loss in float64 on the CPU
    (the plain versions), from ``state``: the rounding-free reference."""
    module = spec.build_module(device="cpu")
    module.load_state_dict(state)
    module.double()
    batch = Batch(*(torch.from_numpy(a).double() for a in arrays))
    alpha, beta = forward_rows(module, batch.x, deterministic=False)
    loss, _ = batched_objective(spec.window_objective())(
        alpha, beta, batch.y, batch.factor, batch.inv_psi)
    loss.backward()
    return torch.cat([p.grad.reshape(-1) for p in module.parameters()]).float()


def _universe_parity(dm) -> dict:
    """model=kfactor with dropout 0, 5 steps of 4 windows (8,192 rows) from
    the same weights on the card and on the CPU (plain versions): the
    trajectories' losses and weights, and each step's gradients on the
    card from the CPU trajectory's weights against the CPU's; each of the
    single-layer kernels launches twice a step."""
    spec = _kfactor_spec(dropout=0.0)
    state = spec.build_module(
        device="cpu", generator=torch.Generator().manual_seed(0)).state_dict()
    batches = _window_batches(dm, U_PARITY_STEPS, U_BATCH)
    lk.reset_launch_counts()
    gpu_losses, gpu_grads, gpu_state, _ = _run_steps(spec, state, batches,
                                                     DEVICE)
    launches = dict(lk.LAUNCHES)
    starts: list = []
    cpu_losses, cpu_grads, cpu_state, _ = _run_steps(spec, state, batches,
                                                     "cpu", before=starts)
    same = [_run_steps(spec, w, [b], DEVICE)[1][0]
            for w, b in zip(starts, batches)]
    exact = [_f64_grads(spec, starts[i], batches[i])
             for i in range(U_F64_STEPS)]
    names = [(n, p.numel()) for n, p in spec.build_module(
        device="cpu").named_parameters()]
    # The beta head's bias gradient, each side against float64 at each of
    # the first U_F64_STEPS steps (relative to the largest entry of the
    # float64 gradient, as _grad_gap reads it).
    offset = 0
    for name, size in names:
        if name == "beta_head.bias":
            bias = slice(offset, offset + size)
        offset += size
    bias_vs_f64 = {
        side: [float((grads[i][bias] - exact[i][bias]).abs().max()
                     / exact[i].abs().max()) for i in range(U_F64_STEPS)]
        for side, grads in (("card", same), ("cpu", cpu_grads))}
    gaps = [((g - c).abs() / c.abs().max()) for g, c in zip(same, cpu_grads)]
    worst = max(range(len(gaps)), key=lambda i: float(gaps[i].max()))
    where = int(gaps[worst].argmax())
    for name, size in names:
        if where < size:
            break
        where -= size
    loss_gap = max(abs(g - c) / abs(c) for g, c in zip(gpu_losses, cpu_losses))
    param_gap = max(float((gpu_state[k] - cpu_state[k]).abs().max())
                    for k in cpu_state)
    out = {
        "phase": "universe_parity",
        "steps": U_PARITY_STEPS,
        "rows_per_step": U_BATCH * U_STOCKS,
        "loss_first": cpu_losses[0],
        "loss_last": cpu_losses[-1],
        "max_loss_rel_gap": loss_gap,
        "loss_rtol": PARITY_LOSS_RTOL,
        "max_same_weights_grad_rel_gap": _grad_gap(same, cpu_grads),
        "worst_step_and_parameter": [worst, name],
        "first_step_vs_float64": {"card": _grad_gap(same[:1], exact[:1]),
                                  "cpu": _grad_gap(cpu_grads[:1], exact[:1])},
        "beta_bias_grad_vs_float64_by_step": bias_vs_f64,
        "beta_bias_f64_rtol": U_F64_RTOL,
        "grad_rtol": U_GRAD_RTOL,
        "max_param_abs_gap": param_gap,
        "param_tol": U_PARAM_TOL,
        "max_param_move": max(float((cpu_state[k] - state[k]).abs().max())
                              for k in state),
        "max_trajectory_grad_rel_gap": _grad_gap(gpu_grads, cpu_grads),
        "launches": launches,
    }
    emit(out)
    if not (loss_gap <= PARITY_LOSS_RTOL and param_gap <= U_PARAM_TOL
            and out["max_same_weights_grad_rel_gap"] <= U_GRAD_RTOL):
        raise AssertionError(f"universe: card and CPU differ: {out}")
    if not all(max(v) <= U_F64_RTOL[side] for side, v in bias_vs_f64.items()):
        raise AssertionError(f"universe: the beta head's bias gradient is off "
                             f"float64: {bias_vs_f64}")
    missed = {k: launches[k] for k in U_PATH
              if launches[k] != 2 * U_PARITY_STEPS}
    missed.update({k: launches[k] for k in U_ABSENT if launches[k]})
    if missed:
        raise AssertionError(f"universe_parity: not 2 a step: {missed}")
    return out


def _universe_stream(dm) -> dict:
    """One ``epoch_mode=stream`` epoch of model=kfactor over the store,
    graphed, prefetch 2 and prefetch 0 from the same seed (bit-equal), and
    the train split in order through the prefetcher (the memmap path)."""
    spec = _kfactor_spec()
    runs, seconds = {}, {}
    for depth in (2, 0):
        trainer = Trainer(max_epochs=1, gradient_clip_val=CLIP, seed=0,
                          device=DEVICE, epoch_mode="stream", prefetch=depth)
        t0 = time.perf_counter()
        runs[depth] = trainer.fit(spec, dm)
        seconds[depth] = time.perf_counter() - t0
    def losses(run):
        return [{k: v for k, v in r.items() if not k.startswith("data/")}
                for r in run.history]

    equal = (losses(runs[2]) == losses(runs[0])
             and all(torch.equal(runs[2].state[k], v)
                     for k, v in runs[0].state.items()))
    stats = PrefetchStats()
    t0 = time.perf_counter()
    n = 0
    for _ in prefetch_to_device(dm.train_batches(shuffle=False), 2, DEVICE,
                                stats):
        n += 1
    torch.cuda.synchronize()
    in_order_s = time.perf_counter() - t0
    row = runs[2].history[0]
    out = {
        "seconds": seconds,
        "prefetch_2_equals_0": equal,
        "shuffled_epoch": {k: row[k] for k in (
            "data/mmap_bytes", "data/fault_wait_s", "data/get_wait_s",
            "data/prefetch_mean_depth")},
        "in_order": {"batches": n, "seconds": in_order_s,
                     "mmap_bytes": stats.mmap_bytes,
                     "fault_wait_s": stats.fault_wait_s,
                     "get_wait_s": stats.get_wait_s},
    }
    print(f"universe stream: mmap_bytes={row['data/mmap_bytes']} "
          f"fault_wait_s={row['data/fault_wait_s']:.6f} (shuffled epoch); "
          f"mmap_bytes={stats.mmap_bytes} "
          f"fault_wait_s={stats.fault_wait_s:.6f} (in order)", flush=True)
    if not equal:
        raise AssertionError("universe stream: prefetch 2 differs from 0")
    if not np.isfinite(row["loss/total/train"]) or stats.mmap_bytes == 0:
        raise AssertionError(f"universe stream: {out}")
    return out


U_DISTINCT = 16  # distinct windows of the serving check, tiled to 64


def _universe_reference(ckpt_dir: Path, dm) -> dict:
    """The CPU engine's answers on the ``best`` checkpoint for the first
    ``U_DISTINCT`` val windows, and its seconds; ``windows`` tiles them to
    the largest bucket (rows are independent, so every row of a 64-window
    batch has its window's CPU answer; the CPU engine takes ~18 s for 64
    distinct windows on the card's 8-core host)."""
    distinct = np.asarray(dm.val_arrays().x[:U_DISTINCT])
    state, _, spec, _ = restore_checkpoint(ckpt_dir, "best")
    cpu = PredictEngine(spec, state, n_stocks=U_STOCKS, lookback=U_T,
                        n_features=U_FEATURES, buckets=(len(distinct),),
                        device="cpu")
    t0 = time.perf_counter()
    alpha, beta = cpu.predict(distinct)
    reps = -(-max(U_BUCKETS) // len(distinct))
    return {"windows": np.tile(distinct, (reps, 1, 1, 1))[:max(U_BUCKETS)],
            "alpha": np.tile(alpha, (reps, 1))[:max(U_BUCKETS)],
            "beta": np.tile(beta, (reps, 1))[:max(U_BUCKETS)],
            "seconds": time.perf_counter() - t0}


def phase_universe_serve(ckpt_dir: Path, reference: dict) -> dict:
    """The universe run's best checkpoint through
    ``PredictEngine.from_checkpoint`` on the ``serve=universe`` ladder, a
    CUDA graph a bucket: every bucket's answers, full and padded, within
    SERVE_TOL of the CPU engine's (``reference``: 16 val windows, tiled);
    bursts of 64 one-window requests through ``PredictServer``; the
    allocator's peak over the captures."""
    from masters_thesis_tpu_torch.serve.program_cache import ProgramCache

    windows, ref_a, ref_b = (reference[k] for k in ("windows", "alpha",
                                                    "beta"))
    cpu_s = reference["seconds"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    cache = ProgramCache()
    t0 = time.perf_counter()
    gpu = PredictEngine.from_checkpoint(ckpt_dir, "best", n_stocks=U_STOCKS,
                                        n_features=U_FEATURES,
                                        buckets=U_BUCKETS, device=DEVICE,
                                        program_cache=cache)
    warm_s = gpu.warmup()
    cold_boot_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    errs = {}
    for n in (1, 2, 3, 4, 8, 16, 32, 48, 64):
        a, b = gpu.predict(windows[:n])
        errs[n] = _max_err((a, b), (ref_a[:n], ref_b[:n]))
    server = PredictServer(gpu, max_wait_s=0.002)
    lk.reset_launch_counts()
    server.start()
    responses = []
    t0 = time.perf_counter()
    try:
        for _ in range(U_BURSTS):
            pending = [server.submit(w, deadline_s=5.0) for w in windows]
            responses += [p.result(timeout=60.0) for p in pending]
        serve_s = time.perf_counter() - t0
    finally:
        stats = server.stop()
    launches = dict(lk.LAUNCHES)
    alpha = np.stack([r.outputs[0] for r in responses if r.ok])
    burst_err = _max_err((alpha,), (np.tile(ref_a, (U_BURSTS, 1)),))
    answers_per_s = len(responses) / serve_s
    out = {
        "phase": "universe_serve",
        "buckets": list(U_BUCKETS),
        "layer_groups": {b: gpu._module.layer_groups(U_T, b * U_STOCKS, False,
                                                     U_STOCKS)
                         for b in U_BUCKETS},
        "compile_events": gpu.compile_events,
        "warmup_s": warm_s,
        "cpu_reference_s": cpu_s,
        "distinct_windows": U_DISTINCT,
        "max_abs_err_vs_cpu": errs,
        "burst_max_abs_err_vs_cpu": burst_err,
        "tol": SERVE_TOL,
        "requests": len(responses),
        "ok": sum(r.ok for r in responses),
        "dispatches": stats["dispatches"],
        "batch_size_counts": stats["batch_size_counts"],
        "late_deliveries": stats["late_deliveries"],
        "p50_ms": stats["p50_ms"],
        "p99_ms": stats["p99_ms"],
        "answers_per_s": answers_per_s,
        "asset_rows_per_s": answers_per_s * U_STOCKS,
        "capture_peak_bytes": gpu.capture_peak_bytes,
        "max_memory_allocated": peak,
        "memory_allocated_before": before,
        "memory_reserved": torch.cuda.memory_reserved(),
        "launches": launches,
    }
    emit(out)
    worst = max(errs.values())
    if not (worst <= SERVE_TOL and burst_err <= SERVE_TOL):
        raise AssertionError(f"universe_serve: answers differ from the CPU "
                             f"engine: {errs}, {burst_err}")
    if gpu.compile_events != len(U_BUCKETS) or out["ok"] != len(responses):
        raise AssertionError(f"universe_serve: {gpu.compile_events} captures, "
                             f"{out['ok']} of {len(responses)} ok")
    if stats["late_deliveries"] or launches["lstm_fwd"] < 2 * stats["dispatches"]:
        raise AssertionError(f"universe_serve: launches {launches}, stats "
                             f"{stats}")
    if any(launches[k] for k in U_ABSENT + ("lstm_bwd",)):
        raise AssertionError(f"universe_serve left lstm_fwd: {launches}")
    out["warm_boot"] = _universe_warm_boot(gpu, cache, ckpt_dir, windows,
                                           cold_boot_s)
    del gpu, server
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _universe_warm_boot(gpu, cache, ckpt_dir: Path, windows: np.ndarray,
                        cold_boot_s: float) -> dict:
    """The ladder 1-64 closed into ``cache`` and booted again from it: the
    cold and warm boot seconds (each bucket's, and the engine's from the
    checkpoint), the allocator's peak over the warm boot, and the warm
    engine's answers on every bucket bit for bit the cold engine's. Its
    launches are counted apart (``universe_serve_warm``)."""
    sizes = (1, 2, 3, 4, 8, 16, 32, 48, 64)
    want = {n: gpu.predict(windows[:n]) for n in sizes}
    cold_bucket_s = dict(gpu.boot_s)
    lk.reset_launch_counts()
    t0 = time.perf_counter()
    gpu.close()
    close_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    warm = PredictEngine.from_checkpoint(ckpt_dir, "best", n_stocks=U_STOCKS,
                                         n_features=U_FEATURES,
                                         buckets=U_BUCKETS, device=DEVICE,
                                         program_cache=cache)
    warm.warmup()
    warm_boot_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    bitwise = {n: all(np.array_equal(g, w) for g, w in
                      zip(warm.predict(windows[:n]), want[n])) for n in sizes}
    launches = {k: v for k, v in lk.LAUNCHES.items() if v}
    out = {"phase": "universe_serve_warm", "buckets": list(U_BUCKETS),
           "cold_boot_s": cold_boot_s, "cold_bucket_s": cold_bucket_s,
           "close_s": close_s, "warm_boot_s": warm_boot_s,
           "warm_bucket_s": dict(warm.boot_s),
           "captures": warm.compile_events, "cache_hits": warm.cache_hits,
           "max_memory_allocated_warm": peak, "bitwise": bitwise,
           "cache": cache.stats(), "launches": launches, "card": _card()}
    emit(out)
    warm.close()
    cache.close()
    if (warm.compile_events, warm.cache_hits) != (0, len(U_BUCKETS)) or \
            not all(bitwise.values()) or not launches.get("lstm_fwd"):
        raise AssertionError(f"universe_serve_warm: {out}")
    return out


# ------------------------------------------------------- stacked replicas

# R replicas of model=small in one program: the replica axis of the pair
# kernels (stacked_kernels at R = 1, 2, 4, 8), StackedTrainer.fit on train
# small's data (stacked_train at R = 1, 8), the stacked entry point as a
# child (stacked_driver, R = 4) and its four ``best``s served as four lanes
# of one StackedPredictEngine (stacked_serve). Seeds 0 .. R - 1; rates cycle
# over the thesis grid's (sweeps/experiment_thesis_grid.sh), replica 0 at
# the configs' 1e-4, so that it is phase_train's run.
STACK_RS = (1, 2, 4, 8)
# The single layer's and the stack's replica axes at R = 1 and 8 (PERF.md
# keeps their times at R = 2, 4 from a run at STACK_RS).
GROUPING_KERNEL_RS = (1, 8)
STACK_TRAIN_RS = (1, 8)
STACK_LRS = (1e-4, 1e-3, 1e-5, 1e-6)
STACK_DRIVER_R = 4
# Replica r of a stacked fit against the solo Trainer.fit of its seed and
# rate: the target is bit for bit (the kernels give each replica its solo
# bits); the bound held is the JAX package's stacked contract
# (tests/test_stacked.py): epoch 0's sums bitwise, then sums 1e-5
# relative, parameters 1e-4 relative + 1e-7 abs, moments 1e-3 relative.
STACK_SUM_RTOL = 1e-5
STACK_PARAM_RTOL, STACK_PARAM_ATOL = 1e-4, 1e-7
STACK_MOMENT_RTOL = 1e-3
# The pair rows of the kernels line and their replica-axis counters.
STACKED_COUNTERS = {
    "lstm_pair_fwd": "lstm_pair_fwd_stacked",
    "lstm_pair_fwd_masked": "lstm_pair_fwd_masked_stacked",
    "lstm_pair_bwd": "lstm_pair_bwd_stacked",
    "lstm_wgrad": "lstm_wgrad_stacked",
}
# The replica axes of the single layer and the stack: each entry of
# the kernels line, (its row in stacked_kernels, rows of the path it is
# read at, its counter, the stacked path whose launches it reports).
GROUPING_KERNELS = {
    "lstm_fwd_stacked": ("lstm_fwd", 100, "lstm_fwd_stacked",
                         "stacked_groupings"),
    "lstm_bwd_stacked": ("lstm_bwd", 100, "lstm_bwd_stacked",
                         "stacked_groupings"),
    "lstm_wgrad_single_stacked": ("lstm_wgrad_single", 100,
                                  "lstm_wgrad_stacked", "stacked_groupings"),
    "lstm_stack_fwd_stacked": ("lstm_stack_fwd", 8 * K_MEDIUM,
                               "lstm_stack_fwd_stacked", "stacked_serve"),
    "lstm_stack_fwd_masked_stacked": ("lstm_stack_fwd_masked", K_MEDIUM,
                                      "lstm_stack_fwd_masked_stacked",
                                      "stacked_groupings"),
    "lstm_stack_bwd_stacked": ("lstm_stack_bwd", K_MEDIUM,
                               "lstm_stack_bwd_stacked", "stacked_groupings"),
    "lstm_wgrad_stack_stacked": ("lstm_wgrad_stack", K_MEDIUM,
                                 "lstm_wgrad_stacked", "stacked_groupings"),
    "lstm_tb_fwd_stacked": ("lstm_tb_fwd", 100, "lstm_tb_fwd_stacked",
                            "stacked_tblocked"),
    "lstm_tb_bwd_stacked": ("lstm_tb_bwd", 100, "lstm_tb_bwd_stacked",
                            "stacked_tblocked"),
}


def stacked_root() -> Path:
    return Path(__file__).resolve().parent / "data" / "chip_smoke" / "stacked"


def _stack_replicas(n: int) -> list:
    return [ReplicaSpec(f"r{i}", i, STACK_LRS[i % len(STACK_LRS)])
            for i in range(n)]


def _stacked_kernel_inputs(rows: int) -> dict:
    """max(STACK_RS) replicas' pair operands at ``rows`` rows, drawn on the
    card (each replica its own x, weights, mask and cotangent), then the
    stacked forward's stashes and the stacked sweep's d_pre planes as the
    sweep's and the pass's inputs."""
    n = max(STACK_RS)
    gen = torch.Generator(device=DEVICE).manual_seed(rows)
    scale = 1.0 / np.sqrt(H)

    def uniform(*shape):
        return (torch.rand(shape, generator=gen, device=DEVICE) * 2 - 1) * scale

    v = {"x": torch.randn((n, T, rows, 4 * H), generator=gen, device=DEVICE),
         "w1": uniform(n, H, 4 * H), "wi2": uniform(n, H, 4 * H),
         "b2": uniform(n, 4 * H), "w2": uniform(n, H, 4 * H),
         "mask": (torch.rand((n, T, rows, H), generator=gen, device=DEVICE)
                  >= 0.2).float() / 0.8,
         "dh": 0.1 * torch.randn((n, T, rows, H), generator=gen, device=DEVICE)}
    with torch.no_grad():
        v["h2s"], v["h1s"], v["c1s"], v["c2s"] = lk.lstm_pair_fwd_stacked_cuda(
            v["x"], v["w1"], v["wi2"], v["b2"], v["w2"], v["mask"], stash=True)
        v["dx1"], v["d_pre2"] = lk.lstm_pair_bwd_stacked_cuda(
            v["dh"], v["x"], v["mask"], v["h1s"], v["c1s"], v["h2s"], v["c2s"],
            v["w1"], v["wi2"], v["b2"], v["w2"])
    return v


def _stacked_grouping_inputs(rows: int, stack: bool) -> dict:
    """max(STACK_RS) replicas' single-layer operands (``stack`` False) or
    4-deep stack operands at ``rows`` rows, drawn on the card, then their
    replica-axis forward's stashes and sweep's d_pre planes as the sweep's
    and the pass's inputs."""
    n = max(STACK_RS)
    gen = torch.Generator(device=DEVICE).manual_seed(1000 + rows)
    scale = 1.0 / np.sqrt(H)

    def uniform(*shape):
        return (torch.rand(shape, generator=gen, device=DEVICE) * 2 - 1) * scale

    def mask():
        return (torch.rand((n, T, rows, H), generator=gen, device=DEVICE)
                >= 0.3).float() / 0.7

    v = {"x": torch.randn((n, T, rows, 4 * H), generator=gen, device=DEVICE),
         "dh": 0.1 * torch.randn((n, T, rows, H), generator=gen, device=DEVICE)}
    with torch.no_grad():
        if not stack:
            v["w"] = uniform(n, H, 4 * H)
            v["hs"], v["cs"] = lk.lstm_fwd_stacked_cuda(v["x"], v["w"],
                                                        return_c=True)
            v["dx"] = lk.lstm_bwd_stacked_cuda(v["dh"], v["x"], v["hs"],
                                               v["cs"], v["w"])
            return v
        seams = STACK_LAYERS - 1
        v["w_hh"] = [uniform(n, H, 4 * H) for _ in range(STACK_LAYERS)]
        v["w_in"] = [uniform(n, H, 4 * H) for _ in range(seams)]
        v["biases"] = [uniform(n, 4 * H) for _ in range(seams)]
        v["masks"] = [mask() for _ in range(seams)]
        weights = (v["w_hh"], v["w_in"], v["biases"])
        v["hs"], v["cs"] = lk.lstm_stack_fwd_stacked_cuda(
            v["x"], *weights, v["masks"], stash=True)
        v["d_pres"] = lk.lstm_stack_bwd_stacked_cuda(
            v["dh"], v["x"], v["masks"], v["hs"], v["cs"], *weights)
    return v


def _grouping_calls(v: dict, n: int, stack: bool) -> dict:
    """As ``_stacked_calls``, for the single layer's replica-axis kernels
    (forward with its c stash, sweep, one-job pass) or the 4-deep
    stack's (forward maskless and masked with its stashes, sweep, 7-job
    pass)."""
    def first(t):
        return [u[:n] for u in t] if isinstance(t, list) else t[:n]

    a = {k: first(t) for k, t in v.items()}

    def solo(fn, *args):
        def at(t, r):
            return [u[r] for u in t] if isinstance(t, list) else t[r]
        return lambda: [fn(*(at(t, r) for t in args)) for r in range(n)]

    if not stack:
        return {
            "lstm_fwd": (
                lambda: lk.lstm_fwd_stacked_cuda(a["x"], a["w"], return_c=True),
                solo(lambda x, w: lk.lstm_fwd_cuda(x, w, return_c=True),
                     a["x"], a["w"]),
                lambda: lk.lstm_recurrence_stacked_ref(a["x"], a["w"],
                                                       return_c=True), False),
            "lstm_bwd": (
                lambda: lk.lstm_bwd_stacked_cuda(a["dh"], a["x"], a["hs"],
                                                 a["cs"], a["w"]),
                solo(lk.lstm_bwd_cuda, a["dh"], a["x"], a["hs"], a["cs"],
                     a["w"]),
                lambda: lk.lstm_bwd_stacked_ref(a["dh"], a["x"], a["hs"],
                                                a["cs"], a["w"]), True),
            "lstm_wgrad_single": (
                lambda: lk.lstm_single_wgrad_stacked(a["dx"], a["hs"]),
                solo(lk.lstm_single_wgrad, a["dx"], a["hs"]),
                lambda: lk.lstm_single_wgrad_stacked_ref(a["dx"], a["hs"]),
                True),
        }
    weights = (a["w_hh"], a["w_in"], a["biases"])
    bwd = (a["dh"], a["x"], a["masks"], a["hs"], a["cs"]) + weights
    return {
        "lstm_stack_fwd": (
            lambda: lk.lstm_stack_fwd_stacked_cuda(a["x"], *weights),
            solo(lk.lstm_stack_fwd_cuda, a["x"], *weights),
            lambda: lk.lstm_stack_stacked_ref(a["x"], *weights), False),
        "lstm_stack_fwd_masked": (
            lambda: lk.lstm_stack_fwd_stacked_cuda(a["x"], *weights,
                                                   a["masks"], stash=True),
            solo(lambda *t: lk.lstm_stack_fwd_cuda(*t, stash=True), a["x"],
                 *weights, a["masks"]),
            lambda: lk.lstm_stack_stacked_ref(a["x"], *weights, a["masks"],
                                              return_stash=True), False),
        "lstm_stack_bwd": (
            lambda: lk.lstm_stack_bwd_stacked_cuda(*bwd),
            solo(lk.lstm_stack_bwd_cuda, *bwd),
            lambda: lk.lstm_stack_bwd_stacked_ref(*bwd), True),
        "lstm_wgrad_stack": (
            lambda: lk.lstm_stack_wgrad_stacked(a["d_pres"], a["hs"],
                                                a["masks"]),
            solo(lk.lstm_stack_wgrad, a["d_pres"], a["hs"], a["masks"]),
            lambda: lk.lstm_stack_wgrad_stacked_ref(a["d_pres"], a["hs"],
                                                    a["masks"]), True),
    }


def _stacked_tb_inputs(rows: int) -> dict:
    """max(STACK_RS) replicas' time-blocked operands at T=252 and ``rows``
    rows, drawn on the card, with the replica-axis forward's stashes as the
    backward's inputs."""
    n = max(STACK_RS)
    gen = torch.Generator(device=DEVICE).manual_seed(2000 + rows)
    scale = 1.0 / np.sqrt(H)
    v = {"x": torch.randn((n, T_LONG, rows, 4 * H), generator=gen,
                          device=DEVICE),
         "w": (torch.rand((n, H, 4 * H), generator=gen, device=DEVICE) * 2
               - 1) * scale,
         "dh": 0.1 * torch.randn((n, T_LONG, rows, H), generator=gen,
                                 device=DEVICE)}
    with torch.no_grad():
        v["hs"], v["cs"] = lk.lstm_tb_fwd_stacked_cuda(v["x"], v["w"],
                                                       return_c=True)
    return v


def _tb_calls(v: dict, n: int) -> dict:
    """As ``_stacked_calls``, for the time-blocked replica axis: the
    forward with its c stash and the backward (dx and the summed dw), the
    plain versions in the reference's time chunks and row tiles."""
    a = {k: t[:n] for k, t in v.items()}
    rows = a["x"].shape[2]
    chunk, tile = lk.tb_time_chunk(rows, H), lk._row_tile(rows)
    bwd = (a["dh"], a["x"], a["hs"], a["cs"], a["w"])

    def solo(fn, *args):
        return lambda: [fn(*(t[r] for t in args)) for r in range(n)]

    return {
        "lstm_tb_fwd": (
            lambda: lk.lstm_tb_fwd_stacked_cuda(a["x"], a["w"], return_c=True),
            solo(lambda x, w: lk.lstm_tb_fwd_cuda(x, w, return_c=True),
                 a["x"], a["w"]),
            lambda: lk.lstm_tb_stacked_ref(a["x"], a["w"], chunk), False),
        "lstm_tb_bwd": (
            lambda: lk.lstm_tb_bwd_stacked_cuda(*bwd),
            solo(lk.lstm_tb_bwd_cuda, *bwd),
            lambda: lk.lstm_tb_bwd_stacked_ref(*bwd, chunk, tile), True),
    }


def _stacked_calls(v: dict, n: int) -> dict:
    """Each replica-axis kernel on the first ``n`` replicas: (the stacked
    call, the ``n`` solo calls, the plain version, relative tolerance)."""
    a = {k: t[:n] for k, t in v.items()}
    pair = (a["x"], a["w1"], a["wi2"], a["b2"], a["w2"])
    bwd = (a["dh"], a["x"], a["mask"], a["h1s"], a["c1s"], a["h2s"], a["c2s"],
           a["w1"], a["wi2"], a["b2"], a["w2"])
    wgrad = (a["dx1"], a["d_pre2"], a["h1s"], a["h2s"], a["mask"])

    def solo(fn, args):
        return lambda: [fn(*(t[r] for t in args)) for r in range(n)]

    return {
        "lstm_pair_fwd": (lambda: lk.lstm_pair_fwd_stacked_cuda(*pair),
                          solo(lk.lstm_pair_fwd_cuda, pair),
                          lambda: lk.lstm_pair_stacked_ref(*pair), False),
        "lstm_pair_fwd_masked": (
            lambda: lk.lstm_pair_fwd_stacked_cuda(*pair, a["mask"], stash=True),
            solo(lambda *t: lk.lstm_pair_fwd_cuda(*t, stash=True),
                 pair + (a["mask"],)),
            lambda: lk.lstm_pair_stacked_ref(*pair, a["mask"], return_stash=True),
            False),
        "lstm_pair_bwd": (lambda: lk.lstm_pair_bwd_stacked_cuda(*bwd),
                          solo(lk.lstm_pair_bwd_cuda, bwd),
                          lambda: lk.lstm_pair_bwd_stacked_ref(*bwd), True),
        "lstm_wgrad": (lambda: lk.lstm_pair_wgrad_stacked(*wgrad),
                       solo(lk.lstm_pair_wgrad, wgrad),
                       lambda: lk.lstm_pair_wgrad_stacked_ref(*wgrad), True),
    }


# The replica-axis launches at a named 8-row tile, on all of ``v``'s
# replicas (phase_stacked_kernels, R = 8 at 100 rows).
TILE8 = {
    "lstm_pair_fwd": lambda v: lk.lstm_pair_fwd_stacked_cuda(
        v["x"], v["w1"], v["wi2"], v["b2"], v["w2"], tile=8),
    "lstm_pair_fwd_masked": lambda v: lk.lstm_pair_fwd_stacked_cuda(
        v["x"], v["w1"], v["wi2"], v["b2"], v["w2"], v["mask"], stash=True,
        tile=8),
    "lstm_pair_bwd": lambda v: lk.lstm_pair_bwd_stacked_cuda(
        v["dh"], v["x"], v["mask"], v["h1s"], v["c1s"], v["h2s"], v["c2s"],
        v["w1"], v["wi2"], v["b2"], v["w2"], tile=8),
}


def _solo_flops_bytes(name: str, rows: int) -> tuple[float, float]:
    """One replica's operations and bytes, as the solo kernel rows count
    them (``cost``; the single forwards with their c plane written too, the
    time-blocked kernels at T=252)."""
    return cost(name, rows, n_t=T_LONG if name.startswith("lstm_tb") else T,
                with_c=name in ("lstm_fwd", "lstm_tb_fwd"))


def _stacked_tiles(name: str, rows: int, n: int) -> dict:
    """The row tile a replica-axis launch of ``name`` takes at ``n``
    replicas, and the solo launch's (the weight-gradient pass has none)."""
    if name.startswith("lstm_wgrad"):
        return {"tile": None, "solo_tile": None}
    if name.startswith("lstm_stack"):
        backward = name == "lstm_stack_bwd"
        masked = name != "lstm_stack_fwd"
        tile = functools.partial(lk.lstm_stack_row_tile_cuda, STACK_LAYERS,
                                 rows, H, DEVICE, backward, masked,
                                 masked and not backward)
        return {"tile": tile(replicas=n), "solo_tile": tile()}
    return {"tile": lk.lstm_sweep_tile_cuda(rows, n),
            "solo_tile": lk.lstm_sweep_tile_cuda(rows, 1)}


def _single_wgrad_library_ms(v: dict, n: int) -> float:
    """One cuBLAS call for ``n`` replicas' single-layer weight gradients:
    a batched product of the shifted h planes (shifted beforehand, not
    timed) with the d_pre planes."""
    hs, dx = v["hs"][:n], v["dx"][:n]
    shifted = torch.cat([torch.zeros_like(hs[:, :1]), hs[:, :-1]], dim=1)
    a = shifted.reshape(n, -1, H).transpose(1, 2)
    d = dx.reshape(n, -1, 4 * H)
    return cuda_ms(lambda: torch.bmm(a, d), iters=10, loops=3)[0]


def phase_stacked_kernels(kernels: dict) -> dict:
    """Each replica-axis kernel: the pair forward maskless and masked with
    its stashes, the sweep, the R x 3-job pass at R = 1, 2, 4, 8 on 100
    rows (a training step) and 800 (a serving bucket of 8 windows); the
    single layer's forward, sweep and one-job pass on 100 and 800 rows and
    the 4-deep stack's forward maskless and masked, sweep and 7-job pass on
    25 and 200 rows at R = 1, 8 (GROUPING_KERNEL_RS): one
    launch against R solo launches of the same kernel, the plain version
    (R solo plain versions), the bound (R x the solo bound) and R x the
    library call's time (phase_kernels' and phase_training_kernels'); its
    error against the plain version and each replica's slice bit for bit
    against its solo launch. At 100 rows and R = 8 the pair's forwards and
    sweep at 8-row tiles, which part from the solo bits, say what keeping
    the solo tile's class costs (lstm_sweep.cuh sweep_rows). The
    time-blocked forward (with c) and backward at T=252 on 100 and 800 rows
    at R = 1, 8 likewise (at 100 rows and R = 8 on 2-row tiles, one dw
    partial a row)."""
    results = {}
    groups = [(rows, _stacked_kernel_inputs, _stacked_calls, STACK_RS)
              for rows in (100, 800)]
    groups += [(rows, functools.partial(_stacked_grouping_inputs, stack=stack),
                functools.partial(_grouping_calls, stack=stack),
                GROUPING_KERNEL_RS)
               for stack, all_rows in ((False, (100, 800)),
                                       (True, (K_MEDIUM, 8 * K_MEDIUM)))
               for rows in all_rows]
    groups += [(rows, _stacked_tb_inputs, _tb_calls, GROUPING_KERNEL_RS)
               for rows in (100, 800)]
    for rows, inputs, calls, replica_counts in groups:
        v = inputs(rows)
        for n in replica_counts:
            for name, (stacked, solo, plain, relative) in calls(v, n).items():
                with torch.no_grad():
                    got = stacked()
                    singles = solo()
                    torch.cuda.synchronize()
                    want = plain()
                err = _max_abs_err(got, want)
                tol = KERNEL_TOL * (max(1.0, _largest(want)) if relative else 1.0)
                parts = [_as_tuple(s) for s in singles]
                bitwise = all(torch.equal(g[r], parts[r][i])
                              for i, g in enumerate(_as_tuple(got))
                              for r in range(n))
                flops, nbytes = _solo_flops_bytes(name, rows)
                bound_ms, bound_by = bound(n * flops, n * nbytes)
                library = kernels.get((name, rows), {}).get("library_ms")
                if name == "lstm_wgrad_single":
                    library = _single_wgrad_library_ms(v, n)
                row = {
                    "phase": "stacked_kernel", "name": name, "rows": rows,
                    "replicas": n, "H": H,
                    "T": T_LONG if name.startswith("lstm_tb") else T,
                    **_stacked_tiles(name, rows, n),
                    "max_abs_err": err, "tol": tol,
                    "replicas_bit_equal_to_solo": bitwise,
                    **timed("ms", stacked, iters=10, loops=3),
                    **timed("solo_ms", solo, iters=10, loops=3),
                    "plain_ms": cuda_ms(plain, iters=1, loops=1, warmup=0)[0],
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": (None if library is None else
                                   library if name == "lstm_wgrad_single"
                                   else n * library),
                    "flops": n * flops, "bytes": n * nbytes,
                }
                if rows == 100 and n == max(STACK_RS) and name in TILE8:
                    # What keeping the solo tile's class costs: the same
                    # launch at 8-row tiles (one wave), and its bits.
                    tile8 = functools.partial(TILE8[name], v)
                    with torch.no_grad():
                        other = tile8()
                    row["tile8_device_ms"] = spin_ms(tile8)
                    row["tile8_bit_equal"] = all(
                        torch.equal(a, b) for a, b in zip(_as_tuple(other),
                                                          _as_tuple(got)))
                emit(row)
                if not err <= tol:
                    raise AssertionError(f"stacked {name} R={n} rows={rows}: "
                                         f"max abs err {err} > {tol}")
                if not bitwise:
                    raise AssertionError(f"stacked {name} R={n} rows={rows}: a "
                                         "replica differs from its solo launch")
                results[(name, rows, n)] = row
        del v
    return results


def _stacked_step_breakdown(dm, spec, n: int) -> dict:
    """The stacked training step of ``n`` replicas as its CUDA graph (128
    windows, one a step each, re-shuffled when they run out): host wall
    clock per step ending synchronized, the device time by kernel and the
    idle share from a profiler trace, one replay under the synchronisation
    check set to raise."""
    replicas = _stack_replicas(n)
    module = StackedLstmEncoder([
        spec.build_module(device=DEVICE,
                          generator=torch.Generator().manual_seed(r.seed))
        for r in replicas])
    optimizer = StackedFlatAdam(module.replicas, CLIP, spec.weight_decay)
    data = device_split(Batch(*(a[:128] for a in dm.train_arrays())), DEVICE)
    program = StackedTrainProgram(
        module, optimizer, spec.window_objective(), data, 1,
        [torch.Generator(device=DEVICE).manual_seed(r.seed) for r in replicas],
        graphed=True)
    taken = [0]

    def replay() -> None:
        if taken[0] % program.n_steps == 0:
            program.begin_epoch([r.learning_rate for r in replicas])
        taken[0] += 1
        program.step()

    def step():
        replay()
        torch.cuda.synchronize()

    host, busy_ms, device = _wall_and_device(step)  # its warm-up captures
    torch.cuda.set_sync_debug_mode("error")
    try:
        replay()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return {"step_wall_ms_p50": host["wall_ms_p50"],
            "step_wall_ms_spread": host["wall_ms_spread"],
            "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / host["wall_ms_p50"],
            "device_ms_by_kernel": device[:8],
            "launches_per_step": program.step.launches}


def _against_solo(got, solo) -> dict:
    """Replica ``got`` of a stacked fit against the solo ``TrainResult``:
    bit for bit or not, and the JAX stacked contract's gaps."""
    sums = [(g[k], s[k]) for g, s in zip(got.history, solo.history)
            for k in s if k.startswith("loss/")]
    epoch0 = all(g[k] == s[k] for g, s in zip(got.history[:1], solo.history[:1])
                 for k in s if k.startswith("loss/"))
    sum_gap = max(abs(a - b) / max(abs(b), 1e-30) for a, b in sums)
    param_excess = max(float(((got.state[k] - v).abs()
                              - STACK_PARAM_RTOL * v.abs()).max())
                       for k, v in solo.state.items())
    moment_gap = max(float(((got.opt_state[k] - solo.opt_state[k]).abs()
                            / solo.opt_state[k].abs().clamp_min(1e-30)).max())
                     for k in ("mu", "nu"))
    bitwise = (got.history == solo.history
               and all(torch.equal(got.state[k], v) for k, v in solo.state.items())
               and all(torch.equal(got.opt_state[k], solo.opt_state[k])
                       for k in ("mu", "nu")))
    within = (epoch0 and sum_gap <= STACK_SUM_RTOL
              and param_excess <= STACK_PARAM_ATOL
              and moment_gap <= STACK_MOMENT_RTOL)
    return {"bit_equal": bitwise, "epoch0_sums_bitwise": epoch0,
            "max_sum_rel_gap": sum_gap,
            "max_param_gap_past_rtol": param_excess,
            "max_moment_rel_gap": moment_gap, "within_contract": within}


def phase_stacked_train(dm, train: dict) -> dict:
    """StackedTrainer.fit at model=small full width (dropout 0.2, mse, clip
    5) on train small's data, graphed, for R = 1 (2 epochs, phase_train's
    depth) and R = 8 (1 epoch, timed whole, its capture included): its
    steps/s and replica-windows/s against phase_train's solo Trainer.fit,
    a step's wall and idle share, the launches; replica 0 (seed 0, lr 1e-4)
    against phase_train's run (at R = 1 the whole run, at R = 8 its
    first epoch's row); then at R = 2 a ``stacked.replica_loss`` nan plan
    on replica 1 that masks it while replica 0 matches the unfaulted run
    (R = 1's) bit for bit."""
    spec = _train_spec()
    solo = train["fit"]
    runs, out = {}, {"phase": "stacked_train", "lrs": list(STACK_LRS), "rs": {},
                     "solo_windows_per_s": solo.windows_per_sec}
    launches = {}
    for n in STACK_TRAIN_RS:
        epochs = TRAIN_EPOCHS if n == 1 else 1
        trainer = StackedTrainer(max_epochs=epochs, gradient_clip_val=CLIP,
                                 device=DEVICE)
        lk.reset_launch_counts()
        t0 = time.perf_counter()
        runs[n] = trainer.fit(spec, dm, _stack_replicas(n))
        fit_s = time.perf_counter() - t0
        launches[n] = dict(lk.LAUNCHES)
        result = runs[n]
        first = result.replicas[0]
        out["rs"][n] = {
            "epochs": epochs,
            "fit_seconds": fit_s,
            "steps_per_s": result.steps_per_sec,
            "replica_windows_per_s": result.replica_steps_per_sec,
            "replica_windows_per_s_over_solo": result.replica_steps_per_sec
            / solo.windows_per_sec,
            "statuses": [r.status for r in result.replicas],
            "best_val": [r.best_val_loss for r in result.replicas],
            "replica0_against_solo": (
                _against_solo(first, solo) if epochs == TRAIN_EPOCHS else
                {"epoch0_row_bitwise": first.history[0] == solo.history[0]}),
            "step": _stacked_step_breakdown(dm, spec, n),
            "launches": {k: v for k, v in launches[n].items() if v},
        }
    plan = {"faults": [{"point": "stacked.replica_loss", "kind": "nan",
                        "attempt": None, "match": {"replica": 1}}]}
    faults.install_plan(faults.FaultPlan.parse(json.dumps(plan)))
    try:
        faulted = StackedTrainer(max_epochs=TRAIN_EPOCHS, gradient_clip_val=CLIP,
                                 device=DEVICE).fit(spec, dm, _stack_replicas(2))
    finally:
        faults.clear_plan()
    clean, kept = runs[1].replicas[0], faulted.replicas[0]
    sibling = (kept.history == clean.history
               and all(torch.equal(kept.state[k], v) for k, v in clean.state.items()))
    out["fault"] = {"plan": plan,
                    "statuses": [r.status for r in faulted.replicas],
                    "rollbacks": [r.rollbacks for r in faulted.replicas],
                    "sibling_bit_equal_to_unfaulted": sibling}
    out["launches"] = launches[max(STACK_TRAIN_RS)]
    emit({**out, "launches": {k: v for k, v in out["launches"].items() if v}})
    for n in STACK_TRAIN_RS:
        row = out["rs"][n]
        check = row["replica0_against_solo"]
        if row["statuses"] != ["active"] * n:
            raise AssertionError(f"stacked_train R={n}: {row['statuses']}")
        if not check.get("within_contract", check.get("epoch0_row_bitwise")):
            raise AssertionError(f"stacked_train R={n}: replica 0 off the "
                                 f"solo run: {check}")
        steps = row["epochs"] * len(dm.train_range)
        want = {c: steps for c in ("lstm_pair_fwd_masked_stacked",
                                   "lstm_pair_bwd_stacked", "lstm_wgrad_stacked")}
        got = {c: launches[n][c] for c in want}
        if got != want or launches[n]["lstm_pair_fwd_masked"]:
            raise AssertionError(f"stacked_train R={n}: the replica axis not "
                                 f"once a step: {got}")
    if out["fault"]["statuses"] != ["active", "masked"] or not sibling:
        raise AssertionError(f"stacked_train: the fault plan: {out['fault']}")
    return out


# The other groupings stacked: one layer on train small's windows
# and model=medium (one 4-deep stack on 25-row windows), each a graphed
# StackedTrainer.fit of R = 4 for one epoch against the solo Trainer.fit
# of replica 0's seed and rate; model=large (7 + 1) and model=kfactor (two
# single layers at 8,192 rows a step) each a 5-step graphed stacked
# trajectory of R = 2, every replica against its solo graphed program.
GROUPING_FIT_R = 4
GROUPING_STEP_RS = (1, 8)
GROUPING_TRAJECTORY_R, GROUPING_TRAJECTORY_STEPS = 2, 5


def _stacked_trajectory(spec, data: Batch, batch: int) -> dict:
    """``GROUPING_TRAJECTORY_STEPS`` graphed steps of a stacked program of
    R replicas (seeds 0 .. R - 1, rates STACK_LRS, each replica's shuffle
    and masks from its epoch-0 generator) on ``data``, and of each
    replica's solo graphed ``TrainProgram`` the same way: parameters and
    Adam moments bit for bit, and the stacked launches."""
    replicas = _stack_replicas(GROUPING_TRAJECTORY_R)
    module = StackedLstmEncoder([
        spec.build_module(device=DEVICE,
                          generator=torch.Generator().manual_seed(r.seed))
        for r in replicas])
    optimizer = StackedFlatAdam(module.replicas, CLIP, spec.weight_decay)
    gens = [torch.Generator(device=DEVICE).manual_seed(epoch_seed(r.seed, 0))
            for r in replicas]
    program = StackedTrainProgram(module, optimizer, spec.window_objective(),
                                  data, batch, gens, graphed=True)
    lk.reset_launch_counts()
    t0 = time.perf_counter()
    program.epoch([r.learning_rate for r in replicas])
    torch.cuda.synchronize()
    stacked_s = time.perf_counter() - t0
    launches = dict(lk.LAUNCHES)
    bitwise = []
    for r, rep in enumerate(replicas):
        solo_module = spec.build_module(
            device=DEVICE, generator=torch.Generator().manual_seed(rep.seed))
        solo_opt = make_optimizer(solo_module, CLIP, spec.weight_decay)
        gen = torch.Generator(device=DEVICE).manual_seed(epoch_seed(rep.seed, 0))
        solo = TrainProgram(solo_module, solo_opt, spec.window_objective(),
                            data, batch, gen, graphed=True)
        solo.epoch(rep.learning_rate)
        bitwise.append(all(torch.equal(getattr(optimizer, k)[r],
                                       getattr(solo_opt, k))
                           for k in ("params", "mu", "nu")))
    return {"replicas": len(replicas), "steps": program.n_steps,
            "rows_per_step": batch * data.x.shape[1],
            "layer_groups": module.replicas[0].layer_groups(
                data.x.shape[2], batch * data.x.shape[1], True,
                data.x.shape[1]),
            "seconds_with_capture": stacked_s,
            "replicas_bit_equal_to_solo": bitwise,
            "launches": {k: v for k, v in launches.items() if v}}


def phase_stacked_groupings(dm, dm_medium, dm_universe, train_medium) -> dict:
    """The groupings beside the pair through the replica axis.
    One layer (train small's data and spec, num_layers=1) and model=medium:
    a graphed StackedTrainer.fit of R = 4, one epoch, its replica-windows/s
    against the solo Trainer.fit of replica 0's seed and rate (one layer:
    one epoch run here; medium: train_medium's run) and replica 0's epoch
    row bit for bit that run's, each replica-axis kernel once a step; a
    graphed stacked step at R = 1 and 8 (wall, idle share, kernels).
    model=large and model=kfactor: a 5-step stacked trajectory of R = 2,
    each replica bit for bit its solo graphed program."""
    out = {"phase": "stacked_groupings", "fits": {}, "trajectories": {}}
    launches: dict[str, int] = {}
    fits = (("single", _train_spec(num_layers=1), dm, None,
             ("lstm_fwd_stacked", "lstm_bwd_stacked", "lstm_wgrad_stacked")),
            ("medium", _medium_spec(), dm_medium, train_medium["fit"],
             ("lstm_stack_fwd_masked_stacked", "lstm_stack_bwd_stacked",
              "lstm_wgrad_stacked")))
    for label, spec, data, solo, counters in fits:
        if solo is None:
            solo = Trainer(max_epochs=1, gradient_clip_val=CLIP, seed=0,
                           device=DEVICE).fit(spec, data)
        trainer = StackedTrainer(max_epochs=1, gradient_clip_val=CLIP,
                                 device=DEVICE)
        lk.reset_launch_counts()
        t0 = time.perf_counter()
        result = trainer.fit(spec, data, _stack_replicas(GROUPING_FIT_R))
        fit_s = time.perf_counter() - t0
        fit_launches = dict(lk.LAUNCHES)
        for k, v in fit_launches.items():
            launches[k] = launches.get(k, 0) + v
        stocks = data.train_arrays().x.shape[1]
        steps = len(data.train_range)
        out["fits"][label] = {
            "replicas": GROUPING_FIT_R, "epochs": 1, "fit_seconds": fit_s,
            "layer_groups": _step_groups(spec, stocks),
            "steps_per_s": result.steps_per_sec,
            "replica_windows_per_s": result.replica_steps_per_sec,
            "solo_windows_per_s": solo.windows_per_sec,
            "replica_windows_per_s_over_solo":
                result.replica_steps_per_sec / solo.windows_per_sec,
            "statuses": [r.status for r in result.replicas],
            "replica0_epoch0_row_bitwise":
                result.replicas[0].history[0] == solo.history[0],
            "steps": {n: _stacked_step_breakdown(data, spec, n)
                      for n in GROUPING_STEP_RS},
            "launches": {k: v for k, v in fit_launches.items() if v},
            "launched_once_a_step": {c: fit_launches[c] == steps
                                     for c in counters},
        }
    for label, spec, data, batch in (
            ("large", _medium_spec(num_layers=8), dm_medium, 1),
            ("kfactor", _kfactor_spec(), dm_universe, U_BATCH)):
        windows = _window_batches(data, 1, batch * GROUPING_TRAJECTORY_STEPS)[0]
        out["trajectories"][label] = _stacked_trajectory(
            spec, device_split(Batch(*windows), DEVICE), batch)
    for t in out["trajectories"].values():
        for k, v in t["launches"].items():
            launches[k] = launches.get(k, 0) + v
    out["launches"] = launches
    emit(out)
    for label, fit in out["fits"].items():
        if (fit["statuses"] != ["active"] * GROUPING_FIT_R
                or not fit["replica0_epoch0_row_bitwise"]
                or not all(fit["launched_once_a_step"].values())):
            raise AssertionError(f"stacked_groupings {label}: {fit}")
    for label, t in out["trajectories"].items():
        if (not all(t["replicas_bit_equal_to_solo"])
                or t["launches"] != _stacked_step_launches(
                    t["layer_groups"], GROUPING_TRAJECTORY_STEPS)):
            raise AssertionError(f"stacked_groupings {label}: {t}")
    return out


# model=small at a one-year lookback through the time-blocked replica axis:
# a 5-step trajectory of R = 2 and a one-epoch fit of R = 4.
STACKED_TB_FIT_R = 4


def phase_stacked_tblocked(dm, train_long: dict) -> dict:
    """model=small (dropout 0.2) at T=252 on 100-row windows, both layers
    alone on the time-blocked route, through its replica axis: a 5-step
    graphed trajectory of R = 2, each replica bit for bit its solo graphed
    program and the replica-axis kernels twice a step (one a layer); a
    graphed StackedTrainer.fit of R = 4 for one epoch, its
    replica-windows/s against train_long's solo Trainer.fit of replica 0's
    seed and rate, replica 0's epoch row bit for bit that run's first, the
    replica-axis kernels twice a step and the solo ones never; a graphed
    step of R = 4 (wall, idle share, kernels)."""
    spec = _train_spec()
    windows = _window_batches(dm, 1, GROUPING_TRAJECTORY_STEPS)[0]
    trajectory = _stacked_trajectory(spec, device_split(Batch(*windows),
                                                        DEVICE), 1)
    solo = train_long["fit"]
    trainer = StackedTrainer(max_epochs=1, gradient_clip_val=CLIP,
                             device=DEVICE)
    lk.reset_launch_counts()
    t0 = time.perf_counter()
    result = trainer.fit(spec, dm, _stack_replicas(STACKED_TB_FIT_R))
    fit_s = time.perf_counter() - t0
    launches = dict(lk.LAUNCHES)
    steps = len(dm.train_range)
    out = {
        "phase": "stacked_tblocked", "T": T_LONG,
        "layer_groups": trajectory["layer_groups"],
        "routes": _routes(spec.build_module(device="cpu"), T_LONG, K_STOCKS,
                          True, K_STOCKS),
        "trajectory": trajectory,
        "fit": {"replicas": STACKED_TB_FIT_R, "epochs": 1, "steps": steps,
                "fit_seconds": fit_s, "steps_per_s": result.steps_per_sec,
                "replica_windows_per_s": result.replica_steps_per_sec,
                "solo_windows_per_s": solo.windows_per_sec,
                "replica_windows_per_s_over_solo":
                    result.replica_steps_per_sec / solo.windows_per_sec,
                "statuses": [r.status for r in result.replicas],
                "replica0_epoch0_row_bitwise":
                    result.replicas[0].history[0] == solo.history[0],
                "step": _stacked_step_breakdown(dm, spec, STACKED_TB_FIT_R)},
        "launches": {k: v for k, v in launches.items() if v},
    }
    out["launches_total"] = {
        k: launches.get(k, 0) + trajectory["launches"].get(k, 0)
        for k in ("lstm_tb_fwd_stacked", "lstm_tb_bwd_stacked")}
    emit(out)
    want = {"lstm_tb_fwd_stacked": 2 * GROUPING_TRAJECTORY_STEPS,
            "lstm_tb_bwd_stacked": 2 * GROUPING_TRAJECTORY_STEPS}
    if (out["layer_groups"] != [1, 1] or trajectory["launches"] != want
            or not all(trajectory["replicas_bit_equal_to_solo"])):
        raise AssertionError(f"stacked_tblocked: the trajectory: {trajectory}")
    fit = out["fit"]
    if (fit["statuses"] != ["active"] * STACKED_TB_FIT_R
            or not fit["replica0_epoch0_row_bitwise"]
            or launches["lstm_tb_bwd_stacked"] != 2 * steps
            or launches["lstm_tb_fwd_stacked"] < 2 * steps
            or launches["lstm_tb_bwd"]):
        raise AssertionError(f"stacked_tblocked: the fit: {fit} {launches}")
    return out


def _stacked_step_launches(groups: list, steps: int) -> dict:
    """The replica-axis launches of ``steps`` stacked training steps whose
    forward runs ``groups`` (model=large: 7 + 1; model=kfactor at 2,048
    rows a window: 1 + 1): a forward, a sweep and a pass a group."""
    want: dict[str, int] = {}
    for depth in groups:
        kind = ("lstm_stack" if depth >= 3 else
                "lstm_pair" if depth == 2 else "lstm")
        masked = "_masked" if depth >= 2 else ""
        for name in (f"{kind}_fwd{masked}_stacked", f"{kind}_bwd_stacked",
                     "lstm_wgrad_stacked"):
            want[name] = want.get(name, 0) + steps
    return want


def _step_groups(spec, stocks: int) -> list:
    """The layer groups a training step of one window of ``stocks`` rows
    runs at ``spec``."""
    return spec.build_module(device="cpu").layer_groups(T, stocks, True, stocks)


def _start_stacked_driver() -> "_Child":
    """``python -m masters_thesis_tpu_torch stacked`` as a child: R = 4 on
    train small's data, 2 epochs, into ``stacked_root()/driver``, started
    now (beside resilience's children) and waited for by
    ``phase_stacked_driver``."""
    ckpt_dir = stacked_root() / "driver"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    replicas = [{"name": r.name, "seed": r.seed, "lr": r.learning_rate}
                for r in _stack_replicas(STACK_DRIVER_R)]
    return _Child("stacked", f"datamodule.data_dir={data_dir(K_STOCKS)}",
                  f"datamodule.n_stocks={K_STOCKS}",
                  f"datamodule.n_samples={TRAIN_SAMPLES}",
                  f"trainer.max_epochs={TRAIN_EPOCHS}",
                  "--replicas", json.dumps(replicas),
                  "--ckpt-dir", str(ckpt_dir), side_by_side=4)


def phase_stacked_driver(child: "_Child") -> dict:
    """The stacked entry point's child: its JSON line (every replica
    active), each replica's manifest-verified ``best`` and ``last``, its
    seconds and launches (the replica-axis kernels once a step)."""
    lines, launches, seconds = _cli_result(child.wait())
    line = json.loads(next(ln for ln in reversed(lines) if ln.startswith("{")))
    ckpt_dir = stacked_root() / "driver"
    files = {f"{r['name']}/{tag}": verify_checkpoint(ckpt_dir / r["name"] / tag,
                                                    require_manifest=True)
             for r in line["replicas"] for tag in ("best", "last")}
    out = {"phase": "stacked_driver", "seconds": seconds, "result": line,
           "checkpoints": files,
           "launches": {k: v for k, v in launches.items() if v}}
    emit(out)
    if [r["status"] for r in line["replicas"]] != ["active"] * STACK_DRIVER_R:
        raise AssertionError(f"stacked_driver: {line}")
    if not all(files.values()) or line["epochs"] != TRAIN_EPOCHS:
        raise AssertionError(f"stacked_driver: checkpoints: {files}")
    if not launches["lstm_pair_fwd_masked_stacked"] or launches["lstm_pair_fwd_masked"]:
        raise AssertionError(f"stacked_driver: off the replica axis: {launches}")
    out["names"] = [r["name"] for r in line["replicas"]]
    return out


class _RecordingStacked(_Recording, StackedPredictEngine):
    pass


# Lanes of the other groupings: (spec, stocks a window, lookback, the
# replica-axis forward a dispatch launches, its launches a dispatch): one
# layer on 100-stock windows, model=medium (one 4-deep stack) on 25-stock
# windows and model=small at a one-year lookback (two time-blocked layers),
# R = 4 lanes of seeded weights.
GROUPING_LANES = {
    "single": (_small_spec(num_layers=1), K_STOCKS, T, "lstm_fwd_stacked", 1),
    "medium": (_medium_spec(dropout=0.0), K_MEDIUM, T,
               "lstm_stack_fwd_stacked", 1),
    "long": (_small_spec(), K_STOCKS, T_LONG, "lstm_tb_fwd_stacked", 2),
}


def _grouping_lanes(windows: dict) -> dict:
    """For each of GROUPING_LANES, a graphed StackedPredictEngine of 4
    lanes and the 4 solo graphed engines: every lane bit for bit its solo
    engine at 1, 3, 8 windows (every bucket, padded), one capture a
    bucket, one replica-axis launch a dispatch; p50 and answers/s of a
    burst beside the solo engine's."""
    out = {}
    for label, (spec, stocks, lookback, counter, per_dispatch) in (
            GROUPING_LANES.items()):
        states = [spec.build_module(
            device="cpu", generator=torch.Generator().manual_seed(s)
        ).state_dict() for s in range(4)]
        kw = dict(n_stocks=stocks, lookback=lookback, device=DEVICE)
        engine = StackedPredictEngine(spec, states, **kw)
        engine.warmup()
        solos = [PredictEngine(spec, state, **kw) for state in states]
        for solo in solos:
            solo.warmup()
        x = windows[label]
        lk.reset_launch_counts()
        bitwise = True
        for n in (1, 3, 8):
            alpha, beta = engine.predict(x[:n])
            for lane, solo in enumerate(solos):
                a, b = solo.predict(x[:n])
                bitwise &= bool(np.array_equal(alpha[:, lane], a)
                                and np.array_equal(beta[:, lane], b))
        launches = dict(lk.LAUNCHES)
        responses, _, stats, serve_s = _burst(engine, x)
        solo_responses, _, _, solo_s = _burst(solos[0], x)
        out[label] = {
            "lanes": engine.num_lanes, "stocks": stocks,
            "lookback": lookback,
            "layer_groups": engine._module.layer_groups(lookback, 8 * stocks,
                                                        False, stocks),
            "captures": engine.compile_events,
            "buckets": len(engine.buckets),
            "lanes_bit_equal_to_solo": bitwise,
            "burst": {**_latency_ms(responses),
                      "lane_answers_per_s": engine.num_lanes * len(responses)
                      / serve_s},
            "solo_burst": {**_latency_ms(solo_responses),
                           "answers_per_s": len(solo_responses) / solo_s},
            "launches": {k: v for k, v in launches.items() if v},
            "counter": counter,
            "per_dispatch": per_dispatch,
        }
    return out


def phase_stacked_serve(driver: dict, windows: np.ndarray,
                        windows_medium: np.ndarray,
                        windows_long: np.ndarray) -> dict:
    """The stacked driver's four ``best``s as four lanes of one
    StackedPredictEngine (``from_checkpoints``), graphed, through
    PredictServer: bursts (p50, p99, answers/s and R x answers/s); each
    lane bit for bit the solo engine on its checkpoint, every bucket and
    padded; one capture a bucket; then ``try_swap_lane`` of lane 3 to lane
    0's checkpoint under SWAP_RATE open-loop load, every dispatched batch's
    other lanes bit for bit the unswapped stack's, no capture, no late
    answer. Then lanes of one layer, of model=medium and of model=small at
    a one-year lookback (``_grouping_lanes``)."""
    root = stacked_root() / "driver"
    ckpts = [root / name for name in driver["names"]]
    kw = dict(n_stocks=K_STOCKS, device=DEVICE)
    t0 = time.perf_counter()
    live = _RecordingStacked.from_checkpoints(ckpts, lanes=driver["names"], **kw)
    live.warmup()
    warm_s = time.perf_counter() - t0
    reference = StackedPredictEngine.from_checkpoints(ckpts, **kw)
    solos = [PredictEngine.from_checkpoint(c, **kw) for c in ckpts]
    lanes_bitwise = True
    for n in (1, 2, 3, 4, 5, 8):
        alpha, beta = live.predict(windows[:n])
        for lane, solo in enumerate(solos):
            a, b = solo.predict(windows[:n])
            lanes_bitwise &= bool(np.array_equal(alpha[:, lane], a)
                                  and np.array_equal(beta[:, lane], b))
    lk.reset_launch_counts()
    responses, _, stats, serve_s = _burst(live, windows)
    burst_launches = dict(lk.LAUNCHES)
    ok = [r for r in responses if r.ok]
    # The lane swap under load.
    server = PredictServer(live, max_wait_s=0.002)
    swapper = CheckpointSwapper(live)
    captures = live.compile_events
    live.dispatched.clear()
    server.start()
    loaded: list = []
    stop = threading.Event()
    feeder = threading.Thread(target=lambda: loaded.append(_paced(
        server, windows, SWAP_RATE, SWAP_DEADLINE_S, lambda _: stop.is_set())))
    feeder.start()
    try:
        time.sleep(0.3)
        verdict = swapper.try_swap_lane(3, ckpts[0], "best")
        time.sleep(0.3)
    finally:
        stop.set()
        feeder.join(timeout=30.0)
    pendings, achieved, _ = loaded[0]
    swap_responses = [p.result(timeout=60.0) for p in pendings]
    swap_stats = server.stop()
    siblings = all(
        np.array_equal(a[:, :3], ra[:, :3]) and np.array_equal(b[:, :3], rb[:, :3])
        for (x, a, b), (ra, rb) in ((d, reference.predict(d[0]))
                                    for d in live.dispatched))
    swapped = live.predict(windows[:2])[0][:, 3]
    out = {
        "phase": "stacked_serve", "lanes": live.num_lanes,
        "buckets": list(live.buckets), "captures": live.compile_events,
        "warmup_s": warm_s,
        "lanes_bit_equal_to_solo": lanes_bitwise,
        "burst": {**_latency_ms(responses), "requests": len(responses),
                  "answers_per_s": len(ok) / serve_s,
                  "lane_answers_per_s": live.num_lanes * len(ok) / serve_s,
                  "stats_lanes": stats["lanes"]},
        "lane_swap": {"reason": verdict.reason,
                      "step_s": dict(swapper.step_seconds),
                      "siblings_bitwise_check": verdict.checks.get("siblings_bitwise"),
                      "requests": len(swap_responses),
                      "achieved_per_s": achieved,
                      "dispatches": len(live.dispatched),
                      "siblings_bit_equal_in_every_dispatch": siblings,
                      "new_captures": live.compile_events - captures,
                      "late_deliveries": swap_stats["late_deliveries"],
                      "late_ok_seen": sum(
                          r.ok and r.delivered_ts > p.request.deadline_ts
                          for p, r in zip(pendings, swap_responses)),
                      "statuses": {st: sum(r.status == st for r in swap_responses)
                                   for st in sorted({r.status for r in swap_responses})},
                      "swapped_lane_is_lane0": bool(np.array_equal(
                          swapped, solos[0].predict(windows[:2])[0]))},
        "launches": {k: v for k, v in burst_launches.items() if v},
        "groupings": _grouping_lanes({"single": windows,
                                      "medium": windows_medium,
                                      "long": windows_long}),
    }
    emit(out)
    for label, lanes in out["groupings"].items():
        if (not lanes["lanes_bit_equal_to_solo"]
                or lanes["captures"] != lanes["buckets"]
                or lanes["launches"].get(lanes["counter"])
                != 3 * lanes["per_dispatch"]):
            raise AssertionError(f"stacked_serve {label} lanes: {lanes}")
    swap = out["lane_swap"]
    if not lanes_bitwise or out["captures"] != len(live.buckets):
        raise AssertionError(f"stacked_serve: lanes or captures: {out}")
    if len(ok) != len(responses) or stats["lanes"] != live.num_lanes:
        raise AssertionError(f"stacked_serve: bursts: {out['burst']}")
    if (swap["reason"] != "committed" or not siblings or swap["new_captures"]
            or swap["late_deliveries"] or swap["late_ok_seen"]
            or not swap["swapped_lane_is_lane0"] or not live.dispatched):
        raise AssertionError(f"stacked_serve: the lane swap: {swap}")
    if not burst_launches["lstm_pair_fwd_stacked"] or burst_launches["lstm_pair_fwd"]:
        raise AssertionError(f"stacked_serve: off the replica axis: "
                             f"{burst_launches}")
    return out


# ------------------------------------------------------------- serving fleet

FLEET_REPLICAS = 3
FLEET_DEADLINE_S = 5.0
FLEET_BURST = 32  # windows a closed-loop burst: four batches of 8
FLEET_BURSTS = 40  # bursts a throughput run (off / on / on / off)
FLEET_LANES = 4  # R of the stacked fleet's replicas
FLEET_TOL = 1e-5  # an ok answer against the solo engine on its window
FLEET_BUDGET_S = 25.0  # the phase's wall, printed against it


class _TimedWarmup:
    """An engine that keeps the wall window of its ``warmup`` (its
    captures) and the error that failed it, if one did, and the programs
    it held when it was closed (``held``)."""

    warm_window: tuple | None = None
    warm_error: str | None = None

    def close(self):
        self.held = dict(self._programs)
        super().close()

    def warmup(self):
        t0 = time.perf_counter()
        try:
            return super().warmup()
        except BaseException as exc:
            self.warm_error = f"{type(exc).__name__}: {exc}"
            raise
        finally:
            self.warm_window = (t0, time.perf_counter())


class _FleetEngine(_TimedWarmup, PredictEngine):
    pass


class _FleetStacked(_TimedWarmup, StackedPredictEngine):
    pass


def _fleet_bursts(front, windows: np.ndarray, bursts: int,
                  first: int = 0) -> tuple[list, float, int]:
    """Closed loop through a server or fleet: ``bursts`` bursts of
    FLEET_BURST windows, each submitted at once and awaited. Returns
    ``(window index, response)`` pairs, the seconds and the requests that
    did not resolve within 60 s."""
    pairs, unresolved = [], 0
    t0 = time.perf_counter()
    for b in range(first, first + bursts):
        idx = [(b * FLEET_BURST + i) % len(windows) for i in range(FLEET_BURST)]
        pending = [(i, front.submit(windows[i], deadline_s=FLEET_DEADLINE_S))
                   for i in idx]
        for i, p in pending:
            try:
                pairs.append((i, p.result(timeout=60.0)))
            except TimeoutError:
                unresolved += 1
    return pairs, time.perf_counter() - t0, unresolved


def _kill(fleet, names: tuple, windows: np.ndarray, first: int) -> dict:
    """``serve.replica_dispatch`` ``raise`` on each of ``names`` at its next
    dispatch, under one closed-loop burst: the plan is cleared as soon as
    each has died once (so that the restarts serve), then the burst's
    answers and the deaths."""
    deaths = fleet.deaths
    _even_forecasts(fleet)
    plan = faults.FaultPlan(faults=[faults.FaultSpec(
        point="serve.replica_dispatch", kind="raise", attempt=None,
        match={"replica": name}) for name in names])
    faults.install_plan(plan)
    stop = threading.Event()

    def clear() -> None:
        while not stop.is_set() and fleet.deaths < deaths + len(names):
            time.sleep(0.0005)
        faults.clear_plan()

    watcher = threading.Thread(target=clear, name="fleet-kill-watch")
    watcher.start()
    try:
        pairs, seconds, unresolved = _fleet_bursts(fleet, windows, 1, first)
    finally:
        stop.set()
        watcher.join()
        faults.clear_plan()
    return {"pairs": pairs, "seconds": seconds, "unresolved": unresolved,
            "deaths": fleet.deaths - deaths}


def _even_forecasts(fleet) -> None:
    """Seed every replica's service-time forecast with the fastest one, so
    that least-loaded dispatch breaks its ties in name order. Each forecast
    starts from one timed warm-up batch: a slow one would keep a replica
    idle (never the victim of a planted crash, never serving after its
    restart) through a whole burst."""
    forecast_s = min(r.service_model.batch_s for r in fleet.replicas.values())
    for replica in fleet.replicas.values():
        replica.service_model.seed(forecast_s)


def _wait_generation(fleet, want: dict, timeout_s: float = 60.0) -> bool:
    """Wait for each replica of ``want`` to be live at its generation, then
    even the forecasts (``_even_forecasts``)."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if all(fleet.replicas[n].generation >= g
               and fleet.replicas[n].state == "live" for n, g in want.items()):
            _even_forecasts(fleet)
            return True
        time.sleep(0.005)
    return False


def _graph_launches(engines: list) -> dict:
    """The kernel launches the engines' graphs made: each graph's warm-up
    run and replays times its own launches, each graph once (a warm
    restart replays the graphs its closed predecessor captured)."""
    graphs = {}
    for engine in engines:
        for program in [*engine._programs.values(),
                        *getattr(engine, "held", {}).values()]:
            graphs[id(program.run)] = program.run
    out: dict = {}
    for run in graphs.values():
        for name, k in run.launches.items():
            out[name] = out.get(name, 0) + (run.captures + run.replays) * k
    return out


def _answer_errors(pairs: list, reference: tuple) -> dict:
    """Each ok answer against the reference's answer for its window: the
    worst abs error, and the statuses."""
    worst, statuses = 0.0, {}
    for i, r in pairs:
        statuses[r.status] = statuses.get(r.status, 0) + 1
        if r.ok:
            for got, want in zip(r.outputs, reference):
                worst = max(worst, float(np.abs(got - want[i]).max()))
    return {"statuses": statuses, "max_abs_err": worst}


def _reference(engine, windows: np.ndarray) -> tuple:
    """An engine's answers on every window, in batches of its largest
    bucket."""
    outs = [engine.predict(windows[i:i + engine.max_bucket])
            for i in range(0, len(windows), engine.max_bucket)]
    return tuple(np.concatenate([o[j] for o in outs]) for j in range(2))


def _fleet_throughput(engine_factory, windows: np.ndarray) -> dict:
    """Answers/s, p50 and p99 of one PredictServer and of a fleet of
    FLEET_REPLICAS replicas under the same closed-loop bursts, in turns:
    off / on / on / off."""
    from masters_thesis_tpu_torch.serve.fleet import FleetServer

    server = PredictServer(engine_factory(), max_wait_s=0.002)
    fleet = FleetServer({f"r{i}": engine_factory
                         for i in range(FLEET_REPLICAS)}, max_wait_s=0.002)
    server.start()
    fleet.start()
    runs = []
    try:
        for label, front in (("off", server), ("on", fleet), ("on", fleet),
                             ("off", server)):
            pairs, seconds, unresolved = _fleet_bursts(front, windows,
                                                       FLEET_BURSTS)
            responses = [r for _, r in pairs]
            runs.append({"fleet": label, "seconds": seconds,
                         "answers_per_s": sum(r.ok for r in responses) / seconds,
                         "unresolved": unresolved, **_latency_ms(responses)})
    finally:
        solo_stats = server.stop()
        fleet_stats = fleet.stop()
    return {"runs": runs,
            "late_deliveries": {"off": solo_stats["late_deliveries"],
                                "on": fleet_stats["late_deliveries"]}}


def phase_serve_fleet(windows: np.ndarray) -> dict:
    """The serving fleet on the card: model=small at full width, buckets
    1-8, a 5 s deadline. Three replicas share the card (each factory names
    it) behind one FleetServer, under closed-loop bursts:

    - ``r0`` is crashed by an injected ``serve.replica_dispatch`` raise;
      its batch is re-dispatched, its engine is closed into the factories'
      shared ``ProgramCache``, and it comes back at generation 2 on the card
      warm (no capture, one hit a bucket; ``boot_s`` beside generation 1's
      cold boot: the time to recover a replica) and serves;
    - ``r0`` and ``r1`` are crashed together, so that their two restarts
      boot at once while ``r2`` serves (from factories without the cache
      now, so that they capture: their captures take turns with
      each other and with ``r2``'s replays, ``utils/cuda_graph.py``): no
      capture fails (no boot failure, each generation the expected one),
      the boots overlap, the collector is on at the end, and the launches
      counted over the phase are exactly each graph's warm-up run and
      replays times its own launches;
    - every request resolves explicitly, no ok answer is late, and every ok
      answer is within FLEET_TOL of a solo engine's on its window;
    - two replicas of R = 4 lanes (StackedPredictEngine), one crashed, the
      same way, the lanes held against a solo stacked engine;
    - printed, not claimed: answers/s, p50 and p99 of the fleet against
      one PredictServer, off / on / on / off, and the phase's seconds
      against FLEET_BUDGET_S."""
    from masters_thesis_tpu_torch.resilience.supervisor import (
        ReplicaRestartPolicy,
    )
    from masters_thesis_tpu_torch.serve.fleet import FleetServer

    t0 = time.perf_counter()
    spec = _small_spec()
    state = spec.build_module(
        device="cpu", generator=torch.Generator().manual_seed(0)).state_dict()
    kw = dict(n_stocks=K_STOCKS, lookback=T, n_features=3,
              buckets=(1, 2, 4, 8), device=DEVICE)
    from masters_thesis_tpu_torch.serve.program_cache import ProgramCache

    reference = _reference(PredictEngine(spec, state, **kw), windows)
    built: list = []
    cache = ProgramCache()
    warm_restarts = [True]

    def factory():
        engine = _FleetEngine(spec, state, **kw, program_cache=(
            cache if warm_restarts[0] else None))
        built.append(engine)
        return engine

    names = [f"r{i}" for i in range(FLEET_REPLICAS)]
    # A backoff that does not grow, so that r0's second restart and r1's
    # first start together (the default doubles r0's to 0.1 s, and the two
    # boots of 40-100 ms did not overlap on the card).
    fleet = FleetServer({n: factory for n in names}, max_wait_s=0.002,
                        restart_policy=ReplicaRestartPolicy(
                            backoff_factor=1.0))
    lk.reset_launch_counts()
    fleet.start()
    r0_gen1_boot_s = fleet.replicas["r0"].boot_s
    pairs: list = []
    try:
        warm, _, unresolved = _fleet_bursts(fleet, windows, 2)
        pairs += warm
        one = _kill(fleet, ("r0",), windows, 2)
        pairs += one["pairs"]
        unresolved += one["unresolved"]
        back = _wait_generation(fleet, {"r0": 2})
        served_before = fleet.replicas["r0"].completed
        more, _, lost = _fleet_bursts(fleet, windows, 3, 3)
        pairs += more
        unresolved += lost
        r0_gen2 = {"boot_s": fleet.replicas["r0"].boot_s,
                   "gen1_cold_boot_s": r0_gen1_boot_s,
                   "generation": fleet.replicas["r0"].generation,
                   "served": fleet.replicas["r0"].completed - served_before,
                   "platform": fleet.replicas["r0"].engine.platform,
                   "device": str(fleet.replicas["r0"].engine.device),
                   "cache_hits": fleet.replicas["r0"].engine.cache_hits,
                   "captures": fleet.replicas["r0"].engine.compile_events}
        warm_restarts[0] = False
        two = _kill(fleet, ("r0", "r1"), windows, 6)
        pairs += two["pairs"]
        unresolved += two["unresolved"]
        # r2 serves while the two restarts capture.
        during, _, lost = _fleet_bursts(fleet, windows, 2, 7)
        pairs += during
        unresolved += lost
        back_two = _wait_generation(fleet, {"r0": 3, "r1": 2})
        after, _, lost = _fleet_bursts(fleet, windows, 2, 9)
        pairs += after
        unresolved += lost
    finally:
        stats = fleet.stop()
    launches = {k: v for k, v in lk.LAUNCHES.items() if v}
    want_launches = _graph_launches(built)
    cache_stats = cache.stats()
    cache.close()
    boots = [e.warm_window for e in built[-2:]]
    overlap_s = (min(b[1] for b in boots) - max(b[0] for b in boots)
                 if all(boots) else None)
    answers = _answer_errors(pairs, reference)
    kills = {
        "replicas": {n: {k: r[k] for k in ("state", "generation", "restarts",
                                           "completed", "dispatches",
                                           "boot_s")}
                     for n, r in stats["replicas"].items()},
        "one": {"deaths": one["deaths"], "r0_back": back, "r0_gen2": r0_gen2},
        "two": {"deaths": two["deaths"], "back": back_two,
                "boot_overlap_s": overlap_s,
                "boot_s": {n: fleet.replicas[n].boot_s for n in ("r0", "r1")}},
        "boot_errors": [e.warm_error for e in built if e.warm_error],
        "engines_built": len(built),
        "requests": stats["requests"], "unresolved": unresolved,
        "redispatched": stats["redispatched"], "deaths": stats["deaths"],
        "late_deliveries": stats["late_deliveries"],
        "late_converted": stats["late_converted"],
        "handback_max_ms": stats["handback_max_ms"],
        "answers": answers, "collector_on": gc.isenabled(),
        "launches": launches, "want_launches": want_launches,
        "cache": cache_stats,
    }
    stacked = _stacked_fleet(spec, windows)
    throughput = _fleet_throughput(lambda: PredictEngine(spec, state, **kw),
                                   windows)
    seconds = time.perf_counter() - t0
    out = {"phase": "serve_fleet", **kills, "stacked": stacked,
           "throughput": throughput, "seconds": seconds,
           "budget_s": FLEET_BUDGET_S, "card": _card()}
    emit(out)
    failed = []
    if (unresolved or stats["late_deliveries"] or one["deaths"] != 1
            or two["deaths"] != 2 or not back or not back_two):
        failed.append("deaths, restarts or resolution")
    if (r0_gen2["generation"] != 2 or not r0_gen2["served"]
            or r0_gen2["platform"] != "gpu"):
        failed.append("r0 at generation 2 on the card")
    if (r0_gen2["cache_hits"], r0_gen2["captures"]) != (4, 0):
        failed.append("r0's restart did not boot warm from the cache")
    if kills["boot_errors"] or len(built) != FLEET_REPLICAS + 3:
        failed.append("a boot failed (a capture error)")
    if not (overlap_s or 0) > 0:
        failed.append("the two restarts did not boot at once")
    if not kills["collector_on"]:
        failed.append("the collector is off")
    if launches != want_launches or not launches.get("lstm_pair_fwd"):
        failed.append("launch counts")
    if set(answers["statuses"]) - {"ok", "shed", "rejected_late"} or \
            answers["max_abs_err"] > FLEET_TOL or not answers["statuses"].get("ok"):
        failed.append("answers")
    if stacked["failed"]:
        failed.append(f"stacked fleet: {stacked['failed']}")
    if (any(r["unresolved"] for r in throughput["runs"])
            or any(throughput["late_deliveries"].values())):
        failed.append("throughput runs: unresolved or late answers")
    if failed:
        raise AssertionError(f"serve_fleet: {failed}")
    return out


def _stacked_fleet(spec, windows: np.ndarray) -> dict:
    """Two replicas of R = FLEET_LANES lanes, ``r0`` crashed under bursts;
    each ok ``(R, K)`` answer against a solo stacked engine's."""
    from masters_thesis_tpu_torch.resilience.supervisor import (
        ReplicaRestartPolicy,
    )
    from masters_thesis_tpu_torch.serve.fleet import FleetServer

    states = [spec.build_module(
        device="cpu", generator=torch.Generator().manual_seed(seed)
    ).state_dict() for seed in range(FLEET_LANES)]
    kw = dict(n_stocks=K_STOCKS, lookback=T, n_features=3,
              buckets=(1, 2, 4, 8), device=DEVICE)
    reference = _reference(StackedPredictEngine(spec, states, **kw), windows)
    built: list = []

    def factory():
        engine = _FleetStacked(spec, states, **kw)
        built.append(engine)
        return engine

    fleet = FleetServer({"r0": factory, "r1": factory}, max_wait_s=0.002,
                        restart_policy=ReplicaRestartPolicy())
    lk.reset_launch_counts()
    fleet.start()
    try:
        pairs, _, unresolved = _fleet_bursts(fleet, windows, 1)
        kill = _kill(fleet, ("r0",), windows, 1)
        back = _wait_generation(fleet, {"r0": 2})
        more, _, lost = _fleet_bursts(fleet, windows, 2, 2)
    finally:
        stats = fleet.stop()
    pairs += kill["pairs"] + more
    unresolved += kill["unresolved"] + lost
    launches = {k: v for k, v in lk.LAUNCHES.items() if v}
    want_launches = _graph_launches(built)
    answers = _answer_errors(pairs, reference)
    shapes = sorted({tuple(r.outputs[0].shape) for _, r in pairs if r.ok})
    failed = []
    if unresolved or stats["late_deliveries"] or kill["deaths"] != 1 \
            or not back:
        failed.append("deaths, restarts or resolution")
    if shapes != [(FLEET_LANES, K_STOCKS)] or stats["lanes"] != FLEET_LANES:
        failed.append(f"answers of shape {shapes}")
    if answers["max_abs_err"] > FLEET_TOL:
        failed.append("lanes off the solo stacked engine")
    if launches != want_launches or not launches.get("lstm_pair_fwd_stacked"):
        failed.append("launch counts")
    if [e.warm_error for e in built if e.warm_error]:
        failed.append("a boot failed")
    return {"lanes": stats["lanes"], "answers": answers, "shapes": shapes,
            "deaths": stats["deaths"], "redispatched": stats["redispatched"],
            "late_deliveries": stats["late_deliveries"],
            "unresolved": unresolved, "r0_back": back,
            "boot_s": stats["replicas"]["r0"]["boot_s"],
            "launches": launches, "want_launches": want_launches,
            "failed": failed}


# The doctored third round: these metrics move past the gate, in their bad
# direction (the throughput-like ones x0.6, restart time x1.6).
LEDGER_DOCTORED = {"steps_per_sec": 0.6, "utilization_pct": 0.6,
                   "knee_qps": 0.6, "restart_s": 1.6}


def _ledger_rows(round_id: str, device: dict, train: dict, knee: dict,
                 fleet: dict) -> list[dict]:
    """One ledger round of this run's own numbers, its points named as the
    JAX package's ``bench.py`` names them: ``mse/bs=1`` (``train``'s graphed
    ``Trainer.fit`` at model=small, its counted cost a step and its share
    of the card's peak), ``serve/knee_qps`` (``serve_knee``) and
    ``serve/restart_s`` (``serve_fleet``'s ``r0``: the warm generation-2
    boot, beside its cold generation 1)."""
    _, power = device["nvidia_smi"].rsplit(",", 1)
    common = dict(round_id=round_id, platform="gpu", mesh_shape=[1],
                  pack_width=None, objective="mse", rev=ledger.git_rev(),
                  device_kind=device["kind"],
                  power_limit_w=float(power.split()[0]))
    step = costs.cost_of_step(_train_spec(), K_STOCKS, T, window_rows=K_STOCKS)
    util = costs.utilization(step["flops"], step["bytes"], train["steps_per_s"],
                             "gpu", device=device["kind"])
    r0 = fleet["one"]["r0_gen2"]
    return [
        ledger.ledger_record(
            point="mse/bs=1", batch_size=1, steps_per_sec=train["steps_per_s"],
            flops_per_step=step["flops"], bytes_per_step=step["bytes"],
            peak_memory_bytes=train["peak_memory_bytes"],
            utilization_pct=util["flops_utilization_pct"],
            regime=util["regime"], **common),
        ledger.ledger_record(
            point="serve/knee_qps", steps_per_sec=None,
            knee_qps=knee["knee_offered_per_s"],
            p99_at_knee_ms=knee["knee"]["p99_ms"],
            shed_pct_at_knee=knee["knee"]["shed_pct"], **common),
        ledger.ledger_record(
            point="serve/restart_s", steps_per_sec=None,
            restart_s=r0["boot_s"], restart_cold_s=r0["gen1_cold_boot_s"],
            warm_compiles=r0["captures"], warm_cache_hits=r0["cache_hits"],
            **common),
    ]


def _ledger_cli(root: Path, *args: str) -> tuple[int, dict | None]:
    """``python -m masters_thesis_tpu_torch.telemetry ledger *args`` as a
    child in which torch, numpy and JAX cannot be imported: its exit code
    and its JSON report (None without ``--json``)."""
    poison = root / "poison"
    poison.mkdir(exist_ok=True)
    for name in ("torch", "numpy", "jax", "masters_thesis_tpu"):
        (poison / f"{name}.py").write_text(
            f"raise ImportError('the ledger CLI imported {name}')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(poison), str(Path(__file__).resolve().parent)]))
    proc = subprocess.run(
        [sys.executable, "-m", "masters_thesis_tpu_torch.telemetry", "ledger",
         *args], cwd=root, env=env, capture_output=True, text=True, timeout=60)
    if proc.returncode not in (0, 2):
        raise AssertionError(f"ledger {args}: rc {proc.returncode}: "
                             f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    return proc.returncode, (json.loads(proc.stdout) if "--json" in args
                             else None)


def phase_ledger(device: dict, train: dict, knee: dict, fleet: dict) -> dict:
    """One ledger round of the card's own numbers (``_ledger_rows``),
    written to a ledger in a temporary directory and gated by the port's
    ``telemetry ledger`` as a child without torch or JAX: the first round
    is 3 new configs (rc 0); a second with the same values compares all 3
    and regresses none (rc 0); a third with steps/s, utilization and the
    knee at 0.6x and restart time at 1.6x regresses exactly those four
    metrics (rc 2). ``--selfcheck`` exits 0, and ``knee_from_ledger`` reads
    ``serve_knee``'s knee back. Any failure raises, an I/O error too."""
    t0 = time.perf_counter()
    base = os.environ.get("MTT_BENCH_ROUND") or time.strftime("%Y%m%dT%H%M%S")
    rounds = [base, f"{base}.repeat", f"{base}.doctored"]
    rows = _ledger_rows(rounds[0], device, train, knee, fleet)
    reports, knees = [], []
    with tempfile.TemporaryDirectory(prefix="ledger_") as tmp:
        root = Path(tmp)
        path = root / ledger.DEFAULT_LEDGER_PATH.name
        for round_id in rounds:
            for row in rows:
                rec = {**row, "round": round_id, "ts": time.time()}
                if round_id == rounds[-1]:
                    for metric, factor in LEDGER_DOCTORED.items():
                        if rec.get(metric) is not None:
                            rec[metric] *= factor
                ledger.append_record(path, rec)
            reports.append(_ledger_cli(root, str(path), "--json"))
            knees.append(knee_from_ledger(path))
        selfcheck, _ = _ledger_cli(root, "--selfcheck")
        written = ledger.read_ledger(path)
    (rc1, first), (rc2, repeat), (rc3, doctored) = reports
    regressed = sorted({m for r in doctored["regressions"]
                        for m in r["regressed_metrics"]})
    out = {
        "phase": "ledger", "rounds": rounds, "rows": rows,
        "rows_written": len(written),
        "rc": {"first": rc1, "repeat": rc2, "doctored": rc3,
               "selfcheck": selfcheck},
        "new_configs": [len(r["new_configs"]) for _, r in reports],
        "compared": [len(r["compared"]) for _, r in reports],
        "regressed_metrics": regressed,
        "knee_from_ledger": knees,
        "knee_offered_per_s": knee["knee_offered_per_s"],
        "seconds": time.perf_counter() - t0,
    }
    emit(out)
    failed = []
    if len(written) != 3 * len(rows):
        failed.append(f"{len(written)} rows read back")
    if (rc1, len(first["new_configs"]), len(first["compared"])) != (0, 3, 0):
        failed.append("first round: not 3 new configs with rc 0")
    if (rc2, len(repeat["compared"]), repeat["regressions"]) != (0, 3, []):
        failed.append("repeated round: not 3 compared, none regressed, rc 0")
    if rc3 != 2 or regressed != sorted(LEDGER_DOCTORED):
        failed.append(f"doctored round: rc {rc3}, regressed {regressed}")
    if selfcheck != 0:
        failed.append("--selfcheck")
    if knees[:2] != [knee["knee_offered_per_s"]] * 2:
        failed.append(f"knee_from_ledger {knees[:2]}")
    if failed:
        raise AssertionError(f"ledger: {failed}")
    return out


CACHE_BUCKETS = (1, 2, 4, 8)  # the default ladder
PROBE_TIMEOUT_S = 120.0


def _cache_engine(spec, state, cache):
    return PredictEngine(spec, state, n_stocks=K_STOCKS, lookback=T,
                         n_features=3, buckets=CACHE_BUCKETS, device=DEVICE,
                         program_cache=cache)


def _booted(engine, seconds: float) -> dict:
    return {"seconds": seconds, "bucket_s": dict(engine.boot_s),
            "captures": engine.compile_events,
            "programs_made": engine.programs_made,
            "cache_hits": engine.cache_hits}


def phase_serve_cache(windows: np.ndarray) -> dict:
    """The program cache and the probe at model=small on the default
    ladder, on the card:

    - a cold engine boots (4 captures, its seconds a bucket), answers and
      closes into a ``ProgramCache``; a warm engine boots from it: 0
      captures, 4 hits, its seconds a bucket, its answers the cold
      engine's bit for bit;
    - a third engine boots with one ``cache.load`` corruption planted on
      bucket 8's entry: refused (``golden_mismatch``), that bucket
      captured afresh, the other three hit, the answers unchanged;
    - the real probe (``probe_cuda_backend``, a child on the card) answers
      in one attempt (its seconds);
    - a server on that engine with a ``BackendHealth``: two wedged
      dispatches trip its breaker, the probe's wedge is planted, and the
      device is declared lost (one ``degradation``, ``fallback: null``,
      ``device_lost``), no engine built and the server's engine still on
      the card; the next dispatch serves and clears the state.
    The launch counts are reset before and read after."""
    from masters_thesis_tpu_torch.serve.program_cache import ProgramCache
    from masters_thesis_tpu_torch.utils.backend_probe import (
        BackendHealth,
        probe_cuda_backend,
    )

    spec = _small_spec()
    state = spec.build_module(
        device="cpu", generator=torch.Generator().manual_seed(0)).state_dict()
    x = windows[:5]
    cache = ProgramCache()
    lk.reset_launch_counts()
    t0 = time.perf_counter()
    cold = _cache_engine(spec, state, cache)
    cold.warmup()
    cold_boot = _booted(cold, time.perf_counter() - t0)
    want = cold.predict(x)
    cold.close()
    t0 = time.perf_counter()
    warm = _cache_engine(spec, state, cache)
    warm.warmup()
    warm_boot = _booted(warm, time.perf_counter() - t0)
    got = warm.predict(x)
    bitwise = all(np.array_equal(g, w) for g, w in zip(got, want))
    key8 = warm._cache_key(8)
    warm.close()
    plan = {"seed": 0, "faults": [{"point": "cache.load", "kind": "corrupt",
                                   "attempt": None, "match": {"key": key8}}]}
    with _fault_plan(plan):
        t0 = time.perf_counter()
        planted = _cache_engine(spec, state, cache)
        planted.warmup()
        planted_boot = _booted(planted, time.perf_counter() - t0)
    planted_bitwise = all(np.array_equal(g, w)
                          for g, w in zip(planted.predict(x), want))
    rejections = [(e["reason"], e["key"] == key8) for e in cache.events
                  if e["kind"] == "cache_rejected"]

    t0 = time.perf_counter()
    probe = probe_cuda_backend(timeout_s=PROBE_TIMEOUT_S)
    probe_s = time.perf_counter() - t0
    built = []
    init = PredictEngine.__init__

    def counting_init(self, *a, **kw):
        built.append(kw.get("device"))
        init(self, *a, **kw)

    with tempfile.TemporaryDirectory() as tmp:
        tel = TelemetryRun(tmp, run_id="serve-cache-probe")
        health = BackendHealth(Path(tmp) / "probe_cache.json", timeout_s=60.0)
        server = PredictServer(planted, telemetry=tel, health=health,
                               breaker_threshold=2, max_wait_s=0.002)
        server.start()
        lost_plan = {"seed": 0, "faults": [
            {"point": "serve.dispatch", "kind": "wedge", "attempt": None,
             "match": {"seq": seq}} for seq in (0, 1)] + [
            {"point": "probe.attempt", "kind": "wedge", "attempt": None}]}
        PredictEngine.__init__ = counting_init
        try:
            with _fault_plan(lost_plan):
                failed = [server.submit(w, deadline_s=5.0).result(timeout=30.0)
                          .status for w in windows[:2]]
                deadline = time.monotonic() + 30.0
                while (server.stats()["state"] != "device_lost"
                       and time.monotonic() < deadline):
                    time.sleep(0.005)
                lost = server.stats()["state"]
            after = server.submit(windows[2], deadline_s=5.0).result(
                timeout=30.0)
        finally:
            PredictEngine.__init__ = init
            stats = server.stop()
            tel.close()
        events = read_events(Path(tmp) / "events.jsonl")
    launches = dict(lk.LAUNCHES)
    degradations = [{k: e.get(k) for k in ("scope", "fallback",
                                           "probe_attempts", "platform")}
                    for e in events if e["kind"] == "degradation"]
    device_lost = {
        "failed": failed, "state_after_trip": lost,
        "degradations": degradations, "after": after.status,
        "state_after": stats["state"], "engines_built": len(built),
        "engine_device": str(server.engine.device),
        "same_engine": server.engine is planted,
    }
    out = {"phase": "serve_cache", "buckets": list(CACHE_BUCKETS),
           "cold": cold_boot, "warm": warm_boot,
           "warm_bitwise": bitwise, "planted": planted_boot,
           "planted_rejections": rejections,
           "planted_bitwise": planted_bitwise, "cache": cache.stats(),
           "probe": {"ok": probe.ok, "attempts": probe.attempts,
                     "seconds": probe_s, "detail": probe.detail[-300:]},
           "device_lost": device_lost, "launches": launches,
           "card": _card()}
    emit(out)
    cache.close()
    failed_checks = []
    if (cold_boot["captures"], cold_boot["cache_hits"]) != (4, 0):
        failed_checks.append("cold boot")
    if (warm_boot["captures"], warm_boot["programs_made"],
            warm_boot["cache_hits"]) != (0, 0, 4) or not bitwise:
        failed_checks.append("warm boot")
    if (rejections != [("golden_mismatch", True)]
            or (planted_boot["captures"], planted_boot["cache_hits"]) != (1, 3)
            or not planted_bitwise):
        failed_checks.append("planted corruption")
    if not (probe.ok and probe.attempts == 1):
        failed_checks.append("probe")
    if (failed != ["error", "error"] or lost != "device_lost"
            or degradations != [{"scope": "serve", "fallback": None,
                                 "probe_attempts": 1, "platform": "gpu"}]
            or built or not device_lost["same_engine"]
            or not device_lost["engine_device"].startswith("cuda")
            or after.status != "ok" or stats["state"] != "serving"):
        failed_checks.append("device lost")
    if not launches.get("lstm_pair_fwd"):
        failed_checks.append("launch counts")
    if failed_checks:
        raise AssertionError(f"serve_cache: {failed_checks}")
    return out


def phase_ab(label: str) -> None:
    """The pair, single-layer, time-blocked and stack kernels of whatever
    checkout this copy of the script sits in, for comparing two checkouts
    on one card: each call's device time (``spin_ms``) and a sha256 digest
    of its outputs, at 100 and 800 rows, on the training inputs (T=60) and,
    for the time-blocked forward and backward and the resident forward
    beside them, on ``_long_inputs`` (T=252), and the time-blocked replica
    axis at R = 8 (``_stacked_tb_inputs``; in a checkout that has it); the
    4-deep stack's
    forward (maskless, and masked with its stashes), sweep and
    weight-gradient pass at 25 and 200 rows on ``_stack_inputs``, and the
    8-deep masked forward at 25 rows; the stack's f32 instances (and, in a
    checkout that has them, its bf16 instances) at ``BF16_STACK_SHAPES``.
    Copy the script into each checkout's root and run ``python3
    chip_smoke.py --ab <label>`` there in turns (parent, change, change,
    parent) in one call: equal digests mean bit-equal outputs."""
    for rows in (100, 800):
        v = _training_inputs(rows)
        pair = (v["x"], v["w1"], v["wi2"], v["b2"], v["w2"])
        bwd = (v["dh"], v["x"], v["mask"], v["h1s"], v["c1s"], v["h2s"],
               v["c2s"], v["w1"], v["wi2"], v["b2"], v["w2"])
        calls = {
            "lstm_pair_fwd": lambda: lk.lstm_pair_fwd_cuda(*pair),
            "lstm_pair_fwd_masked": lambda: lk.lstm_pair_fwd_cuda(
                *pair, v["mask"], stash=True),
            "lstm_fwd": lambda: lk.lstm_fwd_cuda(v["x"], v["w1"], return_c=True),
            "lstm_pair_bwd": lambda: lk.lstm_pair_bwd_cuda(*bwd),
            "lstm_bwd": lambda: lk.lstm_bwd_cuda(v["dh"], v["x"], v["hs"],
                                                 v["cs"], v["w1"]),
            "lstm_wgrad": lambda: lk.lstm_pair_wgrad(
                v["dx1"], v["d_pre2"], v["h1s"], v["h2s"], v["mask"]),
            "lstm_wgrad_single": lambda: lk.lstm_single_wgrad(v["dx"], v["hs"]),
        }
        long = _long_inputs(rows, seed=rows)
        calls["lstm_tb_fwd"] = lambda: lk.lstm_tb_fwd_cuda(
            long["x"], long["w"], return_c=True)
        calls["lstm_tb_bwd"] = lambda: lk.lstm_tb_bwd_cuda(
            long["dh"], long["x"], long["hs"], long["cs"], long["w"])
        calls["lstm_fwd_long"] = lambda: lk.lstm_fwd_cuda(
            long["x"], long["w"], return_c=True)
        sp = _stacked_kernel_inputs(rows)
        s_pair = (sp["x"], sp["w1"], sp["wi2"], sp["b2"], sp["w2"])
        calls["lstm_pair_fwd_masked_stacked"] = lambda: lk.lstm_pair_fwd_stacked_cuda(
            *s_pair, sp["mask"], stash=True)
        calls["lstm_pair_bwd_stacked"] = lambda: lk.lstm_pair_bwd_stacked_cuda(
            sp["dh"], sp["x"], sp["mask"], sp["h1s"], sp["c1s"], sp["h2s"],
            sp["c2s"], *s_pair[1:])
        calls["lstm_wgrad_stacked"] = lambda: lk.lstm_pair_wgrad_stacked(
            sp["dx1"], sp["d_pre2"], sp["h1s"], sp["h2s"], sp["mask"])
        if hasattr(lk, "lstm_pair_bwd_bf16_cuda"):  # not in a parent before it
            b = _bf16_inputs(v)
            b_pair = (b["x"], b["w1"], b["wi2"], b["b2"], b["w2"])
            calls["lstm_pair_fwd_bf16"] = lambda: lk.lstm_pair_fwd_cuda(*b_pair)
            calls["lstm_pair_fwd_masked_bf16"] = lambda: lk.lstm_pair_fwd_cuda(
                *b_pair, b["mask"], stash=True)
            calls["lstm_pair_bwd_bf16"] = lambda: lk.lstm_pair_bwd_bf16_cuda(
                *_bf16_bwd_args(b))
            calls["lstm_wgrad_bf16"] = lambda: lk.lstm_pair_wgrad(
                b["d_pre1"], b["d_pre2"], b["h1s"], b["h2s"], b["mask"])
        if hasattr(lk, "lstm_tb_fwd_stacked_cuda"):  # not in a parent before it
            sv = _stacked_tb_inputs(rows)
            calls["lstm_tb_fwd_stacked"] = lambda: lk.lstm_tb_fwd_stacked_cuda(
                sv["x"], sv["w"], return_c=True)
            calls["lstm_tb_bwd_stacked"] = lambda: lk.lstm_tb_bwd_stacked_cuda(
                sv["dh"], sv["x"], sv["hs"], sv["cs"], sv["w"])
        _ab_rows(label, rows, calls)
    for rows in (K_MEDIUM, 8 * K_MEDIUM):
        v = _stack_inputs(STACK_LAYERS, rows, seed=rows)
        weights = (v["w_hh"], v["w_in"], v["biases"])
        _ab_rows(label, rows, {
            "lstm_stack_fwd": lambda: lk.lstm_stack_fwd_cuda(v["x"], *weights),
            "lstm_stack_fwd_masked": lambda: lk.lstm_stack_fwd_cuda(
                v["x"], *weights, v["masks"], stash=True),
            "lstm_stack_bwd": lambda: lk.lstm_stack_bwd_cuda(
                v["dh"], v["x"], v["masks"], v["hs"], v["cs"], *weights),
            "lstm_wgrad_stack": lambda: lk.lstm_stack_wgrad(
                v["d_pres"], v["hs"], v["masks"]),
        })
    deep = _stack_inputs(8, K_MEDIUM, seed=108)
    _ab_rows(label, K_MEDIUM, {
        "lstm_stack_fwd_masked_8": lambda: lk.lstm_stack_fwd_cuda(
            deep["x"], deep["w_hh"], deep["w_in"], deep["biases"],
            deep["masks"], stash=True),
    })
    # The stack at the shapes a bf16 fit runs it (BF16_STACK_SHAPES): its
    # f32 instances on the bf16 inputs' values, and (in a checkout that has
    # them) its bf16 instances.
    bf16 = hasattr(lk, "lstm_stack_bwd_bf16_cuda")  # not in a parent before it
    for n, rows, training in BF16_STACK_SHAPES:
        v = _bf16_stack_inputs(n, rows, 400 + n + rows, training, bf16)
        f = v["f32"]
        calls = {f"lstm_stack_fwd_L{n}": lambda: lk.lstm_stack_fwd_cuda(
            f["x"], *f["weights"])}
        if training:
            calls.update({
                f"lstm_stack_fwd_masked_L{n}": lambda: lk.lstm_stack_fwd_cuda(
                    f["x"], *f["weights"], f["masks"], stash=True),
                f"lstm_stack_bwd_L{n}": lambda: lk.lstm_stack_bwd_cuda(
                    *_bf16_stack_bwd_args(f)),
                f"lstm_wgrad_stack_L{n}": lambda: lk.lstm_stack_wgrad(
                    f["d_pres"], f["hs"], f["masks"]),
            })
        if bf16:
            calls[f"lstm_stack_fwd_bf16_L{n}"] = lambda: lk.lstm_stack_fwd_cuda(
                v["x"], *v["weights"])
            if training:
                calls.update({
                    f"lstm_stack_fwd_masked_bf16_L{n}": lambda: lk.lstm_stack_fwd_cuda(
                        v["x"], *v["weights"], v["masks"], stash=True),
                    f"lstm_stack_bwd_bf16_L{n}": lambda: lk.lstm_stack_bwd_bf16_cuda(
                        *_bf16_stack_bwd_args(v)),
                    f"lstm_wgrad_stack_bf16_L{n}": lambda: lk.lstm_stack_wgrad(
                        v["d_pres"], v["hs"], v["masks"]),
                })
        _ab_rows(label, rows, calls)


def _ab_rows(label: str, rows: int, calls: dict) -> None:
    """One ``"phase": "ab"`` line a call: its device time and digest."""
    with torch.no_grad():
        for name, call in calls.items():
            digest = hashlib.sha256()
            for t in _as_tuple(call()):
                if t.dtype == torch.bfloat16:
                    t = t.view(torch.int16)
                digest.update(t.cpu().numpy().tobytes())
            emit({"phase": "ab", "label": label, "kernel": name,
                  "rows": rows, "device_ms": spin_ms(call),
                  "digest": digest.hexdigest()[:16]})


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--ab", metavar="LABEL",
                        help="only time and digest the pair, single-layer, "
                             "time-blocked and stack kernels (phase_ab), "
                             "labelled LABEL")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    if args.ab is not None:
        phase_device()
        phase_ab(args.ab)
        return 0
    t0 = time.perf_counter()
    device = phase_device()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        # While nvcc builds: the universe data is made on the host, and a
        # first profiler trace sets up the profiler (~8 s on the card).
        universe_data = pool.submit(_universe_datamodule)
        profiler = pool.submit(device_ops, lambda: torch.ones(1, device=DEVICE) * 2)
        phase_build()
        profiler.result()
        dm_universe = universe_data.result()
    kernels = phase_kernels()
    kernels.update(phase_training_kernels())
    kernels.update(phase_stack_kernels())
    phase_stack_depths()
    phase_stack_vs_pairs()
    stack_bf16 = phase_stack_bf16_kernels()
    kernels.update({(name, rows): row for (name, rows, n), row in
                    stack_bf16.items() if n == STACK_LAYERS})
    kernels.update(phase_tblocked_kernels())
    stacked_kernels = phase_stacked_kernels(kernels)
    universe_kernels = phase_universe_kernels()
    windows = _synthetic_windows()
    serve = phase_serve(windows)
    odd = phase_odd_layers(windows)
    phase_breakdown(windows)
    serve_medium = phase_serve_medium(_synthetic_windows(K_MEDIUM))
    dm = _train_datamodule()
    phase_train_parity(dm)
    train = phase_train(dm)
    train_odd = phase_train_odd_layers(dm)
    phase_train_breakdown(dm)
    phase_graphs(dm, _train_spec(), "graphs_small",
                 {"lstm_pair_fwd_masked": 1, "lstm_pair_bwd": 1, "lstm_wgrad": 1})
    phase_driver(train)
    train_bf16 = phase_train_bf16(dm, train)
    train_medium_bf16 = phase_train_medium_bf16(dm)
    stacked_train = phase_stacked_train(dm, train)
    stream = phase_stream(dm)
    dm_medium = _train_datamodule(K_MEDIUM)
    phase_train_medium_parity(dm_medium)
    train_medium = phase_train_medium(dm_medium)
    phase_train_large(dm_medium)
    train_large_bf16 = phase_train_large_bf16(dm_medium, dm)
    phase_train_medium_breakdown(dm_medium)
    phase_train_large_breakdown(dm_medium)
    phase_graphs(dm_medium, _medium_spec(), "graphs_medium",
                 {"lstm_stack_fwd_masked": 1, "lstm_stack_bwd": 1,
                  "lstm_wgrad": 1})
    phase_graphs(dm_medium, _medium_spec(num_layers=8), "graphs_large",
                 {"lstm_stack_fwd_masked": 1, "lstm_stack_bwd": 1,
                  "lstm_fwd": 1, "lstm_bwd": 1, "lstm_wgrad": 2})
    stacked_groupings = phase_stacked_groupings(dm, dm_medium, dm_universe,
                                                train_medium)
    real = phase_real_medium(train_medium)
    # The serve preflight's child and the stacked entry point's run beside
    # resilience's (none of them is timed against another run).
    preflight = _start_preflight()
    stacked_child = _start_stacked_driver()
    profile_child = _start_telemetry_profile()
    sweeps = _start_data_parallel_sweeps()
    bf16_children = _start_bf16_driver()
    try:
        fleet = phase_resilience(profile_child)["fleet"]
        preflight_out = phase_serve_preflight(preflight)
        stacked_driver = phase_stacked_driver(stacked_child)
        phase_data_parallel_sweeps(sweeps)
        train_bf16_driver = phase_train_bf16_driver(bf16_children)
    finally:
        if preflight.poll() is None:
            preflight.kill()
            preflight.communicate()
        for child in (stacked_child, profile_child, sweeps["pool"],
                      sweeps["sequential"], sweeps["refused"],
                      bf16_children["train"], bf16_children["medium"],
                      bf16_children["refused"]):
            if child.proc.poll() is None:
                child.proc.kill()
                child.proc.wait()
    serve_long = phase_serve_long(_synthetic_windows(lookback=T_LONG,
                                                     stride=STRIDE_LONG))
    dm_long = _train_datamodule(lookback=T_LONG, stride=STRIDE_LONG)
    phase_train_long_parity(dm_long)
    train_long = phase_train_long(dm_long)
    phase_train_long_remat(dm_long)
    phase_graphs(dm_long, _train_spec(), "graphs_long",
                 {"lstm_tb_fwd": 2, "lstm_tb_bwd": 2})
    stacked_tblocked = phase_stacked_tblocked(dm_long, train_long)
    # The universe path: model=kfactor on 2,048-asset windows through the
    # single-layer kernels, trained by the entry point and served.
    universe_train = phase_universe_train(dm_universe)
    universe_serve = phase_universe_serve(universe_train["checkpoints"],
                                          universe_train["reference"])
    del dm_universe
    # The rest of serving: the fault plan, the swaps under load, the knee.
    # They run as a serving process would, on a heap collected once and
    # frozen (gc.freeze): the collector's passes then scan what serving
    # allocates, not the objects the phases above left (generation-2
    # passes over those took 0.23-0.87 s on an NVIDIA H100 80GB HBM3 host
    # at 700.00 W, and stalled the load and the dispatch thread alike).
    gc.collect()
    gc.freeze()
    serve_faults = phase_serve_faults(windows)
    serve_swap = phase_serve_swap(windows, _synthetic_windows(K_MEDIUM))
    serve_knee = phase_serve_knee(windows)
    phase_serve_quality(windows, serve_knee)
    phase_serve_slo(windows)
    stacked_serve = phase_stacked_serve(
        stacked_driver, windows, _synthetic_windows(K_MEDIUM),
        _synthetic_windows(lookback=T_LONG, stride=STRIDE_LONG))
    serve_fleet = phase_serve_fleet(windows)
    phase_ledger(device, train, serve_knee, serve_fleet)
    serve_cache = phase_serve_cache(windows)
    phase_preflight()
    # The maskless pair forward's and the stack forward's launches on the
    # serving phases of this slice.
    serve_paths = {
        "lstm_pair_fwd": {"serve_swap": serve_swap["small"],
                          "serve_faults": serve_faults,
                          "serve_knee": serve_knee,
                          "serve_fleet": serve_fleet,
                          "serve_cache": serve_cache},
        "lstm_stack_fwd": {"serve_swap_medium": serve_swap["medium"]},
    }
    missed = {f"{phase}/{name}": path["launches"][name]
              for name, paths in serve_paths.items()
              for phase, path in paths.items() if not path["launches"][name]}
    if missed:
        raise AssertionError(f"serving phases missed their kernels: {missed}")
    # Each kernel's launches on the path it serves, and its times at the
    # shape of that path: model=small serving at 8 windows (800 rows) and
    # training at one window a step (100 rows); model=medium serving at 8
    # windows (200 rows) and training at one window a step (25 rows);
    # model=small at T=252 serving at 8 windows and training at one.
    paths = {
        "lstm_pair_fwd": (serve, "lstm_pair_fwd", 800),
        "lstm_fwd": (odd, "lstm_fwd", 800),
        "lstm_pair_fwd_masked": (train, "lstm_pair_fwd_masked", 100),
        "lstm_pair_bwd": (train, "lstm_pair_bwd", 100),
        "lstm_wgrad": (train, "lstm_wgrad", 100),
        "lstm_bwd": (train_odd, "lstm_bwd", 100),
        "lstm_stack_fwd": (serve_medium, "lstm_stack_fwd", 8 * K_MEDIUM),
        "lstm_stack_fwd_masked": (train_medium, "lstm_stack_fwd_masked", K_MEDIUM),
        "lstm_stack_bwd": (train_medium, "lstm_stack_bwd", K_MEDIUM),
        "lstm_wgrad_stack": (train_medium, "lstm_wgrad", K_MEDIUM),
        "lstm_tb_fwd": (serve_long, "lstm_tb_fwd", 800),
        "lstm_tb_bwd": (train_long, "lstm_tb_bwd", 100),
        # trainer.precision=bf16-mixed: its validation and test run the
        # maskless bf16 forward, EVAL_CHUNK windows a chunk.
        "lstm_pair_fwd_bf16": (train_bf16, "lstm_pair_fwd_bf16",
                               EVAL_CHUNK * K_STOCKS),
        "lstm_pair_fwd_masked_bf16": (train_bf16, "lstm_pair_fwd_masked_bf16", 100),
        "lstm_pair_bwd_bf16": (train_bf16, "lstm_pair_bwd_bf16", 100),
        "lstm_wgrad_bf16": (train_bf16, "lstm_wgrad_bf16", 100),
        # The stack's bf16 instances on model=medium's bf16 fit: its
        # training steps (100 rows) and evaluation chunks (3,200 rows).
        "lstm_stack_fwd_bf16": (train_medium_bf16, "lstm_stack_fwd_bf16",
                                EVAL_CHUNK * K_STOCKS),
        "lstm_stack_fwd_masked_bf16": (train_medium_bf16,
                                       "lstm_stack_fwd_masked_bf16", K_STOCKS),
        "lstm_stack_bwd_bf16": (train_medium_bf16, "lstm_stack_bwd_bf16",
                                K_STOCKS),
        "lstm_wgrad_stack_bf16": (train_medium_bf16, "lstm_wgrad_bf16",
                                  K_STOCKS),
    }
    summary = []
    for name, (path, counter, rows) in paths.items():
        row = kernels[(name, rows)]
        source, replaces = KERNELS[name]
        summary.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": path["launches"][counter],
            "path": path["phase"],
            "rows": rows,
            "max_abs_err": max(v["max_abs_err"] for (n, _), v in kernels.items()
                               if n == name),
            "ms": row["ms"],
            "ms_spread": row["ms_spread"],
            "device_ms": row["device_ms"],
            "plain_ms": row["plain_ms"],
            "plain_device_ms": row["plain_device_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "library_device_ms": row["library_device_ms"],
        })
        if name in BF16_COUNTERS:
            # Its launches in the bf16 entry point's child, and its row's
            # check against the plain bf16 version.
            summary[-1]["launches_by_path"] = {
                "train_bf16_driver": train_bf16_driver["launches"][counter]}
            summary[-1].update({k: row[k] for k in (
                "bf16_equal_share", "bf16_max_ulps", "library_note")})
        if name in BF16_STACK_ROWS:
            # Its launches in the model=medium bf16 driver child and in
            # model=large's bf16 steps and chunks; its rows at the other
            # depths a bf16 fit runs (model=large's 8 and 6).
            summary[-1]["max_abs_err"] = max(
                r["max_abs_err"] for (n, _, _), r in stack_bf16.items()
                if n == name)
            summary[-1]["launches_by_path"] = {
                "train_bf16_driver_medium":
                    train_bf16_driver["medium"]["launches"][counter],
                "train_large_bf16": sum(
                    run[key][counter]
                    for run in train_large_bf16["windows"].values()
                    for key in ("launches", "eval_launches"))}
            summary[-1].update({k: row.get(k) for k in (
                "n_layers", "tile", "jobs", "bf16_equal_share",
                "bf16_max_ulps", "library_note")})
            summary[-1]["other_depths"] = [
                {k: r.get(k) for k in (
                    "n_layers", "rows", "tile", "jobs", "max_abs_err",
                    "bf16_equal_share", "bf16_max_ulps", "ms", "device_ms",
                    "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "library_device_ms")}
                for (n, _, depth), r in stack_bf16.items()
                if n == name and depth != STACK_LAYERS]
        if name in STREAM_PATHS:
            # Its launches on the stream epoch's path: ``stream``
            # (model=small, batch 3, the prefetcher two ahead) or
            # ``real_medium`` (the train child, 2 epochs).
            counts = {"stream": stream["launches"]["depth2"],
                      "real_medium": real["launches"]["train"]}
            summary[-1]["launches_by_path"] = {
                STREAM_PATHS[name]: counts[STREAM_PATHS[name]][counter]}
        if name in FLEET_PATH + ("lstm_pair_fwd",):
            # Its launches in the training fleet's generation 1 (the NCCL
            # rank resumed at epoch 1 by ``resilience fleet``; the maskless
            # forward in its validation and fingerprints).
            summary[-1].setdefault("launches_by_path", {})["fleet"] = \
                fleet["launches"][counter]
        if name == "lstm_fwd":
            # SV306's two one-layer preflight engines on the card.
            summary[-1].setdefault("launches_by_path", {})[
                "serve_preflight_fleet"] = \
                preflight_out["facts"]["fleet"]["launches"]["lstm_fwd"]
        if name in serve_paths:
            summary[-1].setdefault("launches_by_path", {}).update(
                {phase: path["launches"][name]
                 for phase, path in serve_paths[name].items()})
        if name in STACKED_COUNTERS:
            # The replica axis: its launches on the stacked paths (counted
            # apart, STACKED_COUNTERS), and its R = 8 rows at 100 and 800
            # rows against 8 solo launches.
            counter = STACKED_COUNTERS[name]
            by_path = {"stacked_train": stacked_train["launches"][counter],
                       "stacked_driver": stacked_driver["launches"].get(counter, 0)}
            if name == "lstm_pair_fwd":
                by_path = {"stacked_serve": stacked_serve["launches"][counter],
                           "stacked_serve_fleet":
                           serve_fleet["stacked"]["launches"][counter]}
            summary[-1].setdefault("launches_by_path", {}).update(by_path)
            summary[-1]["replica_axis"] = [
                {k: r[k] for k in ("rows", "replicas", "tile", "max_abs_err",
                                   "ms", "device_ms", "solo_ms",
                                   "solo_device_ms", "plain_ms", "bound_ms",
                                   "bound_by", "library_ms",
                                   "replicas_bit_equal_to_solo")}
                for (n, _, reps), r in stacked_kernels.items()
                if n == name and reps == max(STACK_RS)]
        if name in U_PATH:
            # Its launches on the universe path (the train child, the
            # serving bursts) and its rows at that path's shapes.
            measured = "lstm_wgrad_single" if name == "lstm_wgrad" else name
            summary[-1].setdefault("launches_by_path", {}).update({
                "universe_train": universe_train["launches"]["train"][name],
                "universe_serve": universe_serve["launches"][name],
                "universe_serve_warm":
                    universe_serve["warm_boot"]["launches"].get(name, 0)})
            summary[-1]["universe"] = [
                {k: r[k] for k in ("name", "rows", "T", "max_abs_err", "tol",
                                   "ms", "ms_spread", "device_ms", "plain_ms",
                                   "plain_device_ms", "bound_ms", "bound_by",
                                   "library_ms", "library_device_ms")}
                for (n, _), r in universe_kernels.items() if n == measured]
    # The replica axes of the single layer and the stack: each its
    # own entry, read at R = 8 on its path's rows; launches on the stacked
    # paths (counted apart from the solo launches).
    grouping_paths = {"stacked_groupings": stacked_groupings["launches"],
                      "stacked_tblocked": stacked_tblocked["launches_total"],
                      "stacked_serve": {
                          k: sum(g["launches"].get(k, 0)
                                 for g in stacked_serve["groupings"].values())
                          for k in lk.LAUNCHES}}
    for name, (row_name, rows, counter, path) in GROUPING_KERNELS.items():
        row = stacked_kernels[(row_name, rows, max(STACK_RS))]
        source, replaces = KERNELS[row_name]
        summary.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": grouping_paths[path][counter],
            "path": path,
            "rows": rows,
            "replicas": max(STACK_RS),
            "tile": row["tile"],
            "max_abs_err": max(r["max_abs_err"]
                               for (n, _, _), r in stacked_kernels.items()
                               if n == row_name),
            "ms": row["ms"],
            "device_ms": row["device_ms"],
            "solo_ms": row["solo_ms"],
            "solo_device_ms": row["solo_device_ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "replicas_bit_equal_to_solo": all(
                r["replicas_bit_equal_to_solo"]
                for (n, _, _), r in stacked_kernels.items() if n == row_name),
        })
        if path == "stacked_tblocked":
            summary[-1]["launches_by_path"] = {
                "stacked_tblocked": grouping_paths[path][counter],
                "stacked_serve": grouping_paths["stacked_serve"][counter]}
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    emit({"kernels": summary})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": device["kind"], "count": device["count"],
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
