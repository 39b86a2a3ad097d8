"""Serve and train model=small and model=medium on one NVIDIA GPU through the
PyTorch/CUDA port, and model=small at a one-year lookback.

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
Trajectories and gradients are held against the CPU port. Each phase prints one JSON line; the last line is
``{"ok": true, "device": {...}}``. Any failure raises, so the exit code is
non-zero; without CUDA the script exits 2 before doing anything. The
training data is generated under ``data/chip_smoke/<stocks>x<samples>/``
next to this script.

Imports only torch, numpy and the port (never JAX or the JAX package).
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import time
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
from masters_thesis_tpu_torch.train.checkpoint import load_checkpoint
from masters_thesis_tpu_torch.train.optim import make_optimizer
from masters_thesis_tpu_torch.train.steps import (
    evaluate,
    forward_rows,
    metric_means,
    train_step,
)
from masters_thesis_tpu_torch.train.trainer import EVAL_CHUNK, Trainer, device_split

# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): the kernels
# run f32 products on the CUDA cores, so the f32 rate without tensor cores.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
PEAK_SOURCE = "H100 SXM data sheet: 67 TFLOP/s f32 (no tensor cores), 3.35 TB/s"

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
TB_SOURCE = "masters_thesis_tpu_torch/ops/csrc/lstm_tb.cu"
TPU = "masters_thesis_tpu/ops/lstm_kernel.py"
# Each kernel of the port: (its source, the TPU kernel it replaces).
# lstm_wgrad_stack is lstm_wgrad at a stack's 2L - 1 jobs; its launches
# count under lstm_wgrad.
KERNELS = {
    "lstm_pair_fwd": (FWD_SOURCE, f"{TPU}:719"),
    "lstm_fwd": (FWD_SOURCE, f"{TPU}:140"),
    "lstm_pair_fwd_masked": (FWD_SOURCE, f"{TPU}:719"),
    "lstm_pair_bwd": (BWD_SOURCE, f"{TPU}:845"),
    "lstm_wgrad": (BWD_SOURCE, f"{TPU}:845"),
    "lstm_bwd": (BWD_SOURCE, f"{TPU}:204"),
    "lstm_stack_fwd": (STACK_SOURCE, f"{TPU}:1118"),
    "lstm_stack_fwd_masked": (STACK_SOURCE, f"{TPU}:1118"),
    "lstm_stack_bwd": (STACK_SOURCE, f"{TPU}:1239"),
    "lstm_wgrad_stack": (BWD_SOURCE, f"{TPU}:1239"),
    "lstm_tb_fwd": (TB_SOURCE, f"{TPU}:339"),
    "lstm_tb_bwd": (TB_SOURCE, f"{TPU}:404"),
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


def data_dir(stocks: int) -> Path:
    """The training data's directory, keyed by the generation parameters, so
    a set made at another size is never reused and never blocks a run."""
    return (Path(__file__).resolve().parent / "data" / "chip_smoke"
            / f"{stocks}x{TRAIN_SAMPLES}")


def emit(obj: dict) -> None:
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
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
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


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """Least milliseconds for the work: the larger of the two roofline terms."""
    ops_ms = flops / PEAK_F32_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


# ------------------------------------------------------------------ phases


def phase_device() -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
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


def _cudnn_module(layers) -> torch.nn.LSTM:
    """torch.nn.LSTM (cuDNN) computing the kernels' function: layer 1's
    input weight is the identity on the 4H-wide projections (one extra
    (T*B, 4H) @ (4H, 4H) product), all of layer 1's bias sits in x.
    ``layers``: ``[(w_hh,), (w_hh, w_in, bias), ...]``, bottom first."""
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
    return lstm


def _cudnn_forward(x, layers):
    """cuDNN's forward on a copy of x that asks for a gradient: under
    inference mode the inference forward, else the forward as training runs
    it (it keeps what its backward needs)."""
    lstm = _cudnn_module(layers)
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
    lstm = _cudnn_module(layers)
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
                3 * 2 * T * rows * H * 4 * H,
                4 * (x.numel() + 3 * H * 4 * H + 4 * H + T * rows * H),
            ),
            "lstm_fwd": (
                lambda: lk.lstm_fwd_cuda(x, w1),
                lambda: lk.lstm_recurrence_ref(x, w1),
                _cudnn_forward(x, [(w1,)]),
                2 * T * rows * H * 4 * H,
                4 * (x.numel() + H * 4 * H + T * rows * H),
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
                    **timed("plain_ms", plain, calls=3, spin=False, iters=3,
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


def _measure(name: str, rows: int, kernel, plain, library, same: bool,
             flops: float, nbytes: float, relative: bool, full=None,
             note: str | None = None, check=None, n_t: int = T,
             extra: dict | None = None) -> dict:
    """One kernel row: the kernel against its plain version on the same
    inputs, then the kernel's, the plain version's and the library call's
    times, and the bound. ``same`` says whether the library call computes
    the same function (then its own error is reported); ``relative`` holds
    the error to KERNEL_TOL of the largest entry instead of KERNEL_TOL abs;
    ``full`` is the whole cuDNN backward (data and weight gradients);
    ``check`` returns ``(got, want)`` of further outputs to hold; ``extra``
    fields join the row."""
    with torch.no_grad():
        got = kernel()
        torch.cuda.synchronize()
        want = plain()
    err = _max_abs_err(got, want)
    if check is not None:
        extra_got, extra_want = check()
        err = max(err, _max_abs_err(extra_got, extra_want))
        want = _as_tuple(want) + _as_tuple(extra_want)
    tol = KERNEL_TOL * (max(1.0, _largest(want)) if relative else 1.0)
    row = {
        "phase": "kernel",
        "name": name,
        "rows": rows,
        "T": n_t,
        "H": H,
        "max_abs_err": err,
        "tol": tol,
        **(extra or {}),
        **timed("ms", kernel),
        **timed("plain_ms", plain, calls=3, spin=False, iters=3, loops=3,
                warmup=1),
        **timed("library_ms", library),
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
    if not err <= tol:
        raise AssertionError(f"{name} at rows={rows}: max abs err {err} > {tol}")
    return row


def phase_training_kernels() -> dict:
    """The training kernels against their plain versions at the shapes of
    the training path (100 rows: one window a step) and of 8 windows.

    FLOPs count each (rows, H) @ (H, 4H) product of a step as 2*H*4H a row:
    3 in the masked pair forward, 6 in the pair's backward sweep (both
    layers' gates, layer 2's input projection, three transposed products),
    3 in the pair's weight-gradient pass, 2 and 1 for the single layer.
    Bytes count each input read once and each output written once."""
    results = {}
    for rows in (100, 800):
        v = _training_inputs(rows)
        x, w1, wi2, b2, w2, mask, dh = (v[k] for k in (
            "x", "w1", "wi2", "b2", "w2", "mask", "dh"))
        product = 2 * T * rows * H * 4 * H
        plane_h = 4 * T * rows * H
        plane_x = 4 * T * rows * 4 * H
        weight = 4 * H * 4 * H
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
                3 * product, plane_x + plane_h + 3 * weight + 4 * 4 * H
                + 4 * plane_h, False, note=no_mask,
            ),
            # cuDNN's backward gives x's gradient only, held against the
            # sweep's first output; the whole cuDNN backward (data and weight
            # gradients) is timed beside it.
            _measure(
                "lstm_pair_bwd", rows,
                lambda: lk.lstm_pair_bwd_cuda(*bwd_args),
                lambda: lk.lstm_pair_bwd_ref(*bwd_args),
                _cudnn_backward(x, pair, dh, weights=False), False,
                6 * product, 6 * plane_h + plane_x + 3 * weight + 4 * 4 * H
                + 2 * plane_x, True,
                full=_cudnn_backward(x, pair, dh, weights=True), note=no_mask,
            ),
            _measure(
                "lstm_wgrad", rows,
                lambda: lk.lstm_pair_wgrad(*wgrad_args),
                lambda: lk.lstm_pair_wgrad_ref(*wgrad_args),
                _wgrad_library(*wgrad_args), True,
                3 * product, 2 * plane_x + 3 * plane_h + 3 * weight + 4 * 4 * H,
                True,
                # The single-layer job of the same pass.
                check=lambda: (lk.lstm_single_wgrad(v["dx"], v["hs"]),
                               lk.lstm_wgrad_ref(v["dx"], v["hs"], 1)),
            ),
            _measure(
                "lstm_bwd", rows,
                lambda: lk.lstm_bwd_cuda(dh, x, v["hs"], v["cs"], w1),
                lambda: lk.lstm_bwd_ref(dh, x, v["hs"], v["cs"], w1),
                _cudnn_backward(x, [(w1,)], dh, weights=False), True,
                2 * product, 3 * plane_h + plane_x + weight + plane_x, True,
                full=_cudnn_backward(x, [(w1,)], dh, weights=True),
            ),
        ]
        for row in rows_out:
            results[(row["name"], rows)] = row
    return results


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
        product = 2 * T * rows * H * 4 * H
        plane_h = 4 * T * rows * H
        plane_x = 4 * T * rows * 4 * H
        params = 4 * ((2 * n - 1) * H * 4 * H + (n - 1) * 4 * H)
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
                (2 * n - 1) * product, plane_x + params + plane_h, False,
                extra=tile(False, False),
            ),
            _measure(
                "lstm_stack_fwd_masked", rows,
                lambda: lk.lstm_stack_fwd_cuda(x, *weights, masks, stash=True),
                lambda: lk.lstm_stack_ref(x, *weights, masks, return_stash=True),
                _cudnn_forward(x, v["layers"]), False,
                (2 * n - 1) * product,
                plane_x + (n - 1) * plane_h + params + 2 * n * plane_h, False,
                note=no_mask, extra=tile(False, True, stash=True),
            ),
            _measure(
                "lstm_stack_bwd", rows,
                lambda: lk.lstm_stack_bwd_cuda(*bwd_args),
                lambda: lk.lstm_stack_bwd_ref(*bwd_args),
                _cudnn_backward(x, v["layers"], dh, weights=False), False,
                (4 * n - 2) * product,
                plane_h + plane_x + (n - 1) * plane_h + 2 * n * plane_h + params
                + n * plane_x, True,
                full=_cudnn_backward(x, v["layers"], dh, weights=True),
                note=no_mask, extra=tile(True, True),
            ),
            _measure(
                "lstm_wgrad_stack", rows,
                lambda: lk.lstm_stack_wgrad(*wgrad_args),
                lambda: lk.lstm_stack_wgrad_ref(*wgrad_args),
                _stack_wgrad_library(*wgrad_args), True,
                (2 * n - 1) * product,
                n * plane_x + n * plane_h + (n - 1) * plane_h + params, True,
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
        product = 2 * T_LONG * rows * H * 4 * H
        plane_h = 4 * T_LONG * rows * H
        plane_x = 4 * T_LONG * rows * 4 * H
        weight = 4 * H * 4 * H
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
                product, plane_x + weight + plane_h, False,
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
                3 * product, 3 * plane_h + 2 * plane_x + 2 * weight, True,
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
    state = spec.build_module(
        device="cpu", generator=torch.Generator().manual_seed(seed)
    ).state_dict()
    kw = dict(n_stocks=stocks, lookback=lookback, n_features=3,
              buckets=(1, 2, 4, 8))
    return (
        PredictEngine(spec, state, device=DEVICE, **kw),
        PredictEngine(spec, state, device="cpu", **kw),
    )


def _max_err(got, want) -> float:
    return float(max(np.abs(g - w).max() for g, w in zip(got, want)))


def _serve(spec, windows: np.ndarray, stocks: int, phase: str, model: str,
           kernel: str, absent: tuple = ()) -> dict:
    """Bursts of requests through PredictServer on the card, every answer
    held against the CPU engine; ``kernel`` must launch, ``absent`` must
    not."""
    lookback = windows.shape[2]
    gpu, cpu = _engines(spec, seed=0, stocks=stocks, lookback=lookback)
    server = PredictServer(gpu, max_wait_s=0.002)
    bursts = (1, 2, 4, 8, 3, 8, 5, 1, 6, 8, 2, 7, 4, 1, 8)
    sent, responses = [], []
    lk.reset_launch_counts()
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
    launches = dict(lk.LAUNCHES)

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
        "late_deliveries": stats["late_deliveries"],
        "dispatches": stats["dispatches"],
        "buckets_used": buckets,
        "p50_ms": stats["p50_ms"],
        "p99_ms": stats["p99_ms"],
        "answers_per_s": len(responses) / serve_s,
        "launches": launches,
    }
    emit(out)
    if not err <= SERVE_TOL:
        raise AssertionError(f"served answers differ from the CPU engine: {err}")
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
    gpu, cpu = _engines(_small_spec(num_layers=3), seed=1)
    batch = windows[:8]
    lk.reset_launch_counts()
    got = gpu.predict(batch)
    launches = dict(lk.LAUNCHES)
    err = _max_err(got, cpu.predict(batch))
    out = {
        "phase": "odd_layers",
        "num_layers": 3,
        "windows": len(batch),
        "layer_groups": gpu._module.layer_groups(T, 8 * K_STOCKS, False, K_STOCKS),
        "max_abs_err_vs_cpu": err,
        "tol": SERVE_TOL,
        "launches": launches,
    }
    emit(out)
    if not err <= SERVE_TOL:
        raise AssertionError(f"3-layer encoder differs from the CPU: {err}")
    if launches["lstm_fwd"] < 1 or launches["lstm_pair_fwd"] < 1:
        raise AssertionError(f"3-layer path missed a kernel: {launches}")
    return out


def phase_breakdown(windows: np.ndarray) -> list[dict]:
    """Where one predict call's time goes, at buckets 1 and 8: host wall
    clock per call (numpy in, numpy out, so it ends synchronized) beside
    the device time by kernel from a torch.profiler trace of 10 calls."""
    gpu, _ = _engines(_small_spec(), seed=0)
    rows = []
    for bucket in (1, 8):
        x = windows[:bucket]
        host, busy_ms, device = _wall_and_device(lambda: gpu.predict(x))
        row = {
            "phase": "breakdown",
            "bucket": bucket,
            "rows": bucket * K_STOCKS,
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


def _run_steps(spec, state, batches, device, masks=None):
    """``len(batches)`` train_step updates of a model with ``state`` on
    ``device``: per-step losses, per-step flat gradients (CPU) and the
    final parameters (CPU)."""
    module = spec.build_module(device=device)
    module.load_state_dict(state)
    optimizer = make_optimizer(module, CLIP, spec.weight_decay)
    loss_fn = batched_objective(spec.window_objective())
    losses, grads = [], []
    for i, arrays in enumerate(batches):
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


def _window_batches(dm, n: int) -> list:
    train = dm.train_arrays()
    return [tuple(np.ascontiguousarray(a[i:i + 1]) for a in train)
            for i in range(n)]


def _train_parity(dm, spec, phase: str, kernels: tuple, per_step: int = 1) -> dict:
    """``spec`` with dropout 0: PARITY_STEPS steps on the same windows, in
    the same order, from the same weights, on the card and on the CPU (plain
    versions); each of ``kernels`` launches ``per_step`` times a step on the
    card."""
    state = spec.build_module(
        device="cpu", generator=torch.Generator().manual_seed(0)).state_dict()
    batches = _window_batches(dm, PARITY_STEPS)
    lk.reset_launch_counts()
    gpu_losses, gpu_grads, gpu_state, _ = _run_steps(spec, state, batches, DEVICE)
    launches = dict(lk.LAUNCHES)
    cpu_losses, cpu_grads, cpu_state, _ = _run_steps(spec, state, batches, "cpu")
    loss_gap = max(abs(g - c) / abs(c) for g, c in zip(gpu_losses, cpu_losses))
    param_gap = max(float((gpu_state[k] - cpu_state[k]).abs().max())
                    for k in cpu_state)
    grad_gap = _grad_gap(gpu_grads, cpu_grads)
    moved = max(float((cpu_state[k] - state[k]).abs().max()) for k in state)
    rows = dm.train_arrays().x.shape[1]
    out = {
        "phase": phase,
        "num_layers": spec.num_layers,
        "lookback": dm.lookback_window,
        "steps": PARITY_STEPS,
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
              if launches[k] != per_step * PARITY_STEPS}
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
    t0 = time.perf_counter()
    result = trainer.fit(spec, dm, module=module)
    fit_s = time.perf_counter() - t0
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


def phase_train_medium(dm) -> dict:
    """model=medium (dropout 0.3) on 25-row windows: the masked 4-deep
    stack, its sweep and one weight-gradient pass each step."""
    return _train(dm, _medium_spec(), "train_medium", "medium",
                  ("lstm_stack_fwd_masked", "lstm_stack_bwd", "lstm_wgrad"))


def phase_train_long_parity(dm) -> dict:
    """model=small at full width with dropout 0 on 100-row windows of 252
    days: both layers alone, each through the time-blocked forward and
    backward once a step."""
    return _train_parity(dm, _train_spec(dropout=0.0), "train_long_parity",
                         ("lstm_tb_fwd", "lstm_tb_bwd"), per_step=2)


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
    }
    emit(out)
    return out


def phase_train_breakdown(dm) -> dict:
    return _train_breakdown(dm, _train_spec(), "train_breakdown")


def phase_train_medium_breakdown(dm) -> dict:
    return _train_breakdown(dm, _medium_spec(), "train_medium_breakdown")


def phase_train_large_breakdown(dm) -> dict:
    """model=large's step: the 7-deep stack and the single layer."""
    return _train_breakdown(dm, _medium_spec(num_layers=8),
                            "train_large_breakdown")


def phase_ab(label: str) -> None:
    """The pair, single-layer, time-blocked and stack kernels of whatever
    checkout this copy of the script sits in, for comparing two checkouts
    on one card: each call's device time (``spin_ms``) and a sha256 digest
    of its outputs, at 100 and 800 rows, on the training inputs (T=60) and,
    for the time-blocked forward and backward and the resident forward
    beside them, on ``_long_inputs`` (T=252); the 4-deep stack's
    forward (maskless, and masked with its stashes), sweep and
    weight-gradient pass at 25 and 200 rows on ``_stack_inputs``, and the
    8-deep masked forward at 25 rows.
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


def _ab_rows(label: str, rows: int, calls: dict) -> None:
    """One ``"phase": "ab"`` line a call: its device time and digest."""
    with torch.no_grad():
        for name, call in calls.items():
            digest = hashlib.sha256()
            for t in _as_tuple(call()):
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
    phase_build()
    kernels = phase_kernels()
    kernels.update(phase_training_kernels())
    kernels.update(phase_stack_kernels())
    phase_stack_depths()
    phase_stack_vs_pairs()
    kernels.update(phase_tblocked_kernels())
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
    dm_medium = _train_datamodule(K_MEDIUM)
    phase_train_medium_parity(dm_medium)
    train_medium = phase_train_medium(dm_medium)
    phase_train_large(dm_medium)
    phase_train_medium_breakdown(dm_medium)
    phase_train_large_breakdown(dm_medium)
    serve_long = phase_serve_long(_synthetic_windows(lookback=T_LONG,
                                                     stride=STRIDE_LONG))
    dm_long = _train_datamodule(lookback=T_LONG, stride=STRIDE_LONG)
    phase_train_long_parity(dm_long)
    train_long = phase_train_long(dm_long)
    phase_train_long_remat(dm_long)
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
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    emit({"kernels": summary})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": device["kind"], "count": device["count"],
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
