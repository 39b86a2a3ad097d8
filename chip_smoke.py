"""Serve model=small on one NVIDIA GPU through the PyTorch/CUDA port.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``masters_thesis_tpu_torch/ops/csrc`` (at
first use, with nvcc), holds each against its plain PyTorch version on the
card, then drives the port's serving path — ``PredictServer`` ->
``PredictEngine`` -> ``LstmEncoder`` -> kernels — on requests made from the
synthetic DGP, and checks the answers against the same engine on the CPU.
Each phase prints one JSON line; the last line is
``{"ok": true, "device": {...}}``. Any failure raises, so the exit code is
non-zero; without CUDA the script exits 2 before doing anything.

Imports only torch, numpy and the port (never JAX or the JAX package).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from masters_thesis_tpu_torch.data.synthetic import SyntheticLogReturns
from masters_thesis_tpu_torch.models.objectives import ModelSpec
from masters_thesis_tpu_torch.ops import _build
from masters_thesis_tpu_torch.ops import lstm_kernel as lk
from masters_thesis_tpu_torch.ops.windows import (
    add_quadratic_features,
    lookback_target_split,
)
from masters_thesis_tpu_torch.serve.engine import PredictEngine
from masters_thesis_tpu_torch.serve.server import PredictServer

# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): the kernels
# run f32 products on the CUDA cores, so the f32 rate without tensor cores.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
PEAK_SOURCE = "H100 SXM data sheet: 67 TFLOP/s f32 (no tensor cores), 3.35 TB/s"

KERNEL_TOL = 2e-5  # f32, summation order differs over 60 dependent steps
SERVE_TOL = 5e-5  # f32 end to end: input projection, recurrence, heads
T, H = 60, 64
K_STOCKS = 100
SOURCE = "masters_thesis_tpu_torch/ops/csrc/lstm_fwd.cu"
REPLACES = {
    "lstm_pair_fwd": "masters_thesis_tpu/ops/lstm_kernel.py:719",
    "lstm_fwd": "masters_thesis_tpu/ops/lstm_kernel.py:140",
}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call, from CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


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


def _cudnn_lstm(x, layers):
    """torch.nn.LSTM (cuDNN) computing the kernel's function: layer 1's
    input weight is the identity on the 4H-wide projections (one extra
    (T*B, 4H) @ (4H, 4H) product), all of layer 1's bias sits in x."""
    four_h = 4 * H
    lstm = torch.nn.LSTM(four_h, H, num_layers=len(layers)).cuda()
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(torch.eye(four_h))
        lstm.bias_ih_l0.zero_()
        lstm.bias_hh_l0.zero_()
        lstm.weight_hh_l0.copy_(layers[0][0].T)
        if len(layers) == 2:
            (w2, wi2, b2) = layers[1]
            lstm.weight_ih_l1.copy_(wi2.T)
            lstm.bias_ih_l1.copy_(b2)
            lstm.bias_hh_l1.zero_()
            lstm.weight_hh_l1.copy_(w2.T)
    return lambda: lstm(x)[0]


def phase_kernels() -> dict:
    results = {}
    for rows in (100, 800):
        x, w1, wi2, b2, w2 = _kernel_case(rows, seed=rows)
        cases = {
            "lstm_pair_fwd": (
                lambda: lk.lstm_pair_fwd_cuda(x, w1, wi2, b2, w2),
                lambda: lk.lstm_pair_ref(x, w1, wi2, b2, w2),
                _cudnn_lstm(x, [(w1,), (w2, wi2, b2)]),
                3 * 2 * T * rows * H * 4 * H,
                4 * (x.numel() + 3 * H * 4 * H + 4 * H + T * rows * H),
            ),
            "lstm_fwd": (
                lambda: lk.lstm_fwd_cuda(x, w1),
                lambda: lk.lstm_recurrence_ref(x, w1),
                _cudnn_lstm(x, [(w1,)]),
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
                    "ms": cuda_ms(kernel),
                    "plain_ms": cuda_ms(plain, iters=5),
                    "library_ms": cuda_ms(library),
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


def _synthetic_windows() -> np.ndarray:
    """configs/datamodule/synthetic.yaml windows: lookback 60, target 30,
    stride 90, interaction-only features, from 100 stocks x 20,000 samples."""
    r_stocks, r_market, _, _ = SyntheticLogReturns.generate(
        K_STOCKS, 20_000, seed=0
    )
    x, _ = lookback_target_split(
        torch.from_numpy(r_stocks), torch.from_numpy(r_market),
        lookback_window=T, target_window=30, stride=90,
    )
    return add_quadratic_features(x, interaction_only=True).numpy()


def _small_spec(num_layers: int = 2):
    # configs/model/small.yaml: H=64, 2 layers, dropout 0.2, 3 inputs.
    return ModelSpec(
        objective="mse", input_size=3, hidden_size=H, num_layers=num_layers,
        dropout=0.2,
    )


def _engines(spec, seed: int):
    state = spec.build_module(
        device="cpu", generator=torch.Generator().manual_seed(seed)
    ).state_dict()
    kw = dict(n_stocks=K_STOCKS, lookback=T, n_features=3, buckets=(1, 2, 4, 8))
    return (
        PredictEngine(spec, state, device="cuda", **kw),
        PredictEngine(spec, state, device="cpu", **kw),
    )


def _max_err(got, want) -> float:
    return float(max(np.abs(g - w).max() for g, w in zip(got, want)))


def phase_serve(windows: np.ndarray) -> dict:
    gpu, cpu = _engines(_small_spec(), seed=0)
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
        "phase": "serve",
        "model": "small",
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
    if launches["lstm_pair_fwd"] < 1:
        raise AssertionError("the serving path never launched lstm_pair_fwd")
    if len(responses) < 32 or len(buckets) < 2:
        raise AssertionError(f"too little traffic: {len(responses)}, {buckets}")
    return out


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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gpu, _ = _engines(_small_spec(), seed=0)
    rows = []
    for bucket in (1, 8):
        x = windows[:bucket]
        for _ in range(3):
            gpu.predict(x)
        walls = []
        for _ in range(30):
            t0 = time.perf_counter()
            gpu.predict(x)
            walls.append(time.perf_counter() - t0)
        calls = 10
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                gpu.predict(x)
        # Device-side events only (kernels, copies): an operator's device
        # time is its kernels' time, counted once.
        device = sorted(
            ((e.key, e.self_device_time_total / 1e3 / calls)
             for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
            key=lambda kv: -kv[1],
        )
        busy_ms = sum(ms for _, ms in device)
        wall_ms = float(np.median(walls) * 1e3)
        row = {
            "phase": "breakdown",
            "bucket": bucket,
            "rows": bucket * K_STOCKS,
            "predict_wall_ms_p50": wall_ms,
            "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "device_ms_by_kernel": [
                {"name": name[:80], "ms": ms} for name, ms in device[:8]
            ],
        }
        emit(row)
        rows.append(row)
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    device = phase_device()
    phase_build()
    kernels = phase_kernels()
    windows = _synthetic_windows()
    serve = phase_serve(windows)
    odd = phase_odd_layers(windows)
    phase_breakdown(windows)
    path_launches = {
        "lstm_pair_fwd": serve["launches"]["lstm_pair_fwd"],
        "lstm_fwd": odd["launches"]["lstm_fwd"],
    }
    summary = []
    for name in ("lstm_pair_fwd", "lstm_fwd"):
        row = kernels[(name, 800)]
        summary.append({
            "name": name,
            "route": "cuda",
            "source": SOURCE,
            "replaces": REPLACES[name],
            "launches": path_launches[name],
            "max_abs_err": max(kernels[(name, r)]["max_abs_err"] for r in (100, 800)),
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
        })
    emit({"kernels": summary})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": device["kind"], "count": device["count"],
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
