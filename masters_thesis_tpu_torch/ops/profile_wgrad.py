"""The weight-gradient pass on the card: its variants side by side.

    python3 -m masters_thesis_tpu_torch.ops.profile_wgrad

At the four shapes the training paths give the pass (T=60, H=64: the pair's
3 jobs at 100 and 800 rows, a 4-deep stack's 7 jobs at 25 and 200 rows), on
random planes made from a seed: the pass against its plain version, then its
device time (CUDA events around one call queued behind a spin kernel, the
median of 9 calls) and the split count it picks, beside one cuBLAS product a
job (the yardstick ``chip_smoke.py`` reports).
Prints the card's name and power limit, then one JSON line a shape.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

from masters_thesis_tpu_torch.ops import lstm_kernel as lk

T, H = 60, 64


def spin_ms(fn, calls: int = 9) -> float:
    """The card's milliseconds for one call: CUDA events around the call,
    queued behind a spin kernel that outlasts the host's time to queue it."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def jobs_of(kind: str, rows: int, seed: int) -> list:
    """The pass's jobs as the pair (3) or a 4-deep stack (7) makes them."""
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                            device="cuda")

    def mask():
        return torch.tensor((rng.random((T, rows, H)) >= 0.2) / 0.8,
                            dtype=torch.float32, device="cuda")

    if kind == "pair":
        dx1, d_pre2 = t(T, rows, 4 * H), t(T, rows, 4 * H)
        h1s, h2s, m = t(T, rows, H), t(T, rows, H), mask()
        return [(dx1, h1s, 1, None, False), (d_pre2, h1s, 0, m, True),
                (d_pre2, h2s, 1, None, False)]
    n = 4
    d_pres = [t(T, rows, 4 * H) for _ in range(n)]
    hs = [t(T, rows, H) for _ in range(n)]
    masks = [mask() for _ in range(n - 1)]
    return lk._stack_wgrad_jobs(d_pres, hs, masks)


def cublas(jobs):
    """One cuBLAS product a job on the shifted, masked views, and the bias
    sums."""
    def rows_of(x):
        return x.reshape(-1, x.shape[-1])

    def one(d_pre, src, shift, mask):
        a = src if mask is None else src * mask
        if shift:
            return rows_of(a[:-1]).T @ rows_of(d_pre[1:])
        return rows_of(a).T @ rows_of(d_pre)

    return lambda: ([one(*job[:4]) for job in jobs]
                    + [job[0].sum(dim=(0, 1)) for job in jobs if job[4]])


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_wgrad: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    lib = lk._bwd_library()
    for kind, rows in (("pair", 100), ("pair", 800), ("stack", 25), ("stack", 200)):
        jobs = jobs_of(kind, rows, seed=rows)
        found = ctypes.c_int(0)
        assert lib.lstm_wgrad_splits(len(jobs), T, rows, H, torch.cuda.current_device(),
                                     ctypes.byref(found)) == 0
        with torch.no_grad():
            got = lk.lstm_wgrad_cuda(jobs)
            err = 0.0
            for (d_pre, src, shift, mask, with_bias), (dw, db) in zip(jobs, got):
                want = lk.lstm_wgrad_ref(d_pre, src, shift, mask)
                err = max(err, float((dw - want).abs().max()
                                     / max(1.0, float(want.abs().max()))))
                if with_bias:
                    want = d_pre.sum(dim=(0, 1))
                    err = max(err, float((db - want).abs().max()
                                         / max(1.0, float(want.abs().max()))))
            row = {"kind": kind, "rows": rows, "jobs": len(jobs),
                   "splits": found.value, "max_rel_err": err,
                   "ms": spin_ms(lambda: lk.lstm_wgrad_cuda(jobs)),
                   "cublas_ms": spin_ms(cublas(jobs))}
        print(json.dumps(row), flush=True)
        if not err <= 2e-5:
            raise AssertionError(f"{kind} at {rows} rows: relative error {err}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
