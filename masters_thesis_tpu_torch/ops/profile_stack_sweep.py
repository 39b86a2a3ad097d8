"""Where an iteration of the stack's backward sweep and of its forward
spends its time, in clock64 cycles, on the card.

    python3 -m masters_thesis_tpu_torch.ops.profile_stack_sweep

Builds ``csrc/lstm_stack.cu`` once more with ``-DLSTM_STACK_STAMPS`` (a
library of its own under ``ops/_build/``), in which thread 0 of one CTA
stamps ``clock64`` at eight points of every iteration, and runs the sweep
and the forward (masked, with the stashes) through the usual wrappers on
that library: at L=4 on 25 and 200 rows and L=8 on 25 rows (T=60, H=64,
masked), stamping layer 0's CTA, layer 1's and the top layer's in turn.
Prints the card's name, power limit and clocks, then one JSON line a case:
the median cycles an iteration and of each segment between stamps, over
the iterations where the layer runs. The stamps cost a few instructions
each, so the total reads a little above an unstamped launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import subprocess
import sys

import numpy as np
import torch

from masters_thesis_tpu_torch.ops import _build
from masters_thesis_tpu_torch.ops import lstm_kernel as lk

FLAGS = (*_build.NVCC_FLAGS, "-DLSTM_STACK_STAMPS")
STAMP_ITERS = 512  # kStampIters in csrc/lstm_stack.cu
SEGMENTS = {
    "sweep": ("stash loads", "pass", "cluster wait, push, inbox wait", "cell",
              "d_pre plane", "arrive", "device stores, staging, CTA barrier"),
    "forward": ("arm, x1 and mask loads", "inbox wait", "pass",
                "quarter sums, cell, staging", "cluster wait, push", "arrive",
                "device stores, CTA barrier"),
}
# The stamp that only an iteration in which the layer runs records.
RUN_STAMP = {"sweep": 1, "forward": 3}
T, H = 60, 64


def build() -> ctypes.CDLL:
    """csrc/lstm_stack.cu with the stamps, with the wrapper's function types."""
    source = _build.CSRC_DIR / "lstm_stack.cu"
    headers = b"".join(h.read_bytes() for h in sorted(_build.CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(source.read_bytes() + headers
                            + "\0".join(FLAGS).encode()).hexdigest()[:16]
    out = _build.BUILD_DIR / f"liblstm_stack_stamps-{digest}.so"
    if not out.is_file():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build.nvcc_path(), *FLAGS, "-o", str(out), str(source)],
                       check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    arr = ctypes.POINTER(ctypes.c_void_p)
    lib.lstm_stack_bwd.argtypes = [ptr, ptr] + [arr] * 7 + [i32] * 5 + [ptr]
    lib.lstm_stack_bwd.restype = i32
    lib.lstm_stack_fwd.argtypes = [ptr] + [arr] * 6 + [i32] * 5 + [ptr]
    lib.lstm_stack_fwd.restype = i32
    lib.lstm_stack_stamps.argtypes = [i32, ptr]
    lib.lstm_stack_stamps.restype = i32
    return lib


def inputs(n_layers: int, rows: int, seed: int) -> tuple:
    """The sweep's arguments: random weights and masks, plain stashes."""
    rng = np.random.default_rng(seed)
    scale = 1.0 / np.sqrt(H)

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device="cuda")

    x = t(rng.standard_normal((T, rows, 4 * H)))
    w_hh = [t(rng.uniform(-scale, scale, (H, 4 * H))) for _ in range(n_layers)]
    w_in = [t(rng.uniform(-scale, scale, (H, 4 * H))) for _ in range(n_layers - 1)]
    biases = [t(rng.uniform(-scale, scale, (4 * H,))) for _ in range(n_layers - 1)]
    masks = [t((rng.random((T, rows, H)) >= 0.3) / 0.7) for _ in range(n_layers - 1)]
    dh = t(0.1 * rng.standard_normal((T, rows, H)))
    with torch.no_grad():
        hs, cs = lk.lstm_stack_ref(x, w_hh, w_in, biases, masks, return_stash=True)
    return dh, x, masks, hs, cs, w_hh, w_in, biases


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_stack_sweep: CUDA is not available", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    lib = build()
    lk._stack_library = lambda: lib  # the wrapper launches the stamped build
    stamps = np.zeros((STAMP_ITERS, 8), dtype=np.int64)
    for n_layers, rows in ((4, 25), (4, 200), (8, 25)):
        args = inputs(n_layers, rows, seed=rows)
        dh, x, masks, hs, cs, w_hh, w_in, biases = args
        calls = {
            "sweep": (lambda: lk.lstm_stack_bwd_cuda(*args), T + 2 * (n_layers - 1)),
            "forward": (lambda: lk.lstm_stack_fwd_cuda(x, w_hh, w_in, biases, masks,
                                                       stash=True),
                        T + n_layers - 1),
        }
        for kernel, (call, iters) in calls.items():
            for layer in (0, 1, n_layers - 1):
                # The CTA of `layer` in the first cluster is block `layer`.
                if lib.lstm_stack_stamps(layer, stamps.ctypes.data) != 0:
                    raise RuntimeError("lstm_stack_stamps failed")
                for _ in range(3):
                    call()
                if lib.lstm_stack_stamps(-1, stamps.ctypes.data) != 0:
                    raise RuntimeError("lstm_stack_stamps failed")
                got = stamps[:iters].astype(np.float64)
                ran = got[:, RUN_STAMP[kernel]] != 0
                parts = np.diff(got, axis=1)[ran]
                print(json.dumps({
                    "kernel": kernel, "n_layers": n_layers, "rows": rows,
                    "layer": layer, "iterations_run": int(ran.sum()),
                    "cycles_per_iteration": float(np.median(np.diff(got[:, 0]))),
                    "segments": {name: float(np.median(parts[:, i]))
                                 for i, name in enumerate(SEGMENTS[kernel])},
                }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
