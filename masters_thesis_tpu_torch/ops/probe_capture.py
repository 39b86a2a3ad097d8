"""Which of the kernels' host-side runtime calls a CUDA graph capture allows.

    python3 -m masters_thesis_tpu_torch.ops.probe_capture

Besides the launch, the launch code of each kernel (``ops/csrc``) calls the
CUDA runtime that its library links statically: ``cudaSetDevice`` and
``cudaDeviceGetAttribute`` on every call; ``cudaGetDevice``, and for a kernel
instance or a shared-memory size not seen before ``cudaFuncSetAttribute``
(``reserve_smem``); for the stack, ``cudaFuncSetAttribute`` and
``cudaOccupancyMaxActiveClusters`` at an instance's first call
(``cluster_capacity``). An instance's first launch also loads it, under
lazy module loading (CUDA's default). Each case captures one wrapper call
into a CUDA graph on a side stream, replays it, and holds the replay
against the eager call bit for bit:

- ``warm``: the single-layer forward at 100 rows, run eagerly before the
  capture, so only the per-call queries and the launch are captured (what
  the port's graphs do: ``utils/cuda_graph.py`` warms up first);
- ``cold``: the first call of another instance (800 rows, the 8-row tile)
  inside the capture: ``cudaFuncSetAttribute`` too, and the load;
- ``cold_pass``: the weight-gradient pass's first call (two kernels);
- ``cold_stack``: the 4-deep stack forward's first call (a cluster
  launch), with ``cudaOccupancyMaxActiveClusters``;
- ``warm_stack``: the stack forward at 200 rows after an eager call.

Each (module loading, capture mode) pair runs in a child process; EAGER
loading tells the module load apart from the runtime calls. One JSON line
a case, then one line with every case's outcome. Needs a card; builds the
kernels first if needed.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

from masters_thesis_tpu_torch.ops import _build
from masters_thesis_tpu_torch.ops import lstm_kernel as lk

LOADINGS = ("LAZY", "EAGER")
MODES = ("global", "thread_local")


def _inputs(rows: int, seed: int, hidden: int = 64, n_t: int = 60) -> dict:
    g = torch.Generator().manual_seed(seed)
    scale = hidden ** -0.5

    def uniform(*shape):
        return ((torch.rand(shape, generator=g) * 2 - 1) * scale).cuda()

    return {
        "x": torch.randn((n_t, rows, 4 * hidden), generator=g).cuda(),
        "w": uniform(hidden, 4 * hidden),
        "h": torch.randn((n_t, rows, hidden), generator=g).cuda(),
        "w_hh": [uniform(hidden, 4 * hidden) for _ in range(4)],
        "w_in": [uniform(hidden, 4 * hidden) for _ in range(3)],
        "b": [uniform(4 * hidden) for _ in range(3)],
    }


def _flat(out) -> list:
    if out is None:
        return []
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for item in out for t in _flat(item)]


def _capture(call, mode: str) -> list:
    """``call`` captured on a side stream, then replayed once: its outputs."""
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with lk.capturing(stream), torch.cuda.graph(
            graph, stream=stream, capture_error_mode=mode):
        out = _flat(call())
    graph.replay()
    torch.cuda.synchronize()
    return out


def _case(name: str, call, mode: str, warm: bool) -> dict:
    row = {"case": name, "mode": mode,
           "loading": os.environ.get("CUDA_MODULE_LOADING", "default")}
    try:
        want = [t.clone() for t in _flat(call())] if warm else None
        got = _capture(call, mode)
        if want is None:
            want = _flat(call())
        row.update(ok=True, bit_equal=all(torch.equal(a, b)
                                          for a, b in zip(got, want)))
    except Exception as err:  # the outcome is the finding: record it
        row.update(ok=False, error=f"{type(err).__name__}: {err}"[:300])
        torch.cuda.synchronize()
    print(json.dumps(row), flush=True)
    return row


def child(mode: str) -> None:
    small, large, stack = _inputs(100, 0), _inputs(800, 1), _inputs(25, 2)
    stack_wide = _inputs(200, 3)

    def stack_fwd(v):
        return lambda: lk.lstm_stack_fwd_cuda(v["x"], v["w_hh"], v["w_in"],
                                              v["b"])

    _case("warm", lambda: lk.lstm_fwd_cuda(small["x"], small["w"]), mode, True)
    _case("cold", lambda: lk.lstm_fwd_cuda(large["x"], large["w"]), mode, False)
    _case("cold_pass", lambda: lk.lstm_wgrad_cuda(
        [(small["x"], small["h"], 1, None, False)]), mode, False)
    _case("cold_stack", stack_fwd(stack), mode, False)
    _case("warm_stack", stack_fwd(stack_wide), mode, True)


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_capture: CUDA is not available", file=sys.stderr)
        return 2
    _build.build_all()
    rows = []
    for loading in LOADINGS:
        for mode in MODES:
            proc = subprocess.run(
                [sys.executable, "-m", __spec__.name, "--child", mode],
                env=dict(os.environ, CUDA_MODULE_LOADING=loading),
                capture_output=True, text=True, timeout=300)
            print(proc.stdout, end="", flush=True)
            if proc.returncode != 0:
                print(proc.stderr[-2000:], file=sys.stderr)
                rows.append({"loading": loading, "mode": mode,
                             "exit": proc.returncode})
                continue
            rows += [json.loads(line) for line in proc.stdout.splitlines()]
    print(json.dumps({"probe": "capture", "device": torch.cuda.get_device_name(0),
                      "torch": torch.__version__, "cuda": torch.version.cuda,
                      "cases": [{k: r.get(k) for k in
                                 ("loading", "mode", "case", "ok", "bit_equal",
                                  "exit")} for r in rows]}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        child(sys.argv[2])
        sys.exit(0)
    sys.exit(main())
