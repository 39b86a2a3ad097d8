"""Does a sweep's job repeat bit for bit, whichever process runs it?

    python3 -m masters_thesis_tpu_torch.cli.sweep_repeat [--fresh N]
        [--in-process N] [--load] [--device cpu] [overrides ...]

The job is ``train <overrides> seed=1 trainer.max_epochs=1``. It runs
first in ``--fresh`` new processes, one after another, as
``launcher=joblib`` runs a job. Then one process runs a seed-0 fit and,
after it, the job ``--in-process`` times, as the sequential launcher runs
a sweep's second job. Before every second in-process fit the allocator's
free blocks are filled with NaN, so a kernel that read device memory it
had not written would part from the others. ``--load`` keeps another
process busy on the card meanwhile (products of 4,096 x 4,096 matrices).
Each run's history row and ``last`` weights are held against the first
fresh run's. One JSON line reports every run; the exit code is 1 when any
run parts, and the runs' directory is then kept. Needs the card unless
given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from masters_thesis_tpu_torch.cli.train import main as train_main
from masters_thesis_tpu_torch.train.logging import read_records

_LOAD = (
    "import pathlib, sys, torch\n"
    "a = torch.randn(4096, 4096, device='cuda')\n"
    "while not pathlib.Path(sys.argv[1]).exists():\n"
    "    for _ in range(20):\n"
    "        a = (a @ a).tanh_()\n"
    "    torch.cuda.synchronize()\n"
)


def _run_dir(save_dir: Path) -> Path:
    return next(save_dir.rglob("metrics.jsonl")).parent


def _rows(run_dir: Path) -> list:
    return [r for r in read_records(run_dir) if "lr-Adam" in r]


def _weights(run_dir: Path) -> dict:
    return torch.load(run_dir / "checkpoints" / "last" / "state.pt",
                      map_location="cpu", weights_only=True)["state_dict"]


def _poison(device: str) -> None:
    """Fill the allocator's free blocks with NaN: hold blocks of 1 MB
    (the small pool) and of 2 MB to 1 GB, written, then free them."""
    if device == "cpu":
        return
    held = [torch.full((1 << 18,), float("nan"), device=device)
            for _ in range(64)]
    size = 1 << 19
    while size <= 1 << 28:
        held += [torch.full((size,), float("nan"), device=device)
                 for _ in range(2)]
        size *= 2
    torch.cuda.synchronize()
    del held


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m masters_thesis_tpu_torch.cli.sweep_repeat",
        description=__doc__.split("\n\n")[0])
    parser.add_argument("overrides", nargs="*")
    parser.add_argument("--fresh", type=int, default=2)
    parser.add_argument("--in-process", type=int, default=3)
    parser.add_argument("--load", action="store_true")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = ["--device", args.device]
    job = [*args.overrides, "trainer.max_epochs=1"]
    root = Path(tempfile.mkdtemp(prefix="sweep_repeat_"))
    stop = root / "stop"
    load = (subprocess.Popen([sys.executable, "-c", _LOAD, str(stop)])
            if args.load else None)
    runs: list[tuple[str, Path]] = []
    try:
        for i in range(args.fresh):
            save = root / f"fresh{i}"
            subprocess.run([sys.executable, "-m", "masters_thesis_tpu_torch",
                            "train", *device, *job, "seed=1",
                            f"logger.save_dir={save}"], check=True)
            runs.append((f"fresh{i}", _run_dir(save)))
        train_main([*device, *job, "seed=0",
                    f"logger.save_dir={root / 's0'}"])
        for i in range(args.in_process):
            poisoned = i % 2 == 1
            if poisoned:
                _poison(args.device)
            save = root / f"in_process{i}"
            train_main([*device, *job, "seed=1", f"logger.save_dir={save}"])
            runs.append((f"in_process{i}" + ("_nan" if poisoned else ""),
                         _run_dir(save)))
    finally:
        stop.touch()
        if load is not None:
            load.wait()
    want_rows, want_weights = _rows(runs[0][1]), _weights(runs[0][1])
    report = []
    for name, run_dir in runs:
        rows, weights = _rows(run_dir), _weights(run_dir)
        report.append({
            "run": name, "rows_equal": rows == want_rows,
            "weights_equal": weights.keys() == want_weights.keys() and all(
                torch.equal(weights[k], want_weights[k]) for k in weights),
            "mse_train": rows[-1].get("loss/mse/train") if rows else None})
    ok = all(r["rows_equal"] and r["weights_equal"] for r in report)
    print(json.dumps({"sweep_repeat": {
        "runs": report, "all_equal": ok, "load": args.load,
        "kept": None if ok else str(root)}}), flush=True)
    if ok:
        shutil.rmtree(root, ignore_errors=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
