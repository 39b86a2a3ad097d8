"""One rank of a fleet of the port's ``train`` entry point, for the gloo
fleet tests (``tests/test_torch_fleet_train.py``), and the helpers that
start such fleets. Imports no JAX.

Run as ``python tests/torch_fleet_ranks.py <job.json> <train overrides>``
under the fleet supervisor: the rank reads its identity from the launch
environment and, when the job names its rank, installs the job's fault
in-process (the supervisor exports one environment to every rank, and only
this rank may fail), only in the generations the job lists. With ``copy_at_gen``, rank 0
copies the shared checkpoint directory before that generation trains, so a
test can resume a reference run from the very checkpoint the fleet
resumed from. Then it runs ``python -m masters_thesis_tpu_torch train
--device cpu <train overrides>``.

``run_with_deadline`` runs a fleet supervisor under a hard wall-clock cap,
for the fleet tests of this directory.
"""

from __future__ import annotations

import json
import os
import runpy
import shutil
import signal
import sys
import threading
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
#: The toy run of the data-parallel tests, 3 epochs, one intra-op thread a
#: rank (one order of CPU sums in every run).
TOY = ["datamodule.n_stocks=4", "datamodule.n_samples=1200",
       "datamodule.lookback_window=10", "datamodule.target_window=5",
       "datamodule.stride=15", "model.hidden_size=8", "trainer.max_epochs=3",
       "trainer.enable_progress_bar=false", "trainer.strategy=tpu_xla",
       "trainer.resume=auto"]
#: The fleet's run dir's checkpoints, under the job's ``logger.save_dir``.
RUN = ("FinancialLstm", "synthetic")


def rank_env() -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("MTT_FAULT_PLAN", "MTT_ATTEMPT", "MTT_GENERATION")}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    return env


def train_argv(data_dir: Path, save_dir: Path, version: str) -> list[str]:
    """The ranks' ``train`` overrides: the toy run at ``{world}`` ranks,
    telemetry in the rank's fleet dir."""
    return [*TOY, f"datamodule.data_dir={data_dir}",
            f"logger.save_dir={save_dir}", f"logger.version={version}",
            "+trainer.n_devices={world}", "trainer.telemetry={out}"]


def write_job(path: Path, argv: list[str], **job) -> list[str]:
    """The job file, and the rank command whose placeholders the
    supervisor fills in."""
    path.write_text(json.dumps(job))
    return [sys.executable, str(Path(__file__).resolve()), str(path), *argv]


def run_with_deadline(sup, deadline_s: float):
    """``sup.run()`` under a hard wall-clock cap. Past ``deadline_s`` a
    watchdog thread spends the supervisor's generation budget and SIGKILLs
    every rank of the current generation, again each half second, until
    the run returns its verdict; then the test fails, whatever the
    verdict. A fleet that hangs in its rendezvous or beats on without
    finishing so costs one failed test, not the whole run's time limit."""
    done = threading.Event()
    expired = []

    def watch() -> None:
        if done.wait(deadline_s):
            return
        expired.append(True)
        sup.cfg.max_generations = 0
        while not done.wait(0.5):
            for r in list(sup._ranks):
                try:
                    os.killpg(r.proc.pid, signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    pass

    watchdog = threading.Thread(target=watch, daemon=True)
    watchdog.start()
    try:
        result = sup.run()
    finally:
        done.set()
        watchdog.join()
    assert not expired, f"the fleet ran past its {deadline_s:.0f} s deadline"
    return result


def main() -> None:
    job = json.loads(Path(sys.argv[1]).read_text())
    rank = int(os.environ["JAX_PROCESS_INDEX"])
    gen = int(os.environ.get("MTT_GENERATION", "0") or 0)
    if job.get("copy_at_gen") == gen and rank == 0:
        shutil.copytree(job["ckpt_dir"], job["copy_to"])
    fault = job.get("fault")
    if fault and fault["rank"] == rank and gen in fault["generations"]:
        from masters_thesis_tpu_torch.resilience import faults

        faults.install_plan(faults.FaultPlan([faults.FaultSpec(
            point=fault["point"], kind=fault["kind"], attempt=None,
            match=fault["match"])]))
    sys.argv = ["masters_thesis_tpu_torch", "train", "--device", "cpu",
                *sys.argv[2:]]
    runpy.run_module("masters_thesis_tpu_torch", run_name="__main__",
                     alter_sys=True)


if __name__ == "__main__":
    main()
