"""The data-parallel launches of the port (``parallel/launch.py``, the
entry point's ranks, the sweep launchers) on the CPU, in gloo processes.

Every launch rendezvouses through a ``file://`` store in the test's own
``tmp_path`` (the ranks' ``TMPDIR`` for the entry point's launches), and
is cut at ``RANK_TIMEOUT_S``: the launcher then kills every rank, so that
a stuck collective fails one test.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from masters_thesis_tpu_torch.data.pipeline import bootstrap_synthetic
from masters_thesis_tpu_torch.models.objectives import ModelSpec
from masters_thesis_tpu_torch.train.logging import read_records
from torch_parallel_ranks import (
    RANK_TIMEOUT_S,
    TOY,
    WINDOWS,
    launch_ranks,
    rank_env,
)

CLIP = 5.0
H = 8


def _cli(tmp_path: Path, *args: str, env_extra: dict | None = None,
         timeout: float = RANK_TIMEOUT_S) -> subprocess.CompletedProcess:
    env = dict(rank_env(), TMPDIR=str(tmp_path))
    for key in ("MTT_FAULT_PLAN", "MTT_ATTEMPT"):
        env.pop(key, None)
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, "-m", "masters_thesis_tpu_torch", "train",
         "--device", "cpu", *args], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=timeout)


def test_a_killed_rank_stops_thelaunch_ranks(tmp_path):
    """Rank 1 is killed (SIGKILL) after its epoch 1 is dispatched, while
    rank 0 goes on into the epoch's all-reduce: the launcher exits 137 well
    inside the group's timeout, having killed rank 0, and no rank is left
    running."""
    bootstrap_synthetic(tmp_path / "port", n_stocks=4, n_samples=1200, seed=0)
    torch.save(ModelSpec(objective="mse", hidden_size=H, num_layers=2)
               .build_module(device="cpu").state_dict(), tmp_path / "init.pt")
    t0 = time.monotonic()
    code, _ = launch_ranks(tmp_path, 2, dict(
        kind="fit", data=str(tmp_path / "port"), windows=WINDOWS,
        batch_size=4, init=str(tmp_path / "init.pt"), epochs=3, clip=CLIP,
        hparams=dict(objective="mse", hidden_size=H, num_layers=2),
        fault_rank=1, fault_plan=[{"point": "trainer.epoch_dispatched",
                                   "kind": "kill", "match": {"epoch": 1}}]))
    assert code == 128 + 9
    assert time.monotonic() - t0 < 50
    for rank in range(2):
        pid = int((tmp_path / "ranks" / f"pid{rank}").read_text())
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


def test_data_rendezvous_waits_for_rank_zero(tmp_path):
    """Rank 1 finds no dataset and waits for rank 0's (which starts a
    second late) instead of generating or windowing its own (it would
    raise), and reads the same arrays."""
    code, ranks = launch_ranks(tmp_path, 2, dict(
        kind="rendezvous", data=str(tmp_path / "data"), windows=WINDOWS))
    assert code == 0
    assert ranks[1]["bootstrapped_at"] >= ranks[0]["bootstrapped_at"] - 0.1
    for got, want in zip(ranks[1]["arrays"], ranks[0]["arrays"]):
        assert torch.equal(got, want)


def _history(log_dir: Path) -> list:
    return [r for r in read_records(log_dir) if "lr-Adam" in r]


RUN = ("FinancialLstm", "synthetic", "mse_small_lr0.0001_tpu_xla")


def test_killed_world_of_two_resumes_as_the_unbroken_run(tmp_path):
    """``trainer=tpu_xla trainer.n_devices=2`` through the entry point: a
    run killed at epoch 2 (both ranks, after epoch 1's checkpoints) exits
    non-zero; relaunched with ``trainer.resume=true`` it ends where the
    unbroken 2-rank run ends, rows and ``last`` weights bit for bit."""
    common = [*TOY, "trainer=tpu_xla", "trainer.n_devices=2",
              "trainer.max_epochs=3", "trainer.check_val_every_n_epoch=1",
              f"datamodule.data_dir={tmp_path / 'data'}",
              f"logger.save_dir={tmp_path / 'logs'}"]
    whole = _cli(tmp_path, *common, "logger.version=whole")
    assert whole.returncode == 0, whole.stderr[-2000:]
    assert whole.stdout.count("done: ") == 1
    plan = json.dumps([{"point": "trainer.epoch_dispatched", "kind": "kill",
                        "match": {"epoch": 2}}])
    broken = _cli(tmp_path, *common, "logger.version=split",
                  env_extra={"MTT_FAULT_PLAN": plan})
    assert broken.returncode != 0
    resumed = _cli(tmp_path, *common, "logger.version=split",
                   "trainer.resume=true",
                   env_extra={"MTT_FAULT_PLAN": plan, "MTT_ATTEMPT": "2"})
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    root = tmp_path / "logs" / RUN[0] / RUN[1]
    want, got = _history(root / "whole"), _history(root / "split")
    assert [r["step"] for r in got] == [0, 1, 2]
    assert got == want
    a = torch.load(root / "whole" / "checkpoints" / "last" / "state.pt")
    b = torch.load(root / "split" / "checkpoints" / "last" / "state.pt")
    for name, value in a["state_dict"].items():
        assert torch.equal(b["state_dict"][name], value), name


def test_joblib_sweep_jobs_equal_their_sequential_runs(tmp_path):
    """``-m seed=0,1 launcher=joblib launcher.n_jobs=2``: two child
    processes at once, each job's rows equal to its run by the sequential
    launcher; ``MT_NUM_HOSTS=2 MT_HOST_INDEX=1`` over three seeds takes
    job 1 alone, under its global index."""
    common = [*TOY, "trainer.max_epochs=2", "seed=0,1",
              f"datamodule.data_dir={tmp_path / 'data'}"]
    seq = _cli(tmp_path, "-m", *common,
               f"launcher.sweep_dir={tmp_path / 'seq'}")
    assert seq.returncode == 0, seq.stderr[-2000:]
    pool = _cli(tmp_path, "-m", *common, "launcher=joblib",
                "launcher.n_jobs=2", f"launcher.sweep_dir={tmp_path / 'pool'}")
    assert pool.returncode == 0, pool.stderr[-2000:]
    assert "multirun: 2 jobs, n_jobs=2" in pool.stdout
    version = "mse_small_lr0.0001_fast"
    for job in ("0", "1"):
        want = _history(tmp_path / "seq" / job / "logs" / RUN[0] / RUN[1]
                        / version)
        got = _history(tmp_path / "pool" / job / "logs" / RUN[0] / RUN[1]
                       / version)
        assert len(got) == 2 and got == want
    hosts = _cli(tmp_path, "-m", *TOY, "trainer.max_epochs=1", "seed=0,1,2",
                 f"datamodule.data_dir={tmp_path / 'data'}",
                 f"launcher.sweep_dir={tmp_path / 'hosts'}",
                 env_extra={"MT_NUM_HOSTS": "2", "MT_HOST_INDEX": "1"})
    assert hosts.returncode == 0, hosts.stderr[-2000:]
    assert "multirun: host 1/2 takes 1/3 jobs" in hosts.stdout
    assert sorted(p.name for p in (tmp_path / "hosts").iterdir()) == ["1"]
