"""Fleets of the port's real trainer under the fleet supervisor, as gloo
ranks on the CPU (``tests/torch_fleet_ranks.py``), at the toy size of the
data-parallel tests, 3 epochs:

- 2 ranks, rank 1 killed right after epoch 1 is dispatched in generation 0:
  the whole fleet relaunches from the last verified checkpoint, and its
  final ``best`` and ``last`` are bit for bit a fault-free 2-rank fleet's;
- 3 ranks, rank 2 failing with the same error in every generation (a host
  deterministically gone): two failures with one fingerprint, a resize to
  2 ranks, and final weights bit for bit a 2-rank launch resumed from a
  copy of the checkpoint the resized fleet resumed from.

Each fleet runs under a hard deadline (``run_with_deadline``), the
reference launch under the launcher's timeout; nothing else is timed."""

from __future__ import annotations

import json
import os
import shutil
import sys
from pathlib import Path

import pytest
import torch

from masters_thesis_tpu_torch.data.pipeline import bootstrap_synthetic
from masters_thesis_tpu_torch.parallel import launch as launch_lib
from masters_thesis_tpu_torch.resilience import fleetsup
from masters_thesis_tpu_torch.telemetry import aggregate
from masters_thesis_tpu_torch.telemetry.events import read_events
from masters_thesis_tpu_torch.train.checkpoint import load_checkpoint
from torch_fleet_ranks import (
    RUN,
    rank_env,
    run_with_deadline,
    train_argv,
    write_job,
)

TIMEOUT_S = 240


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    data = tmp_path_factory.mktemp("fleet_data") / "toy"
    bootstrap_synthetic(data, n_stocks=4, n_samples=1200, seed=0)
    return data


def _cfg(nprocs: int, **over) -> fleetsup.FleetConfig:
    kw = dict(nprocs=nprocs, min_nprocs=1, backoff_s=0.05,
              backoff_factor=1.0, term_grace_s=5.0, poll_interval_s=0.1,
              hang_timeout_s=90.0, max_generations=4)
    kw.update(over)
    return fleetsup.FleetConfig(**kw)


def _fleet(tmp_path: Path, name: str, data_dir: Path, nprocs: int,
           min_nprocs: int = 1, **job) -> tuple[fleetsup.FleetResult, Path]:
    ckpts = tmp_path.joinpath("logs", *RUN, name, "checkpoints")
    cmd = write_job(tmp_path / f"{name}.json",
                    train_argv(data_dir, tmp_path / "logs", name),
                    ckpt_dir=str(ckpts), **job)
    result = run_with_deadline(fleetsup.FleetSupervisor(
        cmd, run_dir=tmp_path / f"{name}_run",
        cfg=_cfg(nprocs, min_nprocs=min_nprocs), env=rank_env(),
        ckpt_dir=ckpts), TIMEOUT_S)
    return result, ckpts


def _same_checkpoints(got: Path, want: Path) -> dict:
    equal = {}
    for tag in ("best", "last"):
        a, b = load_checkpoint(got, tag), load_checkpoint(want, tag)
        equal[tag] = (
            set(a[0]) == set(b[0])
            and all(torch.equal(a[0][k], v) for k, v in b[0].items())
            and all(torch.equal(a[1][k], v) if torch.is_tensor(v)
                    else a[1][k] == v for k, v in b[1].items())
            and a[2:] == b[2:])
    return equal


def _no_orphans(result) -> None:
    for gen in result.generations:
        for pid in gen.pids:
            with pytest.raises(ProcessLookupError):
                os.kill(pid, 0)


def test_a_killed_rank_resumes_the_fleet_bit_for_bit(tmp_path, data_dir):
    clean, clean_ckpts = _fleet(tmp_path, "clean", data_dir, 2)
    assert clean.ok and clean.n_generations == 1
    kill = {"rank": 1, "generations": [0], "point": "trainer.epoch_dispatched",
            "kind": "kill", "match": {"epoch": 1}}
    result, ckpts = _fleet(tmp_path, "killed", data_dir, 2, fault=kill)
    assert result.ok and result.verdict == "completed"
    assert result.n_generations == 2 and not result.resized
    _no_orphans(result)
    gen0 = result.generations[0]
    assert (gen0.failed_rank, gen0.rc) == (1, 137)
    assert gen0.classification.kind == "transient"
    run = tmp_path / "killed_run"
    relaunch = next(e for e in read_events(run / "supervisor" / "events.jsonl")
                    if e["kind"] == "fleet_relaunch")
    assert Path(relaunch["resumed_from"]).name in ("last", "last.prev")
    started = next(e for e in read_events(run / "g1" / "p0" / "events.jsonl")
                   if e["kind"] == "run_started")
    assert started["n_devices"] == 2 and started["start_epoch"] == 1
    assert started["distributed"]["process_count"] == 2
    assert _same_checkpoints(ckpts, clean_ckpts) == {"best": True,
                                                     "last": True}
    report = aggregate.postmortem_path(run)
    assert report["exit_code"] == 0, report["failures"]
    assert report["collective_schedule"]["verdict"] == "match"
    assert {d["label"]: d["status"] for d in report["processes"]
            if d["label"].startswith("g0/p")} == \
        {"g0/p0": "superseded", "g0/p1": "superseded"}


def test_a_deterministic_loss_resizes_and_resumes_bit_for_bit(tmp_path,
                                                              data_dir):
    loss = {"rank": 2, "generations": [0, 1], "point":
            "trainer.epoch_dispatched", "kind": "raise", "match": {"epoch": 1}}
    copy = tmp_path / "resumed_from"
    result, ckpts = _fleet(tmp_path, "resized", data_dir, 3, min_nprocs=2,
                           fault=loss, copy_at_gen=2, copy_to=str(copy))
    assert result.ok and result.resized and result.final_nprocs == 2
    assert [g.nprocs for g in result.generations] == [3, 3, 2]
    assert [g.failed_rank for g in result.generations[:2]] == [2, 2]
    fps = {g.classification.fingerprint for g in result.generations[:2]}
    assert len(fps) == 1 and None not in fps
    _no_orphans(result)
    # The reference: 2 ranks launched as the entry point launches them,
    # resumed from a copy of the checkpoint the resized fleet resumed from.
    ref = tmp_path.joinpath("logs", *RUN, "reference", "checkpoints")
    shutil.copytree(copy, ref)
    argv = [a for a in train_argv(data_dir, tmp_path / "logs", "reference")
            if not a.startswith(("+trainer.n_devices", "trainer.telemetry"))]
    code = launch_lib.launch(
        [sys.executable, "-m", "masters_thesis_tpu_torch", "train",
         "--device", "cpu", *argv, "trainer.telemetry=null"], 2,
        env=rank_env(), timeout_s=TIMEOUT_S, rendezvous_dir=tmp_path)
    assert code == 0
    assert _same_checkpoints(ckpts, ref) == {"best": True, "last": True}
    resized = [json.loads(line) for line in
               (tmp_path / "resized_run" / "supervisor" / "events.jsonl")
               .read_text().splitlines()]
    assert [e["to_nprocs"] for e in resized if e["kind"] == "fleet_resized"] \
        == [2]
