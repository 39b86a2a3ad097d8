"""The port's collective-schedule chain, its cross-rank audit and its fleet
aggregation against the JAX package's (``telemetry/schedule.py``,
``telemetry/aggregate.py``), and the two trainers' schedules on one run.

Exact throughout: the chains are sha256 over the same canonical entries,
the audits and reports stdlib folds over the same files. The trainer case
runs both ``Trainer.fit``s at one process on the CPU at the toy size of
``tests/test_torch_train.py``'s parity case, with checkpoints, then each
resumed one epoch further."""

from __future__ import annotations

import json
import os
import random
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from masters_thesis_tpu.data.pipeline import (
    FinancialWindowDataModule as JaxDataModule,
)
from masters_thesis_tpu.data.pipeline import bootstrap_synthetic as jax_bootstrap
from masters_thesis_tpu.models.objectives import ModelSpec as JaxSpec
from masters_thesis_tpu.telemetry import aggregate as jax_aggregate
from masters_thesis_tpu.telemetry import schedule as jax_schedule
from masters_thesis_tpu.telemetry.flightrec import (
    FlightRecorder as JaxFlightRecorder,
)
from masters_thesis_tpu.telemetry.run import TelemetryRun as JaxTelemetryRun
from masters_thesis_tpu.train.trainer import Trainer as JaxTrainer
from masters_thesis_tpu_torch.data.pipeline import (
    FinancialWindowDataModule,
    bootstrap_synthetic,
)
from masters_thesis_tpu_torch.models.convert import params_from_jax
from masters_thesis_tpu_torch.models.objectives import ModelSpec
from masters_thesis_tpu_torch.telemetry import aggregate, schedule
from masters_thesis_tpu_torch.telemetry.__main__ import main as telemetry_main
from masters_thesis_tpu_torch.telemetry.flightrec import FlightRecorder
from masters_thesis_tpu_torch.telemetry.run import TelemetryRun
from masters_thesis_tpu_torch.train.trainer import Trainer

KINDS = ("barrier", "pmean", "psum", "all_gather")
NAMES = ("checkpoint.publish.last", "checkpoint.recover.last", "grads.flat",
         None)


def _entries(seed: int, n: int) -> list[tuple[str, dict]]:
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        fields = {"name": rng.choice(NAMES)}
        if rng.random() < 0.5:
            fields.update(dtype="float32", shape=[rng.randrange(1, 9), 64],
                          axes=("data",))
        if rng.random() < 0.7:
            fields["step"] = rng.randrange(0, 50)
        out.append((rng.choice(KINDS), fields))
    return out


def _both(entries, keep=schedule.TAIL_KEEP):
    ours, theirs = (schedule.CollectiveSchedule(keep),
                    jax_schedule.CollectiveSchedule(keep))
    for kind, fields in entries:
        assert ours.record(kind, **fields) == theirs.record(kind, **fields)
    return ours.snapshot(), theirs.snapshot()


@pytest.mark.parametrize("seed,n,keep", [(0, 0, 64), (1, 1, 64),
                                         (2, 40, 64), (3, 150, 64),
                                         (4, 30, 8)])
def test_chains_equal_the_jax_chains(seed, n, keep):
    ours, theirs = _both(_entries(seed, n), keep)
    assert ours == theirs
    assert ours["n"] == n and len(ours["tail"]) == min(n, keep)


def test_reset_and_the_global_chain_are_the_jax_ones():
    schedule.GLOBAL_SCHEDULE.reset()
    jax_schedule.GLOBAL_SCHEDULE.reset()
    for kind, fields in _entries(5, 6):
        assert (schedule.record_collective(kind, **fields)
                == jax_schedule.record_collective(kind, **fields))
    assert (schedule.GLOBAL_SCHEDULE.snapshot()
            == jax_schedule.GLOBAL_SCHEDULE.snapshot())
    schedule.GLOBAL_SCHEDULE.reset()
    assert schedule.GLOBAL_SCHEDULE.snapshot() == \
        schedule.CollectiveSchedule().snapshot()


def _audit_fixture(case: str) -> dict:
    base = _entries(11, 12)
    if case == "match":
        runs = {"p0": base, "p1": base, "p2": base}
    elif case == "lagging":
        runs = {"p0": base, "p1": base[:7], "p2": base}
    elif case == "diverged":
        forked = list(base)
        forked[5] = ("barrier", {"name": "checkpoint.publish.best"})
        runs = {"p0": base, "p1": forked, "p2": base}
    elif case == "diverged_pair":
        runs = {"p0": base, "p1": base[:4] + base[5:]}
    elif case == "insufficient":
        runs = {"p0": base, "p1": []}
    else:  # a rank that published nothing
        return {"p0": _both(base)[0], "p1": None}
    return {label: _both(entries)[0] for label, entries in runs.items()}


@pytest.mark.parametrize("case", ["match", "lagging", "diverged",
                                  "diverged_pair", "insufficient",
                                  "silent_rank"])
def test_audits_equal_the_jax_audits(case):
    snaps = _audit_fixture(case)
    ours = schedule.audit_schedules(snaps)
    assert ours == jax_schedule.audit_schedules(snaps)
    want = {"match": "match", "lagging": "lagging", "diverged": "diverged",
            "diverged_pair": "diverged", "insufficient": "insufficient",
            "silent_rank": "insufficient"}[case]
    assert ours["verdict"] == want
    if case == "diverged":
        assert ours["divergent_rank"] == "p1" and ours["index"] == 5


def test_rank_schedules_are_read_as_the_jax_reader_reads_them(tmp_path):
    """Heartbeat, crashdump and stream event of each rank under a
    generation dir: the same snapshots through both readers."""
    snaps = _audit_fixture("lagging")
    for i, (label, snap) in enumerate(sorted(snaps.items())):
        rank_dir = tmp_path / "g0" / label / "rank1"
        rank_dir.mkdir(parents=True)
        name = ("heartbeat.json", "crashdump.json")[i % 2]
        (rank_dir / name).write_text(json.dumps({"collective_schedule": snap}))
        (rank_dir / "events.jsonl").write_text(json.dumps(
            {"kind": "collective_schedule", "n": 1, "chain": "x",
             "tail": []}) + "\n")
    ours = schedule.read_rank_schedules(tmp_path / "g0")
    assert ours == jax_schedule.read_rank_schedules(tmp_path / "g0")
    assert {k: v["n"] for k, v in ours.items()} == {"p0": 12, "p1": 7,
                                                    "p2": 12}


# ------------------------------------------------ the two trainers' chains


def test_trainer_chains_equal_the_jax_trainer_chains(tmp_path):
    """One process, checkpoints on, 2 epochs, then each resumed to epoch 3:
    the port's schedule (its barriers in ``train/checkpoint.py``, one
    ``pmean`` an epoch) is the JAX trainer's, entry for entry."""
    windows = dict(lookback_window=10, target_window=5, stride=15)
    jax_bootstrap(tmp_path / "jax", n_stocks=4, n_samples=1200, seed=0)
    bootstrap_synthetic(tmp_path / "port", n_stocks=4, n_samples=1200, seed=0)
    dm = FinancialWindowDataModule(tmp_path / "port", **windows)
    dm.prepare_data()
    dm.setup("fit")
    dm.batch_size = n_train = len(dm.train_range)
    jdm = JaxDataModule(tmp_path / "jax", batch_size=n_train, engine="python",
                        **windows)
    hparams = dict(objective="mse", hidden_size=8, num_layers=2, dropout=0.0,
                   learning_rate=1e-3)
    jspec, spec = JaxSpec(**hparams), ModelSpec(**hparams)
    params = jspec.build_module().init(
        jax.random.key(1), jnp.zeros((1, windows["lookback_window"], 3)))["params"]
    init = jax.tree_util.tree_map(np.asarray, params)
    for epochs, resume in ((2, False), (3, True)):
        jax_schedule.GLOBAL_SCHEDULE.reset()
        schedule.GLOBAL_SCHEDULE.reset()
        JaxTrainer(max_epochs=epochs, gradient_clip_val=5.0,
                   strategy="single_device", enable_progress_bar=False,
                   enable_model_summary=False, ckpt_dir=tmp_path / "jck",
                   resume=resume).fit(
            jspec, jdm, init_state=None if resume else (init, None))
        Trainer(max_epochs=epochs, gradient_clip_val=5.0, device="cpu",
                ckpt_dir=tmp_path / "pck", resume=resume,
                enable_progress_bar=False).fit(
            spec, dm,
            init_state=None if resume else (params_from_jax(init), None))
        want = jax_schedule.GLOBAL_SCHEDULE.snapshot()
        got = schedule.GLOBAL_SCHEDULE.snapshot()
        first = next((i for i, (a, b) in enumerate(zip(got["tail"],
                                                       want["tail"]))
                      if a != b), None)
        assert first is None, (got["tail"][first], want["tail"][first])
        assert got == want
        pmeans = [e["step"] for e in got["tail"] if e["kind"] == "pmean"]
        assert pmeans == list(range(2 if resume else 0, epochs))
    schedule.GLOBAL_SCHEDULE.reset()


# ------------------------------------------------------------ aggregation


def _write_stream(path: Path, events: list[dict]) -> None:
    path.mkdir(parents=True, exist_ok=True)
    with open(path / "events.jsonl", "w") as f:
        for ev in events:
            f.write(json.dumps(ev) + "\n")


def _ev(seq, kind, *, proc, nproc, gen, attempt=1, ts=1000.0, **payload):
    ev = {"ts": ts + seq * 0.1, "kind": kind, "run": "r", "seq": seq,
          "host": "h", "pid": (100 + proc) if proc is not None else 99,
          "proc": proc, "nproc": nproc, "attempt": attempt}
    if gen is not None:
        ev["generation"] = gen
    ev.update(payload)
    return ev


def _stitched_root(root: Path, second_nprocs: int, second_procs: list,
                   diverged: bool = False) -> Path:
    """The JAX tests' generation-stitching fixture (``tests/
    test_fleetsup.py::TestAggregateGenerationStitching``), with the ranks'
    schedules as stream events."""
    for p in (0, 1):
        _write_stream(root / "g0" / f"p{p}", [
            _ev(0, "run_started", proc=p, nproc=2, gen=0, trace_id="t1"),
            _ev(1, "epoch", proc=p, nproc=2, gen=0, epoch=0, wall_s=0.1),
        ])
    for p in second_procs:
        entries = _entries(21, 6)
        if diverged and p == 1:
            entries[3] = ("barrier", {"name": "checkpoint.publish.best"})
        snap = _both(entries)[0]
        _write_stream(root / "g1" / f"p{p}", [
            _ev(0, "run_started", proc=p, nproc=second_nprocs, gen=1,
                attempt=2, ts=1100.0, trace_id="t1"),
            _ev(1, "epoch", proc=p, nproc=second_nprocs, gen=1, attempt=2,
                ts=1100.0, epoch=1, wall_s=0.2 + 0.1 * p),
            _ev(2, "collective_schedule", proc=p, nproc=second_nprocs, gen=1,
                attempt=2, ts=1100.0, **snap),
            _ev(3, "run_finished", proc=p, nproc=second_nprocs, gen=1,
                attempt=2, ts=1100.0),
        ])
    _write_stream(root / "supervisor", [
        _ev(0, "fleet_started", proc=None, nproc=None, gen=None, nprocs=2,
            trace_id="t1"),
        _ev(1, "fleet_generation_started", proc=None, nproc=None, gen=None,
            nprocs=2),
        _ev(2, "fleet_failure", proc=None, nproc=None, gen=None, rank=1, rc=3,
            classification="deterministic"),
        _ev(3, "fleet_resized", proc=None, nproc=None, gen=None,
            from_nprocs=2, to_nprocs=second_nprocs,
            reason="deterministic host loss", fingerprint="abc", ts=1050.0),
        _ev(4, "fleet_generation_started", proc=None, nproc=None, gen=None,
            nprocs=second_nprocs, ts=1050.0),
        _ev(5, "fleet_verdict", proc=None, nproc=None, gen=None, ok=True,
            verdict="completed", generations=2, final_nprocs=second_nprocs,
            trace_id="t1", ts=1100.0),
    ])
    return root


def _selfcheck_root(root: Path, writer: str, wedged: bool) -> Path:
    """The postmortem selfcheck's fixture (JAX ``telemetry/__main__.py``
    ``_postmortem_selfcheck``), written by either package."""
    tel_cls, rec_cls = ((TelemetryRun, FlightRecorder) if writer == "port"
                        else (JaxTelemetryRun, JaxFlightRecorder))
    saved = {k: os.environ.get(k)
             for k in ("JAX_PROCESS_INDEX", "JAX_PROCESS_COUNT")}
    try:
        for rank in range(2):
            os.environ["JAX_PROCESS_INDEX"] = str(rank)
            os.environ["JAX_PROCESS_COUNT"] = "2"
            tel = tel_cls(root / f"p{rank}", run_id=f"selfcheck-p{rank}")
            tel.event("run_started", platform="cpu", n_devices=1,
                      strategy="selfcheck", epoch_mode="scan",
                      steps_per_epoch=4)
            hung = wedged and rank == 1
            epochs = 2 if hung else 3
            wall = 0.4 + (0.0 if wedged else 0.01 * rank)
            for epoch in range(epochs):
                tel.event("epoch", epoch=epoch, steps=4, wall_s=wall,
                          dispatch_s=0.01, device_s=None, data_wait_s=0.0,
                          compile_events=0, compiled=False, fenced=False,
                          steps_per_sec=4.0 / wall)
            if hung:
                rec = rec_cls(tel.run_dir, run_id=tel.run_id, sink=tel.sink,
                              heartbeat_interval_s=60.0,
                              install_signal_handlers=False,
                              enable_faulthandler=False)
                rec.beat(phase="train", epoch=2)
                rec.dump("hang: no progress beat for 9.9s (selfcheck)")
                rec.close()
            else:
                tel.event("run_finished", epochs=epochs,
                          total_steps=4 * epochs, steps_per_sec=4.0 / wall,
                          diverged=False, best_val=0.5, epoch_compiles=1,
                          eval_compiles=0)
            tel.close()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return root


def _fixture(tmp_path: Path, name: str) -> tuple[Path, float]:
    if name == "retired_rank":
        return _stitched_root(tmp_path / name, 1, [0]), 1100.0 + 3600.0
    if name == "missing_rank":
        return _stitched_root(tmp_path / name, 2, [0]), 1100.0 + 3600.0
    if name == "diverged":
        return _stitched_root(tmp_path / name, 2, [0, 1], diverged=True), \
            1100.0 + 3600.0
    writer, state = name.split("_")
    root = _selfcheck_root(tmp_path / name, writer, state == "wedged")
    return root, max(p.stat().st_mtime for p in root.rglob("*")) + 1.0


FIXTURES = ["retired_rank", "missing_rank", "diverged", "port_healthy",
            "port_wedged", "jax_healthy", "jax_wedged"]
EXIT = {"retired_rank": 0, "missing_rank": 2, "diverged": 2,
        "port_healthy": 0, "port_wedged": 2, "jax_healthy": 0,
        "jax_wedged": 2}


def _canon(report: dict) -> str:
    return json.dumps(report, sort_keys=True, default=str)


@pytest.mark.parametrize("name", FIXTURES)
def test_reports_equal_the_jax_reports(tmp_path, name):
    root, now = _fixture(tmp_path, name)
    for grace in (30.0, 1e9):
        ours = aggregate.aggregate_path(root, now=now, grace_s=grace)
        assert _canon(ours) == _canon(jax_aggregate.aggregate_path(
            root, now=now, grace_s=grace))
        post = aggregate.postmortem_path(root, now=now, grace_s=grace)
        assert _canon(post) == _canon(jax_aggregate.postmortem_path(
            root, now=now, grace_s=grace))
        for postmortem in (False, True):
            report = post if postmortem else ours
            assert aggregate.render_fleet_text(report, postmortem) == \
                jax_aggregate.render_fleet_text(report, postmortem)
    post = aggregate.postmortem_path(root, now=now, grace_s=30.0)
    assert post["exit_code"] == EXIT[name], post["failures"]
    if name == "retired_rank":
        statuses = {d["label"]: d["status"] for d in post["processes"]}
        assert statuses == {"g0/p0": "superseded", "g0/p1": "superseded",
                            "g1/p0": "finished", "supervisor": "finished"}
    if name == "port_wedged":
        # (In this process the JAX writer takes its identity from the
        # initialised backend, process 0, whatever the environment says.)
        assert "p1" in post["headline"]


@pytest.mark.parametrize("name", ["retired_rank", "port_wedged"])
def test_the_commands_exit_as_the_reports_say(tmp_path, capsys, name):
    root, _ = _fixture(tmp_path, name)
    grace = ["--grace", "1e9"]
    code = telemetry_main(["postmortem", str(root), "--json", *grace])
    report = json.loads(capsys.readouterr().out)
    assert code == report["exit_code"] == EXIT[name]
    code = telemetry_main(["aggregate", str(root), *grace])
    assert code == (0 if EXIT[name] == 0 else 2)
    assert capsys.readouterr().out.startswith("fleet          : ")


def test_postmortem_selfcheck_and_the_watch_queue(capsys):
    assert telemetry_main(["postmortem", "--selfcheck"]) == 0
    assert "postmortem selfcheck ok" in capsys.readouterr().out
    # The watch console and the ledger are ported: a missing ledger is rc 1.
    assert telemetry_main(["watch", "--selfcheck"]) == 0
    assert "watch selfcheck ok" in capsys.readouterr().out
    assert telemetry_main(["ledger", "x"]) == 1
    assert "does not exist" in capsys.readouterr().err
    assert telemetry_main(["aggregate", "/nonexistent/fleet"]) == 1
