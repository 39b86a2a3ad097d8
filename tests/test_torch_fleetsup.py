"""The port's fleet supervisor (``resilience/fleetsup.py``) against the JAX
package's: the same decisions on the same scripted evidence, then its own
processes (``fleet-worker`` ranks): a killed rank relaunched with the
whole fleet, a wedged heartbeat, a resize 4 -> 3, a halt at the floor, and
the root-cause rule that names the failed rank, not a survivor. No timing
is asserted; every fleet runs under a hard deadline
(``tests/torch_fleet_ranks.py`` ``run_with_deadline``), and every run dir
is in ``tmp_path``."""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import urllib.request
from pathlib import Path

import pytest

from masters_thesis_tpu.resilience import fleetsup as jax_fleetsup
from masters_thesis_tpu.telemetry import aggregate as jax_aggregate
from masters_thesis_tpu.telemetry.events import read_events as jax_read_events
from masters_thesis_tpu_torch.resilience import faults, fleetsup
from masters_thesis_tpu_torch.resilience.__main__ import (
    _fleet_expected_value,
)
from masters_thesis_tpu_torch.resilience.__main__ import (
    main as resilience_main,
)
from masters_thesis_tpu_torch.telemetry import aggregate
from masters_thesis_tpu_torch.telemetry.events import read_events
from masters_thesis_tpu_torch.telemetry.trace import TRACE_ENV
from torch_fleet_ranks import run_with_deadline

REPO = Path(__file__).resolve().parent.parent
#: Each fleet of ``fleet-worker`` ranks' hard cap.
DEADLINE_S = 120.0
ENVELOPE = ("ts", "run", "seq", "host", "pid", "proc", "nproc", "attempt",
            "generation")


# ------------------------------------------------------------- the policy

#: Scripted generations: (ok, fingerprint) each, what the supervisor's
#: ``_run_generation`` returns in turn; and the config.
POLICIES = {
    "transient_then_ok": (dict(nprocs=2), [(False, None), (True, None)]),
    "same_fingerprint_resizes": (dict(nprocs=4),
                                 [(False, "fpA"), (False, "fpA"),
                                  (True, None)]),
    "deterministic_at_the_floor": (dict(nprocs=2, min_nprocs=2),
                                   [(False, "fpA"), (False, "fpA")]),
    "generation_budget": (dict(nprocs=2, max_generations=3,
                               max_relaunches_per_size=9),
                          [(False, None), (False, "fpA"), (False, "fpB")]),
    "relaunches_spent_at_the_floor": (dict(nprocs=2, min_nprocs=2,
                                           max_relaunches_per_size=1),
                                      [(False, "fpA"), (False, "fpB")]),
    "relaunches_spent_resize": (dict(nprocs=3, max_relaunches_per_size=1),
                                [(False, "fpA"), (False, "fpB"),
                                 (False, "fpC"), (True, None)]),
}


def _scripted(module, sup, script, calls):
    outcomes = iter(script)

    def run_generation(gen, world, resumed_from):
        calls.append((gen, world, resumed_from))
        ok, fp = next(outcomes)
        cls = None if ok else module.Classification(
            "transient", f"crash (rc=3): scripted {fp}", fingerprint=fp)
        return module.GenerationOutcome(
            gen=gen, nprocs=world, ok=ok, wall_s=0.0, pids=[],
            failed_rank=None if ok else world - 1, rc=None if ok else 3,
            classification=cls)

    sup._run_generation = run_generation


def _supervisor_events(stream: Path, reader) -> list:
    """(kind, payload) of each event but the spans, which are compared by
    name and status; the envelope and timestamps dropped."""
    out = []
    for ev in reader(stream):
        if ev["kind"] == "span":
            out.append(("span", ev["name"], ev.get("status")))
            continue
        out.append((ev["kind"], {k: v for k, v in ev.items()
                                 if k not in ENVELOPE}))
    return out


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_decisions_equal_the_jax_supervisors(tmp_path, name):
    over, script = POLICIES[name]
    env = {TRACE_ENV: "0123456789abcdef"}
    results, calls, events = {}, {}, {}
    for label, module, reader in (("port", fleetsup, read_events),
                                  ("jax", jax_fleetsup, jax_read_events)):
        cfg = module.FleetConfig(backoff_s=0.001, backoff_factor=1.0,
                                 max_backoff_s=0.001, **over)
        sup = module.FleetSupervisor(["true", "{rank}"], tmp_path / label,
                                     cfg=cfg, env=env)
        calls[label] = []
        _scripted(module, sup, script, calls[label])
        result = sup.run()
        results[label] = (result.ok, result.verdict, result.final_nprocs,
                          result.resized, result.n_generations,
                          result.trace_id,
                          [(g.gen, g.nprocs, g.ok, g.failed_rank)
                           for g in result.generations])
        events[label] = _supervisor_events(
            tmp_path / label / "supervisor" / "events.jsonl", reader)
    assert results["port"] == results["jax"]
    assert calls["port"] == calls["jax"]
    assert events["port"] == events["jax"]
    want = {"transient_then_ok": "completed",
            "same_fingerprint_resizes": "completed",
            "deterministic_at_the_floor": "deterministic",
            "generation_budget": "budget_exhausted",
            "relaunches_spent_at_the_floor": "retries_exhausted",
            "relaunches_spent_resize": "completed"}[name]
    assert results["port"][1] == want
    if name == "same_fingerprint_resizes":
        assert [c[1] for c in calls["port"]] == [4, 4, 3]


# ----------------------------------------------------- the pure functions


@pytest.mark.parametrize("bad,want", [
    # A rank killed by a signal and a survivor's collective error, seen in
    # one poll: the killed rank, whatever their numbers.
    ([(0, 1, "RuntimeError: [gloo/transport/tcp/pair.cc:534] Connection "
             "closed by peer"), (1, -9, "")], 1),
    # An error of a rank's own beside survivors' collective errors.
    ([(0, 1, "torch.distributed.DistBackendError: NCCL error"),
      (1, 1, "torch.distributed.DistBackendError: NCCL error"),
      (2, 1, "FaultInjected: injected crash at trainer.epoch_dispatched")], 2),
    # Two deaths by signal: the lowest rank.
    ([(3, -15, ""), (2, -9, "")], 2),
    # One rank alone.
    ([(1, 3, "RuntimeError: injected deterministic rank failure")], 1),
])
def test_the_root_cause_is_the_failed_rank(bad, want):
    assert fleetsup.root_cause(bad) == want


def test_a_dead_generations_heartbeat_does_not_count(tmp_path):
    old = tmp_path / "rank" / "telemetry"
    old.mkdir(parents=True)
    (old / "heartbeat.json").write_text(json.dumps(
        {"ts": 1000.0, "last_beat_ts": 999.0}))
    assert fleetsup.last_heartbeat_ts(tmp_path / "rank") == 999.0
    assert fleetsup.last_heartbeat_ts(tmp_path / "rank", since_ts=2000.0) is None
    (old / "heartbeat.json").write_text(json.dumps(
        {"ts": 2500.0, "last_beat_ts": 2400.0}))
    assert fleetsup.last_heartbeat_ts(tmp_path / "rank", since_ts=2000.0) == 2400.0


def test_placeholders_and_the_coordinators(tmp_path):
    subst = {"rank": 1, "world": 3, "coordinator": "file:///x", "gen": 2,
             "out": tmp_path / "o", "root": tmp_path}
    assert fleetsup._fill("+trainer.n_devices={world}", subst) == \
        "+trainer.n_devices=3"
    assert fleetsup._fill("{'a': {rank}}", subst) == "{'a': 1}"
    sup = fleetsup.FleetSupervisor(["true"], tmp_path / "run")
    stores = {sup._coordinator(g) for g in range(3)}
    assert len(stores) == 3 and all(s.startswith("file://") for s in stores)
    assert not sup._coordinator_up(sup._coordinator(0))


# ------------------------------------------------------------- processes


def _env() -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in (faults.FAULT_PLAN_ENV, faults.ATTEMPT_ENV)}
    env["PYTHONPATH"] = str(REPO)
    return env


def _worker_cmd(state: Path, epochs: int, *extra: str) -> list[str]:
    return [sys.executable, "-m", "masters_thesis_tpu_torch.resilience",
            "fleet-worker", "--state", str(state), "--out", "{out}",
            "--epochs", str(epochs), "--items", "64", "--sleep-s", "0.05",
            *extra]


def _cfg(**over) -> fleetsup.FleetConfig:
    kw = dict(nprocs=2, min_nprocs=1, max_relaunches_per_size=2,
              backoff_s=0.05, backoff_factor=1.0, term_grace_s=2.0,
              poll_interval_s=0.05, hang_timeout_s=60.0,
              max_generations=4)
    kw.update(over)
    return fleetsup.FleetConfig(**kw)


def _events(run_dir: Path) -> dict:
    by_kind: dict = {}
    for ev in read_events(run_dir / "supervisor" / "events.jsonl"):
        by_kind.setdefault(ev["kind"], []).append(ev)
    return by_kind


def _no_orphans(result) -> None:
    for gen in result.generations:
        for pid in gen.pids:
            with pytest.raises(ProcessLookupError):
                os.kill(pid, 0)


def _history(state: Path) -> list:
    return json.loads((state / "progress.json").read_text())["history"]


def _postmortems_agree(run_dir: Path) -> dict:
    now = time.time() + 3600.0
    ours = aggregate.postmortem_path(run_dir, now=now)
    theirs = jax_aggregate.postmortem_path(run_dir, now=now)
    assert json.dumps(ours, sort_keys=True, default=str) == \
        json.dumps(theirs, sort_keys=True, default=str)
    return ours


def test_a_killed_rank_relaunches_the_whole_fleet(tmp_path):
    epochs, state, run = 5, tmp_path / "state", tmp_path / "run"
    result = run_with_deadline(fleetsup.FleetSupervisor(
        _worker_cmd(state, epochs, "--crash-rank", "1", "--at", "1",
                    "--crash-kind", "kill"),
        run_dir=run, cfg=_cfg(), env=_env()), DEADLINE_S)
    assert result.ok and result.verdict == "completed"
    assert result.n_generations == 2 and not result.resized
    _no_orphans(result)
    history = _history(state)
    assert [e[3] for e in history] == list(range(epochs))
    # Generation 1 committed the rest (how much generation 0 committed
    # before the kill depends on the ranks' timing).
    assert {e[1] for e in history} <= {0, 1} and history[-1][1] == 1
    obj = json.loads((state / "progress.json").read_text())
    assert obj["value"] == _fleet_expected_value(epochs)
    by_kind = _events(run)
    fail = by_kind["fleet_failure"][0]
    assert (fail["rank"], fail["rc"], fail["classification"]) == \
        (1, 137, "transient")
    assert fail["lost_work_s"] >= 0 and fail["teardown_s"] >= 0
    assert by_kind["fleet_relaunch"][0]["gen"] == 1
    stores = [e["coordinator"] for e in by_kind["fleet_generation_started"]]
    assert len(set(stores)) == 2 and all("/rdzv/" in s for s in stores)
    g1 = read_events(next((run / "g1" / "p1").rglob("events.jsonl")))
    assert g1 and all(ev.get("generation") == 1 and ev["attempt"] == 2
                      for ev in g1)
    report = _postmortems_agree(run)
    assert report["exit_code"] == 0
    assert report["trace_ids"] == [result.trace_id]
    assert report["generations"] == 2


def test_a_wedged_heartbeat_restarts_the_fleet(tmp_path):
    state, run = tmp_path / "state", tmp_path / "run"
    faults.install_plan(faults.FaultPlan([faults.FaultSpec(
        point="fleet.rank_heartbeat", kind="wedge", attempt=None,
        match={"rank": 1, "gen": 0})]))
    try:
        result = run_with_deadline(fleetsup.FleetSupervisor(
            _worker_cmd(state, 4, "--sleep-s", "0.5"), run_dir=run,
            cfg=_cfg(hang_timeout_s=1.0), env=_env()), DEADLINE_S)
    finally:
        faults.clear_plan()
    assert result.ok and result.n_generations == 2
    _no_orphans(result)
    fail = _events(run)["fleet_failure"][0]
    assert fail["hang"] is True and fail["rank"] == 1 and fail["rc"] is None
    assert fail["classification"] == "transient"
    assert [e[3] for e in _history(state)] == list(range(4))


def test_a_deterministic_loss_resizes_four_to_three(tmp_path):
    epochs, state, run = 4, tmp_path / "state", tmp_path / "run"
    result = run_with_deadline(fleetsup.FleetSupervisor(
        _worker_cmd(state, epochs, "--crash-rank", "3", "--at", "1",
                    "--crash-mode", "always"),
        run_dir=run, cfg=_cfg(nprocs=4), env=_env()), DEADLINE_S)
    assert result.ok and result.resized
    assert result.final_nprocs == 3 and result.n_generations == 3
    _no_orphans(result)
    resized = _events(run)["fleet_resized"][0]
    assert (resized["from_nprocs"], resized["to_nprocs"]) == (4, 3)
    assert "deterministic" in resized["reason"] and resized["fingerprint"]
    lines = [list(map(int, ln.split()))
             for ln in (state / "shards.log").read_text().splitlines()]
    final = [ln for ln in lines if ln[0] == 2]
    assert {ln[1] for ln in final} == {3}
    assert sorted(i for ln in final for i in range(ln[3], ln[4])) == \
        list(range(64))
    assert [e[3] for e in _history(state)] == list(range(epochs))
    report = _postmortems_agree(run)
    assert report["exit_code"] == 0 and report["generations"] == 3
    assert len(report["resizes"]) == 1 and report["fleet_verdict"]["ok"]


def test_a_deterministic_loss_at_the_floor_halts(tmp_path):
    run = tmp_path / "run"
    result = run_with_deadline(fleetsup.FleetSupervisor(
        _worker_cmd(tmp_path / "state", 4, "--crash-rank", "1", "--at", "1",
                    "--crash-mode", "always"),
        run_dir=run, cfg=_cfg(min_nprocs=2), env=_env()), DEADLINE_S)
    assert not result.ok and result.verdict == "deterministic"
    assert result.n_generations == 2 and not result.resized
    _no_orphans(result)
    verdict = _events(run)["fleet_verdict"][-1]
    assert verdict["ok"] is False and verdict["verdict"] == "deterministic"
    report = _postmortems_agree(run)
    assert report["exit_code"] == 2
    assert any("DETERMINISTIC" in f for f in report["failures"])


def test_a_survivor_is_not_named_the_failed_rank(tmp_path):
    """Rank 1 is SIGKILLed and rank 0 exits 1 with a collective's error
    moments later, most often within the same slow poll (the lowest
    bad rank of a poll would be rank 0): rank 1 is the failed rank."""
    run = tmp_path / "run"
    result = run_with_deadline(fleetsup.FleetSupervisor(
        _worker_cmd(tmp_path / "state", 4, "--crash-rank", "1", "--at", "1",
                    "--crash-kind", "kill", "--peer-loss-exit"),
        run_dir=run, cfg=_cfg(poll_interval_s=0.5), env=_env()), DEADLINE_S)
    assert result.ok and result.n_generations == 2
    _no_orphans(result)
    gen0 = result.generations[0]
    assert (gen0.failed_rank, gen0.rc) == (1, 137)
    assert gen0.classification.kind == "transient"


def test_survivors_errors_do_not_hide_a_deterministic_loss(tmp_path):
    """Rank 2 fails with its own error in every generation, and the two
    survivors exit with collective errors that name them: the failed rank
    and its fingerprint are the same twice, so the fleet resizes 3 -> 2."""
    run = tmp_path / "run"
    result = run_with_deadline(fleetsup.FleetSupervisor(
        _worker_cmd(tmp_path / "state", 4, "--crash-rank", "2", "--at", "1",
                    "--crash-mode", "always", "--peer-loss-exit"),
        run_dir=run, cfg=_cfg(nprocs=3, poll_interval_s=0.5),
        env=_env()), DEADLINE_S)
    assert result.ok and result.resized and result.final_nprocs == 2
    failed = result.generations[:2]
    assert [g.failed_rank for g in failed] == [2, 2]
    assert failed[0].classification.fingerprint == \
        failed[1].classification.fingerprint
    _no_orphans(result)


def test_the_fleet_plane_serves_while_its_ranks_run(tmp_path):
    """FleetSupervisor(metrics_port=0) serves /healthz and /slo while its
    ranks run and stops the plane at the verdict; a plane that cannot
    start leaves the fleet alone."""
    seen: dict = {}
    sup = fleetsup.FleetSupervisor(
        [sys.executable, "-c", "import time; time.sleep(3)"],
        tmp_path / "run", cfg=_cfg(nprocs=1), env=_env(), metrics_port=0)

    def probe() -> None:
        deadline = time.monotonic() + 30.0
        while "slo" not in seen and time.monotonic() < deadline:
            server = sup._exposition
            if server is not None:
                try:
                    with urllib.request.urlopen(server.url + "/healthz",
                                                timeout=5) as r:
                        seen["healthz"] = r.status
                    with urllib.request.urlopen(server.url + "/slo",
                                                timeout=5) as r:
                        seen["slo"] = json.loads(r.read())
                except OSError:
                    pass
            time.sleep(0.05)

    prober = threading.Thread(target=probe, daemon=True)
    prober.start()
    result = run_with_deadline(sup, DEADLINE_S)
    prober.join(timeout=35.0)
    assert result.ok
    assert seen["healthz"] == 200
    assert set(seen["slo"]) >= {"ticks", "firing"}
    assert sup._exposition is None and sup._slo_engine is None
    assert "exposition_started" in _events(tmp_path / "run")
    bad = fleetsup.FleetSupervisor([sys.executable, "-c", "pass"],
                                   tmp_path / "run2", cfg=_cfg(nprocs=1),
                                   env=_env(), metrics_port=-5)
    assert run_with_deadline(bad, DEADLINE_S).ok


def test_the_fleet_command_line(tmp_path, capsys, monkeypatch):
    assert resilience_main(["fleet", "--selfcheck"]) == 0
    assert "fleet selfcheck: 2 scenarios OK" in capsys.readouterr().out
    assert resilience_main(["fleet", "--run-dir", str(tmp_path)]) == 2
    cmd = _worker_cmd(tmp_path / "state", 2, "--crash-rank", "1", "--at",
                      "0", "--crash-mode", "always")
    monkeypatch.setenv("PYTHONPATH", str(REPO))
    monkeypatch.delenv(faults.FAULT_PLAN_ENV, raising=False)
    code = resilience_main(["fleet", "--nprocs", "2", "--min-nprocs", "2",
                            "--backoff-s", "0.05", "--backoff-factor", "1",
                            "--poll-interval-s", "0.05", "--term-grace-s",
                            "2", "--hang-timeout-s", "60",
                            "--run-dir", str(tmp_path / "run"), "--",
                            *cmd])
    assert code == 2
    assert "verdict=deterministic generations=2" in capsys.readouterr().err
