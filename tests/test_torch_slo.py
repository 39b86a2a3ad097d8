"""The port's SLO plane against the JAX package's, on the CPU.

The port's ``telemetry/slo.py`` is a copy of the JAX module. Both engines
tail copies of the same event file (written with fixed timestamps) and are
driven by the same ``tick(now)`` calls, never by sleeping: every tick's
published state and every ``alert_fired`` / ``alert_resolved`` event they
write are equal, through burn, debounce, flapping, resolve, the quality and
training rules and the ``slo.evaluate`` wedge fault. ``read_new_lines``
gives the JAX reader's results on a torn tail, a corrupt line, a truncated
file and a missing one. ``/metrics`` (with the ``mtt_slo_*`` gauges),
``/healthz`` and ``/slo`` answer over a port bound as 0, and the trainer,
the server and the supervisor start and stop the plane.
"""

import copy
import json
import os
import subprocess
import sys
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from masters_thesis_tpu.resilience import faults as jax_faults
from masters_thesis_tpu.telemetry import events as jax_events
from masters_thesis_tpu.telemetry import exposition as jax_exposition
from masters_thesis_tpu.telemetry import slo as jax_slo
from masters_thesis_tpu_torch.resilience import faults
from masters_thesis_tpu_torch.telemetry import events, exposition, slo
from masters_thesis_tpu_torch.telemetry.events import read_events
from masters_thesis_tpu_torch.telemetry.run import TelemetryRun

REPO = Path(__file__).resolve().parent.parent
T0 = 1_000_000.0


@pytest.fixture(autouse=True)
def _no_leaked_faults(monkeypatch):
    monkeypatch.delenv(faults.FAULT_PLAN_ENV, raising=False)
    monkeypatch.delenv(faults.ATTEMPT_ENV, raising=False)
    yield
    faults.clear_plan()
    jax_faults.clear_plan()


# ------------------------------------------------------------- the math


@pytest.mark.parametrize("rate,target", [(0.0, 0.99), (0.01, 0.99),
                                         (0.5, 0.9), (0.2, 1.0), (0.0, 1.0)])
def test_burn_rate_equals_the_jax_function(rate, target):
    assert slo.burn_rate(rate, target) == jax_slo.burn_rate(rate, target)


def test_window_stats_and_default_rules_equal_the_jax_module():
    rng = np.random.default_rng(0)
    statuses = ["ok", "shed", "rejected_late", "error"]
    requests = [(T0 + float(t), statuses[int(s)], None if d < 0.1 else float(d))
                for t, s, d in zip(rng.uniform(0, 100, 300),
                                   rng.integers(0, 4, 300),
                                   rng.uniform(0, 0.5, 300))]
    for window in (1.0, 10.0, 60.0, 1000.0):
        assert (slo.window_stats(requests, T0 + 100.0, window)
                == jax_slo.window_stats(requests, T0 + 100.0, window))
    for name in ("default_serve_rules", "default_train_rules",
                 "default_quality_rules"):
        ours = [vars(r) for r in getattr(slo, name)()]
        theirs = [vars(r) for r in getattr(jax_slo, name)()]
        assert ours == theirs, name
    assert slo.RULE_KINDS == jax_slo.RULE_KINDS
    with pytest.raises(ValueError, match="unknown SLO rule kind"):
        slo.SLORule("x", "nope")
    with pytest.raises(ValueError, match="exceeds slow window"):
        slo.SLORule("x", "burn_rate", fast_window_s=10, slow_window_s=5)


# ------------------------------------------------------- the transitions


def _requests(t, n, status, dur_s=0.005):
    return [{"ts": t + 0.01 * i, "kind": "span", "name": "serve.request",
             "status": status, "dur_s": dur_s} for i in range(n)]


def _quality(t, n, shadow_err, input_psi=0.0):
    return [{"ts": t + 0.01 * i, "kind": "quality_sample", "scored": True,
             "input_psi": input_psi, "pred_psi": 0.0, "shadow_err": shadow_err}
            for i in range(n)]


def _epoch(t, wall_s, data_wait_s, compiles):
    return [{"ts": t, "kind": "epoch", "wall_s": wall_s,
             "data_wait_s": data_wait_s, "compile_events": compiles}]


def _scenario(name):
    """(rules factory args, steps): each step appends events, then ticks
    at ``now``; ``"wedge"`` / ``"unwedge"`` steps arm or clear the
    ``slo.evaluate`` fault before their tick."""
    if name == "burn":
        rules = [("burn", "burn_rate", dict(threshold=2.0, target=0.99,
                                            fast_window_s=10.0,
                                            slow_window_s=60.0))]
        return rules, [
            (_requests(T0, 40, "ok"), T0 + 1.0, None),
            (_requests(T0 + 1.0, 40, "shed"), T0 + 2.0, None),
            (_requests(T0 + 70.0, 100, "ok"), T0 + 71.0, None),
            ([], T0 + 71.5, None),
        ]
    if name == "debounce":
        rules = [("p99", "p99_latency", dict(threshold=0.01, for_ticks=2,
                                             fast_window_s=60.0,
                                             slow_window_s=60.0))]
        return rules, [(_requests(T0, 10, "ok", dur_s=0.5), T0 + 1.0, None),
                       ([], T0 + 2.0, None), ([], T0 + 3.0, None)]
    if name == "flapping":
        rules = [("shed", "shed_pct", dict(threshold=10.0, for_ticks=1,
                                           clear_ticks=2, fast_window_s=1.0,
                                           slow_window_s=1.0))]
        return rules, [
            (_requests(T0 + 1.5 * i, 10, "shed" if i % 2 == 0 else "ok"),
             T0 + 1.5 * i + 0.5, None) for i in range(10)]
    if name == "resolve":
        rules = [("burn", "burn_rate", dict(threshold=2.0, target=0.99,
                                            fast_window_s=5.0,
                                            slow_window_s=5.0, clear_ticks=2))]
        return rules, [(_requests(T0, 10, "shed"), T0 + 0.5, None),
                       ([], T0 + 10.0, None), ([], T0 + 11.0, None)]
    if name == "quality":
        rules = "default_quality_rules"
        return rules, [(_quality(T0, 10, 0.1), T0 + 1.0, None),
                       (_quality(T0 + 1.0, 30, 2.0, input_psi=0.9),
                        T0 + 2.0, None),
                       ([], T0 + 3.0, None),
                       (_quality(T0 + 400.0, 10, 0.1), T0 + 401.0, None),
                       ([], T0 + 402.0, None), ([], T0 + 403.0, None)]
    if name == "train":
        rules = "default_train_rules"
        return rules, [(_epoch(T0, 2.0, 0.1, 1), T0 + 1.0, None),
                       (_epoch(T0 + 2.0, 2.0, 1.5, 1), T0 + 3.0, None),
                       (_epoch(T0 + 4.0, 2.0, 1.5, 0), T0 + 5.0, None),
                       ([{"ts": T0 + 6.0, "kind": "run_finished",
                          "diverged": True}], T0 + 7.0, None)]
    assert name == "wedge"
    rules = [("div", "divergence", {})]
    return rules, [
        ([], T0 + 1.0, None),
        ([{"ts": T0 + 1.5, "kind": "run_finished", "diverged": True}],
         T0 + 2.0, "wedge"),
        ([], T0 + 3.0, "unwedge"),
    ]


def _run(module, sink_module, faults_module, root: Path, rules, steps,
         alerts: Path):
    if isinstance(rules, str):
        made = getattr(module, rules)(fast_window_s=60.0, slow_window_s=120.0)
    else:
        made = [module.SLORule(n, k, **kw) for n, k, kw in rules]
    sink = sink_module.EventSink(alerts, run_id="alerts")
    engine = module.SLOEngine(root, rules=made, sink=sink)
    stream = root / "events.jsonl"
    states = []
    for new, now, fault in steps:
        with open(stream, "a", encoding="utf-8") as f:
            for ev in new:
                f.write(json.dumps(ev) + "\n")
        if fault == "wedge":
            faults_module.install_plan(faults_module.FaultPlan.parse(json.dumps(
                {"faults": [{"point": "slo.evaluate", "kind": "wedge",
                             "attempt": None}]})))
        elif fault == "unwedge":
            faults_module.clear_plan()
        states.append(copy.deepcopy(engine.tick(now=now)))
    sink.close()
    envelope = {"ts", "run", "seq", "host", "pid", "proc", "nproc", "attempt",
                "generation"}
    emitted = [{k: v for k, v in e.items() if k not in envelope}
               for e in read_events(alerts)]
    return states, emitted


@pytest.mark.parametrize("name", ["burn", "debounce", "flapping", "resolve",
                                  "quality", "train", "wedge"])
def test_alert_transitions_equal_the_jax_engine(tmp_path, name):
    rules, steps = _scenario(name)
    runs = {}
    for side, module, sink_module, faults_module in (
            ("port", slo, events, faults),
            ("jax", jax_slo, jax_events, jax_faults)):
        root = tmp_path / side / "stream"
        root.mkdir(parents=True)
        runs[side] = _run(module, sink_module, faults_module, root, rules,
                          steps, tmp_path / side / "alerts.jsonl")
    assert runs["port"] == runs["jax"]
    states, emitted = runs["port"]
    kinds = [e["kind"] for e in emitted]
    firing = [s["firing"] for s in states]
    if name == "burn":
        assert firing == [[], ["burn"], ["burn"], []]
        assert kinds == ["alert_fired", "alert_resolved"]
    elif name == "debounce":
        assert firing == [[], ["p99"], ["p99"]]
    elif name == "flapping":
        assert all(f == ["shed"] for f in firing)
        assert kinds == ["alert_fired"]
    elif name == "resolve":
        assert firing == [["burn"], ["burn"], []]
        assert emitted[-1]["active_s"] == pytest.approx(10.5)
    elif name == "wedge":
        assert [s["ticks"] for s in states] == [1, 1, 2]
        assert firing == [[], [], ["div"]]
    else:
        assert "alert_fired" in kinds


# ------------------------------------------------------ read_new_lines


def _read_case(module, path: Path, case: str):
    reads = []
    if case == "torn_tail":
        path.write_bytes(b'{"kind": "a"}\n{"kind": "b"}\n{"kind": "c"')
        reads.append(module.read_new_lines(path, 0))
        reads.append(module.read_new_lines(path, reads[-1][1]))
        with path.open("ab") as f:
            f.write(b"}\n")
        reads.append(module.read_new_lines(path, reads[-1][1]))
    elif case == "corrupt":
        path.write_bytes(b'not json\n{"kind": "ok"}\n[1, 2]\n')
        reads.append(module.read_new_lines(path, 0))
        reads.append(module.read_new_lines(path, reads[-1][1]))
    elif case == "truncated":
        path.write_bytes(b'{"kind": "a"}\n' * 10)
        reads.append(module.read_new_lines(path, 0))
        path.write_bytes(b'{"kind": "fresh"}\n')
        reads.append(module.read_new_lines(path, reads[-1][1]))
    else:
        reads.append(module.read_new_lines(path.parent / "nope.jsonl", 5))
        reads.append(module.read_new_lines(path.parent / "nope.jsonl", -3))
    return reads


@pytest.mark.parametrize("case", ["torn_tail", "corrupt", "truncated",
                                  "missing"])
def test_read_new_lines_equals_the_jax_reader(tmp_path, case):
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got = _read_case(events, tmp_path / "port" / "events.jsonl", case)
    want = _read_case(jax_events, tmp_path / "jax" / "events.jsonl", case)
    assert got == want
    kinds = [[e["kind"] for e in evs] for evs, _ in got]
    if case == "torn_tail":
        # The torn line is not consumed until its newline lands.
        assert kinds == [["a", "b"], [], ["c"]]
        assert got[0][1] == got[1][1] < got[2][1]
    elif case == "corrupt":
        assert kinds == [["ok"], []]  # consumed once, never retried
    elif case == "truncated":
        assert kinds == [["a"] * 10, ["fresh"]]
    else:
        assert got == [([], 5), ([], 0)]


# ----------------------------------------------------------- exposition


def _snapshot():
    return {"tags": {"host": "h", "pid": 7}, "metrics": {
        "serve/requests": {"type": "counter", "value": 12},
        "quality/shadow_err": {"type": "gauge", "value": 0.25},
        "serve/latency_s": {"type": "histogram", "p50": 0.01, "p99": 0.04,
                            "sum": 1.5, "count": 30},
    }}


def test_render_prometheus_equals_the_jax_rendering():
    state = {"rules": {"burn": {"firing": True, "value": float("inf")},
                       "p99": {"firing": False, "value": 0.02},
                       "stale": {"firing": False, "value": None}}}
    for slo_state in (None, {}, state):
        assert (exposition.render_prometheus(_snapshot(), slo_state)
                == jax_exposition.render_prometheus(_snapshot(), slo_state))
    text = exposition.render_prometheus(_snapshot(), state)
    assert 'mtt_slo_firing{host="h",pid="7",rule="burn"} 1' in text
    assert 'mtt_slo_value{host="h",pid="7",rule="p99"} 0.02' in text


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.headers["Content-Type"], resp.read().decode()


def test_slo_metrics_and_healthz_answer_over_port_zero(tmp_path):
    """An engine ticked by hand behind attach_exposition on a port bound as
    0: /metrics carries the registry and the mtt_slo_* gauges, /healthz and
    /slo the firing list, an unknown route 404; the attach is an event."""
    tel = TelemetryRun(tmp_path / "run", run_id="serve")
    tel.counter("serve/requests").inc(3)
    engine = slo.SLOEngine(tel.run_dir, rules=[slo.SLORule("div", "divergence")],
                           sink=tel.sink)
    engine.tick(now=T0)
    server = exposition.attach_exposition(tel, port=0, slo=engine)
    try:
        assert server.port > 0
        ctype, text = _get(server.url + "/metrics")
        assert ctype.startswith("text/plain")
        assert "mtt_serve_requests" in text and "mtt_slo_firing" in text
        assert json.loads(_get(server.url + "/healthz")[1])["firing"] == []
        assert json.loads(_get(server.url + "/slo")[1])["ticks"] == 1
        engine._diverged = True
        engine.tick(now=T0 + 1.0)
        assert json.loads(_get(server.url + "/healthz")[1])["firing"] == ["div"]
        assert json.loads(_get(server.url + "/slo")[1])["firing"] == ["div"]
        assert 'rule="div"} 1' in _get(server.url + "/metrics")[1]
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(server.url + "/nope")
        assert err.value.code == 404
    finally:
        server.close()
        tel.close()
    started = [e for e in read_events(tel.run_dir / "events.jsonl")
               if e["kind"] == "exposition_started"]
    assert started and started[0]["port"] == server.port


def test_the_plane_starts_and_stops_with_its_owner(tmp_path):
    """start_telemetry_plane with no port starts nothing; with port 0 an
    engine over the given root and a server over the run's registry, both
    gone after stop_telemetry_plane (which runs a last tick)."""
    tel = TelemetryRun(tmp_path / "run", run_id="plane")
    assert exposition.start_telemetry_plane(tel, None) == (None, None)
    assert exposition.start_telemetry_plane(None, 0) == (None, None)
    server, engine = exposition.start_telemetry_plane(
        tel, 0, rules=slo.default_train_rules(), slo_interval_s=3600.0)
    url = server.url
    assert json.loads(_get(url + "/slo")[1])["ticks"] == 0  # no tick yet
    exposition.stop_telemetry_plane(server, engine)
    state = engine.state()
    assert state["ticks"] == 1
    assert sorted(state["rules"]) == sorted(
        r.name for r in slo.default_train_rules())
    with pytest.raises(OSError):
        _get(url + "/healthz")
    tel.close()


def test_trainer_and_server_start_the_plane(tmp_path):
    """A Trainer and a PredictServer given metrics_port=0 and telemetry
    start the plane with their default rules (the server's answers /slo
    while it runs) and stop it when they finish; with no port they start
    none."""
    from masters_thesis_tpu_torch.data.pipeline import (
        FinancialWindowDataModule,
        bootstrap_synthetic,
    )
    from masters_thesis_tpu_torch.models.objectives import ModelSpec
    from masters_thesis_tpu_torch.serve.engine import PredictEngine
    from masters_thesis_tpu_torch.serve.server import PredictServer
    from masters_thesis_tpu_torch.train.trainer import Trainer

    bootstrap_synthetic(tmp_path / "data", n_stocks=4, n_samples=600, seed=0)
    dm = FinancialWindowDataModule(tmp_path / "data", lookback_window=10,
                                   target_window=5, stride=15)
    spec = ModelSpec(objective="mse", hidden_size=4, num_layers=1)
    tel = TelemetryRun(tmp_path / "train", run_id="train")
    trainer = Trainer(max_epochs=1, device="cpu", telemetry=tel,
                      metrics_port=0, ckpt_dir=tmp_path / "ck")
    result = trainer.fit(spec, dm)
    tel.close()
    assert trainer._exposition is None and trainer._slo_engine is None
    kinds = [e["kind"] for e in read_events(tel.run_dir / "events.jsonl")]
    assert "exposition_started" in kinds
    engine = PredictEngine(spec, result.state, n_stocks=4, lookback=10,
                           device="cpu", buckets=(1,))
    for port in (0, None):
        stel = TelemetryRun(tmp_path / f"serve{port}", run_id="serve")
        server = PredictServer(engine, telemetry=stel, metrics_port=port)
        server.start()
        try:
            if port is None:
                assert server.metrics_url is None and server.slo_engine is None
            else:
                state = json.loads(_get(server.metrics_url + "/slo")[1])
                assert set(state) >= {"ticks", "firing"}
                assert _get(server.metrics_url + "/healthz")[0] == (
                    "application/json")
                assert server.slo_engine.rules == slo.default_serve_rules()
        finally:
            server.stop()
            stel.close()
        assert server.slo_engine is None


def test_supervisor_plane_watches_its_children(tmp_path):
    """RunSupervisor(metrics_port=0) starts the plane over the children's
    watch dir and stops it at the verdict; a plane that cannot start
    leaves the supervision alone."""
    from masters_thesis_tpu_torch.resilience.supervisor import (
        RunSupervisor,
        SupervisorConfig,
    )

    code = "print('child ok')"
    sup = RunSupervisor([sys.executable, "-c", code], tmp_path / "sup",
                        cfg=SupervisorConfig(max_retries=0),
                        watch_dir=tmp_path / "watch", metrics_port=0)
    result = sup.run()
    assert result.ok and sup._exposition is None and sup._slo_engine is None
    kinds = [e["kind"] for e in read_events(tmp_path / "sup" / "events.jsonl")]
    assert "exposition_started" in kinds
    bad = RunSupervisor([sys.executable, "-c", code], tmp_path / "sup2",
                        cfg=SupervisorConfig(max_retries=0),
                        metrics_port=-5)
    assert bad.run().ok


def test_telemetry_selfcheck_runs_the_quality_and_slo_fixtures():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "masters_thesis_tpu_torch.telemetry",
         "selfcheck"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "telemetry: selfcheck ok" in proc.stdout
    assert "quality selfcheck: all checks passed" in proc.stdout
    assert "slo selfcheck: ok" in proc.stdout
