"""The port's serving fleet on the CPU, held against the JAX package's.

- ``ReplicaRestartPolicy``: both packages' policies give the same verdicts
  on scripted fingerprints.
- The fake-engine scenarios of the JAX fleet's own tests run on both
  ``FleetServer``s; the tests assert their decisions (deaths, halts and
  their kind, generations, explicit statuses, re-dispatch, no late ``ok``),
  not their timing.
- The port's breaker rule: a trip kills the replica and a new generation
  serves; nothing degrades to the CPU.
- Real engines: a 2-replica fleet of the port's ``PredictEngine`` (and of
  its ``StackedPredictEngine``, R = 4 lanes) on the CPU, on weights carried
  over from JAX params, loses a replica under traffic; every ``ok`` answer
  is within 1e-5 abs of the JAX engine's and bit for bit the port's solo
  engine on the batch that carried it.
- SV306 on the CPU, the watch console and the autoscaling signals against
  the JAX package's on the same fixture, and the command lines.
"""

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masters_thesis_tpu.models.objectives import ModelSpec as JaxSpec
from masters_thesis_tpu.resilience import faults as jax_faults
from masters_thesis_tpu.resilience.supervisor import (
    ReplicaRestartPolicy as JaxPolicy,
)
from masters_thesis_tpu.serve.engine import PredictEngine as JaxEngine
from masters_thesis_tpu.serve.fleet import FleetServer as JaxFleet
from masters_thesis_tpu.serve.queue import MicroBatchQueue as JaxQueue
from masters_thesis_tpu.serve.queue import ServeRequest as JaxRequest
from masters_thesis_tpu.serve.stacked import StackedPredictEngine as JaxStacked
from masters_thesis_tpu.telemetry import signals as jax_signals
from masters_thesis_tpu.telemetry import watch as jax_watch
from masters_thesis_tpu_torch.models.convert import params_from_jax
from masters_thesis_tpu_torch.models.objectives import ModelSpec
from masters_thesis_tpu_torch.resilience import faults
from masters_thesis_tpu_torch.resilience.supervisor import ReplicaRestartPolicy
from masters_thesis_tpu_torch.serve import preflight
from masters_thesis_tpu_torch.serve.engine import PredictEngine
from masters_thesis_tpu_torch.serve.fleet import (
    STATE_LIVE,
    FleetServer,
    partition_devices,
)
from masters_thesis_tpu_torch.serve.queue import (
    STATUS_ERROR,
    STATUS_OK,
    STATUS_REJECTED_LATE,
    STATUS_SHED,
    MicroBatchQueue,
    ServeRequest,
)
from masters_thesis_tpu_torch.serve.stacked import StackedPredictEngine
from masters_thesis_tpu_torch.telemetry import signals, watch
from masters_thesis_tpu_torch.telemetry.events import read_events
from masters_thesis_tpu_torch.telemetry.run import TelemetryRun

REPO = Path(__file__).resolve().parent.parent
EXPLICIT = (STATUS_OK, STATUS_SHED, STATUS_REJECTED_LATE)
ATOL = 1e-5


@pytest.fixture(autouse=True)
def _no_leaked_faults(monkeypatch):
    """Every test starts and ends with injection off in both packages."""
    monkeypatch.delenv(faults.FAULT_PLAN_ENV, raising=False)
    monkeypatch.delenv(faults.ATTEMPT_ENV, raising=False)
    yield
    faults.clear_plan()
    jax_faults.clear_plan()


# ----------------------------------------------------------- restart policy

#: Scripted deaths: (replica, fingerprint), or ("healthy", replica).
SCRIPTS = {
    "same_twice_halts": [("r0", "a"), ("r0", "a")],
    "different_restarts": [("r0", "a"), ("r0", "b"), ("r0", "a")],
    "budget": [("r0", "a"), ("r0", "b"), ("r0", "c"), ("r0", "d")],
    "healthy_resets_chain": [("r0", "a"), ("healthy", "r0"), ("r0", "a"),
                             ("r0", "a")],
    "replicas_apart": [("r0", "a"), ("r1", "a"), ("r1", "b"), ("r0", "a")],
    "empty_fingerprint": [("r0", ""), ("r0", "")],
    "backoff_capped": [(f"r0", str(i)) for i in range(8)],
}


def _verdicts(policy, script):
    out = []
    for who, what in script:
        if who == "healthy":
            policy.note_healthy(what)
            continue
        v = policy.classify(who, what, detail=f"death {what}")
        out.append((v.action, v.kind, v.backoff_s, v.detail,
                    policy.restarts(who)))
    return out


@pytest.mark.parametrize("kw", [{}, {"max_restarts": 6, "backoff_s": 0.5}],
                         ids=["defaults", "wide"])
@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_restart_policy_matches_jax(name, kw):
    assert (_verdicts(ReplicaRestartPolicy(**kw), SCRIPTS[name])
            == _verdicts(JaxPolicy(**kw), SCRIPTS[name]))


def test_restart_policy_defaults_are_jax():
    port, ref = ReplicaRestartPolicy(), JaxPolicy()
    for key in ("max_restarts", "backoff_s", "backoff_factor",
                "max_backoff_s"):
        assert getattr(port, key) == getattr(ref, key)


# ------------------------------------------------------ fake-engine fleets


class FakeEngine:
    """The engine protocol with a fixed service time (the JAX fleet tests'
    stand-in)."""

    def __init__(self, service_s: float = 0.001, buckets=(1, 2, 4)):
        self.service_s = service_s
        self.buckets = tuple(buckets)
        self.window_shape = (2, 3, 1)
        self.max_bucket = self.buckets[-1]
        self.compile_events = len(self.buckets)
        self.cache_hits = 0
        self.platform = "fake"
        self.fail_next = 0

    def warmup(self) -> float:
        return self.service_s

    def predict(self, x, params=None):
        time.sleep(self.service_s)
        if self.fail_next > 0:
            self.fail_next -= 1
            raise RuntimeError("scripted device failure")
        n, k = x.shape[0], self.window_shape[0]
        return np.zeros((n, k), np.float32), np.zeros((n, k), np.float32)

    def degrade_to_cpu(self) -> None:
        pass


class Impl:
    def __init__(self, name):
        self.name = name
        self.port = name == "port"
        self.fleet_cls = FleetServer if self.port else JaxFleet
        self.policy = ReplicaRestartPolicy if self.port else JaxPolicy
        self.faults = faults if self.port else jax_faults

    def fleet(self, n=3, service_s=0.001, **kw):
        kw.setdefault("max_wait_s", 0.002)
        kw.setdefault("restart_policy", self.policy(backoff_s=0.01))
        if not isinstance(service_s, (list, tuple)):
            service_s = [service_s] * n
        factories = {f"r{i}": (lambda s=s: FakeEngine(service_s=s))
                     for i, s in enumerate(service_s)}
        return self.fleet_cls(factories, **kw)

    def plan(self, point, kind, attempt=1, **match):
        f = self.faults
        self.faults.install_plan(f.FaultPlan(faults=[f.FaultSpec(
            point=point, kind=kind, attempt=attempt, match=match)]))

    def clear(self):
        self.faults.clear_plan()


def _window():
    return np.zeros((2, 3, 1), np.float32)


def _wait_for(cond, timeout=8.0, period=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(period)
    return False


def _serve_across_replicas(impl):
    fleet = impl.fleet(n=3)
    fleet.start()
    try:
        pend = [fleet.submit(_window(), deadline_s=5.0) for _ in range(40)]
        results = [p.result(timeout=10.0) for p in pend]
    finally:
        stats = fleet.stop()
    assert all(r.status == STATUS_OK for r in results)
    assert stats["late_deliveries"] == 0
    # stop() drains: draining, not dead, means alive to the end.
    assert all(r["state"] == "draining" for r in stats["replicas"].values())
    assert sum(r["completed"] for r in stats["replicas"].values()) == 40


def _least_loaded_prefers_fast(impl):
    fleet = impl.fleet(n=2, service_s=[0.05, 0.001])
    fleet.start()
    try:
        pend = [fleet.submit(_window(), deadline_s=5.0) for _ in range(30)]
        assert all(p.result(timeout=10.0).status == STATUS_OK for p in pend)
    finally:
        stats = fleet.stop()
    assert (stats["replicas"]["r1"]["completed"]
            > stats["replicas"]["r0"]["completed"])


def _admission_by_best_replica(impl):
    slow_only = impl.fleet(n=1, service_s=[0.2])
    slow_only.start()
    try:
        r = slow_only.submit(_window(), deadline_s=0.05).result(timeout=5.0)
    finally:
        slow_only.stop()
    assert r.status == STATUS_SHED
    mixed = impl.fleet(n=2, service_s=[0.2, 0.001])
    mixed.start()
    try:
        results = [mixed.submit(_window(), deadline_s=0.05).result(timeout=5.0)
                   for _ in range(10)]
    finally:
        stats = mixed.stop()
    assert all(r.status == STATUS_OK for r in results)
    assert stats["replicas"]["r1"]["completed"] == 10


def _shed_with_reason(impl):
    queue_cls = MicroBatchQueue if impl.port else JaxQueue
    request_cls = ServeRequest if impl.port else JaxRequest
    q = queue_cls(feasibility=lambda req, depth: "too slow today")
    pending = q.submit(request_cls(rid=1, x=None,
                                   deadline_ts=time.monotonic() + 1.0))
    assert pending.done
    response = pending.result(timeout=1.0)
    assert response.status == STATUS_SHED
    assert "too slow today" in response.detail
    q.close()


def _crash_redispatch_restart(impl):
    # The restart's backoff outlasts the plan, so that generation 2 serves.
    fleet = impl.fleet(n=2, restart_policy=impl.policy(backoff_s=0.2))
    fleet.start()
    try:
        impl.plan("serve.replica_dispatch", "raise", replica="r0")
        pend = [fleet.submit(_window(), deadline_s=5.0) for _ in range(30)]
        assert _wait_for(lambda: fleet.deaths >= 1, period=0.001)
        impl.clear()
        results = [p.result(timeout=10.0) for p in pend]
        assert all(r.status in EXPLICIT for r in results)
        assert _wait_for(lambda: fleet.replicas["r0"].generation >= 2)
        assert _wait_for(lambda: fleet.replicas["r0"].state == "live")
    finally:
        stats = fleet.stop()
    assert stats["deaths"] == 1
    assert stats["late_deliveries"] == 0
    assert stats["replicas"]["r0"]["restarts"] == 1
    assert stats["replicas"]["r1"]["generation"] == 1


def _hang_watchdog(impl):
    fleet = impl.fleet(n=2, hang_timeout_s=0.3,
                       restart_policy=impl.policy(backoff_s=0.2))
    fleet.start()
    try:
        impl.plan("serve.replica_dispatch", "hang", replica="r1")
        pend = [fleet.submit(_window(), deadline_s=5.0) for _ in range(20)]
        assert _wait_for(lambda: fleet.deaths >= 1, period=0.001)
        impl.clear()
        assert all(p.result(timeout=10.0).status in EXPLICIT for p in pend)
        assert _wait_for(lambda: fleet.replicas["r1"].generation >= 2)
    finally:
        stats = fleet.stop()
    assert stats["deaths"] >= 1 and stats["late_deliveries"] == 0
    assert stats["replicas"]["r0"]["generation"] == 1


def _identical_crash_halts(impl):
    fleet = impl.fleet(n=2)
    fleet.start()
    try:
        impl.plan("serve.replica_dispatch", "raise", attempt=None,
                  replica="r0")
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and not fleet.replicas["r0"].halted:
            fleet.submit(_window(), deadline_s=2.0).result(timeout=5.0)
        assert fleet.replicas["r0"].halted
        impl.clear()
        r = fleet.submit(_window(), deadline_s=5.0).result(timeout=5.0)
        assert r.status == STATUS_OK  # the survivor serves after the halt
    finally:
        stats = fleet.stop()
    assert fleet.replicas["r0"].state == "dead"
    assert stats["deaths"] == 2
    assert stats["replicas"]["r0"]["generation"] == 2
    assert stats["replicas"]["r1"]["state"] in ("live", "draining")


def _all_dead_sheds(impl):
    fleet = impl.fleet(n=1, restart_policy=impl.policy(max_restarts=0))
    fleet.start()
    try:
        impl.plan("serve.replica_dispatch", "raise", replica="r0")
        fleet.submit(_window(), deadline_s=2.0).result(timeout=5.0)
        assert _wait_for(lambda: fleet.replicas["r0"].halted)
        impl.clear()
        r = fleet.submit(_window(), deadline_s=2.0).result(timeout=5.0)
    finally:
        stats = fleet.stop()
    assert r.status == STATUS_SHED and "no live replicas" in r.detail
    assert stats["shed_by_reason"].get("no_live_replicas", 0) >= 1


def _corruption_errors_replica_live(impl):
    fleet = impl.fleet(n=2)
    fleet.start()
    try:
        impl.plan("serve.replica_dispatch", "nan")
        poisoned = fleet.submit(_window(), deadline_s=5.0).result(timeout=5.0)
        impl.clear()
        clean = [fleet.submit(_window(), deadline_s=5.0).result(timeout=5.0)
                 for _ in range(6)]
    finally:
        stats = fleet.stop()
    assert poisoned.status == STATUS_ERROR
    assert all(r.status == STATUS_OK for r in clean)
    assert stats["deaths"] == 0 and stats["errors"] >= 1


def _boot_fault_then_retry(impl):
    fleet = impl.fleet(n=2)
    impl.plan("serve.replica_boot", "wedge", replica="r0", generation=1)
    try:
        fleet.start()  # the first boot retries inline after the wedge
        impl.clear()
        assert fleet.replicas["r0"].state == "live"
        assert fleet.replicas["r0"].generation == 2
        r = fleet.submit(_window(), deadline_s=5.0).result(timeout=5.0)
    finally:
        fleet.stop()
    assert r.status == STATUS_OK


SCENARIOS = {
    "serve_across_replicas": _serve_across_replicas,
    "least_loaded_prefers_fast": _least_loaded_prefers_fast,
    "admission_by_best_replica": _admission_by_best_replica,
    "shed_with_reason": _shed_with_reason,
    "crash_redispatch_restart": _crash_redispatch_restart,
    "hang_watchdog": _hang_watchdog,
    "identical_crash_halts": _identical_crash_halts,
    "all_dead_sheds": _all_dead_sheds,
    "corruption_errors_replica_live": _corruption_errors_replica_live,
    "boot_fault_then_retry": _boot_fault_then_retry,
}


@pytest.mark.parametrize("impl", ["jax", "port"])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_fleet_scenario_decisions(scenario, impl):
    SCENARIOS[scenario](Impl(impl))


def test_a_stale_forecast_admits_a_probe_to_the_stale_replica(monkeypatch):
    """The port's queue rule, in the fleet's hook: at an empty queue a
    request every replica's estimate would shed is admitted as a probe
    when a replica's forecast has gone stale, served by that replica, and
    its measurement replaces the forecast."""
    fleet = Impl("port").fleet(n=2)
    fleet.start()
    try:
        for r in fleet.replicas.values():
            r.service_model.seed(10.0)  # every estimate misses 1 s
        assert fleet.submit(_window(), deadline_s=1.0).result(
            timeout=5.0).status == STATUS_SHED
        stale = fleet.replicas["r1"].service_model
        monkeypatch.setattr(stale, "_updated_ts", time.monotonic() - 5.0)
        r = fleet.submit(_window(), deadline_s=1.0).result(timeout=5.0)
    finally:
        stats = fleet.stop()
    assert r.status == STATUS_OK
    assert stats["replicas"]["r1"]["completed"] == 1
    assert stats["replicas"]["r1"]["batch_ms"] < 1000.0
    assert stats["replicas"]["r0"]["batch_ms"] == 10000.0


def test_a_breaker_trip_kills_the_replica_and_a_new_generation_serves(
        tmp_path):
    """The port's rule: a tripped breaker is a death (cause ``breaker``),
    the restart boots the factory again (the same device), and nothing
    degrades or lands on the CPU."""
    built = []

    def factory():
        engine = FakeEngine()
        engine.platform = "gpu"
        engine.device = "cuda:0"
        engine.fail_next = 2 if not built else 0
        built.append(engine)
        return engine

    tel = TelemetryRun(tmp_path, run_id="breaker")
    fleet = FleetServer({"r0": factory}, telemetry=tel, breaker_threshold=2,
                        max_wait_s=0.001,
                        restart_policy=ReplicaRestartPolicy(backoff_s=0.01))
    fleet.start()
    try:
        failed = [fleet.submit(_window(), deadline_s=5.0).result(timeout=5.0)
                  for _ in range(2)]
        assert _wait_for(lambda: fleet.replicas["r0"].generation == 2
                         and fleet.replicas["r0"].state == STATE_LIVE)
        ok = fleet.submit(_window(), deadline_s=5.0).result(timeout=5.0)
    finally:
        stats = fleet.stop()
        tel.close()
    assert [r.status for r in failed] == [STATUS_ERROR] * 2
    assert ok.status == STATUS_OK
    assert stats["degradations"] == 0 and stats["deaths"] == 1
    assert len(built) == 2 and {e.device for e in built} == {"cuda:0"}
    events = read_events(tmp_path / "events.jsonl")
    dead = [e for e in events if e["kind"] == "replica_dead"]
    assert [(e["cause"], e["replica_gen"]) for e in dead] == [("breaker", 1)]
    started = [e for e in events if e["kind"] == "replica_started"]
    assert [(e["replica_gen"], e["restart"]) for e in started] == [
        (1, False), (2, True)]
    assert not [e for e in events if e["kind"] == "degradation"]
    assert all(e.get("platform") != "cpu" for e in events)


def _breaker_fleet(tmp_path, health, name):
    """Two fake replicas, ``r0``'s first engine failing its first two
    dispatches (a breaker of 2), ``health`` probing after the trip."""
    built = []

    def failing_first():
        engine = FakeEngine()
        engine.fail_next = 2 if not built else 0
        built.append(engine)
        return engine

    tel = TelemetryRun(tmp_path, run_id=name)
    fleet = FleetServer({"r0": failing_first, "r1": FakeEngine},
                        telemetry=tel, breaker_threshold=2, max_wait_s=0.001,
                        health=health,
                        restart_policy=ReplicaRestartPolicy(backoff_s=0.01))
    return fleet, tel, built


def _fail_r0_twice(fleet):
    """Two dispatches on r0 alone (r1 is made to look busy)."""
    fleet.replicas["r1"].service_model.seed(60.0)
    return [fleet.submit(_window(), deadline_s=600.0).result(timeout=10.0)
            for _ in range(2)]


def test_a_failed_probe_halts_the_replica_as_device_lost(tmp_path):
    """A trip whose probe fails: one ``degradation`` (``fallback: null``),
    the replica dead with cause ``device_lost`` and halted, never restarted
    onto the lost card; the survivor serves; no CPU engine is built."""
    from masters_thesis_tpu_torch.serve.__main__ import _StubHealth

    health = _StubHealth(ok=False)
    fleet, tel, built = _breaker_fleet(tmp_path, health, "device-lost")
    fleet.start()
    try:
        failed = _fail_r0_twice(fleet)
        assert _wait_for(lambda: fleet.replicas["r0"].halted)
        fleet.replicas["r1"].service_model.seed(0.001)
        ok = fleet.submit(_window(), deadline_s=5.0).result(timeout=5.0)
        time.sleep(0.1)  # a restart, were one scheduled, would land here
    finally:
        stats = fleet.stop()
        tel.close()
    assert [r.status for r in failed] == [STATUS_ERROR] * 2
    assert ok.status == STATUS_OK and health.calls == 1
    assert stats["degradations"] == 1 and stats["deaths"] == 1
    assert stats["replicas"]["r0"]["generation"] == 1 and len(built) == 1
    events = read_events(tmp_path / "events.jsonl")
    [degradation] = [e for e in events if e["kind"] == "degradation"]
    assert degradation["fallback"] is None and degradation["replica"] == "r0"
    assert degradation["probe_attempts"] == 1
    assert degradation["scope"] == "serve"
    dead = [(e["replica"], e["cause"]) for e in events
            if e["kind"] == "replica_dead"]
    assert dead == [("r0", "device_lost")]
    halted = [e for e in events if e["kind"] == "replica_halted"]
    assert [(e["replica"], e["verdict"]) for e in halted] == [
        ("r0", "device_lost")]
    assert not [e for e in events if e["kind"] == "replica_restart_scheduled"]


def test_a_probe_that_answers_keeps_the_kill_and_restart_rule(tmp_path):
    from masters_thesis_tpu_torch.serve.__main__ import _StubHealth

    health = _StubHealth(ok=True)
    fleet, tel, built = _breaker_fleet(tmp_path, health, "probe-ok")
    fleet.start()
    try:
        _fail_r0_twice(fleet)
        assert _wait_for(lambda: fleet.replicas["r0"].generation == 2
                         and fleet.replicas["r0"].state == STATE_LIVE)
    finally:
        stats = fleet.stop()
        tel.close()
    assert health.calls == 1 and stats["degradations"] == 0
    events = read_events(tmp_path / "events.jsonl")
    assert [(e["replica"], e["attempts"]) for e in events
            if e["kind"] == "breaker_probe_ok"] == [("r0", 1)]
    assert [e["cause"] for e in events if e["kind"] == "replica_dead"] == [
        "breaker"]


def test_partition_devices_keeps_the_jax_rule():
    devices = [torch.device("cpu")] * 4
    groups = partition_devices(2, devices)
    assert [len(g) for g in groups] == [2, 2]
    assert len(partition_devices(4, devices)) == 4
    with pytest.raises(ValueError, match="cannot build 5 replicas"):
        partition_devices(5, devices)
    with pytest.raises(ValueError):
        partition_devices(0, devices)


# ------------------------------------------------------------ real engines

K, T, F, H = 5, 8, 3, 16
BUCKETS = (1, 2, 4)
LANES = 4


class _Recording:
    """An engine that keeps each batch it answered, with its answers."""

    def __init__(self, engine, log):
        self._engine = engine
        self._log = log

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def predict(self, x, params=None):
        out = self._engine.predict(x)
        self._log.append((np.array(x), out))
        return out


def _carrier(log, window):
    """The recorded batch that carried ``window``, and its row."""
    for x, out in log:
        for i in range(len(x)):
            if np.array_equal(x[i], window):
                return x, i, out
    raise AssertionError("no recorded batch carried the window")


def _kill_r0_under_traffic(factories, windows, deadline_s=30.0):
    fleet = FleetServer(factories, max_wait_s=0.002, hang_timeout_s=30.0,
                        restart_policy=ReplicaRestartPolicy(backoff_s=0.01))
    fleet.start()
    faults.install_plan(faults.FaultPlan(faults=[faults.FaultSpec(
        point="serve.replica_dispatch", kind="raise", attempt=1,
        match={"replica": "r0"})]))
    try:
        pend = [fleet.submit(w, deadline_s=deadline_s) for w in windows]
        results = [p.result(timeout=120.0) for p in pend]
        assert _wait_for(lambda: fleet.replicas["r0"].generation >= 2,
                         timeout=60.0)
    finally:
        faults.clear_plan()
        stats = fleet.stop()
    return results, stats


@pytest.fixture(scope="module")
def jax_params():
    spec = JaxSpec(objective="mse", hidden_size=H, num_layers=2, dropout=0.0)
    trees = [spec.build_module().init(jax.random.key(seed),
                                      jnp.zeros((1, T, F), jnp.float32))
             ["params"] for seed in range(LANES)]
    return spec, trees


def _port_spec():
    return ModelSpec(objective="mse", hidden_size=H, num_layers=2,
                     dropout=0.0)


def _windows(n, seed):
    return np.random.default_rng(seed).normal(
        size=(n, K, T, F)).astype(np.float32)


def test_real_engine_fleet_answers_match_jax_and_the_solo_engine(jax_params):
    spec, trees = jax_params
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, trees[0]))
    log: list = []

    def factory():
        return _Recording(PredictEngine(_port_spec(), state, n_stocks=K,
                                        lookback=T, n_features=F,
                                        buckets=BUCKETS, device="cpu"), log)

    windows = _windows(24, seed=3)
    results, stats = _kill_r0_under_traffic({"r0": factory, "r1": factory},
                                            windows)
    assert stats["deaths"] == 1 and stats["late_deliveries"] == 0
    assert stats["redispatched"] >= 1
    assert [r.status for r in results] == [STATUS_OK] * len(windows)
    solo = PredictEngine(_port_spec(), state, n_stocks=K, lookback=T,
                         n_features=F, buckets=BUCKETS, device="cpu")
    jax_engine = JaxEngine(spec, trees[0], n_stocks=K, lookback=T,
                           n_features=F, buckets=BUCKETS)
    jax_engine.warmup()
    for w, r in zip(windows, results):
        x, i, out = _carrier(log, w)
        want = solo.predict(x)
        for got, served, alone in zip(r.outputs, out, want):
            np.testing.assert_array_equal(got, served[i])
            np.testing.assert_array_equal(got, alone[i])
        ref = jax_engine.predict(w[None])
        for got, want_ref in zip(r.outputs, ref):
            np.testing.assert_allclose(got, want_ref[0], atol=ATOL, rtol=0)


@pytest.mark.parametrize("cause", ["crash", "breaker"])
def test_a_killed_replica_restarts_warm_from_the_shared_cache(
        jax_params, tmp_path, cause):
    """Factories on one ``ProgramCache``: the dead replica's engine is
    closed into it, and generation 2 boots with one hit a bucket and no
    program made (``replica_started`` says so); its answers are the solo
    engine's bit for bit."""
    from masters_thesis_tpu_torch.serve.program_cache import ProgramCache

    spec, trees = jax_params
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, trees[0]))
    cache = ProgramCache()
    engines = []

    def factory():
        engine = PredictEngine(_port_spec(), state, n_stocks=K, lookback=T,
                               n_features=F, buckets=BUCKETS, device="cpu",
                               program_cache=cache)
        engines.append(engine)
        return engine

    tel = TelemetryRun(tmp_path, run_id=f"warm-{cause}")
    fleet = FleetServer({"r0": factory, "r1": factory}, telemetry=tel,
                        max_wait_s=0.002, breaker_threshold=1,
                        hang_timeout_s=30.0,
                        restart_policy=ReplicaRestartPolicy(backoff_s=0.01))
    fleet.start()
    kind = {"crash": "raise", "breaker": "wedge"}[cause]
    faults.install_plan(faults.FaultPlan(faults=[faults.FaultSpec(
        point="serve.replica_dispatch", kind=kind, attempt=1,
        match={"replica": "r0"})]))
    windows = _windows(12, seed=5)
    try:
        fleet.replicas["r1"].service_model.seed(60.0)  # r0 takes the batch
        fleet.submit(windows[0], deadline_s=600.0).result(timeout=60.0)
        assert _wait_for(lambda: fleet.replicas["r0"].state == "dead")
        faults.clear_plan()
        fleet.replicas["r1"].service_model.seed(0.001)
        assert _wait_for(lambda: fleet.replicas["r0"].live_generation == 2,
                         timeout=30.0)
        results = [fleet.submit(w, deadline_s=30.0) for w in windows]
        results = [p.result(timeout=60.0) for p in results]
        r0 = fleet.replicas["r0"].engine
        got = r0.predict(windows[:4])
    finally:
        faults.clear_plan()
        stats = fleet.stop()
        tel.close()
    assert stats["deaths"] == 1 and stats["late_deliveries"] == 0
    assert [r.status for r in results] == [STATUS_OK] * len(windows)
    assert (r0.cache_hits, r0.programs_made, r0.compile_events) == (
        len(BUCKETS), 0, 0)
    assert len(engines) == 3 and engines[0]._closed
    events = read_events(tmp_path / "events.jsonl")
    started = [(e["replica"], e["replica_gen"], e["cache_hits"])
               for e in events if e["kind"] == "replica_started"]
    assert ("r0", 2, len(BUCKETS)) in started
    assert [e["cause"] for e in events if e["kind"] == "replica_dead"] == [
        cause]
    solo = PredictEngine(_port_spec(), state, n_stocks=K, lookback=T,
                         n_features=F, buckets=BUCKETS, device="cpu")
    for g, w in zip(got, solo.predict(windows[:4])):
        np.testing.assert_array_equal(g, w)


def test_a_hung_replica_gives_nothing_back():
    """A hang death closes nothing into the cache: its dispatch may still
    be on the device."""
    closed = []

    class Closing(FakeEngine):
        def close(self):
            closed.append(self)

    fleet = FleetServer({"r0": Closing}, max_wait_s=0.001,
                        hang_timeout_s=0.2,
                        restart_policy=ReplicaRestartPolicy(backoff_s=0.01))
    fleet.start()
    faults.install_plan(faults.FaultPlan(faults=[faults.FaultSpec(
        point="serve.replica_dispatch", kind="hang", attempt=1,
        match={"replica": "r0", "seq": 0})]))
    try:
        fleet.submit(_window(), deadline_s=5.0)
        assert _wait_for(lambda: fleet.deaths >= 1)
        # The next generation's worker is the one stop() joins.
        assert _wait_for(lambda: fleet.replicas["r0"].live_generation >= 2)
    finally:
        faults.clear_plan()
        fleet.stop()
    assert closed == []


def test_stacked_fleet_replica_kill_zero_late(jax_params):
    """The counterpart of the JAX ``test_stacked_fleet_replica_kill_zero_
    late``: two replicas of R = 4 lanes, one crashed under traffic; every
    request resolves explicitly, none late, ``(R, K)`` answers whose lanes
    are the solo stacked engine's bit for bit and the JAX stacked engine's
    within 1e-5."""
    _, trees = jax_params
    jspec = JaxSpec(objective="mse", hidden_size=H, num_layers=2,
                    dropout=0.0, kernel_impl="xla")
    states = [params_from_jax(jax.tree_util.tree_map(np.asarray, t))
              for t in trees]
    log: list = []

    def stacked():
        return StackedPredictEngine(_port_spec(), states, n_stocks=K,
                                    lookback=T, n_features=F,
                                    buckets=(1, 2), device="cpu")

    windows = _windows(30, seed=5)
    results, stats = _kill_r0_under_traffic(
        {"r0": lambda: _Recording(stacked(), log),
         "r1": lambda: _Recording(stacked(), log)}, windows)
    assert all(r.status in EXPLICIT for r in results)
    ok = [(w, r) for w, r in zip(windows, results) if r.status == STATUS_OK]
    assert ok and all(r.outputs[0].shape == (LANES, K) for _, r in ok)
    assert stats["deaths"] >= 1 and stats["late_deliveries"] == 0
    assert stats["lanes"] == LANES
    solo = stacked()
    jax_engine = JaxStacked(jspec, trees, n_stocks=K, lookback=T,
                            n_features=F, buckets=(1, 2))
    jax_engine.warmup()
    for w, r in ok:
        x, i, _ = _carrier(log, w)
        want = solo.predict(x)
        ref = jax_engine.predict(w[None])
        for got, alone, want_ref in zip(r.outputs, want, ref):
            np.testing.assert_array_equal(got, alone[i])
            np.testing.assert_allclose(got, want_ref[0], atol=ATOL, rtol=0)


def test_sv306_is_clean_on_the_cpu():
    facts: dict = {}
    spec = preflight._preflight_spec()
    assert preflight._fleet(spec, torch.device("cpu"), facts) == []
    fleet = facts["fleet"]
    assert fleet["deaths"] >= 1 and fleet["unresolved"] == 0
    assert fleet["late_deliveries"] == 0 and fleet["survivors"]
    assert fleet["replicas"]["r0"]["generation"] >= 2


def test_sv306_kills_the_victim_after_a_slow_warmup(monkeypatch):
    # The victim's forecast is seeded from its warm-up batch: one slow run
    # there must not keep it idle (no death, no failover tested) while the
    # other replica takes every batch.
    warmup = PredictEngine.warmup
    built = []

    def slow_first(engine):
        built.append(engine)
        warm_s = warmup(engine)
        return 10.0 if len(built) == 1 else warm_s

    monkeypatch.setattr(PredictEngine, "warmup", slow_first)
    facts: dict = {}
    spec = preflight._preflight_spec()
    assert preflight._fleet(spec, torch.device("cpu"), facts) == []
    assert facts["fleet"]["deaths"] >= 1
    assert facts["fleet"]["replicas"]["r0"]["generation"] >= 2


def test_sv306_waits_for_the_victims_own_restart():
    # A second generation that is still booting is no restart, whatever
    # other replicas did meanwhile (here: the fleet counts two deaths).
    from types import SimpleNamespace

    booting = SimpleNamespace(generation=2, live_generation=1, state="dead")
    fleet = SimpleNamespace(replicas={"r0": booting}, deaths=2)
    assert not preflight._wait_restart(fleet, "r0", timeout_s=0.05)
    booting.live_generation = 2  # it came up live, then died again
    assert preflight._wait_restart(fleet, "r0", timeout_s=0.05)


# ------------------------------------------------- watch console, signals


def _fixture(tmp_path):
    from test_slo_plane import _fleet_fixture

    return _fleet_fixture(tmp_path)


def _add_fleet_events(root: Path) -> None:
    """Replica lifecycle events and a ``fleet_finished`` in the serving
    rank's stream (the fleet's own kinds)."""
    now = time.time()
    rows = [
        {"kind": "replica_started", "replica": "r0", "replica_gen": 1,
         "restart": False},
        {"kind": "replica_started", "replica": "r1", "replica_gen": 1,
         "restart": False},
        {"kind": "replica_dead", "replica": "r0", "replica_gen": 1,
         "cause": "crash"},
        {"kind": "replica_started", "replica": "r0", "replica_gen": 2,
         "restart": True},
        {"kind": "fleet_finished", "n_live": 2,
         "replicas": {"r0": {"batch_ms": 2.5}, "r1": {"batch_ms": 3.0}}},
    ]
    with (root / "p0" / "events.jsonl").open("a") as fh:
        for i, row in enumerate(rows):
            fh.write(json.dumps({"ts": now - 1.0 + 0.01 * i, **row}) + "\n")


@pytest.mark.parametrize("with_fleet", [False, True])
def test_fleet_watch_and_render_match_jax(tmp_path, with_fleet):
    root = _fixture(tmp_path)
    if with_fleet:
        _add_fleet_events(root)
    now = time.time()
    got = watch.FleetWatch(root).refresh(now=now)
    want = jax_watch.FleetWatch(root).refresh(now=now)
    for key in ("streams", "serve", "alerts", "replicas", "quality"):
        assert got[key] == want[key], key
    assert watch.render_watch(got) == jax_watch.render_watch(want)
    assert (watch.replica_state(read_events(root / "p0" / "events.jsonl"))
            == jax_watch.replica_state(
                read_events(root / "p0" / "events.jsonl")))


def test_collect_signals_matches_jax(tmp_path, monkeypatch):
    root = _fixture(tmp_path)
    _add_fleet_events(root)
    ledger = tmp_path / "ledger.jsonl"
    ledger.write_text(
        json.dumps({"point": "serve/knee_qps", "knee_qps": 120.0}) + "\n"
        + "not json\n"
        + json.dumps({"point": "serve/knee_qps", "knee_qps": 80.0}) + "\n"
        + '{"point": "serve/knee_qps", "knee_')
    now = time.time()
    stats = {"replicas": {"r0": {"batch_ms": 4.0}}, "n_live": 1}
    for fleet_stats in (None, stats):
        got = signals.collect_signals(root, ledger, fleet_stats=fleet_stats,
                                      now=now)
        want = jax_signals.collect_signals(root, ledger,
                                           fleet_stats=fleet_stats, now=now)
        assert got.__dict__ == want.__dict__
        assert got.knee_qps == 80.0
        assert got.wants_scale_up() == want.wants_scale_up()
        assert got.wants_scale_down() == want.wants_scale_down()
    # By default the port reads its own ledger, relative to the working
    # directory, and never the JAX package's.
    cwd = tmp_path / "cwd"
    (cwd / "results").mkdir(parents=True)
    monkeypatch.chdir(cwd)
    (cwd / "results" / "perf_ledger.jsonl").write_text(
        json.dumps({"point": "serve/knee_qps", "knee_qps": 120.0}) + "\n")
    assert signals.collect_signals(root, now=now).knee_qps is None
    (cwd / "results" / "perf_ledger_torch.jsonl").write_text(
        json.dumps({"point": "serve/knee_qps", "knee_qps": 90.0}) + "\n")
    assert signals.collect_signals(root, now=now).knee_qps == 90.0


# ------------------------------------------------------------ command lines


def _run(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


def test_watch_selfcheck_exits_zero():
    proc = _run("import sys\n"
                "from masters_thesis_tpu_torch.telemetry.__main__ import main\n"
                "sys.exit(main(['watch', '--selfcheck']))\n")
    assert proc.returncode == 0, proc.stderr
    assert "watch selfcheck ok" in proc.stdout


def test_serve_selfcheck_passes_with_torch_blocked():
    proc = _run("import runpy, sys\n"
                "for name in ('torch', 'jax', 'masters_thesis_tpu'):\n"
                "    sys.modules[name] = None\n"
                "sys.argv = ['serve', 'selfcheck']\n"
                "runpy.run_module('masters_thesis_tpu_torch.serve', "
                "run_name='__main__')\n")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "serve: selfcheck ok" in proc.stdout


def test_the_fleet_and_its_consoles_import_without_torch_or_jax():
    proc = _run("import sys\n"
                "for name in ('torch', 'jax', 'flax', 'masters_thesis_tpu'):\n"
                "    sys.modules[name] = None\n"
                "import masters_thesis_tpu_torch.serve.fleet\n"
                "import masters_thesis_tpu_torch.telemetry.watch\n"
                "import masters_thesis_tpu_torch.telemetry.signals\n"
                "import masters_thesis_tpu_torch.utils.counts\n")
    assert proc.returncode == 0, proc.stderr


def test_replica_boot_threads_do_not_outlive_stop():
    """stop() waits for a restart that is mid-boot, and its fresh worker
    gets the drain sentinel: no fleet thread is left running."""
    before = set(threading.enumerate())
    impl = Impl("port")
    fleet = impl.fleet(n=2)
    fleet.start()
    impl.plan("serve.replica_dispatch", "raise", replica="r0")
    try:
        pend = [fleet.submit(_window(), deadline_s=5.0) for _ in range(10)]
        assert all(p.result(timeout=10.0).status in EXPLICIT for p in pend)
    finally:
        impl.clear()
        fleet.stop()
    assert not [t for t in set(threading.enumerate()) - before
                if t.name.startswith("fleet-") and t.is_alive()]
