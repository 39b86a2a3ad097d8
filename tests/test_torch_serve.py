"""The port's PredictEngine and PredictServer on the CPU.

The engine is held against the JAX package's PredictEngine on the same
weights (1e-5 abs: f32 on both sides, summed in a different order); the
server is driven end to end on the port's CPU engine.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masters_thesis_tpu.models.objectives import ModelSpec as JaxSpec
from masters_thesis_tpu.serve.engine import PredictEngine as JaxEngine
from masters_thesis_tpu_torch.models.convert import params_from_jax
from masters_thesis_tpu_torch.models.objectives import ModelSpec
from masters_thesis_tpu_torch.serve.engine import (
    BucketOverflowError,
    PredictEngine,
)
from masters_thesis_tpu_torch.serve.queue import (
    STATUS_ERROR,
    STATUS_OK,
    STATUS_REJECTED_LATE,
    STATUS_SHED,
)
from masters_thesis_tpu_torch.serve.server import PredictServer

K, T, F, H = 5, 8, 3, 16
BUCKETS = (1, 2, 4, 8)
ATOL = 1e-5


def _spec(num_layers=2):
    return ModelSpec(objective="mse", hidden_size=H, num_layers=num_layers,
                     dropout=0.0)


def _state(seed=0, num_layers=2):
    return _spec(num_layers).build_module(
        device="cpu", generator=torch.Generator().manual_seed(seed)
    ).state_dict()


def _engine(state=None, **kw):
    return PredictEngine(
        _spec(), _state() if state is None else state,
        n_stocks=K, lookback=T, n_features=F, buckets=BUCKETS, device="cpu", **kw,
    )


def _windows(n, seed=0):
    return np.random.default_rng(seed).normal(size=(n, K, T, F)).astype(np.float32)


@pytest.fixture(scope="module")
def engine_pair():
    spec = JaxSpec(objective="mse", hidden_size=H, num_layers=2, dropout=0.0)
    params = spec.build_module().init(
        jax.random.key(0), jnp.zeros((1, T, F), jnp.float32)
    )["params"]
    jax_engine = JaxEngine(spec, params, n_stocks=K, lookback=T, n_features=F,
                           buckets=BUCKETS)
    jax_engine.warmup()
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    return jax_engine, _engine(state)


@pytest.mark.parametrize("n", [1, 3, 8])
def test_engine_matches_jax_engine(engine_pair, n):
    jax_engine, engine = engine_pair
    x = _windows(n, seed=n)
    want_a, want_b = jax_engine.predict(x)
    got_a, got_b = engine.predict(x)
    assert got_a.shape == (n, K) and got_b.shape == (n, K)
    np.testing.assert_allclose(got_a, want_a, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_b, want_b, atol=ATOL, rtol=0)


def test_engine_contract():
    engine = _engine()
    assert engine.bucket_for(3) == 4 and engine.bucket_for(8) == 8
    assert engine.window_shape == (K, T, F) and engine.max_bucket == 8
    assert engine.platform == "cpu" and engine.compile_events == 0
    assert engine.warmup() > 0
    with pytest.raises(BucketOverflowError):
        engine.predict(_windows(9))
    with pytest.raises(ValueError, match="request shape"):
        engine.predict(np.zeros((1, K, T + 1, F), np.float32))
    # Padding repeats the first window and is sliced off: a padded window's
    # answer is the answer it gets alone.
    x = _windows(3, seed=11)
    a3, _ = engine.predict(x)
    a1, _ = engine.predict(x[:1])
    np.testing.assert_allclose(a3[:1], a1, atol=1e-6, rtol=0)


def test_server_answers_a_burst_like_the_engine():
    engine = _engine()
    server = PredictServer(engine, max_wait_s=0.01)
    server.start()
    x = _windows(13, seed=2)
    try:
        pending = [server.submit(w, deadline_s=30.0) for w in x]
        responses = [p.result(timeout=30.0) for p in pending]
    finally:
        stats = server.stop()
    assert [r.status for r in responses] == [STATUS_OK] * 13
    want_a, want_b = engine.predict(x[:8])
    want_a2, want_b2 = engine.predict(x[8:])
    want_a, want_b = np.concatenate([want_a, want_a2]), np.concatenate([want_b, want_b2])
    # Rows are independent, so a window's answer does not depend on which
    # micro-batch carried it; 1e-6 allows a different BLAS blocking.
    for i, r in enumerate(responses):
        np.testing.assert_allclose(r.outputs[0], want_a[i], atol=1e-6, rtol=0)
        np.testing.assert_allclose(r.outputs[1], want_b[i], atol=1e-6, rtol=0)
    assert stats["completed"] == 13 and stats["late_deliveries"] == 0
    assert stats["errors"] == 0 and stats["p50_ms"] is not None
    sizes = stats["batch_size_counts"]
    assert sum(n * c for n, c in sizes.items()) == 13
    assert max(sizes) <= engine.max_bucket


def test_non_finite_batch_resolves_as_error():
    state = _state()
    state["alpha_head.bias"] = torch.full_like(state["alpha_head.bias"], float("nan"))
    server = PredictServer(_engine(state))
    server.start()
    try:
        responses = [server.submit(w, deadline_s=30.0).result(timeout=30.0)
                     for w in _windows(2)]
    finally:
        stats = server.stop()
    assert [r.status for r in responses] == [STATUS_ERROR] * 2
    assert all("non-finite" in r.detail for r in responses)
    assert stats["errors"] == 2 and stats["completed"] == 0


def test_infeasible_deadline_is_shed():
    server = PredictServer(_engine())
    server.start()
    try:
        response = server.submit(_windows(1)[0], deadline_s=1e-9).result(timeout=5.0)
    finally:
        stats = server.stop()
    assert response.status == STATUS_SHED
    assert "deadline infeasible" in response.detail
    assert stats["shed_by_reason"] == {"deadline_infeasible": 1}
    assert stats["late_deliveries"] == 0


def test_an_answer_without_time_to_go_back_is_rejected_late():
    """A deadline inside the hand-back guard: admitted (the forecast fits),
    then rejected late at the dispatch re-check, never served ok."""
    server = PredictServer(_engine(), max_wait_s=0.0)
    server.start()
    try:
        assert server.handback_guard_s > 0.002
        server.service_model.seed(1e-6)  # the forecast fits the deadline
        response = server.submit(
            _windows(1)[0], deadline_s=0.5 * server.handback_guard_s
        ).result(timeout=5.0)
    finally:
        stats = server.stop()
    assert response.status == STATUS_REJECTED_LATE
    assert stats["late_converted"] == 1 and stats["late_deliveries"] == 0


def test_a_hand_back_that_slides_past_the_deadline_is_counted(monkeypatch):
    """late_deliveries reads the clock after the hand-back: an ok answer
    whose hand-back is held past its deadline is counted, and the longest
    hand-back is reported. The engine's service time is fixed (the
    selfcheck's fake engine), so admission does not depend on how loaded
    the machine is."""
    from masters_thesis_tpu_torch.serve.__main__ import _FakeEngine
    from masters_thesis_tpu_torch.serve.queue import PendingRequest

    resolve = PendingRequest.resolve

    def slow_resolve(self, response):
        if response.ok:
            time.sleep(0.3)
        resolve(self, response)

    monkeypatch.setattr(PendingRequest, "resolve", slow_resolve)
    engine = _FakeEngine(service_s=0.001)
    server = PredictServer(engine, max_wait_s=0.0)
    server.start()
    try:
        response = server.submit(np.zeros(engine.window_shape, np.float32),
                                 deadline_s=0.2).result(timeout=5.0)
    finally:
        stats = server.stop()
    assert response.ok
    assert stats["late_deliveries"] == 1
    assert stats["handback_max_ms"] >= 300.0


class _FailingEngine:
    window_shape = (K, T, F)
    max_bucket = 2

    def warmup(self):
        return 0.001

    def predict(self, x):
        raise RuntimeError("device fault")


def test_dispatch_failures_are_errors_and_trip_the_breaker():
    server = PredictServer(_FailingEngine(), breaker_threshold=2, max_wait_s=0.0)
    server.start()
    try:
        responses = []
        for w in _windows(4):
            responses.append(server.submit(w, deadline_s=30.0).result(timeout=30.0))
            time.sleep(0.01)
    finally:
        stats = server.stop()
    assert [r.status for r in responses] == [STATUS_ERROR] * 4
    assert all("device fault" in r.detail for r in responses)
    assert stats["errors"] == 4 and stats["breaker_trips"] == stats["dispatches"] // 2
    assert stats["breaker_trips"] >= 1


def test_submit_validates_shape_and_deadline():
    server = PredictServer(_engine())
    with pytest.raises(ValueError, match="window shape"):
        server.submit(np.zeros((K, T, F + 1), np.float32), deadline_s=1.0)
    with pytest.raises(ValueError, match="no deadline"):
        server.submit(np.zeros((K, T, F), np.float32))
    server.register_tenant("batch", deadline_s=30.0)
    server.start()
    try:
        r = server.submit(_windows(1)[0], tenant="batch").result(timeout=30.0)
    finally:
        stats = server.stop()
    assert r.status == STATUS_OK
    assert stats["tenants"]["batch"]["admitted"] == 1


def test_concurrent_submitters_account_for_every_request():
    """Many submitter threads at once, with a short switch interval: every
    request resolves exactly once and the counters add up."""
    import sys
    import threading

    server = PredictServer(_engine(), max_wait_s=0.001)
    server.start()
    windows = _windows(8, seed=4)
    results, lock = [], threading.Lock()

    def submitter(seed):
        for i in range(10):
            r = server.submit(windows[(seed + i) % 8], deadline_s=30.0).result(timeout=30.0)
            with lock:
                results.append(r)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=submitter, args=(s,)) for s in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        stats = server.stop()
    assert len(results) == 160 and len({r.rid for r in results}) == 160
    assert stats["requests"] == 160
    assert stats["completed"] + stats["shed"] + stats["errors"] + stats["late_converted"] == 160
    assert stats["completed"] == sum(r.ok for r in results)
    assert sum(n * c for n, c in stats["batch_size_counts"].items()) == stats["completed"]
    assert stats["late_deliveries"] == 0


# ------------------------------------------------------------ fault points
# The cases of tests/test_serve.py's fault-point tests, on the port.


@pytest.fixture
def fault_plan(monkeypatch):
    from masters_thesis_tpu_torch.resilience import faults

    monkeypatch.delenv(faults.FAULT_PLAN_ENV, raising=False)
    monkeypatch.delenv(faults.ATTEMPT_ENV, raising=False)

    def install(*specs, seed=0):
        faults.install_plan(faults.FaultPlan(
            faults=[faults.FaultSpec(**s) for s in specs], seed=seed))

    yield install
    faults.clear_plan()


def test_admit_fault_forces_shed(fault_plan):
    from masters_thesis_tpu_torch.serve.queue import MicroBatchQueue, ServeRequest

    fault_plan({"point": "serve.admit", "kind": "wedge", "attempt": None})
    q = MicroBatchQueue()
    r = q.submit(ServeRequest(rid=1, x=np.zeros((K, T, F), np.float32),
                              deadline_ts=time.monotonic() + 10.0)
                 ).result(timeout=0)
    assert r.status == STATUS_SHED and "fault" in r.detail


def test_admit_shift_fault_shifts_the_window_as_the_jax_queue(fault_plan):
    from masters_thesis_tpu.resilience import faults as jax_faults
    from masters_thesis_tpu.serve.queue import MicroBatchQueue as JaxQueue
    from masters_thesis_tpu.serve.queue import ServeRequest as JaxRequest
    from masters_thesis_tpu_torch.serve.queue import MicroBatchQueue, ServeRequest

    spec = {"point": "serve.admit", "kind": "shift", "attempt": None}
    fault_plan(spec, seed=4)
    jax_faults.install_plan(jax_faults.FaultPlan(
        faults=[jax_faults.FaultSpec(**spec)], seed=4))
    try:
        x = _windows(1)[0]
        got = ServeRequest(rid=1, x=x.copy(), deadline_ts=time.monotonic() + 9)
        want = JaxRequest(rid=1, x=x.copy(), deadline_ts=time.monotonic() + 9)
        MicroBatchQueue().submit(got)
        JaxQueue().submit(want)
    finally:
        jax_faults.clear_plan()
    np.testing.assert_array_equal(got.x, want.x)
    assert not np.array_equal(got.x, x)


def test_nan_fault_withholds_outputs(fault_plan):
    fault_plan({"point": "serve.dispatch", "kind": "nan", "attempt": None})
    engine = _engine()
    server = PredictServer(engine, max_wait_s=0.001)
    server.start()
    r = server.submit(engine.golden_batch(1)[0], deadline_s=10.0).result(
        timeout=30.0)
    server.stop()
    assert r.status == STATUS_ERROR and "non-finite" in r.detail
    assert r.outputs is None


def test_dispatch_wedge_is_an_error_that_trips_the_breaker(fault_plan):
    """Three wedged dispatches in a row trip the default breaker once; the
    same engine then answers: the port has no CPU failover."""
    fault_plan(*({"point": "serve.dispatch", "kind": "wedge", "attempt": None,
                  "match": {"seq": seq}} for seq in (1, 2, 3)))
    server = PredictServer(_engine(), max_wait_s=0.0)
    server.start()
    try:
        responses = [server.submit(w, deadline_s=30.0).result(timeout=30.0)
                     for w in _windows(5)]
    finally:
        stats = server.stop()
    assert [r.status for r in responses] == [
        STATUS_OK, STATUS_ERROR, STATUS_ERROR, STATUS_ERROR, STATUS_OK]
    assert all("InjectedDeviceError" in r.detail for r in responses[1:4])
    assert stats["breaker_trips"] == 1 and stats["errors"] == 3


def test_shed_categories_are_the_jax_ones():
    from masters_thesis_tpu.serve.server import shed_category as jax_category
    from masters_thesis_tpu_torch.serve.server import shed_category

    for reason in ("server shutting down", "injected admission shed (fault)",
                   "queue full (depth 9)", "deadline infeasible: est 3ms",
                   "no live replicas", "replica r0 died", "something else"):
        assert shed_category(reason) == jax_category(reason)


def test_a_stale_forecast_admits_a_probe_at_an_empty_queue():
    """A forecast past every deadline sheds; once no served batch has
    refreshed it for PROBE_AFTER_S, an empty queue admits the request as a
    probe, so the batch that corrects the forecast can run (the JAX queue
    sheds forever there)."""
    from masters_thesis_tpu.serve.queue import MicroBatchQueue as JaxQueue
    from masters_thesis_tpu.serve.queue import ServeRequest as JaxRequest
    from masters_thesis_tpu_torch.serve import queue

    ours, theirs = queue.MicroBatchQueue(), JaxQueue()
    for q in (ours, theirs):
        q.service_model.seed(10.0)  # one pathological batch's worth
    x = np.zeros((K, T, F), np.float32)

    def submit(q, cls, rid):
        return q.submit(cls(rid=rid, x=x, deadline_ts=time.monotonic() + 1.0))

    assert submit(ours, queue.ServeRequest, 1).done  # shed: fresh forecast
    ours.service_model._updated_ts -= queue.PROBE_AFTER_S + 0.5
    probe = submit(ours, queue.ServeRequest, 2)
    assert not probe.done and len(ours) == 1 and probe.request.probe
    assert submit(ours, queue.ServeRequest, 3).done  # depth 1: forecast rules
    assert submit(theirs, JaxRequest, 2).result(timeout=0).status == STATUS_SHED
    # The probe's measurement replaces the stale forecast; a later one is
    # blended as the JAX model blends it.
    ours.service_model.update(0.002, replace=True)
    assert ours.service_model.batch_s == 0.002
    ours.service_model.update(0.004)
    assert ours.service_model.batch_s == pytest.approx(0.3 * 0.004 + 0.7 * 0.002)


class _Clock:
    """A monotonic clock the test moves by hand."""

    def __init__(self, t=1000.0):
        self.t = t

    def monotonic(self):
        return self.t


@pytest.mark.parametrize("gap_s", [0.2, 1.5, 4.0])
def test_light_traffic_admits_and_forecasts_as_the_jax_queue(monkeypatch,
                                                              gap_s):
    """At light traffic, on the same clock stamps, the port's admission
    decisions and forecasts (queue-wide and the tenant's) equal the JAX
    queue's, also where the forecast has gone stale between requests
    (gap_s past PROBE_AFTER_S): the probe departs from the JAX queue only
    for a request the forecast would shed at an empty, stale queue, and no
    request here is one. Infeasible requests come at depth 1, or right
    after a measurement."""
    import masters_thesis_tpu.serve.queue as jax_queue
    from masters_thesis_tpu_torch.serve import queue as our_queue

    clock = _Clock()
    for mod in (jax_queue, our_queue):
        monkeypatch.setattr(mod, "time", clock)
    queues = {"jax": jax_queue.MicroBatchQueue(max_wait_s=0.0),
              "ours": our_queue.MicroBatchQueue(max_wait_s=0.0)}
    for q in queues.values():
        q.service_model.seed(0.004)
    x = np.zeros((K, T, F), np.float32)
    measured = np.random.default_rng(0).uniform(0.001, 0.02, size=12)
    rid = 0

    def submit(budget_s):
        nonlocal rid
        rid += 1
        out = {}
        for name, q in queues.items():
            mod = jax_queue if name == "jax" else our_queue
            out[name] = q.submit(mod.ServeRequest(
                rid=rid, x=x, deadline_ts=clock.t + budget_s,
                submitted_ts=clock.t))
        return out

    def snapshot():
        return {name: (q.service_model.batch_s, len(q),
                       q.tenant_stats()["default"])
                for name, q in queues.items()}

    decisions = []
    for i, batch_s in enumerate(measured):
        clock.t += gap_s
        pend = submit(0.05)
        if i % 3 == 1:  # an infeasible request behind it, at depth 1
            late = submit(0.0005)
            decisions.append({n: p.done for n, p in late.items()})
        decisions.append({n: p.done for n, p in pend.items()})
        assert snapshot()["ours"] == snapshot()["jax"]
        for name, q in queues.items():
            batch = q.next_batch(timeout_s=0.0)
            assert batch == [pend[name]]
            clock.t += batch_s
            q.service_model.update(batch_s)
            q.note_service({"default"}, batch_s)
            clock.t -= batch_s
        clock.t += batch_s
        assert snapshot()["ours"] == snapshot()["jax"]
        # Right after a measurement the forecast is fresh: an infeasible
        # request at an empty queue is shed by both.
        tight = submit(0.0005)
        decisions.append({n: p.done for n, p in tight.items()})
    assert all(d["ours"] == d["jax"] for d in decisions)
    assert any(d["ours"] for d in decisions) and not all(
        d["ours"] for d in decisions)


def test_a_server_whose_forecast_went_stale_serves_again():
    """A forecast past every deadline (one pathological batch): the server
    sheds, then, once the forecast is stale, serves the probe, re-measures
    on it and answers what follows."""
    from masters_thesis_tpu_torch.serve import queue

    server = PredictServer(_engine(), max_wait_s=0.001)
    server.start()
    try:
        server.service_model.seed(10.0)
        window = _windows(1)[0]
        assert server.submit(window, deadline_s=1.0).result(
            timeout=5).status == STATUS_SHED
        server.service_model._updated_ts -= queue.PROBE_AFTER_S + 0.5
        probe = server.submit(window, deadline_s=1.0).result(timeout=5)
        after = server.submit(window, deadline_s=1.0).result(timeout=5)
    finally:
        server.stop()
    assert probe.status == STATUS_OK and after.status == STATUS_OK
    assert server.service_model.batch_s < 1.0


# ---------------------------------------------- the probe after a breaker trip


def _wait_state(server, state, timeout_s=30.0):
    deadline = time.monotonic() + timeout_s
    while server.stats()["state"] != state and time.monotonic() < deadline:
        time.sleep(0.01)
    return server.stats()["state"]


def test_a_failed_probe_declares_the_device_lost_and_builds_no_cpu_engine(
        fault_plan, tmp_path, monkeypatch):
    """JAX ``test_serve.py::test_wedge_degrades_to_cpu_after_one_probe`` in
    the port's meaning: two wedged dispatches trip the breaker, the real
    ``BackendHealth`` probe is wedged by its fault point, and the server
    declares the device lost: one probe, one ``degradation`` with
    ``fallback: null``, ``device_lost`` in ``stats()`` and ``/healthz``
    (503), the same engine (none built on the CPU), errors answered; the
    next dispatch that succeeds serves again."""
    import json
    import urllib.error
    import urllib.request

    from masters_thesis_tpu_torch.telemetry.events import read_events
    from masters_thesis_tpu_torch.telemetry.run import TelemetryRun
    from masters_thesis_tpu_torch.utils import backend_probe as bp

    engine = _engine()
    built, probes = [], []
    init = PredictEngine.__init__
    monkeypatch.setattr(PredictEngine, "__init__",
                        lambda self, *a, **kw: (built.append(kw),
                                                init(self, *a, **kw))[1])
    real_probe = bp.probe_cuda_backend
    monkeypatch.setattr(bp, "probe_cuda_backend",
                        lambda **kw: probes.append(kw) or real_probe(**kw))
    fault_plan(*({"point": "serve.dispatch", "kind": "wedge", "attempt": None,
                  "match": {"seq": seq}} for seq in (0, 1)),
               {"point": "probe.attempt", "kind": "wedge", "attempt": None})
    tel = TelemetryRun(tmp_path / "tel", run_id="device-lost")
    health = bp.BackendHealth(tmp_path / "probe_cache.json", timeout_s=5.0)
    server = PredictServer(engine, telemetry=tel, health=health,
                           breaker_threshold=2, max_wait_s=0.001,
                           metrics_port=0)
    server.start()
    x = engine.golden_batch(1)[0]
    try:
        for _ in range(2):
            r = server.submit(x, deadline_s=30.0).result(timeout=60.0)
            assert r.status == STATUS_ERROR and "InjectedDeviceError" in r.detail
        assert _wait_state(server, "device_lost") == "device_lost"
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(server.metrics_url + "/healthz", timeout=10)
        assert err.value.code == 503
        health_body = json.loads(err.value.read())
        ok_after = server.submit(x, deadline_s=30.0).result(timeout=60.0)
        healthy = json.loads(urllib.request.urlopen(
            server.metrics_url + "/healthz", timeout=10).read())
    finally:
        stats = server.stop()
        tel.close()
    assert health_body["ok"] is False and health_body["state"] == "device_lost"
    assert ok_after.status == STATUS_OK and server.engine is engine
    assert healthy["ok"] is True and healthy["state"] == "serving"
    assert stats["degradations"] == 1 and stats["state"] == "serving"
    assert len(probes) == 1 and probes[0]["budget_s"] == 0.0
    assert built == []  # no engine was built after the trip, on any device
    events = read_events(tmp_path / "tel" / "events.jsonl")
    degradations = [e for e in events if e["kind"] == "degradation"]
    assert len(degradations) == 1
    d = degradations[0]
    assert d["fallback"] is None and d["scope"] == "serve"
    assert d["probe_attempts"] == 1 and d["platform"] == engine.platform
    assert not [e for e in events if e["kind"] == "breaker_probe_ok"]


def test_a_probe_that_answers_changes_nothing(fault_plan, tmp_path):
    from masters_thesis_tpu_torch.serve.__main__ import _StubHealth
    from masters_thesis_tpu_torch.telemetry.events import read_events
    from masters_thesis_tpu_torch.telemetry.run import TelemetryRun

    fault_plan(*({"point": "serve.dispatch", "kind": "wedge", "attempt": None,
                  "match": {"seq": seq}} for seq in (0, 1)))
    health = _StubHealth(ok=True)
    tel = TelemetryRun(tmp_path, run_id="probe-ok")
    server = PredictServer(_engine(), telemetry=tel, health=health,
                           breaker_threshold=2, max_wait_s=0.001)
    server.start()
    try:
        statuses = [server.submit(w, deadline_s=30.0).result(timeout=60.0).status
                    for w in _windows(3)]
    finally:
        stats = server.stop()
        tel.close()
    ok = [e for e in read_events(tmp_path / "events.jsonl")
          if e["kind"] == "breaker_probe_ok"]
    assert statuses == [STATUS_ERROR, STATUS_ERROR, STATUS_OK]
    assert health.calls == 1 and stats["degradations"] == 0
    assert stats["state"] == "serving"
    assert len(ok) == 1 and ok[0]["trips"] == 1 and ok[0]["attempts"] == 1
    assert "InjectedDeviceError" in ok[0]["cause"]


def test_without_a_probe_no_device_is_declared_lost(fault_plan):
    fault_plan(*({"point": "serve.dispatch", "kind": "wedge", "attempt": None,
                  "match": {"seq": seq}} for seq in (0, 1, 2)))
    server = PredictServer(_engine(), max_wait_s=0.001)
    server.start()
    try:
        for w in _windows(3):
            server.submit(w, deadline_s=30.0).result(timeout=60.0)
    finally:
        stats = server.stop()
    assert stats["breaker_trips"] == 1
    assert stats["degradations"] == 0 and stats["state"] == "serving"


def test_the_server_writes_one_cost_profile_a_bucket(tmp_path):
    """The engine's analytic cost of each bucket (``cost_of_step``'s
    forward over ``b * K`` rows), one ``cost_profile`` event each at
    start."""
    from masters_thesis_tpu_torch.telemetry.costs import cost_of_step
    from masters_thesis_tpu_torch.telemetry.events import read_events
    from masters_thesis_tpu_torch.telemetry.run import TelemetryRun

    engine = _engine()
    tel = TelemetryRun(tmp_path, run_id="costs")
    server = PredictServer(engine, telemetry=tel)
    server.start()
    server.stop()
    tel.close()
    profiles = [e for e in read_events(tmp_path / "events.jsonl")
                if e["kind"] == "cost_profile"]
    assert [p["program"] for p in profiles] == [
        f"serve_bucket_{b}" for b in BUCKETS]
    for p in profiles:
        b = p["meta"]["bucket"]
        want = cost_of_step(_spec(), b * K, T, window_rows=K, training=False)
        assert p["flops"] == want["flops"] and p["bytes_accessed"] == want["bytes"]
        assert p["source"] == "analytic" and p["meta"]["platform"] == "cpu"
        assert p["meta"]["kernels_per_step"] == want["kernels"]
