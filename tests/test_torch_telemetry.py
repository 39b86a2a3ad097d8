"""The port's telemetry against the JAX package's on the CPU.

Exact where the arithmetic is the same: the Prometheus text of equal
registry contents (byte-equal), request-span components fed the same clock
stamps, the event envelope's keys, and the span checks (validate_spans,
serve_attribution) on the same span records. Then the server with
telemetry on: its counters, spans and ``/metrics`` agree with ``stats()``.
"""

import json
import urllib.request

import numpy as np
import pytest
import torch

from masters_thesis_tpu.serve import spans as jax_spans
from masters_thesis_tpu.telemetry import exposition as jax_expo
from masters_thesis_tpu.telemetry import registry as jax_registry
from masters_thesis_tpu.telemetry import trace as jax_trace
from masters_thesis_tpu.telemetry.events import EventSink as JaxSink
from masters_thesis_tpu_torch.models.objectives import ModelSpec
from masters_thesis_tpu_torch.serve import spans
from masters_thesis_tpu_torch.serve.engine import PredictEngine
from masters_thesis_tpu_torch.serve.server import PredictServer
from masters_thesis_tpu_torch.telemetry import exposition, registry, trace
from masters_thesis_tpu_torch.telemetry.events import EventSink, read_events
from masters_thesis_tpu_torch.telemetry.run import TelemetryRun

K, T, F = 5, 8, 3


def _feed(reg, values):
    reg.counter("serve/completed").inc(3)
    reg.counter("serve/requests").inc(2.5)
    reg.gauge("device/bytes_in_use").set(1 << 20)
    reg.gauge("never_set")
    hist = reg.histogram("serve/latency_s")
    for v in values:
        hist.observe(v)


@pytest.mark.parametrize("n_obs", [0, 1, 7, 5000])
def test_prometheus_text_is_byte_equal(n_obs):
    values = np.random.default_rng(n_obs).exponential(0.003, n_obs).tolist()
    if n_obs:
        values[0] = float("inf")
    ours, theirs = registry.MetricsRegistry(), jax_registry.MetricsRegistry()
    _feed(ours, values)
    _feed(theirs, values)
    assert ours.snapshot() == theirs.snapshot()
    want = jax_expo.render_prometheus(theirs.snapshot())
    assert exposition.render_prometheus(ours.snapshot()) == want
    # Label values that need escaping.
    snap = {"tags": {"host": 'a"b\\c\nd', "pid": 1},
            "metrics": ours.snapshot()["metrics"]}
    assert exposition.render_prometheus(snap) == jax_expo.render_prometheus(snap)


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class _Recorder:
    """A tracer that keeps what each span closed with."""

    def __init__(self):
        self.ended = []

    def start(self, name, parent=None, **attrs):
        return {"name": name, **attrs}

    def end(self, span, status="ok", dur_s=None, **attrs):
        self.ended.append({"span": span, "status": status, "dur_s": dur_s,
                           **attrs})


# (stamp name, time) in the order the threads stamp them; the out-of-order
# and missing stamps collapse to zero-width components on both sides.
STAMPS = {
    "ok": [("t_admitted", 0.001), ("t_pickup", 0.004), ("t_predict0", 0.0045),
           ("t_predict_end", 0.0071)],
    "raced": [("t_pickup", 0.002), ("t_admitted", 0.003),
              ("t_predict0", 0.0025), ("t_predict_end", 0.006)],
    "no_device": [("t_admitted", 0.0005), ("t_pickup", 0.0031)],
}


@pytest.mark.parametrize("case", sorted(STAMPS))
@pytest.mark.parametrize("status", ["ok", "rejected_late", "error"])
def test_request_span_components_equal_the_jax_ones(monkeypatch, case, status):
    ended = []
    for module in (jax_spans, spans):
        clock = _Clock()
        monkeypatch.setattr(module.time, "perf_counter", clock)
        tracer = _Recorder()
        rs = module.RequestSpans(lambda: tracer)
        rs.open(7, "serve.request", deadline_ms=50.0)
        for key, t in STAMPS[case]:
            clock.t = t
            if key == "t_pickup":
                rs.stamp_many([7], key, t)
            else:
                rs.stamp(7, key)
        rs.close(7, status, 0.009)
        clock.t = 0.0
        rs.open(8, "serve.request")
        clock.t = 0.0025
        rs.close_shed(8, "fault")
        ended.append((tracer.ended, rs.shares()))
        monkeypatch.undo()
    (ours, our_shares), (theirs, their_shares) = ended[1], ended[0]
    assert ours == theirs and our_shares == their_shares
    closed = ours[0]
    parts = sum(closed[k] for k in trace.SERVE_COMPONENTS)
    assert parts == pytest.approx(closed["dur_s"], abs=1e-15)


def test_event_envelope_matches_the_jax_sink(tmp_path):
    ours = EventSink(tmp_path / "a" / "events.jsonl", run_id="r")
    theirs = JaxSink(tmp_path / "b" / "events.jsonl", run_id="r")
    a = ours.emit("serve_started", platform="cpu", buckets=[1, 2])
    b = theirs.emit("serve_started", platform="cpu", buckets=[1, 2])
    assert list(a) == list(b)
    assert {k: v for k, v in a.items() if k != "ts"} == {
        k: v for k, v in b.items() if k != "ts"}
    with pytest.raises(ValueError, match="clash"):
        ours.emit("x", seq=1)
    ours.close()
    assert read_events(tmp_path / "a" / "events.jsonl")[0]["seq"] == 0


def _span_records(tmp_path):
    """Span records written by the port's tracer, collected back."""
    run = TelemetryRun(tmp_path / "run", run_id="t")
    tracer = run.tracer
    root = tracer.start("serve.server")
    for rid, (queue_s, device_s) in enumerate([(0.001, 0.002), (0.01, 0.003),
                                               (0.0, 0.001)]):
        req = tracer.start("serve.request", parent=root, rid=rid)
        tracer.end(req, status="ok", dur_s=queue_s + device_s + 0.0005,
                   admit_s=0.0001, queue_s=queue_s, batch_form_s=0.0002,
                   device_s=device_s, deliver_s=0.0002)
    shed = tracer.start("serve.request", parent=root, rid=9)
    tracer.end(shed, status="shed", reason_category="fault", admit_s=0.0)
    tracer.emit_span("serve.device", start_ts=0.0, dur_s=0.002, parent=root)
    tracer.start("serve.request", parent=root, rid=10)  # left open
    run.close()  # closes it as aborted
    return trace.collect_spans(tmp_path)["spans"]


def test_span_checks_equal_the_jax_ones(tmp_path):
    records = _span_records(tmp_path)
    assert len(records) == 7
    assert {s["status"] for s in records} == {"ok", "shed", "aborted"}
    assert trace.validate_spans(records) == jax_trace.validate_spans(records) == []
    assert trace.serve_attribution(records) == jax_trace.serve_attribution(records)
    broken = records + [dict(records[0], span_id="x", parent_id="nope",
                             dur_s=-1.0)]
    got = trace.validate_spans(broken)
    assert got == jax_trace.validate_spans(broken)
    assert {p["kind"] for p in got} == {"orphan", "negative_duration"}


def test_server_telemetry_agrees_with_its_stats(tmp_path):
    spec = ModelSpec(objective="mse", hidden_size=8, num_layers=2, dropout=0.0)
    state = spec.build_module(
        device="cpu", generator=torch.Generator().manual_seed(0)).state_dict()
    engine = PredictEngine(spec, state, n_stocks=K, lookback=T, device="cpu")
    tel = TelemetryRun(tmp_path / "tel", run_id="serve")
    server = PredictServer(engine, telemetry=tel, max_wait_s=0.002,
                           metrics_port=0)
    server.start()
    x = np.random.default_rng(0).normal(size=(12, K, T, F)).astype(np.float32)
    try:
        pending = [server.submit(w, deadline_s=30.0, tenant=f"desk{i % 2}")
                   for i, w in enumerate(x)]
        pending.append(server.submit(x[0], deadline_s=1e-9))  # shed
        responses = [p.result(timeout=30.0) for p in pending]
        body = urllib.request.urlopen(server.metrics_url + "/metrics",
                                      timeout=10).read().decode()
        health = json.loads(urllib.request.urlopen(
            server.metrics_url + "/healthz", timeout=10).read())
    finally:
        stats = server.stop()
        tel.close()
    assert [r.status for r in responses] == ["ok"] * 12 + ["shed"]
    assert health["ok"] is True
    assert f"mtt_serve_completed{{" in body
    line = next(ln for ln in body.splitlines()
                if ln.startswith("mtt_serve_completed{"))
    assert float(line.rsplit(" ", 1)[1]) == stats["completed"] == 12
    assert 0 < stats["queue_wait_share"] < 1 and 0 < stats["compute_share"] < 1
    events = read_events(tmp_path / "tel" / "events.jsonl")
    kinds = [e["kind"] for e in events]
    for kind in ("serve_started", "exposition_started", "request_shed",
                 "serve_finished"):
        assert kind in kinds
    assert kinds.count("tenant_admitted") == 2  # desk0, desk1
    records = trace.collect_spans(tmp_path / "tel")["spans"]
    assert trace.validate_spans(records) == []
    requests = [s for s in records if s["name"] == "serve.request"]
    assert len(requests) == 13
    for s in requests:
        if s["status"] == "ok":
            parts = sum(s["attrs"][k] for k in trace.SERVE_COMPONENTS)
            assert parts == pytest.approx(s["dur_s"], abs=1e-12)
    devices = [s for s in records if s["name"] == "serve.device"]
    assert len(devices) == stats["dispatches"]
    attribution = trace.serve_attribution(records)
    assert attribution["completed"] == 12 and attribution["shed"] == 1
    assert attribution["p99"]["sum_ok"]
