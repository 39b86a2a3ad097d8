"""``python -m masters_thesis_tpu_torch.serve`` — the serving gates.

    python -m masters_thesis_tpu_torch.serve selfcheck
    python -m masters_thesis_tpu_torch.serve preflight [--device cpu] [--json]

Counterpart of ``python -m masters_thesis_tpu.serve``:

- ``selfcheck`` imports no torch. It drives the real queue, admission
  control, dispatch loop and deadline enforcement with a fake engine, as
  the JAX selfcheck's checks 1–4 do: the happy path, overload (explicit
  sheds, no late answer), a shed forced by the ``serve.admit`` fault point
  (category ``fault``), and the canary's verdict math; its check 5, with a
  canned probe that fails: scripted dispatch failures trip the breaker,
  ONE single-attempt probe runs, one ``degradation`` with ``fallback:
  null`` is written, the server is ``device_lost`` with the same engine
  (no CPU engine), and the next dispatch that succeeds serves again; its
  check 6, fleet failover: three fake replicas behind
  one ``FleetServer``, one crashed mid-traffic by ``serve.replica_dispatch``
  (every request resolved explicitly, none late, a survivor or a new
  generation), and the port's breaker rule: a replica whose breaker trips
  is dead (``cause="breaker"``) and a new generation serves, with no
  degradation; and its check 7, multi-tenant stacked serving: a tenant
  with a deadline class submits without a deadline, a second one rides
  along, a deadline-less submit of an unclassed tenant is refused, the
  per-tenant admission splits, and a stacked engine's ``(R, K)`` answer
  per window comes back through the unchanged dispatch loop
  (``stats()["lanes"]``). Exit 1 on any failure.
- ``preflight`` runs ``serve/preflight.py`` (SV301–SV304, SV305 for a
  warm boot from the program cache, SV306 for a fleet of two replicas on
  the device, SV307 over lane counts, and SV308 for one engine and for one
  lane of a stack) on the
  card, or on the CPU with ``--device cpu``: one JSON line of what the
  rules measured, then the findings. Exit 1 on findings.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path


class _FakeEngine:
    """Torch-free engine stand-in: the engine protocol with a configurable
    service time and failure script."""

    def __init__(self, service_s: float = 0.001, buckets=(1, 2, 4)):
        import numpy as np

        self._np = np
        self.service_s = service_s
        self.buckets = tuple(buckets)
        self.window_shape = (2, 3, 1)
        self.max_bucket = self.buckets[-1]
        self.compile_events = 0
        self.platform = "fake"
        self.fail_next = 0  # raise on the next N predict calls

    def warmup(self) -> float:
        return self.service_s

    def predict(self, x, params=None):
        time.sleep(self.service_s)
        if self.fail_next > 0:
            self.fail_next -= 1
            raise RuntimeError("scripted device failure")
        n, k = x.shape[0], self.window_shape[0]
        return (self._np.zeros((n, k), self._np.float32),
                self._np.zeros((n, k), self._np.float32))


class _FakeStackedEngine(_FakeEngine):
    """Stacked-engine stand-in: per-lane ``(n, R, K)`` answers."""

    def __init__(self, lanes: int = 3, **kw):
        super().__init__(**kw)
        self.num_lanes = lanes

    def predict(self, x, params=None):
        a, _ = super().predict(x, params)
        a = self._np.repeat(a[:, None, :], self.num_lanes, axis=1)
        return a, a.copy()


class _StubHealth:
    """BackendHealth stand-in: a canned single-attempt probe decision."""

    def __init__(self, ok: bool):
        import threading

        self._ok = ok
        self.calls = 0
        self._lock = threading.Lock()

    def ensure_responsive(self, single_attempt: bool = False, log=None):
        from masters_thesis_tpu_torch.utils.backend_probe import (
            HealthDecision,
        )

        with self._lock:
            self.calls += 1
        assert single_attempt, "serve must probe with single_attempt=True"
        return HealthDecision(
            ok=self._ok, degraded=not self._ok, attempts=1,
            detail="" if self._ok else "stubbed wedge",
            known_wedged=False, cached_age_s=None)


def _selfcheck(args) -> int:
    import numpy as np

    from masters_thesis_tpu_torch.resilience import faults
    from masters_thesis_tpu_torch.serve.queue import STATUS_OK, STATUS_SHED
    from masters_thesis_tpu_torch.serve.server import PredictServer
    from masters_thesis_tpu_torch.serve.swap import canary_checks
    from masters_thesis_tpu_torch.telemetry.events import read_events
    from masters_thesis_tpu_torch.telemetry.run import TelemetryRun

    failures: list[str] = []
    window = np.zeros((2, 3, 1), np.float32)

    # 1. Happy path: generous deadlines, everything completes before them.
    server = PredictServer(_FakeEngine(service_s=0.001), max_wait_s=0.002)
    server.start()
    pending = [server.submit(window, deadline_s=5.0) for _ in range(10)]
    results = [p.result(timeout=10.0) for p in pending]
    server.stop()
    if not all(r.status == STATUS_OK for r in results):
        failures.append("happy path: statuses "
                        f"{sorted({r.status for r in results})} != ['ok']")
    if any(r.delivered_ts > p.request.deadline_ts
           for p, r in zip(pending, results)):
        failures.append("happy path: a response was delivered past its "
                        "deadline")

    # 2. Overload: slow engine + tight deadlines -> explicit sheds, zero
    #    late ok-deliveries, every request resolved.
    server = PredictServer(_FakeEngine(service_s=0.02, buckets=(1, 2)),
                           max_wait_s=0.001)
    server.start()
    pending = [server.submit(window, deadline_s=0.05) for _ in range(20)]
    results = [p.result(timeout=10.0) for p in pending]
    stats = server.stop()
    if stats["shed"] + stats["late_converted"] == 0:
        failures.append(f"overload: nothing was shed or rejected ({stats})")
    if stats["late_deliveries"] != 0:
        failures.append(f"overload: {stats['late_deliveries']} late "
                        "ok-deliveries")
    if any(r.status == STATUS_OK and r.delivered_ts > p.request.deadline_ts
           for p, r in zip(pending, results)):
        failures.append("overload: ok response delivered late")

    # 3. A shed forced by the serve.admit fault point.
    faults.install_plan(faults.FaultPlan.parse(
        '{"faults": [{"point": "serve.admit", "kind": "wedge",'
        ' "attempt": null}]}'))
    try:
        server = PredictServer(_FakeEngine())
        server.start()
        r = server.submit(window, deadline_s=5.0).result(timeout=5.0)
        stats = server.stop()
    finally:
        faults.clear_plan()
    if r.status != STATUS_SHED or "fault" not in r.detail:
        failures.append(f"fault shed: got status={r.status!r} "
                        f"detail={r.detail!r}")
    if stats["shed_by_reason"] != {"fault": 1}:
        failures.append(f"fault shed: categories {stats['shed_by_reason']}")

    # 4. Canary verdict math (the numpy core of the swap gate).
    ok_pair = (np.zeros((1, 2)), np.zeros((1, 2)))
    nan_pair = (np.full((1, 2), np.nan), np.zeros((1, 2)))
    big_pair = (np.full((1, 2), 1e9), np.zeros((1, 2)))
    if not canary_checks(ok_pair, ok_pair).ok:
        failures.append("canary: identical outputs rejected")
    if canary_checks(ok_pair, nan_pair).ok:
        failures.append("canary: NaN candidate accepted")
    if canary_checks(ok_pair, big_pair).ok:
        failures.append("canary: exploded candidate accepted")
    if canary_checks(ok_pair, (np.ones((1, 2)), np.zeros((1, 2))),
                     max_drift=0.5).ok:
        failures.append("canary: drift budget not enforced")

    # 5. The breaker and the probe: two scripted failures trip it once, ONE
    #    probe runs and fails, the device is declared lost (one
    #    degradation, fallback null, no CPU engine); the same engine then
    #    serves the next request and the state clears.
    with tempfile.TemporaryDirectory() as tmp:
        tel = TelemetryRun(tmp, run_id="serve-selfcheck")
        engine = _FakeEngine(service_s=0.001)
        health = _StubHealth(ok=False)
        server = PredictServer(engine, telemetry=tel, breaker_threshold=2,
                               max_wait_s=0.001, health=health)
        server.start()
        engine.fail_next = 2
        # Sequential submit/await: each failure is its own dispatch.
        failed = [server.submit(window, deadline_s=5.0).result(timeout=10.0)
                  for _ in range(2)]
        # The probe runs after the failed answers went back: wait for it.
        deadline = time.monotonic() + 5.0
        while (server.stats()["state"] != "device_lost"
               and time.monotonic() < deadline):
            time.sleep(0.005)
        lost = server.stats()["state"]
        ok_after = server.submit(window, deadline_s=5.0).result(timeout=10.0)
        stats = server.stop()
        tel.close()
        degradations = [e for e in read_events(Path(tmp) / "events.jsonl")
                        if e.get("kind") == "degradation"]
    if [r.status for r in failed] != ["error", "error"]:
        failures.append(f"breaker: failed dispatches answered "
                        f"{[r.status for r in failed]}")
    if stats["breaker_trips"] != 1 or health.calls != 1:
        failures.append(f"breaker: {stats['breaker_trips']} trips, "
                        f"{health.calls} probes (wanted 1 and 1)")
    if (lost != "device_lost" or stats["degradations"] != 1
            or [e.get("fallback", "missing") for e in degradations] != [None]
            or server.engine is not engine):
        failures.append(f"breaker: device not declared lost once, loudly "
                        f"({lost}, {stats}, {degradations})")
    if ok_after.status != STATUS_OK or stats["state"] != "serving":
        failures.append(f"breaker: request after the trip {ok_after.status!r}"
                        f", state {stats['state']!r}")

    # 6. Fleet failover: three fake replicas, one killed by an injected
    #    dispatch crash mid-traffic; survivors absorb the re-dispatched
    #    work, the dead replica restarts a new generation, and no answer is
    #    late or silently dropped.
    from masters_thesis_tpu_torch.resilience.supervisor import (
        ReplicaRestartPolicy,
    )
    from masters_thesis_tpu_torch.serve.fleet import FleetServer

    fleet = FleetServer(
        {f"r{i}": (lambda: _FakeEngine(service_s=0.002)) for i in range(3)},
        max_wait_s=0.002, hang_timeout_s=0.5,
        restart_policy=ReplicaRestartPolicy(backoff_s=0.01))
    fleet.start()
    faults.install_plan(faults.FaultPlan.parse(
        '{"faults": [{"point": "serve.replica_dispatch", "kind": "raise",'
        ' "attempt": null, "match": {"replica": "r1"}}]}'))
    try:
        pending = [fleet.submit(window, deadline_s=2.0) for _ in range(30)]
        deadline = time.monotonic() + 5.0
        while (fleet.replicas["r1"].state != "dead"
               and time.monotonic() < deadline):
            time.sleep(0.005)
        results = [p.result(timeout=10.0) for p in pending]
    finally:
        faults.clear_plan()
    stats = fleet.stop()
    if stats["deaths"] < 1:
        failures.append(f"fleet: injected crash never killed r1 ({stats})")
    if stats["n_live"] < 1 and stats["replicas"]["r1"]["generation"] < 2:
        failures.append(f"fleet: no survivor and no restart ({stats})")
    if stats["late_deliveries"] != 0:
        failures.append(f"fleet: {stats['late_deliveries']} late "
                        "ok-deliveries")
    bad = [r.status for r in results
           if r.status not in ("ok", "shed", "rejected_late")]
    if bad:
        failures.append(f"fleet: non-explicit outcomes {sorted(set(bad))}")

    #    The breaker kills its replica: two scripted failures trip r0's
    #    breaker, r0 dies with cause "breaker", its next generation serves.
    with tempfile.TemporaryDirectory() as tmp:
        tel = TelemetryRun(tmp, run_id="serve-selfcheck-fleet")
        engines: list[_FakeEngine] = []

        def failing_first():
            engines.append(_FakeEngine(service_s=0.001))
            engines[-1].fail_next = 2 if len(engines) == 1 else 0
            return engines[-1]

        fleet = FleetServer({"r0": failing_first}, telemetry=tel,
                            breaker_threshold=2, max_wait_s=0.001,
                            restart_policy=ReplicaRestartPolicy(
                                backoff_s=0.01))
        fleet.start()
        failed = [fleet.submit(window, deadline_s=5.0).result(timeout=10.0)
                  for _ in range(2)]
        deadline = time.monotonic() + 5.0
        while (fleet.replicas["r0"].state != "live"
               or fleet.replicas["r0"].generation < 2) \
                and time.monotonic() < deadline:
            time.sleep(0.005)
        ok_after = fleet.submit(window, deadline_s=5.0).result(timeout=10.0)
        stats = fleet.stop()
        tel.close()
        dead = [e for e in read_events(Path(tmp) / "events.jsonl")
                if e.get("kind") == "replica_dead"]
    if [r.status for r in failed] != ["error", "error"]:
        failures.append(f"fleet breaker: failed dispatches answered "
                        f"{[r.status for r in failed]}")
    if [e.get("cause") for e in dead] != ["breaker"]:
        failures.append(f"fleet breaker: deaths {dead} (wanted one, cause "
                        "breaker)")
    if stats["degradations"] != 0 or stats["replicas"]["r0"]["generation"] < 2:
        failures.append(f"fleet breaker: no new generation ({stats})")
    if ok_after.status != STATUS_OK:
        failures.append(f"fleet breaker: request after the trip "
                        f"{ok_after.status!r}")

    # 7. Multi-tenant stacked serving: a deadline-classed tenant submits
    #    without a deadline, a second tenant rides along, accounting
    #    splits by tenant, and (R, K) answers resolve through the dispatch
    #    loop.
    engine = _FakeStackedEngine(lanes=3, service_s=0.001)
    server = PredictServer(engine, max_wait_s=0.002)
    server.register_tenant("quant-a", deadline_s=5.0)
    server.start()
    pending = [server.submit(window, tenant="quant-a") for _ in range(6)]
    pending += [server.submit(window, deadline_s=5.0, tenant="quant-b")
                for _ in range(4)]
    results = [p.result(timeout=10.0) for p in pending]
    try:
        server.submit(window, tenant="no-class")
        failures.append("tenancy: a deadline-less submit for an unclassed "
                        "tenant was admitted")
    except ValueError:
        pass
    stats = server.stop()
    if not all(r.status == STATUS_OK for r in results):
        failures.append("tenancy: statuses "
                        f"{sorted({r.status for r in results})} != ['ok']")
    lane_shapes = {r.outputs[0].shape for r in results if r.outputs}
    if lane_shapes != {(3, 2)}:
        failures.append(f"tenancy: stacked per-request answers {lane_shapes} "
                        "!= {(3, 2)} (lanes, stocks)")
    tstats = stats.get("tenants", {})
    if (tstats.get("quant-a", {}).get("admitted") != 6
            or tstats.get("quant-b", {}).get("admitted") != 4):
        failures.append(f"tenancy: per-tenant admission split {tstats}")
    if stats.get("lanes") != 3:
        failures.append(f"tenancy: stats lanes {stats.get('lanes')} != 3")

    if sys.modules.get("torch") is not None:
        failures.append("the selfcheck imported torch")
    if failures:
        print("serve: selfcheck FAILED: " + "; ".join(failures))
        return 1
    print("serve: selfcheck ok")
    return 0


def _preflight(args) -> int:
    from masters_thesis_tpu_torch.analysis.findings import format_report
    from masters_thesis_tpu_torch.serve.preflight import run_serve_preflight

    findings, facts = run_serve_preflight(device=args.device,
                                          requests=args.requests)
    print(json.dumps({"preflight": facts}, default=str))
    print(format_report(findings, as_json=args.json))
    if not findings and not args.json:
        print("serve: preflight ok (one capture a bucket, none in steady "
              "state, no implicit sync, captures fit the device, a swap "
              "under load captures nothing and is never late; stacked: one "
              "capture a bucket at every lane count, a lane swap under load "
              "captures nothing, is never late and leaves its siblings "
              "bitwise; a fleet survives a replica's death, nothing late; "
              "a warm boot from the program cache makes no program)")
    return 1 if findings else 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m masters_thesis_tpu_torch.serve",
        description="serving gates: torch-free selfcheck + preflight")
    sub = parser.add_subparsers(dest="command", required=True)
    p_check = sub.add_parser(
        "selfcheck",
        help="torch-free smoke of queue/admission/deadline/breaker/canary")
    p_check.set_defaults(fn=_selfcheck)
    p_pre = sub.add_parser(
        "preflight", help="predict-path audit on the card (SV301-SV308)")
    p_pre.add_argument("--device", default=None,
                       help="cpu to run on the CPU (default: the card)")
    p_pre.add_argument("--requests", type=int, default=12, metavar="N",
                       help="steady-state requests driven through the hot "
                       "path")
    p_pre.add_argument("--json", action="store_true",
                       help="machine-readable findings")
    p_pre.set_defaults(fn=_preflight)
    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
