"""The serving loop: queue -> engine dispatch and deadline enforcement.

Counterpart of ``masters_thesis_tpu/serve/server.py``. The engine is
injected (the selfcheck CLI drives this loop with a fake one, without
torch). Invariants this module owns:

- **No late answers.** A response is delivered as ``ok`` only if it is
  handed back BEFORE the request's deadline; a batch that finishes late
  resolves those requests as explicit ``rejected_late`` rejections. Each
  answer of a batch is checked as it goes back, on a reading of the clock
  taken after the batch's earlier answers went back (the JAX server checks
  a batch once, before its answers go back), and goes back ``ok`` only if
  ``handback_guard_s`` (two of the interpreter's thread-switch intervals)
  remains before its deadline: a thread switch inside the hand-back holds
  it for about one interval, so an answer decided ok just before its
  deadline could otherwise go back after it. The dispatch re-check keeps
  the same margin. The ``late_deliveries`` counter (an ok delivered past
  its deadline, on a reading of the clock taken after the hand-back) must
  stay 0; ``stats()["handback_max_ms"]`` is the longest hand-back seen.
- **Failures are answers.** A dispatch that raises resolves its requests as
  explicit ``error`` responses and feeds a :class:`CircuitBreaker`, whose
  trips are counted (``breaker_trips``). There is no CPU failover in the
  port. After a trip, with ``health=`` (a ``utils.backend_probe.
  BackendHealth``), the server spends ONE single-attempt probe of the card:
  if it answers, a ``breaker_probe_ok`` event and nothing else; if not, the
  device is declared lost, loudly: ``degradations`` is counted, a
  ``degradation`` event (``scope: "serve"``, ``fallback: null``, the
  engine's ``platform``) is written, and ``stats()["state"]`` becomes
  ``device_lost``, which ``/healthz`` reports as unhealthy. No CPU engine is
  built: failed dispatches still answer ``error``, and the first dispatch
  that succeeds sets the state back to ``serving``. With ``health=None``
  nothing is probed and no device is declared lost (only on evidence).
- **Non-finite outputs never leave.** A batch whose outputs contain
  NaN/inf resolves as ``error``.

With ``telemetry=`` (a :class:`~masters_thesis_tpu_torch.telemetry.run.
TelemetryRun`) the server writes the JAX server's events
(``serve_started``, ``tenant_admitted``, ``request_shed``,
``serve_finished``, one ``cost_profile`` a bucket at start from the
engine's ``cost_profiles``), mirrors its counters into ``serve/<name>`` of the
registry, observes ``serve/latency_s``, and writes spans: one
``serve.server`` span, one ``serve.request`` span a request whose
components tile its wall (``serve/spans.py``) and one ``serve.device``
span a dispatch. ``metrics_port=`` (0 for a free port) starts the
telemetry plane while the server runs: an SLO engine over the run's stream
(``slo_rules``, default ``default_serve_rules()``) and the ``/metrics``,
``/healthz`` and ``/slo`` server. ``stats()`` carries ``queue_wait_share``
and ``compute_share`` from the request spans.

What the server shares with the serving fleet (``serve/fleet.py``) lives
in :class:`DeadlineServing`: request intake, the accounting, the dispatch
re-check and the hand-back rule, so both hold the same no-late rule.

``quality_monitor=`` (a ``telemetry.quality.QualityMonitor``) is handed
each batch's delivered answers after their hand-back, with the host arrays
already in hand (a lane-stacked engine's answer is the mean over its
lanes); it samples 1 in K of them and touches no device.

Fault points: ``serve.dispatch`` (context ``seq``, the dispatch's number,
and ``n``, its live requests) kind ``wedge`` raises
:class:`InjectedDeviceError` into the breaker; kind ``nan`` poisons the
batch's answers, which the finite check then withholds. ``serve.admit`` is
handled in ``queue.py``.
"""

from __future__ import annotations

import collections
import sys
import threading
import time

import numpy as np

from masters_thesis_tpu_torch.resilience import faults
from masters_thesis_tpu_torch.serve.queue import (
    DEFAULT_TENANT,
    STATUS_ERROR,
    STATUS_OK,
    STATUS_REJECTED_LATE,
    MicroBatchQueue,
    PendingRequest,
    ServeRequest,
    ServeResponse,
    ServiceTimeModel,
)
from masters_thesis_tpu_torch.serve.spans import RequestSpans


#: ``stats()["state"]``: serving, or the card declared lost after a trip
#: and a failed probe.
STATE_SERVING = "serving"
STATE_DEVICE_LOST = "device_lost"


class InjectedDeviceError(RuntimeError):
    """Stand-in for a device failure (``serve.dispatch`` kind ``wedge``)."""


class CircuitBreaker:
    """Counts consecutive dispatch failures; ``threshold`` of them trip it."""

    def __init__(self, threshold: int = 3) -> None:
        if threshold < 1:
            raise ValueError(f"breaker threshold must be >= 1: {threshold}")
        self.threshold = threshold
        self.consecutive = 0
        self.trips = 0
        self._lock = threading.Lock()

    def record_success(self) -> None:
        with self._lock:
            self.consecutive = 0

    def record_failure(self) -> bool:
        """Count a failure; True when this one trips the breaker (the
        consecutive count then starts again)."""
        with self._lock:
            self.consecutive += 1
            if self.consecutive >= self.threshold:
                self.consecutive = 0
                self.trips += 1
                return True
            return False


def shed_category(reason: str) -> str:
    """Collapse the queue's free-text shed reasons into the JAX server's
    stable categories."""
    if reason.startswith("server shutting down"):
        return "shutdown"
    if reason.startswith("injected admission shed"):
        return "fault"
    if reason.startswith("queue full"):
        return "queue_full"
    if reason.startswith("deadline infeasible"):
        return "deadline_infeasible"
    if reason.startswith("no live replicas"):
        return "no_live_replicas"
    if reason.startswith("replica"):
        return "replica_death"
    return "other"


#: ok deliveries whose latencies stats() reports quantiles over.
LATENCY_WINDOW = 65536


class DeadlineServing:
    """Request intake, accounting and the deadline rules of one serving
    front end (:class:`PredictServer`, the fleet's ``FleetServer``): the
    window shape comes from ``_window_shape()``, each answer goes back by
    ``_answer`` under the hand-back rule (the module docstring)."""

    def __init__(self, *, telemetry=None, metrics_port: int | None = None,
                 slo_rules=None, quality_monitor=None):
        self.telemetry = telemetry
        self.metrics_port = metrics_port
        self._slo_rules = slo_rules
        self._exposition = self._slo_engine = None
        #: Samples delivered answers after their hand-back (None: off).
        self.quality = quality_monitor
        self._rid = 0
        self._rid_lock = threading.Lock()
        self._started_ts: float | None = None
        # Counters are written from the dispatch threads and read by
        # stats() from whatever thread asks; _stats_lock keeps them
        # consistent.
        self._stats_lock = threading.Lock()
        self.completed = 0
        self.errors = 0
        self.late_converted = 0
        #: ok responses delivered past their deadline; must stay 0.
        self.late_deliveries = 0
        #: An answer goes back ok only if this much time remains before its
        #: deadline (the module docstring says why).
        self.handback_guard_s = 2.0 * sys.getswitchinterval()
        #: The longest hand-back of an ok answer: from the clock reading
        #: that decided it to the reading right after it went back.
        self.handback_max_s = 0.0
        self.shed_by_reason: dict[str, int] = {}
        #: Latencies of the most recent ok deliveries (p50/p99 in stats()).
        self._latencies_s: collections.deque = collections.deque(
            maxlen=LATENCY_WINDOW
        )
        #: The front end's root span (``serve.server``, ``serve.fleet``).
        self._root_span = None
        #: ``serving`` or ``device_lost`` (``/healthz`` reads it).
        self.state = STATE_SERVING
        self.degradations = 0
        self.spans = RequestSpans(self._tracer)

    # ------------------------------------------------------------ telemetry

    def _event(self, kind: str, **payload) -> None:
        if self.telemetry is not None:
            self.telemetry.event(kind, **payload)

    def _count(self, name: str, n: int = 1) -> None:
        if self.telemetry is not None:
            self.telemetry.counter(f"serve/{name}").inc(n)

    def _bump(self, name: str, n: int = 1) -> None:
        """Locked increment of a stats counter, mirrored to telemetry."""
        with self._stats_lock:
            setattr(self, name, getattr(self, name) + n)
        self._count(name, n)

    def _tracer(self):
        return self.telemetry.tracer if self.telemetry is not None else None

    def _start_plane(self) -> None:
        if self.metrics_port is not None and self.telemetry is not None:
            from masters_thesis_tpu_torch.telemetry.exposition import (
                start_telemetry_plane,
            )

            self._exposition, self._slo_engine = start_telemetry_plane(
                self.telemetry, self.metrics_port, rules=self._slo_rules,
                health=lambda: self.state)

    def _stop_plane(self) -> None:
        if self._exposition is not None or self._slo_engine is not None:
            from masters_thesis_tpu_torch.telemetry.exposition import (
                stop_telemetry_plane,
            )

            stop_telemetry_plane(self._exposition, self._slo_engine)
            self._exposition = self._slo_engine = None

    @property
    def metrics_url(self) -> str | None:
        """``http://host:port`` of ``/metrics``, ``/healthz`` and ``/slo``
        while the front end runs."""
        return None if self._exposition is None else self._exposition.url

    @property
    def slo_engine(self):
        """The plane's SLO engine while the front end runs, else None."""
        return self._slo_engine

    def _wall_s(self) -> float:
        return (time.monotonic() - self._started_ts
                if self._started_ts is not None else 0.0)

    def _latency_ms(self) -> dict:
        """p50 and p99 of the recent ok latencies, in ms (None: none)."""
        with self._stats_lock:
            lat = np.asarray(self._latencies_s)
        if not lat.size:
            return {"p50_ms": None, "p99_ms": None}
        return {"p50_ms": float(np.percentile(lat, 50) * 1e3),
                "p99_ms": float(np.percentile(lat, 99) * 1e3)}

    # -------------------------------------------------------------- request

    def _window_shape(self) -> tuple:
        raise NotImplementedError

    def register_tenant(
        self, name: str, deadline_s: float | None = None
    ) -> None:
        """Onboard (or re-class) a tenant: pins its deadline class and
        emits ``tenant_admitted`` the first time the front end sees it."""
        _, created = self.queue.tenant(name, deadline_s)
        if created:
            self._event(
                "tenant_admitted", tenant=name,
                deadline_ms=None if deadline_s is None else deadline_s * 1e3,
            )

    def submit(
        self,
        x,
        deadline_s: float | None = None,
        tenant: str = DEFAULT_TENANT,
    ) -> PendingRequest:
        """Admit one window with a relative deadline budget in seconds.

        ``deadline_s=None`` falls back to ``tenant``'s deadline class
        (register_tenant); a request with neither is a caller bug. An
        unregistered tenant is onboarded at its first request.
        """
        x = np.asarray(x, np.float32)
        shape = self._window_shape()
        if x.shape != shape:
            raise ValueError(
                f"request window shape {x.shape} != engine window shape "
                f"{shape}"
            )
        if deadline_s is None:
            deadline_s = self.queue.tenant_deadline_s(tenant)
            if deadline_s is None:
                raise ValueError(
                    f"request carries no deadline and tenant {tenant!r} "
                    "has no deadline class (register_tenant first)"
                )
        self.register_tenant(tenant)
        with self._rid_lock:
            self._rid += 1
            rid = self._rid
        self._count("requests")
        # The span must exist BEFORE queue.submit: a shed resolves
        # synchronously inside it, and _on_shed closes the span.
        self.spans.open(rid, "serve.request", parent=self._root_span,
                        deadline_ms=deadline_s * 1e3)
        pending = self.queue.submit(
            ServeRequest(
                rid=rid, x=x, deadline_ts=time.monotonic() + deadline_s,
                tenant=tenant,
            )
        )
        if not pending.done:
            self.spans.stamp(rid, "t_admitted")
        return pending

    def _on_shed(self, request: ServeRequest, reason: str) -> None:
        self._count("shed")
        category = shed_category(reason)
        with self._stats_lock:
            self.shed_by_reason[category] = (
                self.shed_by_reason.get(category, 0) + 1
            )
        self._event("request_shed", rid=request.rid, reason=reason)
        self.spans.close_shed(request.rid, category)

    # ------------------------------------------------------------- answers

    def _resolve(self, pending: PendingRequest, status: str, detail: str = "",
                 outputs: tuple | None = None,
                 now: float | None = None, **span_attrs) -> float:
        """Resolve ``pending``, stamped ``now`` (a reading of the monotonic
        clock taken here, just before the hand-back, if not given), then
        close its span. Returns the clock read right after the hand-back."""
        now = time.monotonic() if now is None else now
        t_resolve = time.perf_counter()
        pending.resolve(ServeResponse(
            rid=pending.request.rid,
            status=status,
            outputs=outputs,
            detail=detail,
            delivered_ts=now,
            latency_s=now - pending.request.submitted_ts,
        ))
        handed_back = time.monotonic()
        self.spans.close(pending.request.rid, status, t_resolve, **span_attrs)
        return handed_back

    def _reject_late(self, pending: PendingRequest, detail: str,
                     now: float | None = None, **span_attrs) -> None:
        self._bump("late_converted")
        self._resolve(pending, STATUS_REJECTED_LATE, detail, now=now,
                      **span_attrs)

    def _recheck(self, batch: list[PendingRequest], batch_s: float,
                 **span_attrs) -> list[PendingRequest]:
        """The batch's requests still worth dispatching. Queue wait may
        have eaten a request's whole budget; spending device time on it
        would only produce a late answer, so it is rejected now. The answer
        must also leave ``handback_guard_s`` before the deadline
        (``_deliver``). A probe (queue.py, PROBE_AFTER_S) skips the check:
        its batch is the one whose measurement replaces the stale
        forecast. A request resolved elsewhere is dropped."""
        est = batch_s + self.handback_guard_s
        now = time.monotonic()
        live: list[PendingRequest] = []
        for p in batch:
            if p.done:
                continue
            if now + est > p.request.deadline_ts and not p.request.probe:
                self._reject_late(
                    p, "deadline infeasible at dispatch (queue wait consumed "
                    "the budget); rejected rather than served late",
                    **span_attrs)
            else:
                live.append(p)
        return live

    def _answer(self, live: list[PendingRequest], alpha, beta,
                **span_attrs) -> tuple[list[int], bool]:
        """Hand back a dispatched batch's answers: all ``error`` when any
        is non-finite, else each by ``_deliver``; then the quality monitor
        samples the delivered ones. Returns the delivered indices, and
        whether the answers were finite."""
        finite = bool(np.isfinite(alpha).all() and np.isfinite(beta).all())
        delivered = []
        for i, p in enumerate(live):
            if not finite:
                self._bump("errors")
                self._resolve(p, STATUS_ERROR,
                              "non-finite predictions; response withheld",
                              **span_attrs)
            elif self._deliver(p, (alpha[i], beta[i]), **span_attrs):
                delivered.append(i)
        if self.quality is not None:
            # After every answer of the batch went back: host arrays only.
            for i in delivered:
                a_i, b_i = alpha[i], beta[i]
                if a_i.ndim == 2:  # lanes (R, K): the served answer's mean
                    a_i, b_i = a_i.mean(axis=0), b_i.mean(axis=0)
                self.quality.sample(live[i].request.x, a_i, b_i)
        return delivered, finite

    def _deliver(self, pending: PendingRequest, outputs: tuple,
                 **span_attrs) -> bool:
        """Hand back an ``ok`` answer (returns True), or ``rejected_late``
        (False) once less than ``handback_guard_s`` remains before its
        deadline. Each answer is decided on its own reading of the clock,
        after the batch's earlier answers went back (their span and event
        writes included). The response is stamped on a fresh reading after
        this answer's own bookkeeping, just before the hand-back, and
        ``late_deliveries`` counts an ``ok`` the clock reads past its
        deadline right after the hand-back."""
        request = pending.request
        now = time.monotonic()
        if now + self.handback_guard_s > request.deadline_ts:
            self._reject_late(
                pending,
                "batch completed too close to the deadline to be handed "
                "back before it; rejected rather than delivered late",
                now=now, **span_attrs)
            return False
        latency = now - request.submitted_ts
        with self._stats_lock:
            self.completed += 1
            self._latencies_s.append(latency)
        self._count("completed")
        if self.telemetry is not None:
            self.telemetry.histogram("serve/latency_s").observe(latency)
        handed_back = self._resolve(pending, STATUS_OK, outputs=outputs,
                                    **span_attrs)
        with self._stats_lock:
            self.handback_max_s = max(self.handback_max_s, handed_back - now)
        if handed_back > request.deadline_ts:
            # The delivery itself slid past the deadline: this must never
            # happen; counted so that a run fails loudly.
            self._bump("late_deliveries")
        return True


class PredictServer(DeadlineServing):
    """Owns the queue, the dispatch thread and the request accounting."""

    def __init__(
        self,
        engine,
        *,
        max_batch: int | None = None,
        max_wait_s: float = 0.005,
        max_depth: int = 256,
        telemetry=None,
        breaker_threshold: int = 3,
        metrics_port: int | None = None,
        slo_rules=None,
        quality_monitor=None,
        health=None,
    ):
        super().__init__(telemetry=telemetry, metrics_port=metrics_port,
                         slo_rules=slo_rules, quality_monitor=quality_monitor)
        self.engine = engine
        self.breaker = CircuitBreaker(breaker_threshold)
        #: The card's probe after a breaker trip (None: no probe, and no
        #: device is ever declared lost).
        self.health = health
        self.service_model = ServiceTimeModel()
        # The queue's micro-batch can never exceed the largest bucket.
        cap = engine.max_bucket
        self.max_batch = min(max_batch, cap) if max_batch else cap
        self.queue = MicroBatchQueue(
            max_batch=self.max_batch,
            max_wait_s=max_wait_s,
            max_depth=max_depth,
            service_model=self.service_model,
            on_shed=self._on_shed,
        )
        self._thread: threading.Thread | None = None
        self.dispatches = 0
        #: Dispatches by batch size, before padding to a bucket.
        self.batch_size_counts: dict[int, int] = {}

    def _window_shape(self) -> tuple:
        return tuple(self.engine.window_shape)

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        if self._thread is not None:
            raise RuntimeError("server already started")
        warm_s = self.engine.warmup()
        self.service_model.seed(warm_s)
        self._started_ts = time.monotonic()
        tracer = self._tracer()
        if tracer is not None:
            self._root_span = tracer.start(
                "serve.server", platform=self.engine.platform,
                max_batch=self.max_batch,
            )
        if self.telemetry is not None:
            self._event(
                "serve_started",
                platform=self.engine.platform,
                buckets=list(self.engine.buckets),
                max_batch=self.max_batch,
                max_wait_ms=self.queue.max_wait_s * 1e3,
                warmup_batch_ms=warm_s * 1e3,
                compile_events=self.engine.compile_events,
            )
            # One cost_profile a bucket (the engine's analytic costs); a
            # cost_unavailable, once, for an engine without them.
            profiles = getattr(self.engine, "cost_profiles", {})
            warned = False
            for b in self.engine.buckets:
                if profiles.get(b):
                    self._event("cost_profile", **profiles[b])
                elif not warned:
                    warned = True
                    self._event("cost_unavailable",
                                program=f"serve_bucket_{b}")
        self._thread = threading.Thread(
            target=self._worker, name="serve-dispatch", daemon=True
        )
        self._thread.start()
        self._start_plane()

    def stop(self) -> dict:
        """Drain, stop the dispatch thread, emit ``serve_finished``;
        returns the summary stats the event carries."""
        self._stop_plane()
        self.queue.close()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            if self._thread.is_alive():
                raise RuntimeError("dispatch thread did not stop within 30 s")
            self._thread = None
        stats = self.stats()
        tracer = self._tracer()
        if tracer is not None and self._root_span is not None:
            tracer.end(self._root_span, status="ok",
                       requests=stats["requests"],
                       completed=stats["completed"], shed=stats["shed"])
            self._root_span = None
        self._event("serve_finished", **stats)
        return stats

    def stats(self) -> dict:
        span = self._wall_s()
        queue_wait_share, compute_share = self.spans.shares()
        with self._stats_lock:
            stats = {
                "queue_wait_share": queue_wait_share,
                "compute_share": compute_share,
                "requests": self.queue.submitted,
                "completed": self.completed,
                "shed": self.queue.shed,
                "shed_by_reason": dict(self.shed_by_reason),
                "errors": self.errors,
                "late_converted": self.late_converted,
                "late_deliveries": self.late_deliveries,
                "handback_max_ms": 1e3 * self.handback_max_s,
                "dispatches": self.dispatches,
                "breaker_trips": self.breaker.trips,
                "degradations": self.degradations,
                "state": self.state,
                "batch_size_counts": dict(self.batch_size_counts),
            }
        stats.update(
            tenants=self.queue.tenant_stats(),
            lanes=getattr(self.engine, "num_lanes", 1),
            **self._latency_ms(),
            qps=stats["completed"] / span if span > 0 else 0.0,
            wall_s=span,
        )
        return stats

    # ------------------------------------------------------------- dispatch

    def _worker(self) -> None:
        while True:
            batch = self.queue.next_batch(timeout_s=0.05)
            if not batch:
                if self.queue.closed and len(self.queue) == 0:
                    return
                continue
            self.spans.stamp_many([p.request.rid for p in batch], "t_pickup",
                                  time.perf_counter())
            self._dispatch(batch)

    def _dispatch(self, batch: list[PendingRequest]) -> None:
        live = self._recheck(batch, self.service_model.batch_s)
        if not live:
            return
        with self._stats_lock:
            seq = self.dispatches  # the dispatch's number, from 0
            self.dispatches += 1
            self.batch_size_counts[len(live)] = (
                self.batch_size_counts.get(len(live), 0) + 1
            )
        kind = faults.fire("serve.dispatch", seq=seq, n=len(live))
        tracer = self._tracer()
        live_rids = [p.request.rid for p in live]
        t0_wall = time.time()
        t0 = time.perf_counter()
        self.spans.stamp_many(live_rids, "t_predict0", t0)
        try:
            if kind == "wedge":
                raise InjectedDeviceError(
                    f"injected device error at dispatch seq={seq}"
                )
            alpha, beta = self.engine.predict(
                np.stack([p.request.x for p in live])
            )
            if kind == "nan":
                alpha = np.full_like(alpha, np.nan)
        except Exception as exc:  # noqa: BLE001 — any dispatch failure
            self.spans.stamp_many(live_rids, "t_predict_end",
                                  time.perf_counter())
            self._bump("errors", len(live))
            for p in live:
                self._resolve(
                    p, STATUS_ERROR, f"{type(exc).__name__}: {exc}"
                )
            if self.breaker.record_failure():
                self._probe_after_trip(exc)
            return
        device_s = time.perf_counter() - t0
        self.spans.stamp_many(live_rids, "t_predict_end", t0 + device_s)
        if tracer is not None:
            tracer.emit_span("serve.device", start_ts=t0_wall, dur_s=device_s,
                             parent=self._root_span, seq=seq, n=len(live))
        probe = any(p.request.probe for p in live)
        self.service_model.update(device_s, replace=probe)
        # Per-tenant EWMA: each tenant in this batch saw this service time.
        self.queue.note_service({p.request.tenant for p in live}, device_s,
                                replace=probe)
        self.breaker.record_success()
        with self._stats_lock:
            self.state = STATE_SERVING
        self._answer(live, alpha, beta)

    def _probe_after_trip(self, cause: Exception) -> None:
        """The breaker tripped: ONE probe of the card. It answers: a
        ``breaker_probe_ok`` event. It fails: the device is declared lost
        (the module docstring); nothing moves to the CPU."""
        if self.health is None:
            return
        decision = self.health.ensure_responsive(single_attempt=True)
        if decision.ok:
            self._event("breaker_probe_ok", trips=self.breaker.trips,
                        attempts=decision.attempts, cause=repr(cause))
            return
        self._bump("degradations")
        with self._stats_lock:
            self.state = STATE_DEVICE_LOST
        self._event("degradation", scope="serve",
                    reason=f"circuit breaker tripped: {cause!r}; probe: "
                    f"{decision.detail}",
                    probe_attempts=decision.attempts, fallback=None,
                    platform=self.engine.platform)
        print(f"[serve] device lost: the breaker tripped ({cause!r}) and "
              f"the probe failed ({decision.detail}); answering error, no "
              "CPU fallback", file=sys.stderr, flush=True)
