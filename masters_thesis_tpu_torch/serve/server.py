"""The serving loop: queue -> engine dispatch and deadline enforcement.

Counterpart of ``masters_thesis_tpu/serve/server.py``. The engine is
injected. Invariants this module owns:

- **No late answers.** A response is delivered as ``ok`` only if it is
  handed back BEFORE the request's deadline; a batch that finishes late
  resolves those requests as explicit ``rejected_late`` rejections. The
  ``late_deliveries`` counter (an ok delivered past its deadline) must
  therefore stay 0 by construction.
- **Failures are answers.** A dispatch that raises resolves its requests as
  explicit ``error`` responses and feeds a :class:`CircuitBreaker`, whose
  trips are counted. There is no CPU failover in this port: after a trip
  the server keeps dispatching to the same engine.
- **Non-finite outputs never leave.** A batch whose outputs contain
  NaN/inf resolves as ``error``.

Telemetry, request spans, the metrics endpoint, the quality monitor and
fault points of the JAX server are not ported.
"""

from __future__ import annotations

import collections
import threading
import time

import numpy as np

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
    """Collapse the queue's free-text shed reasons into stable categories."""
    if reason.startswith("server shutting down"):
        return "shutdown"
    if reason.startswith("queue full"):
        return "queue_full"
    if reason.startswith("deadline infeasible"):
        return "deadline_infeasible"
    return "other"


#: ok deliveries whose latencies stats() reports quantiles over.
LATENCY_WINDOW = 65536


class PredictServer:
    """Owns the queue, the dispatch thread and the request accounting."""

    def __init__(
        self,
        engine,
        *,
        max_batch: int | None = None,
        max_wait_s: float = 0.005,
        max_depth: int = 256,
        breaker_threshold: int = 3,
    ):
        self.engine = engine
        self.breaker = CircuitBreaker(breaker_threshold)
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
        self._rid = 0
        self._rid_lock = threading.Lock()
        self._started_ts: float | None = None
        # Counters are written from the dispatch thread and read by stats()
        # from whatever thread asks; _stats_lock keeps them consistent.
        self._stats_lock = threading.Lock()
        self.completed = 0
        self.errors = 0
        self.late_converted = 0
        #: ok responses delivered past their deadline — 0 by construction.
        self.late_deliveries = 0
        self.dispatches = 0
        self.shed_by_reason: dict[str, int] = {}
        #: Latencies of the most recent ok deliveries (p50/p99 in stats()).
        self._latencies_s: collections.deque = collections.deque(
            maxlen=LATENCY_WINDOW
        )
        #: Dispatches by batch size, before padding to a bucket.
        self.batch_size_counts: dict[int, int] = {}

    def _bump(self, name: str, n: int = 1) -> None:
        with self._stats_lock:
            setattr(self, name, getattr(self, name) + n)

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        if self._thread is not None:
            raise RuntimeError("server already started")
        self.service_model.seed(self.engine.warmup())
        self._started_ts = time.monotonic()
        self._thread = threading.Thread(
            target=self._worker, name="serve-dispatch", daemon=True
        )
        self._thread.start()

    def stop(self) -> dict:
        """Drain, stop the dispatch thread; returns the summary stats."""
        self.queue.close()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            if self._thread.is_alive():
                raise RuntimeError("dispatch thread did not stop within 30 s")
            self._thread = None
        return self.stats()

    def stats(self) -> dict:
        span = (
            time.monotonic() - self._started_ts
            if self._started_ts is not None
            else 0.0
        )
        with self._stats_lock:
            lat = np.asarray(self._latencies_s)
            stats = {
                "requests": self.queue.submitted,
                "completed": self.completed,
                "shed": self.queue.shed,
                "shed_by_reason": dict(self.shed_by_reason),
                "errors": self.errors,
                "late_converted": self.late_converted,
                "late_deliveries": self.late_deliveries,
                "dispatches": self.dispatches,
                "breaker_trips": self.breaker.trips,
                "batch_size_counts": dict(self.batch_size_counts),
            }
        stats.update(
            tenants=self.queue.tenant_stats(),
            p50_ms=float(np.percentile(lat, 50) * 1e3) if lat.size else None,
            p99_ms=float(np.percentile(lat, 99) * 1e3) if lat.size else None,
            qps=stats["completed"] / span if span > 0 else 0.0,
            wall_s=span,
        )
        return stats

    # -------------------------------------------------------------- request

    def register_tenant(
        self, name: str, deadline_s: float | None = None
    ) -> None:
        """Onboard (or re-class) a tenant: pins its deadline class."""
        self.queue.tenant(name, deadline_s)

    def submit(
        self,
        x,
        deadline_s: float | None = None,
        tenant: str = DEFAULT_TENANT,
    ) -> PendingRequest:
        """Admit one window with a relative deadline budget in seconds.

        ``deadline_s=None`` falls back to ``tenant``'s deadline class
        (register_tenant); a request with neither is a caller bug.
        """
        x = np.asarray(x, np.float32)
        if x.shape != tuple(self.engine.window_shape):
            raise ValueError(
                f"request window shape {x.shape} != engine window shape "
                f"{tuple(self.engine.window_shape)}"
            )
        if deadline_s is None:
            deadline_s = self.queue.tenant_deadline_s(tenant)
            if deadline_s is None:
                raise ValueError(
                    f"request carries no deadline and tenant {tenant!r} "
                    "has no deadline class (register_tenant first)"
                )
        with self._rid_lock:
            self._rid += 1
            rid = self._rid
        return self.queue.submit(
            ServeRequest(
                rid=rid, x=x, deadline_ts=time.monotonic() + deadline_s,
                tenant=tenant,
            )
        )

    def _on_shed(self, request: ServeRequest, reason: str) -> None:
        category = shed_category(reason)
        with self._stats_lock:
            self.shed_by_reason[category] = (
                self.shed_by_reason.get(category, 0) + 1
            )

    # ------------------------------------------------------------- dispatch

    def _worker(self) -> None:
        while True:
            batch = self.queue.next_batch(timeout_s=0.05)
            if not batch:
                if self.queue.closed and len(self.queue) == 0:
                    return
                continue
            self._dispatch(batch)

    def _resolve(self, pending: PendingRequest, status: str, detail: str = "",
                 outputs: tuple | None = None) -> None:
        now = time.monotonic()
        pending.resolve(
            ServeResponse(
                rid=pending.request.rid,
                status=status,
                outputs=outputs,
                detail=detail,
                delivered_ts=now,
                latency_s=now - pending.request.submitted_ts,
            )
        )

    def _dispatch(self, batch: list[PendingRequest]) -> None:
        # Pre-dispatch feasibility re-check: queue wait may have eaten a
        # request's whole budget; spending device time on it would only
        # produce a late answer — reject now, serve the rest.
        est = self.service_model.batch_s
        now = time.monotonic()
        live: list[PendingRequest] = []
        for p in batch:
            if now + est > p.request.deadline_ts:
                self._bump("late_converted")
                self._resolve(
                    p, STATUS_REJECTED_LATE,
                    "deadline infeasible at dispatch (queue wait consumed "
                    "the budget); rejected rather than served late",
                )
            else:
                live.append(p)
        if not live:
            return
        with self._stats_lock:
            self.dispatches += 1
            self.batch_size_counts[len(live)] = (
                self.batch_size_counts.get(len(live), 0) + 1
            )
        t0 = time.perf_counter()
        try:
            alpha, beta = self.engine.predict(
                np.stack([p.request.x for p in live])
            )
        except Exception as exc:  # noqa: BLE001 — any dispatch failure
            self._bump("errors", len(live))
            for p in live:
                self._resolve(
                    p, STATUS_ERROR, f"{type(exc).__name__}: {exc}"
                )
            self.breaker.record_failure()
            return
        device_s = time.perf_counter() - t0
        self.service_model.update(device_s)
        # Per-tenant EWMA: each tenant in this batch saw this service time.
        self.queue.note_service({p.request.tenant for p in live}, device_s)
        self.breaker.record_success()
        finite = bool(np.isfinite(alpha).all() and np.isfinite(beta).all())
        now = time.monotonic()
        for i, p in enumerate(live):
            if not finite:
                self._bump("errors")
                self._resolve(
                    p, STATUS_ERROR,
                    "non-finite predictions; response withheld",
                )
            elif now > p.request.deadline_ts:
                self._bump("late_converted")
                self._resolve(
                    p, STATUS_REJECTED_LATE,
                    "batch completed past the deadline; rejected rather "
                    "than delivered late",
                )
            else:
                with self._stats_lock:
                    self.completed += 1
                    self._latencies_s.append(now - p.request.submitted_ts)
                self._resolve(p, STATUS_OK, outputs=(alpha[i], beta[i]))
                if time.monotonic() > p.request.deadline_ts:
                    # The delivery itself slid past the deadline — this
                    # must never happen (the check above runs against the
                    # same clock); count it so a run can fail loudly.
                    self._bump("late_deliveries")
