"""Deadline-aware micro-batching queue with admission control.

Counterpart of ``masters_thesis_tpu/serve/queue.py``, without its fault
injection points (the chaos suite comes later). The request path's
robustness rules live here, independent of the device:

- every request carries an absolute deadline (monotonic clock);
- the queue fires a micro-batch when ``max_batch`` requests are waiting or
  the oldest waiting request has aged ``max_wait_s`` — whichever first;
- admission control sheds load EARLY: a request whose deadline the current
  backlog already makes infeasible (estimated via an EWMA of measured
  batch service time) is rejected at submit time with an explicit ``shed``
  response instead of being served late;
- the server converts any response that would still be delivered past its
  deadline into an explicit rejection (server.py);
- admission is TENANT-aware: every request bills to a tenant
  (:class:`TenantClass`) with its own deadline class, shed accounting and
  EWMA service model, used for its forecasts once it has been served.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable

#: Response statuses. ``shed`` and ``rejected_late`` are both explicit
#: rejections — the difference is WHEN the server gave up: at admission
#: (predicted infeasible) vs. after compute (finished past the deadline).
STATUS_OK = "ok"
STATUS_SHED = "shed"
STATUS_REJECTED_LATE = "rejected_late"
STATUS_ERROR = "error"


#: Tenant assigned to requests that don't declare one. Single-tenant
#: deployments never see tenancy — the default tenant is auto-registered
#: and all accounting folds into it.
DEFAULT_TENANT = "default"


@dataclass
class ServeRequest:
    """One predict request: a single window ``x`` of shape (K, T, F) plus
    an absolute deadline on the monotonic clock."""

    rid: int
    x: Any  # np.ndarray (K, T, F)
    deadline_ts: float
    submitted_ts: float = field(default_factory=time.monotonic)
    #: Logical tenant this request bills to (stacked serving: typically
    #: the lane owner). Pure accounting/admission metadata — dispatch
    #: fans every request across all lanes regardless.
    tenant: str = DEFAULT_TENANT


@dataclass
class ServeResponse:
    rid: int
    status: str  # STATUS_* above
    outputs: tuple | None = None  # (alpha (K,), beta (K,)) when ok
    detail: str = ""
    delivered_ts: float = 0.0
    latency_s: float = 0.0

    @property
    def ok(self) -> bool:
        return self.status == STATUS_OK


class PendingRequest:
    """Future for a submitted request; resolved exactly once."""

    def __init__(self, request: ServeRequest):
        self.request = request
        self._done = threading.Event()
        self._response: ServeResponse | None = None

    def resolve(self, response: ServeResponse) -> None:
        if self._done.is_set():  # first resolution wins (shed vs late race)
            return
        self._response = response
        self._done.set()

    def result(self, timeout: float | None = None) -> ServeResponse:
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"request {self.request.rid} unresolved after {timeout}s"
            )
        assert self._response is not None
        return self._response

    @property
    def done(self) -> bool:
        return self._done.is_set()


class ServiceTimeModel:
    """EWMA of measured per-batch service seconds.

    Admission control needs a forecast, not an average over history: the
    EWMA tracks the CURRENT service rate while smoothing over per-batch
    jitter. Thread-safe;
    written by the dispatch thread, read by every submitter.
    """

    def __init__(self, alpha: float = 0.3, initial_s: float = 0.05):
        self.alpha = alpha
        self._batch_s = initial_s
        self._lock = threading.Lock()

    @property
    def batch_s(self) -> float:
        with self._lock:
            return self._batch_s

    def seed(self, batch_s: float) -> None:
        """Reset to a measured value (the engine's warmup timing)."""
        with self._lock:
            self._batch_s = max(1e-6, batch_s)

    def update(self, batch_s: float) -> None:
        with self._lock:
            self._batch_s = (
                self.alpha * max(1e-6, batch_s)
                + (1.0 - self.alpha) * self._batch_s
            )

    def estimate_completion_s(self, queue_depth: int, max_batch: int) -> float:
        """Seconds until a request admitted NOW would complete: the batches
        already ahead of it, plus its own batch."""
        batches_ahead = queue_depth // max(1, max_batch)
        return (batches_ahead + 1) * self.batch_s


@dataclass
class TenantClass:
    """Admission policy + accounting for one tenant.

    ``deadline_s`` is the tenant's deadline CLASS: the default budget
    stamped on its requests when the caller doesn't carry an explicit
    one (an interactive tenant rides a tight class, a batch tenant a
    loose one). The per-tenant :class:`ServiceTimeModel` tracks the
    service rate THIS tenant's batches actually see — seeded from the
    queue-wide model at registration, updated only by this tenant's
    dispatches — so per-tenant admission forecasts stay honest even when
    tenants' deadline classes differ by orders of magnitude.
    """

    name: str
    deadline_s: float | None = None
    model: ServiceTimeModel = field(default_factory=ServiceTimeModel)
    admitted: int = 0
    shed: int = 0
    #: Batches this tenant has actually been served in. Until the first
    #: one, admission falls back to the queue-wide model — a freshly
    #: onboarded tenant must not forecast from an unseeded EWMA.
    observed: int = 0

    def stats(self) -> dict:
        return {
            "admitted": self.admitted,
            "shed": self.shed,
            "deadline_ms": (
                None if self.deadline_s is None else self.deadline_s * 1e3
            ),
            "batch_ms": self.model.batch_s * 1e3,
        }


class MicroBatchQueue:
    """Bounded FIFO with deadline admission and max-wait/max-batch firing."""

    def __init__(
        self,
        max_batch: int = 8,
        max_wait_s: float = 0.005,
        max_depth: int = 256,
        service_model: ServiceTimeModel | None = None,
        on_shed: Callable[[ServeRequest, str], None] | None = None,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1: {max_batch}")
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.max_depth = max_depth
        self.service_model = service_model or ServiceTimeModel()
        self.on_shed = on_shed
        self._items: list[PendingRequest] = []
        self._cond = threading.Condition()
        self._closed = False
        self.submitted = 0
        self.shed = 0
        #: Per-tenant admission state, keyed by tenant name. The default
        #: tenant always exists so single-tenant callers never special-case.
        self._tenants: dict[str, TenantClass] = {}
        self.tenant(DEFAULT_TENANT)

    def __len__(self) -> int:
        with self._cond:
            return len(self._items)

    # ------------------------------------------------------------- tenancy

    def tenant(
        self, name: str, deadline_s: float | None = None
    ) -> tuple[TenantClass, bool]:
        """Look up (auto-registering) a tenant; returns ``(class, created)``.

        A new tenant's EWMA seeds from the queue-wide model's CURRENT
        estimate so its first forecast reflects the engine warmup timing
        rather than the class default. ``deadline_s`` (re)pins the
        tenant's deadline class when given.
        """
        with self._cond:
            t = self._tenants.get(name)
            if t is None:
                t = TenantClass(
                    name=name,
                    deadline_s=deadline_s,
                    model=ServiceTimeModel(
                        initial_s=self.service_model.batch_s
                    ),
                )
                self._tenants[name] = t
                return t, True
            if deadline_s is not None:
                t.deadline_s = deadline_s
            return t, False

    def tenant_deadline_s(self, name: str) -> float | None:
        """The tenant's deadline class (None when it never declared one)."""
        with self._cond:
            t = self._tenants.get(name)
            return t.deadline_s if t is not None else None

    def note_service(self, tenants, batch_s: float) -> None:
        """Fold one measured batch service time into each named tenant's
        EWMA (called by the dispatch loop after compute)."""
        with self._cond:
            ts = [
                self._tenants[n] for n in set(tenants) if n in self._tenants
            ]
            for t in ts:
                t.observed += 1
        for t in ts:  # EWMA has its own lock; keep it out of _cond
            t.model.update(batch_s)

    def tenant_stats(self) -> dict:
        """``{tenant: {admitted, shed, deadline_ms, batch_ms}}`` snapshot."""
        with self._cond:
            return {
                name: t.stats()
                for name, t in sorted(self._tenants.items())
            }

    def _shed(self, pending: PendingRequest, reason: str) -> PendingRequest:
        # Only the counter bump takes the lock: resolving the pending and
        # the on_shed callback run unlocked, so a callback that takes its
        # own lock cannot invert the lock order against the dispatch path.
        with self._cond:
            self.shed += 1
            t = self._tenants.get(pending.request.tenant)
            if t is not None:
                t.shed += 1
        now = time.monotonic()
        pending.resolve(
            ServeResponse(
                rid=pending.request.rid,
                status=STATUS_SHED,
                detail=reason,
                delivered_ts=now,
                latency_s=now - pending.request.submitted_ts,
            )
        )
        if self.on_shed is not None:
            self.on_shed(pending.request, reason)
        return pending

    def submit(self, request: ServeRequest) -> PendingRequest:
        """Admit or shed; always returns a PendingRequest (a shed one is
        already resolved). Never blocks on capacity — backpressure is an
        explicit rejection, not a stalled caller."""
        pending = PendingRequest(request)
        tenant, _ = self.tenant(request.tenant)
        with self._cond:
            self.submitted += 1
            depth = len(self._items)
            closed = self._closed
        if closed:
            return self._shed(pending, "server shutting down")
        if depth >= self.max_depth:
            return self._shed(pending, f"queue full (depth {depth})")
        # Forecast with the tenant's OWN service model once it has seen a
        # batch (its requests may systematically differ from the
        # aggregate); a fresh tenant uses the queue-wide EWMA.
        model = tenant.model if tenant.observed > 0 else self.service_model
        est = model.estimate_completion_s(depth, self.max_batch)
        now = time.monotonic()
        if now + est > request.deadline_ts:
            budget_ms = (request.deadline_ts - now) * 1e3
            return self._shed(
                pending,
                f"deadline infeasible: est {est * 1e3:.1f}ms > "
                f"budget {budget_ms:.1f}ms at depth {depth}",
            )
        with self._cond:
            if not self._closed:  # re-check under the lock (close() raced us)
                self._items.append(pending)
                tenant.admitted += 1
                self._cond.notify_all()
                return pending
        return self._shed(pending, "server shutting down")

    def next_batch(self, timeout_s: float = 0.1) -> list[PendingRequest]:
        """Block until a micro-batch is ready; [] on timeout or close.

        Fires when ``max_batch`` requests are waiting, or the oldest
        waiting request has aged ``max_wait_s`` — latency is bounded by
        max-wait even at low QPS, throughput by max-batch at high QPS.
        """
        deadline = time.monotonic() + timeout_s
        with self._cond:
            while True:
                now = time.monotonic()
                if self._items:
                    oldest = self._items[0].request.submitted_ts
                    fire_at = oldest + self.max_wait_s
                    if (
                        len(self._items) >= self.max_batch
                        or now >= fire_at
                        or self._closed
                    ):
                        batch = self._items[: self.max_batch]
                        del self._items[: len(batch)]
                        return batch
                    wake = min(fire_at, deadline)
                else:
                    if self._closed or now >= deadline:
                        return []
                    wake = deadline
                if now >= wake:
                    # Timed out while a batch is still aging toward its
                    # max-wait; hand control back so the caller can re-poll
                    # (and observe a stop request) instead of spinning.
                    return []
                self._cond.wait(wake - now)

    def close(self) -> None:
        """Stop admitting; wake consumers so they can drain the remainder."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    @property
    def closed(self) -> bool:
        with self._cond:
            return self._closed
