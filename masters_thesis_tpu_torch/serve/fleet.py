"""The serving fleet: N engine replicas behind one deadline queue.

Counterpart of ``masters_thesis_tpu/serve/fleet.py``. One engine behind one
server (``server.py``) makes the loss of that engine an outage; the fleet
serves from N replicas —

- **Replicas.** Each :class:`Replica` holds one engine built by its
  factory (a zero-argument callable; each (re)boot calls it afresh, so a
  restart is a new engine: its own bucket graphs, side streams and lock),
  with its own EWMA :class:`~.queue.ServiceTimeModel`, its own
  :class:`~.server.CircuitBreaker` and its own worker thread. Replicas on
  disjoint cards come from :func:`partition_devices`; on one card the
  factories name the device themselves and the replicas share it.
- **Least-loaded dispatch.** The shared :class:`~.queue.MicroBatchQueue`
  feeds a scheduler that gives each micro-batch to the serving replica
  with the smallest estimated completion (its EWMA times its backlog).
- **Per-replica admission.** The queue's ``feasibility`` hook sheds a
  request at admission only when EVERY serving replica's own estimate
  misses its deadline. As in the port's queue, a request the estimates
  would shed at an empty queue is admitted as a probe when a serving
  replica's forecast has gone stale (``PROBE_AFTER_S``): the probe's batch
  goes to a stale replica and its measurement replaces that forecast.
- **Failure by evidence.** A crash (``FaultInjected`` or any unexpected
  exception in the worker), a hang (the watchdog: a batch in flight past
  ``hang_timeout_s``), a boot failure, or a tripped breaker declares the
  replica DEAD; :class:`~masters_thesis_tpu_torch.resilience.supervisor.
  ReplicaRestartPolicy` classifies the death (transient: restart after a
  backoff; the same fingerprint twice in a row, or a spent budget: halt),
  and a restart boots a fresh engine generation from the factory.
- **No late answers, fleet-wide.** A dead replica's in-flight and queued
  batches go to survivors whose estimate still meets their deadlines
  (the request keeps its ONE span, marked ``redispatched_from``); the rest
  are rejected explicitly. Every answer goes back under the one-engine
  server's hand-back rule (:class:`~.server.DeadlineServing`, shared):
  ``ok`` only with ``handback_guard_s`` left, checked answer by answer.

- **Warm restarts.** Factories that build their engines on one shared
  ``serve/program_cache.py`` ``ProgramCache`` restart warm: a replica dead
  by its breaker or a crash has no dispatch in flight, so its engine is
  closed into the cache as it is declared dead, and the next generation's
  ``warmup`` takes its graphs (``replica_started`` carries
  ``cache_hits``). A hung replica gives nothing back.

Where it departs from the JAX fleet: a tripped breaker first spends ONE
probe of the card (``health=``, a ``utils.backend_probe.BackendHealth``).
If it answers (``breaker_probe_ok``), or with ``health=None``, the breaker
kills its replica (``replica_dead`` with ``cause="breaker"``) and the
restart policy brings a new generation up on the factory's device. If it
fails, the device is lost: ``degradations`` is counted, a ``degradation``
event (``fallback: null``) is written and the replica is halted with
``cause="device_lost"`` rather than restarted onto a dead card. The JAX
fleet rebuilds the replica on the CPU, which the port never does:
``STATE_DEGRADED`` is never entered.
The JAX fleet checks a batch's deadline once before its answers go back;
this one checks each answer (above). Latency quantiles come from the
recent ok latencies, as in the port's server.

It imports no torch (engines arrive through factories; only
:func:`partition_devices` imports it, when called), so the selfcheck drives
the whole state machine with fake engines.

Fault points: ``serve.replica_dispatch`` (context ``replica``, ``seq``,
``n``; ``wedge``: a device error that feeds the breaker; ``nan`` or
``corrupt``: poisoned answers, withheld; ``raise``: a crash; ``hang``: the
watchdog's) and ``serve.replica_boot`` (``replica``, ``generation``;
``wedge`` or ``raise``: a boot failure). Match ``{"replica": name}`` to
pick one replica.
"""

from __future__ import annotations

import hashlib
import queue as stdqueue
import re
import threading
import time

import numpy as np

from masters_thesis_tpu_torch.resilience import faults
from masters_thesis_tpu_torch.resilience.supervisor import ReplicaRestartPolicy
from masters_thesis_tpu_torch.serve.queue import (
    STATUS_ERROR,
    MicroBatchQueue,
    PendingRequest,
    ServeRequest,
    ServiceTimeModel,
)
from masters_thesis_tpu_torch.serve.server import (
    CircuitBreaker,
    DeadlineServing,
    InjectedDeviceError,
)

#: Replica states.
STATE_LIVE = "live"
#: Kept for the JAX fleet's names; the port never enters it (a tripped
#: breaker kills the replica, or halts it when the card is lost).
STATE_DEGRADED = "degraded"
STATE_DRAINING = "draining"
STATE_DEAD = "dead"
#: States that accept new batches.
SERVING_STATES = (STATE_LIVE, STATE_DEGRADED)


class ReplicaBootError(RuntimeError):
    """A replica's engine failed to boot (an injected boot fault)."""


def partition_devices(n_replicas: int, devices=None) -> list:
    """``n_replicas`` disjoint device groups of the visible cards (or of
    ``devices``), as the JAX fleet partitions its meshes: a
    ``ValueError`` when asked for more replicas than devices. The only
    helper of this module that imports torch."""
    if devices is None:
        import torch

        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_replicas < 1 or n_replicas > len(devices):
        raise ValueError(f"cannot build {n_replicas} replicas from "
                         f"{len(devices)} devices")
    per = len(devices) // n_replicas
    return [devices[i * per:(i + 1) * per] for i in range(n_replicas)]


class Replica:
    """One engine slot: state, worker thread and its own load model."""

    def __init__(self, name: str, engine_factory, breaker_threshold: int = 3):
        self.name = name
        self.engine_factory = engine_factory
        self.engine = None
        self.service_model = ServiceTimeModel()
        self.breaker = CircuitBreaker(breaker_threshold)
        self._breaker_threshold = breaker_threshold
        self.state = STATE_DEAD  # not serving until booted
        self.halted = False
        self.generation = 0
        #: The newest generation that booted, warmed up and went live
        #: (0: none yet); a later death leaves it as it was.
        self.live_generation = 0
        self.inbox: stdqueue.Queue = stdqueue.Queue()
        self.stop_event = threading.Event()
        self.thread: threading.Thread | None = None
        self.span = None
        #: Set while a batch is on the device: the hang watchdog's clock.
        self.busy_since: float | None = None
        self.current_batch: list[PendingRequest] | None = None
        self.completed = 0
        self.errors = 0
        self.dispatches = 0
        self.busy_s = 0.0
        self.boot_s: float | None = None

    def backlog_estimate_s(self) -> float:
        """Seconds until a batch assigned NOW would complete here."""
        waiting = self.inbox.qsize() + (1 if self.busy_since else 0)  # mtt: disable=CL502 -- advisory estimate; a stale busy_since only skews replica choice
        return (waiting + 1) * self.service_model.batch_s


class FleetServer(DeadlineServing):
    """Owns the queue, the scheduler, N replicas and the failover policy.

    ``engine_factories`` maps a replica's name to a zero-argument callable
    that returns an engine (``warmup``, ``predict``, ``window_shape``,
    ``max_bucket``, ``platform``, ``compile_events``).
    """

    def __init__(
        self,
        engine_factories: dict,
        *,
        max_batch: int = 8,
        max_wait_s: float = 0.005,
        max_depth: int = 256,
        telemetry=None,
        breaker_threshold: int = 3,
        restart_policy: ReplicaRestartPolicy | None = None,
        hang_timeout_s: float = 2.0,
        metrics_port: int | None = None,
        slo_rules=None,
        quality_monitor=None,
        health=None,
    ):
        if not engine_factories:
            raise ValueError("fleet needs at least one engine factory")
        super().__init__(telemetry=telemetry, metrics_port=metrics_port,
                         slo_rules=slo_rules, quality_monitor=quality_monitor)
        self.restart_policy = restart_policy or ReplicaRestartPolicy()
        self.hang_timeout_s = hang_timeout_s
        #: The card's probe after a breaker trip (None: no probe).
        self.health = health
        self.replicas: dict[str, Replica] = {
            name: Replica(name, factory, breaker_threshold)
            for name, factory in engine_factories.items()
        }
        self.queue = MicroBatchQueue(
            max_batch=max_batch,
            max_wait_s=max_wait_s,
            max_depth=max_depth,
            on_shed=self._on_shed,
            feasibility=self._feasibility,
        )
        #: Replica states, generations and the hand-over of their work.
        self._lock = threading.RLock()
        self._scheduler: threading.Thread | None = None
        self._monitor: threading.Thread | None = None
        self._boot_threads: list[threading.Thread] = []
        self._stop = threading.Event()
        self._dispatch_seq = 0
        self._shape: tuple | None = None
        self.deaths = 0
        self.redispatched = 0

    def _window_shape(self) -> tuple:
        if self._shape is None:
            raise RuntimeError("fleet not started")
        return self._shape

    # ------------------------------------------------------------ admission

    def _serving(self) -> list[Replica]:
        with self._lock:
            return [r for r in self.replicas.values()
                    if r.state in SERVING_STATES]

    def _feasibility(self, request: ServeRequest, depth: int) -> str | None:
        """The queue's admission hook: shed only when EVERY serving
        replica's own estimate misses the deadline; at an empty queue a
        replica with a stale forecast takes the request as a probe."""
        serving = self._serving()
        if not serving:
            return "no live replicas (fleet dead or halted)"
        # The waiting queue spreads over the fleet: charge each replica its
        # backlog plus an even share of the unassigned queue.
        share = depth // max(1, len(serving) * self.queue.max_batch)
        best = min(r.backlog_estimate_s() + share * r.service_model.batch_s
                   for r in serving)
        now = time.monotonic()
        if now + best <= request.deadline_ts:
            return None
        if depth == 0 and any(r.service_model.stale(now) for r in serving):
            request.probe = True
            return None
        budget_ms = (request.deadline_ts - now) * 1e3
        return (f"deadline infeasible on ALL {len(serving)} serving "
                f"replicas: best est {best * 1e3:.1f}ms > budget "
                f"{budget_ms:.1f}ms at depth {depth}")

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        if self._scheduler is not None:
            raise RuntimeError("fleet already started")
        tracer = self._tracer()
        if tracer is not None:
            self._root_span = tracer.start("serve.fleet",
                                           replicas=sorted(self.replicas))
        for replica in self.replicas.values():
            self._boot_replica(replica, initial=True)
        serving = self._serving()
        if not serving:
            raise RuntimeError("fleet start failed: no replica survived boot")
        # Any replica must be able to take any batch: the micro-batch never
        # exceeds the smallest replica's largest bucket.
        cap = min(r.engine.max_bucket for r in serving)
        self.queue.max_batch = min(self.queue.max_batch, cap)
        self._shape = tuple(serving[0].engine.window_shape)
        self._started_ts = time.monotonic()
        self._event("fleet_started", replicas=sorted(self.replicas),
                    serving=[r.name for r in serving],
                    max_batch=self.queue.max_batch)
        self._scheduler = threading.Thread(
            target=self._scheduler_loop, name="fleet-scheduler", daemon=True)
        self._scheduler.start()
        self._monitor = threading.Thread(
            target=self._monitor_loop, name="fleet-monitor", daemon=True)
        self._monitor.start()
        self._start_plane()

    def stop(self) -> dict:
        """Drain, stop every thread, emit ``fleet_finished``; returns the
        summary stats the event carries."""
        self._stop_plane()
        self.queue.close()
        with self._lock:
            for r in self.replicas.values():
                if r.state in SERVING_STATES:
                    r.state = STATE_DRAINING
        if self._scheduler is not None:
            self._scheduler.join(timeout=30.0)
            self._scheduler = None
        # A restart may be mid-boot: wait for it before the workers'
        # sentinels, so that its fresh worker receives one too.
        with self._lock:
            boots = list(self._boot_threads)
        for t in boots:
            t.join(timeout=30.0)
        for r in self.replicas.values():
            if r.thread is not None:
                r.inbox.put(None)  # drain sentinel
                r.thread.join(timeout=30.0)
        self._stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=5.0)
            self._monitor = None
        stats = self.stats()
        tracer = self._tracer()
        if tracer is not None:
            for r in self.replicas.values():
                if r.span is not None:
                    tracer.end(r.span, status="ok", completed=r.completed,
                               busy_s=r.busy_s)  # mtt: disable=CL502 -- workers joined above; no concurrent writer remains
                    r.span = None
            if self._root_span is not None:
                tracer.end(self._root_span, status="ok",
                           requests=stats["requests"],
                           completed=stats["completed"], shed=stats["shed"])
                self._root_span = None
        self._event("fleet_finished", **stats)
        return stats

    def stats(self) -> dict:
        span = self._wall_s()
        queue_wait_share, compute_share = self.spans.shares()
        with self._lock:
            per_replica = {
                r.name: {
                    "state": r.state,
                    "generation": r.generation,
                    "restarts": self.restart_policy.restarts(r.name),
                    "completed": r.completed,
                    "errors": r.errors,
                    "dispatches": r.dispatches,
                    "busy_s": r.busy_s,
                    "utilization": r.busy_s / span if span > 0 else 0.0,
                    "batch_ms": r.service_model.batch_s * 1e3,
                    "boot_s": r.boot_s,
                }
                for r in self.replicas.values()
            }
            lanes = max((getattr(r.engine, "num_lanes", 1)
                         for r in self.replicas.values()
                         if r.engine is not None), default=1)
        with self._stats_lock:
            counters = {
                "completed": self.completed,
                "errors": self.errors,
                "late_converted": self.late_converted,
                "late_deliveries": self.late_deliveries,
                "handback_max_ms": 1e3 * self.handback_max_s,
                "degradations": self.degradations,
                "deaths": self.deaths,
                "redispatched": self.redispatched,
                "shed_by_reason": dict(self.shed_by_reason),
            }
        return {
            "replicas": per_replica,
            "n_live": sum(1 for v in per_replica.values()
                          if v["state"] in SERVING_STATES),
            "queue_wait_share": queue_wait_share,
            "compute_share": compute_share,
            "tenants": self.queue.tenant_stats(),
            "lanes": lanes,
            "requests": self.queue.submitted,
            "shed": self.queue.shed,
            **counters,
            **self._latency_ms(),
            "qps": counters["completed"] / span if span > 0 else 0.0,
            "wall_s": span,
        }

    # ------------------------------------------------------------ scheduler

    def _scheduler_loop(self) -> None:
        while True:
            batch = self.queue.next_batch(timeout_s=0.05)
            if not batch:
                if self.queue.closed and len(self.queue) == 0:
                    return
                continue
            self.spans.stamp_many([p.request.rid for p in batch], "t_pickup",
                                  time.perf_counter())
            self._assign(batch)

    def _pick_replica(self, probe: bool = False) -> Replica | None:
        """The least-loaded serving replica by ITS OWN estimate; a probe's
        batch goes to one whose forecast is stale, if any is."""
        serving = self._serving()
        if probe:
            now = time.monotonic()
            serving = ([r for r in serving if r.service_model.stale(now)]
                       or serving)
        if not serving:
            return None
        return min(serving, key=lambda r: r.backlog_estimate_s())

    def _assign(self, batch: list[PendingRequest]) -> None:
        target = self._pick_replica(any(p.request.probe for p in batch))
        if target is None:
            for p in batch:
                if not p.done:
                    self.queue._shed(p, "no live replicas (fleet dead or "
                                     "halted)")
            return
        target.inbox.put(batch)

    # --------------------------------------------------------------- worker

    def _worker_loop(self, replica: Replica, generation: int) -> None:
        while not replica.stop_event.is_set():
            try:
                batch = replica.inbox.get(timeout=0.05)
            except stdqueue.Empty:
                with self._lock:
                    drained = (replica.state == STATE_DRAINING
                               and replica.inbox.empty())
                if drained:
                    return
                continue
            if batch is None:  # drain sentinel from stop()
                return
            with self._lock:
                if replica.generation != generation:
                    # A newer generation owns this replica: hand the work
                    # back to the scheduler rather than race it.
                    self._assign([p for p in batch if not p.done])
                    return
                replica.busy_since = time.monotonic()
                replica.current_batch = batch
            try:
                self._dispatch_on(replica, batch)
            except BaseException as exc:  # noqa: BLE001 — a fatal death
                self._declare_dead(replica, fingerprint=self._fingerprint(exc),
                                   detail=f"{type(exc).__name__}: {exc}",
                                   cause="crash")
                return
            finally:
                with self._lock:
                    replica.current_batch = None
                    replica.busy_since = None

    def _dispatch_on(self, replica: Replica,
                     batch: list[PendingRequest]) -> None:
        who = {"replica": replica.name}
        live = self._recheck(batch, replica.service_model.batch_s, **who)
        if not live:
            return
        with self._lock:
            seq = self._dispatch_seq
            self._dispatch_seq += 1
            replica.dispatches += 1
        # The process kinds (raise: a crash, hang: the watchdog's) act
        # inside fire(); the data kinds come back to be applied here.
        kind = faults.fire("serve.replica_dispatch", replica=replica.name,
                           seq=seq, n=len(live))
        live_rids = [p.request.rid for p in live]
        t0_wall = time.time()
        t0 = time.perf_counter()
        self.spans.stamp_many(live_rids, "t_predict0", t0)
        try:
            if kind == "wedge":
                raise InjectedDeviceError(
                    f"injected device error on {replica.name} seq={seq}")
            alpha, beta = replica.engine.predict(
                np.stack([p.request.x for p in live]))
            if kind in ("nan", "corrupt"):
                alpha = np.full_like(alpha, np.nan)
        except faults.FaultInjected:
            raise  # fatal: the worker loop declares this replica dead
        except Exception as exc:  # noqa: BLE001 — a device or runtime error
            self.spans.stamp_many(live_rids, "t_predict_end",
                                  time.perf_counter())
            self._bump("errors", len(live))
            with self._lock:
                replica.errors += len(live)
            for p in live:
                self._resolve(p, STATUS_ERROR,
                              f"{type(exc).__name__}: {exc}", **who)
            if replica.breaker.record_failure():
                detail = f"circuit breaker tripped: {type(exc).__name__}: {exc}"
                cause = self._probe_after_trip(replica, exc, detail)
                self._declare_dead(replica, fingerprint=self._fingerprint(exc),
                                   detail=detail, cause=cause)
            return
        device_s = time.perf_counter() - t0
        self.spans.stamp_many(live_rids, "t_predict_end", t0 + device_s)
        tracer = self._tracer()
        if tracer is not None:
            tracer.emit_span("serve.device", start_ts=t0_wall, dur_s=device_s,
                             parent=replica.span or self._root_span, seq=seq,
                             n=len(live), replica=replica.name)
        with self._lock:
            replica.busy_s += device_s
        probe = any(p.request.probe for p in live)
        replica.service_model.update(device_s, replace=probe)
        # Per-tenant EWMA: each tenant in this batch saw this service time.
        self.queue.note_service({p.request.tenant for p in live}, device_s,
                                replace=probe)
        replica.breaker.record_success()
        self.restart_policy.note_healthy(replica.name)
        delivered, finite = self._answer(live, alpha, beta, **who)
        with self._lock:
            replica.completed += len(delivered)
            replica.errors += 0 if finite else len(live)

    # ------------------------------------------------------------- failover

    @staticmethod
    def _fingerprint(exc: BaseException) -> str:
        # Digits are normalised out: a crash message that embeds a sequence
        # number or an address must still fingerprint as the SAME failure,
        # or the deterministic halt could never trigger.
        norm = re.sub(r"\d+", "#", f"{type(exc).__name__}|{exc}")
        return hashlib.sha1(norm.encode()).hexdigest()[:12]

    def _probe_after_trip(self, replica: Replica, exc: Exception,
                          detail: str) -> str:
        """One probe of the card after ``replica``'s breaker tripped: the
        cause of its death, ``breaker`` (restarted by the policy) or
        ``device_lost`` (halted; a ``degradation`` event)."""
        if self.health is None:
            return "breaker"
        decision = self.health.ensure_responsive(single_attempt=True)
        if decision.ok:
            self._event("breaker_probe_ok", replica=replica.name,
                        trips=replica.breaker.trips,
                        attempts=decision.attempts, cause=repr(exc))
            return "breaker"
        self._bump("degradations")
        self._event("degradation", scope="serve", replica=replica.name,
                    reason=f"{detail}; probe: {decision.detail}",
                    probe_attempts=decision.attempts, fallback=None,
                    platform=replica.engine.platform)
        return "device_lost"

    def _declare_dead(self, replica: Replica, *, fingerprint: str,
                      detail: str, cause: str) -> None:
        with self._lock:
            if replica.state == STATE_DEAD:
                return
            replica.state = STATE_DEAD
            replica.stop_event.set()
            generation = replica.generation
            orphans: list[PendingRequest] = []
            if replica.current_batch is not None:
                orphans.extend(replica.current_batch)
                replica.current_batch = None
                replica.busy_since = None
            while True:
                try:
                    batch = replica.inbox.get_nowait()
                except stdqueue.Empty:
                    break
                if batch:
                    orphans.extend(batch)
        with self._stats_lock:
            self.deaths += 1
        self._count("replica_deaths")
        # replica_gen, not "generation": that name is the fleet
        # supervisor's envelope key (telemetry.events.RESERVED_KEYS).
        self._event("replica_dead", replica=replica.name,
                    replica_gen=generation, cause=cause,
                    fingerprint=fingerprint, detail=detail,
                    orphaned=len(orphans))
        tracer = self._tracer()
        if tracer is not None and replica.span is not None:
            tracer.end(replica.span, status="dead", cause=cause,
                       completed=replica.completed, busy_s=replica.busy_s)  # mtt: disable=CL502 -- span attribute of a replica already declared dead; a stale total only skews the span
            replica.span = None
        self._redispatch(replica, orphans)
        if cause in ("breaker", "crash"):
            # No dispatch in flight: its programs go back to its engine's
            # program cache, for the next generation's warm boot.
            close = getattr(replica.engine, "close", None)
            if close is not None:
                close()
        if cause == "device_lost":
            with self._lock:
                replica.halted = True
            self._event("replica_halted", replica=replica.name,
                        verdict="device_lost", detail=detail)
            return
        self._after_failure(replica, fingerprint, detail)

    def _after_failure(self, replica: Replica, fingerprint: str,
                       detail: str, initial: bool = False) -> None:
        """Classify a death or a boot failure: a restart after its backoff
        (inline for a failed first boot, which ``start`` waits for), or a
        halt."""
        verdict = self.restart_policy.classify(replica.name, fingerprint,
                                               detail)
        if verdict.action != "restart":
            with self._lock:
                replica.halted = True
                replica.state = STATE_DEAD
            self._event("replica_halted", replica=replica.name,
                        verdict=verdict.kind, detail=verdict.detail)
            return
        if initial:
            time.sleep(verdict.backoff_s)
            self._boot_replica(replica)
            return
        self._event("replica_restart_scheduled", replica=replica.name,
                    backoff_s=verdict.backoff_s,
                    restarts=self.restart_policy.restarts(replica.name))
        timer = threading.Thread(target=self._delayed_boot,
                                 args=(replica, verdict.backoff_s),
                                 name=f"fleet-boot-{replica.name}",
                                 daemon=True)
        # Listed and started as one step: stop() joins only started ones.
        with self._lock:
            self._boot_threads.append(timer)
            timer.start()

    def _redispatch(self, dead: Replica,
                    orphans: list[PendingRequest]) -> None:
        """A dead replica's unresolved work to the least-loaded survivor
        whose estimate meets its deadline; the rest rejected explicitly.
        The request keeps its ONE span, marked ``redispatched_from``."""
        for p in orphans:
            if p.done:
                continue
            now = time.monotonic()
            serving = self._serving()
            feasible = [r for r in serving
                        if now + r.backlog_estimate_s()
                        <= p.request.deadline_ts]
            if not feasible:
                self._reject_late(
                    p, f"replica {dead.name} died; "
                    + ("no live replica remains" if not serving
                       else "no survivor can meet the deadline"))
                continue
            target = min(feasible, key=lambda r: r.backlog_estimate_s())
            self._bump("redispatched")
            self.spans.annotate(p.request.rid, redispatched_from=dead.name)
            self._event("redispatch", rid=p.request.rid,
                        from_replica=dead.name, to_replica=target.name)
            target.inbox.put([p])

    def _delayed_boot(self, replica: Replica, backoff_s: float) -> None:
        if backoff_s > 0:
            time.sleep(backoff_s)
        if self.queue.closed:
            return
        self._boot_replica(replica)

    def _boot_replica(self, replica: Replica, initial: bool = False) -> None:
        """(Re)build the replica's engine from its factory: a fresh
        generation, warmed up (on the card: its graphs captured) before it
        takes a batch."""
        with self._lock:
            if replica.halted or (not initial and self.queue.closed):
                return
            replica.generation += 1
            generation = replica.generation
        try:
            kind = faults.fire("serve.replica_boot", replica=replica.name,
                               generation=generation)
            if kind == "wedge":
                raise ReplicaBootError(
                    f"injected boot failure on {replica.name}")
            t0 = time.perf_counter()
            engine = replica.engine_factory()
            warm_s = engine.warmup()
            boot_s = time.perf_counter() - t0
        except BaseException as exc:  # noqa: BLE001 — boot is fallible
            detail = f"boot failed: {type(exc).__name__}: {exc}"
            self._event("replica_boot_failed", replica=replica.name,
                        replica_gen=generation, detail=detail)
            self._after_failure(replica, f"boot:{self._fingerprint(exc)}",
                                detail, initial=initial)
            return
        with self._lock:
            replica.engine = engine
            replica.service_model.seed(warm_s)
            replica.breaker = CircuitBreaker(replica._breaker_threshold)
            replica.stop_event = threading.Event()
            replica.current_batch = None
            replica.busy_since = None
            replica.boot_s = boot_s
            replica.state = STATE_LIVE
            replica.live_generation = generation
            replica.thread = threading.Thread(
                target=self._worker_loop, args=(replica, generation),
                name=f"fleet-{replica.name}-g{generation}", daemon=True)
        tracer = self._tracer()
        if tracer is not None:
            replica.span = tracer.start(
                "serve.replica", parent=self._root_span,
                replica=replica.name, generation=generation,
                platform=engine.platform)
        self._event("replica_started", replica=replica.name,
                    replica_gen=generation, restart=not initial,
                    boot_s=boot_s, warmup_batch_ms=warm_s * 1e3,
                    compile_events=engine.compile_events,
                    cache_hits=getattr(engine, "cache_hits", 0),
                    platform=engine.platform)
        replica.thread.start()

    # -------------------------------------------------------------- monitor

    def _monitor_loop(self) -> None:
        """The hang watchdog: a replica on one batch past
        ``hang_timeout_s`` is dead by evidence."""
        period = max(0.01, min(0.05, self.hang_timeout_s / 4.0))
        while not self._stop.wait(period):
            now = time.monotonic()
            for replica in list(self.replicas.values()):
                with self._lock:
                    busy_since = replica.busy_since
                    serving = replica.state in SERVING_STATES
                if (serving and busy_since is not None
                        and now - busy_since > self.hang_timeout_s):
                    self._declare_dead(
                        replica, fingerprint="hang",
                        detail=f"batch in flight for {now - busy_since:.2f}s "
                        f"> hang timeout {self.hang_timeout_s:.2f}s",
                        cause="hang")
