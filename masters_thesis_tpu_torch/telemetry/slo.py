"""Declarative SLO rules with multi-window burn-rate alerting.

Counterpart of ``masters_thesis_tpu/telemetry/slo.py``, copied whole
(stdlib only). The engine reads a run's ``events.jsonl`` streams while
they are written (the tail-cursor reader, ``events.read_new_lines``) and
folds them into a few live signals:

- each request's latency and outcome from the ``serve.request`` span
  events (status ok, shed, rejected_late or error, and its wall duration:
  ``serve/spans.py``);
- epoch health (starvation, recompiles, divergence) from ``epoch`` and
  ``run_finished`` events;
- liveness from the flight recorder's ``heartbeat.json`` and each
  stream's last event time;
- model quality from the serving monitor's ``quality_sample`` events.

A ``SLORule`` names a signal kind, a threshold and a fast/slow window
pair. The burn-rate rule is the multi-window form: with availability
target T the error budget is ``1 - T`` and the burn rate ``error_rate /
(1 - T)``; the rule fires only when both windows breach (the fast one makes
the alert quick, the slow one keeps a blip from paging). Transitions are
debounced (``for_ticks`` breaches in a row to fire, ``clear_ticks`` clean
ticks to resolve: a flapping signal fires once and stays firing) and
written back into the stream as ``alert_fired`` / ``alert_resolved``
events, so the post-hoc report sees what the live plane saw.

Evaluation is reader-side only: the engine touches no serving or
training path, it tails their streams. The ``slo.evaluate`` fault point
wedges the evaluator (ticks become no-ops and the published state goes
stale) without touching serving.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path

from masters_thesis_tpu_torch.resilience.faults import fire
from masters_thesis_tpu_torch.telemetry.events import read_new_lines
from masters_thesis_tpu_torch.telemetry.flightrec import HEARTBEAT_FILENAME
from masters_thesis_tpu_torch.telemetry.report import EVENTS_FILENAME

#: Rule kinds and the signal each one compares against its threshold.
RULE_KINDS = frozenset(
    {
        "p99_latency",  # p99 request wall seconds over the fast window
        "shed_pct",  # % of requests shed/rejected over the fast window
        "burn_rate",  # error-budget burn; fires when BOTH windows breach
        "heartbeat_staleness",  # seconds since the quietest live stream
        "starvation_pct",  # input-pipeline starvation % (slow window)
        "recompile",  # epoch-program compiles beyond the contract's one
        "divergence",  # a run halted on a non-finite loss
        "input_drift",  # max feature PSI from quality_sample events
        "prediction_drift",  # max predicted-(α,β) PSI from quality_sample
        "shadow_disagreement",  # |model − shadow-OLS| EWMA from
        # quality_sample events (telemetry/quality.py)
    }
)

#: The model-quality rule kinds and the ``quality_sample`` field each one
#: reads (the monitor emits thresholds too, but the RULE owns its own).
QUALITY_RULE_FIELDS = {
    "input_drift": "input_psi",
    "prediction_drift": "pred_psi",
    "shadow_disagreement": "shadow_err",
}

#: Request statuses that consume error budget (a shed IS a user-visible
#: non-answer; the no-late-answers invariant makes rejected_late one too).
ERROR_STATUSES = frozenset({"shed", "rejected_late", "error"})


@dataclass(frozen=True)
class SLORule:
    """One declarative objective; see :data:`RULE_KINDS` for semantics."""

    name: str
    kind: str
    threshold: float = 0.0
    #: Availability objective for ``burn_rate`` (budget = 1 − target).
    target: float = 0.99
    fast_window_s: float = 60.0
    slow_window_s: float = 300.0
    #: Consecutive breaching ticks before the alert fires.
    for_ticks: int = 1
    #: Consecutive clean ticks before a firing alert resolves.
    clear_ticks: int = 2

    def __post_init__(self) -> None:
        if self.kind not in RULE_KINDS:
            raise ValueError(
                f"unknown SLO rule kind: {self.kind!r} "
                f"(valid kinds: {', '.join(sorted(RULE_KINDS))})"
            )
        if self.fast_window_s > self.slow_window_s:
            raise ValueError(
                f"rule {self.name}: fast window {self.fast_window_s}s "
                f"exceeds slow window {self.slow_window_s}s"
            )


def burn_rate(error_rate: float, target: float) -> float:
    """Error-budget burn: how many times faster than sustainable the
    budget is being consumed. Burn 1.0 = the budget lasts exactly the
    SLO period; an exhausted budget (target ≥ 1) burns infinitely fast
    the moment anything errors."""
    budget = 1.0 - target
    if budget <= 0.0:
        return math.inf if error_rate > 0.0 else 0.0
    return error_rate / budget


def window_stats(
    requests, now: float, window_s: float
) -> dict:
    """Fold ``(ts, status, dur_s)`` request samples inside the window.

    Returns n / ok / errored / shed counts, the error rate, nearest-rank
    p99 latency over samples that carried a duration, and the offered
    QPS (n over the window span)."""
    n = ok = shed = errored = 0
    durs: list[float] = []
    cutoff = now - window_s
    for ts, status, dur_s in requests:
        if ts < cutoff:
            continue
        n += 1
        if status == "ok":
            ok += 1
        if status in ("shed", "rejected_late"):
            shed += 1
        if status in ERROR_STATUSES:
            errored += 1
        if dur_s is not None:
            durs.append(dur_s)
    durs.sort()
    p99 = None
    if durs:
        idx = min(len(durs) - 1, max(0, round(0.99 * (len(durs) - 1))))
        p99 = durs[idx]
    return {
        "n": n,
        "ok": ok,
        "shed": shed,
        "errored": errored,
        "error_rate": (errored / n) if n else 0.0,
        "shed_pct": (100.0 * shed / n) if n else 0.0,
        "p99_s": p99,
        "qps": (n / window_s) if window_s > 0 else 0.0,
    }


def default_serve_rules(
    deadline_s: float = 0.05,
    availability_target: float = 0.99,
    fast_window_s: float = 60.0,
    slow_window_s: float = 300.0,
) -> list[SLORule]:
    """The serving-path objectives ROADMAP item 3 gates capacity on."""
    return [
        SLORule(
            "p99-latency", "p99_latency", threshold=deadline_s,
            fast_window_s=fast_window_s, slow_window_s=slow_window_s,
            for_ticks=2,
        ),
        SLORule(
            "shed-rate", "shed_pct", threshold=10.0,
            fast_window_s=fast_window_s, slow_window_s=slow_window_s,
            for_ticks=2,
        ),
        SLORule(
            "error-budget-burn", "burn_rate", threshold=2.0,
            target=availability_target,
            fast_window_s=fast_window_s, slow_window_s=slow_window_s,
        ),
        SLORule(
            "heartbeat-stale", "heartbeat_staleness", threshold=30.0,
            fast_window_s=fast_window_s, slow_window_s=slow_window_s,
        ),
    ]


def default_train_rules(
    fast_window_s: float = 60.0, slow_window_s: float = 300.0
) -> list[SLORule]:
    """Training-run objectives: liveness + the runtime TA201 contract."""
    return [
        SLORule(
            "heartbeat-stale", "heartbeat_staleness", threshold=30.0,
            fast_window_s=fast_window_s, slow_window_s=slow_window_s,
        ),
        SLORule(
            "input-starvation", "starvation_pct", threshold=25.0,
            fast_window_s=fast_window_s, slow_window_s=slow_window_s,
            for_ticks=2,
        ),
        SLORule(
            "recompile", "recompile", threshold=0.0,
            fast_window_s=fast_window_s, slow_window_s=slow_window_s,
        ),
        SLORule(
            "divergence", "divergence", threshold=0.0,
            fast_window_s=fast_window_s, slow_window_s=slow_window_s,
        ),
    ]


def default_quality_rules(
    input_threshold: float = 0.25,
    prediction_threshold: float = 0.25,
    shadow_threshold: float = 0.5,
    fast_window_s: float = 60.0,
    slow_window_s: float = 300.0,
) -> list[SLORule]:
    """Model-quality objectives over ``quality_sample`` events (the
    serve-side 1-in-K sampler in telemetry/quality.py). PSI thresholds
    read on the usual industry scale; the shadow threshold is a mean
    |model − OLS| disagreement in (α, β) units."""
    return [
        SLORule(
            "input-drift", "input_drift", threshold=input_threshold,
            fast_window_s=fast_window_s, slow_window_s=slow_window_s,
            for_ticks=2,
        ),
        SLORule(
            "prediction-drift", "prediction_drift",
            threshold=prediction_threshold,
            fast_window_s=fast_window_s, slow_window_s=slow_window_s,
            for_ticks=2,
        ),
        SLORule(
            "shadow-disagreement", "shadow_disagreement",
            threshold=shadow_threshold,
            fast_window_s=fast_window_s, slow_window_s=slow_window_s,
            for_ticks=2,
        ),
    ]


@dataclass
class _AlertState:
    """Debounced per-rule state machine: pending → firing → resolved."""

    rule: SLORule
    firing: bool = False
    breach_streak: int = 0
    clear_streak: int = 0
    fired_ts: float | None = None
    fired_count: int = 0
    value: float | None = None
    detail: dict = field(default_factory=dict)

    def update(self, breached: bool, now: float) -> str | None:
        """Advance one tick; returns "fired"/"resolved" on a transition."""
        if breached:
            self.breach_streak += 1
            self.clear_streak = 0
            if not self.firing and self.breach_streak >= self.rule.for_ticks:
                self.firing = True
                self.fired_ts = now
                self.fired_count += 1
                return "fired"
        else:
            self.clear_streak += 1
            self.breach_streak = 0
            if self.firing and self.clear_streak >= self.rule.clear_ticks:
                self.firing = False
                return "resolved"
        return None


class SLOEngine:
    """Incremental SLO evaluation over the event streams under a root.

    Single-writer by design: :meth:`tick` is called either by the owner
    directly (tests, the bench's per-stage loop) or by the monitor
    thread :meth:`start` spawns — never both at once. Cross-thread
    readers (the ``/slo`` exposition endpoint, the watch console) see
    only the published snapshot, swapped under ``_state_lock`` at the
    end of each tick; no file I/O ever happens under that lock.
    """

    def __init__(
        self,
        root: str | Path,
        rules: list[SLORule] | None = None,
        sink=None,
        grace_s: float = 5.0,
    ):
        self.root = Path(root)
        self.rules = (
            list(rules) if rules is not None else default_serve_rules()
        )
        names = [r.name for r in self.rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO rule names: {names}")
        self._sink = sink
        self._grace_s = grace_s
        self._retain_s = max(
            [r.slow_window_s for r in self.rules] or [300.0]
        ) + 60.0
        # Tail cursors + accumulated signal state (single writer: tick).
        self._cursors: dict[Path, int] = {}
        self._requests: deque = deque()  # (ts, status, dur_s)
        self._epochs: deque = deque()  # (ts, wall_s, data_wait_s)
        # (ts, scored, input_psi, pred_psi, shadow_err) quality samples.
        self._quality: deque = deque()
        self._epoch_compiles = 0
        self._diverged = False
        self._divergence_detail: str | None = None
        self._stream_last_ts: dict[Path, float] = {}
        self._stream_finished: dict[Path, bool] = {}
        self._alerts = {r.name: _AlertState(r) for r in self.rules}
        self._events_seen = 0
        self._ticks = 0
        # Published snapshot for cross-thread readers.
        self._state_lock = threading.Lock()
        self._published: dict = {
            "ts": None, "ticks": 0, "rules": {}, "firing": [],
        }
        # Monitor-thread lifecycle (spawned in start, joined in stop).
        self._stop_event = threading.Event()
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------ ingest

    def _discover(self) -> list[Path]:
        if self.root.is_file():
            return [self.root]
        return sorted(self.root.rglob(EVENTS_FILENAME))

    def _ingest(self) -> None:
        for path in self._discover():
            cursor = self._cursors.get(path, 0)
            events, cursor = read_new_lines(path, cursor)
            self._cursors[path] = cursor
            for ev in events:
                self._fold(path, ev)
            # Single-writer: tick() runs on exactly one thread (the owner
            # before start(), the monitor thread after).
            self._events_seen += len(events)  # mtt: disable=CL502 -- single-writer tick

    def _fold(self, path: Path, ev: dict) -> None:
        ts = ev.get("ts")
        if ts is not None:
            prev = self._stream_last_ts.get(path)
            self._stream_last_ts[path] = ts if prev is None else max(
                prev, ts
            )
        kind = ev.get("kind")
        if kind == "span" and ev.get("name") == "serve.request":
            if ts is not None:
                self._requests.append(
                    (ts, ev.get("status"), ev.get("dur_s"))
                )
        elif kind == "epoch":
            if ts is not None and ev.get("wall_s") is not None:
                self._epochs.append(
                    (ts, float(ev["wall_s"]),
                     float(ev.get("data_wait_s") or 0.0))
                )
            self._epoch_compiles += int(ev.get("compile_events") or 0)  # mtt: disable=CL502 -- single-writer tick
        elif kind == "quality_sample":
            if ts is not None:
                self._quality.append(
                    (
                        ts,
                        bool(ev.get("scored")),
                        float(ev.get("input_psi") or 0.0),
                        float(ev.get("pred_psi") or 0.0),
                        float(ev.get("shadow_err") or 0.0),
                    )
                )
        elif kind == "run_finished":
            self._stream_finished[path] = True
            if ev.get("diverged"):
                self._diverged = True
                self._divergence_detail = "run halted on a non-finite loss"
        elif kind in (
            "serve_finished", "fleet_finished", "fleet_verdict",
            "supervisor_verdict",
        ):
            self._stream_finished[path] = True

    def _trim(self, now: float) -> None:
        cutoff = now - self._retain_s
        while self._requests and self._requests[0][0] < cutoff:
            self._requests.popleft()
        while self._epochs and self._epochs[0][0] < cutoff:
            self._epochs.popleft()
        while self._quality and self._quality[0][0] < cutoff:
            self._quality.popleft()

    # ---------------------------------------------------------- signals

    def _staleness(self, now: float) -> float | None:
        """Seconds since the quietest *live* stream's last sign of life
        (heartbeat sidecar or last flushed event); finished streams are
        excluded — a cleanly ended run must not go stale forever."""
        worst = None
        for path, last_ts in self._stream_last_ts.items():
            if self._stream_finished.get(path):
                continue
            hb = _heartbeat_ts(path.parent / HEARTBEAT_FILENAME)
            last = max(last_ts, hb) if hb is not None else last_ts
            gap = now - last
            worst = gap if worst is None else max(worst, gap)
        return worst

    def _starvation(self, now: float, window_s: float) -> float | None:
        cutoff = now - window_s
        wall = wait = 0.0
        for ts, wall_s, data_wait_s in self._epochs:
            if ts < cutoff:
                continue
            wall += wall_s
            wait += data_wait_s
        if wall <= 0:
            return None
        return 100.0 * wait / wall

    def _evaluate(self, rule: SLORule, now: float) -> tuple[
        float | None, bool, dict
    ]:
        """One rule's (value, breached, detail) at ``now``."""
        if rule.kind == "burn_rate":
            fast = window_stats(self._requests, now, rule.fast_window_s)
            slow = window_stats(self._requests, now, rule.slow_window_s)
            burn_fast = burn_rate(fast["error_rate"], rule.target)
            burn_slow = burn_rate(slow["error_rate"], rule.target)
            value = min(burn_fast, burn_slow)
            breached = (
                fast["n"] > 0
                and burn_fast > rule.threshold
                and burn_slow > rule.threshold
            )
            return value, breached, {
                "burn_fast": burn_fast, "burn_slow": burn_slow,
                "error_rate_fast": fast["error_rate"],
                "requests_fast": fast["n"],
            }
        if rule.kind == "p99_latency":
            stats = window_stats(self._requests, now, rule.fast_window_s)
            value = stats["p99_s"]
            return value, (
                value is not None and value > rule.threshold
            ), {"requests_fast": stats["n"]}
        if rule.kind == "shed_pct":
            stats = window_stats(self._requests, now, rule.fast_window_s)
            value = stats["shed_pct"] if stats["n"] else None
            return value, (
                value is not None and value > rule.threshold
            ), {"requests_fast": stats["n"]}
        if rule.kind == "heartbeat_staleness":
            value = self._staleness(now)
            return value, (
                value is not None and value > rule.threshold
            ), {}
        if rule.kind == "starvation_pct":
            value = self._starvation(now, rule.slow_window_s)
            return value, (
                value is not None and value > rule.threshold
            ), {}
        if rule.kind == "recompile":
            value = float(max(0, self._epoch_compiles - 1))
            return value, value > rule.threshold, {
                "compile_events": self._epoch_compiles
            }
        if rule.kind == "divergence":
            value = 1.0 if self._diverged else 0.0
            return value, value > rule.threshold, {
                "detail": self._divergence_detail
            }
        if rule.kind in QUALITY_RULE_FIELDS:
            # Drift signals are cumulative-sketch scores: the LATEST
            # sample in the window is the current state (older samples
            # were computed from a strictly smaller sketch). Shadow
            # disagreement is an EWMA — same story. Drift kinds only
            # consider scored samples (a reference fingerprint was
            # loaded and the warm-up count was met).
            idx = {
                "input_drift": 2,
                "prediction_drift": 3,
                "shadow_disagreement": 4,
            }[rule.kind]
            cutoff = now - rule.fast_window_s
            value = None
            n = 0
            for ts, scored, *vals in self._quality:
                if ts < cutoff:
                    continue
                if rule.kind != "shadow_disagreement" and not scored:
                    continue
                n += 1
                value = vals[idx - 2]
            return value, (
                value is not None and value > rule.threshold
            ), {"samples_fast": n}
        raise AssertionError(f"unreachable rule kind {rule.kind!r}")

    # -------------------------------------------------------------- tick

    def tick(self, now: float | None = None) -> dict:
        """Ingest new events, evaluate every rule, publish the state.

        The chaos harness can wedge this evaluator (``slo.evaluate`` /
        kind ``wedge``): the tick becomes a no-op and the published
        state goes stale — serving is untouched, which is the point.
        """
        if fire("slo.evaluate") == "wedge":
            return self.state()
        now = time.time() if now is None else now
        self._ingest()
        self._trim(now)
        # Single-writer: one thread ticks; _state_lock only guards the
        # published-snapshot swap.
        self._ticks += 1  # mtt: disable=CL502 -- single-writer tick
        fired: list[str] = []
        resolved: list[str] = []
        rules_out: dict[str, dict] = {}
        for rule in self.rules:
            value, breached, detail = self._evaluate(rule, now)
            st = self._alerts[rule.name]
            st.value = value
            st.detail = detail
            transition = st.update(breached, now)
            if transition == "fired":
                fired.append(rule.name)
                self._emit(
                    "alert_fired", rule, st, now, detail
                )
            elif transition == "resolved":
                resolved.append(rule.name)
                self._emit(
                    "alert_resolved", rule, st, now, detail
                )
            rules_out[rule.name] = {
                "kind": rule.kind,
                "value": value,
                "threshold": rule.threshold,
                "breached": breached,
                "firing": st.firing,
                "fired_ts": st.fired_ts,
                "fired_count": st.fired_count,
                **detail,
            }
        window = window_stats(
            self._requests, now,
            max((r.fast_window_s for r in self.rules), default=60.0),
        )
        state = {
            "ts": now,
            "ticks": self._ticks,
            "events_seen": self._events_seen,
            "streams": len(self._cursors),
            "rules": rules_out,
            "firing": sorted(
                n for n, st in self._alerts.items() if st.firing
            ),
            "just_fired": fired,
            "just_resolved": resolved,
            "requests": window,
        }
        with self._state_lock:
            self._published = state
        return state

    def _emit(
        self, kind: str, rule: SLORule, st: _AlertState, now: float,
        detail: dict,
    ) -> None:
        if self._sink is None:
            return
        payload = {
            "rule": rule.name,
            "slo_kind": rule.kind,
            "value": st.value,
            "threshold": rule.threshold,
            "burn_fast": detail.get("burn_fast"),
            "burn_slow": detail.get("burn_slow"),
            "active_s": (
                (now - st.fired_ts)
                if kind == "alert_resolved" and st.fired_ts is not None
                else None
            ),
        }
        # Infinity is honest math but not valid JSON; clamp at emit.
        for key in ("value", "burn_fast", "burn_slow"):
            v = payload[key]
            if v is not None and math.isinf(v):
                payload[key] = 1e308
        if kind == "alert_fired":
            self._sink.emit("alert_fired", **payload)
        else:
            self._sink.emit("alert_resolved", **payload)

    def emit_snapshot(self, state: dict | None = None) -> None:
        """Record the current SLO state into the stream (periodic from
        the monitor thread; per-stage from the bench)."""
        if self._sink is None:
            return
        state = state or self.state()
        self._sink.emit(
            "slo_snapshot",
            firing=state.get("firing") or [],
            ticks=state.get("ticks"),
            events_seen=state.get("events_seen"),
            p99_s=(state.get("requests") or {}).get("p99_s"),
            shed_pct=(state.get("requests") or {}).get("shed_pct"),
            qps=(state.get("requests") or {}).get("qps"),
        )

    def state(self) -> dict:
        """The last published snapshot (safe from any thread)."""
        with self._state_lock:
            return dict(self._published)

    # --------------------------------------------------------- lifecycle

    def start(
        self, interval_s: float = 2.0, snapshot_every: int = 5
    ) -> None:
        """Spawn the monitor thread: tick every ``interval_s``, record a
        ``slo_snapshot`` event every ``snapshot_every`` ticks."""
        if self._thread is not None:
            return
        self._stop_event.clear()

        def _loop() -> None:
            ticks = 0
            while not self._stop_event.wait(interval_s):
                try:
                    state = self.tick()
                    ticks += 1
                    if snapshot_every and ticks % snapshot_every == 0:
                        self.emit_snapshot(state)
                except Exception:  # noqa: BLE001 -- a transient read
                    # error (stream mid-rotation) must not kill the
                    # monitor; the next tick retries from the cursor.
                    pass

        self._thread = threading.Thread(
            target=_loop, name="slo-monitor", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        """Join the monitor thread (bounded) and run one final tick so
        the published state reflects the stream's end."""
        thread = self._thread
        if thread is not None:
            self._stop_event.set()
            thread.join(timeout=10.0)
            self._thread = None
        try:
            self.tick()
        except Exception:  # noqa: BLE001 -- best-effort final fold
            pass

    close = stop

    def __enter__(self) -> "SLOEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


def _heartbeat_ts(path: Path) -> float | None:
    try:
        import json

        doc = json.loads(path.read_text())
    except (OSError, ValueError):
        return None
    if not isinstance(doc, dict):
        return None
    candidates = [
        doc.get(k) for k in ("ts", "last_beat_ts")
        if isinstance(doc.get(k), (int, float))
    ]
    return max(candidates) if candidates else None
