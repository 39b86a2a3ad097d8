"""Spans: where one request's time went, written into the event stream.

Counterpart of the writer and the checks of
``masters_thesis_tpu/telemetry/trace.py`` that serving needs. Spans are
close-only records: nothing is written when a span opens; one ``span``
event lands in the run's ``events.jsonl`` when it closes, carrying the
trace id, span id, parent id, a wall-clock ``start_ts`` and a
monotonic-clock ``dur_s``. ``MTT_TRACE_ID`` / ``MTT_PARENT_SPAN`` carry a
trace into a child process.

Reader side: :func:`collect_spans` gathers the span events of every
stream under a root, :func:`validate_spans` finds orphans and negative
durations, :func:`serve_attribution` breaks the p50 and p99 request into
admit / queue / batch-form / device / deliver (the components must cover
the span's wall within 5%). The flight recorder's sidecars (open spans of
a killed process), the trace CLI and the Chrome-trace export are not
ported. Stdlib only.
"""

from __future__ import annotations

import os
import threading
import time
from pathlib import Path

from masters_thesis_tpu_torch.telemetry.events import read_events

# Env propagation contract: MTT_TRACE_ID carries the trace id into child
# processes; MTT_PARENT_SPAN names the span the child's roots hang off.
TRACE_ENV = "MTT_TRACE_ID"
PARENT_SPAN_ENV = "MTT_PARENT_SPAN"
# Event kind used on the run's events.jsonl stream.
SPAN_KIND = "span"
# Critical-path components must cover the measured wall within this.
SUM_TOLERANCE = 0.05

# Serve request component attrs, in lifecycle order. ``other`` (the
# residual vs the span's own wall) is appended by the reader.
SERVE_COMPONENTS = ("admit_s", "queue_s", "batch_form_s", "device_s",
                    "deliver_s")


def new_trace_id() -> str:
    return os.urandom(8).hex()


def new_span_id() -> str:
    return os.urandom(4).hex()


class Span:
    """An open span. Cheap (slots, no I/O); closed via ``Tracer.end``."""

    __slots__ = (
        "name", "cat", "span_id", "parent_id", "trace_id", "start_ts",
        "t0", "attrs", "ext", "closed",
    )

    def __init__(self, name, cat, span_id, parent_id, trace_id, start_ts,
                 t0, attrs, ext):
        self.name = name
        self.cat = cat
        self.span_id = span_id
        self.parent_id = parent_id
        self.trace_id = trace_id
        self.start_ts = start_ts  # wall clock (cross-process timeline)
        self.t0 = t0              # monotonic (duration)
        self.attrs = attrs
        self.ext = ext            # parent id came from MTT_PARENT_SPAN
        self.closed = False


class Tracer:
    """Thread-safe span writer over an :class:`~.events.EventSink`.

    Adopts ``MTT_TRACE_ID``/``MTT_PARENT_SPAN`` from the environment, so a
    child process lands on the trace its parent started. Emission never
    raises: a telemetry fault must not kill a serve worker.
    """

    def __init__(self, sink):
        self.sink = sink
        self.trace_id = os.environ.get(TRACE_ENV) or new_trace_id()
        self.root_parent = os.environ.get(PARENT_SPAN_ENV) or None
        self._root_ext = self.root_parent is not None
        self._lock = threading.Lock()
        self._open: dict[str, Span] = {}

    # ------------------------------------------------------------ writer

    def start(self, name: str, parent=None, cat: str | None = None,
              **attrs) -> Span:
        """Open a span. ``parent`` is a :class:`Span`, a span-id string,
        or None for a trace root (which hangs off ``MTT_PARENT_SPAN``
        when the env provided one)."""
        if parent is None:
            parent_id, ext = self.root_parent, self._root_ext
        elif isinstance(parent, Span):
            parent_id, ext = parent.span_id, False
        else:
            parent_id, ext = str(parent), False
        span = Span(
            name=name,
            cat=cat or name.split(".", 1)[0],
            span_id=new_span_id(),
            parent_id=parent_id,
            trace_id=self.trace_id,
            start_ts=time.time(),
            t0=time.perf_counter(),
            attrs=dict(attrs),
            ext=ext,
        )
        with self._lock:
            self._open[span.span_id] = span
        return span

    def end(self, span: Span, status: str = "ok",
            dur_s: float | None = None, **attrs) -> None:
        """Close a span and emit its ``span`` event. ``dur_s`` overrides
        the monotonic measurement when the caller owns the exact wall
        (a request span's tiled components)."""
        if span is None or span.closed:
            return
        span.closed = True
        with self._lock:
            self._open.pop(span.span_id, None)
        if dur_s is None:
            dur_s = time.perf_counter() - span.t0
        if attrs:
            span.attrs.update(attrs)
        self._emit(span, status, dur_s)

    def emit_span(self, name: str, *, start_ts: float, dur_s: float,
                  parent=None, cat: str | None = None, status: str = "ok",
                  **attrs) -> None:
        """Emit a retroactive span that was never open (the caller timed
        it itself)."""
        if parent is None:
            parent_id, ext = self.root_parent, self._root_ext
        elif isinstance(parent, Span):
            parent_id, ext = parent.span_id, False
        else:
            parent_id, ext = str(parent), False
        span = Span(
            name=name, cat=cat or name.split(".", 1)[0],
            span_id=new_span_id(), parent_id=parent_id,
            trace_id=self.trace_id, start_ts=start_ts, t0=0.0,
            attrs=dict(attrs), ext=ext,
        )
        span.closed = True
        self._emit(span, status, dur_s)

    def _emit(self, span: Span, status: str, dur_s: float) -> None:
        try:
            self.sink.emit(
                SPAN_KIND,
                name=span.name,
                cat=span.cat,
                span_id=span.span_id,
                parent_id=span.parent_id,
                trace_id=span.trace_id,
                start_ts=span.start_ts,
                dur_s=dur_s,
                status=status,
                ext=span.ext,
                attrs=span.attrs,
            )
        except Exception:
            pass  # tracing must never kill the traced work

    def close_all(self, status: str = "aborted") -> int:
        """Close every still-open span (children before parents). Called
        by ``TelemetryRun.close`` so an exception path that skips
        individual ``end`` calls still leaves a well-formed tree."""
        with self._lock:
            spans = sorted(
                self._open.values(), key=lambda s: s.start_ts, reverse=True
            )
        for span in spans:
            self.end(span, status=status)
        return len(spans)


def collect_spans(root: str | Path) -> dict:
    """The span events of every ``events.jsonl`` under ``root`` (or the
    file ``root`` itself): ``{"spans": [...], "streams": n}``, each span
    record with its stream's envelope (host/pid/proc) and a ``stream``
    label."""
    root = Path(root)
    paths = [root] if root.is_file() else sorted(root.rglob("events.jsonl"))
    spans: list[dict] = []
    for path in paths:
        try:
            stream = str(path.parent.relative_to(root)) or "."
        except ValueError:
            stream = str(path.parent)
        for ev in read_events(path):
            if ev.get("kind") != SPAN_KIND:
                continue
            spans.append({
                "name": ev.get("name"),
                "cat": ev.get("cat"),
                "span_id": ev.get("span_id"),
                "parent_id": ev.get("parent_id"),
                "trace_id": ev.get("trace_id"),
                "start_ts": ev.get("start_ts"),
                "dur_s": ev.get("dur_s"),
                "status": ev.get("status", "ok"),
                "ext": bool(ev.get("ext")),
                "attrs": ev.get("attrs") or {},
                "host": ev.get("host"),
                "pid": ev.get("pid"),
                "proc": ev.get("proc"),
                "stream": stream,
            })
    return {"spans": spans, "streams": len(paths)}


def validate_spans(spans: list[dict],
                   problems: list[dict] | None = None) -> list[dict]:
    """Broken-tree findings: orphans (a parent id resolving to no known
    span, unless the link was env-external) and negative durations.
    Extends and returns ``problems``."""
    problems = list(problems or [])
    known = {s["span_id"] for s in spans if s.get("span_id")}
    for s in spans:
        dur = s.get("dur_s")
        if dur is not None and dur < 0:
            problems.append({
                "kind": "negative_duration",
                "span_id": s.get("span_id"),
                "detail": (
                    f"span {s.get('name')!r} ({s.get('span_id')}) has "
                    f"negative duration {dur:.6f}s"
                ),
            })
        parent = s.get("parent_id")
        if parent and not s.get("ext") and parent not in known:
            problems.append({
                "kind": "orphan",
                "span_id": s.get("span_id"),
                "detail": (
                    f"span {s.get('name')!r} ({s.get('span_id')}) names "
                    f"unknown parent {parent} (stream {s.get('stream')})"
                ),
            })
    return problems


def _breakdown(wall: float, components: dict[str, float]) -> dict:
    """Components + an ``other`` residual, with the ≤5% coverage check.
    ``other`` is clamped at 0 so a small negative residual (overlapping
    host timers) reads as over-coverage, which the check also catches."""
    comp = {k: float(v) for k, v in components.items() if v is not None}
    total = sum(comp.values())
    residual = wall - total
    if residual > 0:
        comp["other"] = residual
    shares = (
        {k: v / wall for k, v in comp.items()} if wall > 0
        else {k: 0.0 for k in comp}
    )
    return {
        "wall_s": wall,
        "components_s": comp,
        "shares": shares,
        "unattributed_frac": (
            max(0.0, residual) / wall if wall > 0 else 0.0
        ),
        "sum_ok": abs(residual) <= SUM_TOLERANCE * wall,
        "gap_s": abs(residual),
    }


def _quantile_item(items: list, q: float):
    if not items:
        return None
    idx = min(len(items) - 1, max(0, round(q * (len(items) - 1))))
    return items[idx]


def serve_attribution(spans: list[dict]) -> dict | None:
    """p50/p99 request breakdowns + aggregate shares over every
    ``serve.request`` span."""
    requests = [s for s in spans if s.get("name") == "serve.request"]
    if not requests:
        return None
    completed = sorted(
        (s for s in requests if s.get("status") == "ok"
         and s.get("dur_s") is not None),
        key=lambda s: s["dur_s"],
    )
    shed_by_reason: dict[str, int] = {}
    for s in requests:
        if s.get("status") in ("shed", "rejected_late", "error", "aborted"):
            key = (s.get("attrs") or {}).get("reason_category") or s["status"]
            shed_by_reason[key] = shed_by_reason.get(key, 0) + 1

    def request_breakdown(s: dict) -> dict:
        attrs = s.get("attrs") or {}
        b = _breakdown(
            float(s["dur_s"]),
            {k: attrs.get(k) for k in SERVE_COMPONENTS},
        )
        b["rid"] = attrs.get("rid")
        return b

    total_wall = sum(s["dur_s"] for s in completed)
    total_queue = sum(
        (s.get("attrs") or {}).get("queue_s") or 0.0 for s in completed
    )
    total_device = sum(
        (s.get("attrs") or {}).get("device_s") or 0.0 for s in completed
    )
    p50 = _quantile_item(completed, 0.50)
    p99 = _quantile_item(completed, 0.99)
    return {
        "requests": len(requests),
        "completed": len(completed),
        "shed": sum(1 for s in requests if s.get("status") == "shed"),
        "rejected_late": sum(
            1 for s in requests if s.get("status") == "rejected_late"
        ),
        "shed_by_reason": shed_by_reason,
        "queue_wait_share": (
            total_queue / total_wall if total_wall > 0 else None
        ),
        "compute_share": (
            total_device / total_wall if total_wall > 0 else None
        ),
        "p50": request_breakdown(p50) if p50 else None,
        "p99": request_breakdown(p99) if p99 else None,
    }
