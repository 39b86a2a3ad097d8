"""Spans: where one unit of work's time went, written into the event stream.

Counterpart of ``masters_thesis_tpu/telemetry/trace.py``, the same code
over the port's event sink. Spans are close-only records: nothing is
written when a span opens; one ``span`` event lands in the run's
``events.jsonl`` when it closes, carrying the trace id, span id, parent
id, a wall-clock ``start_ts`` and a monotonic-clock ``dur_s``. Open spans
are held in memory and flushed into the flight recorder's heartbeat and
crashdump sidecars (``telemetry/flightrec.py``), so a killed process's
in-flight work is closed as ``aborted`` by the reader, not lost.
``MTT_TRACE_ID`` / ``MTT_PARENT_SPAN`` carry a trace into a child process:
the supervisor exports both per attempt, so one trace
id covers every retry of a run.

Reader side: :func:`collect_spans` merges every stream under a root (with
the sidecars' open spans), :func:`validate_spans` finds orphans, negative
durations and spans a cleanly closed process left open,
:func:`serve_attribution` breaks the p50 and p99 request into admit /
queue / batch-form / device / deliver and :func:`epoch_attribution` the
median epoch into dispatch / data wait / device (each within 5% of the
span's wall), and :func:`chrome_trace` writes a Perfetto-loadable JSON:
the ``python -m masters_thesis_tpu_torch.telemetry trace`` command.
Stdlib only.
"""

from __future__ import annotations

import json
import os
import threading
import time
from pathlib import Path

# Env propagation contract: MTT_TRACE_ID carries the trace id into child
# processes; MTT_PARENT_SPAN names the span the child's roots hang off.
TRACE_ENV = "MTT_TRACE_ID"
PARENT_SPAN_ENV = "MTT_PARENT_SPAN"
# Event kind used on the run's existing events.jsonl stream.
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

    def snapshot(self) -> dict:
        """The sidecar form a flight recorder flushes for open spans."""
        return {
            "name": self.name,
            "cat": self.cat,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "trace_id": self.trace_id,
            "start_ts": self.start_ts,
            "ext": self.ext,
            "attrs": dict(self.attrs),
        }


class Tracer:
    """Thread-safe span writer over an :class:`~.events.EventSink`.

    Adopts ``MTT_TRACE_ID``/``MTT_PARENT_SPAN`` from the environment so a
    supervised child, a grid cell, or a fleet worker lands on the trace
    its parent started. All emission is no-throw by design — a telemetry
    bug must never kill a training run or a serve worker.
    """

    def __init__(self, sink, trace_id: str | None = None, parent=None,
                 env=None):
        env = os.environ if env is None else env
        self.sink = sink
        self.trace_id = trace_id or env.get(TRACE_ENV) or new_trace_id()
        if parent is not None:
            self.root_parent = (
                parent.span_id if isinstance(parent, Span) else str(parent)
            )
            self._root_ext = False
        else:
            self.root_parent = env.get(PARENT_SPAN_ENV) or None
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
        (e.g. the EpochRecorder's boundary-to-boundary epoch wall)."""
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

    # ------------------------------------------------- sidecar interface

    def open_spans(self) -> list[dict]:
        """Snapshot of currently-open spans — the flight recorder flushes
        this into heartbeat.json/crashdump.json so a killed process's
        in-flight work is recoverable."""
        with self._lock:
            spans = list(self._open.values())
        return [s.snapshot() for s in spans]

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


def adopt_orphaned_spans(run_dir: str | Path, sink) -> int:
    """Close the previous attempt's open spans into a re-opened stream.

    A supervised retry that resumes IN PLACE re-opens the same run dir,
    and its fresh flight recorder will overwrite ``heartbeat.json`` /
    ``crashdump.json`` — the only record of the spans the dead attempt
    left open. Called before that overwrite (``attach_flight_recorder``),
    this emits the sidecar's unclosed spans as ``aborted`` span events,
    exactly as the reader would have synthesized them, so the dead
    attempt's child spans keep a parent in the merged tree. No-throw;
    returns the number of spans adopted (0 for a fresh dir).
    """
    try:
        from masters_thesis_tpu_torch.telemetry.events import read_events
        from masters_thesis_tpu_torch.telemetry.flightrec import (
            CRASHDUMP_FILENAME,
            HEARTBEAT_FILENAME,
        )

        run_dir = Path(run_dir)
        crashdump = _read_json(run_dir / CRASHDUMP_FILENAME)
        heartbeat = _read_json(run_dir / HEARTBEAT_FILENAME)
        closed_cleanly = bool(heartbeat and heartbeat.get("closed"))
        sidecar = _sidecar_open_spans(crashdump) or (
            [] if closed_cleanly else _sidecar_open_spans(heartbeat)
        )
        if not sidecar:
            return 0
        sidecar_ts = (crashdump or {}).get("ts") or (
            heartbeat or {}).get("ts")
        closed_ids = {
            ev.get("span_id")
            for ev in read_events(run_dir / "events.jsonl")
            if ev.get("kind") == SPAN_KIND
        }
        adopted = 0
        for s in sidecar:
            if s.get("span_id") in closed_ids:
                continue
            start_ts = s.get("start_ts")
            dur = 0.0
            if start_ts is not None and sidecar_ts is not None:
                dur = max(0.0, float(sidecar_ts) - float(start_ts))
            sink.emit(
                SPAN_KIND,
                name=s.get("name"),
                cat=s.get("cat"),
                span_id=s.get("span_id"),
                parent_id=s.get("parent_id"),
                trace_id=s.get("trace_id"),
                start_ts=start_ts,
                dur_s=dur,
                status="aborted",
                ext=bool(s.get("ext")),
                attrs={**(s.get("attrs") or {}), "synthesized": True},
            )
            adopted += 1
        return adopted
    except Exception:
        return 0  # crash forensics must never block the new attempt


# ======================================================================
# Reader side: collect, validate, export, attribute. Stdlib only.
# ======================================================================


def _read_json(path: Path) -> dict | None:
    try:
        obj = json.loads(path.read_text())
    except (OSError, json.JSONDecodeError):
        return None
    return obj if isinstance(obj, dict) else None


def _sidecar_open_spans(obj: dict | None) -> list[dict]:
    if not obj:
        return []
    spans = obj.get("open_spans")
    return [s for s in spans if isinstance(s, dict)] if isinstance(
        spans, list) else []


def collect_spans(root: str | Path) -> dict:
    """Merge span records from every stream under ``root``.

    Returns ``{"spans": [...], "problems": [...], "streams": n,
    "profile_windows": [...]}`` where each span record carries the event
    envelope (host/pid/proc) plus a ``stream`` label. Open spans found in
    the sidecars of *dead* processes are synthesized as ``aborted``;
    open spans claimed by a *cleanly closed* process are a bug
    (``unclosed``) and land in ``problems``.
    """
    from masters_thesis_tpu_torch.telemetry.events import read_events
    from masters_thesis_tpu_torch.telemetry.flightrec import (
        CRASHDUMP_FILENAME,
        HEARTBEAT_FILENAME,
    )

    root = Path(root)
    streams = ([root] if root.is_file()
               else sorted(root.rglob("events.jsonl")))
    spans: list[dict] = []
    problems: list[dict] = []
    windows: list[dict] = []
    seen_dirs: set[Path] = set()
    for path in streams:
        if path.parent in seen_dirs:
            continue
        seen_dirs.add(path.parent)
        try:
            rel = str(path.parent.relative_to(root))
        except ValueError:
            rel = str(path.parent)
        stream = rel or "."
        events = read_events(path)
        envelope = {"host": None, "pid": None, "proc": None}
        for ev in events:
            kind = ev.get("kind")
            for key in envelope:
                if envelope[key] is None and ev.get(key) is not None:
                    envelope[key] = ev[key]
            if kind == "profile_window":
                windows.append({**ev, "stream": stream})
            elif kind == SPAN_KIND:
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
        crashdump = _read_json(path.parent / CRASHDUMP_FILENAME)
        heartbeat = _read_json(path.parent / HEARTBEAT_FILENAME)
        closed_cleanly = bool(heartbeat and heartbeat.get("closed"))
        closed_ids = {s["span_id"] for s in spans if s.get("span_id")}
        # Prefer the crashdump snapshot (dump-time truth) over the last
        # periodic heartbeat; a span closed in the stream supersedes both
        # (a SIGTERM dump races the normal close path).
        sidecar = _sidecar_open_spans(crashdump) or (
            [] if closed_cleanly else _sidecar_open_spans(heartbeat)
        )
        sidecar_ts = (crashdump or {}).get("ts") or (
            heartbeat or {}).get("ts")
        if closed_cleanly and not crashdump:
            for s in _sidecar_open_spans(heartbeat):
                if s.get("span_id") in closed_ids:
                    continue
                problems.append({
                    "kind": "unclosed",
                    "span_id": s.get("span_id"),
                    "detail": (
                        f"span {s.get('name')!r} ({s.get('span_id')}) still "
                        f"open after clean close of stream {stream}"
                    ),
                })
            continue
        for s in sidecar:
            if s.get("span_id") in closed_ids:
                continue
            start_ts = s.get("start_ts")
            dur = None
            if start_ts is not None and sidecar_ts is not None:
                dur = max(0.0, float(sidecar_ts) - float(start_ts))
            spans.append({
                "name": s.get("name"),
                "cat": s.get("cat"),
                "span_id": s.get("span_id"),
                "parent_id": s.get("parent_id"),
                "trace_id": s.get("trace_id"),
                "start_ts": start_ts,
                "dur_s": dur if dur is not None else 0.0,
                "status": "aborted",
                "ext": bool(s.get("ext")),
                "attrs": {**(s.get("attrs") or {}), "synthesized": True},
                "host": envelope["host"],
                "pid": envelope["pid"],
                "proc": envelope["proc"],
                "stream": stream,
            })
    return {
        "spans": spans,
        "problems": problems,
        "streams": len(seen_dirs),
        "profile_windows": windows,
    }


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


# ------------------------------------------------------- Chrome export


def chrome_trace(spans: list[dict],
                 profile_windows: list[dict] | None = None) -> dict:
    """A merged Chrome-trace-event JSON (Perfetto-loadable): one process
    row per stream, one thread row per span category; overlapping serve
    requests as async (b/e) events so concurrent lifetimes render as
    separate tracks instead of garbled nesting."""
    streams = sorted({s["stream"] for s in spans})
    pid_of = {stream: i for i, stream in enumerate(streams)}
    tid_of: dict[tuple[int, str], int] = {}
    events: list[dict] = []

    def tid(pid: int, track: str) -> int:
        key = (pid, track)
        if key not in tid_of:
            tid_of[key] = len([k for k in tid_of if k[0] == pid]) + 1
            events.append({
                "ph": "M", "name": "thread_name", "pid": pid,
                "tid": tid_of[key], "args": {"name": track},
            })
        return tid_of[key]

    for stream in streams:
        first = next(s for s in spans if s["stream"] == stream)
        label = f"{stream}"
        if first.get("proc") is not None:
            label = f"p{first['proc']} · {stream}"
        if first.get("host"):
            label += f" @ {first['host']}"
        events.append({
            "ph": "M", "name": "process_name", "pid": pid_of[stream],
            "tid": 0, "args": {"name": label},
        })
        events.append({
            "ph": "M", "name": "process_sort_index", "pid": pid_of[stream],
            "tid": 0, "args": {"sort_index": pid_of[stream]},
        })

    epoch_index: dict[tuple[str, int], dict] = {}
    for s in spans:
        if s.get("start_ts") is None or s.get("dur_s") is None:
            continue
        pid = pid_of[s["stream"]]
        args = {
            "span_id": s.get("span_id"),
            "parent_id": s.get("parent_id"),
            "trace_id": s.get("trace_id"),
            "status": s.get("status"),
            **{k: v for k, v in (s.get("attrs") or {}).items()},
        }
        ts_us = float(s["start_ts"]) * 1e6
        dur_us = max(0.0, float(s["dur_s"])) * 1e6
        if s.get("name") == "serve.request":
            common = {
                "cat": s.get("cat") or "serve", "name": s["name"],
                "id": str(s.get("span_id")), "pid": pid,
                "tid": tid(pid, "serve.requests"),
            }
            events.append({**common, "ph": "b", "ts": ts_us, "args": args})
            events.append({**common, "ph": "e", "ts": ts_us + dur_us,
                           "args": {}})
        else:
            events.append({
                "ph": "X", "name": s.get("name") or "?",
                "cat": s.get("cat") or "span",
                "ts": ts_us, "dur": dur_us, "pid": pid,
                "tid": tid(pid, s.get("cat") or "span"),
                "args": args,
            })
        if s.get("name") == "train.epoch":
            ep = (s.get("attrs") or {}).get("epoch")
            if ep is not None:
                epoch_index[(s["stream"], int(ep))] = s

    # torch.profiler capture windows, placed on the timeline via the epoch
    # spans they bracket (the window event itself is emitted at close).
    for win in profile_windows or []:
        lo = epoch_index.get((win["stream"], int(win.get("start_epoch", -1))
                              if win.get("start_epoch") is not None else -1))
        hi = epoch_index.get((win["stream"], int(win.get("end_epoch", -1))
                              if win.get("end_epoch") is not None else -1))
        if lo is None or hi is None:
            continue
        start = float(lo["start_ts"])
        end = float(hi["start_ts"]) + float(hi["dur_s"])
        pid = pid_of.get(win["stream"], 0)
        events.append({
            "ph": "X", "name": "torch.profiler window", "cat": "profiler",
            "ts": start * 1e6, "dur": max(0.0, end - start) * 1e6,
            "pid": pid, "tid": tid(pid, "torch.profiler"),
            "args": {"trace_dir": win.get("trace_dir"),
                     "start_epoch": win.get("start_epoch"),
                     "end_epoch": win.get("end_epoch")},
        })

    return {"traceEvents": events, "displayTimeUnit": "ms"}


# ------------------------------------------------- critical-path math


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
    ``serve.request`` span (the bench's ``detail.serve`` source)."""
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


def epoch_attribution(spans: list[dict]) -> dict | None:
    """Median-epoch breakdown over ``train.epoch`` spans. The epoch wall
    decomposes as host dispatch + (in stream mode) data wait + the
    device/overlap remainder — the boundary-to-boundary semantics the
    EpochRecorder already defines, so components tile the wall exactly."""
    epochs = sorted(
        (s for s in spans if s.get("name") == "train.epoch"
         and s.get("status") == "ok" and s.get("dur_s") is not None),
        key=lambda s: s["dur_s"],
    )
    if not epochs:
        return None

    def breakdown(s: dict) -> dict:
        attrs = s.get("attrs") or {}
        wall = float(s["dur_s"])
        dispatch = min(float(attrs.get("dispatch_s") or 0.0), wall)
        data_wait = min(float(attrs.get("data_wait_s") or 0.0),
                        max(0.0, dispatch))
        comp = {
            "dispatch_s": dispatch - data_wait,
            "data_wait_s": data_wait,
            "device_overlap_s": max(0.0, wall - dispatch),
        }
        b = _breakdown(wall, comp)
        b["epoch"] = attrs.get("epoch")
        b["fenced"] = attrs.get("fenced")
        b["device_s"] = attrs.get("device_s")
        return b

    median = _quantile_item(epochs, 0.50)
    return {
        "epochs": len(epochs),
        "median": breakdown(median),
        "slowest": breakdown(epochs[-1]),
    }


# ------------------------------------------------------------- report


def build_trace_report(root: str | Path,
                       out: str | Path | None = None) -> dict:
    """Collect + validate + attribute + export: the ``trace`` CLI body.
    ``exit_code``: 0 ok, 1 no spans found, 2 broken span tree."""
    root = Path(root)
    collected = collect_spans(root)
    spans = collected["spans"]
    problems = validate_spans(spans, collected["problems"])
    traces: dict[str, dict] = {}
    for s in spans:
        t = traces.setdefault(
            s.get("trace_id") or "?", {"spans": 0, "streams": set()}
        )
        t["spans"] += 1
        t["streams"].add(s["stream"])
    chrome = chrome_trace(spans, collected["profile_windows"])
    chrome_path = None
    if out is not None and spans:
        chrome_path = Path(out)
        chrome_path.parent.mkdir(parents=True, exist_ok=True)
        chrome_path.write_text(json.dumps(chrome))
    report = {
        "root": str(root),
        "streams": collected["streams"],
        "spans": len(spans),
        "aborted": sum(1 for s in spans if s.get("status") == "aborted"),
        "traces": {
            tid: {"spans": t["spans"], "streams": sorted(t["streams"])}
            for tid, t in sorted(traces.items())
        },
        "problems": problems,
        "serve": serve_attribution(spans),
        "epoch": epoch_attribution(spans),
        "chrome_events": len(chrome["traceEvents"]),
        "chrome_path": str(chrome_path) if chrome_path else None,
        "profile_windows": len(collected["profile_windows"]),
    }
    if not spans:
        report["exit_code"] = 1
    elif problems:
        report["exit_code"] = 2
    else:
        report["exit_code"] = 0
    return report


def _fmt_breakdown(b: dict | None) -> str:
    if b is None:
        return "n/a"
    wall = b["wall_s"]
    unit, scale = ("ms", 1e3) if wall < 1.0 else ("s", 1.0)
    parts = " + ".join(
        f"{name.removesuffix('_s')} {100.0 * share:.0f}%"
        for name, share in sorted(
            b["shares"].items(), key=lambda kv: -kv[1]
        )
        if share >= 0.005
    )
    ok = "" if b["sum_ok"] else "  [components do not cover wall]"
    return f"{wall * scale:.3g}{unit} = {parts}{ok}"


def render_trace_text(report: dict) -> str:
    lines = [
        f"trace          : {report['spans']} span(s) across "
        f"{report['streams']} stream(s), {len(report['traces'])} trace(s)"
        + (f", {report['aborted']} aborted" if report["aborted"] else ""),
    ]
    for tid, t in report["traces"].items():
        lines.append(
            f"  {tid}  {t['spans']} span(s) in {', '.join(t['streams'])}"
        )
    serve = report.get("serve")
    if serve:
        lines.append(
            f"serve          : {serve['completed']}/{serve['requests']} "
            f"completed, {serve['shed']} shed, "
            f"{serve['rejected_late']} late-rejected"
        )
        if serve["shed_by_reason"]:
            lines.append(
                "  shed by reason: " + ", ".join(
                    f"{k}={v}" for k, v in sorted(
                        serve["shed_by_reason"].items())
                )
            )
        if serve.get("queue_wait_share") is not None:
            lines.append(
                f"  queue-wait share {100 * serve['queue_wait_share']:.1f}% "
                f"| compute share {100 * (serve['compute_share'] or 0):.1f}%"
            )
        lines.append(f"  p50 request  : {_fmt_breakdown(serve['p50'])}")
        lines.append(f"  p99 request  : {_fmt_breakdown(serve['p99'])}")
    epoch = report.get("epoch")
    if epoch:
        med = epoch["median"]
        lines.append(
            f"epoch median   : {_fmt_breakdown(med)}"
            + (f"  (epoch {med.get('epoch')})"
               if med.get("epoch") is not None else "")
        )
    if report.get("chrome_path"):
        lines.append(
            f"chrome trace   : {report['chrome_path']} "
            f"({report['chrome_events']} events; open in Perfetto)"
        )
    if report["problems"]:
        lines.append("BROKEN SPAN TREE:")
        lines.extend(f"  - {p['detail']}" for p in report["problems"])
    elif report["spans"]:
        lines.append("span tree      : ok")
    else:
        lines.append("span tree      : no spans found")
    return "\n".join(lines)


# ----------------------------------------------------------- selfcheck


def _selfcheck_fixture(root: Path) -> str:
    """A synthetic multi-process trace: a supervisor with two attempts
    (one killed mid-epoch, one finishing), a 2-process fleet of epoch
    spans, and a serve stream with sheds — all through the real writer
    classes so the fixture exercises the same code paths as production."""
    from masters_thesis_tpu_torch.telemetry.events import EventSink

    t0 = time.time() - 100.0
    trace_id = new_trace_id()

    sup_sink = EventSink(root / "sup" / "events.jsonl", run_id="sup")
    sup = Tracer(sup_sink, trace_id=trace_id, env={})
    run_span = sup.start("supervisor.run")
    run_span.start_ts = t0
    a1 = sup.start("supervisor.attempt", parent=run_span, n=1)
    a1.start_ts = t0 + 0.1
    a2 = sup.start("supervisor.attempt", parent=run_span, n=2)
    a2.start_ts = t0 + 4.5
    sup.end(a1, status="error", dur_s=4.0, rc=-15)
    sup.end(a2, status="ok", dur_s=5.0, rc=0)
    sup.end(run_span, status="ok", dur_s=10.0)
    sup_sink.emit("supervisor_verdict", ok=True)
    sup_sink.close()

    # Worker p0: killed mid-epoch — its fit span survives only in the
    # crashdump sidecar and must come back as `aborted`, not orphaned.
    w0_sink = EventSink(root / "w0" / "events.jsonl", run_id="w0", proc=0,
                        nproc=2)
    w0 = Tracer(w0_sink, trace_id=trace_id,
                env={PARENT_SPAN_ENV: a1.span_id})
    fit0 = w0.start("trainer.fit")
    fit0.start_ts = t0 + 0.2
    for ep in range(2):
        w0.emit_span(
            "train.epoch", start_ts=t0 + 0.3 + ep, dur_s=1.0,
            parent=fit0, epoch=ep, dispatch_s=0.12, data_wait_s=0.02,
            fenced=(ep == 0),
        )
    (root / "w0" / "crashdump.json").write_text(json.dumps({
        "reason": "signal: SIGKILL (simulated)", "ts": t0 + 4.0,
        "open_spans": w0.open_spans(),
    }))
    w0_sink.close()

    # Worker p1: the healthy retry, sharing the SAME trace id via env.
    w1_sink = EventSink(root / "w1" / "events.jsonl", run_id="w1", proc=1,
                        nproc=2)
    w1 = Tracer(w1_sink, trace_id=trace_id,
                env={PARENT_SPAN_ENV: a2.span_id})
    fit1 = w1.start("trainer.fit")
    fit1.start_ts = t0 + 4.6
    for ep in range(3):
        w1.emit_span(
            "train.epoch", start_ts=t0 + 4.7 + ep, dur_s=1.0 + 0.1 * ep,
            parent=fit1, epoch=ep, dispatch_s=0.1, data_wait_s=0.0,
            fenced=(ep == 0),
        )
    w1.end(fit1, dur_s=4.8)
    w1_sink.emit("run_finished", epochs=3, total_steps=30)
    w1_sink.close()

    # Serve stream: 20 requests with exhaustive component attribution.
    sv_sink = EventSink(root / "serve" / "events.jsonl", run_id="serve")
    sv = Tracer(sv_sink, trace_id=trace_id, env={})
    server_span = sv.start("serve.server")
    server_span.start_ts = t0 + 20.0
    for i in range(20):
        wall = 0.004 + 0.0005 * i
        queue = 0.4 * wall
        device = 0.5 * wall
        sv.emit_span(
            "serve.request", start_ts=t0 + 20.1 + 0.01 * i, dur_s=wall,
            parent=server_span, rid=i, admit_s=0.02 * wall, queue_s=queue,
            batch_form_s=0.02 * wall, device_s=device,
            deliver_s=0.02 * wall,
        )
    for i, (status, category) in enumerate(
        (("shed", "queue_full"), ("shed", "deadline_infeasible"),
         ("rejected_late", "rejected_late")),
    ):
        sv.emit_span(
            "serve.request", start_ts=t0 + 20.5 + 0.01 * i, dur_s=0.001,
            parent=server_span, status=status, rid=100 + i,
            reason_category=category,
        )
    sv.end(server_span, dur_s=2.0)
    sv_sink.close()
    return trace_id


def selfcheck(echo=print) -> int:
    """Hermetic fixture → report → Chrome JSON → attribution checks,
    plus the negative case (a deliberately broken tree must exit 2).
    Returns a process exit code."""
    import tempfile

    failures: list[str] = []

    def check(cond: bool, what: str) -> None:
        if cond:
            echo(f"  ok: {what}")
        else:
            failures.append(what)

    with tempfile.TemporaryDirectory() as td:
        root = Path(td)
        trace_id = _selfcheck_fixture(root)
        out = root / "trace.json"
        report = build_trace_report(root, out=out)
        check(report["exit_code"] == 0,
              f"clean fixture exits 0 (got {report['exit_code']}: "
              f"{report['problems']})")
        check(report["aborted"] == 1,
              f"killed worker's open span aborted (got {report['aborted']})")
        check(len(report["traces"]) == 1
              and trace_id in report["traces"],
              "one trace id spans supervisor + both workers + serve")
        if trace_id in report["traces"]:
            check(len(report["traces"][trace_id]["streams"]) == 4,
                  "all 4 process streams joined the trace")
        serve = report["serve"] or {}
        check(serve.get("completed") == 20 and serve.get("shed") == 2,
              "serve request census (20 completed / 2 shed)")
        p99 = serve.get("p99") or {}
        check(bool(p99.get("sum_ok")),
              "p99 request components cover wall within 5%")
        qws = serve.get("queue_wait_share")
        check(qws is not None and abs(qws - 0.4) < 0.01,
              f"queue-wait share ≈ 40% (got {qws})")
        med = (report["epoch"] or {}).get("median") or {}
        check(bool(med.get("sum_ok")),
              "median epoch components cover wall within 5%")
        chrome = json.loads(out.read_text())
        events = chrome.get("traceEvents", [])
        check(bool(events) and all(
            {"ph", "pid"} <= set(e) for e in events),
            "chrome trace events well-formed")
        begins = sum(1 for e in events if e.get("ph") == "b")
        ends = sum(1 for e in events if e.get("ph") == "e")
        check(begins == ends and begins == 23,
              f"async request events balanced ({begins}b/{ends}e)")
        check(any(e.get("ph") == "M" and e.get("name") == "process_name"
                  for e in events), "process_name metadata present")

    with tempfile.TemporaryDirectory() as td:
        root = Path(td)
        from masters_thesis_tpu_torch.telemetry.events import EventSink

        sink = EventSink(root / "bad" / "events.jsonl", run_id="bad")
        bad = Tracer(sink, env={})
        bad.emit_span("x.orphan", start_ts=1.0, dur_s=1.0,
                      parent="feedfeed")
        bad.emit_span("x.negative", start_ts=2.0, dur_s=-0.5)
        sink.close()
        (root / "bad" / "heartbeat.json").write_text(json.dumps({
            "ts": 3.0, "closed": True,
            "open_spans": [{"name": "x.unclosed", "span_id": "aa11aa11",
                            "start_ts": 2.5}],
        }))
        report = build_trace_report(root)
        kinds = {p["kind"] for p in report["problems"]}
        check(report["exit_code"] == 2, "broken fixture exits 2")
        check(kinds == {"orphan", "negative_duration", "unclosed"},
              f"all three problem classes detected (got {sorted(kinds)})")

    if failures:
        for f in failures:
            echo(f"  FAIL: {f}")
        echo(f"trace selfcheck: {len(failures)} failure(s)")
        return 1
    echo("trace selfcheck: ok")
    return 0
