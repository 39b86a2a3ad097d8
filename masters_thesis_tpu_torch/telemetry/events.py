"""Structured JSONL event sink: one append-only stream per run.

Counterpart of ``masters_thesis_tpu/telemetry/events.py``, with its schema:
each event is one JSON object a line with the envelope
``ts``/``kind``/``run``/``seq``/``host``/``pid``/``proc``/``nproc``/
``attempt`` (plus ``generation`` when ``MTT_GENERATION`` is set) and a flat,
kind-specific payload. The file is flushed after every line, so a killed
run loses at most the event being written, and a run that reopens a
stream appends to it. Stdlib only.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from pathlib import Path

# Envelope keys; payload keys must not collide (enforced at emit time).
RESERVED_KEYS = (
    "ts", "kind", "run", "seq", "host", "pid", "proc", "nproc", "attempt",
    "generation",
)

#: Fleet generation counter, as the JAX package's supervisor exports it.
GENERATION_ENV = "MTT_GENERATION"


def current_generation() -> int | None:
    """The generation from the env; ``None`` outside a supervised fleet
    (the key is then absent from every event)."""
    raw = os.environ.get(GENERATION_ENV)
    if not raw:
        return None
    try:
        return int(raw)
    except ValueError:
        return None


def current_attempt() -> int:
    """Supervisor attempt number (``MTT_ATTEMPT``); 1 when unsupervised."""
    try:
        return int(os.environ.get("MTT_ATTEMPT", "1") or 1)
    except ValueError:
        return 1


class EventSink:
    """Thread-safe append-only JSONL writer with per-line flush."""

    def __init__(
        self,
        path: str | Path,
        run_id: str,
        proc: int | None = None,
        nproc: int | None = None,
        attempt: int | None = None,
        generation: int | None = None,
    ):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.run_id = run_id
        self.proc = proc
        self.nproc = nproc
        self.attempt = current_attempt() if attempt is None else attempt
        self.generation = (
            current_generation() if generation is None else generation
        )
        self._host = socket.gethostname()
        self._pid = os.getpid()
        self._seq = 0
        self._lock = threading.Lock()
        self._file = None

    def emit(self, kind: str, **payload) -> dict:
        event = self._event(kind, payload)
        # The sequence number and the append are one step under the lock:
        # the lines of a stream are in ``seq`` order.
        with self._lock:
            return self._append(event)  # mtt: disable=CL503 -- the serialized append IS the sink's contract; the lock exists to order writers

    def try_emit(self, kind: str, timeout: float = 0.25,
                 **payload) -> dict | None:
        """``emit`` with a bounded wait for the lock, for signal handlers:
        a handler that interrupted a frame holding the lock gives up after
        ``timeout`` instead of deadlocking the process. None when the
        event was dropped."""
        event = self._event(kind, payload)
        if not self._lock.acquire(timeout=timeout):
            return None
        try:
            return self._append(event)  # mtt: disable=CL503 -- bounded handler-path append; same serialized-writer contract as emit()
        finally:
            self._lock.release()

    def _event(self, kind: str, payload: dict) -> dict:
        clashes = [k for k in payload if k in RESERVED_KEYS]
        if clashes:
            raise ValueError(f"payload keys clash with envelope: {clashes}")
        event = {
            "ts": time.time(),
            "kind": kind,
            "run": self.run_id,
            "seq": None,
            "host": self._host,
            "pid": self._pid,
            "proc": self.proc,
            "nproc": self.nproc,
            "attempt": self.attempt,
        }
        if self.generation is not None:
            event["generation"] = self.generation
        event.update(payload)
        return event

    def _append(self, event: dict) -> dict:
        event["seq"] = self._seq
        self._seq += 1  # mtt: disable=CL502 -- _append runs only with _lock held (emit/try_emit are the sole callers)
        if self._file is None:
            self._file = open(self.path, "a", encoding="utf-8")
        self._file.write(json.dumps(event, default=_jsonable) + "\n")
        self._file.flush()
        return event

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None


def _jsonable(obj):
    """Last-resort coercion: numpy scalars, Paths, anything with float()."""
    if isinstance(obj, Path):
        return str(obj)
    for cast in (float, int):
        try:
            return cast(obj)
        except (TypeError, ValueError):
            continue
    return str(obj)


def read_events(path: str | Path) -> list[dict]:
    """Load a JSONL event stream; tolerates a torn final line."""
    events: list[dict] = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError:
                continue  # torn tail from a killed writer
    return events


def read_new_lines(
    path: str | Path, cursor: int = 0
) -> tuple[list[dict], int]:
    """Incremental tail read: the events appended since ``cursor``.

    Returns ``(events, new_cursor)`` where ``new_cursor`` is the byte
    offset just past the last newline-terminated line. A torn final line
    (a writer killed mid-append, or simply caught mid-write) is NOT
    consumed: the cursor stays in front of it so the next call re-reads
    the line once its newline lands — unlike :func:`read_events`, which
    drops the torn tail, the incremental reader must not lose the event
    a live writer is still flushing. A terminated-but-unparseable line
    is skipped and consumed (it will never become valid). A file shorter
    than the cursor (stream replaced or truncated) resets to the top.
    A missing file returns ``([], cursor)`` unchanged.
    """
    cursor = max(0, int(cursor))
    try:
        f = open(path, "rb")
    except OSError:
        return [], cursor
    with f:
        size = f.seek(0, os.SEEK_END)
        if cursor > size:
            cursor = 0  # the stream shrank under us: re-read from the top
        f.seek(cursor)
        chunk = f.read()
    end = chunk.rfind(b"\n")
    if end < 0:
        return [], cursor  # nothing terminated yet
    events: list[dict] = []
    for raw in chunk[:end].split(b"\n"):
        raw = raw.strip()
        if not raw:
            continue
        try:
            ev = json.loads(raw.decode("utf-8"))
        except (json.JSONDecodeError, UnicodeDecodeError):
            continue  # terminated but corrupt: consumed, never retried
        if isinstance(ev, dict):
            events.append(ev)
    return events, cursor + end + 1
