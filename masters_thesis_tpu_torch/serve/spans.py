"""Per-request span bookkeeping of the server.

Counterpart of ``masters_thesis_tpu/serve/spans.py``, with its contract: a
request span is opened at submit and closed exactly once with components
that TILE its wall clock —

    admit_s + queue_s + batch_form_s + device_s + deliver_s == dur_s

The boundaries are:

    t0 (submit) -> t_admitted -> t_pickup -> t_predict0 -> t_predict_end
    -> t_resolve

Missing boundaries (a shed never reaches the engine; a rejected-late
request never reaches the device) collapse to zero-width components, and
boundaries are forced monotone so a stamp race between the submit and
dispatch threads can never produce a negative component. Imports no torch:
the serving selfcheck drives the server without it.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Iterable


class RequestSpans:
    """rid -> open span + boundary stamps; thread-safe.

    ``tracer_fn`` is called at every operation (not once) because the
    server may run without telemetry — every method is a cheap no-op when
    it returns ``None``.
    """

    #: Interior boundaries in tiling order (t0 and t_resolve bracket them).
    BOUNDARIES = ("t_admitted", "t_pickup", "t_predict0", "t_predict_end")

    def __init__(self, tracer_fn: Callable[[], object | None]):
        self._tracer_fn = tracer_fn
        self._lock = threading.Lock()
        self._entries: dict[int, dict] = {}
        # ok-request component sums: the server's queue_wait_share /
        # compute_share stats.
        self._sum_queue_s = 0.0
        self._sum_device_s = 0.0
        self._sum_req_wall_s = 0.0

    def _tracer(self):
        return self._tracer_fn()

    def open(self, rid: int, name: str, *, parent=None, **attrs) -> None:
        """Start the request span. Must run BEFORE queue submit: a shed
        resolves synchronously inside submit and closes the span."""
        tracer = self._tracer()
        if tracer is None:
            return
        entry = {
            "span": tracer.start(name, parent=parent, rid=rid, **attrs),
            "t0": time.perf_counter(),
        }
        with self._lock:
            self._entries[rid] = entry

    def stamp(self, rid: int, key: str, t: float | None = None) -> None:
        if self._tracer() is None:
            return
        t = time.perf_counter() if t is None else t
        with self._lock:
            entry = self._entries.get(rid)
            if entry is not None:
                entry[key] = t

    def stamp_many(self, rids: Iterable[int], key: str, t: float) -> None:
        if self._tracer() is None:
            return
        with self._lock:
            for rid in rids:
                entry = self._entries.get(rid)
                if entry is not None:
                    entry[key] = t

    def annotate(self, rid: int, **attrs) -> None:
        """Attributes written when the span closes (the fleet marks a
        re-dispatched request with ``redispatched_from=<replica>``)."""
        with self._lock:
            entry = self._entries.get(rid)
            if entry is not None:
                entry.setdefault("attrs", {}).update(attrs)

    def close(self, rid: int, status: str, t_resolve: float, **attrs) -> None:
        """End the span with tiling components (see module docstring)."""
        tracer = self._tracer()
        if tracer is None:
            return
        with self._lock:
            entry = self._entries.pop(rid, None)
        if entry is None:
            return
        b = [entry["t0"]]
        for key in self.BOUNDARIES:
            t = entry.get(key)
            b.append(b[-1] if t is None else max(b[-1], t))
        b.append(max(b[-1], t_resolve))
        admit_s, queue_s, batch_form_s, device_s, deliver_s = (
            b[i + 1] - b[i] for i in range(5)
        )
        wall = b[-1] - b[0]
        if status == "ok":
            with self._lock:
                self._sum_queue_s += queue_s
                self._sum_device_s += device_s
                self._sum_req_wall_s += wall
        merged = {**entry.get("attrs", {}), **attrs}
        tracer.end(
            entry["span"],
            status=status,
            dur_s=wall,
            admit_s=admit_s,
            queue_s=queue_s,
            batch_form_s=batch_form_s,
            device_s=device_s,
            deliver_s=deliver_s,
            **merged,
        )

    def close_shed(self, rid: int, category: str) -> None:
        """End a span shed at admission: the whole wall is admit_s."""
        tracer = self._tracer()
        if tracer is None:
            return
        with self._lock:
            entry = self._entries.pop(rid, None)
        if entry is None:
            return
        tracer.end(
            entry["span"],
            status="shed",
            reason_category=category,
            admit_s=time.perf_counter() - entry["t0"],
            **entry.get("attrs", {}),
        )

    def shares(self) -> tuple[float | None, float | None]:
        """(queue_wait_share, compute_share) over ok requests, or Nones."""
        with self._lock:
            wall = self._sum_req_wall_s
            if wall <= 0:
                return None, None
            return self._sum_queue_s / wall, self._sum_device_s / wall
