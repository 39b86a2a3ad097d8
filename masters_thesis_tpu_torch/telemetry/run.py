"""One run's telemetry: ``<run_dir>/events.jsonl``, a live registry, the
flight recorder and the epoch accounting the trainers drive.

Counterpart of ``masters_thesis_tpu/telemetry/run.py``: ``TelemetryRun``
(``event``, ``tracer``, ``attach_flight_recorder``, ``counter``/``gauge``/
``histogram``, ``sample_memory``, ``snapshot_metrics``, ``close``),
:class:`CaptureTracker` and :class:`EpochRecorder`. Constructing a run over
an existing directory continues its stream (a resumed attempt appends).

The port's trainer reads each epoch's metric sums on the host as the epoch
ends, so every epoch is fenced: :class:`EpochRecorder` closes an epoch at
that read, and ``device_s`` is the card's own time for the epoch's work,
two CUDA events recorded around it and read after that read (on the CPU,
the wait at the read, as the JAX recorder measures a fence). Compiles are
counted as the CUDA graph captures of the programs a trainer owns
(:class:`CaptureTracker` over ``utils/cuda_graph.py``'s ``GraphedCall``):
1 for the train program in the first epoch on the card, 0 after, and 0 on
the CPU, where nothing is captured.

Telemetry never stops a run: an event that cannot be written (a full disk,
a closed file) is dropped and counted in ``write_errors``, and the
recorder's calls do not raise. The device memory snapshot reads the card
through ``torch.cuda`` (host-side allocator counters that make the card
wait for nothing). This module imports no torch; it reads the card only
where torch is already imported, so the supervisor and the report use it
in a process without torch.

A run of a data-parallel launch is tagged with its rank:
:func:`process_identity` (the process group's rank and world where one is
initialised, else the launch environment's) goes into every event's
envelope (``proc``, ``nproc``) and into the registry's ``process_index``
and ``process_count`` tags; each rank writes its own stream.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from pathlib import Path
from typing import Callable, Sequence

from masters_thesis_tpu_torch.telemetry.events import EventSink
from masters_thesis_tpu_torch.telemetry.registry import MetricsRegistry


#: The identity's environment, in order: the launch's (``parallel/mesh.py``
#: exports them to every rank), then the multi-host sweep's.
_IDENTITY_ENV = (
    ("JAX_PROCESS_INDEX", "JAX_PROCESS_COUNT"),
    ("MT_HOST_INDEX", "MT_NUM_HOSTS"),
)


def process_identity() -> tuple[int | None, int | None]:
    """``(process_index, process_count)`` to tag a telemetry stream with:
    the process group's rank and world where torch is imported and a group
    is initialised (never importing torch), else the environment's
    (``JAX_PROCESS_INDEX``, then ``MT_HOST_INDEX``), else ``(None,
    None)``."""
    torch = sys.modules.get("torch")
    if torch is not None:
        try:
            dist = torch.distributed
            if dist.is_available() and dist.is_initialized():
                return dist.get_rank(), dist.get_world_size()
        except (AttributeError, RuntimeError):
            pass
    for index_key, count_key in _IDENTITY_ENV:
        index = os.environ.get(index_key)
        if index is None:
            continue
        try:
            count = os.environ.get(count_key)
            return int(index), (int(count) if count else None)
        except ValueError:
            continue
    return None, None


class TelemetryRun:
    """One run's telemetry: ``<run_dir>/events.jsonl`` + a live registry."""

    def __init__(self, run_dir: str | Path, run_id: str | None = None):
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        proc, nproc = process_identity()
        if run_id is None:
            run_id = time.strftime("%Y%m%d-%H%M%S") + f"-p{proc or 0}"
        self.run_id = run_id
        tags = {}
        if proc is not None:
            tags["process_index"] = proc
        if nproc is not None:
            tags["process_count"] = nproc
        self.registry = MetricsRegistry(tags=tags)
        self.sink = EventSink(self.run_dir / "events.jsonl", run_id=run_id,
                              proc=proc, nproc=nproc)
        #: Events that could not be written (dropped, never raised).
        self.write_errors = 0
        self._errors_lock = threading.Lock()
        # The flight recorder (attach_flight_recorder) mirrors every event
        # into its ring, so a crashdump carries the run's recent history.
        self.recorder = None
        self._tracer = None

    def event(self, kind: str, **payload) -> dict:
        try:
            ev = self.sink.emit(kind, **payload)
        except OSError:
            with self._errors_lock:  # event() runs on several threads
                self.write_errors += 1
            return {}
        if self.recorder is not None:
            self.recorder.record(ev)
        return ev

    @property
    def tracer(self):
        """This run's span writer (made at first use; adopts
        ``MTT_TRACE_ID`` / ``MTT_PARENT_SPAN`` from the environment). Its
        open spans go into the flight recorder's sidecars."""
        if self._tracer is None:
            from masters_thesis_tpu_torch.telemetry.trace import Tracer

            self._tracer = Tracer(self.sink)
        return self._tracer

    def attach_flight_recorder(self, **kwargs):
        """The run's flight recorder (``telemetry/flightrec.py``):
        ``crashdump.json`` on SIGTERM, SIGQUIT or a hang, ``heartbeat.json``
        for the supervisor. The first attach wins; later calls return it.
        Before its first heartbeat overwrites a dead attempt's sidecars,
        that attempt's open spans are closed into the stream as
        ``aborted``."""
        if self.recorder is None:
            from masters_thesis_tpu_torch.telemetry.flightrec import (
                FlightRecorder,
            )
            from masters_thesis_tpu_torch.telemetry.trace import (
                adopt_orphaned_spans,
            )

            adopt_orphaned_spans(self.run_dir, self.sink)
            self.recorder = FlightRecorder(
                self.run_dir, run_id=self.run_id, sink=self.sink, **kwargs
            )
            self.recorder.open_spans_provider = (
                lambda: self._tracer.open_spans()
                if self._tracer is not None else []
            )
        return self.recorder

    def counter(self, name: str):
        return self.registry.counter(name)

    def gauge(self, name: str):
        return self.registry.gauge(name)

    def histogram(self, name: str):
        return self.registry.histogram(name)

    def sample_memory(self, epoch, device) -> dict | None:
        """Gauges and a ``memory`` event for the memory of ``device``, the
        card the run uses (None, and nothing written, for any other
        device). The event carries the JAX package's keys."""
        snap = device_memory_snapshot(device)
        if snap is None:
            return None
        for key in ("bytes_in_use", "peak_bytes_in_use", "live_buffer_bytes",
                    "live_buffers", "device_free_bytes",
                    "device_total_bytes"):
            self.gauge(f"device/{key}").set(snap[key])
        self.event("memory", epoch=epoch,
                   **{k: snap[k] for k in MEMORY_EVENT_KEYS})
        return snap

    def snapshot_metrics(self) -> dict:
        """Emit the registry's state as a ``metrics`` event."""
        snap = self.registry.snapshot()
        self.event("metrics", **snap)
        return snap

    def close(self) -> None:
        # Spans an exception path left open close as ``aborted`` before the
        # recorder writes its final (closed) heartbeat, so a cleanly closed
        # stream never claims open spans.
        if self._tracer is not None:
            self._tracer.close_all(status="aborted")
        if self.recorder is not None:
            self.recorder.close()
        self.sink.close()


#: The ``memory`` event's payload (besides ``epoch``), the JAX package's.
MEMORY_EVENT_KEYS = ("bytes_in_use", "peak_bytes_in_use", "live_buffer_bytes",
                     "live_buffers", "source")


def device_memory_snapshot(device) -> dict | None:
    """The memory of ``device``, a CUDA card: bytes the caching allocator
    has handed out now and at its peak (``live_buffer_bytes`` is the
    former, and ``live_buffers`` the allocations live now, the
    counterparts of the JAX package's live arrays), and the card's free
    and total bytes. None for any other device, and when torch was never
    imported (host tooling must not pull torch in): a run on the CPU reads
    nothing of a card, so it opens no CUDA context."""
    torch = sys.modules.get("torch")
    if torch is None:
        return None
    device = torch.device(device)
    if device.type != "cuda":
        return None
    free, total = torch.cuda.mem_get_info(device)
    in_use = int(torch.cuda.memory_allocated(device))
    stats = torch.cuda.memory_stats(device)
    return {
        "bytes_in_use": in_use,
        "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(device)),
        "live_buffer_bytes": in_use,
        "live_buffers": int(stats.get("allocation.all.current", 0)),
        "device_free_bytes": int(free),
        "device_total_bytes": int(total),
        "source": "torch.cuda",
    }


class CaptureTracker:
    """Counts the CUDA graph captures of a trainer's programs, the
    counterpart of the JAX package's ``CompileTracker``.

    ``calls`` are the programs' step calls (``GraphedCall``s on the card);
    ``poll()`` is how many captures they made since the last poll
    (``GraphedCall.captures``): 1 in the epoch that captures the train
    step, 0 in steady state, more exactly when a program was captured
    again. Eager calls (the CPU, ``cuda_graphs=False``) are not graphs and
    count nothing.
    """

    def __init__(self, calls: Sequence):
        self._calls = list(calls)
        self._last = self._count()
        self.total = 0

    def _count(self) -> int:
        return sum(getattr(call, "captures", 0) for call in self._calls)

    def poll(self) -> int:
        count = self._count()
        new = count - self._last
        self._last = count
        self.total += new
        return new


class EpochRecorder:
    """Turns the trainer's loop boundaries into ``epoch`` events.

    Per epoch: ``begin`` (closes an epoch left open), ``dispatched`` (host
    seconds to queue the epoch, captures, data wait), ``fenced`` (the card
    seconds of the epoch, closing it at the trainer's read of its sums),
    and ``finish`` once after the loop. No call raises: a telemetry fault
    must never stop a training run.
    """

    def __init__(self, tel: TelemetryRun, steps_per_epoch: int,
                 on_epoch: Callable[[dict], None] | None = None,
                 span_parent=None):
        self.tel = tel
        self.steps_per_epoch = steps_per_epoch
        #: Called with each finished epoch event (the trainer mirrors the
        #: perf scalars into its logger).
        self.on_epoch = on_epoch
        #: With a parent span (the trainer's ``trainer.fit``), every epoch
        #: also lands as a retroactive ``train.epoch`` span.
        self.span_parent = span_parent
        self._open: dict | None = None
        self._t0: float | None = None
        self._wall0: float | None = None

    def begin(self, epoch: int) -> None:
        now = time.perf_counter()
        self._finalize(now, fenced=False, device_s=None)
        self._t0 = now
        self._wall0 = time.time()
        self._open = {"epoch": epoch}

    def dispatched(self, compiles: int = 0, data_wait_s: float = 0.0) -> None:
        if self._open is None or self._t0 is None:
            return
        self._open["dispatch_s"] = time.perf_counter() - self._t0
        self._open["compile_events"] = compiles
        self._open["data_wait_s"] = data_wait_s
        try:
            if compiles:
                self.tel.counter("train/epoch_compiles").inc(compiles)
            if data_wait_s:
                self.tel.counter("data/get_wait_s").inc(data_wait_s)
        except Exception:
            pass

    def fenced(self, device_s: float | None) -> None:
        self._finalize(time.perf_counter(), fenced=True, device_s=device_s)

    def finish(self) -> None:
        self._finalize(time.perf_counter(), fenced=True, device_s=None)

    def _finalize(self, now: float, fenced: bool, device_s: float | None):
        if self._open is None or self._t0 is None:
            return
        ev, self._open = self._open, None
        wall = now - self._t0
        wall0, self._t0, self._wall0 = self._wall0, None, None
        try:
            self._emit(ev, wall, wall0, fenced, device_s)
        except Exception:  # observation must never stop a run
            pass

    def _emit(self, ev, wall, wall0, fenced, device_s) -> None:
        steps = self.steps_per_epoch
        compiled = bool(ev.get("compile_events"))
        self.tel.counter("train/epochs").inc()
        self.tel.counter("train/steps").inc(steps)
        self.tel.histogram("train/epoch_wall_s").observe(wall)
        if not compiled and steps > 0:
            self.tel.histogram("train/step_time_s").observe(wall / steps)
        payload = self.tel.event(
            "epoch",
            epoch=ev["epoch"],
            steps=steps,
            wall_s=wall,
            dispatch_s=ev.get("dispatch_s"),
            device_s=device_s,
            data_wait_s=ev.get("data_wait_s", 0.0),
            compile_events=ev.get("compile_events", 0),
            compiled=compiled,
            fenced=fenced,
            steps_per_sec=(steps / wall) if wall > 0 else None,
        )
        if self.span_parent is not None and wall0 is not None:
            self.tel.tracer.emit_span(
                "train.epoch",
                start_ts=wall0,
                dur_s=wall,
                parent=self.span_parent,
                cat="train",
                epoch=ev["epoch"],
                dispatch_s=ev.get("dispatch_s"),
                device_s=device_s,
                data_wait_s=ev.get("data_wait_s", 0.0),
                compiled=compiled,
                fenced=fenced,
            )
        if self.on_epoch is not None and payload:
            self.on_epoch(payload)
