"""One run's telemetry: ``<run_dir>/events.jsonl`` and a live registry.

Counterpart of ``TelemetryRun`` in ``masters_thesis_tpu/telemetry/run.py``:
``event``, ``tracer``, ``counter``/``gauge``/``histogram``,
``sample_memory``, ``snapshot_metrics`` and ``close``. Constructing a run
over an existing directory continues its stream. The device memory
snapshot reads the card through ``torch.cuda`` (``mem_get_info``,
``memory_allocated``, ``max_memory_allocated``): host-side queries that
make the card wait for nothing. The JAX package's ``CompileTracker`` has
no counterpart: on the card a serving engine counts its own CUDA graph
captures (``PredictEngine.compile_events``). The flight recorder and the
epoch recorder are not ported. This module imports no torch; it reads the
card only where torch is already imported.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

from masters_thesis_tpu_torch.telemetry.events import EventSink
from masters_thesis_tpu_torch.telemetry.registry import MetricsRegistry


class TelemetryRun:
    """One run's telemetry: ``<run_dir>/events.jsonl`` + a live registry."""

    def __init__(self, run_dir: str | Path, run_id: str | None = None):
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        if run_id is None:
            run_id = time.strftime("%Y%m%d-%H%M%S") + "-p0"
        self.run_id = run_id
        self.registry = MetricsRegistry()
        self.sink = EventSink(self.run_dir / "events.jsonl", run_id=run_id)
        self._tracer = None

    def event(self, kind: str, **payload) -> dict:
        return self.sink.emit(kind, **payload)

    @property
    def tracer(self):
        """This run's span writer (made at first use; adopts
        ``MTT_TRACE_ID`` / ``MTT_PARENT_SPAN`` from the environment)."""
        if self._tracer is None:
            from masters_thesis_tpu_torch.telemetry.trace import Tracer

            self._tracer = Tracer(self.sink)
        return self._tracer

    def counter(self, name: str):
        return self.registry.counter(name)

    def gauge(self, name: str):
        return self.registry.gauge(name)

    def histogram(self, name: str):
        return self.registry.histogram(name)

    def sample_memory(self, tag: str | None = None) -> dict | None:
        """Gauges and a ``memory`` event for the card's memory (None
        without a card)."""
        snap = device_memory_snapshot()
        if snap is None:
            return None
        for key in ("bytes_in_use", "peak_bytes_in_use", "device_free_bytes",
                    "device_total_bytes"):
            self.gauge(f"device/{key}").set(snap[key])
        self.event("memory", tag=tag, **snap)
        return snap

    def snapshot_metrics(self) -> dict:
        """Emit the registry's state as a ``metrics`` event."""
        snap = self.registry.snapshot()
        self.event("metrics", **snap)
        return snap

    def close(self) -> None:
        # Spans an exception path left open close as ``aborted`` first, so
        # a cleanly closed stream never claims open spans.
        if self._tracer is not None:
            self._tracer.close_all(status="aborted")
        self.sink.close()


def device_memory_snapshot() -> dict | None:
    """The current card's memory: bytes the caching allocator has handed
    out now and at its peak, and the card's free and total bytes. None
    when torch was never imported or there is no card (host tooling must
    not pull torch in)."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_available():
        return None
    free, total = torch.cuda.mem_get_info()
    return {
        "bytes_in_use": int(torch.cuda.memory_allocated()),
        "peak_bytes_in_use": int(torch.cuda.max_memory_allocated()),
        "device_free_bytes": int(free),
        "device_total_bytes": int(total),
        "source": "torch.cuda",
    }
