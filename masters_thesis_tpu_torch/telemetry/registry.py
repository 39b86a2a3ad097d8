"""In-process metrics registry: counters, gauges, histograms.

Counterpart of ``masters_thesis_tpu/telemetry/registry.py``, with its
instrument names, its deterministic histogram sample (stride decimation, no
RNG) and its snapshot format, so the same ``render_prometheus`` text comes
out of either. Host-side and stdlib only. Instruments are tagged with
host/process identity; histograms keep exact count/sum/min/max and a
bounded sample for the live quantiles.
"""

from __future__ import annotations

import os
import socket
import threading


def default_tags() -> dict:
    """Host/process identity tags stamped on every instrument snapshot."""
    return {"host": socket.gethostname(), "pid": os.getpid()}


class Counter:
    """Monotonic accumulator (float increments allowed: seconds, bytes)."""

    def __init__(self, name: str):
        self.name = name
        self.value: float = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative increment")
        self.value += amount

    def snapshot(self) -> dict:
        return {"type": "counter", "value": self.value}


class Gauge:
    """Last-write-wins instantaneous value."""

    def __init__(self, name: str):
        self.name = name
        self.value: float | None = None

    def set(self, value: float) -> None:
        self.value = float(value)

    def snapshot(self) -> dict:
        return {"type": "gauge", "value": self.value}


class Histogram:
    """Summary stats + a bounded deterministic sample of observations.

    Once ``max_samples`` is reached the sample is decimated by dropping
    every other kept value and the keep-stride doubles — bounded memory,
    no randomness, and the kept points stay spread over the whole run
    rather than clustered at the start.

    Thread-safe: the dispatch thread observes while a ``/metrics`` scrape
    snapshots, so the summary state and the kept sample mutate under a
    lock.
    """

    def __init__(self, name: str, max_samples: int = 2048):
        self.name = name
        self.count = 0
        self.sum = 0.0
        self.min: float | None = None
        self.max: float | None = None
        self._samples: list[float] = []
        self._max_samples = max_samples
        self._stride = 1
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self.count += 1
            self.sum += value
            self.min = value if self.min is None else min(self.min, value)
            self.max = value if self.max is None else max(self.max, value)
            if (self.count - 1) % self._stride == 0:
                self._samples.append(value)
                if len(self._samples) >= self._max_samples:
                    self._samples = self._samples[::2]
                    self._stride *= 2

    @staticmethod
    def _rank(ordered: list[float], q: float) -> float | None:
        if not ordered:
            return None
        idx = min(len(ordered) - 1, max(0, round(q * (len(ordered) - 1))))
        return ordered[idx]

    def quantile(self, q: float) -> float | None:
        """Nearest-rank quantile over the kept sample (live approximation)."""
        with self._lock:
            samples = list(self._samples)
        return self._rank(sorted(samples), q)

    def snapshot(self) -> dict:
        with self._lock:
            count, total = self.count, self.sum
            lo, hi = self.min, self.max
            samples = list(self._samples)
        ordered = sorted(samples)
        return {
            "type": "histogram",
            "count": count,
            "sum": total,
            "min": lo,
            "max": hi,
            "mean": (total / count) if count else None,
            "p50": self._rank(ordered, 0.50),
            "p99": self._rank(ordered, 0.99),
        }


class MetricsRegistry:
    """Named instruments, created on first use, snapshot-able as one dict."""

    def __init__(self, tags: dict | None = None):
        self.tags = dict(default_tags())
        if tags:
            self.tags.update(tags)
        self._lock = threading.Lock()
        self._instruments: dict[str, Counter | Gauge | Histogram] = {}

    def _get(self, name: str, cls):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = self._instruments[name] = cls(name)
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}, requested {cls.__name__}"
                )
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "tags": dict(self.tags),
                "metrics": {
                    name: inst.snapshot()
                    for name, inst in sorted(self._instruments.items())
                },
            }
