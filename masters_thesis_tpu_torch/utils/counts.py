"""Launch and collective counts that stay exact across threads and captures.

``ops.lstm_kernel.LAUNCHES`` and ``parallel.mesh.COLLECTIVES`` are
:class:`CallCounts`: a dict of counts by name whose increments
(:meth:`CallCounts.count`, and a CUDA graph replay's :meth:`CallCounts.add`)
take a lock, so that threads that launch at once (the replicas of a serving
fleet on one card) lose none.

A CUDA graph capture runs the kernel wrappers but launches nothing; what
they count while it runs is the graph's own (``utils/cuda_graph.py``), and
must not reach the process-wide counts. :meth:`CallCounts.diverted` sends
them to a dict of the capture's own: for a ``thread_local`` capture only
the capturing thread's counts (another thread's launches are real and
count as usual), for a ``global`` capture every thread's (the autograd
engine runs a captured backward on a thread of its own). A replay's
:meth:`CallCounts.add` is never diverted. Inside a diverted thread, reading
and writing a name reads and writes the capture's count, so a plain
``counts[name] += 1`` there is diverted too.
"""

from __future__ import annotations

import contextlib
import threading


class CallCounts(dict):
    """Counts by name; see the module docstring."""

    def __init__(self, names) -> None:
        super().__init__(dict.fromkeys(names, 0))
        self._lock = threading.RLock()
        self._local = threading.local()
        #: The sink of the ``global`` capture underway, if any.
        self._shared: dict | None = None

    def _sink(self) -> dict | None:
        sink = getattr(self._local, "sink", None)
        return self._shared if sink is None else sink

    def __getitem__(self, name):
        sink = self._sink()
        if sink is not None:
            return sink.get(name, 0)
        return dict.__getitem__(self, name)

    def __setitem__(self, name, value) -> None:
        sink = self._sink()
        if sink is not None:
            sink[name] = value
        else:
            dict.__setitem__(self, name, value)

    def count(self, name: str, n: int = 1) -> None:
        """One launch (or ``n``) of ``name``, diverted inside a capture."""
        with self._lock:
            self[name] = self[name] + n

    def add(self, counts: dict) -> None:
        """A replay's counts, never diverted."""
        with self._lock:
            for name, n in counts.items():
                dict.__setitem__(self, name, dict.get(self, name, 0) + n)

    def reset(self) -> None:
        with self._lock:
            for name in dict.keys(self):
                dict.__setitem__(self, name, 0)

    @contextlib.contextmanager
    def diverted(self, every_thread: bool):
        """Send counts to a fresh dict, yielded, while the block runs: this
        thread's, or with ``every_thread`` every thread's."""
        sink: dict = {}
        if every_thread:
            with self._lock:
                previous, self._shared = self._shared, sink
            try:
                yield sink
            finally:
                with self._lock:
                    self._shared = previous
        else:
            previous = getattr(self._local, "sink", None)
            self._local.sink = sink
            try:
                yield sink
            finally:
                self._local.sink = previous
