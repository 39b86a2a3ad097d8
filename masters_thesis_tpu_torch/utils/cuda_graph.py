"""A call captured once as a CUDA graph and replayed: the card's counterpart
of ``jit(...).lower(...).compile()``.

The JAX package compiles each step function into one program (the training
epoch, the evaluation pass, each serving bucket). The port's counterpart is
:class:`GraphedCall`: its first call runs ``body`` once eagerly on the real
state (the warm-up, whose work counts: every kernel instance and library
handle it needs is made there, outside the capture), then captures ``body``
into a CUDA graph with its own memory pool; every later call replays the
graph. ``body`` takes no arguments and returns nothing: it reads static
buffers and writes static buffers in place, which is what a replay does.

The kernels count their launches in ``ops.lstm_kernel.LAUNCHES`` from
Python, so a capture, which runs the wrappers but no kernel, would count
launches that never ran, and a replay, which runs no Python, none. A
``GraphedCall`` sends the capture's counts to the graph's own
(``CallCounts.diverted``: the capturing thread's for a ``thread_local``
capture, every thread's for a ``global`` one) and adds them on every
replay; so too for the collectives in ``parallel.mesh.COLLECTIVES`` (a
data-parallel step captures its gradient all-reduce). Another thread's
launches and replays during a ``thread_local`` capture (the replicas of a
serving fleet share one card) count as they run. The warm-up run is what
creates an NCCL communicator that is made lazily, at its first collective:
that cannot happen inside a capture.

Nothing falls back: a failed capture raises :class:`CaptureError`, and a
kernel wrapper that finds a capture underway but its own stream not
capturing raises too (``lstm_kernel.capturing``). Python's cyclic garbage
collector is off while any capture runs (it would free dead graphs there):
:func:`collector_paused` counts the captures underway, the first turns it
off and the last turns it back on.

Several threads may hold graphs of their own (the replicas of a serving
fleet on one card): one restarts, warms up and captures while another
replays. The capture itself (``capture_begin`` to ``capture_end``) and a
replay never overlap: PyTorch refuses a replay while another thread's
capture is underway ("Cannot prepare for replay during capturing stage",
on the H100 with torch 2.11), so one lock orders every capture and every
replay of the process. A replay holds it for the few microseconds of its
launch, a capture for ``torch.cuda.graph``'s device synchronisation and
cache release, its own launches and instantiation; the eager warm-up runs
outside it. (The cache release must stay: a capture's private pool cannot
take the blocks another pool has cached, and skipping it left the
universe's 64-window bucket short of memory on the card.)
Importing this module touches no CUDA state.
"""

from __future__ import annotations

import contextlib
import gc
import threading
from typing import Callable, Sequence

import torch

from masters_thesis_tpu_torch.ops import lstm_kernel as lk
from masters_thesis_tpu_torch.parallel.mesh import COLLECTIVES


class CaptureError(RuntimeError):
    """A CUDA graph capture failed; nothing was run in its place."""


#: Orders every capture and every replay of the process (module docstring).
_GRAPH_LOCK = threading.Lock()
_COLLECTOR_LOCK = threading.Lock()
#: Captures underway, and whether the collector was on before the first.
_COLLECTOR = {"holds": 0, "was_enabled": False}


@contextlib.contextmanager
def collector_paused():
    """Python's cyclic collector off while the block runs, counted across
    threads: the first block to enter turns it off, the last to leave
    turns it back on if it was on before the first."""
    with _COLLECTOR_LOCK:
        if _COLLECTOR["holds"] == 0:
            _COLLECTOR["was_enabled"] = gc.isenabled()
            gc.disable()
        _COLLECTOR["holds"] += 1
    try:
        yield
    finally:
        with _COLLECTOR_LOCK:
            _COLLECTOR["holds"] -= 1
            if _COLLECTOR["holds"] == 0 and _COLLECTOR["was_enabled"]:
                gc.enable()


class GraphedCall:
    """``body`` as one replayed CUDA graph on ``device``.

    ``generator`` is a CUDA generator ``body`` draws from, or a sequence
    of them (a stacked step's, one a replica): the graph registers each
    one's state, so each replay draws from where every generator stands,
    as an eager call would, and advances each as far.
    ``capture_error_mode`` is ``torch.cuda.graph``'s: "global" also
    refuses unsafe CUDA calls from other threads (the autograd engine's
    included), "thread_local" only from the capturing thread (for a server
    whose other threads keep running).
    """

    def __init__(self, body: Callable[[], None], *, device, name: str,
                 generator: torch.Generator | Sequence[torch.Generator]
                 | None = None,
                 capture_error_mode: str = "global"):
        self.body = body
        self.device = torch.device(device)
        self.name = name
        if generator is None:
            self.generators: tuple = ()
        elif isinstance(generator, torch.Generator):
            self.generators = (generator,)
        else:
            self.generators = tuple(generator)
        self.capture_error_mode = capture_error_mode
        self.graph = None
        #: Kernel launches in one run of ``body`` (the capture's counts).
        self.launches: dict[str, int] = {}
        #: Collectives in one run of ``body``.
        self.collectives: dict[str, int] = {}
        #: Captures made (run telemetry counts them as compiles).
        self.captures = 0
        #: Replays made.
        self.replays = 0

    @property
    def captured(self) -> bool:
        return self.graph is not None

    def __call__(self) -> None:
        if self.graph is None:
            self.capture()
        else:
            with _GRAPH_LOCK:
                self.graph.replay()  # mtt: disable=CL503 -- one lock orders every capture and replay of the process: PyTorch refuses a replay during another thread's capture (module docstring)
            self.replays += 1
            lk.LAUNCHES.add(self.launches)
            COLLECTIVES.add(self.collectives)

    def release(self) -> None:
        """Free the graph and its memory pool now, under the lock that
        orders captures and replays, so never inside a capture; the next
        call captures afresh."""
        with _GRAPH_LOCK:
            graph, self.graph = self.graph, None
            if graph is not None:
                graph.reset()

    def capture(self) -> None:
        """The warm-up run of ``body`` (real, counted), then its capture
        (nothing runs; its counts are the graph's own)."""
        stream = self._warm_up()
        self.captures += 1
        every_thread = self.capture_error_mode == "global"
        with lk.LAUNCHES.diverted(every_thread) as launches, \
                COLLECTIVES.diverted(every_thread) as collectives:
            try:
                self.graph = self._record(stream)
            except Exception as err:
                raise CaptureError(
                    f"capturing {self.name} failed: {err}") from err
        self.launches = {k: n for k, n in launches.items() if n}
        self.collectives = {k: n for k, n in collectives.items() if n}

    def _warm_up(self):
        """Run ``body`` on a side stream, the one the capture then uses, so
        that per-stream state (cuBLAS workspaces) exists before it."""
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            self.body()
        torch.cuda.current_stream(self.device).wait_stream(stream)
        return stream

    def _record(self, stream):
        failed = []
        # The cyclic collector stays off during the capture. A program and
        # its GraphedCall refer to each other, so a dead program's graph is
        # freed by the collector, whenever it runs; destroying a graph inside
        # a capture invalidates the capture.
        with _GRAPH_LOCK:
            graph = torch.cuda.CUDAGraph()
            for generator in self.generators:
                graph.register_generator_state(generator)
            try:
                with collector_paused(), \
                        lk.capturing(stream, self.capture_error_mode), \
                        torch.cuda.graph(  # mtt: disable=CL503 -- one lock orders every capture and replay of the process: PyTorch refuses a replay during another thread's capture (module docstring)
                            graph, stream=stream,
                            capture_error_mode=self.capture_error_mode):
                    try:
                        self.body()
                    except Exception as err:
                        failed.append(err)
                        raise
            except Exception:
                # An error inside the capture makes its end fail too; the
                # first error is the one that says why.
                if failed:
                    raise failed[0] from None
                raise
        return graph
