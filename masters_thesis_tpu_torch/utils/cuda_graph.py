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
``GraphedCall`` takes the capture's counts back out and adds them again on
every replay; so too for the collectives in ``parallel.mesh.COLLECTIVES``
(a data-parallel step captures its gradient all-reduce). The warm-up run
is what creates an NCCL communicator that is made lazily, at its first
collective: that cannot happen inside a capture.

Nothing falls back: a failed capture raises :class:`CaptureError`, and a
kernel wrapper that finds a capture underway but its own stream not
capturing raises too (``lstm_kernel.capturing``). Python's cyclic garbage
collector is off while a capture runs (it would free dead graphs there).
Importing this module touches no CUDA state.
"""

from __future__ import annotations

import gc
from typing import Callable, Sequence

import torch

from masters_thesis_tpu_torch.ops import lstm_kernel as lk
from masters_thesis_tpu_torch.parallel.mesh import COLLECTIVES

#: The counters a capture takes back and a replay adds again.
COUNTERS = (lk.LAUNCHES, COLLECTIVES)


class CaptureError(RuntimeError):
    """A CUDA graph capture failed; nothing was run in its place."""


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

    @property
    def captured(self) -> bool:
        return self.graph is not None

    def __call__(self) -> None:
        if self.graph is None:
            self.capture()
        else:
            self.graph.replay()
            for counter, counts in zip(COUNTERS, (self.launches,
                                                  self.collectives)):
                for name, n in counts.items():
                    counter[name] += n

    def capture(self) -> None:
        """The warm-up run of ``body`` (real, counted), then its capture
        (nothing runs, nothing is counted)."""
        stream = self._warm_up()
        self.captures += 1
        before = [dict(counter) for counter in COUNTERS]
        try:
            self.graph = self._record(stream)
        except Exception as err:
            raise CaptureError(f"capturing {self.name} failed: {err}") from err
        finally:
            deltas = []
            for counter, old in zip(COUNTERS, before):
                deltas.append({k: n for k in old
                               if (n := counter[k] - old[k])})
                counter.update(old)
        self.launches, self.collectives = deltas

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
        graph = torch.cuda.CUDAGraph()
        for generator in self.generators:
            graph.register_generator_state(generator)
        failed = []
        # The cyclic collector stays off during the capture. A program and
        # its GraphedCall refer to each other, so a dead program's graph is
        # freed by the collector, whenever it runs; destroying a graph inside
        # a capture invalidates the capture.
        collecting = gc.isenabled()
        gc.disable()
        try:
            with lk.capturing(stream), torch.cuda.graph(
                    graph, stream=stream,
                    capture_error_mode=self.capture_error_mode):
                try:
                    self.body()
                except Exception as err:
                    failed.append(err)
                    raise
        except Exception:
            # An error inside the capture makes its end fail too; the first
            # error is the one that says why.
            if failed:
                raise failed[0] from None
            raise
        finally:
            if collecting:
                gc.enable()
        return graph
