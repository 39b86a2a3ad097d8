"""Host-to-device prefetching for batch iterators.

Counterpart of ``masters_thesis_tpu/data/prefetch.py``: batches are put on
the device ``size`` steps ahead of the step that reads them, so the copy of
batch k+1 overlaps the device's work on batch k. On the card each batch is
staged in pinned host memory and copied with ``non_blocking=True`` on a
copy stream of its own; the consuming stream waits on an event recorded
after the copy before it reads the batch. A batch's buffers are never
written twice: each batch gets fresh ones from PyTorch's caching
allocators, which keep a pinned block until the copy that reads it has
finished (the event a non-blocking copy records), and a device block until
the consuming stream's work queued before its release has finished
(``record_stream``).

:class:`PrefetchStats` makes input starvation observable: the generator is
synchronous, so the host time inside ``next(source)`` and the copy's
dispatch is time that did not overlap the device's work. Batches of the
window store (``data/window_store.py``) may hold ``np.memmap`` views, whose
reads happen as page faults when their bytes are first touched; the
prefetcher copies each such view into memory on the producer side, timed
(``fault_wait_s``, a part of ``get_wait_s``) and counted (``mmap_bytes``),
before it stages the batch. A batch gathered across the store's windows is
a fresh array already (its page-in falls in ``take``, inside
``get_wait_s``), so it counts in neither.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Iterable, Iterator

import numpy as np
import torch

from masters_thesis_tpu_torch import resolve_device


@dataclasses.dataclass
class PrefetchStats:
    """Counters a prefetch iterator updates in place (host side only)."""

    gets: int = 0            # items pulled from the source iterator
    yields: int = 0          # items handed to the consumer
    get_wait_s: float = 0.0  # host time producing and dispatching items
    depth_sum: int = 0       # queue depth observed at each yield
    min_depth: int | None = None
    exhausted: bool = False  # the source ran dry (the end of every epoch)
    fault_wait_s: float = 0.0  # host time paging memmap views in
    mmap_bytes: int = 0  # bytes of the memmap views paged in

    def observe_depth(self, depth: int) -> None:
        self.yields += 1
        self.depth_sum += depth
        self.min_depth = (depth if self.min_depth is None
                          else min(self.min_depth, depth))

    @property
    def mean_depth(self) -> float:
        return self.depth_sum / self.yields if self.yields else 0.0

    def snapshot(self) -> dict:
        return {
            "gets": self.gets,
            "yields": self.yields,
            "get_wait_s": self.get_wait_s,
            "mean_depth": self.mean_depth,
            "min_depth": self.min_depth,
            "exhausted": self.exhausted,
            "fault_wait_s": self.fault_wait_s,
            "mmap_bytes": self.mmap_bytes,
        }


def _map(item, fn):
    """``fn`` on every array of a (named) tuple or list nest."""
    if isinstance(item, tuple) and hasattr(item, "_fields"):
        return type(item)(*(_map(v, fn) for v in item))
    if isinstance(item, (tuple, list)):
        return type(item)(_map(v, fn) for v in item)
    return fn(item)


def _materialize_mmap(item, stats: PrefetchStats | None):
    """``item`` with each ``np.memmap`` leaf copied into memory, the copy
    timed into ``stats.fault_wait_s`` and its bytes into
    ``stats.mmap_bytes``; other leaves untouched. (``np.ascontiguousarray``,
    which the JAX prefetcher calls here, returns a contiguous memmap's
    pages as a view without reading them; the copy reads them.)"""
    def force(leaf):
        if not isinstance(leaf, np.memmap):
            return leaf
        t0 = time.perf_counter()
        out = np.array(leaf, order="C", copy=True)
        if stats is not None:
            stats.fault_wait_s += time.perf_counter() - t0
            stats.mmap_bytes += int(leaf.nbytes)
        return out

    return _map(item, force)


def prefetch_to_device(iterator: Iterable[Any], size: int = 2, device=None,
                       stats: PrefetchStats | None = None) -> Iterator[Any]:
    """Yield the items of ``iterator`` (nests of tuples of numpy arrays) as
    tensors on ``device`` (the card unless told otherwise), ``size`` items
    already dispatched; ``size=0`` puts each item then yields it.

    On the card the copy runs on its own stream, and each yielded item's
    tensors may be read on the stream current at the ``next()`` that
    yields it, which has been made to wait for the copy. ``stats`` is
    updated in place.
    """
    if size < 0:
        raise ValueError(f"prefetch size must be >= 0, got {size}")
    device = resolve_device(device)
    on_card = device.type == "cuda"
    copy_stream = torch.cuda.Stream(device) if on_card else None

    def host(a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a))

    def put(item):
        if not on_card:
            return _map(item, host), None
        with torch.cuda.stream(copy_stream):
            out = _map(item, lambda a: host(a).pin_memory().to(
                device, non_blocking=True))
            ready = torch.cuda.Event()
            ready.record(copy_stream)
        return out, ready

    def take(entry):
        out, ready = entry
        if ready is not None:
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(ready)
            _map(out, lambda t: t.record_stream(consumer))
        return out

    queue: collections.deque = collections.deque()
    it = iter(iterator)

    def pull() -> bool:
        """Produce and dispatch one item; False once the source is dry."""
        t0 = time.perf_counter()
        try:
            item = next(it)
        except StopIteration:
            if stats is not None:
                stats.get_wait_s += time.perf_counter() - t0
                stats.exhausted = True
            return False
        queue.append(put(_materialize_mmap(item, stats)))
        if stats is not None:
            stats.get_wait_s += time.perf_counter() - t0
            stats.gets += 1
        return True

    if size == 0:
        while pull():
            if stats is not None:
                stats.observe_depth(len(queue))
            yield take(queue.popleft())
        return

    for _ in range(size):
        if not pull():
            break
    while queue:
        if stats is not None:
            stats.observe_depth(len(queue))
        yield take(queue.popleft())
        pull()
