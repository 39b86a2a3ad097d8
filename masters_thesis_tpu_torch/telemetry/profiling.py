"""Profiler capture windows over epochs: ``torch.profiler`` in place of
``jax.profiler``.

Counterpart of ``masters_thesis_tpu/telemetry/profiling.py``.
``ProfilerWindow((N, M), trace_dir)`` traces epochs N..M (inclusive) into
``trace_dir``: the trainer starts the trace before it queues epoch N and
stops it after epoch M's read of its sums, behind one synchronisation
(``fence``), so the trace ends at an epoch boundary. It takes the host's
activity and, where the trainer runs on the card, the card's (CUDA
kernels, copies), and writes one Chrome-trace JSON file
(``trace_epochs_N_M.json``) under ``trace_dir``; a ``profile_window``
event with the JAX payload (``start_epoch``, ``end_epoch``,
``trace_dir``) says where. A window of ``None`` is a no-op, so the
trainer's loop carries no conditionals.

torch.profiler is imported when a window starts: constructing one (from
config parsing) touches nothing.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable


class ProfilerWindow:
    def __init__(self, window: tuple[int, int] | None,
                 trace_dir: str | Path, telemetry=None, cuda: bool = False):
        if window is not None:
            start, end = int(window[0]), int(window[1])
            if start < 0 or end < start:
                raise ValueError(
                    f"profile window must be 0 <= start <= end, got {window!r}")
            window = (start, end)
        self.window = window
        self.trace_dir = Path(trace_dir)
        self.telemetry = telemetry
        #: Trace the card's activity too (the trainer runs on CUDA).
        self.cuda = cuda
        self.active = False
        self._prof = None
        #: The trace file the window wrote (None until it stops).
        self.trace_path: Path | None = None

    def maybe_start(self, epoch: int) -> None:
        if self.window is None or self.active or epoch != self.window[0]:
            return
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.cuda:
            activities.append(ProfilerActivity.CUDA)
        self.trace_dir.mkdir(parents=True, exist_ok=True)
        self._prof = profile(activities=activities)
        self._prof.__enter__()
        self.active = True

    def maybe_stop(self, epoch: int, fence: Callable[[], None]) -> None:
        if not self.active or epoch < self.window[1]:
            return
        self._stop(fence)

    def close(self, fence: Callable[[], None]) -> None:
        """Stop a trace still open (a divergence halt inside the window)
        so that what it caught is written, not lost."""
        if self.active:
            self._stop(fence)

    def _stop(self, fence: Callable[[], None]) -> None:
        fence()
        prof, self._prof = self._prof, None
        self.active = False
        prof.__exit__(None, None, None)
        self.trace_path = (self.trace_dir / f"trace_epochs_{self.window[0]}"
                           f"_{self.window[1]}.json")
        prof.export_chrome_trace(str(self.trace_path))
        if self.telemetry is not None:
            self.telemetry.event(
                "profile_window",
                start_epoch=self.window[0],
                end_epoch=self.window[1],
                trace_dir=str(self.trace_dir),
            )
