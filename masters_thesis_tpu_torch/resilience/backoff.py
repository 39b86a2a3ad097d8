"""Decorrelated-jitter backoff, shared by every restart loop.

A fixed exponential schedule synchronizes restarts: when one failure
takes down N processes (a dead host kills the whole data-parallel fleet),
every survivor computes the same delay and they all reconnect to the
coordinator in the same instant — the classic thundering herd. The fix is
the AWS "decorrelated jitter" schedule::

    delay_0 = base
    delay_k = min(cap, uniform(base, delay_{k-1} * factor))

which keeps the exponential *envelope* (the upper bound still grows by
``factor`` per retry, capped) while spreading actual delays uniformly
below it, so independent restart loops decorrelate after one step.

``factor <= 1.0`` degrades to a constant ``base`` delay — exactly the
deterministic schedule the fast selfcheck/test configs rely on
(``uniform(base, base) == base``), so determinism is a configuration,
not a special case.

A copy of ``masters_thesis_tpu/resilience/backoff.py``: one seed gives
the same delays in both packages. Stdlib only; used by
:class:`~masters_thesis_tpu_torch.resilience.supervisor.RunSupervisor`.
"""

from __future__ import annotations

import random


class DecorrelatedBackoff:
    """Stateful delay generator: ``next()`` yields the next sleep."""

    def __init__(
        self,
        base_s: float,
        cap_s: float,
        factor: float = 2.0,
        rng: random.Random | None = None,
    ) -> None:
        if base_s < 0 or cap_s < 0:
            raise ValueError("backoff delays must be non-negative")
        self.base_s = float(base_s)
        self.cap_s = float(cap_s)
        self.factor = float(factor)
        self._rng = rng if rng is not None else random.Random()
        self._prev: float | None = None

    def next(self) -> float:
        """The next delay; the first call always returns ``base_s``
        (capped) so a single transient blip retries promptly."""
        if self._prev is None:
            delay = min(self.base_s, self.cap_s)
        else:
            hi = max(self.base_s, self._prev * self.factor)
            delay = min(self.cap_s, self._rng.uniform(self.base_s, hi))
        self._prev = delay
        return delay

    def reset(self) -> None:
        """Forget the chain (a success ends the incident; the next
        failure is a fresh one and starts from ``base_s`` again)."""
        self._prev = None
