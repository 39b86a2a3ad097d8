"""Deterministic fault injection: the port's copy of the fault plan.

Counterpart of ``masters_thesis_tpu/resilience/faults.py`` (stdlib only,
like it), with the same plan format, so one ``MTT_FAULT_PLAN`` drives
either package. A :class:`FaultPlan` is a seeded list of
:class:`FaultSpec` entries, each naming a *fault point* (a host-side call
site instrumented with :func:`fire`), a fault *kind* and match conditions.
A plan is active only when asked for: through the ``MTT_FAULT_PLAN``
environment variable (JSON, or ``@/path/to/plan.json``) or
:func:`install_plan` in-process. With no plan a fault point costs one
dict lookup.

Kinds: ``preempt`` (SIGTERM self), ``kill`` (SIGKILL self), ``hang``
(sleep forever) and ``raise`` (:class:`FaultInjected`) act inside
:func:`fire`; ``wedge``, ``corrupt``, ``nan`` and ``shift`` are returned
to the call site, which applies them. A spec fires when its ``point``
matches, the current attempt (``MTT_ATTEMPT``, default 1) equals its
``attempt`` (``null`` = any) and every ``match`` key equals the value
``fire(**ctx)`` was given.

The port fires these points: ``checkpoint.pre_publish``,
``checkpoint.mid_publish`` and ``checkpoint.post_publish`` (``corrupt``)
in ``train/checkpoint.py``, with the context ``tag`` (as the JAX package)
and ``epoch`` (the save's, so that a plan can pick one save);
``trainer.epoch_dispatched`` and ``trainer.loss`` (``nan``) in
``train/trainer.py``, with the context ``epoch``; ``stacked.replica_loss``
(``nan``) in ``train/stacked.py``, with the context ``epoch`` and
``replica`` (the replica's index); and, with the JAX
package's context keys, ``serve.admit`` in ``serve/queue.py`` (``rid``,
``depth``; ``wedge`` sheds the request, ``shift`` shifts its window by
:func:`shift_params`), ``serve.dispatch`` in ``serve/server.py`` (``seq``,
``n``; ``wedge`` fails the dispatch, ``nan`` withholds its answers) and
``serve.pre_swap`` in ``serve/swap.py`` (``tag``; ``corrupt`` flips a byte
of the candidate), ``dist.barrier`` in ``parallel/mesh.py``
``fleet_barrier`` (``name``; a ``hang`` wedges the rank inside the
barrier), ``fleet.rank_heartbeat`` in ``resilience/fleetsup.py``, in the
fleet supervisor's own process (``rank``, ``gen``; ``wedge`` makes the hang
watchdog take that rank for hung) and ``worker.epoch`` in the simulated
ranks of ``resilience/__main__.py`` (``epoch``, and ``rank`` in a fleet
worker). The other points are accepted so that a plan written for the JAX
package parses here too; they fire nowhere in the port yet.
"""

from __future__ import annotations

import json
import os
import random
import signal
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Mapping

FAULT_PLAN_ENV = "MTT_FAULT_PLAN"
ATTEMPT_ENV = "MTT_ATTEMPT"

KINDS = frozenset(
    {"preempt", "kill", "hang", "raise", "wedge", "corrupt", "nan", "shift"}
)
#: Kinds fire() executes itself (the process never returns normally).
PROCESS_KINDS = frozenset({"preempt", "kill", "hang", "raise"})
#: Kinds returned to the call site, which applies them itself.
DATA_KINDS = KINDS - PROCESS_KINDS

#: The fault points of the JAX package's plan format (a typo guard at
#: parse time).
POINTS = frozenset(
    {
        "trainer.epoch_start",
        "trainer.epoch_dispatched",  # after the epoch, before readback/save
        "trainer.loss",  # the host's read of the epoch's sums (kind: nan)
        "stacked.replica_loss",
        "data.epoch",
        "checkpoint.pre_publish",  # staged pair complete, not yet live
        # rotation done, staged tree not yet live: a kill here tears the
        # publish at its most exposed point
        "checkpoint.mid_publish",
        "checkpoint.post_publish",  # after publish (kind: corrupt)
        "dist.barrier",
        "fleet.rank_heartbeat",
        "probe.attempt",
        "worker.epoch",
        "serve.admit",
        "serve.dispatch",
        "serve.pre_swap",
        "serve.replica_dispatch",
        "serve.replica_boot",
        "cache.load",
        "slo.evaluate",
    }
)


class FaultInjected(RuntimeError):
    """Raised by ``kind: raise`` faults: a deterministic crashing bug."""


@dataclass(frozen=True)
class FaultSpec:
    point: str
    kind: str
    #: Attempt this spec is scoped to (None = every attempt).
    attempt: int | None = 1
    #: Context equality constraints, e.g. ``{"epoch": 3}``.
    match: Mapping[str, Any] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown fault kind: {self.kind!r} "
                f"(valid kinds: {', '.join(sorted(KINDS))})"
            )
        if self.point not in POINTS:
            raise ValueError(
                f"unknown fault point: {self.point!r} "
                f"(valid points: {', '.join(sorted(POINTS))})"
            )

    def matches(self, point: str, attempt: int, ctx: Mapping[str, Any]) -> bool:
        if point != self.point:
            return False
        if self.attempt is not None and attempt != self.attempt:
            return False
        return all(ctx.get(k) == v for k, v in self.match.items())


@dataclass
class FaultPlan:
    faults: list[FaultSpec]
    seed: int = 0

    @classmethod
    def parse(cls, text: str) -> "FaultPlan":
        """Parse a plan from JSON text or an ``@/path`` file reference."""
        text = text.strip()
        if text.startswith("@"):
            text = Path(text[1:]).read_text()
        raw = json.loads(text)
        if isinstance(raw, list):
            raw = {"faults": raw}
        faults = [FaultSpec(**f) for f in raw.get("faults", [])]
        return cls(faults=faults, seed=int(raw.get("seed", 0)))

    def to_json(self) -> str:
        return json.dumps({
            "seed": self.seed,
            "faults": [{"point": f.point, "kind": f.kind,
                        "attempt": f.attempt, "match": dict(f.match)}
                       for f in self.faults],
        })

    def lookup(self, point: str, attempt: int,
               ctx: Mapping[str, Any]) -> FaultSpec | None:
        for spec in self.faults:
            if spec.matches(point, attempt, ctx):
                return spec
        return None


# In-process override installed by tests; _UNSET means "use the env".
_UNSET = object()
_override: Any = _UNSET
# The parsed env plan, keyed by the env text, so a changed env is re-read.
_env_cache: tuple[str, FaultPlan] | None = None


def install_plan(plan: FaultPlan | None) -> None:
    """Install a plan in-process, taking precedence over ``MTT_FAULT_PLAN``
    (``None`` turns injection off even if the env is set);
    :func:`clear_plan` returns to the environment."""
    global _override
    _override = plan


def clear_plan() -> None:
    global _override
    _override = _UNSET


def active_plan() -> FaultPlan | None:
    global _env_cache
    if _override is not _UNSET:
        return _override
    text = os.environ.get(FAULT_PLAN_ENV)
    if not text:
        return None
    if _env_cache is None or _env_cache[0] != text:
        _env_cache = (text, FaultPlan.parse(text))
    return _env_cache[1]


def current_attempt() -> int:
    try:
        return int(os.environ.get(ATTEMPT_ENV, "1") or 1)
    except ValueError:
        return 1


def fire(point: str, **ctx: Any) -> str | None:
    """Fire the fault armed at ``point`` for the current attempt and
    context, if any.

    The process kinds never return. The data kinds return the kind for the
    call site to apply; with no active plan, or nothing matching, the
    return is ``None``.
    """
    if _override is _UNSET and FAULT_PLAN_ENV not in os.environ:
        return None  # fast path: injection off
    plan = active_plan()
    if plan is None:
        return None
    spec = plan.lookup(point, current_attempt(), ctx)
    if spec is None:
        return None
    print(f"[faults] firing kind={spec.kind} at point={point} "
          f"attempt={current_attempt()} ctx={ctx}", file=sys.stderr,
          flush=True)
    if spec.kind == "preempt":
        os.kill(os.getpid(), signal.SIGTERM)
        # Time for a SIGTERM handler to run; without one the default action
        # has already ended the process.
        deadline = time.monotonic() + 10.0  # mtt: disable=DV704 -- chaos preempt path: the process is being killed, nothing it computes past here reaches a checkpoint
        while time.monotonic() < deadline:  # mtt: disable=DV704 -- same dying-process grace loop; timing here cannot affect resume determinism
            time.sleep(0.1)
        os._exit(143)
    if spec.kind == "kill":
        os.kill(os.getpid(), signal.SIGKILL)
        time.sleep(60)  # unreachable: SIGKILL is not deferred
    if spec.kind == "hang":
        while True:
            time.sleep(1.0)
    if spec.kind == "raise":
        raise FaultInjected(f"injected crash at {point} (ctx={ctx})")
    return spec.kind


def corruption_seed(extra: int = 0) -> int:
    """Deterministic seed for a data-kind corruption at a call site."""
    plan = active_plan()
    return (plan.seed if plan is not None else 0) * 1_000_003 + extra


def shift_params(extra: int = 0) -> tuple[float, float]:
    """Seeded ``(scale, offset)`` for the ``shift`` kind, as the JAX
    package draws them: scale in [1.25, 1.75), offset in [0.25, 0.75)."""
    rng = random.Random(corruption_seed(extra))
    return 1.0 + rng.uniform(0.25, 0.75), rng.uniform(0.25, 0.75)
