"""The serving program cache, in the process: a restarted engine replays the
graphs a closed engine gave back instead of capturing its buckets again.

Counterpart of ``masters_thesis_tpu/serve/program_cache.py``, with the JAX
API's names (``ProgramCache``, ``entry_key``, ``param_signature``, the
counters ``hits``, ``misses``, ``stores``, ``rejections``, the ``events``
list, ``stats()``, and the telemetry events ``cache_hit``, ``cache_miss``,
``cache_store`` and ``cache_rejected``). The JAX cache writes serialized
executables to disk; a CUDA graph cannot be written to disk, so here an
entry lives in the process: one bucket's program (its graph, its static
buffers) and the module whose parameter tensors that graph reads.

- **Keyed on identity.** ``entry_key`` is a sha256 over the model spec, the
  parameters' signature, the window shape, the bucket, whether the program
  is a graph, the lane digests of a stacked engine and the device's
  ``backend_fingerprint`` (torch, CUDA, the device's index, name and
  capability, the kernel libraries' digest): whatever could change the
  program changes the key.
- **Checked out, never shared.** An entry is in the cache only while no
  engine holds it. An engine gives its programs back in its ``close()``
  (one :class:`ProgramSet`: its module and one entry a bucket) and a
  booting engine takes one set out whole (:meth:`ProgramCache.checkout`,
  the set that holds most of its buckets), so two live engines never
  replay one graph or read one module's tensors. Weights enter a taken
  module only by an in-place ``copy_`` (the graphs read those tensors).
- **Verified, not trusted.** At ``close`` each entry keeps a golden input
  (the JAX seed rule), the weights it ran on and the answers its graph gave.
  :meth:`ProgramCache.load` has the booting engine copy the golden weights
  in and replay the golden input, and requires the stored answers bit for
  bit; only then does the engine copy its own weights in.
- **Refusals.** ``stale`` (the entry's fingerprint is not the booting
  engine's), ``golden_failed`` (the golden replay raised) and
  ``golden_mismatch`` (its answers are not the stored ones). Each emits
  ``cache_rejected`` and frees the entry's graph (under the lock that
  orders captures and replays, so never inside a capture); the engine then
  captures that bucket afresh. JAX's ``torn`` (a damaged file) has no
  counterpart: nothing is written. The fault point ``cache.load`` (context
  ``key``), kind ``corrupt``, flips the sign of one element of the entry's
  stored weights before the verification, so that the real refusal runs.

There is no capacity knob: the cache holds only what engines gave back, so
it never holds more graph memory than they held. :meth:`ProgramCache.close`
frees every entry. Importing this module imports no torch.
"""

from __future__ import annotations

import hashlib
import json
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable

import numpy as np

from masters_thesis_tpu_torch.resilience import faults

#: Bump when the key recipe changes.
CACHE_SCHEMA = 1


def param_signature(state_dict) -> list:
    """``[key, shape, dtype]`` of each tensor of a state dict, in key order:
    the parameters' part of a program's identity."""
    return [[k, list(v.shape), str(v.dtype)]
            for k, v in sorted(state_dict.items())]


def release_program(program) -> None:
    """Free a bucket program's graph now (outside any capture), if it has
    one."""
    release = getattr(program.run, "release", None)
    if release is not None:
        release()


def entry_key(ident: dict) -> str:
    """sha256 over the canonical JSON of a program's whole identity."""
    canon = json.dumps({"schema": CACHE_SCHEMA, **ident}, sort_keys=True,
                       default=str)
    return hashlib.sha256(canon.encode()).hexdigest()[:24]


@dataclass
class CacheEntry:
    """One bucket's program as an engine gave it back. ``golden``: the
    golden input ``x`` (numpy), the weights it ran on (``state``, tensors
    by state-dict key) and the answers (``alpha``, ``beta``, numpy)."""

    program: Any
    fingerprint: dict
    golden: dict

    def release(self) -> None:
        release_program(self.program)


@dataclass
class ProgramSet:
    """One module and the entries whose graphs read its tensors."""

    module: Any
    entries: dict[str, CacheEntry] = field(default_factory=dict)


class ProgramCache:
    """The programs closed engines gave back, shared by the engines of a
    process (the replicas of a fleet). Counters and ``events`` make every
    decision auditable without telemetry; with ``telemetry`` each decision
    is an event too."""

    def __init__(self, telemetry=None):
        self.telemetry = telemetry
        self.hits = 0
        self.misses = 0
        self.stores = 0
        self.rejections = 0
        self.events: list[dict] = []
        self._sets: list[ProgramSet] = []
        self._lock = threading.Lock()

    def _event(self, kind: str, **payload) -> None:
        with self._lock:
            self.events.append({"kind": kind, **payload})
        if self.telemetry is not None:
            try:
                self.telemetry.event(kind, **payload)
            except Exception:  # noqa: BLE001 — accounting never costs serving
                pass

    def _count(self, name: str) -> None:
        with self._lock:
            setattr(self, name, getattr(self, name) + 1)

    def __len__(self) -> int:
        with self._lock:
            return sum(len(s.entries) for s in self._sets)

    # ------------------------------------------------------------ check-out

    def checkout(self, keys: Iterable[str]) -> ProgramSet | None:
        """Take out, whole, the set that holds most of ``keys`` (the
        earliest given back on a tie); None when none holds any. The
        caller owns it from now on: it ``load``s each key and gives every
        entry it keeps back in ``store``."""
        keys = set(keys)
        with self._lock:
            best = max(self._sets, default=None,
                       key=lambda s: len(keys & s.entries.keys()))
            if best is None or not keys & best.entries.keys():
                return None
            self._sets.remove(best)
            return best

    def load(self, programs: ProgramSet | None, key: str, *,
             fingerprint: dict,
             run_golden: Callable[[CacheEntry], tuple]):
        """The program of ``key`` from a checked-out set, verified, or None
        (a miss or a refusal: the caller captures afresh). ``run_golden``
        copies the entry's golden weights into the set's module, replays
        its golden input and returns the host ``(alpha, beta)``."""
        entry = (programs.entries.pop(key, None)
                 if programs is not None else None)
        if entry is None:
            self._count("misses")
            self._event("cache_miss", key=key)
            return None
        if faults.fire("cache.load", key=key) == "corrupt":
            entry.golden = {**entry.golden, "state": _corrupted(
                entry.golden["state"], faults.corruption_seed())}
        if entry.fingerprint != fingerprint:
            self._reject(entry, key, "stale",
                         "entry fingerprint does not match the booting "
                         f"engine's (entry: {entry.fingerprint!r})")
            return None
        try:
            alpha, beta = run_golden(entry)
        except Exception as exc:  # noqa: BLE001 — any failure refuses
            self._reject(entry, key, "golden_failed",
                         f"{type(exc).__name__}: {exc}")
            return None
        if not (np.array_equal(alpha, entry.golden["alpha"])
                and np.array_equal(beta, entry.golden["beta"])):
            self._reject(entry, key, "golden_mismatch",
                         "the program does not reproduce its stored golden "
                         "answers bit for bit")
            return None
        self._count("hits")
        self._event("cache_hit", key=key)
        return entry.program

    def _reject(self, entry: CacheEntry, key: str, reason: str,
                detail: str) -> None:
        self._count("rejections")
        self._event("cache_rejected", key=key, reason=reason, detail=detail)
        entry.release()

    # ---------------------------------------------------------------- store

    def store(self, programs: ProgramSet) -> None:
        """Give a closed engine's programs back (one set)."""
        if not programs.entries:
            return
        with self._lock:
            self._sets.append(programs)
        for key in programs.entries:
            self._count("stores")
            self._event("cache_store", key=key)

    def put_back(self, programs: ProgramSet) -> None:
        """Return what is left of a checked-out set that its engine did not
        take (nothing of it verified); counted as no store."""
        if programs.entries:
            with self._lock:
                self._sets.append(programs)

    def close(self) -> None:
        """Free every entry."""
        with self._lock:
            sets, self._sets = self._sets, []
        for programs in sets:
            for entry in programs.entries.values():
                entry.release()

    def stats(self) -> dict:
        with self._lock:
            return {"entries": sum(len(s.entries) for s in self._sets),
                    "sets": len(self._sets), "hits": self.hits,
                    "misses": self.misses, "stores": self.stores,
                    "rejections": self.rejections}


def _corrupted(state: dict, seed: int) -> dict:
    """``state`` with the sign of one element of its largest tensor flipped
    (1.0 where it is 0), in a copy: entries of one close share their golden
    weights (the ``cache.load`` fault)."""
    name = max(sorted(state), key=lambda k: state[k].numel())
    state = {**state, name: state[name].clone()}
    flat = state[name].view(-1)
    i = seed % flat.numel()
    flat[i] = -flat[i] if float(flat[i]) != 0.0 else 1.0
    return state
