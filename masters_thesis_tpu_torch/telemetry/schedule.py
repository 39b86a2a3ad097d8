"""Each rank's collective-schedule hash chain and the cross-rank audit.

Counterpart of ``masters_thesis_tpu/telemetry/schedule.py``, kept byte for
byte in what it hashes (the canonical entry, the ``mtt.schedule.v1`` seed),
so one schedule gives one chain in both packages.

A data-parallel fleet that loses a rank seldom crashes whole: the ranks
left block in their next collective until a watchdog condemns the
generation, and nothing they leave says which rank took another path, or
where. Every host-level collective of the port (``fleet_barrier`` in
``parallel/mesh.py``, the epoch's gradient all-reduce in
``train/trainer.py``) records a canonical entry ``(kind, name, dtype,
shape, axes, step)``, chained into a rolling sha256: two ranks that issued
the same schedule hold equal chains, and the first entry that differs is
found by comparing the per-entry hashes. The chain rides the flight
recorder's ``heartbeat.json`` and ``crashdump.json``: the heartbeat thread
goes on publishing it while the main thread is stuck in a collective, which
is when the audit needs it.

Stdlib only: ``telemetry aggregate`` and ``postmortem`` read it where no
torch may be imported.
"""

from __future__ import annotations

import hashlib
import json
import threading
from collections import deque
from pathlib import Path
from typing import Any

#: Entries kept verbatim (beyond the rolling hash) for the postmortem
#: report — enough tail to show both schedules around the fork point.
TAIL_KEEP = 64


class CollectiveSchedule:
    """Thread-safe rolling hash chain of collective-schedule entries."""

    def __init__(self, keep: int = TAIL_KEEP):
        self._lock = threading.Lock()
        self._keep = keep
        self._n = 0
        self._hash = hashlib.sha256(b"mtt.schedule.v1").hexdigest()
        self._tail: deque[dict[str, Any]] = deque(maxlen=keep)

    def record(
        self,
        kind: str,
        *,
        name: str | None = None,
        dtype: str | None = None,
        shape: tuple | list | None = None,
        axes: tuple | list | None = None,
        step: int | None = None,
    ) -> str:
        """Append one collective entry; returns the chain hash after it.

        The entry is canonicalised (sorted-key JSON) before hashing so
        two ranks that issued the same collective produce byte-equal
        chain links regardless of call-site kwarg order.
        """
        entry = {
            "kind": kind,
            "name": name,
            "dtype": dtype,
            "shape": list(shape) if shape is not None else None,
            "axes": list(axes) if axes is not None else None,
            "step": step,
        }
        canon = json.dumps(entry, sort_keys=True, separators=(",", ":"))
        with self._lock:
            self._hash = hashlib.sha256(
                (self._hash + canon).encode()
            ).hexdigest()
            entry["i"] = self._n
            entry["h"] = self._hash
            self._tail.append(entry)
            self._n += 1
            return self._hash

    def snapshot(self) -> dict[str, Any]:
        """Publishable view: entry count, chain head, and recent tail."""
        with self._lock:
            return {
                "n": self._n,
                "chain": self._hash,
                "tail": [dict(e) for e in self._tail],
            }

    def reset(self) -> None:
        """Restart the chain (tests / a fresh fleet generation)."""
        with self._lock:
            self._n = 0
            self._hash = hashlib.sha256(b"mtt.schedule.v1").hexdigest()
            self._tail.clear()


#: Process-wide chain: mesh.fleet_barrier and the trainer epoch loop
#: record here; the flight recorder snapshots it into every heartbeat.
GLOBAL_SCHEDULE = CollectiveSchedule()


def record_collective(kind: str, **fields) -> str:
    """Record one entry on the process-wide chain (see GLOBAL_SCHEDULE)."""
    return GLOBAL_SCHEDULE.record(kind, **fields)


def _entry_desc(entry: dict) -> str:
    bits = [str(entry.get("kind"))]
    for key in ("name", "dtype", "shape", "axes", "step"):
        val = entry.get(key)
        if val is not None:
            bits.append(f"{key}={val}")
    return " ".join(bits)


def audit_schedules(snaps: dict[str, dict | None]) -> dict[str, Any]:
    """Bitwise cross-check of per-rank schedule snapshots.

    ``snaps`` maps a rank label (``"p0"``) to a ``snapshot()`` dict (or
    None when that rank published nothing). Returns a verdict dict::

        {"ok": bool, "verdict": "match"|"insufficient"|"lagging"|
                                "diverged",
         "ranks": {label: {"n":, "chain":}},
         # on divergence:
         "divergent_rank":, "step":, "index":, "schedules": {label: ...},
         "detail": "<one-line human diagnosis>"}

    - every (n, chain) equal → ``match``.
    - chains agree over the shared prefix but lengths differ →
      ``lagging``: a rank stopped issuing collectives (wedged or dead)
      while peers ran ahead; names the laggard and the first entry it is
      missing. Still ``ok`` — lag is a liveness symptom, not a schedule
      contradiction (the hang watchdog owns liveness).
    - a per-entry chain hash differs at some shared index →
      ``diverged``: names the first divergent index, the minority rank,
      the step recorded there, and both schedules' tails. Never ``ok``.
    """
    usable = {k: v for k, v in snaps.items() if v and v.get("n", 0) > 0}
    ranks = {
        k: {"n": v["n"], "chain": v["chain"]} for k, v in usable.items()
    }
    if len(usable) < 2:
        return {"ok": True, "verdict": "insufficient", "ranks": ranks}

    chains = {(v["n"], v["chain"]) for v in usable.values()}
    if len(chains) == 1:
        return {"ok": True, "verdict": "match", "ranks": ranks}

    # Index the retained tails by entry position: tails are bounded, so
    # the fork is only locatable when it falls inside every rank's
    # retained window — otherwise fall back to the lagging/short check.
    by_index: dict[int, dict[str, dict]] = {}
    for label, snap in usable.items():
        for entry in snap.get("tail", ()):
            by_index.setdefault(entry["i"], {})[label] = entry

    for idx in sorted(by_index):
        at = by_index[idx]
        if len(at) < 2:
            continue
        hashes = {e["h"] for e in at.values()}
        if len(hashes) == 1:
            continue
        # First divergent entry. The minority hash names the diverging
        # rank; on a 50/50 split (the 2-rank case), the side with FEWER
        # total entries diverged — it skipped a collective the other
        # side issued. Lowest label breaks any remaining tie.
        votes: dict[str, list[str]] = {}
        for label, entry in at.items():
            votes.setdefault(entry["h"], []).append(label)
        minority = min(
            votes.values(),
            key=lambda ls: (
                len(ls),
                min(usable[la]["n"] for la in ls),
                sorted(ls),
            ),
        )
        divergent = sorted(minority)[0]
        step = at[divergent].get("step")
        schedules = {
            label: [_entry_desc(e) for e in usable[label].get("tail", ())]
            for label in sorted(at)
        }
        detail = (
            f"collective schedules diverge at entry {idx}: rank "
            f"{divergent} issued [{_entry_desc(at[divergent])}] "
            f"(step={step}), peers issued "
            + "; ".join(
                f"{label} [{_entry_desc(e)}]"
                for label, e in sorted(at.items())
                if label != divergent
            )
        )
        return {
            "ok": False,
            "verdict": "diverged",
            "ranks": ranks,
            "divergent_rank": divergent,
            "step": step,
            "index": idx,
            "schedules": schedules,
            "detail": detail,
        }

    # No contradicting entry in the shared windows: a rank is simply
    # behind (fewer entries, same prefix) — wedged or killed mid-run.
    laggard = min(usable, key=lambda k: (usable[k]["n"], k))
    leader = max(usable, key=lambda k: (usable[k]["n"], k))
    missing = [
        _entry_desc(e)
        for e in usable[leader].get("tail", ())
        if e["i"] >= usable[laggard]["n"]
    ]
    detail = (
        f"rank {laggard} stopped at {usable[laggard]['n']} collectives "
        f"while {leader} reached {usable[leader]['n']}; first missing: "
        + (missing[0] if missing else "<outside retained tail>")
    )
    return {
        "ok": True,
        "verdict": "lagging",
        "ranks": ranks,
        "laggard": laggard,
        "leader": leader,
        "missing": missing,
        "detail": detail,
    }


def read_rank_schedules(gen_dir: str | Path) -> dict[str, dict | None]:
    """Collect per-rank schedule snapshots under a generation directory.

    Scans ``<gen_dir>/p<rank>/`` for the flight-recorder sidecars
    (heartbeat.json, crashdump.json) and any ``collective_schedule``
    events in the stream, keeping whichever snapshot saw the most
    entries — a crashdump taken after the last heartbeat is the fresher
    record. Purely best-effort: unreadable files yield None for that
    rank rather than raising (this runs on the postmortem path).
    """
    gen_dir = Path(gen_dir)
    out: dict[str, dict | None] = {}
    for rank_dir in sorted(gen_dir.glob("p*")):
        if not rank_dir.is_dir():
            continue
        best: dict | None = None
        for name in ("heartbeat.json", "crashdump.json"):
            for path in sorted(rank_dir.rglob(name)):
                try:
                    doc = json.loads(path.read_text())
                except (OSError, ValueError):
                    continue
                snap = doc.get("collective_schedule")
                if snap and snap.get("n", 0) > (best or {}).get("n", -1):
                    best = snap
        for path in sorted(rank_dir.rglob("events.jsonl")):
            try:
                lines = path.read_text().splitlines()
            except OSError:
                continue
            for line in lines:
                try:
                    ev = json.loads(line)
                except ValueError:
                    continue
                if ev.get("kind") != "collective_schedule":
                    continue
                snap = {
                    "n": ev.get("n"),
                    "chain": ev.get("chain"),
                    "tail": ev.get("tail") or [],
                }
                if snap["n"] and snap["n"] > (best or {}).get("n", -1):
                    best = snap
        out[rank_dir.name] = best
    return out
