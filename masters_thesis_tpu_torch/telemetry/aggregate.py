"""Fleet aggregation: every rank's event stream folded into one view, and
how a data-parallel run ended, rebuilt.

Counterpart of ``masters_thesis_tpu/telemetry/aggregate.py``, with its
report. A fleet leaves one ``events.jsonl`` a rank (and, under the fleet
supervisor, one a rank and generation, ``g<gen>/p<rank>/``), with the
flight recorder's ``heartbeat.json`` and, where a process died with
warning, ``crashdump.json`` beside each. This module folds them into one
fleet report:

- **epoch-time skew** between the ranks over the epochs every stream
  shares, and the **straggler**: the rank whose epochs run longest, and
  its slowdown against the fleet's median;
- **collective wait**: in a data-parallel fleet the fast ranks wait in the
  gradient all-reduce for the slowest, so each rank's wait is the sum over
  shared epochs of (the fleet's longest wall - its own);
- **heartbeat gaps**: how far each rank's last sign of life lags the
  fleet's, the only evidence a SIGKILLed rank leaves;
- **each rank's status**: ``finished``, ``killed`` (a crashdump from a
  signal), ``hung`` (a crashdump from the hang watchdog), ``running``
  (recent activity), ``dead`` (started, never finished, no recent
  activity: the SIGKILL case) or ``superseded`` (a generation the
  supervisor already relaunched past: history, not a live failure);
- **generation stitching**: the attempt chain across relaunches and
  elastic resizes (``fleet_resized``), liveness judged against the LATEST
  generation's world only, on the one trace id the supervisor threads
  through every generation;
- **the schedule audit** (``telemetry/schedule.py``): the ranks'
  collective-schedule chains held against each other.

Stdlib only: ``telemetry aggregate`` and ``postmortem`` import no torch.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

from masters_thesis_tpu_torch.telemetry.events import read_events
from masters_thesis_tpu_torch.telemetry.flightrec import (
    CRASHDUMP_FILENAME,
    HEARTBEAT_FILENAME,
)
from masters_thesis_tpu_torch.telemetry.report import EVENTS_FILENAME
from masters_thesis_tpu_torch.telemetry.schedule import audit_schedules

# A process whose last activity is within this window of "now" is treated
# as still running rather than dead (live-run inspection vs postmortem).
DEFAULT_GRACE_S = 30.0
# A finished straggler is flagged when its shared-epoch wall exceeds the
# fleet median by more than this fraction.
STRAGGLER_SLOWDOWN = 0.10


def discover_streams(root: str | Path) -> list[Path]:
    """Every ``events.jsonl`` under ``root`` (or ``root`` itself if it is
    one), sorted for deterministic process ordering."""
    root = Path(root)
    if root.is_file():
        return [root]
    if (root / EVENTS_FILENAME).is_file():
        # A run dir may hold nested streams too (a rank r > 0 under
        # rank<r>/); take the lot.
        return sorted(root.rglob(EVENTS_FILENAME))
    return sorted(root.rglob(EVENTS_FILENAME))


def _read_json(path: Path) -> dict | None:
    try:
        obj = json.loads(path.read_text())
    except (OSError, json.JSONDecodeError):
        return None
    return obj if isinstance(obj, dict) else None


def digest_stream(path: Path, root: Path) -> dict:
    """Fold one process's stream (+ sidecar heartbeat/crashdump) into the
    per-process digest the fleet report is built from."""
    return digest_events(read_events(path), path, root)


def digest_events(events: list[dict], path: Path, root: Path) -> dict:
    """The digest fold over already-loaded events.

    Split out of :func:`digest_stream` so that a reader holding events
    already (the live console's tail, ``telemetry/watch.py``) shares this
    reconstruction; ``path`` still names the stream's location, since the
    heartbeat and crashdump sidecars lie beside it.
    """
    by_kind: dict[str, list[dict]] = {}
    proc = nproc = None
    host = pid = None
    generation = None
    for ev in events:
        by_kind.setdefault(ev.get("kind", "?"), []).append(ev)
        if proc is None and ev.get("proc") is not None:
            proc = ev["proc"]
        if ev.get("nproc") is not None:
            nproc = max(nproc or 0, ev["nproc"])
        if ev.get("generation") is not None:
            # Fleet-supervised ranks tag every envelope with their
            # generation; a stream that spans relaunches keeps the max.
            generation = max(generation or 0, int(ev["generation"]))
        host = host or ev.get("host")
        pid = pid or ev.get("pid")
    starts = by_kind.get("run_started", [])
    started = bool(starts)
    # Supervisor streams (fleet or single-run) finish at their VERDICT,
    # not at run_finished — without this the postmortem flags the
    # supervisor's own stream as a dead worker.
    role = (
        "supervisor"
        if ("fleet_started" in by_kind or "supervisor_started" in by_kind)
        else "worker"
    )
    fleet_verdict = (by_kind.get("fleet_verdict") or [None])[-1]
    sup_verdict = (by_kind.get("supervisor_verdict") or [None])[-1]
    verdict = fleet_verdict or sup_verdict
    fleet = None
    if "fleet_started" in by_kind:
        gen_starts = by_kind.get("fleet_generation_started", [])
        fleet = {
            "generations": len(gen_starts),
            "last_nprocs": (
                gen_starts[-1].get("nprocs") if gen_starts else None
            ),
            "resizes": [
                {k: ev.get(k) for k in
                 ("gen", "from_nprocs", "to_nprocs", "reason",
                  "fingerprint")}
                for ev in by_kind.get("fleet_resized", [])
            ],
            "verdict": None if fleet_verdict is None else {
                k: fleet_verdict.get(k) for k in
                ("ok", "verdict", "generations", "final_nprocs",
                 "resized", "trace_id")
            },
        }
    # Attempt linking: a supervised run APPENDS each retry to the same
    # stream, so one events.jsonl can hold several attempts — delimited by
    # run_started (trainer streams) or the envelope's attempt tag. The
    # digest folds them into ONE logical run: `finished` reflects the LAST
    # attempt, and a crashdump from a superseded attempt doesn't fail a
    # stream whose final attempt completed.
    attempts = max(
        len(starts),
        len(by_kind.get("attempt_started", [])),
        max((int(ev.get("attempt") or 1) for ev in events), default=0),
    )
    resumed_from = next(
        (s["resumed_from"] for s in reversed(starts) if s.get("resumed_from")),
        None,
    )
    finished = (by_kind.get("run_finished") or [None])[-1]
    last_start = starts[-1] if starts else {}
    # The hot program's static cost model (telemetry/costs.py payload) —
    # the training program when present, else the last profile emitted.
    profiles = by_kind.get("cost_profile", [])
    cost = next(
        (e for e in profiles if str(e.get("program", "")).startswith("train")),
        profiles[-1] if profiles else None,
    )
    epochs = by_kind.get("epoch", [])
    epoch_walls: dict[int, float] = {}
    for e in epochs:
        if e.get("epoch") is not None and e.get("wall_s") is not None:
            epoch_walls[int(e["epoch"])] = float(e["wall_s"])
    # Trace spans: the trace id the stream rides (one id spans the whole
    # supervised fleet when propagation worked) and per-(span name, epoch)
    # walls, so the fleet report can attribute collective wait to NAMED
    # phases instead of only the epoch total.
    spans = by_kind.get("span", [])
    trace_id = next(
        (s["trace_id"] for s in spans if s.get("trace_id")),
        next(
            (s["trace_id"] for s in starts if s.get("trace_id")),
            next(
                (ev["trace_id"]
                 for ev in by_kind.get("fleet_started", [])
                 if ev.get("trace_id")),
                None,
            ),
        ),
    )
    span_walls: dict[str, dict[int, float]] = {}
    for s in spans:
        epoch = (s.get("attrs") or {}).get("epoch")
        if epoch is None or s.get("dur_s") is None or not s.get("name"):
            continue
        span_walls.setdefault(str(s["name"]), {})[int(epoch)] = float(
            s["dur_s"]
        )
    crash_events = by_kind.get("crashdump", [])
    crashdump = _read_json(path.parent / CRASHDUMP_FILENAME)
    if crashdump is None and crash_events:
        # The dump file may have been reaped; the flushed event survives.
        crashdump = {"reason": crash_events[-1].get("reason"),
                     "path": crash_events[-1].get("path")}
    heartbeat = _read_json(path.parent / HEARTBEAT_FILENAME)
    # Collective-schedule snapshot: prefer whichever record saw the most
    # entries — a crashdump taken after the last heartbeat is fresher,
    # and the flushed event stream survives sidecar reaping.
    schedule = None
    for doc in (heartbeat, crashdump):
        snap = (doc or {}).get("collective_schedule")
        if snap and snap.get("n", 0) > (schedule or {}).get("n", 0):
            schedule = snap
    for ev in by_kind.get("collective_schedule", []):
        snap = {
            "n": ev.get("n"),
            "chain": ev.get("chain"),
            "tail": ev.get("tail") or [],
        }
        if snap["n"] and snap["n"] > (schedule or {}).get("n", 0):
            schedule = snap
    try:
        rel = str(path.parent.relative_to(root))
    except ValueError:
        rel = str(path.parent)
    label = f"p{proc}" if proc is not None else (rel or path.parent.name)
    return {
        "stream": rel or ".",
        "label": label,
        "proc": proc,
        "nproc": nproc,
        "host": host,
        "pid": pid,
        "run": events[0].get("run") if events else None,
        "events": len(events),
        "started": started,
        "attempts": attempts,
        "resumed_from": resumed_from,
        "generation": generation,
        "role": role,
        "fleet": fleet,
        "verdict": None if verdict is None else {
            "ok": bool(verdict.get("ok")),
            "verdict": verdict.get("verdict"),
        },
        "finished": finished is not None or verdict is not None,
        "diverged": bool(finished and finished.get("diverged")),
        "steps_per_sec": finished.get("steps_per_sec") if finished else None,
        "platform": last_start.get("platform"),
        "n_devices": last_start.get("n_devices"),
        "cost_profile": None if cost is None else {
            k: cost.get(k)
            for k in ("program", "available", "flops_per_step",
                      "bytes_per_step", "peak_bytes")
        },
        "epochs": len(epoch_walls),
        "last_epoch": max(epoch_walls) if epoch_walls else None,
        "epoch_walls": epoch_walls,
        "trace_id": trace_id,
        "span_walls": span_walls,
        "first_ts": events[0].get("ts") if events else None,
        "last_ts": events[-1].get("ts") if events else None,
        "crashdump": None if crashdump is None else {
            "reason": crashdump.get("reason"),
            "phase": crashdump.get("phase"),
            "epoch": crashdump.get("epoch"),
            "path": str(path.parent / CRASHDUMP_FILENAME),
        },
        "heartbeat": None if heartbeat is None else {
            "ts": heartbeat.get("ts"),
            "phase": heartbeat.get("phase"),
            "epoch": heartbeat.get("epoch"),
            "beats": heartbeat.get("beats"),
        },
        "schedule": schedule,
    }


def _last_activity(d: dict) -> float | None:
    candidates = [d.get("last_ts")]
    if d.get("heartbeat"):
        candidates.append(d["heartbeat"].get("ts"))
    candidates = [c for c in candidates if c is not None]
    return max(candidates) if candidates else None


def _status(d: dict, now: float, grace_s: float) -> str:
    if d["finished"]:
        return "finished"
    last = _last_activity(d)
    crash = d.get("crashdump")
    if (
        crash
        and (d.get("attempts") or 1) > 1
        and last is not None
        and (now - last) <= grace_s
    ):
        # The crashdump belongs to a superseded attempt; the retry is
        # still making progress.
        return "running"
    if crash and crash.get("reason"):
        reason = str(crash["reason"])
        if reason.startswith("signal"):
            return "killed"
        if reason.startswith("hang"):
            return "hung"
        return "crashed"
    last = _last_activity(d)
    if last is not None and (now - last) <= grace_s:
        return "running"
    return "dead"


def aggregate_streams(
    digests: list[dict],
    now: float | None = None,
    grace_s: float = DEFAULT_GRACE_S,
) -> dict:
    """The fleet report over per-process digests (see module docstring)."""
    now = time.time() if now is None else now
    for d in digests:
        d["status"] = _status(d, now, grace_s)

    # --- generation stitching (fleet supervisor relaunch / resize) ---
    # A fleet-supervised incident leaves one stream per rank PER
    # GENERATION under the same root, plus the supervisor's own stream.
    # Everything below reconstructs ONE logical run from that pile: the
    # LATEST generation is the fleet's present; older generations are
    # forensic history, not live failures.
    sups = [d for d in digests if d.get("role") == "supervisor"]
    workers = [d for d in digests if d.get("role") != "supervisor"]
    gens = sorted(
        {d["generation"] for d in workers if d.get("generation") is not None}
    )
    fleet_gen = gens[-1] if gens else None
    if len(gens) > 1:
        # Two generations both contain a "p0": disambiguate every worker
        # label with its generation so rows and attribution keys stay
        # unique across relaunches.
        for d in workers:
            g = d["generation"] if d.get("generation") is not None else 0
            d["label"] = f"g{g}/{d['label']}"
    for d in workers:
        if (
            fleet_gen is not None
            and d.get("generation") is not None
            and d["generation"] < fleet_gen
            and d["status"] != "finished"
        ):
            # The fleet was relaunched past this stream: an unfinished
            # older-generation rank is SUPERSEDED evidence — the relaunch
            # already healed it, so it must not read as dead forever.
            d["status"] = "superseded"
    current = [
        d for d in workers
        if fleet_gen is None or d.get("generation") in (None, fleet_gen)
    ]
    fleet_info = next((d["fleet"] for d in sups if d.get("fleet")), None)
    resizes = fleet_info["resizes"] if fleet_info else []
    fleet_verdict = fleet_info["verdict"] if fleet_info else None
    # Epoch statistics (skew, wait, straggler) compare only the CURRENT
    # generation — a superseded rank's partial epochs would poison the
    # shared-epoch intersection and the wait attribution.
    stat_digests = current if fleet_gen is not None else digests

    # Expected world size is the LATEST generation's: after an elastic
    # resize the retired rank is gone by design, not missing.
    expected_src = [d["nproc"] for d in current if d.get("nproc")]
    if fleet_info and fleet_info.get("last_nprocs"):
        expected_src.append(fleet_info["last_nprocs"])
    expected = max(expected_src or [len(current) or len(digests)])
    present = {d["proc"] for d in current if d.get("proc") is not None}
    missing = (
        sorted(set(range(expected)) - present)
        if present and expected > len(current)
        else []
    )

    # Skew + wait attribution over the epochs EVERY stream shares — a
    # process that died at epoch 3 must not make the survivors' epochs
    # 4..N look like infinite skew.
    walls = [d["epoch_walls"] for d in stat_digests if d["epoch_walls"]]
    shared = sorted(set.intersection(*map(set, walls))) if len(walls) > 1 else []
    per_epoch_skew = {
        e: max(w[e] for w in walls) - min(w[e] for w in walls)
        for e in shared
    }
    slowest_count: dict[str, int] = {}
    for e in shared:
        slowest = max(
            (d for d in stat_digests if e in d["epoch_walls"]),
            key=lambda d: d["epoch_walls"][e],
        )
        slowest_count[slowest["label"]] = (
            slowest_count.get(slowest["label"], 0) + 1
        )
    collective_wait = {
        d["label"]: sum(
            max(w[e] for w in walls) - d["epoch_walls"][e] for e in shared
        )
        for d in stat_digests
        if d["epoch_walls"]
    }

    # Named-span wait attribution: the same (fleet max − own) fold, but per
    # span name over the epochs every emitting stream shares — so "p1 waits
    # 2s" decomposes into WHICH phase the fleet serializes on.
    span_names = sorted(
        {n for d in stat_digests for n in (d.get("span_walls") or {})}
    )
    collective_wait_by_span: dict[str, dict[str, float]] = {}
    for name in span_names:
        swalls = [
            d["span_walls"][name]
            for d in stat_digests
            if (d.get("span_walls") or {}).get(name)
        ]
        if len(swalls) < 2:
            continue
        shared_e = set.intersection(*map(set, swalls))
        if not shared_e:
            continue
        collective_wait_by_span[name] = {
            d["label"]: sum(
                max(w[e] for w in swalls) - d["span_walls"][name][e]
                for e in shared_e
            )
            for d in stat_digests
            if (d.get("span_walls") or {}).get(name)
        }
    trace_ids = sorted(
        {d["trace_id"] for d in digests if d.get("trace_id")}
    )

    straggler = None
    if shared:
        totals = {
            d["label"]: sum(d["epoch_walls"][e] for e in shared)
            for d in stat_digests
            if d["epoch_walls"]
        }
        worst_label = max(totals, key=totals.get)
        ordered = sorted(totals.values())
        median = ordered[len(ordered) // 2]
        slowdown = (totals[worst_label] / median - 1.0) if median > 0 else 0.0
        worst = next(d for d in stat_digests if d["label"] == worst_label)
        straggler = {
            "label": worst_label,
            "proc": worst["proc"],
            "host": worst["host"],
            "shared_epoch_wall_s": totals[worst_label],
            "slowdown_pct": 100.0 * slowdown,
            "slowest_epochs": slowest_count.get(worst_label, 0),
            "significant": slowdown > STRAGGLER_SLOWDOWN,
        }

    per_host_wall: dict[str, list[float]] = {}
    for d in stat_digests:
        if d["epoch_walls"] and d.get("host"):
            per_host_wall.setdefault(d["host"], []).extend(
                d["epoch_walls"][e] for e in (shared or d["epoch_walls"])
            )

    fleet_last = max(
        (t for t in (_last_activity(d) for d in digests) if t is not None),
        default=None,
    )
    heartbeat_gaps = {}
    for d in digests:
        last = _last_activity(d)
        if last is not None and fleet_last is not None:
            heartbeat_gaps[d["label"]] = fleet_last - last

    failures: list[str] = []
    for d in sups:
        v = d.get("verdict")
        if v is not None and not v["ok"]:
            detail = ""
            if fleet_verdict is not None:
                detail = (
                    f" after {fleet_verdict.get('generations')} "
                    f"generation(s), final "
                    f"{fleet_verdict.get('final_nprocs')} rank(s)"
                )
            failures.append(
                f"{d['label']} supervisor verdict "
                f"{v['verdict'].upper()}{detail}"
            )
    for d in digests:
        if d.get("role") == "supervisor" or d["status"] == "superseded":
            # Supervisors fail via their verdict (above); superseded
            # generations already paid their failure as a relaunch.
            continue
        if d["status"] in ("killed", "hung", "crashed", "dead"):
            crash = d.get("crashdump") or {}
            where = (
                f"epoch {d['last_epoch']}" if d["last_epoch"] is not None
                else f"phase {crash.get('phase') or '?'}"
            )
            detail = crash.get("reason") or (
                "no crashdump; last activity "
                f"{heartbeat_gaps.get(d['label'], 0.0):.1f}s behind the fleet"
            )
            failures.append(
                f"{d['label']} (host {d['host']}, pid {d['pid']}) "
                f"{d['status'].upper()} at {where} — {detail}"
            )
        elif d["diverged"]:
            failures.append(
                f"{d['label']} diverged (halted on a non-finite loss)"
            )
    for proc in missing:
        failures.append(
            f"p{proc} left no event stream ({expected} processes expected, "
            f"{len(digests)} streams found)"
        )
    if straggler and straggler["significant"]:
        failures_note = (
            f"{straggler['label']} straggles: "
            f"{straggler['slowdown_pct']:.0f}% over the fleet median, "
            f"slowest in {straggler['slowest_epochs']}/{len(shared)} epochs"
        )
        # A slow-but-finished straggler is a warning, not a failure.
        if any(d["label"] == straggler["label"]
               and d["status"] != "finished" for d in digests):
            failures.append(failures_note)

    # --- collective-schedule audit (runtime half of analysis Pass 4) ---
    # Bitwise cross-check of each CURRENT-generation rank's schedule
    # hash chain: a wedged fleet whose ranks issued different collective
    # schedules gets a diagnosis (divergent rank, step, both schedules)
    # instead of a heartbeat timeout.
    schedule_audit = audit_schedules(
        {
            d["label"]: d.get("schedule")
            for d in (current if fleet_gen is not None else workers)
        }
    )
    if not schedule_audit["ok"]:
        chains = ", ".join(
            f"{label} {v['chain'][:16]}…({v['n']} entries)"
            for label, v in sorted(schedule_audit["ranks"].items())
        )
        scheds = "; ".join(
            f"{label}: [{', '.join(entries[-4:])}]"
            for label, entries in sorted(
                (schedule_audit.get("schedules") or {}).items()
            )
        )
        failures.append(
            f"collective schedule DIVERGED — {schedule_audit['detail']} "
            f"| chains: {chains}" + (f" | tails: {scheds}" if scheds else "")
        )

    # Fleet utilization: the hot program's static cost × the fleet's step
    # rate, with the comms side fed by the wait attribution above — the
    # mean fraction of shared-epoch wall each process spent blocked in the
    # collective. This is the ONLY place comms-bound can be diagnosed (a
    # single stream cannot see the fleet max), so summarize splits only
    # compute/memory and the aggregate view owns the third regime.
    fleet_util = None
    cost_digest = next((d for d in digests if d.get("cost_profile")), None)
    if cost_digest is not None:
        from masters_thesis_tpu_torch.telemetry.costs import utilization

        cost = cost_digest["cost_profile"]
        rates = [d["steps_per_sec"] for d in digests
                 if d.get("steps_per_sec")]
        mean_sps = sum(rates) / len(rates) if rates else None
        comms_frac = None
        if shared and len(collective_wait) > 1:
            fleet_wall = sum(max(w[e] for w in walls) for e in shared)
            if fleet_wall > 0:
                comms_frac = sum(collective_wait.values()) / (
                    fleet_wall * len(collective_wait)
                )
        fleet_util = {
            "program": cost.get("program"),
            "available": bool(cost.get("available")),
            "flops_per_step": cost.get("flops_per_step"),
            "bytes_per_step": cost.get("bytes_per_step"),
            "processes_profiled": sum(
                1 for d in digests if d.get("cost_profile")
            ),
        }
        fleet_util.update(
            utilization(
                cost.get("flops_per_step"),
                cost.get("bytes_per_step"),
                mean_sps,
                cost_digest.get("platform"),
                cost_digest.get("n_devices"),
                comms_frac,
            )
        )

    return {
        "processes": digests,
        "expected_processes": expected,
        "finished_processes": sum(
            d["status"] == "finished"
            for d in digests
            if d.get("role") != "supervisor"
        ),
        "missing_processes": missing,
        "fleet_generation": fleet_gen,
        "generations": (
            fleet_info["generations"]
            if fleet_info and fleet_info.get("generations")
            else (fleet_gen + 1 if fleet_gen is not None else None)
        ),
        "resizes": resizes,
        "fleet_verdict": fleet_verdict,
        "epoch_skew": {
            "epochs_compared": len(shared),
            "mean_s": (
                sum(per_epoch_skew.values()) / len(per_epoch_skew)
                if per_epoch_skew
                else None
            ),
            "max_s": max(per_epoch_skew.values()) if per_epoch_skew else None,
            "max_epoch": (
                max(per_epoch_skew, key=per_epoch_skew.get)
                if per_epoch_skew
                else None
            ),
        },
        "per_host_mean_epoch_wall_s": {
            h: sum(v) / len(v) for h, v in sorted(per_host_wall.items())
        },
        "collective_wait_s": collective_wait,
        "collective_wait_by_span_s": collective_wait_by_span,
        "trace_ids": trace_ids,
        "utilization": fleet_util,
        "straggler": straggler,
        "heartbeat_gaps_s": heartbeat_gaps,
        "collective_schedule": schedule_audit,
        "failures": failures,
        "healthy": not failures,
    }


def aggregate_path(
    root: str | Path,
    now: float | None = None,
    grace_s: float = DEFAULT_GRACE_S,
) -> dict:
    root = Path(root)
    streams = discover_streams(root)
    if not streams:
        raise FileNotFoundError(f"no {EVENTS_FILENAME} under {root}")
    report = aggregate_streams(
        [digest_stream(p, root) for p in streams], now=now, grace_s=grace_s
    )
    report["root"] = str(root)
    return report


def postmortem_path(
    root: str | Path,
    now: float | None = None,
    grace_s: float = DEFAULT_GRACE_S,
) -> dict:
    """The fleet report plus the one-line verdict an operator (or a sweep
    runner's failed-cell row) wants first."""
    report = aggregate_path(root, now=now, grace_s=grace_s)
    report["headline"] = _headline(report)
    report["exit_code"] = 0 if report["healthy"] else 2
    return report


def _headline(report: dict) -> str:
    n = len(report["processes"])
    if report["healthy"]:
        extra = ""
        gens = report.get("generations")
        if gens and gens > 1:
            extra = f" (fleet healed across {gens} generations" + (
                f", {len(report['resizes'])} resize(s))"
                if report.get("resizes") else ")"
            )
            return (
                f"latest generation finished clean; no live failures"
                + extra
            )
        return (
            f"all {n} process(es) finished; no failures detected" + extra
        )
    return report["failures"][0] + (
        f" [{len(report['failures'])} finding(s); "
        f"{report['finished_processes']}/{report['expected_processes']} "
        "finished]"
    )


# ------------------------------------------------------------- rendering


def _fmt(value, spec: str = ".3g") -> str:
    return "n/a" if value is None else format(value, spec)


def render_fleet_text(report: dict, postmortem: bool = False) -> str:
    lines = []
    if postmortem:
        lines.append(f"postmortem     : {report['headline']}")
    lines += [
        f"fleet          : {len(report['processes'])} stream(s), "
        f"{report['finished_processes']}/{report['expected_processes']} "
        "finished",
    ]
    if report.get("fleet_generation") is not None:
        gen_line = f"generations    : {report.get('generations')}"
        for r in report.get("resizes") or []:
            gen_line += (
                f" | resized {r.get('from_nprocs')}->{r.get('to_nprocs')}"
                f" @ g{r.get('gen')} ({r.get('reason')})"
            )
        lines.append(gen_line)
    if report.get("fleet_verdict"):
        v = report["fleet_verdict"]
        lines.append(
            f"fleet verdict  : {'ok' if v.get('ok') else 'FAILED'} "
            f"({v.get('verdict')}, final {v.get('final_nprocs')} rank(s), "
            f"trace {v.get('trace_id')})"
        )
    for d in report["processes"]:
        hb = report["heartbeat_gaps_s"].get(d["label"])
        lines.append(
            f"  {d['label']:<8s} {d['status']:<9s} host={d['host']} "
            f"pid={d['pid']} epochs={d['epochs']} "
            f"last_epoch={_fmt(d['last_epoch'], 'd') if d['last_epoch'] is not None else 'n/a'} "
            f"sps={_fmt(d['steps_per_sec'], '.2f')} "
            f"gap={_fmt(hb, '.1f')}s"
            + (
                f" attempts={d['attempts']}"
                + (" (resumed)" if d.get("resumed_from") else "")
                if (d.get("attempts") or 1) > 1
                else ""
            )
        )
    skew = report["epoch_skew"]
    lines.append(
        f"epoch skew     : mean {_fmt(skew['mean_s'], '.4f')}s | "
        f"max {_fmt(skew['max_s'], '.4f')}s"
        + (
            f" @ epoch {skew['max_epoch']}"
            if skew["max_epoch"] is not None
            else ""
        )
        + f" ({skew['epochs_compared']} shared epochs)"
    )
    for host, wall in report["per_host_mean_epoch_wall_s"].items():
        lines.append(f"  host {host:<12s} mean epoch wall {wall:.4f}s")
    if report["collective_wait_s"]:
        waits = ", ".join(
            f"{label} {wait:.3f}s"
            for label, wait in sorted(report["collective_wait_s"].items())
        )
        lines.append(f"collective wait: {waits}")
    for name, waits in sorted(
        (report.get("collective_wait_by_span_s") or {}).items()
    ):
        per = ", ".join(
            f"{label} {wait:.3f}s" for label, wait in sorted(waits.items())
        )
        lines.append(f"  span {name:<13s} {per}")
    if report.get("trace_ids"):
        ids = report["trace_ids"]
        lines.append(
            f"trace          : {ids[0]}"
            + (f" (+{len(ids) - 1} more — propagation split the fleet!)"
               if len(ids) > 1 else " (one trace across the fleet)")
        )
    util = report.get("utilization")
    if util is not None:
        if util.get("available"):
            frac = util.get("comms_wait_frac")
            lines.append(
                f"utilization    : {util.get('program')} | "
                f"AI {_fmt(util.get('arithmetic_intensity'), '.3g')} | "
                f"{_fmt(util.get('flops_utilization_pct'), '.4g')}% of peak "
                f"FLOP/s | {util.get('regime') or 'n/a'}"
                + (
                    f" (comms wait {100.0 * frac:.1f}% of fleet wall)"
                    if frac is not None
                    else ""
                )
            )
        else:
            lines.append(
                "utilization    : n/a (backend reported no cost model)"
            )
    sched = report.get("collective_schedule")
    if sched is not None and sched.get("verdict") != "insufficient":
        per_rank = ", ".join(
            f"{label} {v['chain'][:12]}…({v['n']})"
            for label, v in sorted((sched.get("ranks") or {}).items())
        )
        lines.append(
            f"collectives    : {sched['verdict']}"
            + (f" | {per_rank}" if per_rank else "")
        )
        if sched.get("verdict") in ("diverged", "lagging"):
            lines.append(f"  {sched.get('detail')}")
        for label, entries in sorted(
            (sched.get("schedules") or {}).items()
        ):
            tail = ", ".join(entries[-4:]) if entries else "<empty>"
            lines.append(f"  {label} schedule tail: {tail}")
    s = report["straggler"]
    if s is not None:
        lines.append(
            f"straggler      : {s['label']} (host {s['host']}) "
            f"+{s['slowdown_pct']:.1f}% vs fleet median, slowest in "
            f"{s['slowest_epochs']} epoch(s)"
            + ("" if s["significant"] else " [not significant]")
        )
    if report["failures"]:
        lines.append("FAILURES:")
        lines.extend(f"  - {f}" for f in report["failures"])
    else:
        lines.append("fleet health   : ok")
    return "\n".join(lines)
