"""Run reports: fold a JSONL event stream into the numbers that matter.

Counterpart of ``masters_thesis_tpu/telemetry/report.py``, the same
arithmetic over dicts, for the streams the port writes: a training run
(``train/trainer.py``), a stacked run (``train/stacked.py``: per-replica
stats), a serving run (``serve/``) and the run supervisor
(``resilience/supervisor.py``: restarts and lost work). The report gives
steps/s and the step-time quantiles over the epochs that captured no
graph, the captures of the train program (``compiles.train_epoch``:
exactly one is the contract, more is a violation and the CLI exits 2),
where the wall time went, the input pipeline's wait, device memory,
restarts, serving, per-replica status and the roofline line from the
analytic ``cost_profile``.

One difference from the JAX report: the utilization line takes the card's
peaks from the device name the ``cost_profile`` event carries
(``meta.device``), through the port's ``costs.platform_peaks``, which
knows only the H100; any other device, and the CPU, print ``n/a``.

Stdlib only: ``python -m masters_thesis_tpu_torch.telemetry summarize``
runs without torch.
"""

from __future__ import annotations

import json
from pathlib import Path

from masters_thesis_tpu_torch.telemetry.costs import (
    TPU_UTILIZATION_FLOOR,
    utilization as _roofline_utilization,
)
from masters_thesis_tpu_torch.telemetry.events import read_events
from masters_thesis_tpu_torch.telemetry.quality import (
    quality_report,
    quality_violations,
)

EVENTS_FILENAME = "events.jsonl"


def resolve_events_path(target: str | Path) -> Path:
    """Accept a run dir, a dir containing one run, or an events file."""
    target = Path(target)
    if target.is_file():
        return target
    direct = target / EVENTS_FILENAME
    if direct.is_file():
        return direct
    nested = sorted(target.glob(f"*/{EVENTS_FILENAME}"))
    if len(nested) == 1:
        return nested[0]
    if len(nested) > 1:
        raise FileNotFoundError(
            f"{target} holds {len(nested)} event streams; pass one of: "
            + ", ".join(str(p.parent) for p in nested)
        )
    raise FileNotFoundError(f"no {EVENTS_FILENAME} under {target}")


def _quantile(sorted_values: list[float], q: float) -> float | None:
    if not sorted_values:
        return None
    idx = min(len(sorted_values) - 1, max(0, round(q * (len(sorted_values) - 1))))
    return sorted_values[idx]


def summarize_events(events: list[dict]) -> dict:
    """Fold an event stream into the run report dict (see render_text)."""
    by_kind: dict[str, list[dict]] = {}
    for ev in events:
        by_kind.setdefault(ev.get("kind", "?"), []).append(ev)

    started = (by_kind.get("run_started") or [{}])[-1]
    finished = (by_kind.get("run_finished") or [{}])[-1]
    epochs = by_kind.get("epoch", [])
    steady = [e for e in epochs if not e.get("compiled")]
    compile_epochs = [e for e in epochs if e.get("compiled")]

    # Throughput: prefer the trainer's own post-compile figure (measured
    # fence-to-fence over the whole run); fall back to summing epoch events.
    steps_per_sec = finished.get("steps_per_sec")
    steady_steps = sum(e.get("steps") or 0 for e in steady)
    steady_wall = sum(e.get("wall_s") or 0.0 for e in steady)
    if steps_per_sec is None and steady_wall > 0:
        steps_per_sec = steady_steps / steady_wall

    step_times = sorted(
        (e["wall_s"] / e["steps"])
        for e in steady
        if e.get("wall_s") and e.get("steps")
    )

    # Compile accounting: epoch events carry per-epoch cache-miss deltas;
    # run_finished carries the totals (authoritative when present).
    epoch_compiles = finished.get("epoch_compiles")
    if epoch_compiles is None:
        epoch_compiles = sum(e.get("compile_events") or 0 for e in epochs)
    eval_compiles = finished.get("eval_compiles")
    if eval_compiles is None:
        eval_compiles = sum(
            e.get("compile_events") or 0 for e in by_kind.get("eval", [])
        )
    first_compile_s = (
        compile_epochs[0].get("wall_s") if compile_epochs else None
    )

    compile_s = sum(e.get("wall_s") or 0.0 for e in compile_epochs)
    device_s = sum(
        e["device_s"] for e in steady if e.get("device_s") is not None
    )
    dispatch_s = sum(
        e["dispatch_s"] for e in steady if e.get("dispatch_s") is not None
    )
    data_wait_s = sum(e.get("data_wait_s") or 0.0 for e in epochs)
    total_wall = compile_s + steady_wall

    # Starvation: fraction of steady-state wall the host spent PRODUCING
    # the next batch instead of overlapping device compute. Scan-mode runs
    # (device-resident split) are structurally 0.
    steady_data_wait = sum(e.get("data_wait_s") or 0.0 for e in steady)
    starvation_pct = (
        100.0 * steady_data_wait / steady_wall if steady_wall > 0 else 0.0
    )

    mem_events = by_kind.get("memory", [])
    peak_bytes = _max_of(mem_events, "peak_bytes_in_use")
    bytes_in_use = _max_of(mem_events, "bytes_in_use")
    live_bytes = _max_of(mem_events, "live_buffer_bytes")
    peak = next(
        (v for v in (peak_bytes, bytes_in_use, live_bytes) if v is not None),
        None,
    )

    restarts = _restart_stats(events, by_kind)
    serve = _serve_stats(by_kind)
    fleet = _fleet_stats(by_kind)
    replicas = _replica_stats(by_kind)
    util = _utilization_stats(
        by_kind,
        steps_per_sec,
        started.get("platform"),
        started.get("n_devices"),
    )

    # Window-store epochs (memory-mapped shards): how many bytes paged
    # through the store and how much of the data wait was page-fault wait —
    # the "slow disk vs slow producer" split for universe-scale runs.
    ws_events = by_kind.get("window_store", [])
    window_store = None
    if ws_events:
        ws_bytes = sum(e.get("bytes_read") or 0 for e in ws_events)
        ws_fault = sum(e.get("fault_wait_s") or 0.0 for e in ws_events)
        window_store = {
            "epochs": len(ws_events),
            "bytes_read": ws_bytes,
            "fault_wait_s": ws_fault,
            "fault_share_pct": (
                100.0 * ws_fault / data_wait_s if data_wait_s > 0 else 0.0
            ),
        }

    preflight = (by_kind.get("preflight") or [{}])[-1]
    # Gradient-sync footprint (flat update path, train/flatparams.py): the
    # trainer records one grad_sync event per run — collectives per step
    # (the TA206-pinned count) and bytes moved by the flat-buffer pmean.
    grad_sync = (by_kind.get("grad_sync") or [{}])[-1]
    profile_windows = [
        {k: e.get(k) for k in ("start_epoch", "end_epoch", "trace_dir")}
        for e in by_kind.get("profile_window", [])
    ]

    report = {
        "run": started.get("run") or (events[0].get("run") if events else None),
        "platform": started.get("platform"),
        "n_devices": started.get("n_devices"),
        "strategy": started.get("strategy"),
        "epoch_mode": started.get("epoch_mode"),
        "epochs": len(epochs),
        "total_steps": sum(e.get("steps") or 0 for e in epochs),
        "steps_per_sec": steps_per_sec,
        "step_time_ms": {
            "p50": _scale(_quantile(step_times, 0.50), 1e3),
            "p99": _scale(_quantile(step_times, 0.99), 1e3),
            "mean": _scale(
                (sum(step_times) / len(step_times)) if step_times else None,
                1e3,
            ),
            "samples": len(step_times),
        },
        "compiles": {
            "train_epoch": epoch_compiles,
            "eval": eval_compiles,
            "first_compile_s": first_compile_s,
        },
        "time_split_s": {
            "total": total_wall,
            "compile": compile_s,
            "device": device_s,
            "dispatch": dispatch_s,
            "data_wait": data_wait_s,
        },
        "data": {
            "data_wait_s": data_wait_s,
            "starvation_pct": starvation_pct,
        },
        "window_store": window_store,
        "memory": {
            "peak_bytes": peak,
            "peak_bytes_in_use": peak_bytes,
            "live_buffer_bytes": live_bytes,
            "source": mem_events[-1].get("source") if mem_events else None,
        },
        "grad_sync": {
            "collectives_per_step": grad_sync.get("collectives_per_step"),
            "grad_reduce_bytes": grad_sync.get("grad_reduce_bytes"),
            "flat_buffers": grad_sync.get("flat_buffers"),
        },
        "restarts": restarts,
        "serve": serve,
        "fleet": fleet,
        "replicas": replicas,
        "utilization": util,
        "preflight": preflight.get("status"),
        "diverged": finished.get("diverged"),
        "profile_windows": profile_windows,
        "best_val": finished.get("best_val"),
        "alerts": (
            alert_state(events)
            if (by_kind.get("alert_fired") or by_kind.get("alert_resolved"))
            else None
        ),
        # Model-quality plane (telemetry/quality.py): drift-sample folding,
        # breach counts, quality-rejected swaps. None for runs that never
        # sampled — the section only appears once a monitor was attached.
        "quality": (
            quality_report(events)
            if (
                by_kind.get("quality_sample")
                or any(
                    str(e.get("reason") or "").startswith("quality")
                    for e in by_kind.get("swap_rejected", [])
                )
            )
            else None
        ),
    }
    report["violations"] = contract_violations(report) + quality_violations(
        events, report["quality"]
    )
    return report


def alert_state(events: list[dict]) -> dict:
    """Fold ``alert_fired``/``alert_resolved`` (stream-ordered) into the
    per-rule alert state. Shared by the live watch console and the
    post-hoc ``alerts`` report section, so what the console showed while
    the run was alive is — by construction — what summarize confirms
    after it ends."""
    rules: dict[str, dict] = {}
    fired = resolved = 0
    for ev in events:
        kind = ev.get("kind")
        if kind not in ("alert_fired", "alert_resolved"):
            continue
        name = ev.get("rule") or "?"
        row = rules.setdefault(
            name,
            {
                "rule": name,
                "slo_kind": ev.get("slo_kind"),
                "firing": False,
                "since_ts": None,
                "fired": 0,
                "resolved": 0,
                "last_value": None,
                "threshold": ev.get("threshold"),
            },
        )
        row["last_value"] = ev.get("value")
        if kind == "alert_fired":
            fired += 1
            row["fired"] += 1
            row["firing"] = True
            row["since_ts"] = ev.get("ts")
        else:
            resolved += 1
            row["resolved"] += 1
            row["firing"] = False
    return {
        "rules": rules,
        "active": sorted(
            name for name, row in rules.items() if row["firing"]
        ),
        "fired": fired,
        "resolved": resolved,
    }


def _restart_stats(events: list[dict], by_kind: dict) -> dict:
    """Restart accounting over a (possibly multi-attempt) event stream.

    A resumed run APPENDS to the same events.jsonl (telemetry/run.py), so
    one stream can hold several attempts: trainer streams delimit them
    with run_started, supervisor streams with attempt_started. Lost work
    per dead attempt = gap between its last activity and its last
    checkpoint_saved (no checkpoint in the segment -> the whole segment
    was lost); supervisor attempt_finished events carry the figure
    precomputed.
    """
    starts = by_kind.get("run_started", [])
    sup_started = by_kind.get("attempt_started", [])
    attempts = max(len(starts), len(sup_started), 1 if events else 0)

    lost_work_s = 0.0
    # Supervisor streams: attempt_finished carries lost_work_s directly.
    measured = False
    for ev in by_kind.get("attempt_finished", []):
        if ev.get("lost_work_s") is not None and not ev.get("ok"):
            lost_work_s += float(ev["lost_work_s"])
            measured = True
    if not measured and len(starts) > 1:
        # Trainer streams: split into segments at each run_started; a
        # segment without a run_finished died mid-flight.
        segments: list[list[dict]] = []
        for ev in events:
            if ev.get("kind") == "run_started":
                segments.append([])
            if segments:
                segments[-1].append(ev)
        for seg in segments:
            if any(e.get("kind") == "run_finished" for e in seg):
                continue
            last_ts = max((e.get("ts") or 0.0) for e in seg)
            saves = [
                e.get("ts") or 0.0
                for e in seg
                if e.get("kind") == "checkpoint_saved"
            ]
            floor_ts = max(saves) if saves else min(
                (e.get("ts") or 0.0) for e in seg
            )
            lost_work_s += max(0.0, last_ts - floor_ts)

    # The trace id the attempt chain rides: the supervisor propagates ONE
    # id forward through every retry (trace.py), so the restarts line can
    # name the trace that stitches the attempts together.
    trace_id = next(
        (
            ev["trace_id"]
            for ev in (sup_started + starts)
            if ev.get("trace_id")
        ),
        None,
    )

    return {
        "attempts": attempts,
        "restarts": max(0, attempts - 1),
        "lost_work_s": lost_work_s,
        "degradations": len(by_kind.get("degradation", [])),
        "rollbacks": len(by_kind.get("rollback", [])),
        "resumed": any(e.get("resumed_from") for e in starts),
        "trace_id": trace_id,
    }


def _serve_stats(by_kind: dict) -> dict | None:
    """Serving-path accounting; None for runs that never served.

    ``serve_finished`` (server.py stop()) is authoritative for the
    totals; the raw shed / swap / degradation events keep the section
    usable for a replica that died before a clean stop.
    """
    finished = by_kind.get("serve_finished", [])
    raw_sheds = len(by_kind.get("request_shed", []))
    swaps_committed = len(by_kind.get("swap_committed", []))
    swaps_rejected = len(by_kind.get("swap_rejected", []))
    lane_swaps_committed = len(by_kind.get("lane_swap_committed", []))
    lane_swaps_rejected = len(by_kind.get("lane_swap_rejected", []))
    if not (
        finished
        or by_kind.get("serve_started")
        or raw_sheds
        or swaps_committed
        or swaps_rejected
        or lane_swaps_committed
        or lane_swaps_rejected
    ):
        return None
    last = finished[-1] if finished else {}
    return {
        "requests": last.get("requests"),
        "completed": last.get("completed"),
        "shed": last.get("shed", raw_sheds),
        "errors": last.get("errors"),
        "late_converted": last.get("late_converted"),
        "late_deliveries": last.get("late_deliveries"),
        "p50_ms": last.get("p50_ms"),
        "p99_ms": last.get("p99_ms"),
        "qps": last.get("qps"),
        # Multi-tenant stacked serving: per-tenant admission accounting
        # and lane count ride along on serve_finished when present.
        "tenants": last.get("tenants"),
        "lanes": last.get("lanes"),
        "swaps_committed": swaps_committed,
        "swaps_rejected": swaps_rejected,
        "lane_swaps_committed": lane_swaps_committed,
        "lane_swaps_rejected": lane_swaps_rejected,
        "degradations": len(by_kind.get("degradation", [])),
        "clean_stop": bool(finished),
    }


def _fleet_stats(by_kind: dict) -> dict | None:
    """Serving-fleet accounting (serve/fleet.py): replica lifecycle,
    failover, and exported-program cache behaviour. None for runs that
    never ran a fleet or touched the program cache.

    ``fleet_finished`` (stop()) is authoritative for the totals; the raw
    lifecycle events (replica_dead / replica_started / redispatch /
    cache_*) keep the section usable for a fleet that died before a
    clean stop.
    """
    finished = by_kind.get("fleet_finished", [])
    deaths = by_kind.get("replica_dead", [])
    boots = by_kind.get("replica_started", [])
    cache = {
        "hits": len(by_kind.get("cache_hit", [])),
        "misses": len(by_kind.get("cache_miss", [])),
        "stores": len(by_kind.get("cache_store", [])),
        "rejections": len(by_kind.get("cache_rejected", [])),
    }
    has_fleet = bool(finished or by_kind.get("fleet_started") or deaths
                     or boots)
    if not has_fleet and not any(cache.values()):
        return None
    last = finished[-1] if finished else {}
    per = last.get("replicas") if isinstance(last.get("replicas"), dict) \
        else {}
    restart_boots = [b for b in boots if b.get("restart")]
    return {
        "replicas": sorted(per) or sorted(
            {b.get("replica") for b in boots if b.get("replica")}
        ),
        "n_live": last.get("n_live"),
        # stop() drains serving replicas before the final stats, so
        # n_live is 0 at every clean stop by construction; draining means
        # the replica was alive when the fleet shut down. Only dead /
        # halted states count as losses.
        "alive_at_stop": sum(
            1 for rep in per.values()
            if (rep or {}).get("state") in ("live", "degraded", "draining")
        ),
        "deaths": last.get("deaths", len(deaths)),
        "death_causes": sorted(
            {d.get("cause") for d in deaths if d.get("cause")}
        ),
        "restarts": len(restart_boots),
        "halted": sorted({
            h.get("replica")
            for h in by_kind.get("replica_halted", [])
            if h.get("replica")
        }),
        "redispatched": last.get(
            "redispatched", len(by_kind.get("redispatch", []))
        ),
        "late_deliveries": last.get("late_deliveries"),
        # Restart boots must come from the exported-program cache: a
        # restarted replica that compiled anything took the cold path.
        "restart_boot_compiles": sum(
            int(b.get("compile_events") or 0) for b in restart_boots
        ),
        "restart_boot_cache_hits": sum(
            int(b.get("cache_hits") or 0) for b in restart_boots
        ),
        "cache": cache,
        "utilization": {
            name: rep.get("utilization") for name, rep in per.items()
        },
        "clean_stop": bool(finished),
    }


def _replica_stats(by_kind: dict) -> dict | None:
    """Per-replica accounting for stacked runs; None for solo runs.

    Folds the stacked trainer's per-replica sub-streams: ``replica_epoch``
    (one per replica per epoch: loss, lr, status), ``replica_status``
    (transition events: active -> recovering -> masked, with rollback
    counts) and ``replica_eval`` (per-replica validation losses).
    """
    epochs = by_kind.get("replica_epoch", [])
    transitions = by_kind.get("replica_status", [])
    evals = by_kind.get("replica_eval", [])
    if not epochs and not transitions:
        return None
    per: dict[int, dict] = {}
    for ev in epochs:
        r = ev.get("replica")
        row = per.setdefault(
            r,
            {
                "replica": r,
                "name": ev.get("name"),
                "epochs": 0,
                "last_loss": None,
                "last_lr": None,
                "status": "active",
                "rollbacks": 0,
                "best_val": None,
            },
        )
        row["epochs"] += 1
        row["last_loss"] = ev.get("loss")
        row["last_lr"] = ev.get("lr")
        row["status"] = ev.get("status", row["status"])
    for ev in transitions:
        row = per.get(ev.get("replica"))
        if row is None:
            continue
        row["status"] = ev.get("status", row["status"])
        row["rollbacks"] = max(
            row["rollbacks"], ev.get("rollbacks") or 0
        )
    for ev in evals:
        row = per.get(ev.get("replica"))
        if row is None or ev.get("val_loss") is None:
            continue
        if row["best_val"] is None or ev["val_loss"] < row["best_val"]:
            row["best_val"] = ev["val_loss"]
    rows = [per[r] for r in sorted(per, key=lambda x: (x is None, x))]
    return {
        "count": len(rows),
        "masked": sum(1 for r in rows if r["status"] == "masked"),
        "rollbacks": sum(r["rollbacks"] for r in rows),
        "per_replica": rows,
    }


def _utilization_stats(
    by_kind: dict,
    steps_per_sec: float | None,
    platform: str | None,
    n_devices: int | None,
) -> dict | None:
    """Roofline section from cost_profile events; None for pre-cost runs.

    Static cost (FLOPs/bytes per step from the compiler) × the measured
    post-compile step rate gives achieved FLOP/s and the roofline regime.
    A stream that recorded only ``cost_unavailable`` (backend reported no
    cost model) still gets a section — rendered "n/a", never omitted.
    The comms-bound verdict needs the aggregator's collective-wait
    attribution, so a single-stream summarize only splits compute/memory.
    """
    profiles = by_kind.get("cost_profile", [])
    unavailable = by_kind.get("cost_unavailable", [])
    if not profiles and not unavailable:
        return None
    # Hot program = the training program when present (authoritative for
    # steps/sec); otherwise the last profile seen (e.g. a serve-only run).
    hot = next(
        (e for e in profiles if str(e.get("program", "")).startswith("train")),
        profiles[-1] if profiles else None,
    )
    serve_buckets = {
        e.get("program"): e
        for e in profiles
        if str(e.get("program", "")).startswith("serve_bucket")
    }
    section = {
        "program": hot.get("program") if hot else None,
        "available": bool(hot and hot.get("available")),
        "source": hot.get("source") if hot else None,
        "flops_per_step": hot.get("flops_per_step") if hot else None,
        "bytes_per_step": hot.get("bytes_per_step") if hot else None,
        "peak_bytes": hot.get("peak_bytes") if hot else None,
        "serve_buckets": len(serve_buckets),
        "cost_unavailable_events": len(unavailable),
    }
    section.update(
        _roofline_utilization(
            section["flops_per_step"],
            section["bytes_per_step"],
            steps_per_sec,
            platform,
            n_devices,
            device=((hot or {}).get("meta") or {}).get("device"),
        )
    )
    return section


def contract_violations(report: dict) -> list[str]:
    """The runtime contracts a run report is gated on (CLI exits 2)."""
    violations = []
    compiles = report["compiles"]["train_epoch"] or 0
    if compiles > 1:
        violations.append(
            f"recompile: the train epoch program compiled {compiles} times "
            "across the run (contract: exactly once — TA201 at runtime)"
        )
    if report.get("preflight") == "failed":
        violations.append("preflight: the tracelint trace audit failed")
    if report.get("diverged"):
        violations.append("divergence: the run halted on a non-finite loss")
    serve = report.get("serve")
    if serve and (serve.get("late_deliveries") or 0) > 0:
        violations.append(
            f"serve: {serve['late_deliveries']} response(s) delivered past "
            "their deadline (contract: late answers are rejected, never "
            "delivered)"
        )
    fleet = report.get("fleet")
    if fleet:
        if (
            fleet.get("clean_stop")
            and fleet.get("replicas")
            and fleet.get("alive_at_stop") == 0
        ):
            violations.append(
                "fleet: finished with ZERO live replicas (every replica "
                "dead or halted — the fleet was serving explicit sheds, "
                "not answers)"
            )
        if (fleet.get("late_deliveries") or 0) > 0:
            violations.append(
                f"fleet: {fleet['late_deliveries']} response(s) delivered "
                "past their deadline during fleet serving (the no-late-"
                "answers invariant must hold fleet-wide, failover included)"
            )
        # Only gate restart compiles when a program cache was actually in
        # play (cache events in-stream, or restart boots reporting hits):
        # a cacheless fleet legitimately recompiles on restart.
        cache_active = any((fleet.get("cache") or {}).values()) or (
            fleet.get("restart_boot_cache_hits") or 0
        ) > 0
        if cache_active and (fleet.get("restart_boot_compiles") or 0) > 0:
            violations.append(
                f"fleet: restarted replica(s) compiled "
                f"{fleet['restart_boot_compiles']} program(s) at boot "
                "(contract: restarts load from the exported-program cache "
                "with zero compiles)"
            )
    util = report.get("utilization")
    if util and (report.get("platform") or "").lower() == "tpu":
        pct = util.get("flops_utilization_pct")
        floor_pct = 100.0 * TPU_UTILIZATION_FLOOR
        if pct is not None and pct < floor_pct:
            violations.append(
                f"utilization: {util.get('program')} achieved {pct:.3f}% of "
                f"nominal TPU FLOP/s (floor {floor_pct:.1f}% — CP403); the "
                "program cannot feed the MXU, see docs/telemetry.md"
            )
    return violations


def summarize_path(target: str | Path) -> dict:
    return summarize_events(read_events(resolve_events_path(target)))


def _max_of(events: list[dict], key: str) -> float | None:
    values = [e[key] for e in events if e.get(key) is not None]
    return max(values) if values else None


def _scale(value, factor):
    return None if value is None else value * factor


def _fmt_bytes(n) -> str:
    if n is None:
        return "n/a"
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024
    return f"{n:.1f} TiB"


def _fmt(value, spec: str = ".3g") -> str:
    return "n/a" if value is None else format(value, spec)


def render_text(report: dict) -> str:
    """Human-readable run report (the CLI's default output)."""
    t = report["time_split_s"]
    mem = report["memory"]
    st = report["step_time_ms"]
    lines = [
        f"run            : {report.get('run') or 'n/a'}",
        f"platform       : {report.get('platform') or 'n/a'} "
        f"x{report.get('n_devices') or '?'} "
        f"({report.get('strategy') or '?'}, {report.get('epoch_mode') or '?'})",
        f"epochs / steps : {report['epochs']} / {report['total_steps']}",
        f"steps/sec      : {_fmt(report['steps_per_sec'], '.2f')}",
        f"step time (ms) : p50 {_fmt(st['p50'], '.3f')} | "
        f"p99 {_fmt(st['p99'], '.3f')} | mean {_fmt(st['mean'], '.3f')} "
        f"({st['samples']} samples)",
        f"compiles       : train_epoch={report['compiles']['train_epoch']} "
        f"eval={report['compiles']['eval']} "
        f"(first compile {_fmt(report['compiles']['first_compile_s'], '.2f')}s)",
        f"time split (s) : compile {t['compile']:.2f} | device {t['device']:.2f}"
        f" | dispatch {t['dispatch']:.2f} | data-wait {t['data_wait']:.2f}"
        f" | total {t['total']:.2f}",
        f"input pipeline : data-wait {report['data']['data_wait_s']:.3f}s, "
        f"starvation {report['data']['starvation_pct']:.1f}%",
        *(
            [
                f"window store   : {_fmt_bytes(ws['bytes_read'])} paged over "
                f"{ws['epochs']} epoch(s), fault-wait {ws['fault_wait_s']:.3f}s"
                f" ({ws['fault_share_pct']:.1f}% of data-wait)"
            ]
            if (ws := report.get("window_store"))
            else []
        ),
        f"device memory  : peak {_fmt_bytes(mem['peak_bytes'])} "
        f"(live buffers {_fmt_bytes(mem['live_buffer_bytes'])}, "
        f"source: {mem['source'] or 'n/a'})",
        _render_restarts(report.get("restarts") or {}),
        f"preflight      : {report.get('preflight') or 'not recorded'}",
    ]
    sv = report.get("serve")
    if sv:
        lines.insert(
            len(lines) - 1,
            f"serve          : {sv.get('completed') or 0}/"
            f"{sv.get('requests') or 0} ok, shed {sv.get('shed') or 0}, "
            f"late-rejected {sv.get('late_converted') or 0}, "
            f"p50 {_fmt(sv.get('p50_ms'), '.2f')}ms / "
            f"p99 {_fmt(sv.get('p99_ms'), '.2f')}ms, "
            f"qps {_fmt(sv.get('qps'), '.1f')}, "
            f"swaps {sv.get('swaps_committed', 0)}+/"
            f"{sv.get('swaps_rejected', 0)}-, "
            f"{sv.get('degradations', 0)} degradation(s)",
        )
    q = report.get("quality")
    if q:
        last = q.get("last") or {}
        br = q.get("breaches") or {}
        qline = (
            f"quality        : {q.get('samples', 0)} sample(s), "
            f"input_psi {_fmt(last.get('input_psi'), '.3f')}, "
            f"pred_psi {_fmt(last.get('pred_psi'), '.3f')}, "
            f"shadow_err {_fmt(last.get('shadow_err'), '.3f')} | "
            f"breaches input {br.get('input', 0)} / "
            f"pred {br.get('prediction', 0)} / shadow {br.get('shadow', 0)}"
        )
        if q.get("swaps_rejected_quality"):
            lr = q.get("last_rejection") or {}
            qline += (
                f" | {q['swaps_rejected_quality']} quality-rejected "
                f"swap(s) (last: {lr.get('tag')} {lr.get('reason')})"
            )
        lines.insert(len(lines) - 1, qline)
    fl = report.get("fleet")
    if fl:
        cache = fl.get("cache") or {}
        util_bits = ", ".join(
            f"{name} {_fmt(u, '.2f')}"
            for name, u in sorted((fl.get("utilization") or {}).items())
        )
        lines.insert(
            len(lines) - 1,
            f"fleet          : {len(fl.get('replicas') or [])} replica(s), "
            f"{fl.get('deaths') or 0} death(s), "
            f"{fl.get('restarts') or 0} restart(s), "
            f"{fl.get('redispatched') or 0} redispatched, "
            f"halted {fl.get('halted') or 'none'} | "
            f"cache {cache.get('hits', 0)} hit(s) / "
            f"{cache.get('stores', 0)} store(s) / "
            f"{cache.get('rejections', 0)} rejection(s)"
            + (f" | util {util_bits}" if util_bits else ""),
        )
    util = report.get("utilization")
    if util is not None:
        if util.get("available"):
            line = (
                f"utilization    : {util.get('program')} | "
                f"flops/step {_fmt(util.get('flops_per_step'))} | "
                f"bytes/step {_fmt(util.get('bytes_per_step'))} | "
                f"AI {_fmt(util.get('arithmetic_intensity'), '.3g')} | "
                f"{_fmt(util.get('flops_utilization_pct'), '.4g')}% of "
                f"{report.get('platform') or '?'} peak FLOP/s | "
                f"{util.get('regime') or 'n/a'}"
            )
        else:
            line = (
                "utilization    : n/a (backend reported no cost model; "
                f"{util.get('cost_unavailable_events', 0)} "
                "cost_unavailable event(s))"
            )
        if util.get("serve_buckets"):
            line += f" | {util['serve_buckets']} serve bucket(s) profiled"
        lines.insert(len(lines) - 1, line)
    reps = report.get("replicas")
    if reps:
        lines.insert(
            len(lines) - 1,
            f"replicas       : {reps['count']} stacked, "
            f"{reps['masked']} masked, {reps['rollbacks']} rollback(s)",
        )
        for row in reps["per_replica"]:
            lines.insert(
                len(lines) - 1,
                f"  - {row.get('name') or row.get('replica')}: "
                f"{row['epochs']} epochs, "
                f"loss {_fmt(row.get('last_loss'), '.4g')}, "
                f"lr {_fmt(row.get('last_lr'), '.3g')}, "
                f"best-val {_fmt(row.get('best_val'), '.4g')}, "
                f"{row['status']}"
                + (
                    f" ({row['rollbacks']} rollback(s))"
                    if row.get("rollbacks")
                    else ""
                ),
            )
    alerts = report.get("alerts")
    if alerts:
        active = alerts.get("active") or []
        line = (
            f"slo alerts     : {alerts.get('fired', 0)} fired, "
            f"{alerts.get('resolved', 0)} resolved"
        )
        if active:
            line += " | STILL FIRING: " + ", ".join(active)
        lines.insert(len(lines) - 1, line)
        for name, row in sorted((alerts.get("rules") or {}).items()):
            lines.insert(
                len(lines) - 1,
                f"  - {name} ({row.get('slo_kind')}): "
                f"{'FIRING' if row.get('firing') else 'resolved'}, "
                f"last value {_fmt(row.get('last_value'), '.4g')} "
                f"vs threshold {_fmt(row.get('threshold'), '.4g')} "
                f"({row.get('fired', 0)} fire(s))",
            )
    gs = report.get("grad_sync") or {}
    if gs.get("collectives_per_step") is not None:
        lines.insert(
            len(lines) - 1,
            f"grad sync      : {gs['collectives_per_step']} collective(s)"
            f"/step, {_fmt_bytes(gs['grad_reduce_bytes'])} reduced/step "
            f"({gs.get('flat_buffers')} flat buffer(s))",
        )
    for w in report.get("profile_windows", []):
        lines.append(
            f"profiler trace : epochs {w['start_epoch']}..{w['end_epoch']} "
            f"-> {w['trace_dir']}"
        )
    if report["violations"]:
        lines.append("CONTRACT VIOLATIONS:")
        lines.extend(f"  - {v}" for v in report["violations"])
    else:
        lines.append("contracts      : ok")
    return "\n".join(lines)


def _render_restarts(r: dict) -> str:
    if not r or (
        not r.get("restarts")
        and not r.get("degradations")
        and not r.get("rollbacks")
    ):
        return "restarts       : none"
    parts = [f"{r.get('restarts', 0)} ({r.get('attempts', 1)} attempts)"]
    parts.append(f"lost work {_fmt(r.get('lost_work_s'), '.1f')}s")
    if r.get("rollbacks"):
        parts.append(f"{r['rollbacks']} rollback(s)")
    parts.append(f"{r.get('degradations', 0)} degradation event(s)")
    if r.get("trace_id"):
        parts.append(f"trace {r['trace_id']}")
    return "restarts       : " + ", ".join(parts)


def render_json(report: dict) -> str:
    return json.dumps(report, indent=2, default=str)
