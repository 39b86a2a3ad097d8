"""Live fleet watch console: incremental merge of running event streams.

Counterpart of ``masters_thesis_tpu/telemetry/watch.py``.
``python -m masters_thesis_tpu_torch.telemetry watch <root>`` tails every
``events.jsonl`` under a root *while the fleet is writing them* and
renders one screen per refresh: per-rank/per-replica status, offered
QPS / p99 / shed over the recent window, the fleet generation, and the
SLO alerts currently firing.

The console shares the fleet reconstruction with the post-hoc tools
rather than duplicating it: each stream's accumulated events are folded
through :func:`~.aggregate.digest_events` (the same digest the
``aggregate`` / ``postmortem`` CLIs build from a full read) and merged
with :func:`~.aggregate.aggregate_streams` — so what the live console
says about a rank is, by construction, what the postmortem will say
once the run ends. The only difference is HOW the events arrive: the
tail-cursor reader (:func:`~.events.read_new_lines`) feeds each refresh
only the bytes appended since the last one, so a refresh over a
long-running fleet costs the tail, not the history.

It imports no torch, like every CLI of this package: the console must
run while the card's runtime is wedged.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

from masters_thesis_tpu_torch.telemetry.aggregate import (
    DEFAULT_GRACE_S,
    aggregate_streams,
    digest_events,
)
from masters_thesis_tpu_torch.telemetry.events import read_new_lines
from masters_thesis_tpu_torch.telemetry.quality import (
    quality_report,
    render_quality,
)
from masters_thesis_tpu_torch.telemetry.report import EVENTS_FILENAME, alert_state
from masters_thesis_tpu_torch.telemetry.slo import window_stats

#: Replica lifecycle kinds the per-replica panel is folded from.
_REPLICA_KINDS = ("replica_started", "replica_dead", "replica_halted")


class FleetWatch:
    """Incremental fleet state: cursors + accumulated events per stream.

    Single-threaded by design (one console, one reader); every refresh
    re-digests only the streams whose cursor moved.
    """

    def __init__(
        self,
        root: str | Path,
        grace_s: float = DEFAULT_GRACE_S,
        window_s: float = 60.0,
    ):
        self.root = Path(root)
        self.grace_s = grace_s
        self.window_s = window_s
        self._cursors: dict[Path, int] = {}
        self._events: dict[Path, list[dict]] = {}
        self._digests: dict[Path, dict] = {}

    def _discover(self) -> list[Path]:
        if self.root.is_file():
            return [self.root]
        return sorted(self.root.rglob(EVENTS_FILENAME))

    def refresh(self, now: float | None = None) -> dict:
        """Tail every stream, re-digest what changed, build the snapshot."""
        now = time.time() if now is None else now
        for path in self._discover():
            cursor = self._cursors.get(path, 0)
            new, moved = read_new_lines(path, cursor)
            acc = self._events.setdefault(path, [])
            if new:
                acc.extend(new)
            if new or path not in self._digests:
                self._digests[path] = digest_events(acc, path, self.root)
            self._cursors[path] = moved
        # aggregate_streams stamps status and (for multi-generation
        # fleets) rewrites labels in place — feed it copies so the cached
        # digests stay pristine across refreshes.
        report = aggregate_streams(
            [dict(d) for d in self._digests.values()],
            now=now,
            grace_s=self.grace_s,
        ) if self._digests else None
        merged = self._merged_events()
        return {
            "ts": now,
            "root": str(self.root),
            "streams": len(self._digests),
            "report": report,
            "serve": self._serve_window(merged, now),
            "alerts": alert_state(merged),
            "replicas": replica_state(merged),
            "quality": quality_report(merged),
        }

    def _merged_events(self) -> list[dict]:
        merged = [
            ev for events in self._events.values() for ev in events
        ]
        merged.sort(key=lambda e: (e.get("ts") or 0.0))
        return merged

    def _serve_window(self, merged: list[dict], now: float) -> dict | None:
        requests = [
            (ev["ts"], ev.get("status"), ev.get("dur_s"))
            for ev in merged
            if ev.get("kind") == "span"
            and ev.get("name") == "serve.request"
            and ev.get("ts") is not None
        ]
        if not requests:
            return None
        return window_stats(requests, now, self.window_s)


def replica_state(events: list[dict]) -> dict | None:
    """Per-replica serving status from the fleet's lifecycle events."""
    per: dict[str, dict] = {}
    for ev in events:
        kind = ev.get("kind")
        if kind not in _REPLICA_KINDS:
            continue
        name = ev.get("replica")
        if not name:
            continue
        row = per.setdefault(
            name,
            {"replica": name, "state": "unknown", "restarts": 0,
             "cause": None},
        )
        if kind == "replica_started":
            row["state"] = "live"
            if ev.get("restart"):
                row["restarts"] += 1
        elif kind == "replica_dead":
            row["state"] = "dead"
            row["cause"] = ev.get("cause")
        elif kind == "replica_halted":
            row["state"] = "halted"
    if not per:
        return None
    return {
        "replicas": {name: per[name] for name in sorted(per)},
        "live": sum(1 for r in per.values() if r["state"] == "live"),
    }


# ------------------------------------------------------------- rendering


def _fmt(value, spec: str = ".3g") -> str:
    return "n/a" if value is None else format(value, spec)


def render_watch(snapshot: dict) -> str:
    """One console frame from a :meth:`FleetWatch.refresh` snapshot."""
    lines = [
        f"watch          : {snapshot['root']} | "
        f"{snapshot['streams']} stream(s) | "
        f"{time.strftime('%H:%M:%S', time.localtime(snapshot['ts']))}"
    ]
    report = snapshot.get("report")
    if report is None:
        lines.append("  (no event streams yet)")
        return "\n".join(lines)
    if report.get("fleet_generation") is not None:
        lines.append(
            f"generation     : g{report['fleet_generation']} "
            f"({report.get('generations')} generation(s), "
            f"{len(report.get('resizes') or [])} resize(s))"
        )
    for d in report["processes"]:
        gap = (report.get("heartbeat_gaps_s") or {}).get(d["label"])
        lines.append(
            f"  {d['label']:<8s} {d['status']:<10s} host={d['host']} "
            f"epochs={d['epochs']} "
            f"sps={_fmt(d.get('steps_per_sec'), '.2f')} "
            f"gap={_fmt(gap, '.1f')}s"
        )
    serve = snapshot.get("serve")
    if serve:
        lines.append(
            f"serving        : qps {serve['qps']:.1f} | "
            f"p99 {_fmt(None if serve['p99_s'] is None else serve['p99_s'] * 1e3, '.2f')}ms | "
            f"shed {serve['shed_pct']:.1f}% "
            f"({serve['n']} request(s) in window)"
        )
    replicas = snapshot.get("replicas")
    if replicas:
        per = ", ".join(
            f"{name} {row['state']}"
            + (f" x{row['restarts']} restart(s)" if row["restarts"] else "")
            for name, row in replicas["replicas"].items()
        )
        lines.append(
            f"replicas       : {replicas['live']}/"
            f"{len(replicas['replicas'])} live | {per}"
        )
    quality = snapshot.get("quality")
    if quality and (
        quality.get("samples") or quality.get("swaps_rejected_quality")
    ):
        lines.append(render_quality(quality))
    alerts = snapshot.get("alerts") or {}
    active = alerts.get("active") or []
    if active:
        lines.append(f"ALERTS FIRING  : {', '.join(active)}")
        for name in active:
            row = alerts["rules"][name]
            since = row.get("since_ts")
            age = (
                f"{snapshot['ts'] - since:.0f}s ago"
                if since is not None else "n/a"
            )
            lines.append(
                f"  - {name} ({row.get('slo_kind')}): value "
                f"{_fmt(row.get('last_value'), '.4g')} > threshold "
                f"{_fmt(row.get('threshold'), '.4g')}, fired {age}"
            )
    else:
        lines.append(
            "alerts         : none firing"
            + (
                f" ({alerts.get('resolved')} resolved)"
                if alerts.get("resolved")
                else ""
            )
        )
    if report.get("failures"):
        lines.append("failures       :")
        lines.extend(f"  - {f}" for f in report["failures"][:4])
    else:
        lines.append("fleet health   : ok")
    return "\n".join(lines)


def run_watch(
    root: str | Path,
    once: bool = False,
    interval_s: float = 2.0,
    grace_s: float = DEFAULT_GRACE_S,
    out=None,
) -> int:
    """The ``watch`` CLI loop; ``once`` renders a single snapshot."""
    out = sys.stdout if out is None else out
    watch = FleetWatch(root, grace_s=grace_s)
    if once:
        print(render_watch(watch.refresh()), file=out)
        return 0
    try:
        while True:
            frame = render_watch(watch.refresh())
            # Clear + home between frames so the console reads as one
            # live screen rather than a scroll.
            print("\x1b[2J\x1b[H" + frame, file=out, flush=True)
            time.sleep(interval_s)
    except KeyboardInterrupt:
        return 0


def selfcheck() -> int:
    """Hermetic watch smoke: fabricate a 2-process fleet (one rank
    behind), a serve window, and a fired-then-unresolved alert; the
    rendered snapshot must show all three."""
    import os
    import tempfile

    from masters_thesis_tpu_torch.telemetry.run import TelemetryRun

    saved = {
        k: os.environ.get(k)
        for k in ("JAX_PROCESS_INDEX", "JAX_PROCESS_COUNT")
    }
    failures: list[str] = []
    try:
        with tempfile.TemporaryDirectory() as tmp:
            root = Path(tmp)
            now = time.time()
            for rank in range(2):
                os.environ["JAX_PROCESS_INDEX"] = str(rank)
                os.environ["JAX_PROCESS_COUNT"] = "2"
                tel = TelemetryRun(
                    root / f"p{rank}", run_id=f"watch-p{rank}"
                )
                tel.event(
                    "run_started", platform="cpu", n_devices=1,
                    strategy="selfcheck", epoch_mode="scan",
                    steps_per_epoch=4,
                )
                for epoch in range(3):
                    tel.event(
                        "epoch", epoch=epoch, steps=4,
                        wall_s=0.4 + 0.2 * rank, dispatch_s=0.01,
                        device_s=None, data_wait_s=0.0, compile_events=0,
                        compiled=False, fenced=False, steps_per_sec=8.0,
                    )
                if rank == 0:
                    for i in range(10):
                        tel.event(
                            "span", name="serve.request", cat="serve",
                            span_id=f"r{i}", start_ts=now - 1.0,
                            dur_s=0.01,
                            status="ok" if i < 9 else "shed",
                        )
                    tel.event(
                        "alert_fired", rule="error-budget-burn",
                        slo_kind="burn_rate", value=5.0, threshold=2.0,
                        burn_fast=5.0, burn_slow=4.0, active_s=None,
                    )
                    tel.event(
                        "quality_sample", sampled=7, scored=True,
                        input_psi=0.31, input_ks=0.2, pred_psi=0.05,
                        pred_ks=0.04, shadow_err=0.12, shadow_thr=0.5,
                        input_thr=0.25, pred_thr=0.25,
                        input_breached=True, pred_breached=False,
                        shadow_breached=False,
                    )
                    tel.event(
                        "run_finished", epochs=3, total_steps=12,
                        steps_per_sec=8.0, diverged=False, best_val=0.5,
                        epoch_compiles=1, eval_compiles=0,
                    )
                tel.close()
            snap = FleetWatch(root).refresh()
            frame = render_watch(snap)
            if snap["streams"] != 2:
                failures.append(f"saw {snap['streams']} streams, wanted 2")
            if (snap["alerts"] or {}).get("active") != [
                "error-budget-burn"
            ]:
                failures.append(
                    f"active alerts {snap['alerts'].get('active')!r}"
                )
            if snap["serve"] is None or snap["serve"]["n"] != 10:
                failures.append(f"serve window {snap['serve']!r}")
            if (snap.get("quality") or {}).get("samples") != 1:
                failures.append(f"quality section {snap.get('quality')!r}")
            for needle in ("ALERTS FIRING", "error-budget-burn", "p0",
                           "p1", "serving", "QUALITY"):
                if needle not in frame:
                    failures.append(f"frame missing {needle!r}")
            # A second refresh must be incremental: cursors already at
            # EOF, nothing re-read, identical fleet view.
            watch2 = FleetWatch(root)
            watch2.refresh()
            cursors = dict(watch2._cursors)
            snap2 = watch2.refresh()
            if watch2._cursors != cursors:
                failures.append("cursors moved with no new events")
            if snap2["streams"] != 2:
                failures.append("incremental refresh lost streams")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if failures:
        print("telemetry: watch selfcheck FAILED: " + "; ".join(failures))
        return 1
    print("telemetry: watch selfcheck ok")
    return 0
