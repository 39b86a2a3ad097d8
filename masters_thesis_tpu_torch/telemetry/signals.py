"""Typed autoscaling signals: the feed a capacity controller consumes.

Counterpart of ``masters_thesis_tpu/telemetry/signals.py``. One struct
answers "how loaded is the fleet right now, and how much headroom is
left?", from the three signal families the telemetry plane produces:

- **measured capacity** — the knee rate from the perf ledger's
  ``serve/knee_qps`` rows (the last offered rate the fleet sustained
  inside the deadline SLO): by default the port's own ledger
  (``ledger.DEFAULT_LEDGER_PATH``), never the JAX package's, whose rows
  were measured on other hardware;
- **live load** — offered QPS / p99 / shed% over the recent window, and
  the SLO alerts currently firing, from the event stream (the fold
  :mod:`watch` and :mod:`slo` share);
- **per-replica service time** — each replica's EWMA batch seconds
  (``ServiceTimeModel``), from a live ``FleetServer.stats()`` dict when
  the caller has one, else from the stream's last ``fleet_finished``.

``utilization`` is offered/knee (how much of measured capacity is in
use) and ``headroom_qps`` is what is left. Stdlib only, no torch.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path

from masters_thesis_tpu_torch.telemetry.events import read_events
from masters_thesis_tpu_torch.telemetry.ledger import (
    DEFAULT_LEDGER_PATH,
    read_ledger,
)
from masters_thesis_tpu_torch.telemetry.report import (
    EVENTS_FILENAME,
    alert_state,
)
from masters_thesis_tpu_torch.telemetry.slo import window_stats

DEFAULT_LEDGER = DEFAULT_LEDGER_PATH


@dataclass(frozen=True)
class AutoscaleSignals:
    """One consistent snapshot of load vs capacity."""

    ts: float
    #: Offered request rate over the window (None: nothing served yet).
    qps: float | None
    p99_s: float | None
    shed_pct: float | None
    #: Measured capacity: last knee from the perf ledger.
    knee_qps: float | None
    #: qps / knee_qps — fraction of measured capacity in use.
    utilization: float | None
    #: knee_qps − qps (clamped at 0) — capacity left before the knee.
    headroom_qps: float | None
    #: Per-replica EWMA service seconds (ServiceTimeModel.batch_s).
    replica_service_s: dict = field(default_factory=dict)
    live_replicas: int | None = None
    #: SLO rules firing right now — a controller should never scale
    #: DOWN while any of these is active.
    active_alerts: tuple = ()

    def wants_scale_up(self) -> bool:
        """High-utilization or actively-breaching: add capacity."""
        return bool(self.active_alerts) or (
            self.utilization is not None and self.utilization > 0.8
        )

    def wants_scale_down(self) -> bool:
        """Quiet and alert-free: capacity can be returned."""
        return (
            not self.active_alerts
            and self.utilization is not None
            and self.utilization < 0.3
        )


def knee_from_ledger(path: str | Path = DEFAULT_LEDGER) -> float | None:
    """The most recent measured knee QPS (None: no ledger, or never
    benched)."""
    knee = None
    for row in read_ledger(path):
        if row.get("point") == "serve/knee_qps" and row.get("knee_qps"):
            knee = float(row["knee_qps"])
    return knee


def _replica_service(
    fleet_stats: dict | None, events: list[dict]
) -> tuple[dict, int | None]:
    """(per-replica EWMA seconds, live count) from live stats when the
    caller holds a FleetServer, else from the stream's last stats."""
    per = (fleet_stats or {}).get("replicas")
    n_live = (fleet_stats or {}).get("n_live")
    if not per:
        for ev in events:
            if ev.get("kind") == "fleet_finished" and isinstance(
                ev.get("replicas"), dict
            ):
                per = ev["replicas"]
                n_live = ev.get("n_live", n_live)
    if not per:
        return {}, n_live
    service = {}
    for name, row in sorted(per.items()):
        batch_ms = (row or {}).get("batch_ms")
        if batch_ms is not None:
            service[name] = float(batch_ms) / 1e3
    return service, n_live


def collect_signals(
    root: str | Path,
    ledger_path: str | Path = DEFAULT_LEDGER,
    fleet_stats: dict | None = None,
    now: float | None = None,
    window_s: float = 60.0,
) -> AutoscaleSignals:
    """Build the feed from a run root's event streams + a perf ledger.

    ``fleet_stats`` (a live ``FleetServer.stats()`` dict) sharpens the
    per-replica service times when the caller is in-process with the
    fleet; everything else comes from the durable streams, so a
    controller on another host needs only the filesystem.
    """
    now = time.time() if now is None else now
    root = Path(root)
    streams = (
        [root] if root.is_file() else sorted(root.rglob(EVENTS_FILENAME))
    )
    events: list[dict] = []
    for path in streams:
        events.extend(read_events(path))
    events.sort(key=lambda e: (e.get("ts") or 0.0))
    requests = [
        (ev["ts"], ev.get("status"), ev.get("dur_s"))
        for ev in events
        if ev.get("kind") == "span"
        and ev.get("name") == "serve.request"
        and ev.get("ts") is not None
    ]
    window = window_stats(requests, now, window_s) if requests else None
    alerts = alert_state(events)
    knee = knee_from_ledger(ledger_path)
    qps = window["qps"] if window else None
    utilization = (
        qps / knee if (qps is not None and knee) else None
    )
    service, n_live = _replica_service(fleet_stats, events)
    return AutoscaleSignals(
        ts=now,
        qps=qps,
        p99_s=window["p99_s"] if window else None,
        shed_pct=window["shed_pct"] if window else None,
        knee_qps=knee,
        utilization=utilization,
        headroom_qps=(
            max(0.0, knee - qps)
            if (knee is not None and qps is not None)
            else None
        ),
        replica_service_s=service,
        live_replicas=n_live,
        active_alerts=tuple(alerts.get("active") or ()),
    )
