"""The perf ledger: an append-only JSONL history of measured points.

Counterpart of ``masters_thesis_tpu/telemetry/ledger.py``, with the same
names, schema and gate. One schema-versioned row per measured point (git
rev, platform, mesh shape, pack width, FLOPs, steps/s, utilization, and
any extra fields), appended round by round and diffed by ``python -m
masters_thesis_tpu_torch.telemetry ledger``, which exits 2 when the
latest round regresses a gated metric (steps/s, utilization, cells/hour,
the serving knee, or restart time) by more than 15% against the baseline
window AT EQUAL CONFIG (same point, platform, mesh, batch size, objective
and pack width; a CPU round is never compared against a GPU baseline).

The port's rows go to their own file, ``results/perf_ledger_torch.jsonl``
(``DEFAULT_LEDGER_PATH``), never to the JAX package's
``results/perf_ledger.jsonl``: the two hold measurements of different
programs on different hardware.

Stdlib only, like :mod:`report`: the ledger CLI runs where torch cannot
be imported (operator machines, CI).
"""

from __future__ import annotations

import json
import subprocess
import time
from pathlib import Path

LEDGER_SCHEMA_VERSION = 1
#: The port's own ledger, relative to the working directory.
DEFAULT_LEDGER_PATH = Path("results") / "perf_ledger_torch.jsonl"
#: Regression gate: a latest-round gated metric moving more than this
#: far in its bad direction vs the baseline median (equal config) exits 2.
REGRESSION_PCT = 15.0

#: Gated metrics and their good direction: +1 = higher is better (a drop
#: regresses), -1 = lower is better (a rise regresses — restart time).
#: serve/knee_qps and serve/restart_s rows ride the same gate as the
#: training throughput rows.
GATED_METRICS = (
    ("steps_per_sec", +1),
    ("utilization_pct", +1),
    ("cells_per_hour", +1),
    ("knee_qps", +1),
    ("restart_s", -1),
)

#: The fields that define "equal config" — a row is only ever compared
#: against baseline rows agreeing on ALL of these.
CONFIG_KEYS = (
    "point",
    "platform",
    "mesh_shape",
    "batch_size",
    "objective",
    "pack_width",
)


def git_rev(repo_root: Path | None = None) -> str | None:
    """Short git revision of the repo, or None outside a checkout."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=repo_root or Path(__file__).resolve().parents[2],
            capture_output=True,
            text=True,
            timeout=10,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    rev = out.stdout.strip()
    return rev if out.returncode == 0 and rev else None


def ledger_record(
    *,
    point: str,
    round_id: str,
    platform: str | None,
    steps_per_sec: float | None,
    objective: str | None = None,
    batch_size: int | None = None,
    mesh_shape: list[int] | None = None,
    pack_width: int | None = None,
    flops_per_step: float | None = None,
    bytes_per_step: float | None = None,
    peak_memory_bytes: int | None = None,
    utilization_pct: float | None = None,
    regime: str | None = None,
    rev: str | None = None,
    ts: float | None = None,
    **extra,
) -> dict:
    """One schema-versioned ledger row. Unknown fields ride in ``extra``."""
    rec = {
        "schema": LEDGER_SCHEMA_VERSION,
        "ts": time.time() if ts is None else ts,
        "round": round_id,
        "git_rev": rev if rev is not None else git_rev(),
        "point": point,
        "platform": platform,
        "objective": objective,
        "batch_size": batch_size,
        "mesh_shape": mesh_shape,
        "pack_width": pack_width,
        "steps_per_sec": steps_per_sec,
        "flops_per_step": flops_per_step,
        "bytes_per_step": bytes_per_step,
        "peak_memory_bytes": peak_memory_bytes,
        "utilization_pct": utilization_pct,
        "regime": regime,
    }
    rec.update(extra)
    return rec


def append_record(path: str | Path, record: dict) -> None:
    """Append one row; parents are created, the file never rewritten."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("a", encoding="utf-8") as fh:
        fh.write(json.dumps(record, default=str) + "\n")


def read_ledger(path: str | Path) -> list[dict]:
    """All parseable rows, in file order; torn tails are tolerated (a
    killed bench run must not corrupt the whole history)."""
    path = Path(path)
    if not path.is_file():
        return []
    rows: list[dict] = []
    with path.open("r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(obj, dict):
                rows.append(obj)
    return rows


def config_key(rec: dict) -> tuple:
    def _norm(v):
        return tuple(v) if isinstance(v, list) else v

    return tuple(_norm(rec.get(k)) for k in CONFIG_KEYS)


def _round_order(rows: list[dict]) -> list[str]:
    """Distinct round ids ordered by first appearance (the file is
    append-only, so file order IS time order)."""
    seen: list[str] = []
    for rec in rows:
        rid = rec.get("round")
        if rid is not None and rid not in seen:
            seen.append(rid)
    return seen


def _median(values: list[float]) -> float | None:
    vals = sorted(v for v in values if v is not None)
    if not vals:
        return None
    mid = len(vals) // 2
    if len(vals) % 2:
        return vals[mid]
    return 0.5 * (vals[mid - 1] + vals[mid])


def ledger_diff(
    rows: list[dict],
    *,
    threshold_pct: float = REGRESSION_PCT,
    baseline_rounds: int | None = None,
) -> dict:
    """Diff the latest round against the baseline window, at equal config.

    For every config measured in the latest round, the baseline is the
    MEDIAN over all earlier rounds' rows with the same config key (or the
    last ``baseline_rounds`` of them). A config with no baseline is
    reported as new, never as a regression. Exit semantics live in
    ``report["regressed"]`` — True when any ``GATED_METRICS`` entry moved
    more than ``threshold_pct`` in its bad direction (a drop for
    throughput-like metrics, a rise for restart time).
    """
    order = _round_order(rows)
    if not order:
        return {
            "rounds": 0,
            "latest_round": None,
            "compared": [],
            "new_configs": [],
            "regressions": [],
            "regressed": False,
            "threshold_pct": threshold_pct,
        }
    latest = order[-1]
    baseline_ids = order[:-1]
    if baseline_rounds is not None:
        baseline_ids = baseline_ids[-baseline_rounds:]
    latest_rows = [r for r in rows if r.get("round") == latest]
    base_rows = [r for r in rows if r.get("round") in set(baseline_ids)]
    by_key: dict[tuple, list[dict]] = {}
    for rec in base_rows:
        by_key.setdefault(config_key(rec), []).append(rec)

    compared: list[dict] = []
    new_configs: list[dict] = []
    regressions: list[dict] = []
    for rec in latest_rows:
        key = config_key(rec)
        baseline = by_key.get(key)
        if not baseline:
            new_configs.append({"point": rec.get("point"), "config": key})
            continue
        row = {
            "point": rec.get("point"),
            "platform": rec.get("platform"),
            "batch_size": rec.get("batch_size"),
            "baseline_rounds": len({b.get("round") for b in baseline}),
        }
        regressed_metrics: list[str] = []
        for metric, direction in GATED_METRICS:
            latest_v = rec.get(metric)
            base_v = _median([b.get(metric) for b in baseline])
            row[metric] = {"latest": latest_v, "baseline": base_v}
            if latest_v is None or base_v is None or base_v <= 0:
                continue
            delta_pct = 100.0 * (latest_v - base_v) / base_v
            row[metric]["delta_pct"] = round(delta_pct, 2)
            if direction * delta_pct < -threshold_pct:
                regressed_metrics.append(metric)
        row["regressed_metrics"] = regressed_metrics
        compared.append(row)
        if regressed_metrics:
            regressions.append(row)
    return {
        "rounds": len(order),
        "latest_round": latest,
        "baseline_window": baseline_ids,
        "compared": compared,
        "new_configs": new_configs,
        "regressions": regressions,
        "regressed": bool(regressions),
        "threshold_pct": threshold_pct,
    }


def diff_path(
    path: str | Path,
    *,
    threshold_pct: float = REGRESSION_PCT,
    baseline_rounds: int | None = None,
) -> dict:
    report = ledger_diff(
        read_ledger(path),
        threshold_pct=threshold_pct,
        baseline_rounds=baseline_rounds,
    )
    report["path"] = str(path)
    return report


def _fmt(value, spec: str = ".3g") -> str:
    return "n/a" if value is None else format(value, spec)


def render_ledger_text(report: dict) -> str:
    lines = [
        f"ledger         : {report.get('path', '?')} "
        f"({report['rounds']} round(s))",
    ]
    if not report["rounds"]:
        lines.append("verdict        : empty ledger — nothing to gate")
        return "\n".join(lines)
    lines.append(
        f"latest round   : {report['latest_round']} vs "
        f"{len(report.get('baseline_window') or [])} baseline round(s), "
        f"threshold {report['threshold_pct']:.0f}%"
    )
    for row in report["compared"]:
        sps = row["steps_per_sec"]
        util = row["utilization_pct"]
        mark = " <-- REGRESSED" if row["regressed_metrics"] else ""
        line = (
            f"  {row['point']:<16s} [{row.get('platform') or '?'}] "
            f"sps {_fmt(sps['latest'], '.2f')} vs {_fmt(sps['baseline'], '.2f')}"
            f" ({_fmt(sps.get('delta_pct'), '+.1f')}%) | "
            f"util {_fmt(util['latest'], '.3f')}% vs "
            f"{_fmt(util['baseline'], '.3f')}%"
            f" ({_fmt(util.get('delta_pct'), '+.1f')}%)"
        )
        for metric, label, spec in (
            ("cells_per_hour", "cells/h", ".1f"),
            ("knee_qps", "knee", ".1f"),
            ("restart_s", "restart", ".3f"),
        ):
            m = row.get(metric) or {}
            if m.get("latest") is not None:
                line += (
                    f" | {label} {_fmt(m['latest'], spec)} vs "
                    f"{_fmt(m['baseline'], spec)}"
                    f" ({_fmt(m.get('delta_pct'), '+.1f')}%)"
                )
        lines.append(line + mark)
    for row in report["new_configs"]:
        lines.append(f"  {row['point']:<16s} new config (no baseline)")
    if report["regressed"]:
        lines.append(
            f"verdict        : REGRESSION — {len(report['regressions'])} "
            f"config(s) dropped >{report['threshold_pct']:.0f}% vs baseline"
        )
    elif report["compared"]:
        lines.append("verdict        : ok — no regression at equal config")
    else:
        lines.append(
            "verdict        : no comparable configs (first round, or "
            "config drift) — nothing to gate"
        )
    return "\n".join(lines)
