"""``python -m masters_thesis_tpu_torch.telemetry``: run reports from the
event streams the port writes (imports no torch).

Counterpart of ``masters_thesis_tpu/telemetry/__main__.py``.

- ``summarize <run>`` — the run report of a run directory (or an
  ``events.jsonl`` file). Exit codes: 0 ok, 1 could not load, 2 the report
  shows contract violations (the train program captured more than once,
  divergence, late answers).
- ``trace <run>`` — every stream's spans under a root (with the open spans
  a killed process left in its sidecars) as one checked span forest: the
  p50/p99 request and median epoch breakdowns, and a Chrome-trace JSON
  (``--out``, default ``<run>/trace.json``). Exit codes: 0 ok, 1 no spans,
  2 a broken span tree. ``--selfcheck`` runs a synthetic fixture instead.
- ``quality <root>`` — the model-quality report of a run's stream: the
  ``quality_sample`` folding (input and prediction PSI and KS, shadow-OLS
  disagreement), breach counts, swaps refused on quality, and the wiring
  contract (a sustained shadow breach under an SLO engine must have fired
  a ``shadow_disagreement`` alert). Exit codes: 0 ok, 1 could not load, 2
  a detector breached or the contract is violated. ``--selfcheck`` runs
  the sketch, detector and gate fixture instead.
- ``selfcheck`` — events -> report on a synthetic stream in a temporary
  directory, then the quality fixture and an SLO fixture (a burst of shed
  requests fires the burn-rate alert, which resolves once they stop).

Not ported, each exiting 1 with the ROADMAP item that holds it:
``postmortem``, ``aggregate`` and ``watch`` (fleet views, item 4),
``ledger`` (item 6).
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile

#: The subcommands this package does not have yet, and where each waits.
NOT_PORTED = {
    "postmortem": "ROADMAP.md queue 1 item 4 (fleets)",
    "aggregate": "ROADMAP.md queue 1 item 4 (fleets)",
    "watch": "ROADMAP.md queue 1 item 4 (fleets)",
    "ledger": "ROADMAP.md queue 1 item 6 (with the first BENCHMARK.json)",
}


def _summarize(args) -> int:
    from masters_thesis_tpu_torch.telemetry.report import (
        render_json,
        render_text,
        summarize_path,
    )

    try:
        report = summarize_path(args.run)
    except FileNotFoundError as exc:
        print(f"summarize: {exc}", file=sys.stderr)
        return 1
    print(render_json(report) if args.json else render_text(report))
    return 2 if report["violations"] else 0


def _trace(args) -> int:
    from pathlib import Path

    from masters_thesis_tpu_torch.telemetry import trace

    if args.selfcheck:
        return trace.selfcheck()
    if args.run is None:
        print("trace: a run root is required (or --selfcheck)",
              file=sys.stderr)
        return 1
    root = Path(args.run)
    if not root.exists():
        print(f"trace: {root} does not exist", file=sys.stderr)
        return 1
    out = args.out
    if out is None:
        out = (root.parent if root.is_file() else root) / "trace.json"
    report = trace.build_trace_report(root, out=out)
    print(json.dumps(report, indent=2, default=str) if args.json
          else trace.render_trace_text(report))
    return report["exit_code"]


def _quality(args) -> int:
    from masters_thesis_tpu_torch.telemetry import quality as quality_lib

    if args.selfcheck:
        return 0 if quality_lib.selfcheck() else 1
    if args.root is None:
        print("quality: a run root is required (or --selfcheck)",
              file=sys.stderr)
        return 1
    from masters_thesis_tpu_torch.telemetry.events import read_events
    from masters_thesis_tpu_torch.telemetry.report import resolve_events_path

    try:
        events = read_events(resolve_events_path(args.root))
    except FileNotFoundError as exc:
        print(f"quality: {exc}", file=sys.stderr)
        return 1
    report = quality_lib.quality_report(events)
    violations = quality_lib.quality_violations(events, report)
    if args.json:
        print(json.dumps({"quality": report, "violations": violations},
                         indent=2, default=str))
    else:
        print(quality_lib.render_quality(report))
        for v in violations:
            print(f"CONTRACT VIOLATION: {v}")
    breached = any((report.get("breaches") or {}).values())
    return 2 if (violations or breached) else 0


def slo_selfcheck() -> bool:
    """An SLO engine driven by ticks over a synthetic request stream: 40
    ok requests, then 40 shed ones fire the burn-rate alert (both windows
    past 2x the budget), and 200 ok ones after them resolve it; both
    transitions are written back into the stream."""
    from pathlib import Path

    from masters_thesis_tpu_torch.telemetry.events import EventSink, read_events
    from masters_thesis_tpu_torch.telemetry.slo import SLOEngine, SLORule

    rule = SLORule("burn", "burn_rate", threshold=2.0, target=0.99,
                   fast_window_s=10.0, slow_window_s=60.0)
    with tempfile.TemporaryDirectory() as tmp:
        stream = Path(tmp) / "serve" / "events.jsonl"
        stream.parent.mkdir()
        alerts = EventSink(Path(tmp) / "alerts.jsonl", run_id="slo-alerts")
        engine = SLOEngine(stream.parent, rules=[rule], sink=alerts)
        firing = []

        def serve(start: float, n: int, status: str) -> float:
            with open(stream, "a", encoding="utf-8") as f:
                for i in range(n):
                    f.write(json.dumps({
                        "ts": start + 0.05 * i, "kind": "span",
                        "name": "serve.request", "status": status,
                        "dur_s": 0.01}) + "\n")
            return start + 0.05 * n

        t = serve(1000.0, 40, "ok")
        firing.append(engine.tick(now=t)["firing"])
        t = serve(t, 40, "shed")
        firing.append(engine.tick(now=t)["firing"])
        t = serve(t + 60.0, 200, "ok")
        firing.append(engine.tick(now=t)["firing"])
        firing.append(engine.tick(now=t + 0.5)["firing"])
        alerts.close()
        kinds = [e["kind"] for e in read_events(Path(tmp) / "alerts.jsonl")]
    ok = (firing == [[], ["burn"], ["burn"], []]
          and kinds == ["alert_fired", "alert_resolved"])
    print("slo selfcheck: " + ("ok" if ok else f"FAILED: firing={firing} "
                               f"events={kinds}"))
    return ok


def _selfcheck(args) -> int:
    from masters_thesis_tpu_torch.telemetry.report import summarize_path
    from masters_thesis_tpu_torch.telemetry.run import TelemetryRun

    with tempfile.TemporaryDirectory() as tmp:
        tel = TelemetryRun(tmp, run_id="selfcheck")
        tel.event(
            "run_started", platform="cpu", n_devices=1, strategy="selfcheck",
            epoch_mode="scan", steps_per_epoch=4,
        )
        for epoch in range(3):
            tel.event(
                "epoch", epoch=epoch, steps=4, wall_s=0.4 if epoch else 2.0,
                dispatch_s=0.01, device_s=0.38 if epoch else None,
                data_wait_s=0.0, compile_events=0 if epoch else 1,
                compiled=not epoch, fenced=True, steps_per_sec=10.0,
            )
            tel.histogram("train/epoch_wall_s").observe(0.4)
        tel.event(
            "run_finished", epochs=3, total_steps=12, steps_per_sec=10.0,
            diverged=False, best_val=0.5, epoch_compiles=1, eval_compiles=1,
        )
        tel.snapshot_metrics()
        tel.close()
        report = summarize_path(tmp)
    ok = (
        report["compiles"]["train_epoch"] == 1
        and report["steps_per_sec"] == 10.0
        and report["step_time_ms"]["p50"] is not None
        and not report["violations"]
    )
    print("telemetry: selfcheck " + ("ok" if ok else f"FAILED: {report}"))
    from masters_thesis_tpu_torch.telemetry import quality as quality_lib

    quality_ok = quality_lib.selfcheck()
    slo_ok = slo_selfcheck()
    return 0 if ok and quality_ok and slo_ok else 1


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in NOT_PORTED:
        print(f"{argv[0]}: not ported yet ({NOT_PORTED[argv[0]]})",
              file=sys.stderr)
        return 1
    parser = argparse.ArgumentParser(
        prog="python -m masters_thesis_tpu_torch.telemetry",
        description="run reports over the port's event streams",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    p_sum = sub.add_parser(
        "summarize", help="render a run report from a run dir's events.jsonl")
    p_sum.add_argument("run", help="run directory (or events.jsonl file)")
    p_sum.add_argument("--json", action="store_true",
                       help="machine-readable report")
    p_sum.set_defaults(fn=_summarize)
    p_trace = sub.add_parser(
        "trace", help="merged span timeline + attribution; exit 2 on a "
                      "broken span tree")
    p_trace.add_argument("run", nargs="?", default=None,
                         help="run root (every events.jsonl under it)")
    p_trace.add_argument("--json", action="store_true",
                         help="machine-readable report")
    p_trace.add_argument("--out", default=None, metavar="PATH",
                         help="Chrome-trace JSON output "
                              "(default <run>/trace.json)")
    p_trace.add_argument("--selfcheck", action="store_true",
                         help="synthetic span fixture instead of a run")
    p_trace.set_defaults(fn=_trace)
    p_quality = sub.add_parser(
        "quality", help="model-quality report; exit 2 on a breach or a "
                        "broken wiring contract")
    p_quality.add_argument("root", nargs="?", default=None,
                           help="run directory (or events.jsonl file)")
    p_quality.add_argument("--json", action="store_true",
                           help="machine-readable report")
    p_quality.add_argument("--selfcheck", action="store_true",
                           help="hermetic sketch/detector/gate fixture")
    p_quality.set_defaults(fn=_quality)
    p_check = sub.add_parser("selfcheck",
                             help="events -> report, quality and SLO smoke")
    p_check.set_defaults(fn=_selfcheck)
    for name, item in NOT_PORTED.items():
        sub.add_parser(name, help=f"not ported ({item})")
    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:  # summarize | head closed the pipe
        sys.exit(0)
