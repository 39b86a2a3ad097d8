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
- ``aggregate <root>`` — every rank's ``events.jsonl`` under a root (a
  fleet supervisor's run dir: ``g<gen>/p<rank>/`` and ``supervisor/``)
  folded into one fleet view (``telemetry/aggregate.py``): epoch-time skew,
  the straggler, collective wait, heartbeat gaps, each rank's status, the
  generations and the schedule audit. Exit codes: 0 ok, 1 could not load,
  2 the fleet has failures.
- ``postmortem <root>`` — the same view led by a one-line verdict on how
  the run ended (which rank died, hung or straggled, and where). Exit 2
  when a rank died, hung or stalled, or the schedules diverged.
  ``--selfcheck`` runs a hermetic two-rank fixture instead (a healthy
  fleet exits 0, one whose p1 hung and dumped exits 2 naming p1).
- ``selfcheck`` — events -> report on a synthetic stream in a temporary
  directory, then the quality fixture and an SLO fixture (a burst of shed
  requests fires the burn-rate alert, which resolves once they stop).

- ``watch <root>`` — the live fleet console (``telemetry/watch.py``):
  tails every ``events.jsonl`` under a root while it is written and
  renders per-rank and per-replica status, the serving window (QPS, p99,
  shed), the generation and the SLO alerts firing. ``--once`` renders one
  frame, ``--json`` one snapshot; ``--selfcheck`` runs a hermetic
  two-process fixture instead.
- ``ledger [path]`` — diff the perf ledger's latest round (default
  ``results/perf_ledger_torch.jsonl``, the port's own) against its
  baseline window at equal config (``telemetry/ledger.py``). Exit codes: 0
  ok or nothing to gate, 1 the file does not exist, 2 a gated metric
  regressed past ``--threshold``. ``--selfcheck`` fabricates a steady
  two-round ledger, a round 30% slower and a config drift, and checks the
  gate on each.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile

from masters_thesis_tpu_torch.telemetry.ledger import (
    DEFAULT_LEDGER_PATH,
    REGRESSION_PCT,
)


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


def _aggregate(args) -> int:
    from masters_thesis_tpu_torch.telemetry.aggregate import (
        aggregate_path,
        render_fleet_text,
    )

    try:
        report = aggregate_path(args.root, grace_s=args.grace)
    except FileNotFoundError as exc:
        print(f"aggregate: {exc}", file=sys.stderr)
        return 1
    print(json.dumps(report, indent=2, default=str) if args.json
          else render_fleet_text(report))
    return 0 if report["healthy"] else 2


def _watch(args) -> int:
    from masters_thesis_tpu_torch.telemetry import watch

    if args.selfcheck:
        return watch.selfcheck()
    if args.root is None:
        print("watch: a run root is required (or --selfcheck)",
              file=sys.stderr)
        return 1
    if args.json:
        w = watch.FleetWatch(args.root, grace_s=args.grace)
        print(json.dumps(w.refresh(), indent=2, default=str))
        return 0
    return watch.run_watch(args.root, once=args.once,
                           interval_s=args.interval, grace_s=args.grace)


def _postmortem(args) -> int:
    if args.selfcheck:
        return postmortem_selfcheck()
    if args.root is None:
        print("postmortem: a run root is required (or --selfcheck)",
              file=sys.stderr)
        return 1
    from masters_thesis_tpu_torch.telemetry.aggregate import (
        postmortem_path,
        render_fleet_text,
    )

    try:
        report = postmortem_path(args.root, grace_s=args.grace)
    except FileNotFoundError as exc:
        print(f"postmortem: {exc}", file=sys.stderr)
        return 1
    print(json.dumps(report, indent=2, default=str) if args.json
          else render_fleet_text(report, postmortem=True))
    return report["exit_code"]


def postmortem_selfcheck() -> int:
    """Two fabricated 2-rank runs: a healthy one must aggregate to exit 0
    over 3 shared epochs, and one whose p1 hung and dumped must exit 2
    with a headline naming p1, its status ``hung``."""
    import os
    from pathlib import Path

    from masters_thesis_tpu_torch.telemetry.aggregate import postmortem_path
    from masters_thesis_tpu_torch.telemetry.flightrec import FlightRecorder
    from masters_thesis_tpu_torch.telemetry.run import TelemetryRun

    def write_stream(root: Path, rank: int, epochs: int, finish: bool,
                     wall: float) -> TelemetryRun:
        os.environ["JAX_PROCESS_INDEX"] = str(rank)
        os.environ["JAX_PROCESS_COUNT"] = "2"
        tel = TelemetryRun(root / f"p{rank}", run_id=f"selfcheck-p{rank}")
        tel.event("run_started", platform="cpu", n_devices=1,
                  strategy="selfcheck", epoch_mode="scan", steps_per_epoch=4)
        for epoch in range(epochs):
            tel.event("epoch", epoch=epoch, steps=4, wall_s=wall,
                      dispatch_s=0.01, device_s=None, data_wait_s=0.0,
                      compile_events=0, compiled=False, fenced=False,
                      steps_per_sec=4.0 / wall)
        if finish:
            tel.event("run_finished", epochs=epochs, total_steps=4 * epochs,
                      steps_per_sec=4.0 / wall, diverged=False,
                      best_val=0.5, epoch_compiles=1, eval_compiles=0)
        return tel

    saved = {k: os.environ.get(k)
             for k in ("JAX_PROCESS_INDEX", "JAX_PROCESS_COUNT")}
    failures: list[str] = []
    try:
        with tempfile.TemporaryDirectory() as tmp:
            healthy = Path(tmp) / "healthy"
            for rank in range(2):
                write_stream(healthy, rank, epochs=3, finish=True,
                             wall=0.4 + 0.01 * rank).close()
            report = postmortem_path(healthy)
            if report["exit_code"] != 0:
                failures.append(f"healthy fleet exited {report['exit_code']}"
                                f": {report['failures']}")
            if report["epoch_skew"]["epochs_compared"] != 3:
                failures.append(
                    f"expected 3 shared epochs, got {report['epoch_skew']}")

            wedged = Path(tmp) / "wedged"
            write_stream(wedged, 0, epochs=3, finish=True, wall=0.4).close()
            tel = write_stream(wedged, 1, epochs=2, finish=False, wall=0.4)
            rec = FlightRecorder(
                tel.run_dir, run_id=tel.run_id, sink=tel.sink,
                heartbeat_interval_s=60.0, install_signal_handlers=False,
                enable_faulthandler=False,
            )
            rec.beat(phase="train", epoch=2)
            rec.dump("hang: no progress beat for 9.9s (selfcheck)")
            rec.close()
            tel.close()
            report = postmortem_path(wedged)
            if report["exit_code"] != 2:
                failures.append(
                    f"wedged fleet exited {report['exit_code']}, wanted 2")
            if "p1" not in report["headline"]:
                failures.append(
                    f"headline does not name p1: {report['headline']!r}")
            statuses = {d["label"]: d["status"] for d in report["processes"]}
            if statuses.get("p1") != "hung":
                failures.append(f"p1 status {statuses.get('p1')!r} != 'hung'")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if failures:
        print("telemetry: postmortem selfcheck FAILED: " + "; ".join(failures))
        return 1
    print("telemetry: postmortem selfcheck ok")
    return 0


def _ledger(args) -> int:
    if args.selfcheck:
        return ledger_selfcheck()
    from pathlib import Path

    from masters_thesis_tpu_torch.telemetry.ledger import (
        diff_path,
        render_ledger_text,
    )

    path = Path(args.path)
    if not path.exists():
        print(f"ledger: {path} does not exist", file=sys.stderr)
        return 1
    report = diff_path(path, threshold_pct=args.threshold,
                       baseline_rounds=args.baseline)
    print(json.dumps(report, indent=2, default=str) if args.json
          else render_ledger_text(report))
    return 2 if report["regressed"] else 0


def ledger_selfcheck() -> int:
    """The gate on three fabricated ledgers: a steady two-round one must
    pass and compare its config, a third round 30% slower at equal config
    must regress steps/s and utilization exactly, and a changed batch size
    must be a new config, never a regression."""
    from pathlib import Path

    from masters_thesis_tpu_torch.telemetry.ledger import (
        append_record,
        diff_path,
        ledger_record,
        read_ledger,
    )

    failures: list[str] = []
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "perf_ledger.jsonl"

        def point(round_id, sps, util, ts):
            return ledger_record(
                point="scan_bs2", round_id=round_id, platform="cpu",
                steps_per_sec=sps, batch_size=2, mesh_shape=[8],
                pack_width=4, objective="mse", flops_per_step=1.6e5,
                bytes_per_step=7.2e5, utilization_pct=util,
                regime="memory-bound", rev="deadbee", ts=ts,
            )

        append_record(path, point("r1", 100.0, 4.0, 1.0))
        append_record(path, point("r2", 98.0, 3.9, 2.0))
        if len(read_ledger(path)) != 2:
            failures.append("append/read round-trip lost rows")
        report = diff_path(path)
        if report["regressed"] or report["rounds"] != 2:
            failures.append(f"steady ledger flagged regressed: {report}")
        if not report["compared"]:
            failures.append("equal-config rounds were not compared")

        append_record(path, point("r3", 60.0, 2.4, 3.0))
        report = diff_path(path)
        if not report["regressed"]:
            failures.append("30% slower round did not trip the gate")
        else:
            metrics = report["regressions"][0]["regressed_metrics"]
            if set(metrics) != {"steps_per_sec", "utilization_pct"}:
                failures.append(f"unexpected regressed metrics: {metrics}")

        path2 = Path(tmp) / "drift.jsonl"
        append_record(path2, point("r1", 100.0, 4.0, 1.0))
        rec = point("r2", 10.0, 0.4, 2.0)
        rec["batch_size"] = 64
        append_record(path2, rec)
        report = diff_path(path2)
        if report["regressed"] or not report["new_configs"]:
            failures.append(f"config drift mis-gated: {report}")
    if failures:
        print("telemetry: ledger selfcheck FAILED: " + "; ".join(failures))
        return 1
    print("telemetry: ledger selfcheck ok")
    return 0


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
    p_agg = sub.add_parser(
        "aggregate", help="every rank's event stream in one fleet view")
    p_agg.add_argument("root", help="root holding the ranks' run dirs")
    p_agg.add_argument("--json", action="store_true",
                       help="machine-readable report")
    p_agg.add_argument("--grace", type=float, default=30.0, metavar="S",
                       help="a process active within S seconds is running")
    p_agg.set_defaults(fn=_aggregate)
    p_post = sub.add_parser(
        "postmortem", help="the fleet's verdict on how the run ended; exit 2 "
                           "on failures")
    p_post.add_argument("root", nargs="?", default=None,
                        help="root holding the ranks' run dirs")
    p_post.add_argument("--json", action="store_true",
                        help="machine-readable report")
    p_post.add_argument("--grace", type=float, default=30.0, metavar="S",
                        help="a process active within S seconds is running")
    p_post.add_argument("--selfcheck", action="store_true",
                        help="hermetic two-rank fixture instead of a run")
    p_post.set_defaults(fn=_postmortem)
    p_led = sub.add_parser(
        "ledger", help="diff the perf ledger's latest round against its "
                       "baseline; exit 2 on a regression at equal config")
    p_led.add_argument("path", nargs="?", default=str(DEFAULT_LEDGER_PATH),
                       help=f"perf ledger JSONL (default: "
                            f"{DEFAULT_LEDGER_PATH})")
    p_led.add_argument("--json", action="store_true",
                       help="machine-readable report")
    p_led.add_argument("--threshold", type=float, default=REGRESSION_PCT,
                       metavar="PCT", help="regression threshold in percent "
                                           f"(default {REGRESSION_PCT:g})")
    p_led.add_argument("--baseline", type=int, default=None, metavar="N",
                       help="compare against only the last N baseline rounds")
    p_led.add_argument("--selfcheck", action="store_true",
                       help="hermetic gate fixture instead of a ledger")
    p_led.set_defaults(fn=_ledger)
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
    p_watch = sub.add_parser(
        "watch", help="live fleet console over running event streams")
    p_watch.add_argument("root", nargs="?", default=None,
                         help="root directory holding per-process run dirs")
    p_watch.add_argument("--once", action="store_true",
                         help="render one snapshot and exit")
    p_watch.add_argument("--json", action="store_true",
                         help="print one machine-readable snapshot and exit")
    p_watch.add_argument("--interval", type=float, default=2.0, metavar="S",
                         help="refresh interval in seconds (default 2)")
    p_watch.add_argument("--grace", type=float, default=30.0, metavar="S",
                         help="a process active within S seconds is running")
    p_watch.add_argument("--selfcheck", action="store_true",
                         help="hermetic 2-process fixture instead of a root")
    p_watch.set_defaults(fn=_watch)
    p_check = sub.add_parser("selfcheck",
                             help="events -> report, quality and SLO smoke")
    p_check.set_defaults(fn=_selfcheck)
    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:  # summarize | head closed the pipe
        sys.exit(0)
