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
- ``selfcheck`` — events -> report on a synthetic stream in a temporary
  directory.

Not ported, each exiting 1 with the ROADMAP item that holds it:
``postmortem``, ``aggregate`` and ``watch`` (fleet views, item 4),
``quality`` (item 5), ``ledger`` (item 6).
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
    "quality": "ROADMAP.md queue 1 item 5 (the quality plane)",
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
    return 0 if ok else 1


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
    p_check = sub.add_parser("selfcheck", help="events -> report smoke")
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
