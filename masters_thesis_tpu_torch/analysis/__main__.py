"""``python -m masters_thesis_tpu_torch.analysis`` — the port's lint gate.

The default run is the graph-path lint (TL101–TL105, ``astlint.py``) over
the given paths (by default the package), then the trainer preflight
(TA201–TA207, ``traceaudit.py``) on ``--device``: the card by default,
failing without one, as every entry point of the port does; ``--device
cpu`` audits on the CPU, where it prints TA201 and TA202 as not
applicable. ``--concurrency`` (CL501–CL505, over the host-thread modules:
``serve/``, ``parallel/launch.py``, ``resilience/``, ``telemetry/``,
``utils/cuda_graph.py``, ``utils/counts.py``), ``--contracts`` (EC601–EC603
over the package, against ``analysis/event_schema.json``) and ``--spmd``
(DV701–DV705 over ``train/``, ``parallel/``, ``resilience/``,
``telemetry/``) run only those static passes, which import no torch.
``--emit-schema`` rewrites the lockfile from the emitters and exits.

Exit codes: 0 — no unsuppressed finding; 1 — at least one. ``--json``
prints the findings as JSON; the static passes then include the
suppressed ones, marked ``"suppressed": true``, which never count.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

PACKAGE_ROOT = Path(__file__).resolve().parents[1]
LOCKFILE = PACKAGE_ROOT / "analysis" / "event_schema.json"
#: The modules whose threads the concurrency lint reads.
CONCURRENCY_PATHS = ("serve", "parallel/launch.py", "resilience", "telemetry",
                     "utils/cuda_graph.py", "utils/counts.py")
#: Where collectives are issued, supervised and chained (the SPMD lint).
SPMD_PATHS = ("train", "parallel", "resilience", "telemetry")


def _static(args) -> int:
    """The static passes asked for; the exit code."""
    from masters_thesis_tpu_torch.analysis.findings import format_report

    keep = args.json  # suppressed findings, marked, for the inventory
    findings: list = []
    if args.concurrency:
        from masters_thesis_tpu_torch.analysis.concurrency import (
            lint_concurrency,
        )

        findings += lint_concurrency(
            args.paths or [PACKAGE_ROOT / p for p in CONCURRENCY_PATHS],
            package_root=PACKAGE_ROOT, include_suppressed=keep)
    if args.contracts:
        from masters_thesis_tpu_torch.analysis.contracts import lint_contracts

        findings += lint_contracts(
            args.paths or [PACKAGE_ROOT], package_root=PACKAGE_ROOT,
            schema_path=None if args.paths else LOCKFILE,
            include_suppressed=keep)
    if args.spmd:
        from masters_thesis_tpu_torch.analysis.spmd import lint_spmd

        findings += lint_spmd(
            args.paths or [PACKAGE_ROOT / p for p in SPMD_PATHS],
            package_root=PACKAGE_ROOT, include_suppressed=keep)
    findings = sorted(set(findings),
                      key=lambda f: (f.path, f.line, f.rule, f.message))
    print(format_report(findings, as_json=args.json))
    return 1 if any(not f.suppressed for f in findings) else 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m masters_thesis_tpu_torch.analysis",
        description="the port's lint gate: the graph-path lint and the "
                    "trainer preflight, or the static passes")
    parser.add_argument("paths", nargs="*", type=Path,
                        help="files/directories to lint (default: the "
                             "package, or each pass's own modules)")
    parser.add_argument("--skip-lint", action="store_true",
                        help="run only the trainer preflight")
    parser.add_argument("--device", default=None,
                        help="where the preflight runs: cuda (the default; "
                             "fails without a card) or cpu")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable findings")
    parser.add_argument("--concurrency", action="store_true",
                        help="run only the concurrency lint (CL501-CL505)")
    parser.add_argument("--contracts", action="store_true",
                        help="run only the event contract (EC601-EC603)")
    parser.add_argument("--spmd", action="store_true",
                        help="run only the SPMD lint (DV701-DV705)")
    parser.add_argument("--emit-schema", action="store_true",
                        help="rewrite analysis/event_schema.json from the "
                             "emitters and exit")
    args = parser.parse_args(argv)

    if args.emit_schema:
        from masters_thesis_tpu_torch.analysis.contracts import build_schema

        schema = build_schema(args.paths or [PACKAGE_ROOT],
                              package_root=PACKAGE_ROOT)
        LOCKFILE.write_text(json.dumps(schema, indent=2) + "\n")
        print(f"wrote {LOCKFILE} ({len(schema['kinds'])} event kinds)")
        return 0
    if args.concurrency or args.contracts or args.spmd:
        return _static(args)

    from masters_thesis_tpu_torch import resolve_device
    from masters_thesis_tpu_torch.analysis.findings import format_report

    device = resolve_device(args.device)  # raises without the card asked for
    findings = []
    if not args.skip_lint:
        from masters_thesis_tpu_torch.analysis.astlint import lint_paths

        findings += lint_paths(args.paths or [PACKAGE_ROOT],
                               package_root=PACKAGE_ROOT)
    from masters_thesis_tpu_torch.analysis.traceaudit import (
        AUDIT_REPLICAS,
        run_trace_audit,
    )

    facts: dict = {}
    findings += run_trace_audit(device=device,
                                stacked_replicas=AUDIT_REPLICAS, facts=facts)
    print(json.dumps({"preflight": facts}, sort_keys=True), flush=True)
    if not args.json:
        for rule, why in sorted(facts.get("not_applicable", {}).items()):
            print(f"{rule} not applicable on {facts['device']}: {why}")
    print(format_report(findings, as_json=args.json))
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
