"""``python -m masters_thesis_tpu_torch.resilience``: the run supervisor's
command line (imports no torch).

Counterpart of ``masters_thesis_tpu/resilience/__main__.py``.

- ``run``       — supervise a training command to completion::

                      python -m masters_thesis_tpu_torch.resilience run \\
                          --run-dir <dir> --watch-dir <log_dir>/telemetry \\
                          --ckpt-dir <log_dir>/checkpoints -- \\
                          python -m masters_thesis_tpu_torch train \\
                          trainer.resume=auto

                  Exit code: 0 completed, 2 deterministic-failure verdict,
                  1 anything else (retries, budget or rollbacks spent).
- ``classify``  — one failure classified from the evidence on disk (return
                  code, stderr tail, crashdumps, event streams); prints JSON.
- ``selfcheck`` — the supervisor against ``worker`` children: preempt ->
                  resume, a deterministic crash -> halt, a NaN -> rollback
                  at a scaled LR. Exits non-zero on a failed scenario.
- ``worker``    — internal: the simulated trainee of the selfcheck and the
                  tests (a progress file, telemetry, the fault point
                  ``worker.epoch``).

``fleet`` and ``fleet-worker`` (the fleet supervisor) are not ported:
they exit 1 and name ROADMAP queue 1 item 4. ``--probe`` (the backend
probe and its CPU fallback) is refused: item 5.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path


def _add_policy_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--max-retries", type=int, default=3)
    p.add_argument("--backoff-s", type=float, default=5.0)
    p.add_argument("--backoff-factor", type=float, default=2.0)
    p.add_argument("--max-backoff-s", type=float, default=300.0)
    p.add_argument("--retry-budget-s", type=float, default=None)
    p.add_argument("--attempt-timeout-s", type=float, default=None)
    p.add_argument("--rollback-attempts", type=int, default=2)
    p.add_argument("--lr-factor", type=float, default=0.5)
    p.add_argument("--hang-timeout-s", type=float, default=None)
    p.add_argument(
        "--probe",
        action="store_true",
        help="refused: the backend probe and its CPU fallback are not "
        "ported (" + PROBE_QUEUE + ")",
    )


#: Where what this command line does not do yet is queued.
FLEET_QUEUE = "ROADMAP.md queue 1 item 4 (fleets)"
PROBE_QUEUE = "ROADMAP.md queue 1 item 5 (a loud CPU degradation)"


def _cfg_from_args(args):
    from masters_thesis_tpu_torch.resilience.supervisor import SupervisorConfig

    return SupervisorConfig(
        max_retries=args.max_retries,
        backoff_s=args.backoff_s,
        backoff_factor=args.backoff_factor,
        max_backoff_s=args.max_backoff_s,
        retry_budget_s=args.retry_budget_s,
        attempt_timeout_s=args.attempt_timeout_s,
        rollback_attempts=args.rollback_attempts,
        lr_factor=args.lr_factor,
        hang_timeout_s=args.hang_timeout_s,
    )


# ---------------------------------------------------------------------- run


def _cmd_run(args) -> int:
    from masters_thesis_tpu_torch.resilience.supervisor import RunSupervisor

    if args.probe:
        print(f"run: --probe is not ported ({PROBE_QUEUE}); a child is never "
              "moved to the CPU behind the user's back", file=sys.stderr)
        return 1
    if not args.cmd:
        print("run: no command given (use `-- cmd ...`)", file=sys.stderr)
        return 2
    cmd = args.cmd[1:] if args.cmd and args.cmd[0] == "--" else args.cmd
    sup = RunSupervisor(
        cmd,
        run_dir=args.run_dir,
        cfg=_cfg_from_args(args),
        watch_dir=args.watch_dir,
        ckpt_dir=args.ckpt_dir,
        passthrough=not args.quiet,
    )
    result = sup.run()
    print(
        f"[supervisor] verdict={result.verdict} attempts={result.n_attempts}"
        f" lost_work_s={result.lost_work_s:.1f}",
        file=sys.stderr,
    )
    if result.ok:
        return 0
    return 2 if result.verdict == "deterministic" else 1


# ----------------------------------------------------------------- classify


def _cmd_classify(args) -> int:
    from masters_thesis_tpu_torch.resilience.supervisor import RunSupervisor

    stderr_tail = ""
    if args.stderr_file:
        stderr_tail = Path(args.stderr_file).read_text(errors="replace")
    sup = RunSupervisor(
        ["true"],
        run_dir=args.watch_dir or ".",
        watch_dir=args.watch_dir,
    )
    cls = sup._classify(
        args.rc,
        args.since,
        stderr_tail,
        hang_killed=args.hang_killed,
        timed_out=False,
    )
    print(
        json.dumps(
            {
                "kind": cls.kind,
                "reason": cls.reason,
                "fingerprint": cls.fingerprint,
                "diverged_epoch": cls.diverged_epoch,
            },
            indent=2,
        )
    )
    return 0


# ------------------------------------------------------------------- worker


def _cmd_worker(args) -> int:
    """Simulated trainee: per-epoch progress file + telemetry + fault
    hooks. Resumes from its own progress file exactly like the real
    trainer resumes from a checkpoint — the selfcheck's proof that a
    supervised restart continues instead of starting over."""
    import os

    from masters_thesis_tpu_torch.resilience import faults
    from masters_thesis_tpu_torch.telemetry.run import TelemetryRun

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    progress = out / "progress.json"
    start = 0
    if progress.exists():
        try:
            start = json.loads(progress.read_text())["epoch"] + 1
        except (ValueError, KeyError):
            start = 0
    tel = TelemetryRun(out / "telemetry", run_id="selfcheck-worker")
    rec = tel.attach_flight_recorder(heartbeat_interval_s=0.1)
    lr_scale = float(os.environ.get("MTT_LR_SCALE", "1") or 1.0)
    tel.event(
        "run_started",
        resumed_from=str(progress) if start else None,
        lr_scale=lr_scale,
    )
    diverged = False
    for epoch in range(start, args.epochs):
        faults.fire("worker.epoch", epoch=epoch)
        rec.beat(phase="epoch", epoch=epoch)
        if args.mode == "hang" and epoch == args.at:
            while True:  # a wedged collective, as seen from the host
                time.sleep(3600)
        if args.mode == "nan" and epoch == args.at and lr_scale == 1.0:
            # Divergence heals at a lower LR: the rollback's relaunch
            # (MTT_LR_SCALE < 1) sails past this epoch.
            diverged = True
            break
        with open(out / "work.log", "a") as f:
            f.write(f"{faults.current_attempt()} {epoch}\n")
        progress.write_text(json.dumps({"epoch": epoch}))
        if args.sleep_s:
            time.sleep(args.sleep_s)
    tel.event("run_finished", diverged=diverged, epochs=args.epochs)
    tel.close()
    if args.mode == "crash":
        print("RuntimeError: injected deterministic failure", file=sys.stderr)
        return 3
    return 0


# -------------------------------------------------------------------- fleet


def _cmd_fleet(command: str) -> int:
    print(f"{command}: the fleet supervisor is not ported ({FLEET_QUEUE})",
          file=sys.stderr)
    return 1


# ---------------------------------------------------------------- selfcheck


def _selfcheck(args) -> int:
    from masters_thesis_tpu_torch.resilience.supervisor import (
        RunSupervisor,
        SupervisorConfig,
    )

    tmp = Path(tempfile.mkdtemp(prefix="resilience-selfcheck-"))
    failures: list[str] = []

    def worker_cmd(out: Path, mode: str, epochs: int = 4, at: int = 1):
        return [
            sys.executable,
            "-m",
            "masters_thesis_tpu_torch.resilience",
            "worker",
            "--out",
            str(out),
            "--mode",
            mode,
            "--epochs",
            str(epochs),
            "--at",
            str(at),
        ]

    fast = SupervisorConfig(
        max_retries=3, backoff_s=0.05, backoff_factor=1.0, term_grace_s=2.0
    )

    # 1. preempt mid-run -> supervised resume continues, no redone work
    out = tmp / "preempt"
    import os

    env = dict(os.environ)
    env["MTT_FAULT_PLAN"] = json.dumps(
        [{"point": "worker.epoch", "kind": "preempt", "attempt": 1,
          "match": {"epoch": 2}}]
    )
    res = RunSupervisor(
        worker_cmd(out, "ok"),
        run_dir=out / "supervisor",
        cfg=fast,
        env=env,
        watch_dir=out / "telemetry",
    ).run()
    lines = (
        (out / "work.log").read_text().splitlines()
        if (out / "work.log").exists()
        else []
    )
    epochs_done = [int(ln.split()[1]) for ln in lines]
    if not res.ok or res.n_attempts != 2:
        failures.append(
            f"preempt-resume: verdict={res.verdict} attempts={res.n_attempts}"
        )
    elif epochs_done != [0, 1, 2, 3]:
        failures.append(
            f"preempt-resume: work log {epochs_done} != [0, 1, 2, 3] "
            "(restart redid or skipped epochs instead of resuming)"
        )

    # 2. deterministic crash -> halt after the fingerprint reproduces
    out = tmp / "crash"
    res = RunSupervisor(
        worker_cmd(out, "crash", at=99),
        run_dir=out / "supervisor",
        cfg=fast,
        watch_dir=out / "telemetry",
    ).run()
    if res.verdict != "deterministic" or res.n_attempts != 2:
        failures.append(
            f"deterministic: verdict={res.verdict} attempts={res.n_attempts}"
            " (want deterministic after exactly 2 attempts)"
        )

    # 3. NaN divergence -> rollback relaunch with a scaled LR completes
    out = tmp / "nan"
    res = RunSupervisor(
        worker_cmd(out, "nan"),
        run_dir=out / "supervisor",
        cfg=fast,
        watch_dir=out / "telemetry",
    ).run()
    rollbacks = [
        a for a in res.attempts if a.classification.kind == "divergence"
    ]
    if not res.ok or res.n_attempts != 2 or len(rollbacks) != 1:
        failures.append(
            f"nan-rollback: verdict={res.verdict} attempts={res.n_attempts} "
            f"divergences={len(rollbacks)}"
        )

    if args.keep:
        print(f"selfcheck artifacts kept at {tmp}", file=sys.stderr)
    else:
        shutil.rmtree(tmp, ignore_errors=True)
    if failures:
        for f in failures:
            print(f"resilience selfcheck FAILED: {f}", file=sys.stderr)
        return 1
    print("resilience selfcheck: 3 scenarios OK")
    return 0


# --------------------------------------------------------------------- main


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m masters_thesis_tpu_torch.resilience",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p_run = sub.add_parser("run", help="supervise a training command")
    p_run.add_argument("--run-dir", type=Path, required=True)
    p_run.add_argument("--watch-dir", type=Path, default=None,
                       help="child telemetry dir (heartbeat + events)")
    p_run.add_argument("--ckpt-dir", type=Path, default=None)
    p_run.add_argument("--quiet", action="store_true",
                       help="log child output to files only, no passthrough")
    _add_policy_args(p_run)
    p_run.add_argument("cmd", nargs=argparse.REMAINDER)

    p_cls = sub.add_parser("classify", help="classify a failure from disk")
    p_cls.add_argument("--rc", type=int, default=None)
    p_cls.add_argument("--stderr-file", type=Path, default=None)
    p_cls.add_argument("--watch-dir", type=Path, default=None)
    p_cls.add_argument("--since", type=float, default=0.0)
    p_cls.add_argument("--hang-killed", action="store_true")

    p_self = sub.add_parser("selfcheck", help="end-to-end supervisor smoke")
    p_self.add_argument("--keep", action="store_true",
                        help="keep the scratch dir for inspection")

    for name in ("fleet", "fleet-worker"):
        sub.add_parser(name, help=f"not ported ({FLEET_QUEUE})")

    p_wrk = sub.add_parser("worker")  # internal, used by selfcheck
    p_wrk.add_argument("--out", type=Path, required=True)
    p_wrk.add_argument("--mode", choices=("ok", "crash", "nan", "hang"),
                       default="ok")
    p_wrk.add_argument("--epochs", type=int, default=4)
    p_wrk.add_argument("--at", type=int, default=1,
                       help="epoch at which mode-specific behavior fires")
    p_wrk.add_argument("--sleep-s", type=float, default=0.0)

    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in ("fleet", "fleet-worker"):
        return _cmd_fleet(argv[0])
    args = parser.parse_args(argv)
    if args.command == "run":
        return _cmd_run(args)
    if args.command == "classify":
        return _cmd_classify(args)
    if args.command == "selfcheck":
        return _selfcheck(args)
    if args.command == "worker":
        return _cmd_worker(args)
    return 2


if __name__ == "__main__":
    sys.exit(main())
