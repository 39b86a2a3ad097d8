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
- ``fleet``     — supervise N ranks of a data-parallel run
                  (``resilience/fleetsup.py``): any rank dead or hung
                  restarts the WHOLE fleet from the last verified
                  checkpoint; a deterministic loss resizes it to N-1::

                      python -m masters_thesis_tpu_torch.resilience fleet \
                          --nprocs 2 --run-dir <dir> \
                          --ckpt-dir <log_dir>/checkpoints -- \
                          python -m masters_thesis_tpu_torch train \
                          trainer.strategy=tpu_xla \
                          +trainer.n_devices={world} trainer.resume=auto \
                          trainer.telemetry={out}

                  (add ``--device cpu`` to the train command for gloo
                  ranks). Exit code: 0 completed, 2 deterministic, 1
                  anything else. ``--selfcheck`` runs a 2-rank fleet of
                  ``fleet-worker`` ranks with a rank killed (relaunch), then
                  a deterministic rank loss (resize to 1).
- ``worker``    — internal: the simulated trainee of the selfcheck and the
                  tests (a progress file, telemetry, the fault point
                  ``worker.epoch``).
- ``fleet-worker`` — internal: the simulated fleet rank (its shard by
                  ``shard_bounds``, rank 0's atomic progress commit, a
                  crash or hang of one rank).

``run --probe`` probes the card before each attempt (one attempt,
``--probe-timeout-s``, the cache ``--probe-cache``); a failed probe is
recorded as a ``degradation`` with ``fallback: null`` and the attempt runs
on the card. ``--no-cpu-fallback`` is accepted so that JAX command lines
run unchanged: it is what the port always does.
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
        help="probe the card before each attempt (one attempt); a failed "
        "probe is recorded as a degradation, and the attempt runs on the "
        "card all the same",
    )
    p.add_argument("--probe-timeout-s", type=float, default=120.0)
    p.add_argument("--probe-cache", type=Path, default=None)
    p.add_argument(
        "--no-cpu-fallback",
        action="store_true",
        help="accepted for the JAX command line: the port never falls back "
        "to the CPU",
    )


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
        probe=args.probe,
        probe_timeout_s=args.probe_timeout_s,
        probe_cache=args.probe_cache,
    )


# ---------------------------------------------------------------------- run


def _cmd_run(args) -> int:
    from masters_thesis_tpu_torch.resilience.supervisor import RunSupervisor

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


def _fleet_cfg_from_args(args):
    from masters_thesis_tpu_torch.resilience.fleetsup import FleetConfig

    return FleetConfig(
        nprocs=args.nprocs,
        min_nprocs=args.min_nprocs,
        max_relaunches_per_size=args.max_relaunches_per_size,
        max_generations=args.max_generations,
        backoff_s=args.backoff_s,
        backoff_factor=args.backoff_factor,
        max_backoff_s=args.max_backoff_s,
        hang_timeout_s=args.hang_timeout_s,
        term_grace_s=args.term_grace_s,
        poll_interval_s=args.poll_interval_s,
        boot_timeout_s=args.boot_timeout_s,
    )


def _cmd_fleet(args) -> int:
    from masters_thesis_tpu_torch.resilience.fleetsup import FleetSupervisor

    if args.selfcheck:
        return _fleet_selfcheck(args)
    cmd = args.cmd[1:] if args.cmd and args.cmd[0] == "--" else args.cmd
    if not cmd:
        print("fleet: no command given (use `-- cmd ...`)", file=sys.stderr)
        return 2
    if args.run_dir is None:
        print("fleet: --run-dir is required", file=sys.stderr)
        return 2
    sup = FleetSupervisor(
        cmd,
        run_dir=args.run_dir,
        cfg=_fleet_cfg_from_args(args),
        ckpt_dir=args.ckpt_dir,
        metrics_port=args.metrics_port,
    )
    result = sup.run()
    print(
        f"[fleetsup] verdict={result.verdict}"
        f" generations={result.n_generations}"
        f" final_nprocs={result.final_nprocs}"
        + (" resized" if result.resized else "")
        + f" trace={result.trace_id}",
        file=sys.stderr,
    )
    if result.ok:
        return 0
    return 2 if result.verdict == "deterministic" else 1


# ------------------------------------------------------------- fleet-worker


def _cmd_fleet_worker(args) -> int:
    """Simulated fleet rank of the fleet selfcheck and the tests.

    Takes its shard of ``--items`` by ``shard_bounds`` over the
    generation's world (the identity the fleet supervisor exports), beats
    through the flight recorder, and on rank 0 only (as rank 0 alone
    publishes a checkpoint) commits its progress atomically after each
    epoch: one file with the resume epoch, a rolling value and the whole
    history. A kill at any instant leaves every committed epoch in the
    history exactly once, which is what the bit-for-bit resume check
    reads. With ``--peer-loss-exit`` the other ranks exit 1 with a
    collective's error once the crash rank has gone, as gloo and NCCL
    ranks do."""
    import os
    import signal as _signal

    from masters_thesis_tpu_torch.parallel.mesh import (
        COUNT_ENV,
        INDEX_ENV,
        shard_bounds,
    )
    from masters_thesis_tpu_torch.resilience import faults
    from masters_thesis_tpu_torch.telemetry.events import GENERATION_ENV
    from masters_thesis_tpu_torch.telemetry.run import TelemetryRun
    from masters_thesis_tpu_torch.utils.io import atomic_write_text

    rank = int(os.environ.get(INDEX_ENV, "0") or 0)
    world = int(os.environ.get(COUNT_ENV, "1") or 1)
    gen = int(os.environ.get(GENERATION_ENV, "0") or 0)
    attempt = faults.current_attempt()
    state = Path(args.state)
    state.mkdir(parents=True, exist_ok=True)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    lo, hi = shard_bounds(args.items, world, rank)
    with open(state / "shards.log", "a") as f:
        # One short write under O_APPEND: atomic across ranks.
        f.write(f"{gen} {world} {rank} {lo} {hi}\n")

    progress = state / "progress.json"
    start, value, history = 0, 0, []
    if progress.exists():
        try:
            obj = json.loads(progress.read_text())
            start = obj["epoch"] + 1
            value = obj["value"]
            history = obj["history"]
        except (ValueError, KeyError):
            start, value, history = 0, 0, []

    tel = TelemetryRun(out / "telemetry", run_id=f"fleet-worker-p{rank}")
    rec = tel.attach_flight_recorder(heartbeat_interval_s=0.1)
    tel.event("run_started", rank=rank, world=world, gen=gen,
              shard=[lo, hi],
              resumed_from=str(progress) if start else None)
    crashed = state / f"crashed.g{gen}"

    def peer_lost() -> bool:
        return (args.peer_loss_exit and rank != args.crash_rank
                and crashed.exists())

    last = args.epochs
    if args.crash_mode == "always" and rank == args.crash_rank:
        # A host gone for good fails in every generation it is in, also one
        # whose work its peers finished before it got to fail.
        last = max(last, start + 1)
    for epoch in range(start, last):
        rec.beat(phase="epoch", epoch=epoch)
        faults.fire("worker.epoch", epoch=epoch, rank=rank)
        crash_here = (
            args.crash_rank is not None
            and rank == args.crash_rank
            and epoch >= args.at
            and (args.crash_mode == "always" or gen == 0)
        )
        if crash_here:
            tel.event("epoch_crash", rank=rank, gen=gen, epoch=epoch)
            if args.crash_kind == "kill":
                crashed.touch()
                os.kill(os.getpid(), _signal.SIGKILL)
            print("RuntimeError: injected deterministic rank failure",
                  file=sys.stderr, flush=True)
            tel.close()
            # The peers learn of the loss only as the process goes, as a
            # real rank's peers do when its sockets close.
            crashed.touch()
            os._exit(3)
        if (args.hang_rank is not None and rank == args.hang_rank
                and epoch == args.at and gen == 0):
            while True:  # a wedged collective, as seen from the host
                time.sleep(3600)
        deadline = time.monotonic() + args.sleep_s
        while True:
            if peer_lost():
                print("RuntimeError: [gloo/transport/tcp/pair.cc] Connection "
                      f"closed by peer (rank {rank}, epoch {epoch})",
                      file=sys.stderr)
                tel.close()
                return 1
            if time.monotonic() >= deadline:
                break
            time.sleep(0.005)
        if rank == 0:
            # The one commit point: value and history move together or not
            # at all (atomic replace), so a SIGKILL mid-epoch never records
            # the epoch half done.
            value = (value * 1000003 + epoch) % (2**61 - 1)
            history.append([attempt, gen, world, epoch])
            atomic_write_text(progress, json.dumps(
                {"epoch": epoch, "value": value, "history": history}))
    tel.event("run_finished", rank=rank, world=world, gen=gen,
              epochs=args.epochs)
    tel.close()
    return 0


def _fleet_expected_value(epochs: int) -> int:
    value = 0
    for epoch in range(epochs):
        value = (value * 1000003 + epoch) % (2**61 - 1)
    return value


def _fleet_selfcheck(args) -> int:
    """A 2-rank fleet of ``fleet-worker`` ranks, hermetic: (1) a rank
    SIGKILLed mid-epoch -> the whole fleet relaunched, resumed from the
    committed progress, its final value bit for bit a run's without the
    fault, every epoch done exactly once; (2) a deterministic rank loss
    (the same fingerprint twice) -> resized to 1 rank, which completes."""
    from masters_thesis_tpu_torch.resilience.fleetsup import (
        FleetConfig,
        FleetSupervisor,
    )

    tmp = Path(tempfile.mkdtemp(prefix="fleet-selfcheck-"))
    failures: list[str] = []
    epochs = 5
    expected = _fleet_expected_value(epochs)

    def fleet_cmd(state: Path, *extra: str) -> list[str]:
        return [sys.executable, "-m", "masters_thesis_tpu_torch.resilience",
                "fleet-worker", "--state", str(state), "--out", "{out}",
                "--epochs", str(epochs), "--items", "64", "--sleep-s", "0.05",
                *extra]

    fast = FleetConfig(nprocs=2, min_nprocs=1, max_relaunches_per_size=2,
                       backoff_s=0.05, backoff_factor=1.0, term_grace_s=2.0,
                       poll_interval_s=0.05)

    def check_progress(state: Path, label: str) -> None:
        obj = json.loads((state / "progress.json").read_text())
        done = [entry[3] for entry in obj["history"]]
        if done != list(range(epochs)):
            failures.append(
                f"{label}: history epochs {done} != {list(range(epochs))} "
                "(resume redid or skipped committed work)")
        elif obj["value"] != expected:
            failures.append(
                f"{label}: final value {obj['value']} != fault-free "
                f"{expected} (resume is not bit-identical)")

    # 1. rank 1 SIGKILLed mid-epoch -> all-rank relaunch, verified resume
    state = tmp / "kill-state"
    res = FleetSupervisor(
        fleet_cmd(state, "--crash-rank", "1", "--at", "1",
                  "--crash-kind", "kill"),
        run_dir=tmp / "kill-run", cfg=fast).run()
    if not res.ok or res.n_generations != 2 or res.resized:
        failures.append(
            f"kill-relaunch: verdict={res.verdict} "
            f"generations={res.n_generations} resized={res.resized} "
            "(want completed in exactly 2 generations, no resize)")
    else:
        check_progress(state, "kill-relaunch")

    # 2. deterministic rank loss -> same fingerprint twice -> resize to 1
    state = tmp / "det-state"
    res = FleetSupervisor(
        fleet_cmd(state, "--crash-rank", "1", "--at", "1",
                  "--crash-mode", "always"),
        run_dir=tmp / "det-run", cfg=fast).run()
    if not res.ok or not res.resized or res.final_nprocs != 1:
        failures.append(
            f"deterministic-resize: verdict={res.verdict} "
            f"generations={res.n_generations} resized={res.resized} "
            f"final_nprocs={res.final_nprocs} "
            "(want elastic degradation to 1 rank, then completion)")
    else:
        check_progress(state, "deterministic-resize")

    if args.keep:
        print(f"fleet selfcheck artifacts kept at {tmp}", file=sys.stderr)
    else:
        shutil.rmtree(tmp, ignore_errors=True)
    if failures:
        for f in failures:
            print(f"fleet selfcheck FAILED: {f}", file=sys.stderr)
        return 1
    print("fleet selfcheck: 2 scenarios OK")
    return 0


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

    p_fleet = sub.add_parser("fleet", help="supervise an N-process fleet")
    p_fleet.add_argument("--run-dir", type=Path, default=None)
    p_fleet.add_argument("--ckpt-dir", type=Path, default=None)
    p_fleet.add_argument("--nprocs", type=int, default=2)
    p_fleet.add_argument("--min-nprocs", type=int, default=1,
                         help="elastic-resize floor; below this a "
                         "deterministic failure halts the fleet")
    p_fleet.add_argument("--max-relaunches-per-size", type=int, default=2)
    p_fleet.add_argument("--max-generations", type=int, default=8)
    p_fleet.add_argument("--backoff-s", type=float, default=1.0)
    p_fleet.add_argument("--backoff-factor", type=float, default=2.0)
    p_fleet.add_argument("--max-backoff-s", type=float, default=60.0)
    p_fleet.add_argument("--hang-timeout-s", type=float, default=None,
                         help="heartbeat staleness after which a rank "
                         "counts as hung and the fleet restarts")
    p_fleet.add_argument("--term-grace-s", type=float, default=5.0)
    p_fleet.add_argument("--poll-interval-s", type=float, default=0.2)
    p_fleet.add_argument("--boot-timeout-s", type=float, default=None)
    p_fleet.add_argument("--metrics-port", type=int, default=None,
                         help="serve /metrics and /slo (0: any free port)")
    p_fleet.add_argument("--selfcheck", action="store_true",
                         help="run the hermetic 2-rank fleet smoke "
                         "instead of supervising a command")
    p_fleet.add_argument("--keep", action="store_true",
                         help="(selfcheck) keep the scratch dir")
    p_fleet.add_argument("cmd", nargs=argparse.REMAINDER,
                         help="per-rank command template; {rank} {world} "
                         "{coordinator} {gen} {out} {root} substituted")

    p_fwrk = sub.add_parser("fleet-worker")  # internal, used by selfcheck
    p_fwrk.add_argument("--state", type=Path, required=True,
                        help="shared dir: atomic progress + shard log")
    p_fwrk.add_argument("--out", type=Path, required=True)
    p_fwrk.add_argument("--epochs", type=int, default=4)
    p_fwrk.add_argument("--items", type=int, default=64,
                        help="total items sharded across the fleet")
    p_fwrk.add_argument("--sleep-s", type=float, default=0.0)
    p_fwrk.add_argument("--crash-rank", type=int, default=None)
    p_fwrk.add_argument("--hang-rank", type=int, default=None)
    p_fwrk.add_argument("--at", type=int, default=1,
                        help="epoch at which the injected failure fires")
    p_fwrk.add_argument("--crash-mode", choices=("once", "always"),
                        default="once",
                        help="once: generation 0 only (transient); "
                        "always: every generation the rank exists in "
                        "(deterministic host loss)")
    p_fwrk.add_argument("--crash-kind", choices=("exit", "kill"),
                        default="exit",
                        help="exit: rc=3 with a stderr line; kill: "
                        "SIGKILL self (no evidence beyond the signal)")
    p_fwrk.add_argument("--peer-loss-exit", action="store_true",
                        help="the other ranks exit 1 with a collective's "
                        "error once the crash rank has gone")

    p_wrk = sub.add_parser("worker")  # internal, used by selfcheck
    p_wrk.add_argument("--out", type=Path, required=True)
    p_wrk.add_argument("--mode", choices=("ok", "crash", "nan", "hang"),
                       default="ok")
    p_wrk.add_argument("--epochs", type=int, default=4)
    p_wrk.add_argument("--at", type=int, default=1,
                       help="epoch at which mode-specific behavior fires")
    p_wrk.add_argument("--sleep-s", type=float, default=0.0)

    args = parser.parse_args(argv)
    if args.command == "run":
        return _cmd_run(args)
    if args.command == "classify":
        return _cmd_classify(args)
    if args.command == "selfcheck":
        return _selfcheck(args)
    if args.command == "worker":
        return _cmd_worker(args)
    if args.command == "fleet":
        return _cmd_fleet(args)
    if args.command == "fleet-worker":
        return _cmd_fleet_worker(args)
    return 2


if __name__ == "__main__":
    sys.exit(main())
