"""The fleet supervisor: N ranks relaunched together, and resized N -> N-1.

Counterpart of ``masters_thesis_tpu/resilience/fleetsup.py``, with its
policy, events and exit codes. A data-parallel fleet has one failure the
run supervisor (``resilience/supervisor.py``) cannot see: one rank dies,
and the others block in their next collective, alive, making no progress.
The fleet's rule:

    any rank dead, or hung past ``hang_timeout_s``
        => terminate ALL ranks (SIGTERM to each rank's process group, one
           grace period shared by the whole fleet, then SIGKILL),
           classify the failure with the run supervisor's rules,
           relaunch the WHOLE fleet from the last manifest-verified
           checkpoint (the trainer's resume makes the retry bit for bit a
           run without the fault).

Each launch of the whole fleet is a **generation**: generation 0 is the
first; each relaunch adds one, exports ``MTT_GENERATION`` (the events'
envelope tag) and ``MTT_ATTEMPT`` = generation + 1 (a fault plan scoped to
attempt 1 fires in generation 0 only), and gets a fresh rendezvous: a
``file://`` store under ``<run_dir>/g<gen>/rdzv/``. A dead generation's
store is never reused: its keys would meet the new ranks. Every rank is a
local process, so the fleet is on one host.
Each rank gets the port's launch environment (``parallel/launch.py``
``rank_env``: the coordinator, its index and the world, and
``MTT_LAUNCHER_PID`` naming this supervisor, so a rank dies with it), its
own session, and its output in ``<run_dir>/g<gen>/p<rank>.{out,err}``; the
command template's ``{rank}``, ``{world}``, ``{coordinator}``, ``{gen}``,
``{out}`` (``<run_dir>/g<gen>/p<rank>``, where the rank's telemetry should
go) and ``{root}`` are filled in for each rank.

Elastic resize: when the same crash fingerprint ends two generations in a
row (a host deterministically gone), or the relaunches at one size are
spent, the fleet relaunches at N-1 (``fleet_resized``) down to
``min_nprocs``, where it halts instead. The shards re-balance from the new
world alone (``parallel/mesh.py`` ``shard_bounds``). One trace id spans
every generation, so ``telemetry aggregate`` and ``postmortem`` read the
incident as one.

Where it differs from the JAX supervisor:

- **The failed rank is the root cause.** When one rank is SIGKILLed, the
  others' gloo or NCCL collectives fail a moment later and they exit non-zero
  too. The JAX supervisor names the lowest-numbered bad rank of a poll,
  which here could be a survivor, whose stderr (a collective error) differs
  from run to run, and then a repeated loss never shows the same fingerprint
  twice. The port names the first rank seen to exit; among those seen in
  one poll it prefers a death by a signal, then an error that is not a
  collective's, then the lowest rank.
- **Heartbeats are read per generation**: only heartbeats written since the
  generation started count (the run supervisor's rule against a dead
  attempt's stale heartbeat).
- A rank's ``rc`` is reported as a shell reports it (128 + the signal for a
  killed rank, 137 for SIGKILL), as ``parallel/launch.py`` reports one.
- ``fleet_failure`` also carries ``failed_at_ts`` (when the failure was
  seen), ``lost_work_s`` (from the last checkpoint publish in the
  generation, or the whole generation) and ``teardown_s``.
- No launch stagger (``launch_stagger_s``): the ranks meet at a ``file://``
  store, which takes N ranks at once.
- No ``tcp://`` coordinator: the JAX supervisor's address on another host
  waits for a launcher that starts ranks there.

Imports no torch: one poll loop (return codes, and the heartbeats of the
flight recorder), no thread, no signal handler. Relaunches wait a
decorrelated backoff, so N ranks do not reach a fresh coordinator at once.

Command line: ``python -m masters_thesis_tpu_torch.resilience fleet``.
"""

from __future__ import annotations

import os
import shlex
import signal
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Sequence

from masters_thesis_tpu_torch.parallel.launch import exit_code, rank_env
from masters_thesis_tpu_torch.resilience import faults
from masters_thesis_tpu_torch.resilience.backoff import DecorrelatedBackoff
from masters_thesis_tpu_torch.resilience.faults import ATTEMPT_ENV
from masters_thesis_tpu_torch.resilience.supervisor import (
    Classification,
    SupervisorTelemetry,
    _crash_line,
    _tail,
    classify_exit,
    crash_context,
    last_heartbeat_ts,
    last_publish,
)
from masters_thesis_tpu_torch.telemetry.events import GENERATION_ENV
from masters_thesis_tpu_torch.telemetry.schedule import (
    audit_schedules,
    read_rank_schedules,
)
from masters_thesis_tpu_torch.telemetry.trace import (
    PARENT_SPAN_ENV,
    TRACE_ENV,
    new_trace_id,
)

#: Template placeholders a fleet command may use, filled in for each rank
#: and generation.
TEMPLATE_KEYS = ("rank", "world", "coordinator", "gen", "out", "root")

#: What a rank's stderr shows when its collective failed because a peer
#: went away (gloo's transport, NCCL, torch.distributed's own errors).
COLLECTIVE_ERROR_PATTERNS = (
    "gloo/transport",
    "Connection closed by peer",
    "Connection reset by peer",
    "DistBackendError",
    "DistNetworkError",
    "ProcessGroupGloo",
    "ProcessGroupNCCL",
    "NCCL error",
)


@dataclass
class FleetConfig:
    nprocs: int = 2
    #: The floor of the elastic resize; at this size a deterministic
    #: failure halts instead (min_nprocs == nprocs: never resize).
    min_nprocs: int = 1
    #: Transient failures relaunched at the CURRENT size before the fleet
    #: resizes to N-1.
    max_relaunches_per_size: int = 2
    #: Generations across all sizes (a runaway's backstop).
    max_generations: int = 8
    backoff_s: float = 1.0
    backoff_factor: float = 2.0
    max_backoff_s: float = 60.0
    #: A heartbeat older than this: the rank is hung and the fleet
    #: restarts. Must exceed a rank's start (imports, data, capture).
    hang_timeout_s: float | None = None
    term_grace_s: float = 5.0
    poll_interval_s: float = 0.2
    #: Rank 0 must open the rendezvous within this, or the generation is a
    #: boot failure.
    boot_timeout_s: float | None = None


@dataclass
class _Rank:
    rank: int
    proc: subprocess.Popen
    dir: Path
    out_path: Path
    err_path: Path
    files: tuple


@dataclass
class GenerationOutcome:
    gen: int
    nprocs: int
    ok: bool
    wall_s: float
    pids: list[int] = field(default_factory=list)
    failed_rank: int | None = None
    rc: int | None = None
    hang_killed: bool = False
    classification: Classification | None = None
    lost_work_s: float = 0.0
    teardown_s: float = 0.0


@dataclass
class FleetResult:
    ok: bool
    verdict: str  # completed | deterministic | retries_exhausted |
    #               budget_exhausted
    generations: list[GenerationOutcome] = field(default_factory=list)
    final_nprocs: int = 0
    resized: bool = False
    trace_id: str | None = None

    @property
    def n_generations(self) -> int:
        return len(self.generations)


def collective_error(stderr_tail: str) -> bool:
    """True when the last error a rank's stderr shows is a collective that
    failed under it (a peer gone), not a failure of its own."""
    line = _crash_line(stderr_tail)
    return any(p in line for p in COLLECTIVE_ERROR_PATTERNS)


def root_cause(bad: list[tuple[int, int, str]]) -> int:
    """The failed rank among ``(rank, returncode, stderr tail)`` of the
    ranks first seen to have failed, in one poll: a death by a signal
    first, then an error of the rank's own, then a collective's error;
    the lowest rank among equals."""
    def order(item):
        rank, rc, tail = item
        if rc < 0:
            return (0, rank)
        return (2 if collective_error(tail) else 1, rank)

    return min(bad, key=order)[0]


class FleetSupervisor(SupervisorTelemetry):
    """Launch and heal an N-rank fleet by the module's rules.

    ``cmd_template`` is each rank's command, with the ``TEMPLATE_KEYS``
    placeholders. ``ckpt_dir`` (optional) is the fleet's shared checkpoint
    directory: each relaunch reports the last manifest-verified checkpoint
    in it (read from the filesystem; the ranks restore it themselves), and
    the lost work counts from its last publish. ``metrics_port`` starts the
    telemetry plane over every rank's stream under ``run_dir``, as the run
    supervisor's does."""

    def __init__(
        self,
        cmd_template: Sequence[str],
        run_dir: Path | str,
        cfg: FleetConfig | None = None,
        env: dict | None = None,
        ckpt_dir: Path | str | None = None,
        metrics_port: int | None = None,
        slo_rules=None,
    ) -> None:
        self.cmd_template = [str(a) for a in cmd_template]
        self.run_dir = Path(run_dir)
        self.cfg = cfg or FleetConfig()
        if self.cfg.min_nprocs > self.cfg.nprocs:
            raise ValueError("min_nprocs exceeds nprocs")
        self.base_env = dict(os.environ if env is None else env)
        self.ckpt_dir = Path(ckpt_dir) if ckpt_dir else None
        # One trace id for every generation (the caller's, when its env
        # carries one), exported to every rank.
        self.trace_id = self.base_env.get(TRACE_ENV) or new_trace_id()
        self.base_env[TRACE_ENV] = self.trace_id
        self._init_telemetry(
            self.run_dir / "supervisor", f"fleet-{self.run_dir.name}",
            metrics_port, slo_rules, self.run_dir)
        self._run_span = None
        self._gen_span = None
        self._ranks: list[_Rank] = []

    # ------------------------------------------------------------ telemetry

    def _audit_schedule(self, gen: int) -> dict:
        """The generation's ranks' collective schedules held against each
        other, whatever the verdict: a generation that exited 0 can still
        have issued schedules that differ, and a failed one gets its
        diagnosis beside the relaunch. Forensics never kill supervision."""
        try:
            audit = audit_schedules(
                read_rank_schedules(self.run_dir / f"g{gen}"))
        except Exception:
            return {"ok": True, "verdict": "unavailable"}
        self._event(
            "schedule_audit",
            gen=gen,
            ok=audit["ok"],
            verdict=audit["verdict"],
            divergent_rank=audit.get("divergent_rank"),
            step=audit.get("step"),
            detail=audit.get("detail"),
        )
        if not audit["ok"]:
            print(f"[fleetsup] g{gen} collective schedule DIVERGED: "
                  f"{audit.get('detail')}", file=sys.stderr, flush=True)
        return audit

    # ------------------------------------------------------------- evidence

    def _verified_checkpoint(self) -> str | None:
        from masters_thesis_tpu_torch.train.manifest import (
            last_verified_checkpoint,
        )

        return last_verified_checkpoint(self.ckpt_dir)

    # ------------------------------------------------------------ lifecycle

    def _coordinator(self, gen: int) -> str:
        """A rendezvous no earlier generation used."""
        rdzv = self.run_dir / f"g{gen}" / "rdzv"
        rdzv.mkdir(parents=True, exist_ok=True)
        return "file://" + str((rdzv / "store").resolve())

    def _coordinator_up(self, coordinator: str) -> bool:
        """Rank 0 creates the store when it opens the group."""
        return Path(coordinator.removeprefix("file://")).exists()

    def _launch_generation(self, gen: int, world: int,
                           coordinator: str) -> None:
        gen_dir = self.run_dir / f"g{gen}"
        env_base = dict(self.base_env)
        env_base[ATTEMPT_ENV] = str(gen + 1)
        env_base[GENERATION_ENV] = str(gen)
        tracer = self._tracer()
        if tracer is not None:
            self._gen_span = tracer.start(
                "fleet.generation", parent=self._run_span, gen=gen,
                nprocs=world,
            )
            # Each rank's root span hangs off this generation's: one trace
            # covers the supervisor and every rank of every generation.
            env_base[PARENT_SPAN_ENV] = self._gen_span.span_id
        self._ranks = []
        for rank in range(world):
            rank_dir = gen_dir / f"p{rank}"
            rank_dir.mkdir(parents=True, exist_ok=True)
            subst = {
                "rank": rank,
                "world": world,
                "coordinator": coordinator,
                "gen": gen,
                "out": rank_dir,
                "root": self.run_dir,
            }
            cmd = [_fill(a, subst) for a in self.cmd_template]
            out_path = gen_dir / f"p{rank}.out"
            err_path = gen_dir / f"p{rank}.err"
            out_f = open(out_path, "wb")
            err_f = open(err_path, "wb")
            proc = subprocess.Popen(
                cmd,
                stdout=out_f,
                stderr=err_f,
                env=rank_env(coordinator, rank, world, env_base),
                start_new_session=True,  # killpg reaches the rank's tree only
            )
            self._ranks.append(
                _Rank(rank, proc, rank_dir, out_path, err_path,
                      (out_f, err_f))
            )

    def _terminate_all(self, why: str) -> None:
        """SIGTERM every live rank's process group, ONE grace period for the
        whole fleet, SIGKILL what is left; reap them all."""
        live = [r for r in self._ranks if r.proc.poll() is None]
        if live:
            print(f"[fleetsup] terminating {len(live)} rank(s): {why} "
                  f"(SIGTERM, {self.cfg.term_grace_s:.0f}s grace, SIGKILL)",
                  file=sys.stderr, flush=True)
        for r in live:
            try:
                os.killpg(r.proc.pid, signal.SIGTERM)
            except (ProcessLookupError, PermissionError):
                pass
        deadline = time.monotonic() + self.cfg.term_grace_s
        for r in live:
            try:
                r.proc.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                try:
                    os.killpg(r.proc.pid, signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    pass
        for r in self._ranks:
            if r.proc.poll() is None:
                try:
                    r.proc.wait(timeout=10.0)
                except subprocess.TimeoutExpired:  # pragma: no cover
                    pass
            for f in r.files:
                try:
                    f.close()
                except OSError:
                    pass

    # -------------------------------------------------------- one generation

    def _run_generation(
        self, gen: int, world: int, resumed_from: str | None
    ) -> GenerationOutcome:
        cfg = self.cfg
        coordinator = self._coordinator(gen)
        self._event(
            "fleet_generation_started",
            gen=gen,
            nprocs=world,
            coordinator=coordinator,
            resumed_from=resumed_from,
            cmd=shlex.join(self.cmd_template),
        )
        start_ts = time.time()
        t0 = time.monotonic()
        self._gen_span = None
        self._launch_generation(gen, world, coordinator)
        coord_up = False
        failed: _Rank | None = None
        failed_at = None
        hang_killed = False
        why = ""
        teardown_s = 0.0
        try:
            while True:
                time.sleep(cfg.poll_interval_s)
                rcs = {r.rank: r.proc.poll() for r in self._ranks}
                bad = [r for r in self._ranks if rcs[r.rank] not in (None, 0)]
                if bad:
                    failed_at = time.time()
                    chosen = root_cause([(r.rank, rcs[r.rank],
                                          _tail(r.err_path)) for r in bad])
                    failed = self._ranks[chosen]
                    why = (f"rank {failed.rank} exited "
                           f"rc={exit_code(rcs[failed.rank])}")
                    break
                if all(rc == 0 for rc in rcs.values()):
                    break  # the whole fleet finished
                now = time.monotonic()
                if not coord_up:
                    coord_up = self._coordinator_up(coordinator)
                    if (not coord_up and cfg.boot_timeout_s is not None
                            and now - t0 > cfg.boot_timeout_s):
                        failed, failed_at = self._ranks[0], time.time()
                        why = ("coordinator never came up within "
                               f"{cfg.boot_timeout_s:.0f}s")
                        break
                if cfg.hang_timeout_s and now - t0 > cfg.hang_timeout_s:
                    stale = self._find_hung_rank(rcs, gen, start_ts)
                    if stale is not None:
                        failed, failed_at = stale, time.time()
                        hang_killed = True
                        why = f"rank {stale.rank} heartbeat stale"
                        break
        finally:
            # Whatever ends the loop (success, a failure, an error in the
            # supervisor itself) ends the generation: every rank goes. After
            # a success every rank has exited 0 and this only reaps.
            t_down = time.monotonic()
            self._terminate_all(why or "generation over")
            teardown_s = time.monotonic() - t_down
        wall_s = time.monotonic() - t0
        pids = [r.proc.pid for r in self._ranks]

        if failed is None:
            if self._trace is not None and self._gen_span is not None:
                self._trace.end(self._gen_span, status="ok", nprocs=world)
            return GenerationOutcome(gen=gen, nprocs=world, ok=True,
                                     wall_s=wall_s, pids=pids,
                                     teardown_s=teardown_s)
        raw = None if hang_killed else failed.proc.poll()
        rc = None if raw is None else exit_code(raw)
        phase, epoch = crash_context(failed.dir, start_ts)
        cls = classify_exit(
            raw,
            _tail(failed.err_path),
            hang_killed=hang_killed,
            crash_phase=phase,
            crash_epoch=epoch,
        )
        _, published = last_publish(self.ckpt_dir)
        lost = max(0.0, failed_at - (published if published is not None
                                     and published > start_ts
                                     else start_ts))
        if self._trace is not None and self._gen_span is not None:
            self._trace.end(self._gen_span, status="error",
                            failed_rank=failed.rank,
                            classification=cls.kind)
        self._event(
            "fleet_failure",
            gen=gen,
            rank=failed.rank,
            rc=rc,
            hang=hang_killed,
            classification=cls.kind,
            reason=cls.reason[:500],
            fingerprint=cls.fingerprint,
            failed_at_ts=failed_at,
            lost_work_s=lost,
            teardown_s=teardown_s,
        )
        print(f"[fleetsup] generation {gen} failed: {why} "
              f"({cls.kind}: {cls.reason})", file=sys.stderr, flush=True)
        return GenerationOutcome(
            gen=gen, nprocs=world, ok=False, wall_s=wall_s, pids=pids,
            failed_rank=failed.rank, rc=rc, hang_killed=hang_killed,
            classification=cls, lost_work_s=lost, teardown_s=teardown_s,
        )

    def _find_hung_rank(self, rcs: dict, gen: int,
                        since_ts: float) -> _Rank | None:
        """The first running rank whose last progress beat of this
        generation is older than ``hang_timeout_s`` (or that a fault plan
        wedged, ``fleet.rank_heartbeat`` with ``rank`` and ``gen``)."""
        now = time.time()
        for r in self._ranks:
            if rcs[r.rank] is not None:
                continue  # a rank that exited 0 is done, not hung
            if faults.fire("fleet.rank_heartbeat", rank=r.rank,
                           gen=gen) == "wedge":
                return r
            ts = last_heartbeat_ts(r.dir, since_ts)
            # No beat at all counts from the generation's start (the
            # caller's elapsed > hang_timeout_s gate): a rank that never
            # got far enough to beat is as gone as one that stopped.
            if ts is None or now - ts > self.cfg.hang_timeout_s:
                return r
        return None

    # ------------------------------------------------------------- the loop

    def run(self) -> FleetResult:
        cfg = self.cfg
        result = FleetResult(ok=False, verdict="retries_exhausted",
                             final_nprocs=cfg.nprocs, trace_id=self.trace_id)
        tracer = self._tracer()
        if tracer is not None:
            self._run_span = tracer.start("fleet.run")
        self._event(
            "fleet_started",
            nprocs=cfg.nprocs,
            min_nprocs=cfg.min_nprocs,
            max_relaunches_per_size=cfg.max_relaunches_per_size,
            max_generations=cfg.max_generations,
            hang_timeout_s=cfg.hang_timeout_s,
            cmd=shlex.join(self.cmd_template),
            trace_id=self.trace_id,
        )
        self._start_plane()
        world = cfg.nprocs
        gen = 0
        relaunches_at_size = 0
        last_fp: str | None = None
        backoff = DecorrelatedBackoff(cfg.backoff_s, cfg.max_backoff_s,
                                      cfg.backoff_factor)
        try:
            while True:
                resumed_from = self._verified_checkpoint()
                outcome = self._run_generation(gen, world, resumed_from)
                result.generations.append(outcome)
                self._audit_schedule(gen)
                result.final_nprocs = world
                if outcome.ok:
                    result.ok = True
                    result.verdict = "completed"
                    break
                cls = outcome.classification
                deterministic = (cls is not None
                                 and cls.fingerprint is not None
                                 and cls.fingerprint == last_fp)
                last_fp = cls.fingerprint if cls is not None else None
                if gen + 1 >= cfg.max_generations:
                    result.verdict = "budget_exhausted"
                    break
                if (deterministic
                        or relaunches_at_size >= cfg.max_relaunches_per_size):
                    if world - 1 < cfg.min_nprocs:
                        result.verdict = ("deterministic" if deterministic
                                          else "retries_exhausted")
                        break
                    reason = (
                        "deterministic host loss (fingerprint "
                        f"{last_fp} reproduced)" if deterministic
                        else "full-size relaunch budget spent "
                        f"({cfg.max_relaunches_per_size})"
                    )
                    self._event("fleet_resized", gen=gen + 1,
                                from_nprocs=world, to_nprocs=world - 1,
                                reason=reason, fingerprint=last_fp)
                    print(f"[fleetsup] resizing fleet {world} -> "
                          f"{world - 1}: {reason}", file=sys.stderr,
                          flush=True)
                    world -= 1
                    result.resized = True
                    relaunches_at_size = 0
                    # A fresh fingerprint chain at the new size: the retired
                    # rank's failure must not condemn N-1 at once.
                    last_fp = None
                else:
                    relaunches_at_size += 1
                delay = backoff.next()
                self._event(
                    "fleet_relaunch",
                    gen=gen + 1,
                    nprocs=world,
                    backoff_s=delay,
                    # Read now, not at the loop's top: the dead generation
                    # may have published checkpoints since.
                    resumed_from=self._verified_checkpoint(),
                    reason=(cls.reason[:500] if cls is not None else None),
                )
                time.sleep(delay)
                gen += 1
        finally:
            # No verdict leaves a rank behind, even when the supervisor
            # itself failed mid-generation.
            self._terminate_all("fleet verdict")
        if tracer is not None and self._run_span is not None:
            tracer.end(self._run_span,
                       status="ok" if result.ok else "error",
                       verdict=result.verdict,
                       generations=result.n_generations,
                       final_nprocs=result.final_nprocs)
            self._run_span = None
        self._event(
            "fleet_verdict",
            ok=result.ok,
            verdict=result.verdict,
            generations=result.n_generations,
            final_nprocs=result.final_nprocs,
            resized=result.resized,
            trace_id=self.trace_id,
        )
        self._close_telemetry()
        return result


def _fill(arg: str, subst: dict) -> str:
    """Fill the ``{key}`` placeholders without ``str.format``, so that an
    argument holding other braces passes through untouched."""
    for key in TEMPLATE_KEYS:
        arg = arg.replace("{" + key + "}", str(subst[key]))
    return arg
