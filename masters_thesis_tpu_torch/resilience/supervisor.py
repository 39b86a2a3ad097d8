"""The run supervisor: a training command run as a supervised child.

Counterpart of ``masters_thesis_tpu/resilience/supervisor.py``. The
supervisor owns the retry loop the trainer cannot own (it is the process
that dies): it launches the command as a child, watches its heartbeat
(``heartbeat.json`` of the child's flight recorder), classifies how it
ended from the same evidence the report reads (the return code, the
stderr tail, the crashdump, the child's event stream), and decides, by
classification, between

- ``transient`` (a signal, a hang, an unavailable backend, the first
  occurrence of an unknown crash): retry after a decorrelated backoff,
  under ``max_retries`` and an optional wall budget ``retry_budget_s``;
- ``divergence`` (the child's stream ends in ``run_finished`` with
  ``diverged``): relaunch from the last good checkpoint (the trainer
  never saves a diverged epoch) with ``MTT_LR_SCALE`` compounded by
  ``lr_factor``, at most ``rollback_attempts`` times;
- ``deterministic`` (the same crash fingerprint twice, or a divergence at
  the same epoch twice): halt with a verdict.

Each launch exports ``MTT_ATTEMPT`` (the child's events carry it, and
fault plans are scoped to an attempt) and the run's one trace id with the
attempt's span (``MTT_TRACE_ID``, ``MTT_PARENT_SPAN``). The supervisor
writes its own ``events.jsonl`` (``supervisor_started``,
``attempt_started``, ``attempt_finished`` with ``lost_work_s``, ``retry``,
``rollback``, ``supervisor_verdict``) and spans (``supervisor.run``,
``supervisor.attempt``) under ``run_dir``, with each attempt's stdout and
stderr.

Where it differs from the JAX supervisor: the hang watch reads only the
heartbeats written during the current attempt (a dead attempt's stale
heartbeat left in the watch dir no longer counts against the next
attempt while it starts); with ``probe=True`` the card is probed before
each attempt (one attempt of ``utils/backend_probe.py``'s
``BackendHealth``; the supervisor owns the retries), and a failed probe is
recorded as a ``degradation`` event with ``fallback: null`` and
``probe_attempts``, after which the attempt runs on the card all the same:
the JAX supervisor's ``cpu_fallback=False``, the port's only behaviour (a
child pinned to the CPU is the fallback the port forbids; its environment
is never changed). :class:`ReplicaRestartPolicy` is the
serving fleet's (``serve/fleet.py``). N ranks are
``resilience/fleetsup.py``'s.
``metrics_port`` starts the telemetry plane over the children's streams
(``watch_dir``, else ``run_dir``): an SLO engine with ``slo_rules``
(default ``default_train_rules()``) and the ``/metrics``, ``/healthz``
and ``/slo`` server on the supervisor's own registry; a plane that fails
to start or stop never stops the supervision.

It imports no torch: it must work when the card's runtime is wedged.
Checkpoints are read from the filesystem only; the child does the real
restore.
"""

from __future__ import annotations

import hashlib
import os
import re
import shlex
import signal
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Sequence

from masters_thesis_tpu_torch.resilience.backoff import DecorrelatedBackoff
from masters_thesis_tpu_torch.resilience.faults import ATTEMPT_ENV
from masters_thesis_tpu_torch.telemetry.trace import (
    PARENT_SPAN_ENV,
    TRACE_ENV,
    new_trace_id,
)

LR_SCALE_ENV = "MTT_LR_SCALE"
TERM_GRACE_S = 15.0
#: Child stdout/stderr tail kept for fingerprinting + attempt logs.
TAIL_BYTES = 8192

TRANSIENT_PATTERNS = (
    # The backend dropping out from under a live run: retriable.
    "UNAVAILABLE",
    "DEADLINE_EXCEEDED",
    "Socket closed",
    "failed to connect",
)


@dataclass
class SupervisorConfig:
    max_retries: int = 3  # transient retries (attempts = 1 + retries)
    backoff_s: float = 5.0
    backoff_factor: float = 2.0
    max_backoff_s: float = 300.0
    retry_budget_s: float | None = None  # wall budget across ALL attempts
    attempt_timeout_s: float | None = None  # per-attempt wall cap
    rollback_attempts: int = 2  # divergence rollbacks
    lr_factor: float = 0.5  # LR scale per rollback (1.0 = no change)
    hang_timeout_s: float | None = None  # heartbeat staleness -> kill
    term_grace_s: float = TERM_GRACE_S
    probe: bool = False  # probe the card before each attempt
    probe_timeout_s: float = 120.0
    probe_cache: Path | str | None = None  # default: <run_dir>/probe_cache.json


@dataclass
class Classification:
    kind: str  # success | transient | divergence | deterministic | timeout
    reason: str
    fingerprint: str | None = None
    diverged_epoch: int | None = None


@dataclass
class AttemptOutcome:
    attempt: int
    rc: int | None
    wall_s: float
    classification: Classification
    lost_work_s: float = 0.0
    hang_killed: bool = False


@dataclass
class ReplicaVerdict:
    """What the serving fleet does with a dead replica."""

    action: str  # restart | halt
    kind: str  # transient | deterministic | budget_exhausted
    backoff_s: float
    detail: str = ""


class ReplicaRestartPolicy:
    """Restart classification for the serving fleet's replicas, by evidence.

    The supervisor's discipline applied in-process (a replica is a worker
    thread and an engine, not a child process): a death is retriable until
    the evidence says otherwise —

    - the same failure fingerprint on two CONSECUTIVE deaths is
      deterministic (a restart would replay the same failure);
    - a per-replica restart budget bounds a flapping replica;
    - restarts back off exponentially (milliseconds: a dead replica is
      capacity, and the queue sheds what the survivors cannot cover).

    A served batch resets the fingerprint chain (:meth:`note_healthy`): a
    crash, clean traffic, then the same crash is a fresh incident. The
    defaults are the JAX policy's.
    """

    def __init__(self, max_restarts: int = 3, backoff_s: float = 0.05,
                 backoff_factor: float = 2.0, max_backoff_s: float = 2.0):
        self.max_restarts = max_restarts
        self.backoff_s = backoff_s
        self.backoff_factor = backoff_factor
        self.max_backoff_s = max_backoff_s
        self._state: dict[str, dict] = {}

    def _entry(self, replica: str) -> dict:
        return self._state.setdefault(replica,
                                      {"restarts": 0, "last_fp": None})

    def note_healthy(self, replica: str) -> None:
        entry = self._state.get(replica)
        if entry is not None:
            entry["last_fp"] = None

    def restarts(self, replica: str) -> int:
        return self._entry(replica)["restarts"]

    def classify(self, replica: str, fingerprint: str,
                 detail: str = "") -> ReplicaVerdict:
        entry = self._entry(replica)
        if fingerprint and entry["last_fp"] == fingerprint:
            return ReplicaVerdict(
                "halt", "deterministic", 0.0,
                "identical failure fingerprint on consecutive deaths "
                f"({fingerprint}): {detail}")
        if entry["restarts"] >= self.max_restarts:
            return ReplicaVerdict(
                "halt", "budget_exhausted", 0.0,
                f"restart budget exhausted ({self.max_restarts}): {detail}")
        entry["last_fp"] = fingerprint
        entry["restarts"] += 1
        backoff = min(
            self.backoff_s * self.backoff_factor ** (entry["restarts"] - 1),
            self.max_backoff_s)
        return ReplicaVerdict("restart", "transient", backoff, detail)


@dataclass
class SupervisorResult:
    ok: bool
    verdict: str  # completed | deterministic | retries_exhausted |
    #               budget_exhausted | rollback_exhausted
    attempts: list[AttemptOutcome] = field(default_factory=list)
    lost_work_s: float = 0.0

    @property
    def n_attempts(self) -> int:
        return len(self.attempts)


def _tail(path: Path, n: int = TAIL_BYTES) -> str:
    try:
        data = path.read_bytes()
    except OSError:
        return ""
    return data[-n:].decode(errors="replace")


def _crash_line(stderr_tail: str) -> str:
    """The most identifying line of a crash: the final exception line
    (``Error: ...``) if present, else the last non-empty line."""
    lines = [ln.strip() for ln in stderr_tail.splitlines() if ln.strip()]
    for ln in reversed(lines):
        if re.match(r"^[\w.]*(Error|Exception|Exit|Abort)", ln):
            return ln
    return lines[-1] if lines else ""


def _read_json(path: Path) -> dict | None:
    import json

    try:
        obj = json.loads(path.read_text())
    except (OSError, ValueError):
        return None
    return obj if isinstance(obj, dict) else None


def classify_exit(
    rc: int | None,
    stderr_tail: str,
    *,
    hang_killed: bool = False,
    timed_out: bool = False,
    diverged_epoch: int | None = None,
    crash_phase: str | None = None,
    crash_epoch: int | None = None,
) -> Classification:
    """Evidence-based exit classification, the JAX function's rules. The
    caller supplies what it read from disk:
    the stderr tail, any divergence verdict from the child's event
    stream, and the phase/epoch of the freshest crashdump this attempt
    produced (both feed the crash fingerprint, so "died in checkpoint
    publish at epoch 3" and "died in data load at epoch 0" are distinct
    failures even with identical stderr)."""
    if timed_out:
        return Classification("timeout", "attempt wall-clock cap hit")
    if hang_killed:
        return Classification(
            "transient", "hang: heartbeat went stale (watchdog kill)"
        )
    # Divergence first: the trainer HALTS on NaN but exits 0, so the
    # verdict lives in the child's event stream, not the return code.
    if diverged_epoch is not None:
        return Classification(
            "divergence",
            f"run diverged (non-finite loss) at epoch {diverged_epoch}",
            fingerprint=f"nan@epoch{diverged_epoch}",
            diverged_epoch=diverged_epoch,
        )
    if rc == 0:
        return Classification("success", "exited 0")
    if rc is not None and rc < 0:
        sig = -rc
        name = (
            signal.Signals(sig).name
            if sig in signal.Signals._value2member_map_
            else str(sig)
        )
        return Classification(
            "transient", f"killed by {name} (preemption-shaped)"
        )
    if any(p in stderr_tail for p in TRANSIENT_PATTERNS):
        return Classification(
            "transient",
            f"backend unavailable (rc={rc}): "
            f"{_crash_line(stderr_tail)}",
        )
    # Unknown crash: fingerprint it; the retry loop halts when the
    # same fingerprint reproduces (deterministic by evidence).
    crash_line = _crash_line(stderr_tail)
    fp = hashlib.sha1(
        f"{rc}|{crash_line}|{crash_phase}|{crash_epoch}".encode()
    ).hexdigest()[:12]
    return Classification(
        "transient",
        f"crash (rc={rc}): {crash_line or 'no stderr'}",
        fingerprint=fp,
    )


def last_heartbeat_ts(root: Path | None, since_ts: float = 0.0) -> float | None:
    """The newest progress beat among the flight-recorder heartbeats under
    ``root`` written since ``since_ts`` (the attempt's or the generation's
    start): a dead launch's heartbeat, stale by construction, does not
    count against the next one."""
    if root is None or not root.exists():
        return None
    from masters_thesis_tpu_torch.telemetry.flightrec import (
        HEARTBEAT_FILENAME,
    )

    best = None
    for hb in sorted(root.rglob(HEARTBEAT_FILENAME)):
        obj = _read_json(hb)
        try:
            written = (obj or {}).get("ts") or hb.stat().st_mtime
        except OSError:
            continue
        if written < since_ts:
            continue
        # last_beat_ts is the PROGRESS marker; the file's own ts keeps
        # advancing while the main thread hangs (the heartbeat thread
        # outlives it), so it must not count.
        ts = obj.get("last_beat_ts") if obj else None
        if ts is None:
            ts = written
        best = ts if best is None else max(best, ts)
    return best


def crash_context(root: Path | None,
                  since_ts: float) -> tuple[str | None, int | None]:
    """The phase and epoch of the newest crashdump under ``root`` written
    since ``since_ts``: both feed the crash fingerprint."""
    if root is None or not root.exists():
        return None, None
    from masters_thesis_tpu_torch.telemetry.flightrec import (
        CRASHDUMP_FILENAME,
    )

    phase = epoch = None
    for p in sorted(root.rglob(CRASHDUMP_FILENAME)):
        dump = _read_json(p)
        if dump and (dump.get("ts") or 0.0) >= since_ts:
            phase, epoch = dump.get("phase"), dump.get("epoch")
    return phase, epoch


def last_publish(ckpt_dir: Path | None) -> tuple[str | None, float | None]:
    """(resume path, publish time) of the last-good checkpoint, read from
    the filesystem only.

    The sidecar json is the publish's final rename, so its presence
    means a complete pair, and its mtime is when the publish ended;
    verification and recovery are the child trainer's job (it imports
    the checkpoint machinery)."""
    if ckpt_dir is None:
        return None, None
    for tag in ("last", "last.prev"):
        tree = ckpt_dir / tag
        sidecar = ckpt_dir / f"{tag}.json"
        if tree.exists() and sidecar.exists():
            try:
                return str(tree), sidecar.stat().st_mtime
            except OSError:
                return str(tree), None
    return None, None


class SupervisorTelemetry:
    """What both supervisors keep of their own: an event stream and spans
    under the run's one trace id, and the telemetry plane (``/metrics``,
    ``/healthz``, ``/slo`` and an SLO engine over the children's streams).
    Nothing here may stop the supervision: a stream that cannot be
    written, or a plane that fails to start or stop, is dropped."""

    def _init_telemetry(self, tel_dir: Path, run_id: str,
                        metrics_port: int | None, slo_rules,
                        plane_root: Path) -> None:
        self._tel_dir, self._tel_run_id = tel_dir, run_id
        # None: no plane; 0: an ephemeral port.
        self.metrics_port = metrics_port
        self._slo_rules = slo_rules
        self._plane_root = plane_root
        self._tel = self._trace = None
        self._exposition = self._slo_engine = None

    def _telemetry(self):
        if self._tel is None:
            from masters_thesis_tpu_torch.telemetry.run import TelemetryRun

            self._tel = TelemetryRun(self._tel_dir, run_id=self._tel_run_id)
        return self._tel

    def _event(self, kind: str, **payload) -> None:
        try:
            self._telemetry().event(kind, **payload)
        except Exception:
            # The supervisor's own telemetry must never kill supervision.
            pass

    def _tracer(self):
        """Span writer on the supervisor's own stream, pinned to the
        run's stable trace id (the supervisor's process env may not carry
        it — it lives in base_env for the children)."""
        if self._trace is None:
            try:
                from masters_thesis_tpu_torch.telemetry.trace import Tracer

                tel = self._telemetry()
                self._trace = Tracer(tel.sink, trace_id=self.trace_id)
                # Share with the TelemetryRun so close() aborts leftovers.
                tel._tracer = self._trace
            except Exception:
                return None
        return self._trace

    def _start_plane(self) -> None:
        if self.metrics_port is None:
            return
        try:
            from masters_thesis_tpu_torch.telemetry.exposition import (
                start_telemetry_plane,
            )
            from masters_thesis_tpu_torch.telemetry.slo import (
                default_train_rules,
            )

            self._exposition, self._slo_engine = start_telemetry_plane(
                self._telemetry(), self.metrics_port,
                rules=self._slo_rules or default_train_rules(),
                root=self._plane_root)
        except Exception:
            # Monitoring must never kill supervision.
            self._exposition = self._slo_engine = None

    def _close_telemetry(self) -> None:
        """Stop the plane (its engine ticks once more) and close the
        stream."""
        if self._exposition is not None or self._slo_engine is not None:
            try:
                from masters_thesis_tpu_torch.telemetry.exposition import (
                    stop_telemetry_plane,
                )

                stop_telemetry_plane(self._exposition, self._slo_engine)
            except Exception:
                pass
            self._exposition = self._slo_engine = None
        if self._tel is not None:
            try:
                self._tel.close()
            except Exception:
                pass


class RunSupervisor(SupervisorTelemetry):
    """Supervise ``cmd`` to completion, retrying/rolling back per policy.

    ``watch_dir`` is where the CHILD's telemetry lands (heartbeat.json for
    hang detection, events.jsonl for the divergence verdict); ``run_dir``
    holds the supervisor's own stream + per-attempt stdout/stderr logs.
    ``ckpt_dir`` (optional) enables filesystem-level resume/lost-work
    accounting; ``passthrough`` echoes child output to this process's
    stdout/stderr (for pipeline use, e.g. bench's JSON line).
    """

    def __init__(
        self,
        cmd: Sequence[str],
        run_dir: Path | str,
        cfg: SupervisorConfig | None = None,
        env: dict | None = None,
        cwd: Path | str | None = None,
        watch_dir: Path | str | None = None,
        ckpt_dir: Path | str | None = None,
        passthrough: bool = False,
        metrics_port: int | None = None,
        slo_rules=None,
    ) -> None:
        self.cmd = list(cmd)
        self.run_dir = Path(run_dir)
        self.cfg = cfg or SupervisorConfig()
        self.base_env = dict(os.environ if env is None else env)
        self.cwd = str(cwd) if cwd is not None else None
        self.watch_dir = Path(watch_dir) if watch_dir else None
        self.ckpt_dir = Path(ckpt_dir) if ckpt_dir else None
        self.passthrough = passthrough
        self._init_telemetry(
            self.run_dir, f"supervisor-{self.run_dir.name}", metrics_port,
            slo_rules, self.watch_dir or self.run_dir)
        # One stable trace id for the WHOLE supervised run: adopted from
        # the caller's env when present (a grid runner tracing the cell),
        # minted once otherwise — and propagated FORWARD to every attempt
        # via the env, so retries and rollbacks share the trace instead of
        # being stitched together after the fact.
        self.trace_id = self.base_env.get(TRACE_ENV) or new_trace_id()
        self.base_env[TRACE_ENV] = self.trace_id
        self._run_span = None

    # ------------------------------------------------------------- evidence

    def _diverged_epoch(self, since_ts: float) -> int | None:
        """Did the child's event stream end in a divergence halt during
        this attempt? Returns the halting epoch (or -1 if unknown)."""
        if self.watch_dir is None or not self.watch_dir.exists():
            return None
        from masters_thesis_tpu_torch.telemetry.events import read_events
        from masters_thesis_tpu_torch.telemetry.report import EVENTS_FILENAME

        for stream in sorted(self.watch_dir.rglob(EVENTS_FILENAME)):
            events = [
                e
                for e in read_events(stream)
                if (e.get("ts") or 0.0) >= since_ts
            ]
            for ev in reversed(events):
                if ev.get("kind") == "run_finished":
                    if ev.get("diverged"):
                        epochs = [
                            e.get("epoch")
                            for e in events
                            if e.get("kind") == "epoch"
                            and e.get("epoch") is not None
                        ]
                        return int(max(epochs)) if epochs else -1
                    break
        return None

    # --------------------------------------------------------------- health

    def _check_backend(self) -> None:
        """The pre-attempt gate: one probe of the card. A failure is
        recorded (``degradation``, ``fallback: null``) and the attempt runs
        on the card as it would have: nothing is pinned to the CPU."""
        from masters_thesis_tpu_torch.utils.backend_probe import BackendHealth

        cache = self.cfg.probe_cache or self.run_dir / "probe_cache.json"
        health = BackendHealth(cache, timeout_s=self.cfg.probe_timeout_s)
        decision = health.ensure_responsive(single_attempt=True)
        if decision.ok:
            return
        self._event("degradation", reason=decision.detail or
                    "backend probe failed", fallback=None,
                    probe_attempts=decision.attempts,
                    known_wedged=decision.known_wedged)
        print(f"[supervisor] backend probe failed ({decision.attempts} "
              "attempt(s)); the attempt runs on the card all the same (no "
              "CPU fallback)", file=sys.stderr, flush=True)

    # ------------------------------------------------------------ the child

    def _launch(self, attempt: int, lr_scale: float) -> AttemptOutcome:
        cfg = self.cfg
        self.run_dir.mkdir(parents=True, exist_ok=True)
        out_path = self.run_dir / f"attempt_{attempt}.out"
        err_path = self.run_dir / f"attempt_{attempt}.err"
        env = dict(self.base_env)
        env[ATTEMPT_ENV] = str(attempt)
        if lr_scale != 1.0:
            env[LR_SCALE_ENV] = f"{lr_scale:g}"
        resumed_from, _ = last_publish(self.ckpt_dir)

        start_ts = time.time()
        t0 = time.monotonic()
        deadline = (
            t0 + cfg.attempt_timeout_s if cfg.attempt_timeout_s else None
        )
        tracer = self._tracer()
        attempt_span = None
        if tracer is not None:
            attempt_span = tracer.start(
                "supervisor.attempt", parent=self._run_span, n=attempt,
                lr_scale=lr_scale, resumed=bool(resumed_from),
            )
            # The child's root spans hang off this attempt span — one
            # trace covers the supervisor and every process it launches.
            env[PARENT_SPAN_ENV] = attempt_span.span_id
        self._event(
            "attempt_started",
            n=attempt,
            cmd=shlex.join(self.cmd),
            resumed_from=resumed_from,
            lr_scale=lr_scale,
            degraded=False,
            trace_id=self.trace_id,
        )

        with open(out_path, "wb") as out_f, open(err_path, "wb") as err_f:
            proc = subprocess.Popen(
                self.cmd,
                stdout=subprocess.PIPE if self.passthrough else out_f,
                stderr=subprocess.PIPE if self.passthrough else err_f,
                env=env,
                cwd=self.cwd,
                start_new_session=True,  # our signals, not the shell's
            )
            pumps = []
            if self.passthrough:
                pumps = [
                    threading.Thread(
                        target=_pump, args=(proc.stdout, sys.stdout, out_f),
                        daemon=True,
                    ),
                    threading.Thread(
                        target=_pump, args=(proc.stderr, sys.stderr, err_f),
                        daemon=True,
                    ),
                ]
                for t in pumps:
                    t.start()

            hang_killed = False
            rc: int | None = None
            while True:
                try:
                    rc = proc.wait(timeout=1.0)
                    break
                except subprocess.TimeoutExpired:
                    pass
                now = time.monotonic()
                if deadline is not None and now > deadline:
                    self._terminate(proc, "attempt timeout")
                    rc = proc.wait()
                    rc = None  # timeout, not the child's own exit
                    break
                if cfg.hang_timeout_s:
                    hb = last_heartbeat_ts(self.watch_dir, start_ts)
                    if (
                        hb is not None
                        and time.time() - hb > cfg.hang_timeout_s
                        and now - t0 > cfg.hang_timeout_s
                    ):
                        self._terminate(
                            proc,
                            f"heartbeat stale for {time.time() - hb:.0f}s",
                        )
                        proc.wait()
                        rc = None
                        hang_killed = True
                        break
            for t in pumps:
                t.join(timeout=5.0)

        wall_s = time.monotonic() - t0
        classification = self._classify(
            rc,
            start_ts,
            _tail(err_path),
            hang_killed=hang_killed,
            timed_out=(rc is None and not hang_killed),
        )
        # Lost work: wall since the last checkpoint publish this attempt
        # managed (none -> the whole attempt), 0 for successes.
        lost = 0.0
        if classification.kind != "success":
            _, ckpt_mtime_after = last_publish(self.ckpt_dir)
            if ckpt_mtime_after and ckpt_mtime_after > start_ts:
                lost = max(0.0, time.time() - ckpt_mtime_after)
            else:
                # No checkpoint published this attempt: all of it is lost.
                lost = wall_s
        outcome = AttemptOutcome(
            attempt=attempt,
            rc=rc,
            wall_s=wall_s,
            classification=classification,
            lost_work_s=lost,
            hang_killed=hang_killed,
        )
        if tracer is not None and attempt_span is not None:
            tracer.end(
                attempt_span,
                status="ok" if classification.kind == "success" else "error",
                rc=rc,
                classification=classification.kind,
            )
        self._event(
            "attempt_finished",
            n=attempt,
            rc=rc,
            ok=classification.kind == "success",
            wall_s=wall_s,
            classification=classification.kind,
            reason=classification.reason[:500],
            fingerprint=classification.fingerprint,
            lost_work_s=lost,
        )
        return outcome

    def _terminate(self, proc: subprocess.Popen, why: str) -> None:
        print(
            f"[supervisor] killing child pid {proc.pid}: {why} "
            f"(SIGTERM, {self.cfg.term_grace_s:.0f}s grace, then SIGKILL)",
            file=sys.stderr,
            flush=True,
        )
        try:
            os.killpg(proc.pid, signal.SIGTERM)
        except (ProcessLookupError, PermissionError):
            return
        try:
            proc.wait(timeout=self.cfg.term_grace_s)
        except subprocess.TimeoutExpired:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass

    # -------------------------------------------------------- classification

    def _classify(
        self,
        rc: int | None,
        start_ts: float,
        stderr_tail: str,
        hang_killed: bool,
        timed_out: bool,
    ) -> Classification:
        """Gather this attempt's on-disk evidence, then delegate to the
        shared :func:`classify_exit` rules."""
        diverged_epoch = None
        if not timed_out and not hang_killed:
            diverged_epoch = self._diverged_epoch(start_ts)
        phase, epoch = crash_context(self.watch_dir, start_ts)
        return classify_exit(
            rc,
            stderr_tail,
            hang_killed=hang_killed,
            timed_out=timed_out,
            diverged_epoch=diverged_epoch,
            crash_phase=phase,
            crash_epoch=epoch,
        )

    # ------------------------------------------------------------- the loop

    def run(self) -> SupervisorResult:
        cfg = self.cfg
        result = SupervisorResult(ok=False, verdict="retries_exhausted")
        tracer = self._tracer()
        if tracer is not None:
            self._run_span = tracer.start("supervisor.run")
        self._event(
            "supervisor_started",
            cmd=shlex.join(self.cmd),
            max_retries=cfg.max_retries,
            rollback_attempts=cfg.rollback_attempts,
            lr_factor=cfg.lr_factor,
            retry_budget_s=cfg.retry_budget_s,
            probe=bool(cfg.probe),
            trace_id=self.trace_id,
        )
        self._start_plane()
        t_start = time.monotonic()
        attempt = 0
        retries = rollbacks = 0
        lr_scale = 1.0
        # Decorrelated jitter: with many supervised runs (or a whole
        # fleet) restarting off the same failure, identical exponential
        # schedules would thundering-herd the coordinator/backend.
        # backoff_factor <= 1.0 keeps the old deterministic constant.
        backoff_policy = DecorrelatedBackoff(
            cfg.backoff_s, cfg.max_backoff_s, cfg.backoff_factor
        )
        seen_fingerprints: list[str] = []
        last_divergence: str | None = None

        while True:
            attempt += 1
            if cfg.probe:
                self._check_backend()
            outcome = self._launch(attempt, lr_scale)
            result.attempts.append(outcome)
            result.lost_work_s += outcome.lost_work_s
            cls = outcome.classification

            if cls.kind == "success":
                result.ok = True
                result.verdict = "completed"
                break
            if cls.kind == "timeout":
                result.verdict = "budget_exhausted"
                break

            if cls.kind == "divergence":
                if cls.fingerprint == last_divergence:
                    result.verdict = "deterministic"
                    self._event(
                        "verdict_deterministic",
                        reason=(
                            "divergence reproduced at the same epoch after "
                            "rollback: " + cls.reason
                        ),
                    )
                    break
                last_divergence = cls.fingerprint
                if rollbacks >= cfg.rollback_attempts:
                    result.verdict = "rollback_exhausted"
                    break
                rollbacks += 1
                lr_scale *= cfg.lr_factor
                resume_from, _ = last_publish(self.ckpt_dir)
                self._event(
                    "rollback",
                    n=rollbacks,
                    lr_scale=lr_scale,
                    resume_from=resume_from,
                    reason=cls.reason,
                )
                print(
                    f"[supervisor] divergence rollback {rollbacks}/"
                    f"{cfg.rollback_attempts}: resume from last-good with "
                    f"LR x{lr_scale:g}",
                    file=sys.stderr,
                    flush=True,
                )
                continue  # rollback relaunches immediately (no backoff)

            # transient
            if cls.fingerprint and cls.fingerprint in seen_fingerprints:
                result.verdict = "deterministic"
                self._event(
                    "verdict_deterministic",
                    reason="identical crash fingerprint reproduced: "
                    + cls.reason,
                    fingerprint=cls.fingerprint,
                )
                break
            if cls.fingerprint:
                seen_fingerprints.append(cls.fingerprint)
            if retries >= cfg.max_retries:
                result.verdict = "retries_exhausted"
                break
            backoff = backoff_policy.next()
            if (
                cfg.retry_budget_s is not None
                and time.monotonic() - t_start + backoff > cfg.retry_budget_s
            ):
                result.verdict = "budget_exhausted"
                break
            retries += 1
            self._event(
                "retry", n=retries, backoff_s=backoff, reason=cls.reason[:500]
            )
            print(
                f"[supervisor] transient failure ({cls.reason}); retry "
                f"{retries}/{cfg.max_retries} in {backoff:.1f}s",
                file=sys.stderr,
                flush=True,
            )
            time.sleep(backoff)

        if tracer is not None and self._run_span is not None:
            tracer.end(
                self._run_span,
                status="ok" if result.ok else "error",
                verdict=result.verdict,
                attempts=result.n_attempts,
            )
            self._run_span = None
        self._event(
            "supervisor_verdict",
            ok=result.ok,
            verdict=result.verdict,
            attempts=result.n_attempts,
            restarts=max(0, result.n_attempts - 1),
            lost_work_s=result.lost_work_s,
            degraded=False,
            trace_id=self.trace_id,
        )
        self._close_telemetry()
        return result


def _pump(src, mirror, sink) -> None:
    """Forward a child stream to (console mirror, log file) line-wise."""
    for chunk in iter(lambda: src.readline(), b""):
        try:
            sink.write(chunk)
            sink.flush()
        except (OSError, ValueError):
            pass
        try:
            mirror.buffer.write(chunk)
            mirror.flush()
        except (AttributeError, OSError, ValueError):
            try:
                mirror.write(chunk.decode(errors="replace"))
                mirror.flush()
            except (OSError, ValueError):
                pass
    src.close()
