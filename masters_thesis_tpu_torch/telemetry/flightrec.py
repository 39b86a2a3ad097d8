"""In-process flight recorder: a killed or hung run still explains itself.

Counterpart of ``masters_thesis_tpu/telemetry/flightrec.py``. The recorder
keeps a bounded ring of recent telemetry events, the last-known
epoch/capture/memory state and short histories of the loss and the LR,
and dumps all of it, with every thread's stack, to ``crashdump.json``
under the run dir when the process is told to die (SIGTERM, SIGQUIT),
when a fatal signal fires (:mod:`faulthandler` into ``fatal.log``), or
when the heartbeat watchdog sees no progress beat for ``hang_timeout_s``.

A thread writes ``heartbeat.json`` (atomic replace) every few seconds, so
the outside world (the run supervisor, ``resilience/supervisor.py``) can
tell a live process from a dead or hung one even after SIGKILL, the one
signal no handler survives. Each heartbeat and crashdump carries the
process's collective-schedule chain (``telemetry/schedule.py``
``GLOBAL_SCHEDULE``: the fleet barriers and one gradient all-reduce an
epoch) as ``collective_schedule`` once it has an entry, and ``close``
writes it into the stream as a ``collective_schedule`` event, as the JAX
recorder does. The heartbeat thread goes on publishing the chain while the
main thread is stuck in a collective, which is when ``telemetry
postmortem``'s cross-rank audit needs it.

Stdlib only. Everything the trainer calls on its loop (``beat``,
``record``, ``note``, ``track_scalar``) is a host-memory update: no device
read, no I/O; the files are written on the heartbeat thread or at dump
time.
"""

from __future__ import annotations

import collections
import faulthandler
import json
import os
import signal
import socket
import sys
import threading
import time
import traceback
from pathlib import Path

from masters_thesis_tpu_torch.telemetry.schedule import GLOBAL_SCHEDULE

CRASHDUMP_FILENAME = "crashdump.json"
HEARTBEAT_FILENAME = "heartbeat.json"
FATAL_LOG_FILENAME = "fatal.log"

# Signals that mean "you are being killed; say your last words". SIGKILL is
# uncatchable by design — that case is reconstructed from the heartbeat gap.
_DUMP_SIGNALS = ("SIGTERM", "SIGQUIT")


def _atomic_write_json(path: Path, obj: dict) -> None:
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(json.dumps(obj, indent=2, default=str))
    os.replace(tmp, path)


def _all_thread_stacks() -> list[dict]:
    """Snapshot every thread's Python stack (the hang forensics core)."""
    names = {t.ident: t for t in threading.enumerate()}
    stacks = []
    for ident, frame in sys._current_frames().items():
        thread = names.get(ident)
        stacks.append(
            {
                "ident": ident,
                "name": thread.name if thread else "?",
                "daemon": thread.daemon if thread else None,
                "stack": [
                    line.rstrip()
                    for line in traceback.format_stack(frame)
                ],
            }
        )
    return stacks


class FlightRecorder:
    """Bounded in-memory history + crashdump/heartbeat files for one run.

    Hot-path API (host memory only, safe at any frequency):

    - ``beat(phase=, epoch=)`` — a progress marker; the hang watchdog
      measures staleness from the last beat.
    - ``record(event)`` — mirror a telemetry event into the ring buffer
      (wired automatically by ``TelemetryRun.attach_flight_recorder``).
    - ``note(**state)`` — merge into the last-known state dict (step,
      compile count, memory snapshot, ...).
    - ``track_scalar(name, value)`` — append to a bounded per-name history
      (recent loss / lr: the divergence context of a crashdump).

    ``hang_timeout_s=None`` (the default, overridable via the
    ``MTT_HANG_TIMEOUT_S`` env var) disables the hang watchdog but keeps
    heartbeats and signal dumps.
    """

    def __init__(
        self,
        run_dir: str | Path,
        run_id: str | None = None,
        sink=None,
        ring_size: int = 256,
        scalar_history: int = 64,
        heartbeat_interval_s: float = 2.0,
        hang_timeout_s: float | None = None,
        install_signal_handlers: bool = True,
        enable_faulthandler: bool = True,
    ):
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self.run_id = run_id
        self.sink = sink
        # The process's rank and world, as its sink's envelope carries them.
        self.proc = getattr(sink, "proc", None)
        self.nproc = getattr(sink, "nproc", None)
        self._host = socket.gethostname()
        self._pid = os.getpid()
        self._ring: collections.deque = collections.deque(maxlen=ring_size)
        self._scalars: dict[str, collections.deque] = {}
        self._scalar_history = scalar_history
        self._state: dict = {}
        self._lock = threading.Lock()
        self._dump_lock = threading.Lock()
        self._dumped_reasons: set[str] = set()
        self.heartbeat_interval_s = max(0.05, float(heartbeat_interval_s))
        if hang_timeout_s is None:
            env = os.environ.get("MTT_HANG_TIMEOUT_S")
            if env:
                try:
                    hang_timeout_s = float(env)
                except ValueError:
                    hang_timeout_s = None
        self.hang_timeout_s = hang_timeout_s
        # Set by TelemetryRun.attach_flight_recorder: a zero-arg callable
        # returning the tracer's open-span snapshots, flushed into every
        # heartbeat and crashdump so the trace CLI can close a killed
        # process's in-flight spans as `aborted` instead of losing them.
        self.open_spans_provider = None
        self._beats = 0
        self._phase = "init"
        self._epoch: int | None = None
        self._last_beat_mono = time.monotonic()
        self._last_beat_ts = time.time()
        self._hang_dumped = False
        self._closed = threading.Event()
        self._prev_handlers: dict[int, object] = {}
        self._fatal_file = None
        if install_signal_handlers:
            self._install_signal_handlers()
        if enable_faulthandler:
            self._enable_faulthandler()
        self._write_heartbeat()
        self._thread = threading.Thread(
            target=self._heartbeat_loop,
            name="flightrec-heartbeat",
            daemon=True,
        )
        self._thread.start()

    # -------------------------------------------------------- hot-path API

    def beat(self, phase: str | None = None, epoch: int | None = None) -> None:
        self._beats += 1  # mtt: disable=CL502 -- single writer: only the training thread beats; readers tolerate staleness
        self._last_beat_mono = time.monotonic()
        self._last_beat_ts = time.time()
        if phase is not None:
            self._phase = phase
        if epoch is not None:
            self._epoch = epoch  # mtt: disable=CL502 -- single-writer int store from the training thread; dump/heartbeat tolerate staleness
        self._hang_dumped = False  # progress resets the hang latch

    def record(self, event: dict) -> None:
        self._ring.append(event)
        kind = event.get("kind")
        # The last-known state a postmortem reader wants at a glance,
        # without digging through the ring.
        if kind in ("epoch", "memory", "eval", "run_started", "run_finished"):
            with self._lock:
                self._state[f"last_{kind}"] = {
                    k: v for k, v in event.items() if k != "kind"
                }

    def note(self, **state) -> None:
        with self._lock:
            self._state.update(state)

    def track_scalar(self, name: str, value: float) -> None:
        hist = self._scalars.get(name)
        if hist is None:
            hist = self._scalars[name] = collections.deque(
                maxlen=self._scalar_history
            )
        try:
            hist.append(float(value))
        except (TypeError, ValueError):
            hist.append(None)

    # ------------------------------------------------------------- dumping

    @property
    def crashdump_path(self) -> Path:
        return self.run_dir / CRASHDUMP_FILENAME

    @property
    def heartbeat_path(self) -> Path:
        return self.run_dir / HEARTBEAT_FILENAME

    def dump(self, reason: str, force: bool = False) -> Path | None:
        """Write ``crashdump.json``; no-throw, reentrancy-safe, first dump
        per reason wins (a SIGTERM arriving during a hang dump must not
        corrupt the file mid-write)."""
        if not self._dump_lock.acquire(blocking=force):
            return None
        try:
            if reason in self._dumped_reasons and not force:
                return self.crashdump_path
            self._dumped_reasons.add(reason)
            now = time.time()
            # Bounded: this runs on the signal path; if the interrupted
            # main-thread frame holds _lock (record()/note() mid-update),
            # a blocking acquire would self-deadlock the process. Fall
            # back to a best-effort racy copy — a slightly torn state
            # map in a crashdump beats no crashdump.
            if self._lock.acquire(timeout=0.25):
                try:
                    state = dict(self._state)
                finally:
                    self._lock.release()
            else:
                try:
                    state = dict(self._state)
                except RuntimeError:
                    state = {}
            dump = {
                "reason": reason,
                "ts": now,
                "run": self.run_id,
                "host": self._host,
                "pid": self._pid,
                "proc": self.proc,
                "nproc": self.nproc,
                "phase": self._phase,
                "epoch": self._epoch,
                "beats": self._beats,
                "age_since_beat_s": time.monotonic() - self._last_beat_mono,
                "state": state,
                "scalars": {k: list(v) for k, v in self._scalars.items()},
                "open_spans": self._open_spans(),
                "threads": _all_thread_stacks(),
                "ring": list(self._ring),
            }
            sched = GLOBAL_SCHEDULE.snapshot()
            if sched["n"]:
                dump["collective_schedule"] = sched
            _atomic_write_json(self.crashdump_path, dump)  # mtt: disable=CL503 -- _dump_lock exists precisely to serialize crashdump I/O
            self._write_heartbeat(crashdump=str(self.crashdump_path))  # mtt: disable=CL503 -- same serialized-forensics contract as the dump write
            if self.sink is not None:
                try:
                    # The stream flushes per line, so this survives the
                    # process dying right after the handler returns.
                    self.sink.try_emit(  # mtt: disable=CL503 -- bounded handler-path emit; _dump_lock serializes forensics I/O by design
                        "crashdump",
                        reason=reason,
                        path=str(self.crashdump_path),
                        phase=self._phase,
                        epoch=self._epoch,
                    )
                except Exception:
                    pass
            return self.crashdump_path
        except Exception:
            return None  # forensics must never kill (or mask) the run
        finally:
            self._dump_lock.release()

    # ----------------------------------------------------------- heartbeat

    def _open_spans(self) -> list[dict]:
        provider = self.open_spans_provider
        if provider is None:
            return []
        try:
            return list(provider())
        except Exception:
            return []  # forensics must never kill the run

    def _write_heartbeat(self, **extra) -> None:
        try:
            sched = GLOBAL_SCHEDULE.snapshot()
            if sched["n"]:
                extra.setdefault("collective_schedule", sched)
            _atomic_write_json(
                self.heartbeat_path,
                {
                    "ts": time.time(),
                    "last_beat_ts": self._last_beat_ts,
                    "run": self.run_id,
                    "host": self._host,
                    "pid": self._pid,
                    "proc": self.proc,
                    "nproc": self.nproc,
                    "phase": self._phase,
                    "epoch": self._epoch,  # mtt: disable=CL502 -- advisory heartbeat snapshot; a stale epoch is harmless
                    "beats": self._beats,
                    "interval_s": self.heartbeat_interval_s,
                    "hang_timeout_s": self.hang_timeout_s,
                    "open_spans": self._open_spans(),
                    **extra,
                },
            )
        except OSError:
            pass  # a full disk must not take the run down with it

    def _heartbeat_loop(self) -> None:
        period = self.heartbeat_interval_s
        if self.hang_timeout_s:
            period = min(period, max(0.05, self.hang_timeout_s / 4.0))
        while not self._closed.wait(period):
            self._write_heartbeat()
            if self.hang_timeout_s and not self._hang_dumped:
                age = time.monotonic() - self._last_beat_mono
                if age > self.hang_timeout_s:
                    self._hang_dumped = True
                    self.dump(
                        f"hang: no progress beat for {age:.1f}s "
                        f"(timeout {self.hang_timeout_s:.1f}s, "
                        f"phase {self._phase!r})"
                    )

    # ------------------------------------------------------------- signals

    def _install_signal_handlers(self) -> None:
        if threading.current_thread() is not threading.main_thread():
            return  # signal.signal only works from the main thread
        for name in _DUMP_SIGNALS:
            signum = getattr(signal, name, None)
            if signum is None:
                continue
            try:
                self._prev_handlers[signum] = signal.signal(
                    signum, self._on_signal
                )
            except (ValueError, OSError):
                continue

    def _on_signal(self, signum, frame) -> None:
        self.dump(f"signal:{signal.Signals(signum).name}")
        # Restore whatever was there and re-deliver, so the process dies
        # with the correct wait status (and chained handlers still run).
        prev = self._prev_handlers.get(signum, signal.SIG_DFL)
        try:
            signal.signal(signum, prev if callable(prev) or prev in (
                signal.SIG_DFL, signal.SIG_IGN) else signal.SIG_DFL)
        except (ValueError, OSError):
            pass
        if callable(prev) and prev not in (signal.SIG_DFL, signal.SIG_IGN):
            prev(signum, frame)
        else:
            os.kill(self._pid, signum)

    def _enable_faulthandler(self) -> None:
        """Fatal signals (SIGSEGV/SIGABRT/...) dump all-thread stacks to
        ``fatal.log`` — a C-level crash can't run Python handlers, but
        faulthandler's async-signal-safe writer still gets the stacks out."""
        if faulthandler.is_enabled():
            return  # someone else owns the global fatal handler
        try:
            self._fatal_file = open(
                self.run_dir / FATAL_LOG_FILENAME, "w", encoding="utf-8"
            )
            faulthandler.enable(file=self._fatal_file)
        except (OSError, ValueError):
            self._fatal_file = None

    # --------------------------------------------------------------- close

    def close(self) -> None:
        """Stop the heartbeat thread, restore signal state, final beat."""
        if self._closed.is_set():
            return
        self._closed.set()
        self._thread.join(timeout=2.0)
        self._phase = "closed"
        self._write_heartbeat(closed=True)
        # The final chain into the flushed stream: the heartbeat file can be
        # cleaned away, the event line stays for the postmortem's audit.
        sched = GLOBAL_SCHEDULE.snapshot()
        if sched["n"] and self.sink is not None:
            try:
                self.sink.try_emit("collective_schedule", n=sched["n"],
                                   chain=sched["chain"], tail=sched["tail"])
            except Exception:
                pass  # forensics must never kill the run
        for signum, prev in self._prev_handlers.items():
            try:
                signal.signal(signum, prev)
            except (ValueError, OSError, TypeError):
                pass
        self._prev_handlers.clear()
        if self._fatal_file is not None:
            try:
                faulthandler.disable()
                self._fatal_file.close()
            except (OSError, ValueError):
                pass
            self._fatal_file = None
