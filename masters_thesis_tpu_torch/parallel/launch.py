"""The rank launcher: one process a rank, as ``torchrun`` starts them.

No module of the JAX package corresponds to it: the JAX package is
single-controller (one process drives every device of its mesh), torch
runs one process a rank. ``launch(command, world)`` starts ``world``
copies of ``command``, each with the launch environment that
``parallel/mesh.py``'s ``join_fleet`` reads (``MTT_COORDINATOR``, a
``file://`` rendezvous in a fresh temporary directory, no port;
``JAX_PROCESS_INDEX``, ``JAX_PROCESS_COUNT``, ``LOCAL_RANK``), and waits
for every rank. When one rank exits non-zero or is killed, the others are
killed (SIGTERM, then SIGKILL after ``GRACE_S``) and the launcher returns
that rank's failure, so no rank is left blocked in a collective; a rank
also dies with the launcher (``MTT_LAUNCHER_PID``: the rank asks for
``PR_SET_PDEATHSIG`` as it joins, ``die_with_launcher``). A signal to the
launcher ends the launch the same way. ``timeout_s`` bounds the whole launch
(exit 124, as ``timeout`` reports it).

``as_ranks(command, argv, world, device)`` is what the entry points call
when ``trainer.n_devices`` asks for more than one rank:
``python -m masters_thesis_tpu_torch <command> <argv>`` as ``world``
ranks. On the CPU each rank is a gloo process given an equal share of the
host's cores (``OMP_NUM_THREADS``, unless set).
"""

from __future__ import annotations

import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

from masters_thesis_tpu_torch.parallel.mesh import (
    COORDINATOR_ENV,
    COUNT_ENV,
    INDEX_ENV,
    LOCAL_RANK_ENV,
)

#: The exit code of a launch cut by its ``timeout_s``.
TIMEOUT_EXIT = 124
#: The launcher's pid, which a rank it started dies with.
LAUNCHER_PID_ENV = "MTT_LAUNCHER_PID"
#: Seconds between two looks at the ranks, and from SIGTERM to SIGKILL.
POLL_S = 0.05
GRACE_S = 5.0


def die_with_launcher() -> None:
    """In a rank this launcher started: ask Linux to SIGKILL the process
    when the launcher dies (``PR_SET_PDEATHSIG``), and exit now if it has
    died already. Best effort where ``prctl`` is missing."""
    pid = os.environ.get(LAUNCHER_PID_ENV)
    if not pid:
        return
    try:
        import ctypes

        ctypes.CDLL("libc.so.6", use_errno=True).prctl(1, signal.SIGKILL)
    except (OSError, AttributeError):
        return
    if os.getppid() != int(pid):
        os._exit(128 + signal.SIGKILL)


def rank_env(coordinator: str, rank: int, world: int,
             base: dict | None = None) -> dict:
    """The environment of rank ``rank`` of ``world``."""
    env = dict(os.environ if base is None else base)
    env.update({COORDINATOR_ENV: coordinator, INDEX_ENV: str(rank),
                COUNT_ENV: str(world), LOCAL_RANK_ENV: str(rank),
                LAUNCHER_PID_ENV: str(os.getpid())})
    return env


def exit_code(returncode: int) -> int:
    """A child's return code as a shell reports it (128 + the signal for a
    killed child)."""
    return returncode if returncode >= 0 else 128 - returncode


def _stop(procs: list) -> None:
    """SIGTERM every live child, then SIGKILL what is left after
    ``GRACE_S``; reap them all."""
    for proc in procs:
        if proc.poll() is None:
            proc.terminate()
    deadline = time.monotonic() + GRACE_S
    for proc in procs:
        try:
            proc.wait(max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def launch(command: list[str], world: int, *, env: dict | None = None,
           timeout_s: float | None = None, rendezvous_dir=None) -> int:
    """Run ``command`` as ranks ``0 .. world - 1`` and wait for them all:
    0 when every rank exits 0, else the first failure's exit code (every
    other rank killed), or ``TIMEOUT_EXIT`` at ``timeout_s``."""
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    rdzv = tempfile.mkdtemp(prefix="mtt_rdzv_", dir=rendezvous_dir)
    coordinator = "file://" + os.path.join(rdzv, "store")
    procs: list[subprocess.Popen] = []
    received: list[int] = []

    def forward(signum, _frame):
        received.append(signum)

    handlers = {}
    if _main_thread():
        for signum in (signal.SIGTERM, signal.SIGINT):
            handlers[signum] = signal.signal(signum, forward)
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    try:
        for rank in range(world):
            procs.append(subprocess.Popen(
                command, env=rank_env(coordinator, rank, world, env)))
        while True:
            codes = [proc.poll() for proc in procs]
            failed = [c for c in codes if c not in (None, 0)]
            if failed:
                return exit_code(failed[0])
            if all(c == 0 for c in codes):
                return 0
            if received:
                return 128 + received[0]
            if deadline is not None and time.monotonic() > deadline:
                print(f"launch: {world} ranks of {command[:4]} did not "
                      f"finish in {timeout_s} s; killed", file=sys.stderr,
                      flush=True)
                return TIMEOUT_EXIT
            time.sleep(POLL_S)
    finally:
        _stop(procs)
        for signum, handler in handlers.items():
            signal.signal(signum, handler)
        shutil.rmtree(rdzv, ignore_errors=True)


def _main_thread() -> bool:
    import threading

    return threading.current_thread() is threading.main_thread()


def as_ranks(command: str, argv: list[str], world: int, device=None) -> int:
    """``python -m masters_thesis_tpu_torch <command> [--device D] <argv>``
    as ``world`` ranks; returns the launch's exit code. On the CPU each
    rank gets ``cores // world`` threads unless ``OMP_NUM_THREADS`` is
    set."""
    env = dict(os.environ)
    if str(device) == "cpu" and "OMP_NUM_THREADS" not in env:
        env["OMP_NUM_THREADS"] = str(max(1, (os.cpu_count() or 1) // world))
    args = [sys.executable, "-m", "masters_thesis_tpu_torch", command]
    if device is not None:
        args += ["--device", str(device)]
    print(f"launch: {world} ranks ({'gloo' if str(device) == 'cpu' else 'nccl'})"
          f" of {command}", flush=True)
    return launch(args + list(argv), world, env=env)
