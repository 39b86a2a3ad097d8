"""The card's backend probe, its cache and wedge policy, the program
identity of a device, and which rank of which launch this process is.

Counterpart of ``masters_thesis_tpu/utils/backend_probe.py``:

- :func:`probe_cuda_backend` probes the card in a SHORT-LIVED child
  (``python -c``: initialise CUDA, launch one small op on ``cuda:0``,
  synchronise) under ``timeout_s``, so a wedged card hangs the child and
  never the caller. A non-zero exit is a deterministic crash (no card, a
  broken CUDA install) and is not retried: its stderr tail is the detail. A
  timeout is a wedge, retried with ``backoff_s`` between attempts until
  ``budget_s`` is spent. The fault point ``probe.attempt`` (context ``n``,
  the attempt), kind ``wedge``, stands in for a timeout without waiting
  for it. The child gets the caller's environment unchanged: nothing pins
  it to the CPU.
- :class:`BackendHealth` keeps the last probe's outcome in a small JSON file
  with a TTL; within the TTL a backend known to be wedged gets ONE attempt
  instead of the whole budget, and ``single_attempt=True`` (the server's
  breaker and the supervisor's gate) always gets one. It never degrades
  anything itself: the caller records what a failed probe means.
- :func:`backend_fingerprint` is the identity of the programs a device
  runs, for the serving program cache's keys.
- :func:`multihost_rank`: the data module asks it before a device is set
  up, so it reads the live process group when there is one and the launch
  environment (``parallel/mesh.py``'s ``JAX_PROCESS_INDEX`` and
  ``JAX_PROCESS_COUNT``, exported with a coordinator) before
  initialisation.

Not ported: ``pin_cpu``, ``pin_cpu_in_process`` and ``probe_tpu_backend``.
The port never moves work to the CPU after a failed probe (the serving
path declares ``device_lost``, the supervisor records a ``degradation``
and runs the attempt on the card), and it has no TPU to probe.

Importing this module imports no torch (the supervisor imports it, and
must work while the card's runtime is wedged): ``torch.distributed`` is read
only where torch is already imported, and :func:`backend_fingerprint`
imports torch when called.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path

from masters_thesis_tpu_torch.parallel.mesh import (
    COORDINATOR_ENV,
    COUNT_ENV,
    INDEX_ENV,
)
from masters_thesis_tpu_torch.resilience import faults

DEFAULT_TIMEOUT_S = 120.0
DEFAULT_BACKOFF_S = 15.0
DEFAULT_BUDGET_S = 600.0
DEFAULT_CACHE_TTL_S = 900.0

#: The probe child's program: CUDA initialised, one op on the card, waited
#: for. Without a card it exits non-zero at the first line that needs one.
PROBE_CODE = (
    "import torch\n"
    "x = torch.ones(1024, device='cuda:0')\n"
    "y = (x * 2).sum()\n"
    "torch.cuda.synchronize()\n"
    "assert float(y) == 2048.0, float(y)\n"
)


@dataclass
class ProbeResult:
    ok: bool
    attempts: int
    detail: str  # "" when ok; reason and the child's stderr tail otherwise


@dataclass
class HealthDecision:
    """Outcome of :meth:`BackendHealth.ensure_responsive`."""

    ok: bool
    degraded: bool  # not ok: the caller records what that means
    attempts: int
    detail: str
    known_wedged: bool  # the cache said wedged within its TTL: one attempt
    cached_age_s: float | None


class BackendHealth:
    """The probe cache and the wedge policy, as the JAX class: the last
    outcome is written atomically with a TTL; within it a known-wedged
    backend gets ONE probe attempt (``budget_s=0``) instead of the whole
    retry budget."""

    def __init__(
        self,
        cache_path: Path | str,
        ttl_s: float = DEFAULT_CACHE_TTL_S,
        timeout_s: float = DEFAULT_TIMEOUT_S,
        budget_s: float = DEFAULT_BUDGET_S,
        backoff_s: float = DEFAULT_BACKOFF_S,
    ) -> None:
        self.cache_path = Path(cache_path)
        self.ttl_s = ttl_s
        self.timeout_s = timeout_s
        self.budget_s = budget_s
        self.backoff_s = backoff_s

    def read_cache(self) -> dict | None:
        """The last probe outcome, or None when absent, corrupt or
        expired."""
        try:
            cached = json.loads(self.cache_path.read_text())
        except (OSError, json.JSONDecodeError):
            return None
        if not isinstance(cached, dict):
            return None
        at = cached.get("at")
        if not isinstance(at, (int, float)) or time.time() - at > self.ttl_s:
            return None
        return cached

    def record(self, ok: bool, detail: str = "") -> None:
        """Best effort: the cache must never cost the run."""
        from masters_thesis_tpu_torch.utils.io import atomic_write_text

        try:
            self.cache_path.parent.mkdir(parents=True, exist_ok=True)
            atomic_write_text(
                self.cache_path,
                json.dumps({"ok": ok, "at": time.time(),
                            "detail": detail[-500:]}, indent=2))
        except OSError:
            pass

    def record_wedge(self, detail: str) -> None:
        """A watchdog found the backend wedged mid-run."""
        self.record(False, detail)

    def ensure_responsive(self, single_attempt: bool = False,
                          log=None) -> HealthDecision:
        """Probe the card under the cache policy: one attempt when the
        cache knows it wedged or ``single_attempt`` (the caller owns the
        retries), the whole budget otherwise."""
        log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
        cached = self.read_cache()
        known_wedged = cached is not None and not cached.get("ok")
        cached_age_s = (time.time() - cached["at"]
                        if cached is not None else None)
        if known_wedged:
            log("probe cache says the card was wedged "
                f"{cached_age_s:.0f}s ago; single probe attempt")
        budget_s = 0.0 if (known_wedged or single_attempt) else self.budget_s
        probe = probe_cuda_backend(timeout_s=self.timeout_s,
                                   budget_s=budget_s,
                                   backoff_s=self.backoff_s)
        self.record(probe.ok, probe.detail or "")
        if not probe.ok:
            log(f"device probe failed {probe.attempts}x over "
                f"{budget_s:.0f}s ({probe.detail})")
        return HealthDecision(
            ok=probe.ok, degraded=not probe.ok, attempts=probe.attempts,
            detail=probe.detail, known_wedged=known_wedged,
            cached_age_s=cached_age_s)


def probe_cuda_backend(timeout_s: float = DEFAULT_TIMEOUT_S,
                       budget_s: float = 0.0,
                       backoff_s: float = DEFAULT_BACKOFF_S) -> ProbeResult:
    """Probe the card in a child (``PROBE_CODE``); retry timeouts for
    ``budget_s``, never a crash."""
    deadline = time.monotonic() + budget_s
    attempts = 0
    detail = ""
    while True:
        attempts += 1
        remaining = deadline - time.monotonic()
        # A ``wedge`` fault stands in for a child hung to its timeout: the
        # retry, backoff and budget rule below runs unchanged.
        timed_out = faults.fire("probe.attempt", n=attempts) == "wedge"
        if not timed_out:
            try:
                subprocess.run(
                    [sys.executable, "-c", PROBE_CODE],
                    timeout=(max(10.0, min(timeout_s, remaining))
                             if budget_s else timeout_s),
                    check=True, capture_output=True)
                return ProbeResult(True, attempts, "")
            except subprocess.CalledProcessError as exc:
                stderr = (exc.stderr or b"").decode(errors="replace")
                detail = f"init crashed (rc={exc.returncode}): {stderr[-500:]}"
                break  # deterministic: a retry reproduces it
            except subprocess.TimeoutExpired:
                timed_out = True
        if timed_out:
            detail = f"probe timed out after attempt {attempts} (wedged card)"
            print(f"device probe attempt {attempts} timed out; "
                  f"{max(0.0, remaining):.0f}s budget left",
                  file=sys.stderr, flush=True)
            if time.monotonic() + backoff_s >= deadline:
                break
            time.sleep(backoff_s)
    return ProbeResult(False, attempts, detail)


def kernels_digest() -> str:
    """A digest of the kernel libraries ``ops/_build.py`` builds: the
    names it gives them, each keyed by its source, headers and flags."""
    from masters_thesis_tpu_torch.ops import _build

    names = "\0".join(_build.library_path(src).name
                      for src in _build.sources())
    return hashlib.sha256(names.encode()).hexdigest()[:16]


def backend_fingerprint(device=None) -> dict:
    """The identity of the programs ``device`` (the card by default) runs:
    torch and CUDA versions, the device's type, index, name and
    capability, and :func:`kernels_digest`. A cached program whose
    fingerprint differs from its booting engine's is refused as stale.
    Never probes: the caller holds the device already."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    on_card = dev.type == "cuda"
    index = (dev.index if dev.index is not None else torch.cuda.current_device()
             ) if on_card else None
    return {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "platform": dev.type,
        "device_index": index,
        "device_name": torch.cuda.get_device_name(index) if on_card else "cpu",
        "capability": (list(torch.cuda.get_device_capability(index))
                       if on_card else None),
        "kernels": kernels_digest(),
    }


def multihost_rank() -> tuple[int, int]:
    """``(process_index, process_count)``: the process group's rank and
    world when one is initialised, else the launch environment's, else
    ``(0, 1)``."""
    if "torch" in sys.modules:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return dist.get_rank(), dist.get_world_size()
    if os.environ.get(COORDINATOR_ENV):
        try:
            return (int(os.environ.get(INDEX_ENV, "0") or 0),
                    int(os.environ.get(COUNT_ENV, "1") or 1))
        except ValueError:
            pass
    return 0, 1
