"""Bucketed predict engine on one device.

Counterpart of ``masters_thesis_tpu/serve/engine.py`` with the same contract:
``predict`` maps a host batch ``x (n, K, T, F)`` to per-stock
``(alpha (n, K), beta (n, K))`` numpy arrays, deterministically, padding
``n`` up to the nearest bucket by repeating the first window, and refusing a
batch past the largest bucket with :class:`BucketOverflowError`.

A bucket is one program, as in the JAX engine: on the card the forward at
the bucket's shape is one CUDA graph over static buffers, captured by
``warmup`` (or at the bucket's first use) and replayed for every batch
(``compile_events`` counts the captures); the padding keeps the shapes the
kernels see to the bucket ladder. On the CPU, or with ``cuda_graphs=False``,
the same forward runs eagerly over the same static buffers and nothing is
captured. A dispatch on the card makes one synchronisation, the explicit
wait for its own answers: the batch goes in through a pinned buffer by a
``non_blocking`` copy, the answers come back into pinned buffers the same
way, and ``predict`` waits on a CUDA event recorded after them (the serve
preflight's SV302 holds this under ``torch.cuda.set_sync_debug_mode``).
Each engine on the card works on a CUDA stream of its own: its weights'
load, every batch's copies, every replay, every capture's warm-up and the
``done`` event go on it, never on the legacy default stream. It is drawn
from PyTorch's high-priority stream pool: a pool hands its streams out
round robin, and ``GraphedCall`` draws its capture streams from the
default-priority pool, so another engine's capture can never run on this
engine's stream (when it did, a ``done`` event recorded there was refused
with ``cudaErrorCapturedEvent``).

Hot-swap (``serve/swap.py``): the graphs were captured on the module's own
parameter tensors, so weights enter a graphed program only by an in-place
``copy_`` into those tensors, under the lock ``predict`` holds: nothing
rebinds a parameter (no ``load_state_dict(assign=True)``, no ``p.data =``),
which would leave every graph reading freed memory. ``put_params`` stages a
candidate on the device after checking its signature, ``set_params``
commits it (an in-flight batch ends on the old weights, the next starts on
the new) and returns the old weights, and ``predict(x, params=candidate)``
runs a candidate through the SAME bucket program as live traffic, then
copies the live weights back before it releases the lock. Neither captures
anything. ``from_checkpoint`` boots an engine from a published checkpoint
after verifying it strictly.

The program cache (``serve/program_cache.py``, ``program_cache=``): ``close``
gives the engine's programs back, and the first ``warmup`` of an engine on
the same cache takes them (one closed engine's module and its graphs,
verified on their golden batch) instead of capturing: a fully warm boot
has ``compile_events == 0`` and ``cache_hits == len(buckets)``. Buckets the
cache lacks are captured on the taken module, whose tensors then carry
this engine's weights (copied in). ``cost_profiles`` holds one analytic
cost a bucket (``telemetry/costs.py``), which the server writes at start.
The mesh and the CPU degradation of the JAX engine are not ported: after a
breaker trip and a failed probe the server declares the device lost.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from pathlib import Path
from typing import Mapping, Sequence

import numpy as np
import torch

from masters_thesis_tpu_torch import resolve_device
from masters_thesis_tpu_torch.models.objectives import ModelSpec
from masters_thesis_tpu_torch.serve.program_cache import (
    CacheEntry,
    ProgramSet,
    entry_key,
    param_signature,
    release_program,
)
from masters_thesis_tpu_torch.train.checkpoint import (
    CorruptCheckpointError,
    restore_checkpoint,
)
from masters_thesis_tpu_torch.train.manifest import verify_checkpoint
from masters_thesis_tpu_torch.train.steps import forward_rows
from masters_thesis_tpu_torch.utils.cuda_graph import GraphedCall

DEFAULT_BUCKETS = (1, 2, 4, 8)


class BucketOverflowError(ValueError):
    """Request batch larger than the largest bucket."""


def bucket_cost_profiles(spec: ModelSpec, buckets: Sequence[int],
                         n_stocks: int, lookback: int, platform: str,
                         lanes: int = 1) -> dict[int, dict]:
    """One ``cost_profile`` payload a bucket: ``cost_of_step``'s forward
    over ``b * n_stocks`` rows (``lanes`` times for a stacked engine),
    ``program=f"serve_bucket_{b}"``, meta ``bucket`` and ``platform``."""
    from masters_thesis_tpu_torch.telemetry.costs import (
        CostModel,
        cost_of_step,
    )

    out = {}
    for b in buckets:
        c = cost_of_step(spec, b * n_stocks, lookback, window_rows=n_stocks,
                         training=False)
        meta = {"bucket": b, "platform": platform, "groups": c["groups"],
                "kernels_per_step": c["kernels"]}
        if lanes != 1:
            meta["lanes"] = lanes
        out[b] = CostModel(
            program=f"serve_bucket_{b}", flops=float(lanes * c["flops"]),
            bytes_accessed=float(lanes * c["bytes"]),
            transcendentals=float(lanes * c["transcendentals"]),
            source="analytic", meta=meta).to_payload()
    return out


class BucketPrograms:
    """What the solo and the stacked engine share: the bucket programs made
    or taken from the program cache, the engine's own stream and lock,
    ``warmup`` and ``close``. A subclass sets ``spec``, ``buckets``,
    ``device``, ``graphed``, ``_module`` and ``program_cache`` and calls
    ``_init_programs``; it provides ``_new_program``, ``_bind_live`` (its
    view of the module's tensors), ``GOLDEN_SEED`` and
    ``_identity_extra``."""

    #: The golden input of bucket b is ``golden_batch(b, seed=a * b + c)``.
    GOLDEN_SEED = (1009, 7)

    def _init_programs(self, program_cache) -> None:
        self._lock = threading.Lock()
        self._programs: dict = {}
        #: Buckets whose program came from the program cache.
        self._cached: set[int] = set()
        #: Entries of a taken set that this engine does not use: they go
        #: back with its own at ``close``.
        self._spares: dict[str, CacheEntry] = {}
        #: The golden inputs of taken programs, kept for ``close`` (a
        #: universe ladder's take a second to draw).
        self._golden_xs: dict[int, np.ndarray] = {}
        self._closed = False
        #: ``(compile_events, programs_made)`` as ``close`` found them.
        self._closed_counts: tuple | None = None
        self._fingerprint: dict | None = None
        self.program_cache = program_cache
        #: Buckets booted from the program cache instead of a capture.
        self.cache_hits = 0
        #: The allocator's peak during each bucket's capture (``warmup``
        #: on the card): SV304 holds them against the card's memory.
        self.capture_peak_bytes: dict[int, int] = {}
        #: Wall seconds ``warmup`` spent on each bucket: its capture, or
        #: the verification of the program taken from the cache.
        self.boot_s: dict[int, float] = {}

    def _init_stream(self) -> None:
        #: The engine's own stream on the card (None on the CPU), from the
        #: high-priority pool, which no capture draws from (the module
        #: docstring).
        self._stream = (torch.cuda.Stream(self.device, priority=-1)
                        if self.device.type == "cuda" else None)

    def _on_stream(self):
        """The engine's stream as the current one (a no-op on the CPU)."""
        return torch.cuda.stream(self._stream)

    def _sync(self) -> None:
        if self._stream is not None:
            self._stream.synchronize()

    @property
    def window_shape(self) -> tuple[int, int, int]:
        return (self.n_stocks, self.lookback, self.n_features)

    @property
    def max_bucket(self) -> int:
        return self.buckets[-1]

    @property
    def platform(self) -> str:
        return "gpu" if self.device.type == "cuda" else "cpu"

    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        raise BucketOverflowError(
            f"batch of {n} exceeds largest bucket "
            f"{self.max_bucket} (buckets: {self.buckets})"
        )

    @property
    def compile_events(self) -> int:
        """Buckets this engine captured as CUDA graphs (0 on the CPU and
        without graphs, and for buckets taken from the program cache):
        ``len(buckets)`` after a cold ``warmup`` on the card."""
        if self._closed_counts is not None:
            return self._closed_counts[0]
        return sum(1 for b, p in self._programs.items()
                   if p.captured and b not in self._cached)

    @property
    def programs_made(self) -> int:
        """Bucket programs this engine made rather than took from the
        program cache (on the CPU too, where nothing is captured)."""
        if self._closed_counts is not None:
            return self._closed_counts[1]
        return len(self._programs) - len(self._cached)

    def golden_batch(self, n: int = 1, seed: int = 0) -> np.ndarray:
        """Deterministic canary input of this engine's window shape,
        bitwise the JAX engine's."""
        k, t, f = self.window_shape
        rng = np.random.default_rng(seed)
        return rng.standard_normal((n, k, t, f)).astype(np.float32)

    def _golden_x(self, b: int) -> np.ndarray:
        a, c = self.GOLDEN_SEED
        return self.golden_batch(n=b, seed=a * b + c)

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError("engine is closed: its programs were given "
                               "back")

    def _program(self, bucket: int):
        """The bucket's program, made at its first use; under ``_lock``."""
        program = self._programs.get(bucket)
        if program is None:
            program = self._new_program(bucket)
            self._programs[bucket] = program
        return program

    def warmup(self) -> float:
        """Take what the program cache holds for this engine (at its first
        warmup), then make every other bucket's program: on the card
        capture its graph (after one eager run on a zero batch), as the JAX
        engine compiles every bucket. Then run the largest bucket twice;
        returns the wall seconds of the second run (seeds the queue's
        service-time model). Each capture's peak of the allocator goes into
        ``capture_peak_bytes`` (the allocator's peak statistic is reset
        before each)."""
        with self._lock, self._on_stream(), torch.inference_mode():
            self._check_open()
            if self.program_cache is not None and not self._programs:
                self._boot_from_cache()
            for b in self.buckets:
                if b in self._programs:
                    continue
                t0 = time.perf_counter()
                program = self._program(b)
                if self.graphed:
                    torch.cuda.reset_peak_memory_stats(self.device)
                    program.run()
                    self.capture_peak_bytes[b] = int(
                        torch.cuda.max_memory_allocated(self.device))
                self.boot_s[b] = time.perf_counter() - t0
        k, t, f = self.window_shape
        x = np.zeros((self.max_bucket, k, t, f), np.float32)
        self.predict(x)
        t0 = time.perf_counter()
        self.predict(x)
        return time.perf_counter() - t0

    # --------------------------------------------------------- program cache

    def _cache_key(self, b: int) -> str:
        if self._fingerprint is None:
            from masters_thesis_tpu_torch.utils.backend_probe import (
                backend_fingerprint,
            )

            self._fingerprint = backend_fingerprint(self.device)
        return entry_key({
            "spec": dataclasses.asdict(self.spec),
            "params": param_signature(self._module.state_dict()),
            "window": list(self.window_shape),
            "bucket": int(b),
            "graphed": self.graphed,
            "fingerprint": self._fingerprint,
            **self._identity_extra(),
        })

    def _identity_extra(self) -> dict:
        return {}

    def _boot_from_cache(self) -> None:
        """Check out the cache's set that holds most of this engine's
        buckets, verify and take each entry of it (the rest are captured on
        its module), and adopt its module with this engine's weights
        copied in. Under ``_lock``, on the engine's stream."""
        keys = {b: self._cache_key(b) for b in self.buckets}
        taken = self.program_cache.checkout(keys.values())

        def run_golden(entry: CacheEntry) -> tuple:
            for k, v in taken.module.state_dict().items():
                v.copy_(entry.golden["state"][k])
            program = entry.program
            program.load(entry.golden["x"])
            program.run()
            return program.read()

        for b, key in keys.items():
            t0 = time.perf_counter()
            entry = taken.entries.get(key) if taken is not None else None
            program = self.program_cache.load(
                taken, key, fingerprint=self._fingerprint,
                run_golden=run_golden)
            if program is not None:
                self._programs[b] = program
                self._cached.add(b)
                self.cache_hits += 1
                self._golden_xs[b] = entry.golden["x"]
                self.boot_s[b] = time.perf_counter() - t0
        if taken is None:
            return
        if not self._programs:
            # Nothing verified: whatever the set still holds goes back.
            self.program_cache.put_back(taken)
            return
        own = self._module.state_dict()
        self._module = taken.module
        for k, v in self._module.state_dict().items():
            v.copy_(own[k])
        self._bind_live()
        self._spares = taken.entries

    def close(self) -> None:
        """Give this engine's programs back to its program cache, each with
        its golden batch, the weights it ran on and its answers, and free
        the rest; the engine serves no more. An engine whose last dispatch
        is still in flight (its lock is held) gives nothing back."""
        if not self._lock.acquire(blocking=False):
            self._closed = True
            return
        try:
            entries = self._golden_entries()
        finally:
            self._lock.release()
        if entries:
            self.program_cache.store(ProgramSet(self._module, entries))  # mtt: disable=CL503 -- _lock was released in the finally above (a non-blocking acquire, which the pass does not pair)

    def _golden_entries(self) -> dict[str, CacheEntry]:
        """Close under ``_lock``: each program with its golden batch run on
        the current weights, keyed, plus the spares; {} (everything freed)
        without a cache or when a golden run fails."""
        if self._closed:
            return {}
        self._closed_counts = (self.compile_events, self.programs_made)
        self._closed = True
        programs, self._programs = self._programs, {}
        entries, self._spares = self._spares, {}
        if self.program_cache is None:
            for program in programs.values():
                release_program(program)
            return {}
        try:
            with self._on_stream(), torch.inference_mode():
                state = {k: v.detach().clone()
                         for k, v in self._module.state_dict().items()}
                for b, program in programs.items():
                    if self.graphed and not program.captured:
                        release_program(program)
                        continue
                    x = self._golden_xs.get(b)
                    if x is None:
                        x = self._golden_x(b)
                    program.load(x)
                    program.run()
                    alpha, beta = program.read()
                    entries[self._cache_key(b)] = CacheEntry(
                        program, self._fingerprint,
                        {"x": x, "state": state, "alpha": alpha,
                         "beta": beta})
        except Exception:  # noqa: BLE001 — a failed store costs a warm boot
            for program in programs.values():
                release_program(program)
            for entry in entries.values():
                entry.release()
            return {}
        return entries


class PredictEngine(BucketPrograms):
    """Bucketed predict path for one (spec, window-shape) pair."""

    def __init__(
        self,
        spec: ModelSpec,
        state_dict: Mapping[str, torch.Tensor],
        *,
        n_stocks: int,
        lookback: int,
        n_features: int = 3,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        device=None,
        cuda_graphs: bool = True,
        program_cache=None,
    ):
        self.spec = spec
        self.n_stocks = n_stocks
        self.lookback = lookback
        self.n_features = n_features
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"invalid buckets: {buckets!r}")
        self.device = resolve_device(device)
        self._init_stream()
        with self._on_stream():
            self._module = spec.build_module(device=self.device)
            self._module.load_state_dict(state_dict)
        self._sync()
        self._module.eval()
        self.graphed = cuda_graphs and self.device.type == "cuda"
        self._init_programs(program_cache)
        self._bind_live()
        #: One analytic cost a bucket (``bucket_cost_profiles``).
        self.cost_profiles = bucket_cost_profiles(
            spec, self.buckets, n_stocks, lookback, self.platform)

    def _bind_live(self) -> None:
        #: The tensors the programs read (and the graphs were captured on):
        #: the module's parameters and buffers, by state-dict key.
        self._live = self._module.state_dict(keep_vars=True)

    def _new_program(self, bucket: int) -> "_BucketProgram":
        return _BucketProgram(self._module, (bucket, *self.window_shape),
                              self.device, self.graphed)

    @classmethod
    def from_checkpoint(cls, ckpt_dir, tag: str = "best", *, n_stocks: int,
                        n_features: int = 3,
                        buckets: Sequence[int] = DEFAULT_BUCKETS, device=None,
                        cuda_graphs: bool = True,
                        program_cache=None) -> "PredictEngine":
        """An engine on ``<ckpt_dir>/<tag>``, verified STRICTLY first:
        serving never starts from a tree whose content cannot be proven (a
        missing or mismatched manifest, a pre-manifest ``<tag>.pt``
        included), and raises :class:`CorruptCheckpointError` instead. The
        programs are sized by the sidecar's ``datamodule.lookback_window``."""
        path = Path(ckpt_dir) / tag
        if not verify_checkpoint(path, require_manifest=True):
            raise CorruptCheckpointError(
                f"refusing to serve from {path}: strict manifest "
                "verification failed (missing or mismatched MANIFEST.json)")
        state, _, spec, meta = restore_checkpoint(ckpt_dir, tag)
        lookback = meta.get("datamodule", {}).get("lookback_window")
        if lookback is None:
            raise ValueError(f"checkpoint sidecar for {path} has no "
                             "datamodule.lookback_window; cannot size "
                             "predict programs")
        return cls(spec, state, n_stocks=n_stocks, lookback=int(lookback),
                   n_features=n_features, buckets=buckets, device=device,
                   cuda_graphs=cuda_graphs, program_cache=program_cache)

    def put_params(self, state_dict: Mapping[str, torch.Tensor]
                   ) -> dict[str, torch.Tensor]:
        """A candidate's tensors placed on the engine's device (canary
        staging; swaps nothing). Raises ``ValueError`` unless its keys,
        shapes and dtypes are the serving tensors'."""
        got, want = state_signature(state_dict), state_signature(self._live)
        if got != want:
            raise ValueError(
                "candidate state dict does not match the serving tensors: "
                f"{sorted(set(got) ^ set(want))}")
        with self._on_stream():
            return {k: torch.as_tensor(v).detach().to(self.device, copy=True)
                    for k, v in state_dict.items()}

    def set_params(self, params: Mapping[str, torch.Tensor]
                   ) -> dict[str, torch.Tensor]:
        """Commit ``params`` (from ``put_params``) into the serving tensors,
        in place, under the engine lock; returns a copy of the old
        weights. A batch in flight finishes on the old weights, the next
        one runs on the new."""
        with self._lock, self._on_stream(), torch.inference_mode():
            old = {k: v.detach().clone() for k, v in self._live.items()}
            self._copy_in(params)
        return old

    def _copy_in(self, params: Mapping[str, torch.Tensor]) -> None:
        """``params`` into the serving tensors by ``copy_``; under the
        lock. The tensors stay the ones the graphs read."""
        for k, v in self._live.items():
            v.copy_(params[k])

    def predict(self, x: np.ndarray, params: Mapping[str, torch.Tensor]
                | None = None) -> tuple[np.ndarray, np.ndarray]:
        """Run one micro-batch, padded to its bucket; numpy in and out.

        ``params`` (from ``put_params``) overrides the serving weights for
        this call only: they are copied into the serving tensors, the
        bucket's own program runs, and the serving weights are copied back
        before the lock is released (the canary path)."""
        x = np.asarray(x, np.float32)
        if x.ndim != 4 or x.shape[1:] != self.window_shape:
            raise ValueError(
                f"request shape {x.shape} != (n, {self.n_stocks}, "
                f"{self.lookback}, {self.n_features})"
            )
        n = x.shape[0]
        b = self.bucket_for(n)
        if n < b:
            # Pad by repeating the first window: finite data (padding with
            # garbage could manufacture inf/nan that trips output checks),
            # sliced off before returning.
            pad = np.broadcast_to(x[:1], (b - n,) + x.shape[1:])
            x = np.concatenate([x, pad], axis=0)
        with self._lock, self._on_stream(), torch.inference_mode():
            self._check_open()
            program = self._program(b)
            program.load(x)
            live = None
            if params is not None:
                live = {k: v.clone() for k, v in self._live.items()}
                self._copy_in(params)
            try:
                # A bucket's first run on the card is its eager warm-up
                # (this batch's answer) and its capture; every later one a
                # replay.
                program.run()
            finally:
                if live is not None:
                    self._copy_in(live)
            # Read before the lock is released: the next batch of this
            # bucket overwrites the outputs and the staging buffers.
            alpha, beta = program.read()
        return alpha[:n], beta[:n]


def state_signature(state_dict: Mapping[str, torch.Tensor]
                    ) -> list[tuple[str, tuple, str]]:
    """(key, shape, dtype) of each tensor of a state dict, in key order:
    what a candidate must share with the serving weights."""
    return [(k, tuple(v.shape), str(v.dtype))
            for k, v in sorted(state_dict.items())]


class _BucketProgram:
    """The deterministic forward at one bucket's shape, from the static input
    ``x`` into the static outputs ``alpha`` and ``beta``. ``run`` is the
    eager forward, or its CUDA graph, captured in a thread-local mode so
    that a server's other threads keep running. On the card the batch and
    the answers pass through pinned host buffers (``load``, ``read``), on
    the caller's current stream: its engine's own."""

    def __init__(self, module, shape: tuple, device, graphed: bool):
        self.module = module
        self.device = device
        self.x = torch.zeros(shape, device=device)
        self.alpha = torch.zeros(shape[:2] + (1,), device=device)
        self.beta = torch.zeros(shape[:2] + (module.n_factors,), device=device)
        if device.type == "cuda":
            self.x_host = torch.zeros(shape, pin_memory=True)
            self.alpha_host = torch.zeros(shape[:2], pin_memory=True)
            self.beta_host = torch.zeros(shape[:2], pin_memory=True)
        self.run = (GraphedCall(self._forward, device=device,
                                name=f"bucket {shape[0]}",
                                capture_error_mode="thread_local")
                    if graphed else self._forward)

    @property
    def captured(self) -> bool:
        return isinstance(self.run, GraphedCall) and self.run.captured

    def _forward(self) -> None:
        alpha, beta = forward_rows(self.module, self.x)
        self.alpha.copy_(alpha)
        self.beta.copy_(beta)

    def load(self, x: np.ndarray) -> None:
        """The padded batch into ``x``: on the card through the pinned
        buffer, by a copy that does not wait."""
        if self.device.type != "cuda":
            self.x.copy_(torch.from_numpy(np.ascontiguousarray(x)))
            return
        self.x_host.numpy()[...] = x
        self.x.copy_(self.x_host, non_blocking=True)

    def read(self) -> tuple[np.ndarray, np.ndarray]:
        """Copies of the answers (alpha and beta's first factor). On the card
        they come back into pinned buffers by copies that do not wait,
        then one wait on an event recorded after them on the current
        stream: the dispatch's only synchronisation."""
        if self.device.type != "cuda":
            return (self.alpha[..., 0].numpy().copy(),
                    self.beta[..., 0].numpy().copy())
        self.alpha_host.copy_(self.alpha[..., 0], non_blocking=True)
        self.beta_host.copy_(self.beta[..., 0], non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        done.synchronize()
        return self.alpha_host.numpy().copy(), self.beta_host.numpy().copy()
