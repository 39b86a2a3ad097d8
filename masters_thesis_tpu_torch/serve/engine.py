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
after verifying it strictly. The mesh, the program cache (a CUDA graph
cannot be written to disk), cost profiles and CPU degradation of the JAX
engine are not ported.
"""

from __future__ import annotations

import threading
import time
from pathlib import Path
from typing import Mapping, Sequence

import numpy as np
import torch

from masters_thesis_tpu_torch import resolve_device
from masters_thesis_tpu_torch.models.objectives import ModelSpec
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


class PredictEngine:
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
    ):
        self.spec = spec
        self.n_stocks = n_stocks
        self.lookback = lookback
        self.n_features = n_features
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"invalid buckets: {buckets!r}")
        self.device = resolve_device(device)
        self._module = spec.build_module(device=self.device)
        self._module.load_state_dict(state_dict)
        self._module.eval()
        self.graphed = cuda_graphs and self.device.type == "cuda"
        self._lock = threading.Lock()
        self._programs: dict[int, _BucketProgram] = {}
        #: The tensors the programs read (and the graphs were captured on):
        #: the module's parameters and buffers, by state-dict key.
        self._live = self._module.state_dict(keep_vars=True)
        #: Bytes the card's allocator peaked at during each bucket's
        #: capture (``warmup`` on the card): SV304 holds them against the
        #: card's memory.
        self.capture_peak_bytes: dict[int, int] = {}

    @classmethod
    def from_checkpoint(cls, ckpt_dir, tag: str = "best", *, n_stocks: int,
                        n_features: int = 3,
                        buckets: Sequence[int] = DEFAULT_BUCKETS, device=None,
                        cuda_graphs: bool = True) -> "PredictEngine":
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
                   cuda_graphs=cuda_graphs)

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
        """Buckets captured as CUDA graphs (0 on the CPU and without
        graphs): ``len(buckets)`` after ``warmup`` on the card."""
        return sum(1 for p in self._programs.values() if p.captured)

    def warmup(self) -> float:
        """Capture every bucket's graph on the card (each after one eager run
        on a zero batch), as the JAX engine compiles every bucket, then run
        the largest bucket twice; returns the wall seconds of the second
        run (seeds the queue's service-time model). Each capture's peak of
        the allocator goes into ``capture_peak_bytes`` (the allocator's
        peak statistic is reset before each)."""
        if self.graphed:
            with self._lock, torch.inference_mode():
                for b in self.buckets:
                    program = self._program(b)
                    if program.captured:
                        continue
                    torch.cuda.reset_peak_memory_stats(self.device)
                    program.run()
                    self.capture_peak_bytes[b] = int(
                        torch.cuda.max_memory_allocated(self.device))
        k, t, f = self.window_shape
        x = np.zeros((self.max_bucket, k, t, f), np.float32)
        self.predict(x)
        t0 = time.perf_counter()
        self.predict(x)
        return time.perf_counter() - t0

    def _program(self, bucket: int) -> "_BucketProgram":
        """The bucket's program, made at its first use; under ``_lock``."""
        program = self._programs.get(bucket)
        if program is None:
            program = _BucketProgram(self._module, (bucket, *self.window_shape),
                                     self.device, self.graphed)
            self._programs[bucket] = program
        return program

    def golden_batch(self, n: int = 1, seed: int = 0) -> np.ndarray:
        """Deterministic canary input of this engine's window shape,
        bitwise the JAX engine's."""
        k, t, f = self.window_shape
        rng = np.random.default_rng(seed)
        return rng.standard_normal((n, k, t, f)).astype(np.float32)

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
        return {k: torch.as_tensor(v).detach().to(self.device, copy=True)
                for k, v in state_dict.items()}

    def set_params(self, params: Mapping[str, torch.Tensor]
                   ) -> dict[str, torch.Tensor]:
        """Commit ``params`` (from ``put_params``) into the serving tensors,
        in place, under the engine lock; returns a copy of the old
        weights. A batch in flight finishes on the old weights, the next
        one runs on the new."""
        with self._lock, torch.inference_mode():
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
        with self._lock, torch.inference_mode():
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
    the answers pass through pinned host buffers (``load``, ``read``)."""

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
        then one wait on an event recorded after them: the dispatch's only
        synchronisation."""
        if self.device.type != "cuda":
            return (self.alpha[..., 0].numpy().copy(),
                    self.beta[..., 0].numpy().copy())
        self.alpha_host.copy_(self.alpha[..., 0], non_blocking=True)
        self.beta_host.copy_(self.beta[..., 0], non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
        return self.alpha_host.numpy().copy(), self.beta_host.numpy().copy()
