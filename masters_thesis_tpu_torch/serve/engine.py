"""Bucketed predict engine on one device.

Counterpart of ``masters_thesis_tpu/serve/engine.py`` with the same contract:
``predict`` maps a host batch ``x (n, K, T, F)`` to per-stock
``(alpha (n, K), beta (n, K))`` numpy arrays, deterministically, padding
``n`` up to the nearest bucket by repeating the first window, and refusing a
batch past the largest bucket with :class:`BucketOverflowError`.

A bucket is one program, as in the JAX engine: on the card the forward at
the bucket's shape is one CUDA graph over a static input buffer, captured by
``warmup`` (or at the bucket's first use) and replayed for every batch
(``compile_events`` counts the captures); the padding keeps the shapes the
kernels see to the bucket ladder. On the CPU, or with ``cuda_graphs=False``,
the same forward runs eagerly over the same static buffer and nothing is
captured. ``from_checkpoint`` boots an engine from a published checkpoint
after verifying it strictly. The mesh, the program cache (a CUDA graph
cannot be written to disk), cost profiles, hot-swap and CPU degradation of
the JAX engine are not ported.
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
        run (seeds the queue's service-time model)."""
        if self.graphed:
            with self._lock, torch.inference_mode():
                for b in self.buckets:
                    self._program(b).run()
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

    def predict(self, x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Run one micro-batch, padded to its bucket; numpy in and out."""
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
            program.x.copy_(torch.from_numpy(np.ascontiguousarray(x)))
            # A bucket's first run on the card is its eager warm-up (this
            # batch's answer) and its capture; every later one a replay.
            program.run()
            # Copied out before the lock is released: the next batch of
            # this bucket overwrites the outputs (on the CPU too, where
            # .cpu() would return the buffer itself).
            alpha = program.alpha[..., 0].to("cpu", copy=True).numpy()
            beta = program.beta[..., 0].to("cpu", copy=True).numpy()
        return alpha[:n], beta[:n]


class _BucketProgram:
    """The deterministic forward at one bucket's shape, from the static input
    ``x`` into the static outputs ``alpha`` and ``beta``. ``run`` is the
    eager forward, or its CUDA graph, captured in a thread-local mode so
    that a server's other threads keep running."""

    def __init__(self, module, shape: tuple, device, graphed: bool):
        self.module = module
        self.x = torch.zeros(shape, device=device)
        self.alpha = torch.zeros(shape[:2] + (1,), device=device)
        self.beta = torch.zeros(shape[:2] + (module.n_factors,), device=device)
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
