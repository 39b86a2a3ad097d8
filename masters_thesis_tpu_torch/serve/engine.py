"""Bucketed predict engine on one device.

Counterpart of ``masters_thesis_tpu/serve/engine.py`` with the same contract:
``predict`` maps a host batch ``x (n, K, T, F)`` to per-stock
``(alpha (n, K), beta (n, K))`` numpy arrays, deterministically, padding
``n`` up to the nearest bucket by repeating the first window, and refusing a
batch past the largest bucket with :class:`BucketOverflowError`.

PyTorch runs eagerly, so nothing is compiled (``compile_events`` stays 0) and
a bucket is only a batch shape; the padding keeps the shapes the kernels see
to the bucket ladder, as in the JAX engine. The mesh, the program cache, cost
profiles, hot-swap and CPU degradation of the JAX engine are not ported.
"""

from __future__ import annotations

import threading
import time
from typing import Mapping, Sequence

import numpy as np
import torch

from masters_thesis_tpu_torch import resolve_device
from masters_thesis_tpu_torch.models.objectives import ModelSpec
from masters_thesis_tpu_torch.train.steps import forward_rows

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
        #: Program compilations: always 0, PyTorch runs eagerly.
        self.compile_events = 0
        self._lock = threading.Lock()

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

    def warmup(self) -> float:
        """Run the largest bucket twice; returns the wall seconds of the
        second run (seeds the queue's service-time model)."""
        k, t, f = self.window_shape
        x = np.zeros((self.max_bucket, k, t, f), np.float32)
        self.predict(x)
        t0 = time.perf_counter()
        self.predict(x)
        return time.perf_counter() - t0

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
        xd = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        with self._lock, torch.inference_mode():
            alpha, beta = forward_rows(self._module, xd)
            alpha = alpha[..., 0].cpu().numpy()
            beta = beta[..., 0].cpu().numpy()
        return alpha[:n], beta[:n]
