"""Windowed-dataset pipeline: bootstrap, window build, cache and splits.

Counterpart of ``masters_thesis_tpu/data/pipeline.py`` for the scalar
market series. The prepared dataset is cached as ``<data_dir>/datasets/
dataset.npz`` keyed by a SHA-256 of the window hyperparameters and a
fingerprint of the source files (the JAX package's scheme), split
chronologically 70/20/10 and served as whole-split arrays, which the trainer
moves to the device once. Windows are built with the port's own
``ops/windows.py`` (torch on the CPU). The C++ window engine, the on-disk
window store, the K-factor source, the multi-host rendezvous and the
per-batch iterators are not ported.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from masters_thesis_tpu_torch.data.synthetic import SyntheticLogReturns
from masters_thesis_tpu_torch.ops.windows import (
    add_quadratic_features,
    lookback_target_split,
    ols_features,
)
from masters_thesis_tpu_torch.utils.io import publish


class Batch(NamedTuple):
    """Windows with leading dims ``(batch, n_stocks, ...)``: ``x`` the
    feature-expanded lookback ``(B, K, lookback, 3)``, ``y`` the target
    window with label channels ``(B, K, target, 4)`` = ``[r_stock, r_market,
    alpha, beta]``, ``factor`` ``(B, 2)`` = (market mean, var), ``inv_psi``
    ``(B, K)``. numpy arrays or tensors."""

    x: object
    y: object
    factor: object
    inv_psi: object


def bootstrap_synthetic(
    data_dir: Path,
    n_stocks: int = 100,
    n_samples: int = 1_000_000,
    seed: int = 0,
) -> None:
    """Generate and save the synthetic market history (the DGP's default
    ``no_outliers`` variant) if not already there.

    ``stocks.npy``, ``market.npy``, ``alphas.npy`` and ``betas.npy`` are
    written first, then the ``dgp.json`` sidecar with the generation
    parameters, which marks the set complete. Asking for other parameters in
    a directory that holds a dataset, or finding arrays without the sidecar,
    raises instead of reusing or overwriting them.
    """
    data_dir = Path(data_dir)
    requested = {
        "n_stocks": n_stocks, "n_samples": n_samples, "seed": seed,
        "variant": "no_outliers",
    }
    meta_file = data_dir / "dgp.json"
    if meta_file.exists():
        existing = json.loads(meta_file.read_text())
        if existing != requested:
            raise ValueError(
                f"{data_dir} holds a synthetic dataset generated with "
                f"{existing}, but {requested} was requested — use a "
                "different data_dir or delete the old dataset"
            )
        return
    if (data_dir / "stocks.npy").exists():
        raise ValueError(
            f"{data_dir} contains arrays without a dgp.json sidecar (torn "
            "bootstrap or dataset of unknown provenance) — delete the "
            "directory to regenerate"
        )
    data_dir.mkdir(parents=True, exist_ok=True)
    r_stocks, r_market, alphas, betas = SyntheticLogReturns.generate(
        n_stocks, n_samples, seed
    )
    for name, arr in (("stocks.npy", r_stocks), ("market.npy", r_market),
                      ("alphas.npy", alphas), ("betas.npy", betas)):
        publish(data_dir / name, lambda f, a=arr: np.save(f, a))
    publish(meta_file, lambda f: f.write(json.dumps(requested, indent=2).encode()))


def append_label_channels(y, t_alphas, t_betas, alphas, betas) -> np.ndarray:
    """Append ``[alpha, beta]`` label channels to the target window: the
    ground-truth coefficients when the DGP recorded them, else the
    target-window OLS fit."""
    n_windows = y.shape[0]
    if alphas is None or betas is None:
        alpha_label, beta_label = np.asarray(t_alphas), np.asarray(t_betas)
    else:
        alpha_label = np.broadcast_to(alphas[None, :], (n_windows, len(alphas)))
        beta_label = np.broadcast_to(betas[None, :], (n_windows, len(betas)))
    shape = y.shape[:3] + (1,)
    return np.concatenate(
        [y, np.broadcast_to(alpha_label[:, :, None, None], shape),
         np.broadcast_to(beta_label[:, :, None, None], shape)],
        axis=-1,
    )


class FinancialWindowDataModule:
    """Prepares, caches and splits the windowed factor-model dataset."""

    def __init__(
        self,
        data_dir: Path,
        lookback_window: int = 60,
        target_window: int = 20,
        stride: int = 80,
        prediction_task: bool = True,
        interaction_only: bool = True,
        batch_size: int = 1,
    ):
        if not prediction_task and target_window > lookback_window:
            raise ValueError(
                "target window must be <= lookback window for reconstruction task"
            )
        self.data_dir = Path(data_dir)
        self.lookback_window = lookback_window
        self.target_window = target_window
        self.stride = stride
        self.prediction_task = prediction_task
        self.interaction_only = interaction_only
        self.batch_size = batch_size
        self.train_range: range | None = None
        self.val_range: range | None = None
        self.test_range: range | None = None
        self._arrays: Batch | None = None

    @property
    def n_features(self) -> int:
        return 3 if self.interaction_only else 5

    @property
    def n_stocks(self) -> int | None:
        """Stocks per window once ``setup`` has loaded the arrays."""
        return None if self._arrays is None else int(self._arrays.x.shape[1])

    @property
    def _datasets_dir(self) -> Path:
        return self.data_dir / "datasets"

    def _hparams_hash(self) -> str:
        """SHA-256 over the window hyperparameters and a content fingerprint
        of the source files (size and a digest of the first 64 KiB each), so
        a regenerated source rebuilds the cache."""
        fingerprint = []
        for name in ("stocks.npy", "market.npy", "factors.npy", "dgp.json"):
            path = self.data_dir / name
            if path.exists():
                with open(path, "rb") as f:
                    head = f.read(65536)
                fingerprint.append(
                    [name, path.stat().st_size, hashlib.sha256(head).hexdigest()[:16]]
                )
        hparams = {
            "lookback_window": self.lookback_window,
            "target_window": self.target_window,
            "stride": self.stride,
            "prediction_task": self.prediction_task,
            "interaction_only": self.interaction_only,
            "source": fingerprint,
        }
        return hashlib.sha256(json.dumps(hparams, sort_keys=True).encode()).hexdigest()

    def prepare_data(self) -> None:
        """Build the windowed dataset and cache it, keyed by the hparams hash;
        the hash file is written after the dataset. An unchanged cache is
        reused."""
        if (self.data_dir / "factors.npy").exists():
            raise NotImplementedError(
                "the K-factor source (factors.npy) is not ported; the port "
                "builds windows over the scalar market series"
            )
        hparams_hash = self._hparams_hash()
        self._datasets_dir.mkdir(parents=True, exist_ok=True)
        hash_file = self._datasets_dir / "hparams_hash.txt"
        dataset_file = self._datasets_dir / "dataset.npz"
        if (hash_file.exists() and dataset_file.exists()
                and hash_file.read_text().strip() == hparams_hash):
            return
        r_stocks = np.load(self.data_dir / "stocks.npy")
        r_market = np.load(self.data_dir / "market.npy")
        alphas = betas = None
        if (self.data_dir / "alphas.npy").exists():
            alphas = np.load(self.data_dir / "alphas.npy")
            betas = np.load(self.data_dir / "betas.npy")
        x, y, t_alphas, t_betas, factor, inv_psi = self.build_windows(
            r_stocks, r_market
        )
        y = append_label_channels(y, t_alphas, t_betas, alphas, betas)
        publish(dataset_file, lambda f: np.savez(
            f, x=x, y=y, factor=factor, inv_psi=inv_psi))
        publish(hash_file, lambda f: f.write(hparams_hash.encode()))

    def build_windows(self, r_stocks: np.ndarray, r_market: np.ndarray):
        """Window, feature-expand and OLS-label the series: numpy
        ``(x, y, alphas, betas, factor, inv_psi)``."""
        x, y = lookback_target_split(
            torch.from_numpy(np.asarray(r_stocks)),
            torch.from_numpy(np.asarray(r_market)),
            lookback_window=self.lookback_window,
            target_window=self.target_window,
            stride=self.stride,
            prediction=self.prediction_task,
        )
        x = add_quadratic_features(x, interaction_only=self.interaction_only)
        t_alphas, t_betas, factor, inv_psi = ols_features(y)
        return tuple(t.numpy() for t in (x, y, t_alphas, t_betas, factor, inv_psi))

    def setup(self, stage: str | None = None) -> None:
        """Load the cached dataset and compute the chronological 70/20/10 split."""
        with np.load(self._datasets_dir / "dataset.npz") as data:
            self._arrays = Batch(x=data["x"], y=data["y"], factor=data["factor"],
                                 inv_psi=data["inv_psi"])
        n = self._arrays.x.shape[0]
        train_end, val_end = int(0.7 * n), int(0.9 * n)
        if stage in ("fit", None):
            self.train_range = range(0, train_end)
            self.val_range = range(train_end, val_end)
        if stage in ("test", None):
            self.test_range = range(val_end, n)

    def _slice(self, window_range: range | None, stage: str) -> Batch:
        if window_range is None or self._arrays is None:
            raise RuntimeError(f"call setup({stage!r}) first")
        idx = slice(window_range.start, window_range.stop)
        return Batch(*(a[idx] for a in self._arrays))

    def train_arrays(self) -> Batch:
        return self._slice(self.train_range, "fit")

    def val_arrays(self) -> Batch:
        return self._slice(self.val_range, "fit")

    def test_arrays(self) -> Batch:
        return self._slice(self.test_range, "test")
