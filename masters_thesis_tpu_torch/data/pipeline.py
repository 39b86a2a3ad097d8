"""Windowed-dataset pipeline: bootstrap, window build, cache and splits.

Counterpart of ``masters_thesis_tpu/data/pipeline.py``. The prepared dataset
is cached as ``<data_dir>/datasets/dataset.npz`` keyed by a SHA-256 of the
window hyperparameters and a fingerprint of the source files (the JAX
package's scheme), or, with ``store_shards``, as the on-disk window store
``<data_dir>/datasets/window_store/`` (``data/window_store.py``), whose
shards are served as memmaps. It is split chronologically 70/20/10 and
served as whole-split arrays, which the scan epoch moves to the device once,
or as host batches (``train_batches``, shuffled by ``(seed, epoch)`` as the
JAX package shuffles them), which the stream epoch prefetches. The source is
the synthetic DGP (``bootstrap_synthetic``: the scalar market model, or the
K-factor model with ``n_factors > 1``, which writes ``factors.npy``) or the
Fama-French CSVs (``bootstrap_real``). Windows are built by the C++ engine
(``native/``; ``engine="auto"`` takes it for the scalar series when it
builds) or by the port's ``ops/windows.py`` (torch on the CPU, the python
engine; K-factor windows and the store always). Across the ranks of a
launch (``utils/backend_probe.py`` ``multihost_rank``) rank 0 makes the
synthetic arrays, the cache and the window store, and every other rank
polls for the published marker (``utils/io.py`` ``wait_until``) before it
builds a copy of its own (a host-local data directory).
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Iterator, NamedTuple

import numpy as np
import torch

from masters_thesis_tpu_torch.data.fama_french import FamaFrench25Portfolios
from masters_thesis_tpu_torch.data.synthetic import (
    SyntheticKFactorReturns,
    SyntheticLogReturns,
)
from masters_thesis_tpu_torch.data.window_store import (
    WindowStore,
    WindowStoreError,
    append_label_channels,
)
from masters_thesis_tpu_torch.ops.windows import (
    add_quadratic_features,
    lookback_target_split,
    ols_features,
)
from masters_thesis_tpu_torch.utils.backend_probe import multihost_rank
from masters_thesis_tpu_torch.utils.io import (
    atomic_write_text,
    publish,
    wait_until,
)

#: Seconds a rank other than 0 waits for rank 0's published data before it
#: builds its own (the directory is then taken to be host-local).
RENDEZVOUS_TIMEOUT_S = 600.0


class Batch(NamedTuple):
    """Windows with leading dims ``(batch, n_stocks, ...)``: ``x`` the
    feature-expanded lookback ``(B, K, lookback, 2F+1)``, ``y`` the target
    window with label channels ``(B, K, target, 2F+2)`` = ``[r_stock,
    f_1..f_F, alpha, beta_1..beta_F]``, ``factor`` ``(B, 2)`` = (market
    mean, var) at F=1, ``(B, F+F²)`` = ``[f_mean | f_cov.ravel()]`` above,
    ``inv_psi`` ``(B, K)``. numpy arrays or tensors."""

    x: object
    y: object
    factor: object
    inv_psi: object


def bootstrap_synthetic(
    data_dir: Path,
    n_stocks: int = 100,
    n_samples: int = 1_000_000,
    seed: int = 0,
    variant: str = "no_outliers",
    n_factors: int = 1,
    marker_grace_s: float = 60.0,
) -> None:
    """Generate and save the synthetic market history of the DGP's
    ``variant`` (``no_outliers``, the reference's, or ``outliers``) if not
    already there.

    ``stocks.npy``, ``market.npy`` (or, with ``n_factors > 1``, the K-factor
    DGP's ``factors.npy``), ``alphas.npy`` and ``betas.npy`` are written
    first, then the ``dgp.json`` sidecar with the generation parameters,
    which marks the set complete (``n_factors`` is recorded only when it is
    not 1, so the sidecar is the JAX package's byte for byte). Asking for
    other parameters in a directory that holds a dataset raises instead of
    reusing or overwriting it; so do arrays whose sidecar has not appeared
    within ``marker_grace_s`` (a concurrent writer, such as another job of
    a parallel sweep, publishes the arrays first). Across the ranks of a
    launch rank 0 generates and the others wait for its sidecar.
    """
    data_dir = Path(data_dir)
    requested = {
        "n_stocks": n_stocks, "n_samples": n_samples, "seed": seed,
        "variant": variant,
    }
    if n_factors != 1:
        requested["n_factors"] = n_factors
    meta_file = data_dir / "dgp.json"

    def check_existing() -> bool:
        if not (meta_file.exists() and (data_dir / "stocks.npy").exists()):
            return False
        existing = json.loads(meta_file.read_text())
        if existing != requested:
            raise ValueError(
                f"{data_dir} holds a synthetic dataset generated with "
                f"{existing}, but {requested} was requested — use a "
                "different data_dir or delete the old dataset"
            )
        return True

    if check_existing():
        return
    if (data_dir / "stocks.npy").exists():
        if wait_until(check_existing, marker_grace_s):
            return
        raise ValueError(
            f"{data_dir} contains arrays without a dgp.json sidecar (torn "
            "bootstrap or dataset of unknown provenance) — delete the "
            "directory to regenerate"
        )
    rank, world = multihost_rank()
    if world > 1 and rank != 0 and wait_until(check_existing,
                                              RENDEZVOUS_TIMEOUT_S):
        return
    data_dir.mkdir(parents=True, exist_ok=True)
    if n_factors == 1:
        r_stocks, r_market, alphas, betas = SyntheticLogReturns.generate(
            n_stocks, n_samples, seed, variant
        )
        arrays = {"stocks.npy": r_stocks, "market.npy": r_market}
    else:
        r_stocks, factors, alphas, betas = SyntheticKFactorReturns.generate(
            n_stocks, n_samples, n_factors, seed, variant=variant
        )
        arrays = {"stocks.npy": r_stocks, "factors.npy": factors}
    arrays.update({"alphas.npy": alphas, "betas.npy": betas})
    for name, arr in arrays.items():
        publish(data_dir / name, lambda f, a=arr: np.save(f, np.asarray(a)))
    atomic_write_text(meta_file, json.dumps(requested, indent=2))


def bootstrap_real(raw_dir: Path, data_dir: Path) -> bool:
    """Convert the Fama-French CSVs under ``raw_dir`` into ``stocks.npy``
    (25 portfolios) and ``market.npy`` under ``data_dir`` unless they are
    there; False when a CSV is missing (downloading them is a manual step,
    as in the reference). ``stocks.npy``, published last, marks the set
    complete."""
    data_dir = Path(data_dir)
    if (data_dir / "stocks.npy").exists():
        return True
    raw_dir = Path(raw_dir)
    if not all((raw_dir / name).exists()
               for name in (FamaFrench25Portfolios.ff3_filename,
                            FamaFrench25Portfolios.p25_filename)):
        return False
    data_dir.mkdir(parents=True, exist_ok=True)
    p25, mkt = FamaFrench25Portfolios.load(raw_dir)
    publish(data_dir / "market.npy", lambda f: np.save(f, mkt))
    publish(data_dir / "stocks.npy", lambda f: np.save(f, p25))
    return True


ENGINES = ("auto", "native", "python")


class FinancialWindowDataModule:
    """Prepares, caches and splits the windowed factor-model dataset.

    ``engine`` builds the windows of the npz cache: ``"native"`` the C++
    engine (scalar series only; raises when it cannot build), ``"python"``
    the port's window ops, ``"auto"`` the C++ engine for the scalar series
    when it builds, else the window ops. ``store_shards`` keeps the windows
    in the on-disk store of that many shards instead of the npz cache.
    """

    def __init__(
        self,
        data_dir: Path,
        lookback_window: int = 60,
        target_window: int = 20,
        stride: int = 80,
        prediction_task: bool = True,
        interaction_only: bool = True,
        batch_size: int = 1,
        engine: str = "auto",
        store_shards: int | None = None,
    ):
        if engine not in ENGINES:
            raise ValueError(f"unknown engine: {engine!r}")
        if store_shards is not None and store_shards < 1:
            raise ValueError(f"store_shards must be >= 1, got {store_shards}")
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
        self.engine = engine
        self.store_shards = store_shards
        self.train_range: range | None = None
        self.val_range: range | None = None
        self.test_range: range | None = None
        self._arrays: Batch | None = None
        self._store: WindowStore | None = None

    @property
    def n_factors(self) -> int:
        """Factors of the source: the rows of ``factors.npy`` when the
        K-factor DGP wrote one, else 1 (the scalar market series)."""
        path = self.data_dir / "factors.npy"
        if not path.exists():
            return 1
        return int(np.load(path, mmap_mode="r").shape[0])

    @property
    def n_features(self) -> int:
        k = self.n_factors
        return 2 * k + 1 if self.interaction_only else 3 * k + 2

    @property
    def n_stocks(self) -> int | None:
        """Stocks per window once ``setup`` has loaded the arrays."""
        if self._store is not None:
            return int(self._store.field_shape("x")[1])
        return None if self._arrays is None else int(self._arrays.x.shape[1])

    @property
    def store(self) -> WindowStore | None:
        """The window store ``setup`` opened (``store_shards`` set)."""
        return self._store

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

    @property
    def _store_dir(self) -> Path:
        return self._datasets_dir / "window_store"

    def prepare_data(self) -> None:
        """Build the windowed dataset and cache it, keyed by the hparams hash;
        the hash file is written after the dataset. An unchanged cache is
        reused. With ``store_shards`` the cache is the window store."""
        if self.store_shards is not None:
            self._prepare_store()
            return
        hparams_hash = self._hparams_hash()
        self._datasets_dir.mkdir(parents=True, exist_ok=True)
        hash_file = self._datasets_dir / "hparams_hash.txt"
        dataset_file = self._datasets_dir / "dataset.npz"

        def cache_ready() -> bool:
            return (hash_file.exists() and dataset_file.exists()
                    and hash_file.read_text().strip() == hparams_hash)

        if cache_ready():
            return
        rank, world = multihost_rank()
        if world > 1 and rank != 0:
            if wait_until(cache_ready, RENDEZVOUS_TIMEOUT_S):
                return
            print("no shared dataset cache appeared; building a host-local "
                  "one", flush=True)
        r_stocks, factors, alphas, betas = self._load_source()
        x, y, t_alphas, t_betas, factor, inv_psi = self.build_windows(
            r_stocks, factors
        )
        y = append_label_channels(y, t_alphas, t_betas, alphas, betas)
        publish(dataset_file, lambda f: np.savez(
            f, x=x, y=y, factor=factor, inv_psi=inv_psi))
        atomic_write_text(hash_file, hparams_hash)

    def _load_source(self):
        """``(r_stocks, factors, alphas, betas)``: the K-factor block when
        the DGP wrote ``factors.npy``, else the market series; the
        ground-truth coefficients, or None, when the source has none."""
        def load(name):
            path = self.data_dir / name
            return np.load(path) if path.exists() else None

        factors = load("factors.npy")
        if factors is None:
            factors = np.load(self.data_dir / "market.npy")
        return (np.load(self.data_dir / "stocks.npy"), factors,
                load("alphas.npy"), load("betas.npy"))

    def _prepare_store(self) -> None:
        """Build the window store unless one of this source and shard count
        is there. It always builds through the python engine."""
        hparams_hash = self._hparams_hash()

        def cache_ready() -> bool:
            try:
                store = WindowStore.open(self._store_dir)
            except WindowStoreError:
                return False
            return (store.source_hash == hparams_hash
                    and store.n_shards == min(self.store_shards,
                                              store.n_windows))

        if cache_ready():
            return
        rank, world = multihost_rank()
        if world > 1 and rank != 0:
            if wait_until(cache_ready, RENDEZVOUS_TIMEOUT_S):
                return
            print("no shared window store appeared; building a host-local "
                  "one", flush=True)
        if self.engine == "native":
            print("window store builds use the python engine (the native "
                  "engine does not build stores)", flush=True)
        r_stocks, factors, alphas, betas = self._load_source()
        WindowStore.build_from_series(
            self._store_dir, r_stocks, factors, alphas, betas,
            lookback_window=self.lookback_window,
            target_window=self.target_window,
            stride=self.stride,
            prediction=self.prediction_task,
            interaction_only=self.interaction_only,
            n_shards=self.store_shards,
            source_hash=hparams_hash,
        )

    def build_windows(self, r_stocks: np.ndarray, factors: np.ndarray):
        """Window, feature-expand and OLS-label the series (``factors`` the
        market ``(T,)`` or the factor block ``(F, T)``): numpy ``(x, y,
        alphas, betas, factor, inv_psi)``, through the engine the data
        module was given."""
        scalar = np.ndim(factors) == 1
        if not scalar and self.engine == "native":
            raise ValueError(
                "engine='native' only supports the scalar market series; the "
                "K-factor windows build through the python engine "
                "(engine='python' or 'auto')"
            )
        if scalar and self.engine in ("auto", "native"):
            from masters_thesis_tpu_torch import native

            try:
                if self.engine == "native" or native.available():
                    out = native.build_dataset(
                        r_stocks, factors,
                        lookback_window=self.lookback_window,
                        target_window=self.target_window,
                        stride=self.stride,
                        prediction=self.prediction_task,
                        interaction_only=self.interaction_only,
                    )
                    return tuple(out[k] for k in ("x", "y", "alphas", "betas",
                                                  "factor", "inv_psi"))
            except (native.NativeBuildError, OSError) as exc:
                # OSError: a cached library that does not load.
                if self.engine == "native":
                    raise
                print(f"native engine unavailable ({exc}); using the python "
                      "engine", flush=True)
        x, y = lookback_target_split(
            torch.from_numpy(np.asarray(r_stocks)),
            torch.from_numpy(np.asarray(factors)),
            lookback_window=self.lookback_window,
            target_window=self.target_window,
            stride=self.stride,
            prediction=self.prediction_task,
        )
        x = add_quadratic_features(x, interaction_only=self.interaction_only)
        t_alphas, t_betas, factor, inv_psi = ols_features(y)
        return tuple(t.numpy() for t in (x, y, t_alphas, t_betas, factor, inv_psi))

    def setup(self, stage: str | None = None) -> None:
        """Load the cached dataset (or open the window store) and compute
        the chronological 70/20/10 split."""
        if self.store_shards is not None:
            self._store = WindowStore.open(self._store_dir)
            n = self._store.n_windows
        else:
            with np.load(self._datasets_dir / "dataset.npz") as data:
                self._arrays = Batch(x=data["x"], y=data["y"],
                                     factor=data["factor"],
                                     inv_psi=data["inv_psi"])
            n = self._arrays.x.shape[0]
        train_end, val_end = int(0.7 * n), int(0.9 * n)
        if stage in ("fit", None):
            self.train_range = range(0, train_end)
            self.val_range = range(train_end, val_end)
        if stage in ("test", None):
            self.test_range = range(val_end, n)

    def _take(self, idx: np.ndarray) -> Batch:
        """Windows ``idx`` (ascending runs inside one store shard stay
        memmap views)."""
        if self._store is not None:
            return Batch(*self._store.take(idx))
        if self._arrays is None:
            raise RuntimeError("call setup() first")
        return Batch(*(a[idx] for a in self._arrays))

    def _slice(self, window_range: range | None, stage: str) -> Batch:
        if window_range is None or (self._arrays is None
                                    and self._store is None):
            raise RuntimeError(f"call setup({stage!r}) first")
        if self._store is not None:
            return self._take(np.asarray(window_range))
        idx = slice(window_range.start, window_range.stop)
        return Batch(*(a[idx] for a in self._arrays))

    def take(self, idx: np.ndarray) -> Batch:
        """The windows at indices ``idx`` of the whole dataset."""
        return self._take(idx)

    @staticmethod
    def _order(window_range: range, shuffle_seed) -> np.ndarray:
        order = np.asarray(window_range)
        if shuffle_seed is not None:
            order = np.random.default_rng(shuffle_seed).permutation(order)
        return order

    def _iterate(self, window_range: range, batch_size: int,
                 shuffle_seed) -> Iterator[Batch]:
        """Host batches of ``batch_size`` windows of ``window_range`` (the
        last one short), in order or permuted by
        ``np.random.default_rng(shuffle_seed)``."""
        order = self._order(window_range, shuffle_seed)
        for start in range(0, len(order), batch_size):
            yield self._take(order[start:start + batch_size])

    def train_order(self, epoch: int = 0, seed: int = 0) -> np.ndarray:
        """The train windows' indices in ``train_batches``' order for
        ``(seed, epoch)`` (a data-parallel stream epoch cuts its global
        batches from it)."""
        if self.train_range is None:
            raise RuntimeError("call setup('fit') first")
        return self._order(self.train_range, (seed, epoch))

    def train_batches(self, epoch: int = 0, seed: int = 0,
                      shuffle: bool = True) -> Iterator[Batch]:
        """Train batches of ``batch_size`` windows, shuffled by ``(seed,
        epoch)`` (a sequence seed, not ``hash``: reproducible across Python
        versions), or in order with ``shuffle=False``."""
        if self.train_range is None:
            raise RuntimeError("call setup('fit') first")
        return self._iterate(self.train_range, self.batch_size,
                             (seed, epoch) if shuffle else None)

    def val_batches(self) -> Iterator[Batch]:
        if self.val_range is None:
            raise RuntimeError("call setup('fit') first")
        return self._iterate(self.val_range, 1, None)

    def test_batches(self) -> Iterator[Batch]:
        if self.test_range is None:
            raise RuntimeError("call setup('test') first")
        return self._iterate(self.test_range, 1, None)

    def train_arrays(self) -> Batch:
        return self._slice(self.train_range, "fit")

    def val_arrays(self) -> Batch:
        return self._slice(self.val_range, "fit")

    def test_arrays(self) -> Batch:
        return self._slice(self.test_range, "test")
