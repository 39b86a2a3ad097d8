"""On-disk sharded window store: memory-mapped and content-hashed.

Counterpart of ``masters_thesis_tpu/data/window_store.py``, with the same
on-disk layout, so either package opens a store that the other built. The
windowed dataset is kept on disk as ``n_shards`` shard files per field
(``shard{NNNNN}.{field}.npy``), built shard by shard from bounded time
slices of the raw series and served back as ``np.memmap`` views, so the
page cache and not the Python heap holds them.

- Shard boundaries come from :func:`shard_bounds` (balanced contiguous, the
  remainder to the first shards), the JAX package's rule.
- Every shard file is published atomically and recorded in
  ``manifest.json`` with its byte size and SHA-256; the manifest, written
  last, marks the store complete. ``open`` refuses a store without it, a
  missing or resized shard, another ``version`` and, with ``verify``, a
  shard whose content no longer hashes to the manifest's digest.
- A shard is built with the port's window ops (``ops/windows.py``, torch
  on the CPU), the ops of the data module's python engine. Each window's
  features and OLS labels depend on its own time slice only, so a shard's
  rows are bitwise the in-memory build's rows. The native engine's labels
  differ from those ops in the last bits, so the store never builds through
  it (as in the JAX package).
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np
import torch

from masters_thesis_tpu_torch.ops.windows import (
    add_quadratic_features,
    lookback_target_split,
    ols_features,
)
from masters_thesis_tpu_torch.utils.io import atomic_write_text, publish

MANIFEST_NAME = "manifest.json"
STORE_VERSION = 1

# Per-window fields, in the order of the pipeline's Batch.
FIELDS = ("x", "y", "factor", "inv_psi")


class WindowStoreError(RuntimeError):
    """A store is absent, torn, of another version, or fails verification."""


def shard_bounds(n: int, world: int, rank: int) -> tuple[int, int]:
    """Balanced contiguous ``[lo, hi)`` bounds of shard ``rank`` of ``n``
    items over ``world`` shards: sizes differ by at most one, the remainder
    going to the first ``n % world`` shards (the JAX package's
    ``parallel/mesh.py`` rule)."""
    if world <= 0:
        raise ValueError(f"world must be positive, got {world}")
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside [0, {world})")
    base, extra = divmod(n, world)
    lo = rank * base + min(rank, extra)
    return lo, lo + base + (1 if rank < extra else 0)


def _shard_filename(shard: int, field: str) -> str:
    return f"shard{shard:05d}.{field}.npy"


def _sha256_file(path: Path) -> str:
    digest = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            digest.update(chunk)
    return digest.hexdigest()


class WindowStore:
    """Reader over a built store directory; shards are served as memmaps."""

    def __init__(self, store_dir: Path, manifest: dict):
        self.store_dir = Path(store_dir)
        self.manifest = manifest
        self._shard_cache: dict[int, dict[str, np.ndarray]] = {}

    @classmethod
    def open(cls, store_dir: Path, verify: bool = False) -> "WindowStore":
        """Open a store, refusing anything torn or (with ``verify``) altered.

        The manifest must exist and carry ``STORE_VERSION``, and every shard
        file it records must exist with its recorded byte size;
        ``verify=True`` also hashes every shard file against the manifest.
        """
        store_dir = Path(store_dir)
        manifest_file = store_dir / MANIFEST_NAME
        if not manifest_file.exists():
            raise WindowStoreError(
                f"{store_dir} has no {MANIFEST_NAME} — the store is absent or "
                "a build was torn before completion; rebuild it"
            )
        manifest = json.loads(manifest_file.read_text())
        if manifest.get("version") != STORE_VERSION:
            raise WindowStoreError(
                f"{store_dir} manifest version {manifest.get('version')!r} != "
                f"{STORE_VERSION} — rebuild the store"
            )
        for entry in manifest["shards"]:
            for field, rec in entry["files"].items():
                path = store_dir / _shard_filename(entry["shard"], field)
                if not path.exists():
                    raise WindowStoreError(
                        f"{path.name} is missing from {store_dir} (torn "
                        "store) — rebuild the store"
                    )
                size = path.stat().st_size
                if size != rec["bytes"]:
                    raise WindowStoreError(
                        f"{path.name} is {size} bytes, manifest records "
                        f"{rec['bytes']} (torn or truncated shard) — rebuild "
                        "the store"
                    )
                if verify and _sha256_file(path) != rec["sha256"]:
                    raise WindowStoreError(
                        f"{path.name} content hash does not match the "
                        "manifest — the shard was altered or corrupted after "
                        "publish; rebuild the store"
                    )
        return cls(store_dir, manifest)

    @property
    def n_windows(self) -> int:
        return int(self.manifest["n_windows"])

    @property
    def n_shards(self) -> int:
        return int(self.manifest["n_shards"])

    @property
    def source_hash(self) -> str:
        return self.manifest.get("source_hash", "")

    @property
    def nbytes(self) -> int:
        return sum(rec["bytes"] for entry in self.manifest["shards"]
                   for rec in entry["files"].values())

    def field_shape(self, field: str) -> tuple[int, ...]:
        """Shape of one field over every window."""
        return (self.n_windows, *self.manifest["fields"][field]["shape"])

    def bounds(self, shard: int) -> tuple[int, int]:
        entry = self.manifest["shards"][shard]
        return int(entry["lo"]), int(entry["hi"])

    def load_shard(self, shard: int) -> dict[str, np.ndarray]:
        """Memory-mapped views of one shard's fields (windows ``[lo, hi)``)."""
        cached = self._shard_cache.get(shard)
        if cached is None:
            cached = {field: np.load(self.store_dir
                                     / _shard_filename(shard, field),
                                     mmap_mode="r")
                      for field in FIELDS}
            self._shard_cache[shard] = cached
        return cached

    def _shard_of(self, indices: np.ndarray) -> np.ndarray:
        los = np.asarray([e["lo"] for e in self.manifest["shards"]])
        return np.searchsorted(los, indices, side="right") - 1

    def _empty(self, n: int) -> tuple[np.ndarray, ...]:
        return tuple(np.empty((n, *self.manifest["fields"][f]["shape"]),
                              dtype=self.manifest["fields"][f]["dtype"])
                     for f in FIELDS)

    def take(self, indices) -> tuple[np.ndarray, ...]:
        """Rows ``indices`` of every field, in ``FIELDS`` order: zero-copy
        memmap views for an ascending contiguous run inside one shard, else
        gathered shard by shard into fresh arrays."""
        idx = np.asarray(indices, dtype=np.int64)
        if idx.ndim != 1:
            raise ValueError(f"take() wants a 1-D index array, got {idx.shape}")
        if idx.size == 0:
            return self._empty(0)
        shards = self._shard_of(idx)
        same_shard = bool((shards == shards[0]).all())
        contiguous = idx.size == 1 or bool((np.diff(idx) == 1).all())
        if same_shard and contiguous:
            lo, _ = self.bounds(int(shards[0]))
            arrays = self.load_shard(int(shards[0]))
            a, b = int(idx[0] - lo), int(idx[-1] - lo + 1)
            return tuple(arrays[f][a:b] for f in FIELDS)
        out = self._empty(idx.size)
        for shard in np.unique(shards):
            mask = shards == shard
            lo, _ = self.bounds(int(shard))
            arrays = self.load_shard(int(shard))
            rel = idx[mask] - lo
            for field, dst in zip(FIELDS, out):
                dst[mask] = arrays[field][rel]
        return out

    def load_all(self) -> tuple[np.ndarray, ...]:
        """Every window of every field, in ``FIELDS`` order (copies, or one
        shard's views when the store has one shard: for small stores)."""
        return self.take(np.arange(self.n_windows))

    def iter_shards(self):
        """``(lo, hi, {field: memmap})`` of each shard, in layout order."""
        for shard in range(self.n_shards):
            lo, hi = self.bounds(shard)
            yield lo, hi, self.load_shard(shard)

    @classmethod
    def build_from_series(
        cls,
        store_dir: Path,
        r_stocks: np.ndarray,
        r_factors: np.ndarray,
        alphas: np.ndarray | None = None,
        betas: np.ndarray | None = None,
        *,
        lookback_window: int,
        target_window: int,
        stride: int,
        prediction: bool = True,
        interaction_only: bool = True,
        n_shards: int,
        source_hash: str = "",
    ) -> "WindowStore":
        """Build a store shard by shard from the raw return series
        (``r_factors`` the market ``(T,)`` or the factors ``(F, T)``).

        Each shard is computed from the time slice its windows cover. The
        ground-truth ``alphas``/``betas`` (synthetic data) are the labels;
        without them the per-window OLS fit is, as in ``prepare_data``.
        More shards than windows are cut to one shard a window.
        """
        store_dir = Path(store_dir)
        store_dir.mkdir(parents=True, exist_ok=True)
        total_window = (lookback_window + target_window if prediction
                        else lookback_window)
        n_windows = (r_stocks.shape[1] - total_window) // stride + 1
        if n_windows < n_shards:
            n_shards = max(1, n_windows)

        shard_entries = []
        fields_meta: dict[str, dict] = {}
        for shard in range(n_shards):
            lo, hi = shard_bounds(n_windows, n_shards, shard)
            t0, t1 = lo * stride, (hi - 1) * stride + total_window
            factors = (r_factors[t0:t1] if r_factors.ndim == 1
                       else r_factors[:, t0:t1])
            x, y = lookback_target_split(
                torch.from_numpy(np.ascontiguousarray(r_stocks[:, t0:t1])),
                torch.from_numpy(np.ascontiguousarray(factors)),
                lookback_window=lookback_window,
                target_window=target_window,
                stride=stride,
                prediction=prediction,
            )
            x = add_quadratic_features(x, interaction_only=interaction_only)
            t_alphas, t_betas, t_factor, t_inv_psi = ols_features(y)
            arrays = {
                "x": x.numpy(),
                "y": append_label_channels(y.numpy(), t_alphas.numpy(),
                                           t_betas.numpy(), alphas, betas),
                "factor": t_factor.numpy(),
                "inv_psi": t_inv_psi.numpy(),
            }
            files = {}
            for field, arr in arrays.items():
                path = store_dir / _shard_filename(shard, field)
                publish(path, lambda f, a=arr: np.save(f, a))
                files[field] = {"sha256": _sha256_file(path),
                                "bytes": path.stat().st_size}
                fields_meta.setdefault(field, {"shape": list(arr.shape[1:]),
                                               "dtype": str(arr.dtype)})
            shard_entries.append({"shard": shard, "lo": lo, "hi": hi,
                                  "files": files})

        manifest = {
            "version": STORE_VERSION,
            "n_windows": n_windows,
            "n_shards": n_shards,
            "source_hash": source_hash,
            "fields": fields_meta,
            "shards": shard_entries,
        }
        # Last: the manifest marks the store complete.
        atomic_write_text(store_dir / MANIFEST_NAME,
                          json.dumps(manifest, indent=2))
        return cls(store_dir, manifest)


def append_label_channels(y: np.ndarray, t_alphas, t_betas,
                          alphas: np.ndarray | None,
                          betas: np.ndarray | None) -> np.ndarray:
    """Append ``[alpha, beta_1..beta_F]`` label channels to the target
    window: the ground-truth coefficients when the DGP recorded them, else
    the target-window OLS fit. ``betas`` is ``(n_stocks,)`` (one factor) or
    ``(n_stocks, F)``."""
    n_windows = y.shape[0]
    if alphas is None or betas is None:
        alpha_label, beta_label = np.asarray(t_alphas), np.asarray(t_betas)
    else:
        alpha_label = np.broadcast_to(alphas[None, :], (n_windows, len(alphas)))
        beta_label = np.broadcast_to(betas[None], (n_windows,) + betas.shape)
    if beta_label.ndim == 2:
        beta_label = beta_label[..., None]  # one loading -> one channel
    return np.concatenate(
        [y,
         np.broadcast_to(alpha_label[:, :, None, None], y.shape[:3] + (1,)),
         np.broadcast_to(beta_label[:, :, None, :],
                         y.shape[:3] + (beta_label.shape[-1],))],
        axis=-1,
    )
