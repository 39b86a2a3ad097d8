"""The port's on-disk window store against the JAX package's: the same
layout and manifest, so each package opens the other's store with
``verify=True``; the refusals of a torn, truncated, altered or
version-skewed store; the store-backed data module bit for bit its
in-memory path; ``shard_bounds``; and the memmap side of the prefetcher.

The ``x`` and ``y`` shard files (windows, features, ground-truth labels) of
the two packages are byte-identical; ``factor`` and ``inv_psi`` (the OLS
fit's factor statistics and residual precisions) come from other
reductions and pseudo-inverses and are held at 1e-5 of their largest entry.
"""

import json

import numpy as np
import pytest
import torch

from masters_thesis_tpu.data.pipeline import (
    FinancialWindowDataModule as JaxDataModule,
)
from masters_thesis_tpu.data.pipeline import bootstrap_synthetic as jax_bootstrap
from masters_thesis_tpu.data.window_store import WindowStore as JaxStore
from masters_thesis_tpu.parallel.mesh import shard_bounds as jax_shard_bounds
from masters_thesis_tpu_torch.data.pipeline import (
    FinancialWindowDataModule,
    bootstrap_synthetic,
)
from masters_thesis_tpu_torch.data.prefetch import (
    PrefetchStats,
    prefetch_to_device,
)
from masters_thesis_tpu_torch.data.synthetic import (
    SyntheticKFactorReturns,
    SyntheticLogReturns,
)
from masters_thesis_tpu_torch.data.window_store import (
    FIELDS,
    MANIFEST_NAME,
    WindowStore,
    WindowStoreError,
    shard_bounds,
)
from masters_thesis_tpu_torch.models.objectives import ModelSpec
from masters_thesis_tpu_torch.train.logging import RunLogger, read_records
from masters_thesis_tpu_torch.train.trainer import Trainer

WINDOWS = dict(lookback_window=20, target_window=10, stride=30)


def _series(n_factors: int, n_samples: int = 600, seed: int = 0):
    """The synthetic DGP's series (the scalar market model at F=1)."""
    if n_factors == 1:
        return SyntheticLogReturns.generate(5, n_samples, seed)
    return SyntheticKFactorReturns.generate(5, n_samples, n_factors, seed)


def _build(cls, store_dir, series, n_shards):
    r_stocks, factors, alphas, betas = series
    return cls.build_from_series(store_dir, r_stocks, factors, alphas, betas,
                                 n_shards=n_shards, source_hash="cafe",
                                 **WINDOWS)


def test_shard_bounds_match_the_jax_rule():
    for n in range(0, 40):
        for world in range(1, 10):
            bounds = [shard_bounds(n, world, r) for r in range(world)]
            assert bounds == [jax_shard_bounds(n, world, r)
                              for r in range(world)]
            assert bounds[0][0] == 0 and bounds[-1][1] == n
    with pytest.raises(ValueError, match="positive"):
        shard_bounds(4, 0, 0)
    with pytest.raises(ValueError, match="outside"):
        shard_bounds(4, 2, 2)


# 600 samples, 30-day windows at stride 30: 20 windows. 32 shards are more
# than there are windows (cut to one a window).
@pytest.mark.parametrize("n_shards", [1, 3, 8, 32])
@pytest.mark.parametrize("n_factors", [1, 3])
def test_stores_of_both_packages_agree_and_open_each_other(tmp_path, n_factors,
                                                           n_shards):
    series = _series(n_factors)
    port = _build(WindowStore, tmp_path / "port", series, n_shards)
    ref = _build(JaxStore, tmp_path / "jax", series, n_shards)
    assert port.n_windows == ref.n_windows == 20
    assert port.n_shards == ref.n_shards == min(n_shards, 20)
    mp, mj = port.manifest, ref.manifest
    assert {k: v for k, v in mp.items() if k != "shards"} == {
        k: v for k, v in mj.items() if k != "shards"}
    for ep, ej in zip(mp["shards"], mj["shards"]):
        assert (ep["lo"], ep["hi"]) == (ej["lo"], ej["hi"])
        for field in ("x", "y"):
            assert ep["files"][field] == ej["files"][field], field
    for field in FIELDS:
        assert port.field_shape(field) == ref.field_shape(field)
    assert port.field_shape("y")[-1] == 2 * n_factors + 2
    got, want = port.take(np.arange(20)), ref.load_all()
    for field, g, w in zip(FIELDS, got, want):
        if field in ("x", "y"):
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=1e-5 * np.abs(w).max())
    # Each package opens the other's store and re-hashes every shard.
    opened = WindowStore.open(tmp_path / "jax", verify=True)
    assert opened.nbytes == ref.nbytes and opened.source_hash == "cafe"
    JaxStore.open(tmp_path / "port", verify=True)


@pytest.mark.parametrize("n_shards", [1, 3, 32])
@pytest.mark.parametrize("built_by", ["port", "jax"])
def test_load_all_is_the_jax_load_all_bit_for_bit(tmp_path, built_by,
                                                   n_shards):
    """Both packages' ``load_all`` over one store, whichever built it:
    every window of every field, bit for bit."""
    cls = WindowStore if built_by == "port" else JaxStore
    _build(cls, tmp_path / "s", _series(3), n_shards)
    got = WindowStore.open(tmp_path / "s").load_all()
    want = JaxStore.open(tmp_path / "s").load_all()
    assert len(got) == len(want) == len(FIELDS)
    for g, w in zip(got, want):
        assert g.shape[0] == 20 and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_take_serves_memmap_views_and_gathers(tmp_path):
    store = _build(WindowStore, tmp_path / "s", _series(3), 4)
    assert [store.bounds(s) for s in range(4)] == [(0, 5), (5, 10), (10, 15),
                                                   (15, 20)]
    run = store.take(np.arange(6, 9))
    assert all(isinstance(a, np.memmap) for a in run)
    scattered = store.take(np.array([19, 2, 7, 2]))
    assert not any(isinstance(a, np.memmap) for a in scattered)
    full = store.take(np.arange(20))
    for a, b in zip(scattered, full):
        np.testing.assert_array_equal(a, b[[19, 2, 7, 2]])
    for a, b in zip(run, full):
        np.testing.assert_array_equal(a, b[6:9])
    assert [a.shape[0] for a in store.take([])] == [0] * 4
    with pytest.raises(ValueError, match="1-D"):
        store.take(np.zeros((2, 2), np.int64))
    shards = list(store.iter_shards())
    assert [(lo, hi) for lo, hi, _ in shards] == [store.bounds(s)
                                                  for s in range(4)]


def _tear(store_dir, how):
    shard0 = store_dir / "shard00000.x.npy"
    manifest = store_dir / MANIFEST_NAME
    if how == "missing_manifest":
        manifest.unlink()
    elif how == "missing_shard":
        shard0.unlink()
    elif how == "truncated_shard":
        shard0.write_bytes(shard0.read_bytes()[:-8])
    elif how == "altered_shard":
        data = bytearray(shard0.read_bytes())
        data[-1] ^= 0xFF  # same size, other content
        shard0.write_bytes(bytes(data))
    elif how == "version_skew":
        m = json.loads(manifest.read_text())
        m["version"] = 2
        manifest.write_text(json.dumps(m))


TEARS = [("missing_manifest", "torn before completion"),
         ("missing_shard", "missing"),
         ("truncated_shard", "torn or truncated"),
         ("altered_shard", "altered or corrupted"),
         ("version_skew", "version")]


@pytest.mark.parametrize("how,match", TEARS, ids=[t for t, _ in TEARS])
def test_open_refuses_a_torn_or_altered_store(tmp_path, how, match):
    """The JAX package's refusals, message for message; an altered shard of
    the same size opens without ``verify`` and is refused with it."""
    store_dir = tmp_path / "s"
    _build(WindowStore, store_dir, _series(1), 3)
    _tear(store_dir, how)
    if how == "altered_shard":
        WindowStore.open(store_dir)
    with pytest.raises(WindowStoreError, match=match):
        WindowStore.open(store_dir, verify=True)
    with pytest.raises(Exception, match=match):
        JaxStore.open(store_dir, verify=True)


def _datamodules(tmp_path, n_factors, batch_size=3):
    data = tmp_path / "data"
    bootstrap_synthetic(data, n_stocks=6, n_samples=2000, seed=0,
                        n_factors=n_factors)
    kw = dict(batch_size=batch_size, engine="python", **WINDOWS)
    mem = FinancialWindowDataModule(data, **kw)
    store = FinancialWindowDataModule(data, store_shards=8, **kw)
    for dm in (mem, store):
        dm.prepare_data()
        dm.setup()
    return mem, store


@pytest.mark.parametrize("n_factors", [1, 3])
def test_store_backed_datamodule_is_its_in_memory_path_bitwise(tmp_path,
                                                               n_factors):
    """Every split, and the shuffled train batches, of the store-backed data
    module against the npz path; and the store against the JAX package's
    store-backed data module on the same source."""
    mem, store = _datamodules(tmp_path, n_factors)
    assert store.store.n_shards == 8 and store.n_stocks == mem.n_stocks == 6
    assert store.n_factors == n_factors and store.train_range == mem.train_range
    for split in ("train_arrays", "val_arrays", "test_arrays"):
        for a, b in zip(getattr(mem, split)(), getattr(store, split)()):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(mem.train_batches(epoch=2, seed=7),
                    store.train_batches(epoch=2, seed=7)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)

    jax_bootstrap(tmp_path / "jax", n_stocks=6, n_samples=2000, seed=0,
                  n_factors=n_factors)
    jdm = JaxDataModule(tmp_path / "jax", batch_size=3, engine="python",
                        store_shards=8, **WINDOWS)
    jdm.prepare_data(verbose=False)
    assert jdm._hparams_hash() == store._hparams_hash()
    # The JAX package's store is current for the port: built once.
    port_jax = FinancialWindowDataModule(tmp_path / "jax", store_shards=8,
                                         engine="python", **WINDOWS)
    stamp = (tmp_path / "jax" / "datasets" / "window_store"
             / MANIFEST_NAME).stat().st_mtime_ns
    port_jax.prepare_data()
    assert (tmp_path / "jax" / "datasets" / "window_store"
            / MANIFEST_NAME).stat().st_mtime_ns == stamp


def test_prefetch_pages_memmap_views_in_and_counts_them(tmp_path):
    """In-order store batches are memmap views: the prefetcher copies them
    into memory, counting their bytes and the wait; gathered batches count
    nothing. Prefetch depth changes no value."""
    _, store = _datamodules(tmp_path, 3, batch_size=2)
    stats = PrefetchStats()
    got = list(prefetch_to_device(store.train_batches(shuffle=False), 2,
                                  "cpu", stats))
    plain = list(prefetch_to_device(store.train_batches(shuffle=False), 0,
                                    "cpu"))
    views = [b for b in store.train_batches(shuffle=False)
             if isinstance(b.x, np.memmap)]
    assert views and stats.mmap_bytes == sum(
        sum(a.nbytes for a in b) for b in views)
    assert stats.fault_wait_s > 0 and stats.snapshot()["mmap_bytes"] > 0
    for a, b in zip(got, plain):
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, atol=0, rtol=0)
    gathered = PrefetchStats()
    list(prefetch_to_device([tuple(np.array(a) for a in views[0])], 1, "cpu",
                            gathered))
    assert gathered.mmap_bytes == 0 and gathered.fault_wait_s == 0


def test_stream_epoch_rows_carry_the_page_ins(tmp_path):
    """A stream epoch over the store logs ``data/mmap_bytes`` and
    ``data/fault_wait_s`` in its metrics row; the npz path does not."""
    mem, store = _datamodules(tmp_path, 1, batch_size=1)
    spec = ModelSpec(objective="mse", hidden_size=4, num_layers=1)
    rows = {}
    for name, dm in (("store", store), ("mem", mem)):
        logger = RunLogger(tmp_path / "logs", "run", name)
        Trainer(max_epochs=1, device="cpu", logger=logger,
                epoch_mode="stream").fit(spec, dm)
        logger.close()
        rows[name] = read_records(logger.log_dir)
    store_keys = {k for r in rows["store"] for k in r}
    mem_keys = {k for r in rows["mem"] for k in r}
    assert {"data/mmap_bytes", "data/fault_wait_s"} <= store_keys
    assert not {"data/mmap_bytes", "data/fault_wait_s"} & mem_keys
