"""The stream epoch: host batches in the ``(seed, epoch)`` shuffle, the
prefetcher, the padded tail and the weighted step, against the JAX
package's stream trainer and prefetcher, and bit for bit across prefetch
depths on the CPU.

Toy shape: 4 stocks x 1,200 samples of the synthetic DGP, lookback 10,
target 5, stride 15 (56 train windows), batch_size 3: 18 full batches and
a tail of 2, padded back to 3 with one zero-weight copy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masters_thesis_tpu.data.pipeline import (
    FinancialWindowDataModule as JaxDataModule,
    bootstrap_synthetic as jax_bootstrap,
)
from masters_thesis_tpu.data.prefetch import (
    PrefetchStats as JaxPrefetchStats,
    prefetch_to_device as jax_prefetch,
)
from masters_thesis_tpu.models.objectives import ModelSpec as JaxSpec
from masters_thesis_tpu.train.trainer import Trainer as JaxTrainer
from masters_thesis_tpu_torch.data.pipeline import (
    Batch,
    FinancialWindowDataModule,
    bootstrap_synthetic,
)
from masters_thesis_tpu_torch.data.prefetch import PrefetchStats, prefetch_to_device
from masters_thesis_tpu_torch.models.convert import params_from_jax
from masters_thesis_tpu_torch.models.objectives import ModelSpec
from masters_thesis_tpu_torch.train.optim import make_optimizer
from masters_thesis_tpu_torch.train.steps import StreamProgram, weighted_batches
from masters_thesis_tpu_torch.train.trainer import Trainer

WINDOWS = dict(lookback_window=10, target_window=5, stride=15)
N_TRAIN, BATCH = 56, 3
CLIP = 5.0


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("stream")
    bootstrap_synthetic(root / "port", n_stocks=4, n_samples=1200, seed=0)
    jax_bootstrap(root / "jax", n_stocks=4, n_samples=1200, seed=0)
    return root


def _datamodule(data, batch_size=BATCH):
    dm = FinancialWindowDataModule(data / "port", batch_size=batch_size,
                                   **WINDOWS)
    dm.prepare_data()
    dm.setup("fit")
    assert len(dm.train_range) == N_TRAIN
    return dm


def test_train_batches_are_the_jax_packages(data):
    """The same windows in the same order, epoch by epoch."""
    dm = _datamodule(data)
    jdm = JaxDataModule(data / "jax", batch_size=BATCH, engine="python",
                        **WINDOWS)
    jdm.prepare_data(verbose=False)
    jdm.setup("fit")
    for epoch in (0, 1):
        got = list(dm.train_batches(epoch, seed=5))
        want = list(jdm.train_batches(epoch, seed=5))
        assert len(got) == len(want) == -(-N_TRAIN // BATCH)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.x, np.asarray(w.x))
            np.testing.assert_array_equal(g.y, np.asarray(w.y))
    first = [b.x for b in dm.train_batches(0, seed=5)]
    again = [b.x for b in dm.train_batches(1, seed=5)]
    assert not all(np.array_equal(a, b) for a, b in zip(first, again))
    ordered = np.concatenate([b.x for b in dm.train_batches(shuffle=False)])
    np.testing.assert_array_equal(ordered, dm.train_arrays().x)


def test_tail_is_padded_with_zero_weight_copies(data):
    dm = _datamodule(data)
    batches = list(weighted_batches(dm.train_batches(0, seed=1), BATCH))
    assert len(batches) == -(-N_TRAIN // BATCH) == 19
    for batch, w in batches[:-1]:
        assert batch.x.shape[0] == BATCH and w.tolist() == [1.0, 1.0, 1.0]
    tail_batch, tail_w = batches[-1]
    raw_tail = list(dm.train_batches(0, seed=1))[-1]
    assert raw_tail.x.shape[0] == N_TRAIN % BATCH == 2
    assert tail_w.tolist() == [1.0, 1.0, 0.0] and tail_w.dtype == np.float32
    for got, raw in zip(tail_batch, raw_tail):
        np.testing.assert_array_equal(got, raw[[0, 1, 0]])


def test_stream_program_steps_and_sums(data):
    """ceil(n / B) steps an epoch, and the sums' weight counts the real
    windows only: the padded copy adds nothing."""
    dm = _datamodule(data)
    spec = ModelSpec(objective="mse", hidden_size=8, num_layers=2, dropout=0.0)
    module = spec.build_module(device="cpu",
                               generator=torch.Generator().manual_seed(0))
    optimizer = make_optimizer(module, CLIP, spec.weight_decay)
    program = StreamProgram(module, optimizer, spec.window_objective(),
                            dm.train_arrays(), BATCH)
    batches = weighted_batches(dm.train_batches(0, seed=0), BATCH)
    sums, n_steps = program.epoch(1e-3, prefetch_to_device(batches,
                                                           device="cpu"))
    assert n_steps == 19
    assert float(sums["total"][1]) == N_TRAIN
    assert float(sums["mse"][1]) == N_TRAIN * 4 * WINDOWS["target_window"]
    assert int(optimizer.state_dict()["count"]) == 19


@pytest.mark.parametrize("dropout", [0.0, 0.3])
def test_prefetch_depths_are_bit_equal(data, dropout):
    spec = ModelSpec(objective="mse", hidden_size=8, num_layers=2,
                     dropout=dropout, learning_rate=1e-3)
    runs = []
    for depth in (0, 1, 2):
        trainer = Trainer(max_epochs=2, gradient_clip_val=CLIP, device="cpu",
                          epoch_mode="stream", prefetch=depth, seed=3)
        runs.append(trainer.fit(spec, _datamodule(data)))
    for run in runs[1:]:
        for key in ("loss/total/train", "loss/total/val"):
            assert [r[key] for r in run.history] == \
                [r[key] for r in runs[0].history]
        for name, value in runs[0].state.items():
            assert torch.equal(run.state[name], value), name
        assert torch.equal(run.opt_state["mu"], runs[0].opt_state["mu"])
    depths = [[r["data/prefetch_mean_depth"] for r in run.history]
              for run in runs]
    assert depths[0] == [1.0, 1.0]
    assert all(0 < d <= 2 for d in depths[2])
    assert all(r["data/get_wait_s"] > 0 for run in runs for r in run.history)


@pytest.mark.parametrize("size", [0, 1, 2, 7])
def test_prefetch_stats_match_the_jax_prefetcher(size):
    rng = np.random.default_rng(size)
    items = [Batch(*(rng.standard_normal((2, 3)).astype(np.float32)
                     for _ in range(4))) for _ in range(5)]
    stats, jax_stats = PrefetchStats(), JaxPrefetchStats()
    got = list(prefetch_to_device(iter(items), size, device="cpu", stats=stats))
    want = list(jax_prefetch(iter(items), size, stats=jax_stats))
    assert len(got) == len(want) == 5
    for g, w, item in zip(got, want, items):
        assert isinstance(g, Batch)
        for a, b, c in zip(g, w, item):
            assert torch.is_tensor(a)
            np.testing.assert_array_equal(a.numpy(), c)
            np.testing.assert_array_equal(np.asarray(b), c)
    snap, jax_snap = stats.snapshot(), jax_stats.snapshot()
    for key in ("gets", "yields", "mean_depth", "min_depth", "exhausted"):
        assert snap[key] == jax_snap[key], key
    assert snap["gets"] == snap["yields"] == 5 and snap["exhausted"]
    assert snap["min_depth"] == 1
    with pytest.raises(ValueError, match="prefetch size"):
        next(prefetch_to_device(iter(items), -1, device="cpu"))


@pytest.mark.parametrize("objective", ["mse", "combined"])
def test_stream_fit_matches_the_jax_stream_trainer(data, objective):
    """Trainer(epoch_mode="stream").fit's epoch curve (2 epochs) against the
    JAX Trainer's stream epoch: the same windows in the same shuffle, the
    same padded tail, the same initial weights (JAX init ->
    params_from_jax), dropout 0, one device; 1e-5 relative."""
    dm = _datamodule(data)
    jdm = JaxDataModule(data / "jax", batch_size=BATCH, engine="python",
                        **WINDOWS)
    hparams = dict(objective=objective, hidden_size=8, num_layers=2,
                   dropout=0.0, learning_rate=1e-3)
    jspec, spec = JaxSpec(**hparams), ModelSpec(**hparams)
    params = jspec.build_module().init(
        jax.random.key(1), jnp.zeros((1, WINDOWS["lookback_window"], 3)))["params"]
    init = jax.tree_util.tree_map(np.asarray, params)
    jtrainer = JaxTrainer(max_epochs=2, gradient_clip_val=CLIP,
                          strategy="single_device", epoch_mode="stream",
                          enable_progress_bar=False,
                          enable_model_summary=False, seed=4)
    want = jtrainer.fit(jspec, jdm, init_state=(init, None))
    trainer = Trainer(max_epochs=2, gradient_clip_val=CLIP, device="cpu",
                      epoch_mode="stream", seed=4)
    got = trainer.fit(spec, dm, init_state=(params_from_jax(init), None))

    assert len(got.history) == len(want.history) == 2
    for g, w in zip(got.history, want.history):
        assert set(g) == set(w) | {"data/get_wait_s", "data/prefetch_mean_depth"}
        for key in w:
            assert g[key] == pytest.approx(w[key], rel=1e-5, abs=0), key
    assert got.best_val_loss == pytest.approx(want.best_val_loss, rel=1e-5)
    assert int(got.opt_state["count"]) == 2 * 19
    final = jax.tree_util.tree_map(np.asarray, want.params)
    for name, value in params_from_jax(final).items():
        torch.testing.assert_close(got.state[name], value, rtol=0, atol=1e-5)
