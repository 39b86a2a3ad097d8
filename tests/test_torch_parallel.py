"""Data-parallel training of the port (``parallel/``) against the JAX
package's mesh.

The port runs one gloo process a rank; the JAX side runs in this process on
the forced 8-device CPU platform (``tests/conftest.py``). Every case gives
both sides the same seeded windows and the same initial weights (JAX init
-> ``params_from_jax``), dropout 0, and one full-batch step an epoch where
the two sides' shuffles differ (``torch.randperm`` against
``jax.random.permutation``), so only the order of the f32 sums parts them:
1e-5 relative, as ``tests/test_torch_train.py`` holds the solo trainer.

Every launch rendezvouses through a ``file://`` store in the test's own
``tmp_path`` (no port), gives the process group a timeout, and is cut by
the launcher at ``RANK_TIMEOUT_S`` (``tests/torch_parallel_ranks.py``), so
that a stuck collective fails one test. The launcher's own faults, the
data rendezvous, resume and the sweeps are in
``tests/test_torch_parallel_launch.py``.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from masters_thesis_tpu.data.pipeline import (
    FinancialWindowDataModule as JaxDataModule,
)
from masters_thesis_tpu.data.pipeline import bootstrap_synthetic as jax_bootstrap
from masters_thesis_tpu.models.objectives import ModelSpec as JaxSpec
from masters_thesis_tpu.parallel.mesh import (
    balanced_shard_sizes as jax_balanced_shard_sizes,
)
from masters_thesis_tpu.parallel.mesh import shard_bounds as jax_shard_bounds
from masters_thesis_tpu.telemetry import TelemetryRun as JaxTelemetryRun
from masters_thesis_tpu.telemetry.events import read_events as jax_read_events
from masters_thesis_tpu.train.stacked import ReplicaSpec as JaxReplicaSpec
from masters_thesis_tpu.train.stacked import StackedTrainer as JaxStackedTrainer
from masters_thesis_tpu.train.trainer import Trainer as JaxTrainer
from masters_thesis_tpu_torch.cli import train as cli_train
from masters_thesis_tpu_torch.data.pipeline import (
    FinancialWindowDataModule,
    bootstrap_synthetic,
)
from masters_thesis_tpu_torch.models.convert import params_from_jax
from masters_thesis_tpu_torch.models.objectives import ModelSpec
from masters_thesis_tpu_torch.parallel import mesh as mesh_lib
from masters_thesis_tpu_torch.telemetry.events import read_events
from masters_thesis_tpu_torch.telemetry.run import TelemetryRun
from masters_thesis_tpu_torch.train.trainer import Trainer
from torch_parallel_ranks import REPO, TOY, WINDOWS
from torch_parallel_ranks import launch_ranks as _launch

CLIP = 5.0
H = 8
F = 3
N_IN = 2 * F + 1
#: 85 windows (train 59, val 17, test 9): no split a multiple of 2 or 4.
ODD_SAMPLES = 1275
#: 10 windows (train 7, val 2, test 1): at 4 ranks two evaluate nothing.
TINY_SAMPLES = 150
KF_WINDOWS = dict(lookback_window=10, target_window=10, stride=20)

def _close(got: float, want: float, key: str) -> None:
    assert got == pytest.approx(want, rel=1e-5, abs=0), key


def _same_history(got: list, want: list, extra=()) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w) | set(extra)
        for key in w:
            _close(g[key], w[key], key)


def _jax_init(jspec: JaxSpec, lookback: int, n_in: int = 3, seed: int = 1):
    params = jspec.build_module().init(
        jax.random.key(seed), jnp.zeros((1, lookback, n_in)))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture
def world_of_one():
    """Leaves no process group behind a test that makes one in-process."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


# ------------------------------------------------------------- the fits


@pytest.mark.parametrize("world,objective,n_samples", [
    (2, "mse", ODD_SAMPLES), (2, "combined", ODD_SAMPLES),
    (4, "mse", TINY_SAMPLES)])
def test_window_fit_and_test_match_the_jax_mesh(tmp_path, world, objective,
                                                n_samples):
    """``world`` gloo ranks of ``Trainer.fit`` (3 epochs) and
    ``Trainer.test`` against the JAX ``Trainer(strategy="tpu_xla",
    n_devices=world)``: history, best val and the four test metrics at
    1e-5 relative. Each rank's batch is its whole shard (the train split
    truncated to a multiple of the world), so each epoch is one step; the
    splits are no multiple of the world, and at 4 ranks the val split (2
    windows) leaves two ranks with nothing to evaluate. Every rank reads
    the same history; the gradient went through exactly one all-reduce a
    step; rank 1 writes no checkpoint file."""
    jax_bootstrap(tmp_path / "jax", n_stocks=4, n_samples=n_samples, seed=0)
    bootstrap_synthetic(tmp_path / "port", n_stocks=4, n_samples=n_samples,
                        seed=0)
    dm = FinancialWindowDataModule(tmp_path / "port", engine="python",
                                   **WINDOWS)
    dm.prepare_data()
    dm.setup("fit")
    n_train = len(dm.train_range)
    assert n_train % world and len(dm.val_range) % world
    n_local = n_train // world
    hparams = dict(objective=objective, hidden_size=H, num_layers=2,
                   dropout=0.0, learning_rate=1e-3)
    jspec = JaxSpec(**hparams)
    init = _jax_init(jspec, WINDOWS["lookback_window"])
    jdm = JaxDataModule(tmp_path / "jax", batch_size=n_local, engine="python",
                        **WINDOWS)
    jtrainer = JaxTrainer(max_epochs=3, gradient_clip_val=CLIP,
                          strategy="tpu_xla", n_devices=world,
                          enable_progress_bar=False,
                          enable_model_summary=False)
    want = jtrainer.fit(jspec, jdm, init_state=(init, None))
    want_test = jtrainer.test(jspec, want.params, jdm)
    torch.save(params_from_jax(init), tmp_path / "init.pt")
    torch.save(params_from_jax(jax.tree_util.tree_map(np.asarray, want.params)),
               tmp_path / "final.pt")

    code, ranks = _launch(tmp_path, world, dict(
        kind="fit", data=str(tmp_path / "port"), windows=WINDOWS,
        batch_size=n_local, hparams=hparams, init=str(tmp_path / "init.pt"),
        test=str(tmp_path / "final.pt"), epochs=3, clip=CLIP,
        ckpt_dir=str(tmp_path / "ck"), no_writes=True))
    assert code == 0
    got = ranks[0]
    _same_history(got["history"], want.history)
    _close(got["best"], want.best_val_loss, "best_val_loss")
    assert set(got["test"]) == set(want_test) == {"mse", "nll", "mae", "total"}
    for key, value in want_test.items():
        _close(got["test"][key], value, key)
    for other in ranks[1:]:
        assert other["history"] == got["history"]
        for name, value in got["state"].items():
            assert torch.equal(other["state"][name], value), name
    assert got["steps"] == 3
    assert got["collectives"]["all_reduce_grad"] == got["steps"]
    assert {"best", "best.json", "last", "last.json"} <= {
        p.name for p in (tmp_path / "ck").iterdir()}


@pytest.mark.parametrize("objective", ["mse", "nll"])
def test_asset_fit_matches_the_jax_mesh(tmp_path, objective):
    """2 ranks with ``shard_axis="asset"`` on K-factor data (8 assets, F=3,
    one layer: each rank trains every window over 4 of the assets) against
    the JAX ``tpu_xla`` trainer with ``shard_axis="asset"``, ``n_devices=2``,
    full-batch, 3 epochs: history and best val at 1e-5 relative. (Not the
    JAX asset/window agreement test, which ROADMAP queue 3 keeps as a
    failing reference test.)"""
    jax_bootstrap(tmp_path / "jax", n_stocks=8, n_samples=1200, seed=0,
                  n_factors=F)
    bootstrap_synthetic(tmp_path / "port", n_stocks=8, n_samples=1200, seed=0,
                        n_factors=F)
    dm = FinancialWindowDataModule(tmp_path / "port", engine="python",
                                   **KF_WINDOWS)
    dm.prepare_data()
    dm.setup("fit")
    n_train = len(dm.train_range)
    hparams = dict(objective=objective, hidden_size=H, num_layers=1,
                   dropout=0.0, learning_rate=1e-3, input_size=N_IN,
                   n_factors=F)
    jspec = JaxSpec(**hparams)
    init = _jax_init(jspec, KF_WINDOWS["lookback_window"], N_IN)
    jdm = JaxDataModule(tmp_path / "jax", batch_size=n_train, engine="python",
                        **KF_WINDOWS)
    want = JaxTrainer(max_epochs=3, gradient_clip_val=CLIP,
                      strategy="tpu_xla", n_devices=2, shard_axis="asset",
                      enable_progress_bar=False, enable_model_summary=False
                      ).fit(jspec, jdm, init_state=(init, None))
    torch.save(params_from_jax(init), tmp_path / "init.pt")
    code, ranks = _launch(tmp_path, 2, dict(
        kind="fit", data=str(tmp_path / "port"), windows=KF_WINDOWS,
        batch_size=n_train, hparams=hparams, init=str(tmp_path / "init.pt"),
        epochs=3, clip=CLIP, shard_axis="asset"))
    assert code == 0
    _same_history(ranks[0]["history"], want.history)
    _close(ranks[0]["best"], want.best_val_loss, "best_val_loss")
    assert ranks[1]["history"] == ranks[0]["history"]


def test_stream_epoch_matches_the_jax_mesh(tmp_path):
    """2 ranks of the stream epoch (batch 3 a rank, so a global batch of 6
    and a padded tail of 2 windows over 56) against the JAX stream trainer
    at ``n_devices=2``: the same ``(seed, epoch)`` host shuffle, each rank
    training its half of every global batch, 2 epochs at 1e-5 relative."""
    jax_bootstrap(tmp_path / "jax", n_stocks=4, n_samples=1200, seed=0)
    bootstrap_synthetic(tmp_path / "port", n_stocks=4, n_samples=1200, seed=0)
    hparams = dict(objective="combined", hidden_size=H, num_layers=2,
                   dropout=0.0, learning_rate=1e-3)
    jspec = JaxSpec(**hparams)
    init = _jax_init(jspec, WINDOWS["lookback_window"])
    jdm = JaxDataModule(tmp_path / "jax", batch_size=3, engine="python",
                        **WINDOWS)
    want = JaxTrainer(max_epochs=2, gradient_clip_val=CLIP,
                      strategy="tpu_xla", n_devices=2, epoch_mode="stream",
                      enable_progress_bar=False, enable_model_summary=False,
                      seed=4).fit(jspec, jdm, init_state=(init, None))
    torch.save(params_from_jax(init), tmp_path / "init.pt")
    code, ranks = _launch(tmp_path, 2, dict(
        kind="fit", data=str(tmp_path / "port"), windows=WINDOWS,
        batch_size=3, hparams=hparams, init=str(tmp_path / "init.pt"),
        epochs=2, clip=CLIP, epoch_mode="stream", seed=4))
    assert code == 0
    _same_history(ranks[0]["history"], want.history,
                  extra=("data/get_wait_s", "data/prefetch_mean_depth"))
    assert ranks[0]["steps"] == 2 * 10  # ceil(56 / 6) steps an epoch
    final = jax.tree_util.tree_map(np.asarray, want.params)
    for name, value in params_from_jax(final).items():
        torch.testing.assert_close(ranks[0]["state"][name], value, rtol=0,
                                   atol=1e-5)


def test_asset_sharding_refuses_the_stream_epoch():
    with pytest.raises(ValueError, match="requires epoch_mode='scan'"):
        Trainer(max_epochs=1, device="cpu", shard_axis="asset",
                epoch_mode="stream")


def test_stacked_matches_the_jax_mesh(tmp_path):
    """R=2 replicas (their own seeds and rates) on 2 ranks against the JAX
    ``StackedTrainer(strategy="tpu_xla", n_devices=2)``, each replica from
    the JAX init of its seed, full-batch a rank, 3 epochs: each replica's
    history and best val at 1e-5 relative."""
    jax_bootstrap(tmp_path / "jax", n_stocks=4, n_samples=1200, seed=0)
    bootstrap_synthetic(tmp_path / "port", n_stocks=4, n_samples=1200, seed=0)
    dm = FinancialWindowDataModule(tmp_path / "port", engine="python",
                                   **WINDOWS)
    dm.prepare_data()
    dm.setup("fit")
    n_local = len(dm.train_range) // 2
    hparams = dict(objective="mse", hidden_size=H, num_layers=2, dropout=0.0)
    jspec = JaxSpec(**hparams)
    replicas = [("s0", 0, 1e-3), ("s1", 1, 3e-3)]
    jdm = JaxDataModule(tmp_path / "jax", batch_size=n_local, engine="python",
                        **WINDOWS)
    want = JaxStackedTrainer(max_epochs=3, gradient_clip_val=CLIP,
                             strategy="tpu_xla", n_devices=2,
                             enable_progress_bar=False).fit(
        jspec, jdm, [JaxReplicaSpec(*r) for r in replicas])
    inits = []
    module = jspec.build_module()
    for _, seed, _ in replicas:
        init_rng, _ = jax.random.split(jax.random.key(seed))
        params = module.init(init_rng, jnp.zeros(
            (1, WINDOWS["lookback_window"], 3)))["params"]
        inits.append(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                            params)))
    torch.save(inits, tmp_path / "init.pt")
    code, ranks = _launch(tmp_path, 2, dict(
        kind="stacked", data=str(tmp_path / "port"), windows=WINDOWS,
        batch_size=n_local, hparams=hparams, init=str(tmp_path / "init.pt"),
        epochs=3, clip=CLIP, replicas=replicas))
    assert code == 0
    for got, exp in zip(ranks[0]["replicas"], want.replicas):
        assert got["status"] == exp.status == "active"
        _same_history(got["history"], exp.history)
        _close(got["best"], exp.best_val_loss, "best_val_loss")


def test_a_masked_replica_stays_frozen_when_another_rank_poisons_it(
        tmp_path):
    """Two ranks of one ``StackedFlatAdam`` step, replica 0 masked and
    rank 1's gradient row for it NaN: after the all-reduce every rank's row
    0 is NaN, yet its parameters, moments and count stay bit for bit as
    they were, while replica 1 moves alike on both ranks (ROADMAP queue 3
    item 5, across ranks)."""
    code, ranks = _launch(tmp_path, 2, dict(kind="masked"))
    assert code == 0
    for got in ranks:
        assert not got["row0_grad_finite"]
        for before, after in zip(got["before"], got["after"]):
            assert torch.equal(after[0], before[0])
        assert not torch.equal(got["after"][0][1], got["before"][0][1])
    for a, b in zip(ranks[0]["after"], ranks[1]["after"]):
        assert torch.equal(a, b)


# ---------------------------------------------- world size 1 is the solo run


def _toy_dm(data_dir: Path, batch_size: int = 4):
    return FinancialWindowDataModule(data_dir, batch_size=batch_size,
                                     **WINDOWS)


@pytest.fixture(scope="module")
def toy_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("toy")
    bootstrap_synthetic(root, n_stocks=4, n_samples=1200, seed=0)
    return root


@pytest.mark.parametrize("kwargs", [
    dict(strategy="tpu_xla", n_devices=1),
    dict(strategy="tpu_xla", n_devices=1, shard_axis="asset"),
    dict(strategy="tpu_xla", epoch_mode="stream"),
    dict(strategy="single_device")],
    ids=["window", "asset", "stream", "single_device"])
def test_world_of_one_is_the_solo_run_bit_for_bit(toy_data, world_of_one,
                                                  kwargs):
    """At world size 1 (a gloo group of one in this process, the step's
    all-reduce a copy and a division by 1) every strategy and shard axis
    gives the solo trainer's history and weights bit for bit, dropout on."""
    spec = ModelSpec(objective="mse", hidden_size=H, num_layers=2,
                     dropout=0.2, learning_rate=1e-3)
    mode = dict(epoch_mode=kwargs.get("epoch_mode", "scan"))
    want = Trainer(max_epochs=3, gradient_clip_val=CLIP, device="cpu",
                   **mode).fit(spec, _toy_dm(toy_data))
    trainer = Trainer(max_epochs=3, gradient_clip_val=CLIP, device="cpu",
                      **kwargs)
    assert trainer.mesh.world == 1
    assert trainer.mesh.distributed == (kwargs["strategy"] == "tpu_xla")
    mesh_lib.reset_collective_counts()
    got = trainer.fit(spec, _toy_dm(toy_data))

    def rows(history):  # the prefetcher's wait is a host time
        return [{k: v for k, v in r.items() if k != "data/get_wait_s"}
                for r in history]

    assert rows(got.history) == rows(want.history)
    for name, value in want.state.items():
        assert torch.equal(got.state[name], value), name
    steps = int(got.opt_state["count"])
    assert mesh_lib.COLLECTIVES["all_reduce_grad"] == (
        steps if trainer.mesh.distributed else 0)


def test_grad_sync_event_matches_the_jax_event(toy_data, world_of_one,
                                               tmp_path):
    """The ``grad_sync`` event of a data-parallel run: one collective a
    step over the flat gradient's bytes, the JAX trainer's numbers for the
    same spec; the gauges say the same. A single-device run writes none."""
    hparams = dict(objective="mse", hidden_size=H, num_layers=2, dropout=0.0,
                   learning_rate=1e-3)
    jax_bootstrap(tmp_path / "jax", n_stocks=4, n_samples=1200, seed=0)
    jdm = JaxDataModule(tmp_path / "jax", batch_size=4, engine="python",
                        **WINDOWS)
    jtel = JaxTelemetryRun(tmp_path / "jax_tel", run_id="jax")
    JaxTrainer(max_epochs=1, gradient_clip_val=CLIP, strategy="tpu_xla",
               n_devices=2, enable_progress_bar=False,
               enable_model_summary=False, telemetry=jtel,
               cost_profile=False).fit(JaxSpec(**hparams), jdm)
    jtel.close()
    want = next(e for e in jax_read_events(tmp_path / "jax_tel" / "events.jsonl")
                if e["kind"] == "grad_sync")
    tel = TelemetryRun(tmp_path / "tel", run_id="port")
    Trainer(max_epochs=1, gradient_clip_val=CLIP, device="cpu",
            strategy="tpu_xla", telemetry=tel, cost_profile=False).fit(
        ModelSpec(**hparams), _toy_dm(toy_data))
    tel.close()
    events = read_events(tmp_path / "tel" / "events.jsonl")
    got = next(e for e in events if e["kind"] == "grad_sync")
    assert got["collectives_per_step"] == want["collectives_per_step"] == 1
    assert got["grad_reduce_bytes"] == want["grad_reduce_bytes"]
    started = next(e for e in events if e["kind"] == "run_started")
    assert started["strategy"] == "tpu_xla" and started["n_devices"] == 1
    assert started["distributed"]["process_count"] == 1
    gauges = next(e for e in reversed(events) if e["kind"] == "metrics")
    assert gauges["metrics"]["train/collectives_per_step"]["value"] == 1
    assert (gauges["metrics"]["train/grad_reduce_bytes"]["value"]
            == want["grad_reduce_bytes"])


# ------------------------------------------------------------ pure functions


def test_shard_bounds_and_sizes_match_jax():
    for n in range(0, 23):
        for world in range(1, 7):
            assert (mesh_lib.balanced_shard_sizes(n, world)
                    == jax_balanced_shard_sizes(n, world))
            for rank in range(world):
                assert (mesh_lib.shard_bounds(n, world, rank)
                        == jax_shard_bounds(n, world, rank))
    for bad in ((5, 0, 0), (5, 2, 2), (5, 2, -1)):
        with pytest.raises(ValueError):
            mesh_lib.shard_bounds(*bad)


def _jax_train_driver():
    spec = importlib.util.spec_from_file_location("jax_train_driver",
                                                  REPO / "train.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_partition_jobs_matches_train_py():
    jax_partition = _jax_train_driver().partition_jobs
    for n in range(0, 9):
        jobs = list(enumerate([f"seed={i}"] for i in range(n)))
        for hosts in range(1, 5):
            for host in range(hosts):
                assert (cli_train.partition_jobs(jobs, host, hosts)
                        == jax_partition(jobs, host, hosts))
    with pytest.raises(ValueError, match="out of range"):
        cli_train.partition_jobs([], 2, 2)


# ------------------------------------------------------ refusals and errors


def test_more_devices_than_visible_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for strategy in ("tpu_xla", "auto"):
        with pytest.raises(ValueError, match=r"^trainer\.n_devices=2: .*only "
                                             "1 visible"):
            mesh_lib.resolve_world(strategy, 2, "cuda")
    assert mesh_lib.resolve_world("auto", None, "cuda") == ("single_device", 1)
    assert mesh_lib.resolve_world("tpu_xla", None, "cuda") == ("tpu_xla", 1)
    assert mesh_lib.resolve_world("auto", 4, "cpu") == ("tpu_xla", 4)
    with pytest.raises(ValueError, match="single_device runs on one"):
        mesh_lib.resolve_world("single_device", 2, "cpu")
    cfg = cli_train.compose_config(["trainer=tpu_xla", "trainer.n_devices=2"])
    with pytest.raises(ValueError, match=r"^trainer\.n_devices=2: "):
        cli_train.launches_ranks(cfg, None)


def test_auto_takes_every_card_only_at_the_entry_point(monkeypatch):
    """On a host with two cards, ``strategy=auto`` makes the entry point
    start two ranks, while a ``Trainer`` in a process of its own runs on
    one device; an explicit ``tpu_xla`` over both cards in that process
    raises rather than training alone."""
    for key in (mesh_lib.COORDINATOR_ENV, mesh_lib.INDEX_ENV,
                mesh_lib.COUNT_ENV):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cfg = cli_train.compose_config([])
    assert cfg.trainer.get("strategy", "auto") == "auto"
    assert cli_train.launches_ranks(cfg, None) == 2
    mesh = mesh_lib.data_mesh("auto", None, "cuda")
    assert (mesh.strategy, mesh.world, mesh.backend) == ("single_device", 1,
                                                          None)
    for n_devices in (None, 2):
        with pytest.raises(RuntimeError, match="not a rank of a launch"):
            mesh_lib.data_mesh("tpu_xla", n_devices, "cuda")
    assert not dist.is_initialized()


def test_a_rank_without_its_launch_never_trains_alone(monkeypatch, tmp_path):
    """``trainer.distributed=true`` without a coordinator, and a bad
    coordinator, raise; a world of two in a process that is no rank of a
    launch raises rather than training alone."""
    for key in (mesh_lib.COORDINATOR_ENV, mesh_lib.INDEX_ENV,
                mesh_lib.COUNT_ENV):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="no coordinator"):
        mesh_lib.distributed_initialize(required=True, device="cpu")
    with pytest.raises(RuntimeError, match="coordinator"):
        cli_train.main(["--device", "cpu", *TOY, "trainer.distributed=true",
                        f"datamodule.data_dir={tmp_path / 'data'}",
                        f"logger.save_dir={tmp_path / 'logs'}"])
    with pytest.raises(RuntimeError, match="not a rank of a launch"):
        Trainer(max_epochs=1, device="cpu", strategy="tpu_xla", n_devices=2)
    monkeypatch.setenv(mesh_lib.COORDINATOR_ENV, "bogus://nowhere")
    monkeypatch.setenv(mesh_lib.COUNT_ENV, "2")
    monkeypatch.setenv(mesh_lib.INDEX_ENV, "0")
    with pytest.raises(RuntimeError, match="bogus://nowhere"):
        mesh_lib.join_fleet(device="cpu")
    with pytest.raises(RuntimeError, match="bogus://nowhere"):
        Trainer(max_epochs=1, device="cpu")
    assert not dist.is_initialized()
