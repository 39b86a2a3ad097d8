"""Stacked training: the port's replica axis, stacked FlatAdam, stacked epoch
program and ``StackedTrainer`` against the JAX package's stacked path, and
against the port's own solo path.

Against JAX (R = 3, ``SEEDS`` and ``LRS`` of the JAX package's stacked
tests, weights through ``params_from_jax``): the stacked FlatAdam within
1e-6 abs of the vmapped ``update_flat`` (the solo test's tolerance); two
stacked epochs within 1e-5 relative on each replica's loss sums
(``test_torch_train.py``'s: the recurrence's f32 sums in another order),
with dropout 0 and one full-batch step an epoch so that the two sides'
shuffles do not enter. Parameters: 1e-6 abs plus 1e-4 relative, widened
from ``test_torch_train.py``'s 1e-6 abs by the JAX stacked contract's
relative term (``tests/test_stacked.py``). The cause: at these rates (up to
2e-2, twenty times that test's 1e-3) an Adam entry whose decayed gradient
cancels to the scale of eps (1e-8) turns an f32 reordering of its sum into
a step apart by up to ~lr * 2e-4 (3.9e-6 on one of replica 0's 1,010
entries at lr 1e-2, w_hh_l1, whose gradient -4.7e-7 and decay term 5.0e-7
nearly cancel).

Against the port's solo path, bit for bit: each replica of a stacked run is
the solo run of its seed and rate (dropout 0.2, its own masks and
shuffles); siblings are isolated; a diverging replica is rolled back,
slowed, masked and frozen while its siblings train on untouched. Every
grouping stacks: one layer, the pair, the L-deep stack and their mixes,
``[2, 1]``, model=large's ``[7, 1]`` and layers on the time-blocked route
(a one-year lookback), whose replica axis is held against the JAX
package's ``vmap`` over its interpret-mode time-blocked kernel (1e-5 abs on
h, 2e-5 of the largest entry on the gradients, ``test_torch_tblocked.py``'s
tolerances).
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import masters_thesis_tpu.ops.lstm_kernel as jax_lk
from masters_thesis_tpu.analysis.traceaudit import _synthetic_split
from masters_thesis_tpu.models.objectives import ModelSpec as JaxSpec
from masters_thesis_tpu.parallel import global_put, make_data_mesh, replicated_sharding
from masters_thesis_tpu.train.flatparams import FlatAdam as JaxFlatAdam
from masters_thesis_tpu.train.flatparams import flatten as jax_flatten
from masters_thesis_tpu.train.flatparams import flatten_spec
from masters_thesis_tpu.train.flatparams import stack_flat as jax_stack_flat
from masters_thesis_tpu.train.flatparams import stack_opt_states as jax_stack_opt
from masters_thesis_tpu.train.flatparams import unflatten
from masters_thesis_tpu.train.steps import make_stacked_train_epoch
from masters_thesis_tpu_torch.data.pipeline import (
    Batch,
    FinancialWindowDataModule,
    bootstrap_synthetic,
)
from masters_thesis_tpu_torch.models.convert import (
    params_from_jax,
    replica_state,
    stacked_params_from_jax,
)
from masters_thesis_tpu_torch.models.lstm import LstmEncoder, StackedLstmEncoder
from masters_thesis_tpu_torch.models.objectives import ModelSpec
from masters_thesis_tpu_torch.ops import lstm_kernel as lk
from masters_thesis_tpu_torch.resilience import faults
from masters_thesis_tpu_torch.train.checkpoint import restore_checkpoint
from masters_thesis_tpu_torch.train.flatparams import (
    FlatAdam,
    StackedFlatAdam,
    flatten,
    replica_flat,
    replica_opt_state,
    set_lane,
    stack_flat,
    stack_opt_states,
    stacked_size_bytes,
)
from masters_thesis_tpu_torch.train.stacked import ReplicaSpec, StackedTrainer
from masters_thesis_tpu_torch.train.steps import (
    StackedTrainProgram,
    stacked_metric_means,
)
from masters_thesis_tpu_torch.train.trainer import Trainer, device_split

LRS = (1e-2, 5e-3, 2e-2)
SEEDS = (0, 1, 2)
H = 8
CLIP = 5.0
WINDOWS = dict(lookback_window=10, target_window=5, stride=15)
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for these tests of many small products: beside
    the suite's other workers, more threads only wait on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Vector(nn.Module):
    def __init__(self, values):
        super().__init__()
        self.w = nn.Parameter(torch.from_numpy(values[:-7].copy()))
        self.b = nn.Parameter(torch.from_numpy(values[-7:].copy()))


def _grads(rng, n, steps=5):
    out = [rng.normal(0, 0.1, size=(len(SEEDS), n)).astype(np.float32)
           for _ in range(steps)]
    if steps > 2:
        out[2][1] *= 100.0  # replica 1's third gradient is clipped
    return out


@pytest.mark.parametrize("weight_decay", [0.0, 1e-5])
def test_stacked_flat_adam_rows_equal_solo_flat_adam_bitwise(weight_decay):
    """Row r of the stacked update against the solo FlatAdam on row r's
    inputs, over five steps at three rates, one of them clipped."""
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(len(SEEDS), 257)).astype(np.float32)
    stacked = StackedFlatAdam([_Vector(p) for p in p0], CLIP, weight_decay)
    solo_modules = [_Vector(p) for p in p0]
    solos = [FlatAdam(m, CLIP, weight_decay) for m in solo_modules]
    for g in _grads(rng, 257):
        stacked.zero_grad()
        stacked.grads.copy_(torch.from_numpy(g))
        stacked.set_lr(LRS)
        stacked.step()
        for r, opt in enumerate(solos):
            opt.zero_grad()
            opt.grads.copy_(torch.from_numpy(g[r]))
            opt.step(LRS[r])
            for live, want in ((stacked.params, opt.params),
                               (stacked.mu, opt.mu), (stacked.nu, opt.nu)):
                assert torch.equal(live[r], want)
    assert stacked.count_t.tolist() == [5, 5, 5]
    assert stacked.replica_state_dict(1)["count"] == solos[1].count


def test_stacked_flat_adam_matches_jax_vmapped_update_flat():
    rng = np.random.default_rng(1)
    p0 = rng.normal(size=(len(SEEDS), 257)).astype(np.float32)
    tx = JaxFlatAdam(CLIP, 1e-5)
    params = {"w": jnp.asarray(p0[0])}
    spec = flatten_spec(params)
    state = jax_stack_opt([tx.init({"w": jnp.asarray(p)}) for p in p0])
    pbufs = {"float32": jnp.asarray(p0)}

    def one(g, s, p, lr):
        upd, s = tx.update_flat({"float32": g}, s, {"float32": p}, spec)
        return p - lr * upd["float32"], s

    update = jax.vmap(one)
    stacked = StackedFlatAdam([_Vector(p) for p in p0], CLIP, 1e-5)
    lrs = jnp.asarray(LRS, jnp.float32)
    for g in _grads(rng, 257):
        new_p, state = update(jnp.asarray(g), state, pbufs["float32"], lrs)
        pbufs = {"float32": new_p}
        stacked.zero_grad()
        stacked.grads.copy_(torch.from_numpy(g))
        stacked.set_lr(LRS)
        stacked.step()
        np.testing.assert_allclose(stacked.params.numpy(), np.asarray(new_p),
                                   atol=1e-6, rtol=0)
    np.testing.assert_array_equal(stacked.count_t.numpy(), np.asarray(state.count))


def test_a_masked_row_stays_put_whatever_its_gradient_holds():
    """A poisoned replica (NaN gradient on the device) that is masked keeps
    its parameters, moments and count bit for bit; its siblings step as
    if it were not there."""
    rng = np.random.default_rng(2)
    p0 = rng.normal(size=(len(SEEDS), 40)).astype(np.float32)
    stacked = StackedFlatAdam([_Vector(p) for p in p0], CLIP)
    clean = StackedFlatAdam([_Vector(p) for p in p0], CLIP)
    for g in _grads(rng, 40, steps=2):
        for opt in (stacked, clean):
            opt.zero_grad()
            opt.grads.copy_(torch.from_numpy(g))
            opt.set_lr(LRS)
            opt.step()
    before = stacked.snapshot()
    stacked.set_active([True, False, True])
    clean.set_active([True, False, True])
    for g in _grads(rng, 40, steps=3):
        poisoned = g.copy()
        poisoned[1] = np.nan
        stacked.zero_grad()
        stacked.grads.copy_(torch.from_numpy(poisoned))
        clean.zero_grad()
        clean.grads.copy_(torch.from_numpy(g))
        for opt in (stacked, clean):
            opt.set_lr(LRS)
            opt.step()
    for live, saved in zip((stacked.params, stacked.mu, stacked.nu,
                            stacked.count_t), before):
        assert torch.equal(live[1], saved[1])
    for r in (0, 2):
        assert torch.equal(stacked.params[r], clean.params[r])
    assert torch.isfinite(stacked.params).all()


def test_stack_helpers_round_trip():
    rng = np.random.default_rng(3)
    mods = [_Vector(rng.normal(size=20).astype(np.float32)) for _ in SEEDS]
    bufs = [flatten(m) for m in mods]
    stacked = stack_flat(bufs)
    assert stacked.shape == (3, 20)
    assert stacked_size_bytes(mods[0], 3) == 3 * 20 * 4
    assert torch.equal(replica_flat(stacked, 2), bufs[2])
    swapped = set_lane(stacked, 1, bufs[0])
    assert torch.equal(swapped[1], bufs[0])
    assert torch.equal(swapped[0], stacked[0]) and torch.equal(swapped[2], stacked[2])
    assert torch.equal(stacked[1], bufs[1])  # the input is not touched
    states = [{"count": i, "mu": b * 2, "nu": b * 3} for i, b in enumerate(bufs)]
    stacked_state = stack_opt_states(states)
    for r, state in enumerate(states):
        got = replica_opt_state(stacked_state, r)
        assert got["count"] == state["count"]
        assert torch.equal(got["mu"], state["mu"]) and torch.equal(got["nu"], state["nu"])


def _encoder(seed, dropout=0.2, num_layers=2):
    return LstmEncoder(3, H, num_layers, dropout, device="cpu",
                       generator=torch.Generator().manual_seed(seed))


def test_stacked_encoder_replica_is_the_solo_encoder_bitwise():
    """Initial weights from each replica's generator, and a training
    forward and backward (dropout 0.2, each replica's masks from its own
    generator) bit for bit the solo encoder's."""
    stacked = StackedLstmEncoder([_encoder(s) for s in SEEDS])
    solos = [_encoder(s) for s in SEEDS]
    x = torch.randn(3, 6, 7, 3, generator=torch.Generator().manual_seed(9))
    gens = [torch.Generator().manual_seed(40 + s) for s in SEEDS]
    alpha, beta = stacked(x, deterministic=False, generators=gens)
    (alpha.square().sum() + beta.sum()).backward()
    for r, seed in enumerate(SEEDS):
        a, b = solos[r](x[r], deterministic=False,
                        generator=torch.Generator().manual_seed(40 + seed))
        (a.square().sum() + b.sum()).backward()
        assert torch.equal(a, alpha[r]) and torch.equal(b, beta[r])
        for (name, p), q in zip(stacked.replicas[r].named_parameters(),
                                solos[r].parameters()):
            assert torch.equal(p.grad, q.grad), name
    state = stacked.state_dict()
    assert set(replica_state(state, 1)) == set(solos[1].state_dict())


@pytest.mark.parametrize("num_layers,n_t,rows,window_rows,groups", [
    (1, 8, 4, None, [1]),  # one layer: the single-layer kernels
    (3, 8, 4, None, [3]),  # a 3-deep stack
    (4, 60, 25, 25, [4]),  # model=medium at the Fama-French shape
    # model=small at a one-year lookback: two singles, time-blocked
    (2, 252, 100, 100, [1, 1]),
], ids=["1-8-4-None", "3-8-4-None", "4-60-25-25", "2-252-100-100"])
def test_groupings_other_than_one_pair_are_refused(num_layers, n_t, rows,
                                                   window_rows, groups):
    """No grouping is refused any more: each stacks, its groups the solo
    encoder's, and the stacked forward's replica r is the solo encoder's
    bit for bit (at a one-year lookback through the time-blocked replica
    axis)."""
    hidden = 64 if n_t > 8 else H
    solos = [LstmEncoder(3, hidden, num_layers, 0.0, device="cpu",
                         generator=torch.Generator().manual_seed(s))
             for s in (0, 1)]
    stacked = StackedLstmEncoder(solos)
    assert stacked.layer_groups(n_t, rows, False, window_rows) == groups
    assert solos[0].layer_groups(n_t, rows, False, window_rows) == groups
    x = torch.randn(rows, n_t, 3, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        alpha, beta = stacked(x, window_rows=window_rows)
        for r, solo in enumerate(solos):
            a, b = solo(x, window_rows=window_rows)
            assert torch.equal(a, alpha[r]) and torch.equal(b, beta[r])


@pytest.mark.parametrize("num_layers", [1, 4])
def test_stacked_params_carry_any_depth_and_three_factors(num_layers):
    """R JAX trees of one layer or of four, with three factors (the
    kfactor heads), load into a stacked encoder; each replica's state
    comes back out as its own tree's."""
    jspec = JaxSpec(objective="combined", hidden_size=H, num_layers=num_layers,
                    n_factors=3, input_size=7, kernel_impl="xla")
    module = jspec.build_module()
    trees = [jax.tree_util.tree_map(np.asarray, module.init(
        jax.random.key(s), jnp.zeros((1, 8, 7)))["params"]) for s in SEEDS]
    spec = ModelSpec(objective="combined", hidden_size=H,
                     num_layers=num_layers, n_factors=3, input_size=7)
    stacked = StackedLstmEncoder([spec.build_module(device="cpu")
                                  for _ in SEEDS])
    stacked.load_state_dict(stacked_params_from_jax(trees))
    for r, tree in enumerate(trees):
        got = replica_state(stacked.state_dict(), r)
        want = params_from_jax(tree)
        assert set(got) == set(want)
        assert all(torch.equal(got[k], want[k]) for k in want)


def test_a_stack_takes_one_architecture():
    with pytest.raises(ValueError, match="one architecture"):
        StackedLstmEncoder([_encoder(0), LstmEncoder(3, 16, 2, device="cpu")])


def _jax_trees(jspec, n_t):
    module = jspec.build_module()
    trees = [module.init(jax.random.key(s), jnp.zeros((1, n_t, 3)))["params"]
             for s in SEEDS]
    return module, [jax.tree_util.tree_map(np.asarray, t) for t in trees]


@pytest.mark.parametrize("objective", ["mse", "combined"])
def test_stacked_epochs_match_jax_make_stacked_train_epoch(objective):
    """Two stacked epochs of R = 3 replicas against the JAX stacked epoch
    program on a 1-device mesh: dropout 0, batch_size = the split, so each
    epoch is one full-batch step and the shuffles do not enter."""
    _stacked_epochs_against_jax(objective, num_layers=2)


@pytest.mark.parametrize("num_layers", [1, 4])
def test_stacked_epochs_at_one_and_four_layers_match_jax(num_layers):
    """As above (mse) through the single-layer replica axis (one layer) and
    the stack's (four layers fuse into one 4-deep stack at T=8, H=8); the
    same tolerances, 1e-5 relative on the sums."""
    _stacked_epochs_against_jax("mse", num_layers)


def _stacked_epochs_against_jax(objective: str, num_layers: int) -> None:
    n, n_t = 6, 8
    split = _synthetic_split(n, np.random.default_rng(0))
    hparams = dict(objective=objective, hidden_size=H, num_layers=num_layers,
                   dropout=0.0)
    jspec = JaxSpec(kernel_impl="xla", **hparams)
    module, trees = _jax_trees(jspec, n_t)
    mesh = make_data_mesh(1)
    repl = replicated_sharding(mesh)
    tx = JaxFlatAdam(CLIP, jspec.weight_decay)
    fspec = flatten_spec(trees[0])
    pstack = global_put(jax_stack_flat([jax_flatten(t, fspec) for t in trees]),
                        repl)
    ostack = global_put(jax_stack_opt([tx.init(t) for t in trees]), repl)
    epoch_fn = make_stacked_train_epoch(
        module, jspec.window_objective(), jspec.metric_keys, tx, mesh, fspec,
        batch_size=n)
    lrs = global_put(jnp.asarray(LRS, jnp.float32), repl)

    spec = ModelSpec(**hparams)
    stacked = StackedLstmEncoder([spec.build_module(device="cpu") for _ in SEEDS])
    stacked.load_state_dict(stacked_params_from_jax(trees))
    opt = StackedFlatAdam(stacked.replicas, CLIP, spec.weight_decay)
    data = device_split(Batch(*(np.asarray(a) for a in split)), "cpu")
    program = StackedTrainProgram(stacked, opt, spec.window_objective(), data,
                                  n, [torch.Generator() for _ in SEEDS])
    k = data.x.shape[1]
    assert stacked.layer_groups(n_t, n * k, False, k) == [num_layers]
    for epoch in range(2):
        keys = global_put(jnp.stack([jax.random.fold_in(jax.random.key(s), epoch)
                                     for s in SEEDS]), repl)
        pstack, ostack, jsums = epoch_fn(pstack, ostack, lrs, keys, split)
        sums, steps = program.epoch(LRS)
        assert steps == 1
        got = stacked_metric_means(sums, len(SEEDS))
        jsums = jax.device_get(jsums)
        for r in range(len(SEEDS)):
            for key, (v, w) in jsums.items():
                want = float(v[r]) / max(float(w[r]), 1e-30)
                assert got[r][key] == pytest.approx(want, rel=1e-5, abs=0), key
    host = jax.device_get(pstack)
    for r in range(len(SEEDS)):
        want = params_from_jax(jax.tree_util.tree_map(
            np.asarray, unflatten({k: v[r] for k, v in host.items()}, fspec)))
        got = stacked.replicas[r].state_dict()
        for name, value in want.items():
            np.testing.assert_allclose(got[name].numpy(), value.numpy(),
                                       atol=1e-6, rtol=1e-4, err_msg=name)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("stacked_data")
    bootstrap_synthetic(root, n_stocks=4, n_samples=1200, seed=0)
    return root


def _dm(data_dir, batch_size=2):
    return FinancialWindowDataModule(data_dir, batch_size=batch_size, **WINDOWS)


def _spec(lr=1e-4, dropout=0.2):
    return ModelSpec(objective="mse", hidden_size=H, num_layers=2,
                     dropout=dropout, learning_rate=lr)


def _stacked_fit(data_dir, seeds=SEEDS, lrs=LRS, epochs=2, **kw):
    trainer = StackedTrainer(max_epochs=epochs, gradient_clip_val=CLIP,
                             device="cpu", **kw)
    return trainer.fit(_spec(), _dm(data_dir), [
        ReplicaSpec(f"s{i}", s, lr) for i, (s, lr) in enumerate(zip(seeds, lrs))])


def _assert_replica_equal(got, want_state, want_opt=None):
    for name, value in want_state.items():
        assert torch.equal(got.state[name], value), name
    if want_opt is not None:
        assert got.opt_state["count"] == want_opt["count"]
        assert torch.equal(got.opt_state["mu"], want_opt["mu"])
        assert torch.equal(got.opt_state["nu"], want_opt["nu"])


def test_each_replica_is_its_solo_trainer_run_bitwise(data_dir):
    """Replica r of StackedTrainer.fit against Trainer.fit with its seed and
    rate: dropout 0.2, 2 epochs, weights, moments and every history row
    equal bit for bit (each replica draws its masks and shuffles from its
    own generator, as the solo run does)."""
    result = _stacked_fit(data_dir)
    assert [r.status for r in result.replicas] == ["active"] * 3
    for r, (seed, lr) in enumerate(zip(SEEDS, LRS)):
        solo = Trainer(max_epochs=2, gradient_clip_val=CLIP, device="cpu",
                       seed=seed).fit(_spec(lr), _dm(data_dir))
        got = result.replicas[r]
        _assert_replica_equal(got, solo.state, solo.opt_state)
        assert got.history == solo.history
        assert got.best_val_loss == solo.best_val_loss
    assert result.epochs == 2 and result.steps_per_sec > 0
    assert result.replica_steps_per_sec == pytest.approx(3 * result.steps_per_sec)


def test_a_sibling_changes_nothing_of_the_others(data_dir):
    """Replica 2's seed and rate changed: replicas 0 and 1 bit for bit."""
    base = _stacked_fit(data_dir)
    other = _stacked_fit(data_dir, seeds=(0, 1, 7), lrs=(LRS[0], LRS[1], 3e-2))
    for r in (0, 1):
        _assert_replica_equal(other.replicas[r], base.replicas[r].state,
                              base.replicas[r].opt_state)
        assert other.replicas[r].history == base.replicas[r].history
    assert not torch.equal(other.replicas[2].state["w_hh_l0"],
                           base.replicas[2].state["w_hh_l0"])


@pytest.fixture
def fault_plan():
    def install(*specs):
        faults.install_plan(faults.FaultPlan.parse(json.dumps(
            {"faults": [dict(attempt=None, **s) for s in specs]})))

    yield install
    faults.clear_plan()


def test_a_diverging_replica_rolls_back_slows_then_masks(data_dir, fault_plan):
    """A ``stacked.replica_loss`` nan plan on replica 1 at every epoch: rolled
    back with its rate halved after epoch 0, masked after epoch 1, frozen at
    its snapshot (here its initial weights) through epoch 2; its siblings
    bit for bit an unfaulted run's."""
    clean = _stacked_fit(data_dir, epochs=3)
    fault_plan({"point": "stacked.replica_loss", "kind": "nan",
                "match": {"replica": 1}})
    faulted = _stacked_fit(data_dir, epochs=3)
    rep = faulted.replicas[1]
    assert rep.status == "masked" and rep.rollbacks == 2
    # A row's rate is the one the replica goes on with (the solo trainer's
    # history): halved by the rollback at epoch 0, frozen at 0 once masked.
    assert [row["lr-Adam"] for row in rep.history] == [LRS[1] / 2, LRS[1] / 2,
                                                       0.0]
    assert np.isnan(rep.history[0]["loss/total/train"])
    init = _encoder(SEEDS[1]).state_dict()
    _assert_replica_equal(rep, init)
    assert rep.opt_state["count"] == 0
    for r in (0, 2):
        _assert_replica_equal(faulted.replicas[r], clean.replicas[r].state,
                              clean.replicas[r].opt_state)
        assert faulted.replicas[r].history == clean.replicas[r].history


def test_a_poisoned_replica_is_rolled_back_to_its_snapshot(data_dir,
                                                          monkeypatch):
    """NaN written into replica 1's parameters on the device during epoch 1:
    its epoch loss is not finite, its row goes back to the snapshot taken
    after epoch 0, bit for bit, and it trains on at half its rate."""
    snapshots = []
    real_epoch = StackedTrainProgram.epoch

    def epoch(self, lrs):
        snapshots.append(self.optimizer.snapshot())
        if len(snapshots) == 2:  # epoch 1
            with torch.no_grad():
                self.optimizer.params[1].fill_(float("nan"))
        return real_epoch(self, lrs)

    monkeypatch.setattr(StackedTrainProgram, "epoch", epoch)
    rolled = {}
    real_restore = StackedFlatAdam.restore_row

    def restore_row(self, r, snapshot):
        real_restore(self, r, snapshot)
        rolled[r] = tuple(t[r].clone() for t in (self.params, self.mu,
                                                 self.nu, self.count_t))

    monkeypatch.setattr(StackedFlatAdam, "restore_row", restore_row)
    result = _stacked_fit(data_dir, epochs=3)
    assert list(rolled) == [1]
    # The row restored is the state epoch 1 started from.
    for got, saved in zip(rolled[1], snapshots[1]):
        assert torch.equal(got, saved[1])
    rep = result.replicas[1]
    assert rep.status == "active" and rep.rollbacks == 1
    assert rep.history[2]["lr-Adam"] == pytest.approx(LRS[1] / 2)
    assert all(torch.isfinite(v).all() for v in rep.state.values())


def test_replica_checkpoints_restore_and_resume_bit_for_bit(data_dir, tmp_path):
    """Each replica's best and last restore as solo checkpoints; a run of 1
    epoch resumed to 2 equals an unbroken 2-epoch run bit for bit."""
    unbroken = _stacked_fit(data_dir, epochs=2, ckpt_dir=tmp_path / "a")
    for rep in unbroken.replicas:
        state, opt_state, spec, meta = restore_checkpoint(tmp_path / "a" / rep.name,
                                                          "last")
        assert meta["epoch"] == 1 and meta["trainer"] == "stacked"
        assert spec == _spec()
        _assert_replica_equal(rep, state, opt_state)
        best, _, _, best_meta = restore_checkpoint(tmp_path / "a" / rep.name, "best")
        assert best_meta["best_val"] == pytest.approx(rep.best_val_loss)
    _stacked_fit(data_dir, epochs=1, ckpt_dir=tmp_path / "b")
    resumed = _stacked_fit(data_dir, epochs=2, ckpt_dir=tmp_path / "b",
                           resume=True)
    assert resumed.epochs == 1
    for got, want in zip(resumed.replicas, unbroken.replicas):
        _assert_replica_equal(got, want.state, want.opt_state)
        assert got.history == want.history[1:]


def test_mixed_epochs_start_fresh(data_dir, tmp_path):
    _stacked_fit(data_dir, epochs=2, ckpt_dir=tmp_path)
    # Replica s1 one epoch behind the others.
    _stacked_fit(data_dir, seeds=SEEDS[1:2], lrs=LRS[1:2], epochs=1,
                 ckpt_dir=tmp_path / "other")
    for name in ("last", "last.json"):
        target = tmp_path / "s1" / name
        if target.is_dir():
            import shutil

            shutil.rmtree(target)
            shutil.copytree(tmp_path / "other" / "s0" / name, target)
        else:
            target.write_bytes((tmp_path / "other" / "s0" / name).read_bytes())
    fresh = _stacked_fit(data_dir, epochs=2, ckpt_dir=tmp_path, resume=True)
    assert fresh.epochs == 2
    assert [len(r.history) for r in fresh.replicas] == [2, 2, 2]


@pytest.fixture(scope="module")
def long_data_dir(tmp_path_factory):
    """4 stocks, enough samples for 14 training windows of a one-year
    lookback at stride 257."""
    root = tmp_path_factory.mktemp("stacked_long_data")
    bootstrap_synthetic(root, n_stocks=4, n_samples=5600, seed=0)
    return root


def test_stacked_trainer_refuses_a_grouping_before_training(long_data_dir):
    """One layer at H=64 over a one-year lookback on 10 windows of 4 stocks
    (40 rows) takes the time-blocked route, which now stacks: each of two
    replicas is its solo Trainer run bit for bit (weights, moments,
    history)."""
    data_dir = long_data_dir
    spec = ModelSpec(objective="mse", hidden_size=64, num_layers=1)
    windows = dict(batch_size=10, lookback_window=252, target_window=5,
                   stride=257)
    module = StackedLstmEncoder([LstmEncoder(5, 64, 1, 0.0, device="cpu")])
    assert module.layer_groups(252, 40, False, 4) == [1]
    assert lk.single_layer_route(252, 40, 64, 4) == "pallas-timeblocked"
    result = StackedTrainer(max_epochs=1, device="cpu").fit(
        spec, FinancialWindowDataModule(data_dir, **windows),
        [ReplicaSpec("a", 0, 1e-3), ReplicaSpec("b", 1, 1e-4)])
    for got, (seed, lr) in zip(result.replicas, ((0, 1e-3), (1, 1e-4))):
        solo = Trainer(max_epochs=1, device="cpu", seed=seed).fit(
            dataclasses.replace(spec, learning_rate=lr),
            FinancialWindowDataModule(data_dir, **windows))
        assert got.status == "active"
        _assert_replica_equal(got, solo.state, solo.opt_state)
        assert got.history == solo.history


def _child(args, tmp_path, env_extra=None):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2",
               **(env_extra or {}))
    overrides = ["trainer.max_epochs=2", "datamodule.n_stocks=4",
                 "datamodule.n_samples=1200", "datamodule.lookback_window=10",
                 "datamodule.target_window=5", "datamodule.stride=15",
                 "model.hidden_size=8", f"datamodule.data_dir={tmp_path}/data",
                 f"logger.save_dir={tmp_path}/logs"]
    return subprocess.run(
        [sys.executable, "-m", "masters_thesis_tpu_torch", "stacked",
         "--device", "cpu", *overrides, *args],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)


def test_stacked_entry_point_on_the_cpu(tmp_path):
    replicas = '[{"name": "s0", "seed": 0}, {"name": "s1", "seed": 1, "lr": 1e-3}]'
    proc = _child(["--replicas", replicas, "--ckpt-dir", str(tmp_path / "ck")],
                  tmp_path)
    assert proc.returncode == 0, proc.stderr
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(line) == {"replicas", "steps_per_sec", "epochs"}
    assert line["epochs"] == 2
    assert [r["name"] for r in line["replicas"]] == ["s0", "s1"]
    for row in line["replicas"]:
        assert row["status"] == "active" and row["rollbacks"] == 0
        assert row["checkpoint"] == str(tmp_path / "ck" / row["name"] / "best")
        for tag in ("best", "last"):
            state, _, spec, meta = restore_checkpoint(
                tmp_path / "ck" / row["name"], tag)
            assert spec.hidden_size == 8
        assert meta["replica"]["learning_rate"] == (1e-3 if row["name"] == "s1"
                                                    else 1e-4)
    # Every replica masked: exit 1, the line still printed.
    plan = json.dumps({"faults": [{"point": "stacked.replica_loss",
                                   "kind": "nan", "attempt": None}]})
    proc = _child(["--replicas", replicas, "--ckpt-dir",
                   str(tmp_path / "masked"), "--max-epochs", "2"], tmp_path,
                  {"MTT_FAULT_PLAN": plan})
    assert proc.returncode == 1, proc.stderr
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert [r["status"] for r in line["replicas"]] == ["masked", "masked"]


@pytest.mark.parametrize("model", [["model=medium"],
                                   ["model=small", "model.num_layers=1"]],
                         ids=["medium", "one_layer"])
def test_stacked_entry_point_takes_other_groupings(tmp_path, model):
    """``stacked model=medium`` (one 4-deep stack at this toy width) and
    ``model=small model.num_layers=1`` train every replica to the end."""
    replicas = '[{"name": "s0", "seed": 0}, {"name": "s1", "seed": 1}]'
    proc = _child(model + ["--replicas", replicas, "--ckpt-dir",
                           str(tmp_path / "ck")], tmp_path)
    assert proc.returncode == 0, proc.stderr
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert [r["status"] for r in line["replicas"]] == ["active", "active"]
    _, _, spec, _ = restore_checkpoint(tmp_path / "ck" / "s1", "best")
    assert spec.num_layers == (4 if model == ["model=medium"] else 1)


def test_stacked_entry_point_refuses_a_time_blocked_grouping(tmp_path):
    """One layer at H=64 over a one-year lookback takes the time-blocked
    route, which the entry point now trains: every replica to the end, its
    checkpoints those of a one-layer model."""
    proc = _child(["model.num_layers=1", "model.hidden_size=64",
                   "datamodule.lookback_window=252", "datamodule.stride=257",
                   "datamodule.batch_size=10", "datamodule.n_samples=5600",
                   "--replicas",
                   '[{"name": "a", "seed": 0}, {"name": "b", "seed": 1}]',
                   "--ckpt-dir", str(tmp_path / "ck"), "--max-epochs", "1"],
                  tmp_path)
    assert proc.returncode == 0, proc.stderr
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert [r["status"] for r in line["replicas"]] == ["active", "active"]
    for name in ("a", "b"):
        _, _, spec, _ = restore_checkpoint(tmp_path / "ck" / name, "last")
        assert spec.num_layers == 1 and spec.hidden_size == 64


def test_stacked_entry_point_refuses_what_train_refuses(tmp_path):
    for override, key in (("trainer.epoch_mode=stream", "epoch_mode"),
                          ("trainer.n_devices=0", "n_devices")):
        proc = _child([override, "--replicas", '[{"name": "a", "seed": 0}]',
                       "--ckpt-dir", str(tmp_path / "ck")], tmp_path)
        assert proc.returncode != 0
        assert key in proc.stderr


def _t(rng, *shape, scale=1.0):
    return torch.tensor(rng.normal(0, scale, shape), dtype=torch.float32)


def _mask(rng, *shape):
    return torch.tensor((rng.random(shape) > 0.2) / 0.8, dtype=torch.float32)


@pytest.mark.parametrize("n_rep", [1, 3])
def test_stacked_single_layer_plain_versions_equal_the_solo_ones(n_rep):
    """The replica-axis single layer on the CPU (its plain forward, sweep
    and weight gradient, through autograd): each replica's slices the solo
    layer's bit for bit."""
    rng = np.random.default_rng(6)
    t_, b_ = 5, 4
    x = _t(rng, n_rep, t_, b_, 4 * H).requires_grad_()
    w = _t(rng, n_rep, H, 4 * H, scale=0.3).requires_grad_()
    h = lk.lstm_recurrence_stacked(x, w)
    h.square().sum().backward()
    hs, cs = lk.lstm_recurrence_stacked_ref(x.detach(), w.detach(),
                                            return_c=True)
    dh = torch.ones_like(hs)
    d_pre = lk.lstm_bwd_stacked_ref(dh, x.detach(), hs, cs, w.detach())
    dw = lk.lstm_single_wgrad_stacked(d_pre, hs)
    for r in range(n_rep):
        xs = x.detach()[r].clone().requires_grad_()
        ws = w.detach()[r].clone().requires_grad_()
        hr = lk.lstm_recurrence(xs, ws)
        hr.square().sum().backward()
        assert torch.equal(hr, h[r]) and torch.equal(hr, hs[r])
        assert torch.equal(xs.grad, x.grad[r]) and torch.equal(ws.grad, w.grad[r])
        hs_r, cs_r = lk.lstm_recurrence_ref(xs.detach(), ws.detach(),
                                            return_c=True)
        assert torch.equal(cs_r, cs[r])
        d_r = lk.lstm_bwd_ref(dh[r], xs.detach(), hs_r, cs_r, ws.detach())
        assert torch.equal(d_r, d_pre[r])
        assert torch.equal(lk.lstm_single_wgrad(d_r, hs_r), dw[r])


@pytest.mark.parametrize("n_rep", [1, 3])
def test_stacked_stack_plain_versions_equal_the_solo_ones(n_rep):
    """The replica-axis 3-deep stack on the CPU with seam masks (its plain
    forward with the stashes, sweep and weight gradients, and through
    autograd): each replica's slices the solo stack's bit for bit."""
    rng = np.random.default_rng(7)
    t_, b_, depth = 5, 4, 3
    x = _t(rng, n_rep, t_, b_, 4 * H).requires_grad_()
    w_hh = [_t(rng, n_rep, H, 4 * H, scale=0.3).requires_grad_()
            for _ in range(depth)]
    w_in = [_t(rng, n_rep, H, 4 * H, scale=0.3).requires_grad_()
            for _ in range(depth - 1)]
    bias = [_t(rng, n_rep, 4 * H, scale=0.1).requires_grad_()
            for _ in range(depth - 1)]
    masks = [_mask(rng, n_rep, t_, b_, H) for _ in range(depth - 1)]
    h = lk.lstm_stack_recurrence_stacked(x, (w_hh, w_in, bias), masks)
    h.square().sum().backward()
    detached = [[t.detach() for t in g] for g in (w_hh, w_in, bias)]
    hs, cs = lk.lstm_stack_stacked_ref(x.detach(), *detached, masks,
                                       return_stash=True)
    dh = torch.ones_like(hs[-1])
    d_pres = lk.lstm_stack_bwd_stacked_ref(dh, x.detach(), masks, hs, cs,
                                           *detached)
    grads = lk.lstm_stack_wgrad_stacked(d_pres, hs, masks)
    for r in range(n_rep):
        xs = x.detach()[r].clone().requires_grad_()
        groups = [[t.detach()[r].clone().requires_grad_() for t in g]
                  for g in (w_hh, w_in, bias)]
        mr = [m[r] for m in masks]
        hr = lk.lstm_stack_recurrence(xs, groups, mr)
        hr.square().sum().backward()
        assert torch.equal(hr, h[r])
        assert torch.equal(xs.grad, x.grad[r])
        for solo_group, group in zip(groups, (w_hh, w_in, bias)):
            for a, b in zip(solo_group, group):
                assert torch.equal(a.grad, b.grad[r])
        plain = [[t.detach() for t in g] for g in groups]
        hs_r, cs_r = lk.lstm_stack_ref(xs.detach(), *plain, mr,
                                       return_stash=True)
        assert all(torch.equal(a, b[r]) for a, b in zip(hs_r + cs_r, hs + cs))
        d_r = lk.lstm_stack_bwd_ref(dh[r], xs.detach(), mr, hs_r, cs_r, *plain)
        assert all(torch.equal(a, b[r]) for a, b in zip(d_r, d_pres))
        solo = lk.lstm_stack_wgrad_ref(d_r, hs_r, mr)
        for solo_part, part in zip(solo, grads):
            assert all(torch.equal(a, b[r]) for a, b in zip(solo_part, part))


@pytest.mark.parametrize("n_rep", [1, 3])
def test_time_blocked_single_layer_has_no_replica_axis(n_rep):
    """The replica-axis time-blocked layer on the CPU (its plain forward and
    backward through autograd, T=252 on 100 rows at H=64, the reference's
    route): each replica's h and gradients the solo layer's bit for bit,
    and the stacked plain versions the solo ones replica by replica."""
    rng = np.random.default_rng(7)
    n_t, b_, hid = 252, 100, 64
    assert lk.single_layer_route(n_t, b_, hid, 100) == "pallas-timeblocked"
    x = _t(rng, n_rep, n_t, b_, 4 * hid).requires_grad_()
    w = _t(rng, n_rep, hid, 4 * hid, scale=0.1).requires_grad_()
    h = lk.lstm_recurrence_stacked(x, w, window_rows=100)
    h.square().sum().backward()
    chunk, tile = lk.tb_time_chunk(b_, hid), lk._row_tile(b_)
    hs, cs = lk.lstm_tb_stacked_ref(x.detach(), w.detach(), chunk)
    dx, dw = lk.lstm_tb_bwd_stacked_ref(2 * hs, x.detach(), hs, cs, w.detach(),
                                        chunk, tile)
    for r in range(n_rep):
        xs = x.detach()[r].clone().requires_grad_()
        ws = w.detach()[r].clone().requires_grad_()
        hr = lk.lstm_recurrence(xs, ws, window_rows=100)
        hr.square().sum().backward()
        assert torch.equal(hr, h[r]) and torch.equal(hr, hs[r])
        assert torch.equal(xs.grad, x.grad[r]) and torch.equal(ws.grad, w.grad[r])
        hs_r, cs_r = lk.lstm_tb_fwd_ref(xs.detach(), ws.detach(), chunk)
        assert torch.equal(cs_r, cs[r])
        dx_r, dw_r = lk.lstm_tb_bwd_ref(2 * hs_r, xs.detach(), hs_r, cs_r,
                                        ws.detach(), chunk, tile)
        assert torch.equal(dx_r, dx[r]) and torch.equal(dw_r, dw[r])


@pytest.mark.parametrize("n_t,rows,hidden", [(252, 100, 64), (252, 40, 64)])
def test_time_blocked_replica_axis_matches_jax_vmap(n_t, rows, hidden):
    """R = 2 replicas of lstm_recurrence_stacked at T=252 on the
    time-blocked route against jax.vmap of the JAX lstm_recurrence in
    interpret mode (its time-blocked Pallas kernel, batched by vmap), and
    their gradients against jax.grad through it."""
    rng = np.random.default_rng(rows)
    x = rng.normal(size=(2, n_t, rows, 4 * hidden)).astype(np.float32)
    w = (rng.normal(size=(2, hidden, 4 * hidden)) * 0.1).astype(np.float32)
    ct = rng.normal(size=(2, n_t, rows, hidden)).astype(np.float32)
    assert lk.single_layer_route(n_t, rows, hidden) == "pallas-timeblocked"

    def run(a, b):
        return jax.vmap(lambda xr, wr: jax_lk.lstm_recurrence(
            xr, wr, impl="interpret"))(a, b)

    jx, jw = jnp.asarray(x), jnp.asarray(w)
    want = np.asarray(run(jx, jw))
    want_dx, want_dw = (np.asarray(g) for g in jax.grad(
        lambda a, b: jnp.sum(run(a, b) * ct), argnums=(0, 1))(jx, jw))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    h = lk.lstm_recurrence_stacked(tx, tw)
    (h * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(h.detach().numpy(), want, atol=1e-5, rtol=0)
    for r in range(2):
        for got, ref in ((tx.grad[r], want_dx[r]), (tw.grad[r], want_dw[r])):
            scale = float(np.abs(ref).max())
            np.testing.assert_allclose(got.numpy(), ref, atol=2e-5 * scale,
                                       rtol=0)


# Groupings of the stacked encoder at the shapes that give them: a single
# layer and a 3-deep stack at toy width (T=8, H=8 fuse up to 8 layers), and
# at H=64 model=medium's one 4-deep stack and model=large's 7 + 1 on 25-row
# windows (T=60), and a 3-layer model's pair + single on 100 rows.
GROUPINGS = {
    "1": (1, 8, 8, 6, None, [1]),
    "3": (3, 8, 8, 6, None, [3]),
    "4": (4, 64, 60, 25, 25, [4]),
    "7+1": (8, 64, 60, 25, 25, [7, 1]),
    "2+1": (3, 64, 60, 100, 100, [2, 1]),
}


@pytest.mark.parametrize("injected", [False, True], ids=["drawn", "injected"])
@pytest.mark.parametrize("grouping", list(GROUPINGS))
def test_stacked_encoder_groupings_are_the_solo_encoders_bitwise(grouping,
                                                                 injected):
    """A training forward and backward of R = 3 replicas (dropout 0.2, the
    masks drawn from each replica's generator or injected per replica)
    against each solo encoder on its windows and masks: outputs and every
    parameter's gradient bit for bit."""
    num_layers, hidden, n_t, rows, window_rows, groups = GROUPINGS[grouping]

    def encoder(seed):
        return LstmEncoder(3, hidden, num_layers, 0.2, device="cpu",
                           generator=torch.Generator().manual_seed(seed))

    stacked = StackedLstmEncoder([encoder(s) for s in SEEDS])
    solos = [encoder(s) for s in SEEDS]
    assert stacked.layer_groups(n_t, rows, True, window_rows) == groups
    x = torch.randn(len(SEEDS), rows, n_t, 3,
                    generator=torch.Generator().manual_seed(9))
    rng = np.random.default_rng(11)
    masks = ([[_mask(rng, n_t, rows, hidden)
               for _ in range(num_layers - 1)] for _ in SEEDS]
             if injected else None)
    gens = [torch.Generator().manual_seed(40 + s) for s in SEEDS]
    alpha, beta = stacked(x, deterministic=False, generators=gens,
                          masks=masks, window_rows=window_rows)
    (alpha.square().sum() + beta.sum()).backward()
    for r, seed in enumerate(SEEDS):
        a, b = solos[r](x[r], deterministic=False,
                        generator=torch.Generator().manual_seed(40 + seed),
                        masks=masks[r] if injected else None,
                        window_rows=window_rows)
        (a.square().sum() + b.sum()).backward()
        assert torch.equal(a, alpha[r]) and torch.equal(b, beta[r])
        for (name, p), q in zip(stacked.replicas[r].named_parameters(),
                                solos[r].parameters()):
            assert torch.equal(p.grad, q.grad), name


@pytest.mark.parametrize("num_layers", [1, 4])
def test_each_replica_is_its_solo_trainer_run_at_one_and_four_layers(
        data_dir, num_layers):
    """As ``test_each_replica_is_its_solo_trainer_run_bitwise`` (dropout
    0.2, 2 epochs, R = 2) through the single-layer and the 4-deep stack's
    replica axes: weights, moments and history rows bit for bit."""
    spec = ModelSpec(objective="mse", hidden_size=H, num_layers=num_layers,
                     dropout=0.2)
    trainer = StackedTrainer(max_epochs=2, gradient_clip_val=CLIP, device="cpu")
    result = trainer.fit(spec, _dm(data_dir), [
        ReplicaSpec(f"s{i}", s, lr) for i, (s, lr) in
        enumerate(zip(SEEDS[:2], LRS[:2]))])
    for r, (seed, lr) in enumerate(zip(SEEDS[:2], LRS[:2])):
        solo = Trainer(max_epochs=2, gradient_clip_val=CLIP, device="cpu",
                       seed=seed).fit(dataclasses.replace(spec, learning_rate=lr),
                                      _dm(data_dir))
        _assert_replica_equal(result.replicas[r], solo.state, solo.opt_state)
        assert result.replicas[r].history == solo.history


def test_kfactor_stack_replicas_are_their_solo_trainer_runs(tmp_path):
    """A toy model=kfactor stack: 3 factors (the rank-3 NLL, combined
    objective), 256 assets a window, lookback 32, H=64, where the grouping
    rule (``window_rows`` = the assets) runs two single layers; R = 2,
    2 epochs, dropout 0.2: each replica its solo trainer run bit for bit."""
    bootstrap_synthetic(tmp_path, n_stocks=256, n_samples=400, seed=0,
                        n_factors=3)
    windows = dict(lookback_window=32, target_window=16, stride=48)
    spec = ModelSpec(objective="combined", hidden_size=64, num_layers=2,
                     dropout=0.2, input_size=7, n_factors=3)

    def dm():
        return FinancialWindowDataModule(tmp_path, batch_size=1, **windows)

    probe = dm()
    assert probe.n_factors == 3 and probe.n_features == spec.input_size
    stacked = StackedLstmEncoder([spec.build_module(device="cpu")])
    assert stacked.layer_groups(32, 256, True, 256) == [1, 1]
    trainer = StackedTrainer(max_epochs=2, gradient_clip_val=CLIP, device="cpu")
    reps = [ReplicaSpec("a", 0, 1e-3), ReplicaSpec("b", 1, 1e-4)]
    result = trainer.fit(spec, dm(), reps)
    for got, rep in zip(result.replicas, reps):
        solo = Trainer(max_epochs=2, gradient_clip_val=CLIP, device="cpu",
                       seed=rep.seed).fit(
            dataclasses.replace(spec, learning_rate=rep.learning_rate), dm())
        _assert_replica_equal(got, solo.state, solo.opt_state)
        assert got.history == solo.history


def test_stacked_pair_replicas_equal_the_solo_pair_bitwise():
    """The stacked pair's forward, sweep and weight gradients on the CPU:
    each replica's slices the solo pair's, through autograd."""
    rng = np.random.default_rng(5)
    r_, t_, b_ = 3, 5, 4

    def t(*shape, scale=1.0):
        return torch.tensor(rng.normal(0, scale, shape), dtype=torch.float32)

    x = t(r_, t_, b_, 4 * H).requires_grad_()
    ws = [t(r_, H, 4 * H, scale=0.3).requires_grad_() for _ in range(3)]
    b2 = t(r_, 4 * H, scale=0.1).requires_grad_()
    mask = torch.tensor((rng.random((r_, t_, b_, H)) > 0.2) / 0.8,
                        dtype=torch.float32)
    h = lk.lstm_pair_recurrence_stacked(x, ws[0], ws[1], b2, ws[2], mask)
    h.square().sum().backward()
    for r in range(r_):
        xs = x.detach()[r].clone().requires_grad_()
        wr = [w.detach()[r].clone().requires_grad_() for w in ws]
        br = b2.detach()[r].clone().requires_grad_()
        hr = lk.lstm_pair_recurrence(xs, wr[0], wr[1], br, wr[2], mask[r])
        hr.square().sum().backward()
        assert torch.equal(hr, h[r])
        assert torch.equal(xs.grad, x.grad[r])
        for a, w in zip(wr, ws):
            assert torch.equal(a.grad, w.grad[r])
        assert torch.equal(br.grad, b2.grad[r])
