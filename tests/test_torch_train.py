"""The port's optimizer, scheduler, training step and trainer against the
JAX package's, on the same numpy inputs and the same weights.

Tolerances: FlatAdam 1e-6 abs on parameters over 5 steps (f32 on both
sides; the clip norm is one flat sum here against per-leaf sums there). The
10-step trajectory 1e-5 relative on losses and 1e-6 abs on parameters: the
recurrence's f32 sums run in another order on the two sides, and Adam
normalises each gradient, so those ~1e-7 differences reach the parameters
at up to lr times their relative size. ``Trainer.fit``'s epoch curve and
``Trainer.test``'s metrics: 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from masters_thesis_tpu.data.pipeline import Batch as JaxBatch
from masters_thesis_tpu.data.pipeline import (
    FinancialWindowDataModule as JaxDataModule,
)
from masters_thesis_tpu.data.pipeline import bootstrap_synthetic as jax_bootstrap
from masters_thesis_tpu.models.lstm import LstmEncoder as JaxEncoder
from masters_thesis_tpu.models.objectives import ModelSpec as JaxSpec
from masters_thesis_tpu.parallel import make_data_mesh
from masters_thesis_tpu.train.flatparams import FlatAdam as JaxFlatAdam
from masters_thesis_tpu.train.flatparams import flatten_spec
from masters_thesis_tpu.train.optim import PlateauScheduler as JaxPlateau
from masters_thesis_tpu.train.steps import make_train_step
from masters_thesis_tpu.train.trainer import Trainer as JaxTrainer
from masters_thesis_tpu_torch.data.pipeline import (
    Batch,
    FinancialWindowDataModule,
    bootstrap_synthetic,
)
from masters_thesis_tpu_torch.models.convert import params_from_jax
from masters_thesis_tpu_torch.models.lstm import LstmEncoder
from masters_thesis_tpu_torch.models.objectives import ModelSpec, batched_objective
from masters_thesis_tpu_torch.serve.engine import PredictEngine
from masters_thesis_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from masters_thesis_tpu_torch.train.flatparams import FlatAdam
from masters_thesis_tpu_torch.train.optim import PlateauScheduler
from masters_thesis_tpu_torch.train.steps import forward_rows, train_step
from masters_thesis_tpu_torch.train.trainer import Trainer

CLIP, WD = 5.0, 1e-5


class _Vector(nn.Module):
    def __init__(self, values):
        super().__init__()
        self.w = nn.Parameter(torch.from_numpy(values.copy()))


def test_flat_adam_matches_jax_flat_adam():
    """Five updates from the same gradients, the third one clipped."""
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=257).astype(np.float32)
    grads = [rng.normal(0, 0.1, size=257).astype(np.float32) for _ in range(5)]
    grads[2] *= 100.0  # norm ~160 > CLIP
    assert np.linalg.norm(grads[2]) > CLIP > max(np.linalg.norm(g) for g in grads[:2])
    lr = 1e-2

    tx = JaxFlatAdam(CLIP, WD)
    params = {"w": jnp.asarray(p0)}
    spec = flatten_spec(params)
    state = tx.init(params)
    pbuf = jnp.asarray(p0)
    module = _Vector(p0)
    opt = FlatAdam(module, CLIP, WD)
    for g in grads:
        upd, state = tx.update_flat({"float32": jnp.asarray(g)}, state,
                                    {"float32": pbuf}, spec)
        pbuf = pbuf - lr * upd["float32"]
        opt.zero_grad()
        opt.grads.copy_(torch.from_numpy(g))
        opt.step(lr)
        np.testing.assert_allclose(module.w.detach().numpy(), np.asarray(pbuf),
                                   atol=1e-6, rtol=0)
    assert opt.count == int(state.count) == 5
    np.testing.assert_allclose(opt.mu.numpy(), np.asarray(state.mu["float32"]),
                               atol=1e-6, rtol=1e-6)


def test_flat_adam_holds_params_and_grads_as_views():
    module = LstmEncoder(hidden_size=4, num_layers=2, device="cpu")
    opt = FlatAdam(module)
    assert opt.params.numel() == sum(p.numel() for p in module.parameters())
    base = opt.params.data_ptr()
    for p in module.parameters():
        assert opt.params.data_ptr() <= p.data_ptr() < base + 4 * opt.params.numel()
    module(torch.ones(2, 5, 3), deterministic=False)[0].sum().backward()
    flat = torch.cat([p.grad.reshape(-1) for p in module.parameters()])
    torch.testing.assert_close(opt.grads, flat, atol=0, rtol=0)
    assert float(opt.grads.abs().sum()) > 0
    opt.zero_grad()
    assert all(float(p.grad.abs().sum()) == 0 for p in module.parameters())
    with pytest.raises(TypeError, match="float32"):
        FlatAdam(_Vector(np.zeros(3)))


@pytest.mark.parametrize(
    "metrics",
    [
        [1.0, 0.9, 0.9, 0.9, 0.9, 0.8, 0.8, 0.8, 0.8, 0.8],
        [5.0, 4.0, 4.0002, 4.0, 3.9999, 3.9999, 3.9, 4.5, 4.5, 4.5, 4.5, 4.5],
    ],
)
def test_plateau_scheduler_matches_jax(metrics):
    port, ref = PlateauScheduler(1e-3), JaxPlateau(1e-3)
    assert [port.step(m) for m in metrics] == [ref.step(m) for m in metrics]
    assert port.state_dict() == ref.state_dict()
    restored = PlateauScheduler(1.0)
    restored.load_state_dict(port.state_dict())
    assert restored.step(10.0) == ref.step(10.0)


H, K, LOOK, TGT = 8, 5, 12, 6


def _batches(n):
    rng = np.random.default_rng(7)
    out = []
    for _ in range(n):
        x = rng.normal(0.1, 0.5, size=(1, K, LOOK, 3)).astype(np.float32)
        y = rng.normal(0.1, 0.5, size=(1, K, TGT, 4)).astype(np.float32)
        factor = np.stack([rng.normal(size=1), rng.uniform(0.5, 2, size=1)],
                          axis=-1).astype(np.float32)
        inv_psi = rng.uniform(1, 2, size=(1, K)).astype(np.float32)
        out.append((x, y, factor, inv_psi))
    return out


def test_ten_step_trajectory_matches_jax_train_step():
    """10 updates (dropout 0, the same windows, weights through
    params_from_jax): the port's train_step against the JAX package's
    make_train_step with FlatAdam on a 1-device mesh, combined objective."""
    lr = 1e-3
    jspec = JaxSpec(objective="combined", hidden_size=H, num_layers=2,
                    dropout=0.0)
    module = jspec.build_module()
    params = module.init(jax.random.key(3), jnp.zeros((1, LOOK, 3)))["params"]
    port = LstmEncoder(hidden_size=H, num_layers=2, dropout=0.0, device="cpu")
    port.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))

    tx = JaxFlatAdam(CLIP, WD)
    opt_state = tx.init(params)
    step_fn = make_train_step(module, jspec.window_objective(), tx,
                              make_data_mesh(1))
    opt = FlatAdam(port, CLIP, WD)
    loss_fn = batched_objective(
        ModelSpec(objective="combined", hidden_size=H).window_objective())
    want, got = [], []
    for arrays in _batches(10):
        params, opt_state, sums = step_fn(params, opt_state, jnp.float32(lr),
                                          jax.random.key(0), JaxBatch(*arrays))
        want.append(float(sums["total"][0]) / float(sums["total"][1]))
        step_sums = train_step(port, opt, loss_fn,
                               Batch(*map(torch.from_numpy, arrays)), lr)
        got.append(float(step_sums["total"][0] / step_sums["total"][1]))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert got[-1] != pytest.approx(got[0])
    final = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    for name, value in port.state_dict().items():
        torch.testing.assert_close(value, final[name], atol=1e-6, rtol=0)


def test_training_forward_uses_the_injected_masks():
    """With masks given, the training forward is deterministic in them, and
    equals the plain layer composition with the masks applied."""
    enc = LstmEncoder(hidden_size=H, num_layers=3, dropout=0.5, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    x = torch.randn(4, LOOK, 3, generator=torch.Generator().manual_seed(1))
    masks = enc.draw_masks(LOOK, 4, torch.Generator().manual_seed(2))
    assert len(masks) == enc.n_masks == 2
    a, b = enc(x, deterministic=False, masks=masks)
    a2, b2 = enc(x, deterministic=False, masks=masks)
    torch.testing.assert_close((a, b), (a2, b2), atol=0, rtol=0)
    drawn = enc(x, deterministic=False, generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(drawn, (a, b), atol=0, rtol=0)
    assert not torch.allclose(a, enc(x)[0])


def test_fit_test_and_serve_the_best_checkpoint(tmp_path):
    """Trainer.fit + test end to end at toy shape on the CPU: history keys,
    best/last checkpoints, and the best one served by PredictEngine with
    the answers of the trainer's eval forward."""
    bootstrap_synthetic(tmp_path / "data", n_stocks=4, n_samples=1200, seed=0)
    dm = FinancialWindowDataModule(tmp_path / "data", lookback_window=10,
                                   target_window=5, stride=15)
    spec = ModelSpec(objective="mse", hidden_size=H, num_layers=2, dropout=0.2,
                     learning_rate=1e-3)
    trainer = Trainer(max_epochs=2, gradient_clip_val=CLIP,
                      ckpt_dir=tmp_path / "ckpt", seed=0, device="cpu")
    result = trainer.fit(spec, dm)
    assert len(result.history) == 2 and result.steps_per_sec > 0
    assert {"loss/mse/train", "loss/total/train", "loss/mse/val",
            "loss/nll/val", "loss/mae/val", "loss/total/val",
            "lr-Adam"} <= set(result.history[-1])
    assert all(np.isfinite(v) for row in result.history for v in row.values())
    assert result.best_val_loss == min(r["loss/total/val"] for r in result.history)
    metrics = trainer.test(spec, result.state, dm)
    assert set(metrics) == {"mse", "nll", "mae", "total"}
    assert metrics["total"] == pytest.approx(metrics["mse"])

    state, opt_state, sched, meta = load_checkpoint(tmp_path / "ckpt", "last")
    assert meta["epoch"] == 1 and sched["lr"] == pytest.approx(1e-3)
    assert opt_state["count"] == 2 * len(dm.train_range)
    for name, value in result.state.items():
        torch.testing.assert_close(state[name], value, atol=0, rtol=0)
    best, *_ = load_checkpoint(tmp_path / "ckpt", "best")
    x = dm.test_arrays().x[:2]
    engine = PredictEngine(spec, best, n_stocks=4, lookback=10, device="cpu",
                           buckets=(1, 2))
    module = spec.build_module(device="cpu")
    module.load_state_dict(best)
    with torch.no_grad():
        alpha, beta = forward_rows(module, torch.from_numpy(x))
    got = engine.predict(x)
    np.testing.assert_allclose(got[0], alpha[..., 0].numpy(), atol=5e-5, rtol=0)
    np.testing.assert_allclose(got[1], beta[..., 0].numpy(), atol=5e-5, rtol=0)


def test_checkpoint_round_trip_is_atomic(tmp_path):
    state = {"w": torch.arange(6.0).reshape(2, 3)}
    path = save_checkpoint(tmp_path, "last", state, {"count": 3},
                           {"lr": 0.5}, {"epoch": 4})
    assert path == tmp_path / "last"
    save_checkpoint(tmp_path, "last", {"w": state["w"] + 1}, None, None,
                    {"epoch": 5})
    loaded, opt_state, sched, meta = load_checkpoint(tmp_path, "last")
    torch.testing.assert_close(loaded["w"], state["w"] + 1)
    assert opt_state is None and sched is None and meta == {"epoch": 5}
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "last", "last.json", "last.prev", "last.prev.json"]
    assert sorted(p.name for p in path.iterdir()) == ["MANIFEST.json", "state.pt"]


def test_failed_publish_keeps_the_previous_file(tmp_path):
    from masters_thesis_tpu_torch.utils.io import publish

    target = tmp_path / "dataset.npz"
    publish(target, lambda f: f.write(b"old"))

    def torn(f):
        f.write(b"half")
        raise OSError("disk full")

    with pytest.raises(OSError, match="disk full"):
        publish(target, torn)
    assert target.read_bytes() == b"old"
    assert [p.name for p in tmp_path.iterdir()] == ["dataset.npz"]


@pytest.mark.parametrize("objective", ["mse", "combined"])
def test_fit_and_test_match_the_jax_trainer(tmp_path, objective):
    """Trainer.fit's epoch curve (3 epochs) and Trainer.test's four metrics
    against the JAX Trainer: the same windows, the same initial weights
    (JAX init -> params_from_jax, given to both as init_state with a fresh
    optimizer), dropout 0, one device, and batch_size = the number of train
    windows, so each epoch is one full-batch step whose sum does not depend
    on the two sides' different shuffles."""
    windows = dict(lookback_window=10, target_window=5, stride=15)
    jax_bootstrap(tmp_path / "jax", n_stocks=4, n_samples=1200, seed=0)
    bootstrap_synthetic(tmp_path / "port", n_stocks=4, n_samples=1200, seed=0)
    dm = FinancialWindowDataModule(tmp_path / "port", **windows)
    dm.prepare_data()
    dm.setup("fit")
    n_train = len(dm.train_range)
    dm.batch_size = n_train
    jdm = JaxDataModule(tmp_path / "jax", batch_size=n_train, engine="python",
                        **windows)

    hparams = dict(objective=objective, hidden_size=H, num_layers=2,
                   dropout=0.0, learning_rate=1e-3)
    jspec, spec = JaxSpec(**hparams), ModelSpec(**hparams)
    params = jspec.build_module().init(
        jax.random.key(1), jnp.zeros((1, windows["lookback_window"], 3)))["params"]
    init = jax.tree_util.tree_map(np.asarray, params)
    jtrainer = JaxTrainer(max_epochs=3, gradient_clip_val=CLIP,
                          strategy="single_device", enable_progress_bar=False,
                          enable_model_summary=False)
    want = jtrainer.fit(jspec, jdm, init_state=(init, None))
    trainer = Trainer(max_epochs=3, gradient_clip_val=CLIP, device="cpu")
    got = trainer.fit(spec, dm, init_state=(params_from_jax(init), None))

    assert len(got.history) == len(want.history) == 3
    for g, w in zip(got.history, want.history):
        assert set(g) == set(w)
        for key in g:
            assert g[key] == pytest.approx(w[key], rel=1e-5, abs=0), key
    assert got.best_val_loss == pytest.approx(want.best_val_loss, rel=1e-5)

    final = jax.tree_util.tree_map(np.asarray, want.params)
    got_test = trainer.test(spec, params_from_jax(final), dm)
    want_test = jtrainer.test(jspec, want.params, jdm)
    assert set(got_test) == set(want_test) == {"mse", "nll", "mae", "total"}
    for key, value in want_test.items():
        assert got_test[key] == pytest.approx(value, rel=1e-5, abs=0), key
