"""The K-factor model family in the port against the JAX package, on the same
numpy inputs: ``ols_k``, the multi-factor ``ols_features``, the rank-F
Woodbury NLL (values and gradients), the F > 1 objectives and evaluation
metrics, the K-wide encoder, a 10-step ``model=kfactor`` trajectory,
``Trainer.fit`` and ``Trainer.test``, and the drivers on
``datamodule=universe model=kfactor`` at toy size.

Tolerances: 1e-5 abs plus 1e-5 relative for the linear algebra, the losses
and their gradients (f32 on both sides; LAPACK's and the port's unrolled LU
round alike but in another order, the pseudo-inverse is an SVD in torch and
XLA's own in JAX). The NLL at universe width (K = 2,048, n = 16) sums
32,768 terms: it holds at 1e-5 relative. The trajectory 1e-5 relative on
losses and 1e-6 abs on parameters, ``Trainer`` curves and test metrics
1e-5 relative, as for the scalar model (tests/test_torch_train.py).
"""

import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masters_thesis_tpu.data.pipeline import Batch as JaxBatch
from masters_thesis_tpu.data.pipeline import (
    FinancialWindowDataModule as JaxDataModule,
)
from masters_thesis_tpu.data.pipeline import bootstrap_synthetic as jax_bootstrap
from masters_thesis_tpu.models.objectives import ModelSpec as JaxSpec
from masters_thesis_tpu.models.objectives import (
    batched_objective as jax_batched,
    make_combined_window as jax_combined,
    mse_window as jax_mse,
    nll_window as jax_nll,
)
from masters_thesis_tpu.ops.linalg import ols_k as jax_ols_k
from masters_thesis_tpu.ops.losses import kfactor_gaussian_nll as jax_kf_nll
from masters_thesis_tpu.ops.windows import ols_features as jax_ols_features
from masters_thesis_tpu.parallel import make_data_mesh
from masters_thesis_tpu.serve.engine import PredictEngine as JaxEngine
from masters_thesis_tpu.train.flatparams import FlatAdam as JaxFlatAdam
from masters_thesis_tpu.train.steps import make_train_step
from masters_thesis_tpu.train.steps import window_eval_metrics as jax_eval
from masters_thesis_tpu.train.trainer import Trainer as JaxTrainer
from masters_thesis_tpu_torch.cli import test as cli_test
from masters_thesis_tpu_torch.cli.train import main as train_main
from masters_thesis_tpu_torch.data.pipeline import (
    Batch,
    FinancialWindowDataModule,
    bootstrap_synthetic,
)
from masters_thesis_tpu_torch.models import objectives as obj
from masters_thesis_tpu_torch.models.convert import params_from_jax
from masters_thesis_tpu_torch.models.lstm import LstmEncoder
from masters_thesis_tpu_torch.models.objectives import ModelSpec, batched_objective
from masters_thesis_tpu_torch.ops.linalg import ols, ols_k
from masters_thesis_tpu_torch.ops.losses import kfactor_gaussian_nll
from masters_thesis_tpu_torch.ops.windows import ols_features
from masters_thesis_tpu_torch.serve.engine import PredictEngine
from masters_thesis_tpu_torch.train.flatparams import FlatAdam
from masters_thesis_tpu_torch.train.steps import train_step, window_eval_metrics
from masters_thesis_tpu_torch.train.trainer import Trainer

TOL = dict(atol=1e-5, rtol=1e-5)
F = 3
B, K, N = 3, 6, 10
CLIP, WD = 5.0, 1e-5


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def _f_cov(rng, n_f=F):
    a = rng.normal(size=(n_f, n_f))
    return (a @ a.T * 0.3 + np.eye(n_f) * 0.2).astype(np.float32)


def _windows(seed, n_f=F):
    """Model outputs and labels for B windows in the K-factor Batch schema:
    ``y`` (B, K, N, 2F+2), ``factor`` (B, F+F²)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    alpha = rng.normal(0, 0.1, size=(B, K, 1)).astype(f32)
    beta = rng.normal(1, 0.3, size=(B, K, n_f)).astype(f32)
    y = rng.normal(0.1, 0.5, size=(B, K, N, 2 * n_f + 2)).astype(f32)
    factor = np.concatenate(
        [rng.normal(size=(B, n_f)),
         np.stack([_f_cov(rng, n_f).ravel() for _ in range(B)])],
        axis=-1).astype(f32)
    inv_psi = rng.uniform(1, 2, size=(B, K)).astype(f32)
    return alpha, beta, y, factor, inv_psi


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("n_f", [1, 2, 3, 5])
def test_ols_k_matches_jax(n_f):
    """``ols_k`` against the JAX function, batched and unbatched; at F=1 it
    is the port's ``ols`` bit for bit."""
    rng = np.random.default_rng(n_f)
    f = rng.normal(size=(4, 40, n_f)).astype(np.float32)
    y = (0.2 + f @ rng.normal(1, 0.5, size=(n_f, 7))).transpose(0, 2, 1)
    y = (y + rng.normal(0, 0.1, size=y.shape)).astype(np.float32)
    for fs, ys in ((f, y), (f[0], y[0])):
        got = ols_k(*_torch(fs, ys))
        want = jax_ols_k(jnp.asarray(fs), jnp.asarray(ys))
        for g, w in zip(got, want):
            assert g.shape == w.shape
            _close(g, w)
    if n_f == 1:
        alphas, betas = ols(*_torch(f[..., 0], y))
        got_a, got_b = ols_k(*_torch(f, y))
        torch.testing.assert_close(got_a, alphas, atol=0, rtol=0)
        torch.testing.assert_close(got_b[..., 0], betas, atol=0, rtol=0)


def test_ols_features_matches_jax_at_three_factors():
    rng = np.random.default_rng(3)
    f = rng.normal(0, 0.01, size=(5, 16, F)).astype(np.float32)
    r = (0.001 + np.einsum("wtf,kf->wkt", f, rng.normal(1, 0.3, size=(9, F)))
         + rng.normal(0, 0.01, size=(5, 9, 16))).astype(np.float32)
    target = np.concatenate(
        [r[..., None], np.broadcast_to(f[:, None], (5, 9, 16, F))], axis=-1)
    got = ols_features(torch.from_numpy(np.ascontiguousarray(target)))
    want = jax_ols_features(jnp.asarray(target))
    assert [tuple(g.shape) for g in got] == [(5, 9), (5, 9, F), (5, F + F * F),
                                             (5, 9)]
    for name, g, w in zip(("alphas", "betas", "factor", "inv_psi"), got, want):
        scale = float(np.abs(np.asarray(w)).max())
        _close(g, w, atol=1e-5 * scale, rtol=0), name


def test_ols_features_match_float64_least_squares_on_an_ill_conditioned_gram():
    """Factor returns of 1% a day over a 10-day target window give the
    design's gram a condition number of about 2e4. The port's labels stay
    within 1e-5 of float64 least squares there; the JAX package's
    (``jnp.linalg.pinv``, XLA's f32 SVD) part from them, so this case is
    held against float64 and not against the JAX function."""
    rng = np.random.default_rng(0)
    r = rng.normal(0, 0.02, size=(6, 5, 10)).astype(np.float32)
    f = rng.normal(0, 0.01, size=(6, 10, F)).astype(np.float32)
    target = np.concatenate(
        [r[..., None], np.broadcast_to(f[:, None], (6, 5, 10, F))], axis=-1)
    alphas, betas, _, inv_psi = ols_features(
        torch.from_numpy(np.ascontiguousarray(target)))
    design = np.concatenate([np.ones((6, 10, 1)), f.astype(np.float64)], -1)
    assert np.linalg.cond(design[0].T @ design[0]) > 1e4
    want_a, want_b, want_ip = [], [], []
    for w in range(6):
        coef = np.linalg.lstsq(design[w], r[w].T.astype(np.float64),
                               rcond=None)[0]
        resid = r[w] - (design[w] @ coef).T
        want_a.append(coef[0])
        want_b.append(coef[1:].T)
        want_ip.append(1.0 / resid.var(axis=-1, ddof=1))
    for got, want in ((alphas, want_a), (betas, want_b), (inv_psi, want_ip)):
        want = np.asarray(want)
        _close(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)


def _nll_case(case: str, k: int = K, n: int = N, seed: int = 5):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    mean = rng.normal(0, 0.01, size=(k, 1)).astype(f32)
    beta = rng.normal(1, 0.3, size=(k, F)).astype(f32)
    inv_psi = rng.uniform(50, 200, size=k).astype(f32)
    f_cov = _f_cov(rng) * f32(1e-4)
    target = rng.normal(0, 0.05, size=(k, n)).astype(f32)
    if case == "inv_psi_negative":
        inv_psi[1] = -inv_psi[1]
    elif case == "f_cov_indefinite":
        f_cov[0, 0] = -10 * f_cov[0, 0]
    elif case == "f_cov_pivoting":
        # Positive definite, with the largest entry of the first column
        # below the diagonal: the LU swaps rows.
        f_cov = (np.array([[1.0, 2.0, 0.5], [2.0, 5.0, 1.0], [0.5, 1.0, 3.0]])
                 * 1e-4).astype(f32)
    elif case == "f_cov_singular":
        f_cov = np.zeros((F, F), f32)
    return mean, beta, inv_psi, f_cov, target


NLL_CASES = ["psd", "inv_psi_negative", "f_cov_indefinite", "f_cov_pivoting",
             "f_cov_singular"]


@pytest.mark.parametrize("case", NLL_CASES)
def test_kfactor_nll_and_gradients_match_jax(case):
    """The value and the gradients in the mean and the loadings against
    ``jax.grad``; NaN exactly where the JAX function is NaN (inv_psi ≤ 0, a
    determinant of f_cov or of the capacitance whose sign is not
    positive)."""
    mean, beta, inv_psi, f_cov, target = _nll_case(case)
    jargs = [jnp.asarray(a) for a in (inv_psi, f_cov, target)]

    def jax_loss(m, b):
        return jax_kf_nll(m, b, *jargs)

    want = jax_loss(jnp.asarray(mean), jnp.asarray(beta))
    want_grads = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(mean),
                                                     jnp.asarray(beta))
    m, b = (t.requires_grad_() for t in _torch(mean, beta))
    got = kfactor_gaussian_nll(m, b, *_torch(inv_psi, f_cov, target))
    got.backward()
    assert bool(np.isnan(want)) == bool(torch.isnan(got)) == (
        case in ("inv_psi_negative", "f_cov_indefinite", "f_cov_singular"))
    _close(got.detach(), want, atol=1e-5, rtol=1e-5, equal_nan=True)
    if case == "f_cov_singular":
        return  # inf - inf inside both: no gradient to hold
    for g, w in zip((m.grad, b.grad), want_grads):
        scale = float(np.abs(np.asarray(w)).max())
        _close(g, w, atol=1e-5 * scale, rtol=1e-5)


def test_kfactor_nll_at_universe_width_matches_jax():
    """K = 2,048 assets, n = 16 days, batched over 4 windows against
    ``jax.vmap`` of the JAX function, at 1e-5 relative."""
    cases = [_nll_case("psd", k=2048, n=16, seed=s) for s in range(4)]
    stacked = [np.stack(parts) for parts in zip(*cases)]
    want = jax.vmap(jax_kf_nll)(*map(jnp.asarray, stacked))
    got = kfactor_gaussian_nll(*_torch(*stacked))
    _close(got, want, atol=0, rtol=1e-5)


def test_objectives_match_jax_at_three_factors():
    """mse, nll and combined windows, and their batch lifting with and
    without weights, against ``jax.vmap`` of the JAX objectives."""
    arrays = _windows(11)
    targs = _torch(*arrays)
    jargs = [jnp.asarray(a) for a in arrays]
    for port_fn, jax_fn in ((obj.mse_window, jax_mse),
                            (obj.nll_window, jax_nll),
                            (obj.make_combined_window(100.0),
                             jax_combined(100.0))):
        got_loss, got_m = port_fn(*targs)
        want_loss, want_m = jax.vmap(jax_fn)(*jargs)
        _close(got_loss, want_loss)
        assert set(got_m) == set(want_m)
        for key in got_m:
            _close(got_m[key][0], want_m[key][0])
        weights = np.array([1.0, 0.0, 1.0], np.float32)
        for w in (None, weights):
            got = batched_objective(port_fn)(
                *targs, None if w is None else torch.from_numpy(w))
            want = jax_batched(jax_fn)(
                *jargs, None if w is None else jnp.asarray(w))
            _close(got[0], want[0])
            for key in want[1]:
                _close(got[1][key][0], want[1][key][0])
                _close(got[1][key][1], want[1][key][1])


def test_window_eval_metrics_match_jax_at_three_factors():
    arrays = _windows(12)
    got = window_eval_metrics(*_torch(*arrays))
    want = jax.vmap(jax_eval)(*[jnp.asarray(a) for a in arrays])
    assert set(got) == set(want) == {"mse", "nll", "mae"}
    for key in got:
        _close(got[key][0], want[key][0])
        _close(got[key][1], jnp.broadcast_to(want[key][1], (B,)))


H, LOOK, TGT = 8, 12, 6
N_IN = 2 * F + 1


def _jax_params(hidden=H, lookback=LOOK, seed=3):
    jspec = JaxSpec(objective="combined", hidden_size=hidden, num_layers=2,
                    dropout=0.0, n_factors=F, input_size=N_IN)
    module = jspec.build_module()
    params = module.init(jax.random.key(seed),
                         jnp.zeros((1, lookback, N_IN)))["params"]
    return jspec, module, params


def test_k_wide_encoder_matches_jax_on_converted_parameters():
    """The encoder at input width 2F+1 with a (H, F) beta head, on the JAX
    parameters carried across by ``params_from_jax``."""
    _, module, params = _jax_params()
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    assert tuple(state["beta_head.weight"].shape) == (F, H)
    assert tuple(state["w_ih_l0"].shape) == (4 * H, N_IN)
    port = ModelSpec(objective="combined", hidden_size=H, dropout=0.0,
                     input_size=N_IN, n_factors=F).build_module(device="cpu")
    port.load_state_dict(state)
    x = np.random.default_rng(4).normal(size=(K, LOOK, N_IN)).astype(np.float32)
    want = module.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert tuple(got[1].shape) == (K, F)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("n", [1, 3, 16])
def test_kfactor_engine_answers_as_the_jax_engine(n):
    """A model=kfactor engine on the ``serve=universe`` ladder (1–64
    windows) returns what the JAX engine returns: alpha and the first
    loading of beta, padded batches included."""
    jspec, _, params = _jax_params()
    buckets = (1, 2, 4, 8, 16, 32, 64)
    kw = dict(n_stocks=K, lookback=LOOK, n_features=N_IN, buckets=buckets)
    jax_engine = JaxEngine(jspec, params, **kw)
    jax_engine.warmup()
    engine = PredictEngine(
        ModelSpec(objective="combined", hidden_size=H, dropout=0.0,
                  input_size=N_IN, n_factors=F),
        params_from_jax(jax.tree_util.tree_map(np.asarray, params)),
        device="cpu", **kw)
    x = np.random.default_rng(n).normal(size=(n, K, LOOK, N_IN)).astype(
        np.float32)
    got, want = engine.predict(x), jax_engine.predict(x)
    assert got[1].shape == (n, K)
    for g, w in zip(got, want):
        _close(g, w)


def _kfactor_batches(n):
    rng = np.random.default_rng(7)
    out = []
    for _ in range(n):
        x = rng.normal(0.1, 0.5, size=(1, K, LOOK, N_IN)).astype(np.float32)
        y = rng.normal(0.1, 0.5, size=(1, K, TGT, 2 * F + 2)).astype(np.float32)
        factor = np.concatenate([rng.normal(size=(1, F)),
                                 _f_cov(rng).reshape(1, -1)], axis=-1)
        inv_psi = rng.uniform(1, 2, size=(1, K)).astype(np.float32)
        out.append((x, y, factor.astype(np.float32), inv_psi))
    return out


def test_ten_step_kfactor_trajectory_matches_jax_train_step():
    """10 updates of model=kfactor (F=3, input width 7, dropout 0, the
    combined objective) from the same weights on the same windows: the
    port's train_step against the JAX make_train_step with FlatAdam."""
    lr = 1e-3
    jspec, module, params = _jax_params()
    port = LstmEncoder(input_size=N_IN, hidden_size=H, num_layers=2,
                       dropout=0.0, n_factors=F, device="cpu")
    port.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                params)))
    tx = JaxFlatAdam(CLIP, WD)
    opt_state = tx.init(params)
    step_fn = make_train_step(module, jspec.window_objective(), tx,
                              make_data_mesh(1))
    opt = FlatAdam(port, CLIP, WD)
    loss_fn = batched_objective(
        ModelSpec(objective="combined", hidden_size=H).window_objective())
    want, got = [], []
    for arrays in _kfactor_batches(10):
        params, opt_state, sums = step_fn(params, opt_state, jnp.float32(lr),
                                          jax.random.key(0), JaxBatch(*arrays))
        want.append(float(sums["total"][0]) / float(sums["total"][1]))
        step_sums = train_step(port, opt, loss_fn, Batch(*_torch(*arrays)), lr)
        got.append(float(step_sums["total"][0] / step_sums["total"][1]))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert got[-1] != pytest.approx(got[0])
    final = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    for name, value in port.state_dict().items():
        torch.testing.assert_close(value, final[name], atol=1e-6, rtol=0)


@pytest.mark.parametrize("objective", ["nll", "combined"])
def test_kfactor_fit_and_test_match_the_jax_trainer(tmp_path, objective):
    """Trainer.fit's curve (3 epochs) and Trainer.test's metrics on K-factor
    data (4 assets, F=3) against the JAX Trainer: the same windows and
    weights, dropout 0, one full-batch step an epoch (as in
    tests/test_torch_train.py). The target window is 10 days: with F=3 a
    5-day window leaves the OLS fit one degree of freedom, and its
    residual variances (inv_psi) are then ill-conditioned enough that the
    two sides' pseudo-inverses part at 2e-5."""
    windows = dict(lookback_window=10, target_window=10, stride=20)
    jax_bootstrap(tmp_path / "jax", n_stocks=4, n_samples=1200, seed=0,
                  n_factors=F)
    bootstrap_synthetic(tmp_path / "port", n_stocks=4, n_samples=1200, seed=0,
                        n_factors=F)
    dm = FinancialWindowDataModule(tmp_path / "port", **windows)
    assert dm.n_factors == F and dm.n_features == N_IN
    dm.prepare_data()
    dm.setup("fit")
    n_train = len(dm.train_range)
    dm.batch_size = n_train
    jdm = JaxDataModule(tmp_path / "jax", batch_size=n_train, engine="python",
                        **windows)

    hparams = dict(objective=objective, hidden_size=H, num_layers=2,
                   dropout=0.0, learning_rate=1e-3, input_size=N_IN,
                   n_factors=F)
    jspec, spec = JaxSpec(**hparams), ModelSpec(**hparams)
    params = jspec.build_module().init(
        jax.random.key(1), jnp.zeros((1, windows["lookback_window"], N_IN))
    )["params"]
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

    final = jax.tree_util.tree_map(np.asarray, want.params)
    got_test = trainer.test(spec, params_from_jax(final), dm)
    want_test = jtrainer.test(jspec, want.params, jdm)
    assert set(got_test) == set(want_test) == {"mse", "nll", "mae", "total"}
    for key, value in want_test.items():
        assert got_test[key] == pytest.approx(value, rel=1e-5, abs=0), key


UNIVERSE_TOY = ["datamodule=universe", "model=kfactor", "loss=combined",
                "datamodule.n_stocks=16", "datamodule.n_samples=3000",
                "model.hidden_size=8", "trainer.enable_progress_bar=false"]


def test_universe_drivers_on_the_cpu(tmp_path, capsys):
    """``train datamodule=universe model=kfactor`` at toy overrides (only
    n_stocks, n_samples and the hidden size shrink): the window store is
    built with its 8 shards, the model takes 7 inputs and 3 loadings, and
    ``test`` prints the ΔL refusal line and writes the test metrics."""
    data = tmp_path / "data"
    common = ["--device", "cpu", *UNIVERSE_TOY, f"datamodule.data_dir={data}",
              f"logger.save_dir={tmp_path / 'logs'}"]
    train_main([*common, "trainer.max_epochs=2"])
    out = capsys.readouterr().out
    done = re.search(r"done: best_val=(\S+) test_mae=(\S+) test_nll=(\S+)", out)
    assert done and all(np.isfinite(float(v)) for v in done.groups())
    manifest = json.loads((data / "datasets" / "window_store"
                           / "manifest.json").read_text())
    assert manifest["n_shards"] == 8 and manifest["n_windows"] == 62
    assert manifest["fields"]["x"]["shape"] == [16, 32, N_IN]
    assert manifest["fields"]["y"]["shape"] == [16, 16, 2 * F + 2]
    assert json.loads((data / "dgp.json").read_text())["n_factors"] == F
    run = tmp_path / "logs" / "FinancialLstm" / "universe"
    ckpt = run / "combined_kfactor_lr0.0001_fast" / "checkpoints"
    spec = json.loads((ckpt / "best.json").read_text())["spec"]
    assert (spec["input_size"], spec["n_factors"]) == (N_IN, F)

    assert cli_test.main([*common, f"checkpoint={ckpt}"]) == 0
    out = capsys.readouterr().out
    assert ("note: datamodule.n_factors=3: the dL table and results.npz "
            "compare with the scalar market model") in out
    assert "dL_MSE" not in out
    results = json.loads((ckpt.parent / "results.json").read_text())
    assert set(results) == {"checkpoint", "test"}
    assert set(results["test"]) == {"mse", "nll", "mae", "total"}
    assert not (ckpt.parent / "results.npz").exists()
