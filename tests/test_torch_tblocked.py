"""The port's long-lookback path against the JAX package's: the single-layer
route, the time-blocked plain versions, a model=small-width encoder at a
252-day lookback, a trajectory through the time-blocked route with and
without remat, and the evaluation module.

On the CPU the port runs its plain versions. They are held against the JAX
time-blocked Pallas kernel in interpret mode (``_lstm_recurrence_tblocked``)
and its ``jax.grad`` (the kernel's custom VJP, ``_tb_bwd_kernel``), with the
JAX time chunk set to 4 so that several chunks and the carries between them
run. Tolerances: 1e-5 abs for forwards (f32, sums in another order), 2e-5
abs for dx, and 2e-5 of the largest entry for dw and for the encoder's
gradients, which add sums over every row and step. The trajectory keeps
tests/test_torch_train.py's 1e-5 relative on losses and 1e-6 abs on
parameters; evaluation 1e-5 abs + 1e-5 rel (the OLS and the objectives as in
tests/test_torch_objectives.py).

The CUDA kernels are held against these plain versions on the card in
tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import masters_thesis_tpu.ops.lstm_kernel as jax_lk
from masters_thesis_tpu.data.pipeline import Batch as JaxBatch
from masters_thesis_tpu.models.lstm import LstmEncoder as JaxEncoder
from masters_thesis_tpu.models.objectives import ModelSpec as JaxSpec
from masters_thesis_tpu.parallel import make_data_mesh
from masters_thesis_tpu.train.flatparams import FlatAdam as JaxFlatAdam
from masters_thesis_tpu.train.steps import forward_rows as jax_forward_rows
from masters_thesis_tpu.train.steps import make_train_step
from masters_thesis_tpu_torch import evaluation
import masters_thesis_tpu_torch.models.lstm as port_lstm
from masters_thesis_tpu_torch.data.pipeline import Batch
from masters_thesis_tpu_torch.models.convert import params_from_jax
from masters_thesis_tpu_torch.models.lstm import LstmEncoder
from masters_thesis_tpu_torch.models.objectives import ModelSpec, batched_objective
from masters_thesis_tpu_torch.ops import lstm_kernel as lk
from masters_thesis_tpu_torch.train.flatparams import FlatAdam
from masters_thesis_tpu_torch.train.steps import forward_rows, train_step

ATOL = 1e-5
GRAD_ATOL = 2e-5

# ------------------------------------------------------------------ route


@pytest.mark.parametrize("n_t", [60, 88, 89, 120, 252, 400, 600])
def test_single_layer_route_matches_jax(n_t):
    """single_layer_fits and single_layer_route against the JAX package's
    predicate and route_plan(n_layers=1) on a TPU."""
    for hidden in (8, 64):
        for rows in (1, 25, 100, 104, 105, 200, 800, 3200, 6400):
            assert lk.single_layer_fits(n_t, rows, hidden) == (
                jax_lk.single_layer_fits(n_t, rows, hidden, 4))
            for window in (None, 25, 100):
                want = jax_lk.route_plan(n_t, rows, hidden, n_layers=1,
                                         window_rows=window, backend="tpu")
                assert lk.single_layer_route(n_t, rows, hidden, window) == (
                    want["route"]), (n_t, rows, hidden, window)


def test_reference_time_chunk_matches_jax():
    for rows in (1, 25, 100, 104, 105, 800, 6400):
        for hidden in (8, 16, 64):
            assert lk.tb_time_chunk(rows, hidden) == jax_lk._tb_time_chunk(
                jax_lk._row_tile(rows), hidden, 4)


# ---------------------------------------------------------- plain kernels


def _case(seed, n_t, rows, hidden):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n_t, rows, 4 * hidden)).astype(np.float32)
    w = (rng.normal(size=(hidden, 4 * hidden)) * 0.3).astype(np.float32)
    ct = rng.normal(size=(n_t, rows, hidden)).astype(np.float32)
    return x, w, ct


# (13, 120, 8): four JAX row tiles of 32, the last ragged.
@pytest.mark.parametrize("n_t,rows,hidden", [(9, 4, 8), (11, 40, 16), (13, 120, 8)])
def test_plain_time_blocked_matches_interpret_pallas(monkeypatch, n_t, rows,
                                                     hidden):
    """lstm_tb_fwd_ref and lstm_tb_bwd_ref against the interpret-mode
    time-blocked kernel and its jax.grad, both in chunks of 4 steps."""
    monkeypatch.setattr(jax_lk, "_tb_time_chunk", lambda *a: 4)
    x, w, ct = _case(n_t * rows, n_t, rows, hidden)
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    want = jax_lk._lstm_recurrence_tblocked(jx, jw, True)
    want_dx, want_dw = jax.grad(
        lambda a, b: jnp.sum(jax_lk._lstm_recurrence_tblocked(a, b, True) * ct),
        argnums=(0, 1))(jx, jw)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    hs, cs = lk.lstm_tb_fwd_ref(tx, tw, 4)
    np.testing.assert_allclose(hs.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    dx, dw = lk.lstm_tb_bwd_ref(torch.from_numpy(ct), tx, hs, cs, tw, 4,
                                lk._row_tile(rows))
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), atol=GRAD_ATOL,
                               rtol=0)
    scale = float(np.abs(np.asarray(want_dw)).max())
    np.testing.assert_allclose(dw.numpy(), np.asarray(want_dw),
                               atol=GRAD_ATOL * scale, rtol=0)


# (5, 1, 8): one row, one tile a row; (11, 9, 16): ragged tiles of 2 and 4.
@pytest.mark.parametrize("n_t,rows,hidden", [(5, 1, 8), (11, 9, 16), (13, 40, 8)])
def test_plain_time_blocked_dw_at_card_tiles_matches_interpret_pallas(
        monkeypatch, n_t, rows, hidden):
    """lstm_tb_bwd_ref's dw with the card kernel's row tiles (1, 2 and 4
    rows, one (H, 4H) partial each, summed at the end) against the
    interpret-mode time-blocked kernel's jax.grad, in chunks of 4 steps:
    the card's per-tile partials compute the JAX package's dw."""
    monkeypatch.setattr(jax_lk, "_tb_time_chunk", lambda *a: 4)
    x, w, ct = _case(n_t * rows + 1, n_t, rows, hidden)
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    want_dw = np.asarray(jax.grad(
        lambda b: jnp.sum(jax_lk._lstm_recurrence_tblocked(jx, b, True) * ct))(jw))
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    hs, cs = lk.lstm_tb_fwd_ref(tx, tw, 4)
    scale = float(np.abs(want_dw).max())
    for tile in (1, 2, 4):
        _, dw = lk.lstm_tb_bwd_ref(torch.from_numpy(ct), tx, hs, cs, tw, 4, tile)
        np.testing.assert_allclose(dw.numpy(), want_dw, atol=GRAD_ATOL * scale,
                                   rtol=0)


# Tiles 8, 16 and 32 as the reference cuts its rows; 1, 2 and 4 as the card
# kernel does (sweep_rows), 4 with a ragged last tile.
@pytest.mark.parametrize("n_t,rows,hidden,chunk,tile", [
    (9, 4, 8, 4, 8), (13, 120, 8, 5, 32), (30, 33, 16, 7, 16),
    (9, 4, 8, 4, 1), (13, 7, 8, 5, 2), (30, 33, 16, 7, 4)])
def test_plain_time_blocked_is_the_resident_function(n_t, rows, hidden, chunk,
                                                     tile):
    """The time-blocked plain versions compute the resident ones' function:
    hs and cs bit-equal to lstm_recurrence_ref, dx bit-equal to
    lstm_bwd_ref, dw within 1e-5 of lstm_wgrad_ref (summed in another
    order)."""
    x, w, ct = map(torch.from_numpy, _case(n_t + rows, n_t, rows, hidden))
    hs, cs = lk.lstm_tb_fwd_ref(x, w, chunk)
    want_hs, want_cs = lk.lstm_recurrence_ref(x, w, return_c=True)
    assert torch.equal(hs, want_hs) and torch.equal(cs, want_cs)
    dx, dw = lk.lstm_tb_bwd_ref(ct, x, hs, cs, w, chunk, tile)
    assert torch.equal(dx, lk.lstm_bwd_ref(ct, x, hs, cs, w))
    torch.testing.assert_close(dw, lk.lstm_wgrad_ref(dx, hs, 1), atol=1e-5,
                               rtol=0)


# ------------------------------------------- model=small at 252 steps


F, T_LONG, H_SMALL = 3, 252, 64


def _jax_and_port(num_layers, seed, hidden, look):
    """The JAX encoder on its scan (``kernel_impl="xla"``), its parameters
    (numpy) and the port's encoder with the same weights."""
    module = JaxEncoder(hidden_size=hidden, num_layers=num_layers, dropout=0.0,
                        kernel_impl="xla")
    params = module.init(jax.random.key(seed), jnp.zeros((1, look, F)))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    port = LstmEncoder(input_size=F, hidden_size=hidden, num_layers=num_layers,
                       dropout=0.0, device="cpu")
    port.load_state_dict(params_from_jax(params))
    return module, params, port


@pytest.mark.parametrize("windows", [1, 2])
def test_small_encoder_at_252_steps_matches_jax(monkeypatch, windows):
    """model=small's width (H=64, 2 layers) at T=252 on one and two 100-row
    windows (window_rows=100): both layers alone and time-blocked; the
    forward within 1e-5 of the JAX encoder's scan, the gradients through
    _TimeBlockedFunction within 2e-5 of the largest entry of its jax.grad."""
    module, params, port = _jax_and_port(2, 3, H_SMALL, T_LONG)
    rows = 100 * windows
    assert port.layer_groups(T_LONG, rows, False, 100) == [1, 1]
    assert port.layer_groups(T_LONG, rows, True, 100) == [1, 1]
    assert lk.single_layer_route(T_LONG, rows, H_SMALL, 100) == "pallas-timeblocked"
    functions = []
    real = lk._TimeBlockedFunction.apply

    def spy(*args):
        functions.append(args[0].shape)
        return real(*args)

    monkeypatch.setattr(lk._TimeBlockedFunction, "apply", spy)
    x = np.random.default_rng(windows).normal(
        0.0, 0.02, size=(windows, 100, T_LONG, F)).astype(np.float32)
    ct = np.random.default_rng(10 + windows).normal(
        size=(windows, 100, 1)).astype(np.float32)

    def jax_loss(p):
        alpha, beta = jax_forward_rows(module, p, jnp.asarray(x))
        return jnp.sum(alpha * ct) + jnp.sum(beta * ct)

    want_loss, want_grads = jax.value_and_grad(jax_loss)(
        jax.tree_util.tree_map(jnp.asarray, params))
    alpha, beta = forward_rows(port, torch.from_numpy(x))
    loss = (alpha * torch.from_numpy(ct)).sum() + (beta * torch.from_numpy(ct)).sum()
    loss.backward()
    assert functions == [(T_LONG, rows, 4 * H_SMALL)] * 2
    want_a, want_b = jax_forward_rows(module, params, jnp.asarray(x))
    np.testing.assert_allclose(alpha.detach().numpy(), np.asarray(want_a),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(beta.detach().numpy(), np.asarray(want_b),
                               atol=ATOL, rtol=0)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, want_grads))
    for name, p in port.named_parameters():
        scale = float(want[name].abs().max())
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=GRAD_ATOL * scale, rtol=0, err_msg=name)


# ------------------------------------------------------------ trajectory


H, K, LOOK, TGT = 8, 5, 12, 6


def _batches(n):
    rng = np.random.default_rng(17)
    out = []
    for _ in range(n):
        x = rng.normal(0.1, 0.5, size=(1, K, LOOK, F)).astype(np.float32)
        y = rng.normal(0.1, 0.5, size=(1, K, TGT, 4)).astype(np.float32)
        factor = np.stack([rng.normal(size=1), rng.uniform(0.5, 2, size=1)],
                          axis=-1).astype(np.float32)
        inv_psi = rng.uniform(1, 2, size=(1, K)).astype(np.float32)
        out.append((x, y, factor, inv_psi))
    return out


def _port_trajectory(params, remat, batches, lr):
    spec = ModelSpec(objective="mse", hidden_size=H, num_layers=2, dropout=0.0,
                     remat=remat)
    port = spec.build_module(device="cpu")
    port.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    assert port.remat is remat
    opt = FlatAdam(port, 5.0, 1e-5)
    loss_fn = batched_objective(spec.window_objective())
    losses = []
    for arrays in batches:
        sums = train_step(port, opt, loss_fn, Batch(*map(torch.from_numpy, arrays)),
                          lr)
        losses.append(float(sums["total"][0] / sums["total"][1]))
    return losses, port.state_dict()


@pytest.mark.parametrize("remat", [False, True])
def test_time_blocked_trajectory_matches_jax_train_step(monkeypatch, remat):
    """10 updates (2 layers, dropout 0, one 5-row window a step), the
    time-blocked route forced on both sides (each package's
    single_layer_fits refuses, layers run alone, chunks of 4 steps): the
    port's train_step against make_train_step with FlatAdam, the JAX model
    with ModelSpec(remat=True) when remat is on. The port's runs with and
    without remat are bit-equal."""
    monkeypatch.setenv("MT_LSTM_FUSED_PAIR", "0")
    monkeypatch.setattr(jax_lk, "single_layer_fits", lambda *a, **k: False)
    monkeypatch.setattr(jax_lk, "_tb_time_chunk", lambda *a: 4)
    monkeypatch.setattr(lk, "single_layer_fits", lambda *a, **k: False)
    monkeypatch.setattr(lk, "tb_time_chunk", lambda *a: 4)
    monkeypatch.setattr(port_lstm, "stack_fits", lambda *a, **k: False)
    calls = []
    real = lk._TimeBlockedFunction.apply
    monkeypatch.setattr(lk._TimeBlockedFunction, "apply",
                        lambda *a: calls.append(1) or real(*a))
    lr = 1e-3
    jspec = JaxSpec(objective="mse", hidden_size=H, num_layers=2, dropout=0.0,
                    kernel_impl="interpret", remat=remat)
    module = jspec.build_module()
    params = module.init(jax.random.key(4), jnp.zeros((1, LOOK, F)))["params"]
    init = jax.tree_util.tree_map(np.asarray, params)  # the step donates params
    step_fn = make_train_step(module, jspec.window_objective(),
                              JaxFlatAdam(5.0, 1e-5), make_data_mesh(1))
    opt_state = JaxFlatAdam(5.0, 1e-5).init(params)
    batches = _batches(10)
    want = []
    for arrays in batches:
        params, opt_state, sums = step_fn(params, opt_state, jnp.float32(lr),
                                          jax.random.key(0), JaxBatch(*arrays))
        want.append(float(sums["total"][0]) / float(sums["total"][1]))
    got, state = _port_trajectory(init, remat, batches, lr)
    # Two layers a step; remat runs each forward again in the backward.
    assert len(calls) == 10 * 2 * (2 if remat else 1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert got[-1] != pytest.approx(got[0])
    final = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    for name, value in state.items():
        torch.testing.assert_close(value, final[name], atol=1e-6, rtol=0)
    other_losses, other_state = _port_trajectory(init, not remat, batches, lr)
    assert other_losses == got
    for name, value in state.items():
        assert torch.equal(value, other_state[name]), name


# ------------------------------------------------------------ evaluation


def _close(got, want):
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_evaluation_matches_jax(tmp_path):
    """collect_test_results and delta_losses (recomputed, and from the
    collected estimates) on a toy datamodule whose test split spans three
    chunks, against the JAX functions with the same weights."""
    from masters_thesis_tpu.data.pipeline import (
        FinancialWindowDataModule as JaxDataModule,
        bootstrap_synthetic as jax_bootstrap,
    )
    from masters_thesis_tpu.evaluation import (
        collect_test_results as jax_collect,
        delta_losses as jax_delta,
    )
    from masters_thesis_tpu_torch.data.pipeline import (
        FinancialWindowDataModule,
        bootstrap_synthetic,
    )

    kw = dict(lookback_window=10, target_window=5, stride=15)
    bootstrap_synthetic(tmp_path / "port", n_stocks=4, n_samples=20_000, seed=1)
    jax_bootstrap(tmp_path / "jax", n_stocks=4, n_samples=20_000, seed=1)
    port_dm = FinancialWindowDataModule(tmp_path / "port", **kw)
    jax_dm = JaxDataModule(tmp_path / "jax", engine="python", **kw)
    port_dm.prepare_data()
    jax_dm.prepare_data(verbose=False)
    jspec = JaxSpec(objective="mse", hidden_size=H, num_layers=2, dropout=0.0)
    params = jspec.build_module().init(jax.random.key(6),
                                       jnp.zeros((1, 10, F)))["params"]
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    spec = ModelSpec(objective="mse", hidden_size=H, num_layers=2, dropout=0.0)

    got = evaluation.collect_test_results(spec, state, port_dm, device="cpu")
    want = jax_collect(jspec, params, jax_dm)
    assert len(port_dm.test_range) > 2 * evaluation.CHUNK
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].keys() == want[key].keys()
        for sub in want[key]:
            assert got[key][sub].shape == (len(port_dm.test_range), 4)
            _close(got[key][sub], want[key][sub])

    want_delta = jax_delta(jspec, params, jax_dm)
    for estimates in (None, got):
        delta = evaluation.delta_losses(spec, state, port_dm, estimates=estimates,
                                        device="cpu")
        assert delta.keys() == want_delta.keys() and delta["zeta"] == 1e5
        for key in ("model", "ols", "baseline"):
            assert delta[key].keys() == want_delta[key].keys()
            for metric, value in want_delta[key].items():
                _close(delta[key][metric], value)
