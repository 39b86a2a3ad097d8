"""``trainer.precision=bf16-mixed`` on the layer pair: the port against the
JAX package's bf16 compute dtype.

The reference is the interpret-mode Pallas pair in bf16 (``impl`` and
``kernel_impl="interpret"``), never the XLA scan, which rounds its state
every step. Both sides do f32 arithmetic on bf16 operands, carry h and c in
f32 and round what they store. The bars are the f32 ones: 1e-5 abs for
forwards, 2e-5 of the largest entry for gradients. A bf16 entry can still
differ: where the two sides' f32 values (summed in another order) fall on
both sides of a bf16 rounding boundary, the stored values are one bf16 ulp
apart. Measured over 36 pair cases (T 8 and 20, rows 4–32, H 16, masked and
not): 59 of 1,118,208 forward entries, each exactly one ulp. The
gradients recompute the gates from those stashes, so where a stash flipped,
gradients end to end differ by up to two ulps of their entry (at most 6
entries an output a case). So each entry is held to the bar, or to one ulp
of the reference entry (two through ``jax.grad`` end to end). A wrong
semantics misses by more, across many entries: the weight-gradient pass
over rounded d_pre puts about 100 of 1,024 dW entries beyond one ulp (the
guard below).

The slice: ``Trainer(precision="bf16-mixed")`` fit and test against the
JAX ``Trainer(precision="bf16-mixed")`` at toy shape.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masters_thesis_tpu.data.pipeline import (
    FinancialWindowDataModule as JaxDataModule,
)
import masters_thesis_tpu.models.lstm as jax_lstm
from masters_thesis_tpu.data.pipeline import bootstrap_synthetic as jax_bootstrap
from masters_thesis_tpu.models.lstm import LstmEncoder as JaxEncoder
from masters_thesis_tpu.models.objectives import ModelSpec as JaxSpec
from masters_thesis_tpu.ops.lstm_kernel import (
    _pair_bwd_pallas,
    _pair_fwd_pallas,
    lstm_pair_recurrence as jax_pair,
    max_wavefront_depth,
    stack_fits as jax_stack_fits,
    window_schedulable as jax_window_schedulable,
)
from masters_thesis_tpu.train.trainer import Trainer as JaxTrainer
from masters_thesis_tpu_torch.data.pipeline import (
    FinancialWindowDataModule,
    bootstrap_synthetic,
)
from masters_thesis_tpu_torch.models.convert import params_from_jax
from masters_thesis_tpu_torch.models.lstm import LstmEncoder, fused_depth
from masters_thesis_tpu_torch.models.objectives import ModelSpec
from masters_thesis_tpu_torch.ops import lstm_kernel as lk
from masters_thesis_tpu_torch.train.trainer import Trainer

BF16 = torch.bfloat16
ATOL = 1e-5
GRAD_RTOL = 2e-5
CLIP = 5.0


def _bf16_ulp(ref: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at each ``|ref|`` (8 significant bits)."""
    mag = np.maximum(np.abs(ref.astype(np.float64)), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def assert_bf16_close(got, want, atol: float, ulps: int = 1):
    """Each entry within ``atol`` of ``want``, or within ``ulps`` bf16 ulps
    of its reference entry (a rounding flip)."""
    got = np.asarray(got.float() if torch.is_tensor(got) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    bad = (diff > atol) & (diff > ulps * _bf16_ulp(want))
    assert not bad.any(), (
        f"{int(bad.sum())} of {diff.size} entries beyond {atol} and "
        f"{ulps} ulp(s); worst {diff.max()} at {np.unravel_index(diff.argmax(), diff.shape)}")


def assert_grad_close(got, want, ulps: int = 1):
    """A gradient: 2e-5 of the largest entry, or ``ulps`` bf16 ulps."""
    want = np.asarray(want, np.float64)
    assert_bf16_close(got, want, GRAD_RTOL * np.abs(want).max(), ulps)


def _case(seed, rows, n_t, hidden=16):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n_t, rows, 4 * hidden)).astype(np.float32)
    w1, wi2, w2 = ((rng.normal(size=(hidden, 4 * hidden)) * 0.2).astype(np.float32)
                   for _ in range(3))
    b2 = (rng.normal(size=(4 * hidden,)) * 0.2).astype(np.float32)
    mask = ((rng.random((n_t, rows, hidden)) >= 0.2) / 0.8).astype(np.float32)
    ct = rng.normal(size=(n_t, rows, hidden)).astype(np.float32)
    return (x, w1, wi2, b2, w2), mask, ct


def _jax(arrays):
    return [jnp.asarray(a, dtype=jnp.bfloat16) for a in arrays]


def _port(arrays):
    return [torch.from_numpy(np.asarray(a, np.float32)).to(BF16) for a in arrays]


def _np(a):
    return np.asarray(a, np.float32)


PAIR_CASES = [(5, 8), (12, 12), (32, 20)]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("rows,n_t", PAIR_CASES)
def test_pair_forward_and_stashes_match_the_interpret_kernel(rows, n_t, masked):
    """h2s and the h1s, c1s, c2s stashes of the plain bf16 pair (the
    training forward) against the interpret-mode Pallas pair's outputs and
    residuals; the stash-free forward (serving, val) gives the same h2s."""
    args, mask, _ = _case(rows, rows, n_t)
    jm = jnp.asarray(mask, jnp.bfloat16) if masked else None
    pm = _port([mask])[0] if masked else None
    h2s, res = _pair_fwd_pallas(*_jax(args[:1]), jm, *_jax(args[1:]),
                                interpret=True)
    want = [_np(h2s)] + [_np(a)[:, :rows] for a in (res[2], res[3], res[5])]
    got = lk.lstm_pair_ref(*_port(args), pm, return_stash=True)
    assert all(g.dtype == BF16 for g in got)
    for g, w in zip(got, want):
        assert_bf16_close(g, w, ATOL)
    plain = lk.lstm_pair_recurrence(*_port(args), pm)
    assert plain.dtype == BF16
    torch.testing.assert_close(plain, got[0], atol=0, rtol=0)
    assert_bf16_close(plain, _np(jax_pair(*_jax(args), mask=jm,
                                          impl="interpret")), ATOL)


def _port_backward_on(res, rows, ct, args, wgrad_over_rounded=False):
    """The port's bf16 sweep and pass on the JAX kernel's own residuals."""
    x1, mask, h1s, c1s, h2s, c2s = (
        None if a is None else _port([np.asarray(a, np.float32)[:, :rows]])[0]
        for a in res[:6])
    dx1, d_pre1, d_pre2 = lk.lstm_pair_bwd_bf16_ref(
        *_port([ct]), x1, mask, h1s, c1s, h2s, c2s, *_port(args[1:]))
    assert dx1.dtype == BF16 and d_pre1.dtype == d_pre2.dtype == torch.float32
    pass_in = dx1.float() if wgrad_over_rounded else d_pre1
    return dx1, lk.lstm_pair_wgrad_ref(pass_in, d_pre2, h1s, h2s, mask)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("rows,n_t", PAIR_CASES)
def test_pair_backward_matches_the_interpret_kernel_on_its_stashes(rows, n_t,
                                                                   masked):
    """The sweep and the pass on the interpret kernel's own residuals
    against ``_pair_bwd_pallas`` on them: dx1 and the four weight
    gradients, all bf16."""
    args, mask, ct = _case(50 + rows, rows, n_t)
    jm = jnp.asarray(mask, jnp.bfloat16) if masked else None
    _, res = _pair_fwd_pallas(*_jax(args[:1]), jm, *_jax(args[1:]),
                              interpret=True)
    want = _pair_bwd_pallas(True, res, jnp.asarray(ct, jnp.bfloat16))
    dx1, grads = _port_backward_on(res, rows, ct, args)
    assert all(g.dtype == BF16 for g in grads)
    assert_grad_close(dx1, _np(want[0])[:, :rows])
    for g, w in zip(grads, (want[1], want[2], _np(want[3]).reshape(-1), want[4])):
        assert_grad_close(g, _np(w))


@pytest.mark.parametrize("rows", [5, 32])
def test_the_pass_over_f32_d_pre_is_what_meets_the_bar(rows):
    """The guard: dW_hh1 from layer 1's f32 d_pre meets the gradient bar;
    from the rounded dx1 it misses, across many entries (TPU kernel:
    ``dw1_scr += h_prevᵀ d_pre`` over the f32 d_pre)."""
    args, mask, ct = _case(90 + rows, rows, 12)
    _, res = _pair_fwd_pallas(*_jax(args[:1]), jnp.asarray(mask, jnp.bfloat16),
                              *_jax(args[1:]), interpret=True)
    want = _np(_pair_bwd_pallas(True, res, jnp.asarray(ct, jnp.bfloat16))[1])
    _, good = _port_backward_on(res, rows, ct, args)
    assert_grad_close(good[0], want)
    _, bad = _port_backward_on(res, rows, ct, args, wgrad_over_rounded=True)
    diff = np.abs(_np(bad[0].float()) - want)
    beyond = (diff > GRAD_RTOL * np.abs(want).max()) & (diff > _bf16_ulp(want))
    assert beyond.mean() > 0.03, beyond.mean()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("rows,n_t", PAIR_CASES)
def test_pair_gradients_match_jax_grad_in_bf16(rows, n_t, masked):
    """All five gradients through the port's autograd function (bf16
    operands, bf16 gradients) against ``jax.grad`` of the interpret-mode
    pair in bf16 (its custom VJP, ``_pair_bwd_kernel``)."""
    args, mask, ct = _case(70 + rows, rows, n_t)
    jm = jnp.asarray(mask, jnp.bfloat16) if masked else None
    pm = _port([mask])[0] if masked else None

    def objective(*a):
        out = jax_pair(*a, mask=jm, impl="interpret")
        return jnp.sum(out.astype(jnp.float32) * ct)

    want = jax.grad(objective, argnums=(0, 1, 2, 3, 4))(*_jax(args))
    leaves = [t.requires_grad_(True) for t in _port(args)]
    out = lk.lstm_pair_recurrence(*leaves, pm)
    (out.float() * torch.from_numpy(ct)).sum().backward()
    for leaf, w in zip(leaves, want):
        assert leaf.grad.dtype == BF16
        assert_grad_close(leaf.grad, _np(w), ulps=2)


# ------------------------------------------------------------- the encoder

H, F = 16, 3


def _encoders(seed, n_t, dropout=0.0):
    module = JaxEncoder(hidden_size=H, num_layers=2, dropout=dropout,
                        compute_dtype=jnp.bfloat16, kernel_impl="interpret")
    params = module.init(jax.random.key(seed), jnp.zeros((1, n_t, F)))["params"]
    port = LstmEncoder(input_size=F, hidden_size=H, num_layers=2,
                       dropout=dropout, device="cpu", compute_dtype=BF16)
    port.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                params)))
    return module, params, port


def _layer0_bias_reference(params, x, ca, cb):
    """dL/d(b_ih_l0 + b_hh_l0) as the port and a TPU take it: the JAX
    encoder's x_proj cotangent (``jax.vjp`` through the interpret-mode pair
    and the heads, the encoder's own functions) summed over (T, B) in f32
    and rounded to bf16 once. The JAX encoder's own gradient of the bias
    differs: XLA on the CPU reduces the bf16 cotangent of the broadcast add
    in bf16 (measured 1-6% of the largest entry at these shapes)."""
    p, bf = params, jnp.bfloat16
    inputs = jnp.swapaxes(jnp.asarray(x, bf), 0, 1)
    x_proj = inputs @ p["w_ih_l0"].T.astype(bf) + (p["b_ih_l0"] + p["b_hh_l0"]).astype(bf)

    def tail(xp):
        hs = jax_pair(xp, p["w_hh_l0"].T.astype(bf), p["w_ih_l1"].T.astype(bf),
                      (p["b_ih_l1"] + p["b_hh_l1"]).astype(bf),
                      p["w_hh_l1"].T.astype(bf), None, impl="interpret")
        h = hs[-1].astype(jnp.float32)
        alpha = h @ p["alpha_head"]["kernel"] + p["alpha_head"]["bias"]
        beta = h @ p["beta_head"]["kernel"] + p["beta_head"]["bias"]
        return jnp.sum(alpha * ca) + jnp.sum(beta * cb)

    d_proj = _np(jax.grad(tail)(x_proj))
    return torch.from_numpy(d_proj.sum(axis=(0, 1))).to(BF16).float().numpy()


@pytest.mark.parametrize("rows,n_t", [(8, 12), (25, 12), (32, 20)])
def test_encoder_matches_jax_in_bf16(rows, n_t):
    """model=small's shape cut to H=16 (2 layers, one pair): alpha and beta
    against the JAX encoder with ``compute_dtype=bfloat16`` and
    ``kernel_impl="interpret"``, weights through ``params_from_jax``; then
    the gradient of a loss with respect to every parameter (f32, through
    the casts)."""
    module, params, port = _encoders(rows, n_t)
    rng = np.random.default_rng(rows)
    x = rng.normal(size=(rows, n_t, F)).astype(np.float32)
    ca, cb = (rng.normal(size=(rows, 1)).astype(np.float32) for _ in range(2))
    want_a, want_b = module.apply({"params": params}, jnp.asarray(x))
    got_a, got_b = port(torch.from_numpy(x))
    assert got_a.dtype == got_b.dtype == torch.float32
    np.testing.assert_allclose(got_a.detach().numpy(), _np(want_a), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(got_b.detach().numpy(), _np(want_b), atol=ATOL,
                               rtol=0)

    def loss(p):
        a, b = module.apply({"params": p}, jnp.asarray(x))
        return jnp.sum(a * ca) + jnp.sum(b * cb)

    want = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jax.grad(loss)(params)))
    (got_a * torch.from_numpy(ca) + got_b * torch.from_numpy(cb)).sum().backward()
    bias0 = _layer0_bias_reference(params, x, ca, cb)
    for name, p in port.named_parameters():
        assert p.dtype == p.grad.dtype == torch.float32, name
        ref = bias0 if name in ("b_ih_l0", "b_hh_l0") else want[name].numpy()
        assert_grad_close(p.grad, ref, ulps=2)


def test_encoder_masks_are_bf16_and_non_pair_groupings_raise():
    port = LstmEncoder(input_size=F, hidden_size=H, num_layers=2, dropout=0.2,
                       device="cpu", compute_dtype=BF16)
    masks = port.draw_masks(6, 4, torch.Generator().manual_seed(0))
    assert [m.dtype for m in masks] == [BF16]
    assert set(torch.unique(masks[0].float()).tolist()) <= {0.0, 1.25}
    alpha, _ = port(torch.zeros(4, 6, F), deterministic=False,
                    generator=torch.Generator().manual_seed(0))
    assert alpha.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in port.parameters())
    # Since the stack's bf16 kernels, 3 and 4 layers (one stack at this
    # toy shape) run; a grouping with a single layer raises, naming it.
    for layers in (3, 4):
        deep = LstmEncoder(input_size=F, hidden_size=H, num_layers=layers,
                           dropout=0.2, device="cpu", compute_dtype=BF16)
        assert deep.layer_groups(6, 4, True) == [layers]
        alpha, _ = deep(torch.zeros(4, 6, F), deterministic=False,
                        generator=torch.Generator().manual_seed(0))
        assert alpha.dtype == torch.float32 and alpha.shape == (4, 1)
    for layers, hidden, n_t, rows, groups in ((1, H, 6, 4, "[1]"),
                                              (9, H, 6, 4, "[8, 1]"),
                                              (5, 64, 60, 100, "[4, 1]")):
        single = LstmEncoder(input_size=F, hidden_size=hidden,
                             num_layers=layers, dropout=0.3, device="cpu",
                             compute_dtype=BF16)
        with pytest.raises(TypeError, match=rf"group as {re.escape(groups)}"):
            single(torch.zeros(rows, n_t, F), deterministic=False,
                   generator=torch.Generator().manual_seed(0))


def test_the_f32_encoder_casts_nothing():
    """At ``compute_dtype=float32`` the forward adds no cast: a module and
    inputs in f64 (the exact references some checks take) compute and
    return f64, as before bf16 came in."""
    port = LstmEncoder(input_size=F, hidden_size=H, num_layers=2, dropout=0.2,
                       device="cpu").double()
    x = torch.randn(4, 6, F, dtype=torch.float64)
    alpha, beta = port(x, deterministic=False,
                       generator=torch.Generator().manual_seed(0))
    assert alpha.dtype == beta.dtype == torch.float64
    (alpha.sum() + beta.sum()).backward()
    assert all(p.grad.dtype == torch.float64 for p in port.parameters())


# --------------------------------------------- the routes bf16 does not run


def test_bf16_at_other_routes_raises_on_the_cpu():
    """A bf16 projection at the single-layer (resident or time-blocked) or
    replica-axis recurrences raises, naming the queue; nothing converts it
    to f32."""
    (x, w1, wi2, b2, w2), masks, _ = _case(1, 4, 6)
    xb, w1b, wi2b, b2b, w2b = _port((x, w1, wi2, b2, w2))
    long_x = torch.zeros((252, 100, 4 * 64), dtype=BF16)
    long_w = torch.zeros((64, 4 * 64), dtype=BF16)
    calls = {
        "single layer": lambda: lk.lstm_recurrence(xb, w1b),
        "time-blocked": lambda: lk.lstm_recurrence(long_x, long_w),
        "pair's replica axis": lambda: lk.lstm_pair_recurrence_stacked(
            *(t[None] for t in (xb, w1b, wi2b, b2b, w2b))),
        "single layer's replica axis": lambda: lk.lstm_recurrence_stacked(
            xb[None], w1b[None]),
        "stack's replica axis": lambda: lk.lstm_stack_recurrence_stacked(
            xb[None], ((w1b[None],) * 3, (wi2b[None],) * 2, (b2b[None],) * 2)),
    }
    assert lk.single_layer_route(252, 100, 64) == "pallas-timeblocked"
    for route, call in calls.items():
        with pytest.raises(TypeError, match="queue 2"):
            call()


# ---------------------------------------------------- grouping at itemsize 2

ROWS = (25, 72, 88, 100, 200)
WINDOWS = (None, 25, 100)


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("n_t", [60, 61, 120])
@pytest.mark.parametrize("n_layers", [2, 3, 4, 8])
def test_grouping_matches_jax_at_both_itemsizes(n_layers, n_t, itemsize):
    """``stack_fits`` and ``fused_depth`` against the JAX predicates at
    itemsize 4 and 2, over rows, windows and masks, at H=64 and H=16."""
    for hidden in (64, 16):
        for rows in ROWS:
            for has_mask in (False, True):
                for depth in range(2, n_layers + 1):
                    assert lk.stack_fits(n_t, rows, hidden, depth, has_mask,
                                         itemsize) == jax_stack_fits(
                        n_t, rows, hidden, depth, has_mask, itemsize)
                assert fused_depth(n_layers, n_t, rows, hidden, has_mask,
                                   itemsize=itemsize) == max_wavefront_depth(
                    n_t, rows, hidden, n_layers, has_mask, itemsize)
                for window in WINDOWS:
                    def fits(depth):
                        return jax_stack_fits(
                            n_t, rows, hidden, depth, has_mask, itemsize) or (
                            jax_window_schedulable(rows, window)
                            and jax_stack_fits(n_t, window, hidden, depth,
                                               has_mask, itemsize))

                    depth = 1
                    while depth < n_layers and fits(depth + 1):
                        depth += 1
                    assert fused_depth(n_layers, n_t, rows, hidden, has_mask,
                                       window, itemsize) == depth


def _jax_groups(monkeypatch, n_layers, n_t, rows, has_mask, window_rows,
                hidden=64):
    """The depths of the groups the JAX encoder runs in bf16, recorded
    from its calls into the recurrences (which return zeros here)."""
    monkeypatch.delenv("MT_LSTM_FUSED_PAIR", raising=False)
    monkeypatch.delenv("MT_LSTM_WAVEFRONT", raising=False)
    groups = []

    def record(depth):
        def fake(x_proj, *args, **kwargs):
            groups.append(depth)
            return jnp.zeros(x_proj.shape[:2] + (hidden,), x_proj.dtype)
        return fake

    monkeypatch.setattr(jax_lstm, "lstm_recurrence", record(1))
    monkeypatch.setattr(jax_lstm, "lstm_pair_recurrence", record(2))
    monkeypatch.setattr(jax_lstm, "lstm_stack_recurrence",
                        lambda x_proj, weights, *a, **k: record(len(weights[0]))(x_proj))
    module = JaxEncoder(hidden_size=hidden, num_layers=n_layers,
                        dropout=0.3 if has_mask else 0.0,
                        compute_dtype=jnp.bfloat16, kernel_impl="interpret")
    x = jnp.zeros((rows, n_t, 3), jnp.float32)
    params = module.init(jax.random.key(0), x[:1])["params"]
    groups.clear()
    module.apply({"params": params}, x, deterministic=False,
                 window_rows=window_rows, rngs={"dropout": jax.random.key(1)})
    return groups


@pytest.mark.parametrize("n_layers,n_t,rows,has_mask,window_rows,want", [
    (2, 60, 100, True, None, [2]),   # model=small training: a pair, as in f32
    (2, 60, 800, False, 100, [2]),   # model=small, 8 windows
    (2, 60, 25, True, None, [2]),    # model=small on the Fama-French portfolios
    (4, 60, 100, True, None, [4]),   # model=medium: one stack (f32: pairs)
    (8, 60, 25, True, None, [8]),    # model=large (f32: [7, 1])
    (2, 252, 100, True, None, [1, 1]),  # a one-year lookback
])
def test_encoder_groups_at_itemsize_2_as_jax_does(monkeypatch, n_layers, n_t,
                                                  rows, has_mask, window_rows,
                                                  want):
    port = LstmEncoder(hidden_size=64, num_layers=n_layers, device="cpu",
                       compute_dtype=BF16)
    got = port.layer_groups(n_t, rows, has_mask, window_rows)
    assert got == want
    assert got == _jax_groups(monkeypatch, n_layers, n_t, rows, has_mask,
                              window_rows)


# ------------------------------------------------------------------ slice


def _slice_data(tmp_path):
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
    return dm, jdm, windows


#: Per-step (per-epoch: one full-batch step an epoch) losses and the test
#: metrics, bf16 port against bf16 JAX.
SLICE_RTOL = 1e-5


@pytest.mark.parametrize("objective", ["mse", "nll", "combined"])
def test_bf16_fit_and_test_match_the_jax_trainer(tmp_path, capsys, objective):
    """``Trainer(precision="bf16-mixed")``'s epoch curve (5 full-batch
    steps, dropout 0) and ``test`` metrics against the JAX trainer at the
    same precision with ``kernel_impl="interpret"``, from the same initial
    weights; the JAX bf16-vs-f32 gap at the same size is printed beside.
    The checkpointed parameters stay f32, and ``params_from_jax`` carries
    the JAX bf16 run's weights over unchanged."""
    dm, jdm, windows = _slice_data(tmp_path)
    hparams = dict(objective=objective, hidden_size=8, num_layers=2,
                   dropout=0.0, learning_rate=1e-3)
    jspec = JaxSpec(kernel_impl="interpret", **hparams)
    spec = ModelSpec(**hparams)
    params = jspec.build_module().init(
        jax.random.key(1), jnp.zeros((1, windows["lookback_window"], 3)))["params"]
    init = jax.tree_util.tree_map(np.asarray, params)

    def jax_run(precision):
        trainer = JaxTrainer(max_epochs=5, gradient_clip_val=CLIP,
                             strategy="single_device", precision=precision,
                             enable_progress_bar=False,
                             enable_model_summary=False)
        return trainer, trainer.fit(jspec, jdm, init_state=(init, None))

    jtrainer, want = jax_run("bf16-mixed")
    _, want_f32 = jax_run("32-true")
    trainer = Trainer(max_epochs=5, gradient_clip_val=CLIP, device="cpu",
                      precision="bf16-mixed", ckpt_dir=tmp_path / "ckpt")
    got = trainer.fit(spec, dm, init_state=(params_from_jax(init), None))

    key = "loss/total/train"
    gaps = [abs(g[key] - w[key]) / abs(w[key])
            for g, w in zip(got.history, want.history)]
    f32_gaps = [abs(w[key] - f[key]) / abs(f[key])
                for w, f in zip(want.history, want_f32.history)]
    with capsys.disabled():
        print(f"\nbf16 {objective}: port vs JAX max rel gap {max(gaps):.3g}; "
              f"JAX bf16 vs f32 {max(f32_gaps):.3g}")
    assert len(got.history) == len(want.history) == 5
    for g, w in zip(got.history, want.history):
        assert set(g) == set(w)
        for k in g:
            assert g[k] == pytest.approx(w[k], rel=SLICE_RTOL, abs=0), k
    assert max(f32_gaps) > max(gaps)

    final = params_from_jax(jax.tree_util.tree_map(np.asarray, want.params))
    assert all(v.dtype == torch.float32 for v in final.values())
    assert all(v.dtype == torch.float32 for v in got.state.values())
    got_test = trainer.test(spec, final, dm)
    want_test = jtrainer.test(jspec, want.params, jdm)
    assert set(got_test) == set(want_test) == {"mse", "nll", "mae", "total"}
    for k, value in want_test.items():
        assert got_test[k] == pytest.approx(value, rel=SLICE_RTOL, abs=0), k


def test_precision_auto_resolves_to_f32_on_both_sides(tmp_path):
    dm, jdm, _ = _slice_data(tmp_path)
    spec = ModelSpec(objective="mse", hidden_size=8)
    trainer = Trainer(max_epochs=1, device="cpu", precision="auto")
    assert trainer.resolve_dtype(spec, dm) == torch.float32
    jtrainer = JaxTrainer(max_epochs=1, precision="auto",
                          strategy="single_device")
    assert jtrainer._resolve_dtype(JaxSpec(objective="mse", hidden_size=8),
                                   jdm) == jnp.float32
    for precision, dtype in (("32-true", torch.float32), ("32", torch.float32),
                             ("fp32", torch.float32), ("bf16", BF16),
                             ("bf16-mixed", BF16)):
        assert Trainer(max_epochs=1, device="cpu",
                       precision=precision).resolve_dtype(spec, dm) == dtype
    with pytest.raises(ValueError, match="unknown precision"):
        Trainer(max_epochs=1, device="cpu", precision="16-mixed")


@pytest.mark.parametrize("wins,layers,hidden,rows,device,want", [
    ((), 2, 64, 200, "cuda", torch.float32),        # no recorded win
    (((2, 64),), 2, 64, 200, "cuda", BF16),         # [1, 1] -> [2]
    (((2, 64),), 4, 64, 200, "cuda", BF16),         # [1]*4 -> [2, 2]
    (((2, 64),), 2, 64, 100, "cuda", torch.float32),  # [2] either way
    (((2, 64),), 4, 64, 100, "cuda", BF16),         # [2, 2] -> [4], the stack
    (((2, 64),), 5, 64, 100, "cuda", torch.float32),  # [4, 1]: a single layer
    (((2, 64),), 2, 32, 200, "cuda", torch.float32),  # another width
    (((2, 64),), 2, 64, 200, "cpu", torch.float32),   # the CPU
])
def test_precision_auto_takes_bf16_only_where_a_card_win_is_recorded(
        monkeypatch, wins, layers, hidden, rows, device, want):
    """The ``auto`` policy over a recorded win (T=60): bf16 on the card
    only where itemsize 2 fuses a deeper wavefront over the window's rows
    and no group at itemsize 2 is a single layer; f32 otherwise."""
    import masters_thesis_tpu_torch.models.lstm as port_lstm

    monkeypatch.setattr(port_lstm, "MEASURED_BF16_WAVEFRONT_WINS", wins)
    assert port_lstm.preferred_compute_dtype(
        layers, hidden, 60, rows, device=device) == want


def test_precision_auto_reads_the_windows_rows(tmp_path, monkeypatch):
    """``resolve_dtype`` asks the policy at the set-up datamodule's own
    lookback and rows a window, not an assumed 100."""
    import masters_thesis_tpu_torch.train.trainer as port_trainer

    dm, _, windows = _slice_data(tmp_path)
    seen = []
    monkeypatch.setattr(
        port_trainer, "preferred_compute_dtype",
        lambda *args, **kwargs: seen.append(args) or torch.float32)
    spec = ModelSpec(objective="mse", hidden_size=8)
    Trainer(max_epochs=1, device="cpu",
            precision="auto").resolve_dtype(spec, dm)
    assert seen == [(spec.num_layers, 8, windows["lookback_window"], 4)]


def test_no_model_changes_the_reduced_precision_flag(monkeypatch):
    """Building and running an encoder, f32 or bf16, forward and backward,
    leaves cuBLAS's bf16 reduced-precision reduction flag as it was; the
    bf16 projection's products, forward and backward, run with it off."""
    matmul = torch.backends.cuda.matmul
    before = matmul.allow_bf16_reduced_precision_reduction
    seen, plain_matmul = [], torch.matmul

    def spy(a, b, *args, **kwargs):
        if a.dtype == BF16:
            seen.append(matmul.allow_bf16_reduced_precision_reduction)
        return plain_matmul(a, b, *args, **kwargs)

    monkeypatch.setattr(torch, "matmul", spy)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (6, 12, 3)).astype(np.float32))
    for dtype in (torch.float32, BF16):
        enc = LstmEncoder(hidden_size=16, device="cpu", compute_dtype=dtype,
                          generator=torch.Generator().manual_seed(0))
        alpha, beta = enc(x, deterministic=False,
                          generator=torch.Generator().manual_seed(1))
        (alpha.sum() + beta.sum()).backward()
        assert matmul.allow_bf16_reduced_precision_reduction == before
    assert seen and not any(seen)  # the forward's and d_inputs' products


def test_cost_model_counts_bf16_planes_at_two_bytes():
    """``kernel_cost`` and ``cost_of_step`` at itemsize 2: the pair's planes
    and weights at 2 bytes, the d_pre planes the sweep hands the pass at 4
    (layer 1's written twice, rounded and in f32); the operations and the
    f32 counts unchanged; the step's launches under the ``_bf16`` names."""
    from masters_thesis_tpu_torch.telemetry import costs

    rows, n_t, hidden = 100, 60, 64
    plane_h, plane_x = n_t * rows * hidden, n_t * rows * 4 * hidden
    weight, bias = hidden * 4 * hidden, 4 * hidden
    for name in ("lstm_pair_fwd", "lstm_pair_fwd_masked", "lstm_pair_bwd",
                 "lstm_wgrad"):
        f32 = costs.kernel_cost(name, rows, n_t, hidden)
        bf16 = costs.kernel_cost(name, rows, n_t, hidden, itemsize=2)
        assert bf16[0] == f32[0]
        assert bf16[1] < f32[1]
    assert costs.kernel_cost("lstm_pair_bwd", rows, n_t, hidden, itemsize=2)[1] == (
        2 * (6 * plane_h + 2 * plane_x + 3 * weight + bias) + 4 * 2 * plane_x)
    assert costs.kernel_cost("lstm_wgrad", rows, n_t, hidden, itemsize=2)[1] == (
        4 * 2 * plane_x + 2 * (3 * plane_h + 3 * weight + bias))
    assert costs.kernel_cost("lstm_pair_fwd_masked", rows, n_t, hidden,
                             itemsize=2)[1] == 2 * (plane_x + 5 * plane_h
                                                    + 3 * weight + bias)
    spec = ModelSpec(objective="mse")
    f32 = costs.cost_of_step(spec, rows, n_t, window_rows=rows)
    bf16 = costs.cost_of_step(spec, rows, n_t, window_rows=rows, itemsize=2)
    assert f32["kernels"] == {"lstm_pair_fwd_masked": 1, "lstm_pair_bwd": 1,
                              "lstm_wgrad": 1}
    assert bf16["kernels"] == {"lstm_pair_fwd_masked_bf16": 1,
                               "lstm_pair_bwd_bf16": 1, "lstm_wgrad_bf16": 1}
    assert bf16["groups"] == f32["groups"]
    assert bf16["flops"] == f32["flops"] and bf16["bytes"] < f32["bytes"]
    # The stack (model=medium's depth): planes and weights at 2 bytes; its
    # sweep writes dx1 at 2 and the L f32 d_pre planes at 4.
    n = 4
    params = (2 * n - 1) * weight + (n - 1) * bias
    for name in ("lstm_stack_fwd", "lstm_stack_fwd_masked", "lstm_stack_bwd",
                 "lstm_wgrad_stack"):
        f32 = costs.kernel_cost(name, rows, n_t, hidden, n_layers=n)
        bf16 = costs.kernel_cost(name, rows, n_t, hidden, n_layers=n,
                                 itemsize=2)
        assert bf16[0] == f32[0]
        assert bf16[1] < f32[1]
    assert costs.kernel_cost("lstm_stack_bwd", rows, n_t, hidden, n_layers=n)[1] == (
        4 * (3 * n * plane_h + (n + 1) * plane_x + params))
    assert costs.kernel_cost("lstm_stack_bwd", rows, n_t, hidden, n_layers=n,
                             itemsize=2)[1] == (
        2 * (3 * n * plane_h + 2 * plane_x + params) + 4 * n * plane_x)
    assert costs.kernel_cost("lstm_stack_fwd_masked", rows, n_t, hidden,
                             n_layers=n, itemsize=2)[1] == 2 * (
        plane_x + (3 * n - 1) * plane_h + params)
    assert costs.kernel_cost("lstm_wgrad_stack", rows, n_t, hidden, n_layers=n,
                             itemsize=2)[1] == (
        4 * n * plane_x + 2 * ((2 * n - 1) * plane_h + params))
    medium = ModelSpec(objective="mse", num_layers=4, dropout=0.3)
    f32 = costs.cost_of_step(medium, rows, n_t, window_rows=rows)
    bf16 = costs.cost_of_step(medium, rows, n_t, window_rows=rows, itemsize=2)
    assert [g["depth"] for g in f32["groups"]] == [2, 2]
    assert [g["depth"] for g in bf16["groups"]] == [4]
    assert bf16["kernels"] == {"lstm_stack_fwd_masked_bf16": 1,
                               "lstm_stack_bwd_bf16": 1,
                               "lstm_wgrad_stack_bf16": 1}
    evaluation = costs.cost_of_step(medium, 32 * rows, n_t, window_rows=rows,
                                    training=False, itemsize=2)
    assert evaluation["kernels"] == {"lstm_stack_fwd_bf16": 1}


@pytest.mark.parametrize("overrides,accepted", [
    ([], True),                                   # model=small, synthetic
    (["datamodule=real"], True),                  # 25 portfolios: a pair
    (["trainer.epoch_mode=stream", "loss=nll"], True),
    (["trainer.precision=bf16"], True),
    (["trainer.precision=auto", "model=medium"], True),  # auto is f32
    (["model=medium"], True),                     # [4] at itemsize 2
    (["model=large"], True),                      # [4, 4] / [6, 2]
    (["datamodule=real", "model=medium"], True),  # [4]
    (["datamodule=real", "model=large"], True),   # [8]
    (["model.num_layers=5"], False),              # [4, 1]
    (["model.num_layers=7"], False),              # [4, 3] / [6, 1]
    (["datamodule=universe", "model=kfactor"], False),   # [1, 1]
    (["datamodule.lookback_window=252"], False),  # [1, 1]
])
def test_the_driver_takes_bf16_where_the_layers_pair(overrides, accepted):
    """``check_supported`` at ``trainer.precision=bf16-mixed``: the
    configurations whose groups at itemsize 2 are pairs or stacks pass,
    those with a single-layer group are refused by key; the stacked entry
    point (f32 whatever the precision) checks the value only."""
    from masters_thesis_tpu_torch.cli.train import check_supported, compose_config

    cfg = compose_config(["trainer.precision=bf16-mixed", *overrides])
    if accepted:
        check_supported(cfg)
    else:
        with pytest.raises(ValueError, match=r"^trainer\.precision=bf16"):
            check_supported(cfg)
    check_supported(cfg, precision_shapes=False)
