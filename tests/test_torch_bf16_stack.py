"""``trainer.precision=bf16-mixed`` on the L-deep stack: the port against
the JAX package's bf16 compute dtype.

The reference is the interpret-mode Pallas stack in bf16 (``impl`` and
``kernel_impl="interpret"``). Both sides do f32 arithmetic on bf16
operands, carry h and c in f32, build each seam from the f32 h times the
mask and round what they store; the backward recomputes the gates from the
rounded stashes and sums the weight gradients over f32 d_pre. The bars are
``tests/test_torch_bf16.py``'s: 1e-5 abs or one bf16 ulp of the reference
entry for forwards (a rounding flip, where the two sides' f32 values fall
on both sides of a bf16 boundary), 2e-5 of the largest entry or one ulp
for the sweep on the JAX kernel's own stashes, two ulps through
``jax.grad`` end to end. The stack at depth 8 meets them too: a flipped
stash feeds the layer above's recomputed gates, but no case here needs a
wider bar.

The encoder runs at 4 layers over 640 rows of 8 steps at H=64, the
smallest toy shape whose groups are one stack ``[4]`` at itemsize 2 and
pairs ``[2, 2]`` at itemsize 4. Its heads read the bf16 top layer's last
h in f32, so a one-ulp flip of an h entry moves alpha and beta by that
ulp times the head's weight: each head output is held to 1e-5 plus the
sum over its row's h entries of ``|weight| * ulp(h)``, the most one-ulp
flips can move it. Its parameter gradients meet the two-ulp bar except
at a few entries of the top layer's weights, which the bar below admits:
at most 4 entries an output beyond two ulps, each within 16. Measured: 2
of 16,384 in ``w_ih_l3`` (worst 7 ulps) and 2 in ``w_hh_l3`` (worst 10),
every other weight within two ulps. Cause: rounding flips grow with
depth, as each flip moves the f32 seam into the layers above (on a
random 4-deep stack at this shape 22, 64, 87 and 75 of 327,680 h stash
entries flip, layer 0 to 3), and the top layer's recomputed gates read
the most of them; where a weight-gradient entry is a sum that cancels, a
changed term is many of its ulps. The layer-0 biases are not compared
(below). The ``Trainer`` runs a toy ``model=medium`` (4 layers,
H=8, one stack at both itemsizes) against the JAX ``Trainer`` at 1e-5
relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masters_thesis_tpu.models.lstm import LstmEncoder as JaxEncoder
from masters_thesis_tpu.models.objectives import ModelSpec as JaxSpec
from masters_thesis_tpu.ops.lstm_kernel import (
    _stack_bwd_pallas,
    _stack_fwd_pallas,
    lstm_stack_recurrence as jax_stack,
)
from masters_thesis_tpu.train.trainer import Trainer as JaxTrainer
from masters_thesis_tpu_torch.models.convert import params_from_jax
from masters_thesis_tpu_torch.models.lstm import LstmEncoder
from masters_thesis_tpu_torch.models.objectives import ModelSpec
from masters_thesis_tpu_torch.ops import lstm_kernel as lk
from masters_thesis_tpu_torch.train.trainer import Trainer
from test_torch_bf16 import (
    ATOL,
    BF16,
    CLIP,
    GRAD_RTOL,
    SLICE_RTOL,
    _bf16_ulp,
    _slice_data,
    assert_bf16_close,
    assert_grad_close,
)

T, H = 8, 16


def _case(seed, n_layers, rows, n_t=T, hidden=H):
    """numpy x1_proj, weights ``(w_hh, w_in, biases)``, masks (p = 0.2)
    and a cotangent of the top layer's h."""
    rng = np.random.default_rng(seed)

    def weight(shape):
        return (rng.normal(size=shape) * 0.2).astype(np.float32)

    x = rng.normal(size=(n_t, rows, 4 * hidden)).astype(np.float32)
    weights = ([weight((hidden, 4 * hidden)) for _ in range(n_layers)],
               [weight((hidden, 4 * hidden)) for _ in range(n_layers - 1)],
               [weight((4 * hidden,)) for _ in range(n_layers - 1)])
    masks = [((rng.random((n_t, rows, hidden)) >= 0.2) / 0.8).astype(np.float32)
             for _ in range(n_layers - 1)]
    ct = rng.normal(size=(n_t, rows, hidden)).astype(np.float32)
    return x, weights, masks, ct


def _jax(x, weights, masks):
    bf = jnp.bfloat16
    return (jnp.asarray(x, bf),
            tuple(tuple(jnp.asarray(a, bf) for a in g) for g in weights),
            None if masks is None else tuple(jnp.asarray(m, bf) for m in masks))


def _port(x, weights, masks):
    def bf(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(BF16)

    return (bf(x), [[bf(a) for a in g] for g in weights],
            None if masks is None else [bf(m) for m in masks])


def _np(a):
    return np.asarray(a, np.float32)


# Depths 3, 4 and 8; 5 to 32 rows; 8 to 20 steps; masked and not.
STACK_CASES = [(3, 5, 8, True), (3, 32, 20, False), (4, 25, 12, True),
               (4, 12, 20, False), (8, 7, 8, True), (8, 32, 12, False)]


@pytest.mark.parametrize("n_layers,rows,n_t,masked", STACK_CASES)
def test_stack_forward_and_stashes_match_the_interpret_kernel(n_layers, rows,
                                                              n_t, masked):
    """Every layer's h and c stash of the plain bf16 stack (the training
    forward) against the interpret-mode Pallas stack's residuals, and the
    stash-free forward (serving, validation) against its output."""
    x, w, m, _ = _case(n_layers * 100 + rows, n_layers, rows, n_t)
    m = m if masked else None
    jx, jw, jm = _jax(x, w, m)
    px, pw, pm = _port(x, w, m)
    top, res = _stack_fwd_pallas(jx, jm, *jw, interpret=True)
    hs, cs = lk.lstm_stack_ref(px, *pw, pm, return_stash=True)
    assert len(hs) == len(cs) == n_layers
    for got, want in ((hs, res[2]), (cs, res[3])):
        for g, w_ in zip(got, want):
            assert g.dtype == BF16
            assert_bf16_close(g, _np(w_)[:, :rows], ATOL)
    plain = lk.lstm_stack_recurrence(px, pw, pm)
    assert plain.dtype == BF16
    torch.testing.assert_close(plain, hs[-1], atol=0, rtol=0)
    assert_bf16_close(plain, _np(top), ATOL)
    assert_bf16_close(plain, _np(jax_stack(jx, jw, jm, impl="interpret")), ATOL)


@pytest.mark.parametrize("n_layers,rows,n_t,masked", STACK_CASES)
def test_stack_sweep_matches_the_interpret_kernel_on_its_stashes(
        n_layers, rows, n_t, masked):
    """The bf16 sweep and the pass over its 2L - 1 jobs on the interpret
    kernel's own residuals against ``_stack_bwd_pallas`` on them: dx1
    (bf16, layer 0's d_pre rounded), every dW_hh, dW_in and db (bf16)."""
    x, w, m, ct = _case(n_layers * 100 + rows + 1, n_layers, rows, n_t)
    m = m if masked else None
    jx, jw, jm = _jax(x, w, m)
    _, res = _stack_fwd_pallas(jx, jm, *jw, interpret=True)
    want_dx1, want_w, _ = _stack_bwd_pallas(True, res,
                                            jnp.asarray(ct, jnp.bfloat16))

    def port(a):
        return torch.from_numpy(_np(a)[:, :rows]).to(BF16)

    hs, cs = [port(h) for h in res[2]], [port(c) for c in res[3]]
    _, pw, pm = _port(x, w, m)
    dx1, d_pres = lk.lstm_stack_bwd_bf16_ref(
        torch.from_numpy(ct).to(BF16), port(res[0]), pm, hs, cs, *pw)
    assert dx1.dtype == BF16 and len(d_pres) == n_layers
    assert all(d.dtype == torch.float32 for d in d_pres)
    torch.testing.assert_close(dx1, d_pres[0].to(BF16), atol=0, rtol=0)
    assert_grad_close(dx1, _np(want_dx1)[:, :rows])
    got_w = lk.lstm_stack_wgrad(d_pres, hs, pm)
    for got_group, want_group in zip(got_w, want_w):
        assert len(got_group) == len(want_group)
        for g, w_ in zip(got_group, want_group):
            assert g.dtype == BF16
            assert_grad_close(g, _np(w_).reshape(g.shape))


@pytest.mark.parametrize("n_layers,rows,n_t,masked", STACK_CASES)
def test_stack_gradients_match_jax_grad_in_bf16(n_layers, rows, n_t, masked):
    """dx1 and every weight gradient through the port's autograd function
    (bf16 operands, bf16 gradients) against ``jax.grad`` of the
    interpret-mode stack in bf16 (its custom VJP, ``_stack_bwd_kernel``)."""
    x, w, m, ct = _case(n_layers * 100 + rows + 2, n_layers, rows, n_t)
    m = m if masked else None
    jx, jw, jm = _jax(x, w, m)
    want = jax.grad(
        lambda a, ws: jnp.sum(jax_stack(a, ws, jm, impl="interpret")
                              .astype(jnp.float32) * ct),
        argnums=(0, 1))(jx, jw)
    px, pw, pm = _port(x, w, m)
    leaves = [px] + [t for group in pw for t in group]
    for t in leaves:
        t.requires_grad_(True)
    out = lk.lstm_stack_recurrence(px, pw, pm)
    (out.float() * torch.from_numpy(ct)).sum().backward()
    assert px.grad.dtype == BF16
    assert_grad_close(px.grad, _np(want[0]), ulps=2)
    for group, want_group in zip(pw, want[1]):
        for t, g in zip(group, want_group):
            assert t.grad.dtype == BF16
            assert_grad_close(t.grad, _np(g), ulps=2)


# ------------------------------------------------------------- the encoder

F, ENC_T, ENC_ROWS, ENC_H = 3, 8, 640, 64
#: The encoder's gradient bar beyond two ulps (the module docstring).
ENC_OUTLIERS, ENC_OUTLIER_ULPS = 4, 16


def _assert_encoder_grad_close(got, want):
    """2e-5 of the largest entry or two ulps, except at most ENC_OUTLIERS
    entries, each within ENC_OUTLIER_ULPS ulps."""
    got = got.double().numpy()
    want = np.asarray(want, np.float64)
    diff = np.abs(got - want)
    ulp = _bf16_ulp(want)
    beyond = (diff > GRAD_RTOL * np.abs(want).max()) & (diff > 2 * ulp)
    assert beyond.sum() <= ENC_OUTLIERS, (int(beyond.sum()), diff.max())
    assert (diff[beyond] <= ENC_OUTLIER_ULPS * ulp[beyond]).all(), (
        (diff[beyond] / ulp[beyond]).max())


def _head_bar(port, x):
    """1e-5 plus, for each row and head output, ``sum_k |W[o, k]| *
    ulp(h[k])`` over the row's last h (bf16, read by the f32 heads): the
    most one-ulp flips of the h entries can move that output."""
    seen = {}

    def keep(_, args):
        seen["h"] = args[0].detach().double()

    hook = port.alpha_head.register_forward_pre_hook(keep)
    with torch.no_grad():
        port(x)
    hook.remove()
    ulp = torch.from_numpy(_bf16_ulp(seen["h"].numpy()))
    return tuple(ATOL + (ulp @ head.weight.detach().double().abs().T).numpy()
                 for head in (port.alpha_head, port.beta_head))


def test_encoder_matches_jax_in_bf16_as_one_stack():
    """model=medium's depth at H=64 over 640 rows of 8 steps: one 4-deep
    stack at itemsize 2 where f32 runs two pairs. alpha and beta against
    the JAX encoder with ``compute_dtype=bfloat16`` and
    ``kernel_impl="interpret"``, weights through ``params_from_jax``; then
    the gradient of a loss with respect to every recurrence and head
    weight (f32, through the casts)."""
    module = JaxEncoder(hidden_size=ENC_H, num_layers=4, dropout=0.0,
                        compute_dtype=jnp.bfloat16, kernel_impl="interpret")
    params = module.init(jax.random.key(4), jnp.zeros((1, ENC_T, F)))["params"]
    port = LstmEncoder(input_size=F, hidden_size=ENC_H, num_layers=4,
                       dropout=0.0, device="cpu", compute_dtype=BF16)
    port.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                params)))
    assert port.layer_groups(ENC_T, ENC_ROWS, False) == [4]
    assert LstmEncoder(input_size=F, hidden_size=ENC_H, num_layers=4,
                       device="cpu").layer_groups(ENC_T, ENC_ROWS, False) == [2, 2]
    rng = np.random.default_rng(4)
    x = rng.normal(size=(ENC_ROWS, ENC_T, F)).astype(np.float32)
    ca, cb = (rng.normal(size=(ENC_ROWS, 1)).astype(np.float32)
              for _ in range(2))
    want_a, want_b = module.apply({"params": params}, jnp.asarray(x))
    lk.reset_launch_counts()
    got_a, got_b = port(torch.from_numpy(x))
    assert got_a.dtype == got_b.dtype == torch.float32
    bar_a, bar_b = _head_bar(port, torch.from_numpy(x))
    for got, want, bar in ((got_a, want_a, bar_a), (got_b, want_b, bar_b)):
        diff = np.abs(got.detach().numpy().astype(np.float64) - _np(want))
        assert (diff <= bar).all(), (diff.max(), (diff > bar).sum())

    def loss(p):
        a, b = module.apply({"params": p}, jnp.asarray(x))
        return jnp.sum(a * ca) + jnp.sum(b * cb)

    want_g = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jax.grad(loss)(params)))
    (got_a * torch.from_numpy(ca) + got_b * torch.from_numpy(cb)).sum().backward()
    checked = 0
    for name, p in port.named_parameters():
        assert p.dtype == p.grad.dtype == torch.float32, name
        # The layer-0 biases: XLA on the CPU reduces the JAX encoder's bf16
        # cotangent of the broadcast add in bf16 (tests/test_torch_bf16.py,
        # _layer0_bias_reference); the port sums it in f32.
        if name in ("b_ih_l0", "b_hh_l0"):
            continue
        _assert_encoder_grad_close(p.grad, want_g[name].numpy())
        checked += 1
    assert checked == len(list(port.parameters())) - 2


# ------------------------------------------------------------------ slice


def test_bf16_medium_fit_and_test_match_the_jax_trainer(tmp_path):
    """``Trainer(precision="bf16-mixed")`` at a toy model=medium (4 layers,
    one stack, dropout 0): the epoch curve (5 full-batch steps) and the
    ``test`` metrics against the JAX trainer at the same precision with
    ``kernel_impl="interpret"``, from the same initial weights."""
    dm, jdm, windows = _slice_data(tmp_path)
    hparams = dict(objective="mse", hidden_size=8, num_layers=4, dropout=0.0,
                   learning_rate=1e-3)
    jspec = JaxSpec(kernel_impl="interpret", **hparams)
    spec = ModelSpec(**hparams)
    params = jspec.build_module().init(
        jax.random.key(2), jnp.zeros((1, windows["lookback_window"], 3)))["params"]
    init = jax.tree_util.tree_map(np.asarray, params)
    jtrainer = JaxTrainer(max_epochs=5, gradient_clip_val=CLIP,
                          strategy="single_device", precision="bf16-mixed",
                          enable_progress_bar=False, enable_model_summary=False)
    want = jtrainer.fit(jspec, jdm, init_state=(init, None))
    trainer = Trainer(max_epochs=5, gradient_clip_val=CLIP, device="cpu",
                      precision="bf16-mixed", ckpt_dir=tmp_path / "ckpt")
    module = spec.build_module(device="cpu", compute_dtype=BF16)
    assert module.layer_groups(windows["lookback_window"],
                               len(dm.train_range) * 4, False) == [4]
    got = trainer.fit(spec, dm, init_state=(params_from_jax(init), None))
    assert len(got.history) == len(want.history) == 5
    for g, w in zip(got.history, want.history):
        assert set(g) == set(w)
        for k in g:
            assert g[k] == pytest.approx(w[k], rel=SLICE_RTOL, abs=0), k
    assert all(v.dtype == torch.float32 for v in got.state.values())
    final = params_from_jax(jax.tree_util.tree_map(np.asarray, want.params))
    got_test = trainer.test(spec, final, dm)
    want_test = jtrainer.test(jspec, want.params, jdm)
    assert set(got_test) == set(want_test)
    for k, value in want_test.items():
        assert got_test[k] == pytest.approx(value, rel=SLICE_RTOL, abs=0), k
