"""The port's L-deep stack, its grouping rule, and model=medium-shaped
encoders and training against the JAX package's.

On the CPU the port's stack runs its plain versions: the forward is held
against the JAX Pallas stack kernel in interpret mode and the scan
reference, the gradients against ``jax.grad`` of the interpret-mode kernel
(its custom VJP, ``_stack_bwd_kernel``), on the same numpy inputs.
Tolerances: 1e-5 abs for forwards (f32 on both sides, summed in another
order over at most 8 + 7 dependent steps), 2e-5 abs for gradients, which add
the reverse sweep and sums over rows and steps. The trajectory keeps
tests/test_torch_train.py's tolerances: 1e-5 relative on losses, 1e-6 abs on
parameters.

The CUDA kernels are held against these plain versions on the card in
tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import masters_thesis_tpu.models.lstm as jax_lstm
from masters_thesis_tpu.data.pipeline import Batch as JaxBatch
from masters_thesis_tpu.models.lstm import LstmEncoder as JaxEncoder
from masters_thesis_tpu.models.objectives import ModelSpec as JaxSpec
from masters_thesis_tpu.ops.lstm_kernel import (
    _stack_fwd_pallas,
    lstm_stack_recurrence as jax_stack,
    lstm_stack_xla,
    max_wavefront_depth,
    stack_fits as jax_stack_fits,
    window_schedulable as jax_window_schedulable,
)
from masters_thesis_tpu.parallel import make_data_mesh
from masters_thesis_tpu.train.flatparams import FlatAdam as JaxFlatAdam
from masters_thesis_tpu.train.steps import forward_rows as jax_forward_rows
from masters_thesis_tpu.train.steps import make_train_step
from masters_thesis_tpu_torch.data.pipeline import Batch
from masters_thesis_tpu_torch.models.convert import params_from_jax
from masters_thesis_tpu_torch.models.lstm import LstmEncoder, fused_depth
from masters_thesis_tpu_torch.models.objectives import ModelSpec, batched_objective
from masters_thesis_tpu_torch.ops import lstm_kernel as lk
from masters_thesis_tpu_torch.train.flatparams import FlatAdam
from masters_thesis_tpu_torch.train.steps import forward_rows, train_step

ATOL = 1e-5
GRAD_ATOL = 2e-5
T, H = 8, 16


def _case(seed, n_layers, rows, hidden=H, n_t=T, masked=True):
    """numpy x1_proj, weights ``(w_hh, w_in, biases)``, masks (or None)."""
    rng = np.random.default_rng(seed)

    def weight(shape):
        return (rng.normal(size=shape) * 0.2).astype(np.float32)

    x = rng.normal(size=(n_t, rows, 4 * hidden)).astype(np.float32)
    weights = (
        [weight((hidden, 4 * hidden)) for _ in range(n_layers)],
        [weight((hidden, 4 * hidden)) for _ in range(n_layers - 1)],
        [weight((4 * hidden,)) for _ in range(n_layers - 1)],
    )
    masks = [((rng.random((n_t, rows, hidden)) >= 0.2) / 0.8).astype(np.float32)
             for _ in range(n_layers - 1)] if masked else None
    return x, weights, masks


def _jax(x, weights, masks):
    return (jnp.asarray(x), tuple(tuple(map(jnp.asarray, g)) for g in weights),
            None if masks is None else tuple(map(jnp.asarray, masks)))


def _torch(x, weights, masks):
    return (torch.from_numpy(x), [[torch.from_numpy(a) for a in g] for g in weights],
            None if masks is None else [torch.from_numpy(m) for m in masks])


# Depths 3, 4 and 8; 5 to 30 rows; with and without masks.
STACK_CASES = [(3, 5, False), (3, 30, True), (4, 25, True), (4, 12, False),
               (8, 7, True), (8, 30, False)]


@pytest.mark.parametrize("n_layers,rows,masked", STACK_CASES)
def test_stack_forward_and_stashes_match_jax(n_layers, rows, masked):
    """The plain stack against interpret-mode Pallas (its output and its h/c
    residuals) and the scan reference."""
    args = _case(n_layers * 100 + rows, n_layers, rows, masked=masked)
    jx, jw, jm = _jax(*args)
    x, w, m = _torch(*args)
    hs, cs = lk.lstm_stack_ref(x, *w, m, return_stash=True)
    want = jax_stack(jx, jw, jm, impl="interpret")
    np.testing.assert_allclose(hs[-1].numpy(), np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(hs[-1].numpy(), np.asarray(lstm_stack_xla(jx, jw, jm)),
                               atol=ATOL, rtol=0)
    _, res = _stack_fwd_pallas(jx, jm, *jw, interpret=True)
    for got, want_group in ((hs, res[2]), (cs, res[3])):
        for g, w_ in zip(got, want_group):
            np.testing.assert_allclose(g.numpy(), np.asarray(w_)[:, :rows],
                                       atol=ATOL, rtol=0)
    torch.testing.assert_close(lk.lstm_stack_recurrence(x, w, m), hs[-1],
                               atol=0, rtol=0)


@pytest.mark.parametrize("n_layers,rows,masked", STACK_CASES)
def test_stack_gradients_match_jax(n_layers, rows, masked):
    """dx1, every dW_hh, dW_in and db through the port's autograd function
    (plain forward with stashes, plain backward) against jax.grad of the
    interpret-mode Pallas stack."""
    args = _case(n_layers * 100 + rows + 1, n_layers, rows, masked=masked)
    jx, jw, jm = _jax(*args)
    ct = np.random.default_rng(rows).normal(size=(T, rows, H)).astype(np.float32)
    want = jax.grad(
        lambda a, w: jnp.sum(jax_stack(a, w, jm, impl="interpret") * ct),
        argnums=(0, 1),
    )(jx, jw)
    x, w, m = _torch(*args)
    x.requires_grad_(True)
    for group in w:
        for t in group:
            t.requires_grad_(True)
    (lk.lstm_stack_recurrence(x, w, m) * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want[0]),
                               atol=GRAD_ATOL, rtol=0)
    for group, want_group in zip(w, want[1]):
        assert len(group) == len(want_group)
        for t, g in zip(group, want_group):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                       atol=GRAD_ATOL, rtol=0)


@pytest.mark.parametrize("masked", [False, True])
def test_stack_plain_backward_matches_autograd(masked):
    """lstm_stack_bwd_ref and the weight gradients against torch autograd
    through the plain forward (no hand-written backward)."""
    x, w, m = _torch(*_case(7, 4, 9, masked=masked))
    dh = torch.from_numpy(
        np.random.default_rng(8).normal(size=(T, 9, H)).astype(np.float32))
    leaves = [x.clone().requires_grad_(True)] + [
        t.clone().requires_grad_(True) for g in w for t in g]
    (lk.lstm_stack_ref(leaves[0], leaves[1:5], leaves[5:8], leaves[8:11], m)
     * dh).sum().backward()
    hs, cs = lk.lstm_stack_ref(x, *w, m, return_stash=True)
    d_pres = lk.lstm_stack_bwd_ref(dh, x, m, hs, cs, *w)
    dw_hh, dw_in, db = lk.lstm_stack_wgrad_ref(d_pres, hs, m)
    for got, leaf in zip([d_pres[0], *dw_hh, *dw_in, *db], leaves):
        torch.testing.assert_close(got, leaf.grad, atol=GRAD_ATOL, rtol=0)


def test_stack_gradcheck_f64():
    """torch.autograd.gradcheck (f64, finite differences) on the plain
    autograd path, with and without masks."""
    x, w, m = _torch(*_case(9, 3, 3, hidden=4, n_t=4))
    leaves = [x.double().requires_grad_(True)] + [
        t.double().requires_grad_(True) for g in w for t in g]
    masks = [mask.double() for mask in m]

    def run(*a, masks=None):
        return lk.lstm_stack_recurrence(a[0], (a[1:4], a[4:6], a[6:8]), masks)

    assert torch.autograd.gradcheck(lambda *a: run(*a, masks=masks), leaves)
    assert torch.autograd.gradcheck(run, leaves)


# --------------------------------------------------------------- grouping

ROWS = (25, 72, 88, 100, 200)
WINDOWS = (None, 25, 100)


def _jax_fused_depth(n_layers, n_t, rows, hidden, has_mask, window_rows):
    """The JAX encoder's fused_depth at layer 0, from its own predicates."""
    def fits(depth):
        return jax_stack_fits(n_t, rows, hidden, depth, has_mask) or (
            jax_window_schedulable(rows, window_rows)
            and jax_stack_fits(n_t, window_rows, hidden, depth, has_mask))

    depth = 1
    while depth < n_layers and fits(depth + 1):
        depth += 1
    return depth


@pytest.mark.parametrize("n_t", [60, 61])
@pytest.mark.parametrize("n_layers", [3, 4, 8])
def test_fused_depth_matches_jax(n_layers, n_t):
    """The port's copy of the grouping rule against the JAX package's
    predicates over rows, windows and masks, at H=64 and at H=16."""
    for hidden in (64, 16):
        for rows in ROWS:
            for has_mask in (False, True):
                assert fused_depth(n_layers, n_t, rows, hidden, has_mask) == (
                    max_wavefront_depth(n_t, rows, hidden, n_layers, has_mask))
                for window in WINDOWS:
                    assert fused_depth(n_layers, n_t, rows, hidden, has_mask,
                                       window) == _jax_fused_depth(
                        n_layers, n_t, rows, hidden, has_mask, window)


def _jax_groups(monkeypatch, n_layers, n_t, rows, has_mask, window_rows,
                hidden=64):
    """The depths of the groups the JAX encoder runs, recorded from its
    calls into the recurrences (which return zeros here)."""
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

    def stack(x_proj, weights, *args, **kwargs):
        return record(len(weights[0]))(x_proj)

    monkeypatch.setattr(jax_lstm, "lstm_stack_recurrence", stack)
    module = JaxEncoder(hidden_size=hidden, num_layers=n_layers,
                        dropout=0.3 if has_mask else 0.0,
                        kernel_impl="interpret")
    x = jnp.zeros((rows, n_t, 3), jnp.float32)
    params = module.init(jax.random.key(0), x[:1])["params"]
    groups.clear()
    module.apply({"params": params}, x, deterministic=False,
                 window_rows=window_rows, rngs={"dropout": jax.random.key(1)})
    return groups


@pytest.mark.parametrize("n_layers,n_t,rows,has_mask,window_rows,want", [
    (4, 60, 25, True, None, [4]),      # model=medium training, one window
    (4, 60, 200, False, 25, [4]),      # model=medium serving, bucket 8
    (8, 60, 25, True, None, [7, 1]),   # model=large training
    (8, 60, 200, False, 25, [8]),      # model=large serving, bucket 8
    (2, 60, 100, True, None, [2]),     # model=small training
    (2, 60, 800, False, 100, [2]),     # model=small serving, bucket 8
    (3, 60, 100, True, None, [2, 1]),  # 3 layers at 100 rows: pair + single
    (4, 61, 100, True, None, [1, 1, 1, 1]),  # past the pair's budget
])
def test_encoder_groups_layers_as_jax_does(monkeypatch, n_layers, n_t, rows,
                                           has_mask, window_rows, want):
    port = LstmEncoder(hidden_size=64, num_layers=n_layers, device="cpu")
    got = port.layer_groups(n_t, rows, has_mask, window_rows)
    assert got == want
    assert got == _jax_groups(monkeypatch, n_layers, n_t, rows, has_mask,
                              window_rows)


# ------------------------------------------------- model=medium-shaped runs

F = 3


def _jax_and_port(num_layers, seed, hidden=H):
    module = JaxEncoder(hidden_size=hidden, num_layers=num_layers, dropout=0.0,
                        kernel_impl="interpret")
    params = module.init(jax.random.key(seed), jnp.zeros((1, T, F)))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    port = LstmEncoder(input_size=F, hidden_size=hidden, num_layers=num_layers,
                       dropout=0.0, device="cpu")
    port.load_state_dict(params_from_jax(params))
    return module, params, port


@pytest.mark.parametrize("num_layers", [4, 8])
def test_encoder_on_25_row_windows_matches_jax(num_layers):
    """model=medium's (4) and model=large's (8) depth, deterministic, on two
    25-row windows through forward_rows on both sides (window_rows=25), the
    JAX encoder's stack in interpret mode."""
    module, params, port = _jax_and_port(num_layers, seed=num_layers)
    x = np.random.default_rng(num_layers).normal(size=(2, 25, T, F)).astype(np.float32)
    want_a, want_b = jax_forward_rows(module, params, jnp.asarray(x))
    with torch.inference_mode():
        got_a, got_b = forward_rows(port, torch.from_numpy(x))
    assert port.layer_groups(T, 50, False, 25) == [num_layers]
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), atol=ATOL, rtol=0)


def test_training_forward_with_injected_masks_matches_jax_stack():
    """A 4-layer training forward (one 4-deep stack) with injected masks
    against the interpret-mode JAX stack with the same seam masks."""
    _, params, port = _jax_and_port(4, seed=2)
    port.dropout = 0.3  # masks are used in training mode with dropout on
    rng = np.random.default_rng(2)
    x = rng.normal(size=(25, T, F)).astype(np.float32)
    masks = [((rng.random((T, 25, H)) >= 0.3) / 0.7).astype(np.float32)
             for _ in range(3)]

    def proj(n):
        return params[f"w_ih_l{n}"], params[f"b_ih_l{n}"] + params[f"b_hh_l{n}"]

    w0, b0 = proj(0)
    x1 = jnp.swapaxes(jnp.asarray(x), 0, 1) @ w0.T + b0
    weights = (tuple(params[f"w_hh_l{n}"].T for n in range(4)),
               tuple(proj(n)[0].T for n in range(1, 4)),
               tuple(proj(n)[1] for n in range(1, 4)))
    h = jax_stack(x1, weights, tuple(map(jnp.asarray, masks)),
                  impl="interpret")[-1]
    want_a = h @ params["alpha_head"]["kernel"] + params["alpha_head"]["bias"]
    with torch.no_grad():
        got_a, _ = port(torch.from_numpy(x), deterministic=False,
                        masks=[torch.from_numpy(m) for m in masks])
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), atol=ATOL, rtol=0)


def _jax_groups_loss(params, x, masks, groups, ct):
    """sum(alpha * ct) of a training forward through the JAX package's layer
    functions in ``groups`` (interpret-mode Pallas): the seam masks inside
    each group's kernel, the boundary masks multiplied between groups."""
    from masters_thesis_tpu.ops.lstm_kernel import (
        lstm_pair_recurrence as jax_pair,
        lstm_recurrence as jax_recurrence,
    )

    def proj(n):
        return params[f"w_ih_l{n}"].T, params[f"b_ih_l{n}"] + params[f"b_hh_l{n}"]

    h, pending, layer = jnp.swapaxes(x, 0, 1), iter(masks), 0
    for depth in groups:
        w0, b0 = proj(layer)
        x_proj = h @ w0 + b0
        above = range(layer + 1, layer + depth)
        w_hh = tuple(params[f"w_hh_l{n}"].T for n in range(layer, layer + depth))
        w_in = tuple(proj(n)[0] for n in above)
        bias = tuple(proj(n)[1] for n in above)
        seams = tuple(next(pending) for _ in above)
        if depth >= 3:
            h = jax_stack(x_proj, (w_hh, w_in, bias), seams, impl="interpret")
        elif depth == 2:
            h = jax_pair(x_proj, w_hh[0], w_in[0], bias[0], w_hh[1],
                         mask=seams[0], impl="interpret")
        else:
            h = jax_recurrence(x_proj, w_hh[0], impl="interpret")
        layer += depth
        if layer < sum(groups):
            h = h * next(pending)
    alpha = h[-1] @ params["alpha_head"]["kernel"] + params["alpha_head"]["bias"]
    return jnp.sum(alpha * ct)


# Every mixed route the encoder takes at T=60, H=64: pair + single (3 layers
# at 100 rows), pair + pair (model=medium at 100 rows), 7-deep stack + single
# (model=large training at 25 rows), and a stack then a single at 4 layers.
@pytest.mark.parametrize("groups", [[2, 1], [2, 2], [3, 1], [7, 1]])
def test_training_mixed_groups_match_jax(monkeypatch, groups):
    """A training forward and its gradients with injected masks, the port's
    layers grouped as ``groups`` (set, since at this toy shape the rule
    fuses every layer), against the JAX layer functions in the same groups:
    the boundary masks and each group's seams in the same order."""
    import masters_thesis_tpu_torch.models.lstm as port_lstm

    n_layers, rows = sum(groups), 6
    _, params, port = _jax_and_port(n_layers, seed=n_layers + len(groups))
    port.dropout = 0.3  # masks are used in training mode with dropout on
    monkeypatch.setattr(port, "layer_groups", lambda *a, **k: list(groups))
    ran = []

    def spy(name, depth):
        fn = getattr(port_lstm, name)

        def call(*a, **k):
            ran.append(depth(*a))
            return fn(*a, **k)
        monkeypatch.setattr(port_lstm, name, call)

    spy("lstm_recurrence", lambda *a: 1)
    spy("lstm_pair_recurrence", lambda *a: 2)
    spy("lstm_stack_recurrence", lambda x, weights, *a: len(weights[0]))
    rng = np.random.default_rng(len(groups) * 10 + n_layers)
    x = rng.normal(size=(rows, T, F)).astype(np.float32)
    masks = [((rng.random((T, rows, H)) >= 0.3) / 0.7).astype(np.float32)
             for _ in range(n_layers - 1)]
    ct = rng.normal(size=(rows, 1)).astype(np.float32)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jmasks = [jnp.asarray(m) for m in masks]
    want_loss, want_grads = jax.value_and_grad(_jax_groups_loss)(
        jparams, jnp.asarray(x), jmasks, groups, jnp.asarray(ct))
    alpha, _ = port(torch.from_numpy(x), deterministic=False,
                    masks=[torch.from_numpy(m) for m in masks])
    loss = (alpha * torch.from_numpy(ct)).sum()
    loss.backward()
    assert ran == groups
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), atol=ATOL,
                               rtol=0)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, want_grads))
    for name, p in port.named_parameters():
        if name.startswith("beta_head"):
            continue  # beta takes no part in this loss
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=GRAD_ATOL, rtol=0, err_msg=name)


def _windows(n, k=25, look=12, tgt=6):
    rng = np.random.default_rng(11)
    out = []
    for _ in range(n):
        x = rng.normal(0.1, 0.5, size=(1, k, look, F)).astype(np.float32)
        y = rng.normal(0.1, 0.5, size=(1, k, tgt, 4)).astype(np.float32)
        factor = np.stack([rng.normal(size=1), rng.uniform(0.5, 2, size=1)],
                          axis=-1).astype(np.float32)
        inv_psi = rng.uniform(1, 2, size=(1, k)).astype(np.float32)
        out.append((x, y, factor, inv_psi))
    return out


def test_ten_step_medium_trajectory_matches_jax_train_step():
    """10 updates of a model=medium-shaped encoder (4 layers, dropout 0,
    batch_size 1, one 25-row window a step, so one 4-deep stack): the
    port's train_step against the JAX package's make_train_step with
    FlatAdam on a 1-device mesh, mse objective."""
    lr, hidden, look = 1e-3, 8, 12
    jspec = JaxSpec(objective="mse", hidden_size=hidden, num_layers=4,
                    dropout=0.0)
    module = jspec.build_module()
    params = module.init(jax.random.key(5), jnp.zeros((1, look, F)))["params"]
    port = LstmEncoder(hidden_size=hidden, num_layers=4, dropout=0.0, device="cpu")
    port.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    assert port.layer_groups(look, 25, False) == [4]

    tx = JaxFlatAdam(5.0, 1e-5)
    opt_state = tx.init(params)
    step_fn = make_train_step(module, jspec.window_objective(), tx,
                              make_data_mesh(1))
    opt = FlatAdam(port, 5.0, 1e-5)
    loss_fn = batched_objective(
        ModelSpec(objective="mse", hidden_size=hidden).window_objective())
    want, got = [], []
    lk.reset_launch_counts()
    for arrays in _windows(10, look=look):
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
    assert not any(lk.LAUNCHES.values())  # the CPU runs the plain versions
