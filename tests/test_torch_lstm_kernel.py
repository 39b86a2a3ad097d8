"""The port's LSTM recurrences against the JAX package's.

On the CPU the port's public functions run their plain versions; they are
held against the JAX Pallas kernels in interpret mode and against the JAX
scan references, on the same numpy inputs. Tolerance 1e-5 abs for forwards:
f32 on both sides, summed in a different order over at most 8 dependent
steps. 2e-5 abs for gradients, which add the reverse sweep and the sums
over rows and steps (measured: below 1e-6).

The CUDA kernels are held against these plain versions on the card in
tests/test_torch_cuda.py, which imports no JAX so that it runs there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masters_thesis_tpu.ops.lstm_kernel import (
    _pair_fwd_pallas,
    lstm_pair_recurrence as jax_pair,
    lstm_pair_xla,
    lstm_recurrence as jax_recurrence,
    lstm_recurrence_xla,
)
from masters_thesis_tpu_torch.ops import lstm_kernel as lk

ATOL = 1e-5
GRAD_ATOL = 2e-5
T, H = 8, 16


def _case(seed, rows, hidden=H, n_t=T):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n_t, rows, 4 * hidden)).astype(np.float32)
    w1, wi2, w2 = (
        (rng.normal(size=(hidden, 4 * hidden)) * 0.2).astype(np.float32)
        for _ in range(3)
    )
    b2 = (rng.normal(size=(4 * hidden,)) * 0.2).astype(np.float32)
    return x, w1, wi2, b2, w2


def _torch(*arrays, device="cpu"):
    return [torch.from_numpy(a).to(device) for a in arrays]


@pytest.mark.parametrize("rows", [5, 12])
@pytest.mark.parametrize("reference", ["interpret", "xla"])
def test_pair_matches_jax(rows, reference):
    args = _case(rows, rows)
    jargs = [jnp.asarray(a) for a in args]
    if reference == "interpret":
        want = jax_pair(*jargs, mask=None, impl="interpret")
    else:
        want = lstm_pair_xla(*jargs)
    got = lk.lstm_pair_recurrence(*_torch(*args))
    assert got.shape == (T, rows, H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("rows", [5, 12])
@pytest.mark.parametrize("reference", ["interpret", "xla"])
def test_single_layer_matches_jax(rows, reference):
    x, w, *_ = _case(100 + rows, rows)
    if reference == "interpret":
        want = jax_recurrence(jnp.asarray(x), jnp.asarray(w), impl="interpret")
    else:
        want = lstm_recurrence_xla(jnp.asarray(x), jnp.asarray(w))
    got = lk.lstm_recurrence(*_torch(x, w))
    assert got.shape == (T, rows, H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_plain_c_output_continues_h():
    """The optional c plane is the cell state that produced h: h_t equals
    o_t * tanh(c_t) with o_t recomputed from x_t and h_{t-1}."""
    x, w, *_ = _case(7, 5)
    xt, wt = _torch(x, w)
    hs, cs = lk.lstm_recurrence_ref(xt, wt, return_c=True)
    h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
    o = torch.sigmoid((xt + h_prev @ wt)[..., 3 * H:])
    torch.testing.assert_close(hs, o * torch.tanh(cs), atol=ATOL, rtol=0)


def test_cpu_dispatch_launches_no_kernel():
    """A CPU tensor takes the plain version and never counts a launch."""
    lk.reset_launch_counts()
    args = _torch(*_case(3, 4))
    lk.lstm_pair_recurrence(*args)
    lk.lstm_recurrence(args[0], args[1])
    leaves = [a.requires_grad_(True) for a in args]
    lk.lstm_pair_recurrence(*leaves).sum().backward()
    lk.lstm_recurrence(leaves[0], leaves[1]).sum().backward()
    x, w1, wi2, b2, w2 = leaves
    stack = (x, ([w1, w2, w1], [wi2, wi2], [b2, b2]))
    lk.lstm_stack_recurrence(*stack).sum().backward()
    with torch.no_grad():
        lk.lstm_stack_recurrence(*stack)
    # A long lookback takes the time-blocked route, plain on the CPU.
    long_x = torch.zeros((90, 100, 4 * 64), requires_grad=True)
    long_w = torch.zeros((64, 4 * 64), requires_grad=True)
    assert lk.single_layer_route(90, 100, 64) == "pallas-timeblocked"
    lk.lstm_recurrence(long_x, long_w).sum().backward()
    assert set(lk.LAUNCHES) == {
        "lstm_pair_fwd", "lstm_pair_fwd_masked", "lstm_fwd", "lstm_pair_bwd",
        "lstm_bwd", "lstm_wgrad", "lstm_stack_fwd", "lstm_stack_fwd_masked",
        "lstm_stack_bwd", "lstm_tb_fwd", "lstm_tb_bwd",
    }
    assert not any(lk.LAUNCHES.values())


def _mask(seed, rows, hidden=H, n_t=T, p=0.2):
    keep = np.random.default_rng(seed).random((n_t, rows, hidden)) >= p
    return (keep / (1.0 - p)).astype(np.float32)


@pytest.mark.parametrize("rows", [5, 12])
def test_masked_pair_forward_and_stashes_match_jax(rows):
    """The masked pair (the training forward) against interpret-mode Pallas
    and the scan reference, and its h1/c1/c2 stashes against the Pallas
    kernel's residuals."""
    args = _case(20 + rows, rows)
    mask = _mask(rows, rows)
    jargs = [jnp.asarray(a) for a in args]
    got = lk.lstm_pair_ref(*_torch(*args), torch.from_numpy(mask),
                           return_stash=True)
    want_h2 = jax_pair(*jargs, mask=jnp.asarray(mask), impl="interpret")
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want_h2), atol=ATOL, rtol=0)
    xla = lstm_pair_xla(*jargs, mask=jnp.asarray(mask))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(xla), atol=ATOL, rtol=0)
    x, w1, wi2, b2, w2 = jargs
    _, res = _pair_fwd_pallas(x, jnp.asarray(mask), w1, wi2, b2, w2,
                              interpret=True)
    h1s, c1s, _, c2s = (np.asarray(a)[:, :rows] for a in res[2:6])
    for g, w in zip(got[1:], (h1s, c1s, c2s)):
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=0)
    plain = lk.lstm_pair_recurrence(*_torch(*args), torch.from_numpy(mask))
    torch.testing.assert_close(plain, got[0], atol=0, rtol=0)


def _cotangent(seed, rows, hidden=H):
    return np.random.default_rng(seed).normal(size=(T, rows, hidden)).astype(np.float32)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("rows", [5, 12])
def test_pair_gradients_match_jax(rows, masked):
    """All five pair gradients through the port's autograd function (plain
    forward with stashes, plain backward) against jax.grad of the
    interpret-mode Pallas pair (its custom VJP, _pair_bwd_kernel)."""
    args = _case(40 + rows, rows)
    mask = _mask(rows + 1, rows) if masked else None
    ct = _cotangent(rows, rows)

    def objective(*a):
        m = None if mask is None else jnp.asarray(mask)
        return jnp.sum(jax_pair(*a, mask=m, impl="interpret") * ct)

    want = jax.grad(objective, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, args))
    leaves = [t.requires_grad_(True) for t in _torch(*args)]
    out = lk.lstm_pair_recurrence(
        *leaves, None if mask is None else torch.from_numpy(mask))
    (out * torch.from_numpy(ct)).sum().backward()
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   atol=GRAD_ATOL, rtol=0)


@pytest.mark.parametrize("rows", [5, 12])
def test_single_layer_gradients_match_jax(rows):
    """dx and dW of one layer against jax.grad of the interpret-mode Pallas
    recurrence (its custom VJP, _bwd_kernel)."""
    x, w, *_ = _case(60 + rows, rows)
    ct = _cotangent(rows + 2, rows)
    want = jax.grad(
        lambda a, b: jnp.sum(jax_recurrence(a, b, impl="interpret") * ct),
        argnums=(0, 1),
    )(jnp.asarray(x), jnp.asarray(w))
    leaves = [t.requires_grad_(True) for t in _torch(x, w)]
    (lk.lstm_recurrence(*leaves) * torch.from_numpy(ct)).sum().backward()
    for leaf, g in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g),
                                   atol=GRAD_ATOL, rtol=0)


@pytest.mark.parametrize("masked", [False, True])
def test_plain_backward_matches_autograd(masked):
    """lstm_pair_bwd_ref + the reduction, and lstm_bwd_ref, against torch
    autograd through the plain forwards (no hand-written backward)."""
    x, w1, wi2, b2, w2 = _torch(*_case(80, 7))
    mask = torch.from_numpy(_mask(81, 7)) if masked else None
    dh = torch.from_numpy(_cotangent(82, 7))
    leaves = [t.clone().requires_grad_(True) for t in (x, w1, wi2, b2, w2)]
    (lk.lstm_pair_ref(*leaves, mask) * dh).sum().backward()
    h2s, h1s, c1s, c2s = lk.lstm_pair_ref(x, w1, wi2, b2, w2, mask,
                                          return_stash=True)
    dx1, d_pre2 = lk.lstm_pair_bwd_ref(dh, x, mask, h1s, c1s, h2s, c2s,
                                       w1, wi2, b2, w2)
    dw1, dwi2, db2, dw2 = lk.lstm_pair_wgrad_ref(dx1, d_pre2, h1s, h2s, mask)
    for got, leaf in zip((dx1, dw1, dwi2, db2, dw2), leaves):
        torch.testing.assert_close(got, leaf.grad, atol=GRAD_ATOL, rtol=0)

    leaves = [t.clone().requires_grad_(True) for t in (x, w1)]
    (lk.lstm_recurrence_ref(*leaves) * dh).sum().backward()
    hs, cs = lk.lstm_recurrence_ref(x, w1, return_c=True)
    dx = lk.lstm_bwd_ref(dh, x, hs, cs, w1)
    torch.testing.assert_close(dx, leaves[0].grad, atol=GRAD_ATOL, rtol=0)
    torch.testing.assert_close(lk.lstm_wgrad_ref(dx, hs, 1), leaves[1].grad,
                               atol=GRAD_ATOL, rtol=0)


def test_gradcheck_f64_through_the_autograd_functions():
    """torch.autograd.gradcheck (f64, finite differences) on the plain
    autograd path: the hand-written backward is the forward's derivative."""
    x, w1, wi2, b2, w2 = (torch.from_numpy(a).double()
                          for a in _case(90, 3, hidden=4, n_t=4))
    mask = torch.from_numpy(_mask(91, 3, hidden=4, n_t=4)).double()
    leaves = [t.requires_grad_(True) for t in (x, w1, wi2, b2, w2)]
    assert torch.autograd.gradcheck(
        lambda *a: lk.lstm_pair_recurrence(*a, mask), leaves)
    assert torch.autograd.gradcheck(
        lambda *a: lk.lstm_pair_recurrence(*a), leaves)
    assert torch.autograd.gradcheck(lk.lstm_recurrence, leaves[:2])
