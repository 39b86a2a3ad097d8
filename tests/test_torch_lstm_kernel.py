"""The port's LSTM recurrences against the JAX package's.

On the CPU the port's public functions run their plain versions; they are
held against the JAX Pallas kernels in interpret mode and against the JAX
scan references, on the same numpy inputs. Tolerance 1e-5 abs: f32 on both
sides, summed in a different order over at most 8 dependent steps.

The CUDA kernels are held against these plain versions on the card in
tests/test_torch_cuda.py, which imports no JAX so that it runs there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masters_thesis_tpu.ops.lstm_kernel import (
    lstm_pair_recurrence as jax_pair,
    lstm_pair_xla,
    lstm_recurrence as jax_recurrence,
    lstm_recurrence_xla,
)
from masters_thesis_tpu_torch.ops import lstm_kernel as lk

ATOL = 1e-5
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
    assert lk.LAUNCHES == {"lstm_pair_fwd": 0, "lstm_fwd": 0}
