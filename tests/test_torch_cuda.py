"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA device and skips without one. The file imports
no JAX, so on a machine with a card and no JAX it runs on its own:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q

Tolerance 2e-5 abs for a kernel against its plain version (f32, the sums
taken in another order over up to 12 dependent steps), 5e-5 for the
encoder and engine end to end (input projection and heads added). The
weight gradients are sums over up to 12 * 803 rows and are held at 2e-5
relative to the largest entry.
"""

import numpy as np
import pytest
import torch

from masters_thesis_tpu_torch.models.objectives import ModelSpec
from masters_thesis_tpu_torch.ops import lstm_kernel as lk
from masters_thesis_tpu_torch.serve.engine import PredictEngine

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(seed, rows, hidden, n_t=12, device="cpu"):
    rng = np.random.default_rng(seed)
    scale = 1.0 / np.sqrt(hidden)
    arrays = [rng.normal(size=(n_t, rows, 4 * hidden))] + [
        rng.uniform(-scale, scale, size=shape)
        for shape in ((hidden, 4 * hidden), (hidden, 4 * hidden),
                      (4 * hidden,), (hidden, 4 * hidden))
    ]
    return [torch.tensor(a, dtype=torch.float32, device=device) for a in arrays]


def _mask_and_cotangent(seed, n_t, rows, hidden, device):
    rng = np.random.default_rng(seed)
    mask = (rng.random((n_t, rows, hidden)) >= 0.2) / 0.8
    dh = rng.normal(size=(n_t, rows, hidden))
    return (torch.tensor(mask, dtype=torch.float32, device=device),
            torch.tensor(dh, dtype=torch.float32, device=device))


def _close_rel(got, want, rtol=2e-5):
    scale = max(float(want.abs().max()), 1.0)
    torch.testing.assert_close(got, want, atol=rtol * scale, rtol=0)


CASES = [(1, 1), (9, 5), (12, 16), (100, 64), (400, 64), (803, 64), (37, 64)]


# Ragged row tiles, H not a multiple of 4, and each row tile of the launch
# heuristic (2, 4 and 8 rows at 100, 400 and 803 rows).
@pytest.mark.parametrize("rows,hidden", CASES)
def test_kernels_match_plain(cuda_device, rows, hidden):
    x, w1, wi2, b2, w2 = _case(rows, rows, hidden, device=cuda_device)
    before = dict(lk.LAUNCHES)
    h2s = lk.lstm_pair_recurrence(x, w1, wi2, b2, w2)
    hs, cs = lk.lstm_fwd_cuda(x, w1, return_c=True)
    torch.cuda.synchronize()
    assert lk.LAUNCHES["lstm_pair_fwd"] == before["lstm_pair_fwd"] + 1
    assert lk.LAUNCHES["lstm_fwd"] == before["lstm_fwd"] + 1
    torch.testing.assert_close(h2s, lk.lstm_pair_ref(x, w1, wi2, b2, w2),
                               atol=2e-5, rtol=0)
    hs_ref, cs_ref = lk.lstm_recurrence_ref(x, w1, return_c=True)
    torch.testing.assert_close(hs, hs_ref, atol=2e-5, rtol=0)
    torch.testing.assert_close(cs, cs_ref, atol=2e-5, rtol=0)
    torch.testing.assert_close(lk.lstm_recurrence(x, w1), hs, atol=0, rtol=0)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("rows,hidden", CASES)
def test_training_kernels_match_plain(cuda_device, rows, hidden, masked):
    """Pair forward with stashes, both backward sweeps and the weight
    gradients, each against its plain version on the same inputs."""
    x, w1, wi2, b2, w2 = _case(rows + 7, rows, hidden, device=cuda_device)
    mask, dh = _mask_and_cotangent(rows, x.shape[0], rows, hidden, cuda_device)
    mask = mask if masked else None
    got = lk.lstm_pair_fwd_cuda(x, w1, wi2, b2, w2, mask, stash=True)
    want = lk.lstm_pair_ref(x, w1, wi2, b2, w2, mask, return_stash=True)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=2e-5, rtol=0)
    h2s, h1s, c1s, c2s = want
    args = (dh, x, mask, h1s, c1s, h2s, c2s, w1, wi2, b2, w2)
    dx1, d_pre2 = lk.lstm_pair_bwd_cuda(*args)
    dx1_ref, d_pre2_ref = lk.lstm_pair_bwd_ref(*args)
    torch.testing.assert_close(dx1, dx1_ref, atol=2e-5, rtol=0)
    torch.testing.assert_close(d_pre2, d_pre2_ref, atol=2e-5, rtol=0)
    for g, w in zip(lk.lstm_pair_wgrad(dx1_ref, d_pre2_ref, h1s, h2s, mask),
                    lk.lstm_pair_wgrad_ref(dx1_ref, d_pre2_ref, h1s, h2s, mask)):
        _close_rel(g, w)
    hs, cs = lk.lstm_recurrence_ref(x, w1, return_c=True)
    dx = lk.lstm_bwd_cuda(dh, x, hs, cs, w1)
    dx_ref = lk.lstm_bwd_ref(dh, x, hs, cs, w1)
    torch.testing.assert_close(dx, dx_ref, atol=2e-5, rtol=0)
    _close_rel(lk.lstm_single_wgrad(dx_ref, hs), lk.lstm_wgrad_ref(dx_ref, hs, 1))


def test_weight_gradients_repeat_bit_for_bit(cuda_device):
    x, w1, wi2, b2, w2 = _case(3, 803, 64, device=cuda_device)
    mask, dh = _mask_and_cotangent(3, x.shape[0], 803, 64, cuda_device)
    h2s, h1s, c1s, c2s = lk.lstm_pair_ref(x, w1, wi2, b2, w2, mask,
                                          return_stash=True)
    dx1, d_pre2 = lk.lstm_pair_bwd_cuda(dh, x, mask, h1s, c1s, h2s, c2s,
                                        w1, wi2, b2, w2)
    first = lk.lstm_pair_wgrad(dx1, d_pre2, h1s, h2s, mask)
    second = lk.lstm_pair_wgrad(dx1, d_pre2, h1s, h2s, mask)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("masked", [False, True])
def test_cuda_gradients_go_through_the_kernels(cuda_device, monkeypatch,
                                               masked):
    """A CUDA tensor that needs a gradient runs the stash forward and the
    backward kernels, never the plain backward, and its gradients match
    autograd through the plain forward."""
    for name in ("lstm_pair_bwd_ref", "lstm_bwd_ref", "lstm_pair_wgrad_ref"):
        monkeypatch.setattr(lk, name, _refuse)
    base = _case(5, 100, 64, device=cuda_device)
    mask, dh = _mask_and_cotangent(5, base[0].shape[0], 100, 64, cuda_device)
    mask = mask if masked else None
    leaves = [t.clone().requires_grad_(True) for t in base]
    lk.reset_launch_counts()
    (lk.lstm_pair_recurrence(*leaves, mask) * dh).sum().backward()
    (lk.lstm_recurrence(leaves[0], leaves[1]) * dh).sum().backward()
    torch.cuda.synchronize()
    assert lk.LAUNCHES == {
        "lstm_pair_fwd": 0 if masked else 1,
        "lstm_pair_fwd_masked": 1 if masked else 0,
        "lstm_fwd": 1,
        "lstm_pair_bwd": 1,
        "lstm_bwd": 1,
        "lstm_wgrad": 2,
    }
    ref = [t.clone().requires_grad_(True) for t in base]
    plain = lk.lstm_pair_ref(*ref, mask)
    ((plain * dh).sum() + (lk.lstm_recurrence_ref(ref[0], ref[1]) * dh).sum()
     ).backward()
    for got, want in zip(leaves, ref):
        _close_rel(got.grad, want.grad)


def _refuse(*args, **kwargs):
    raise AssertionError("a CUDA tensor reached a plain backward")


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    x, w1, wi2, b2, w2 = _case(1, 4, 8, device=cuda_device)
    before = dict(lk.LAUNCHES)
    with pytest.raises(TypeError):
        lk.lstm_recurrence(x.double(), w1.double())
    with pytest.raises(ValueError, match="contiguous"):
        lk.lstm_recurrence(x.transpose(0, 1).contiguous().transpose(0, 1), w1)
    with pytest.raises(ValueError, match="is on cpu"):
        lk.lstm_recurrence(x, w1.cpu())
    with pytest.raises(ValueError, match="shape"):
        lk.lstm_pair_recurrence(x, w1, wi2, b2[:-1], w2)
    wide = lk.MAX_HIDDEN + 1
    big = torch.zeros((2, 3, 4 * wide), device=cuda_device)
    with pytest.raises(ValueError, match="outside the kernels' range"):
        lk.lstm_recurrence(big, torch.zeros((wide, 4 * wide), device=cuda_device))
    # The training path refuses the same: a gradient through f64 or a wide
    # layer raises on the card instead of taking the plain version.
    with pytest.raises(TypeError):
        lk.lstm_pair_recurrence(*(t.double().requires_grad_(True)
                                  for t in (x, w1, wi2, b2, w2)))
    wide_w = torch.zeros((wide, 4 * wide), device=cuda_device, requires_grad=True)
    with pytest.raises(ValueError, match="outside the kernels' range"):
        lk.lstm_recurrence(big, wide_w)
    mask = torch.ones(x.shape[:2] + (8,), device=cuda_device)
    with pytest.raises(ValueError, match="mask has shape"):
        lk.lstm_pair_recurrence(x, w1, wi2, b2, w2, mask[:, :, :4])
    h = torch.zeros(x.shape[:2] + (8,), device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        lk.lstm_bwd_cuda(h.transpose(0, 1).contiguous().transpose(0, 1), x, h,
                         h, w1)
    with pytest.raises(TypeError):
        lk.lstm_pair_bwd_cuda(h.double(), x, None, h, h, h, h, w1, wi2, b2, w2)
    assert lk.LAUNCHES == before


@pytest.mark.parametrize("num_layers", [1, 2, 3])
def test_engine_on_the_card_matches_the_cpu(cuda_device, num_layers):
    spec = ModelSpec(objective="mse", hidden_size=32, num_layers=num_layers,
                     dropout=0.0)
    state = spec.build_module(
        device="cpu", generator=torch.Generator().manual_seed(num_layers)
    ).state_dict()
    kw = dict(n_stocks=7, lookback=10, n_features=3, buckets=(1, 2, 4))
    gpu = PredictEngine(spec, state, device=cuda_device, **kw)
    cpu = PredictEngine(spec, state, device="cpu", **kw)
    x = np.random.default_rng(0).normal(size=(3, 7, 10, 3)).astype(np.float32)
    lk.reset_launch_counts()
    got = gpu.predict(x)
    assert lk.LAUNCHES["lstm_pair_fwd"] == num_layers // 2
    assert lk.LAUNCHES["lstm_fwd"] == num_layers % 2
    for g, w in zip(got, cpu.predict(x)):
        np.testing.assert_allclose(g, w, atol=5e-5, rtol=0)
