"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA device and skips without one. The file imports
no JAX, so on a machine with a card and no JAX it runs on its own:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q

Tolerance 2e-5 abs for a forward against its plain version (f32, the sums
taken in another order over up to 12 dependent steps, 19 wavefront
iterations for an 8-deep stack, 252 steps for the time-blocked kernels),
5e-5 for the encoder and engine end to end (input projection and heads
added). Backward sweeps and weight gradients (sums over up to 60 * 803 or
252 * 803 rows) are held at 2e-5 relative to the largest entry.
"""

import functools

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


# Ragged row tiles, H not a multiple of 4, and the row tiles of the
# 256-thread forwards (1, 4 and 8 rows at 100, 400 and 803 rows).
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
    """The pair's 3 jobs and an 8-deep stack's 15, each launched twice:
    the splits are summed in a fixed order, so the results are equal."""
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
    sx, weights, masks, sdh = _stack_case(5, 8, 203, 64, n_t=60,
                                          device=cuda_device)
    shs, scs = lk.lstm_stack_ref(sx, *weights, masks, return_stash=True)
    d_pres = lk.lstm_stack_bwd_cuda(sdh, sx, masks, shs, scs, *weights)
    first = lk.lstm_stack_wgrad(d_pres, shs, masks)
    second = lk.lstm_stack_wgrad(d_pres, shs, masks)
    assert sum(len(group) for group in first) == 15 + 7
    for group_a, group_b in zip(first, second):
        for a, b in zip(group_a, group_b):
            assert torch.equal(a, b)


def _pass_jobs(seed, n_jobs, n_t, rows, hidden, device):
    """``n_jobs`` jobs of the weight-gradient pass: job i reads d_pre plane
    i // 2 (so jobs 2k and 2k + 1 share one, as the pair's and the stacks'
    jobs do), shift i % 2; a mask on jobs 0, 3, 4, 7, 8, 9, 12 and 13 (so
    every combination of shift, mask and bias occurs from 8 jobs on); the
    bias on jobs 4-7 and 12-15."""
    rng = np.random.default_rng(seed)

    def t(shape):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float32,
                            device=device)

    d_pres = [t((n_t, rows, 4 * hidden)) for _ in range((n_jobs + 1) // 2)]
    jobs = []
    for i in range(n_jobs):
        masked = i % 4 in ((0, 3) if i < 8 else (0, 1))
        mask = (torch.tensor((rng.random((n_t, rows, hidden)) >= 0.2) / 0.8,
                             dtype=torch.float32, device=device)
                if masked else None)
        jobs.append((d_pres[i // 2], t((n_t, rows, hidden)), i % 2, mask,
                     (i // 4) % 2 == 1))
    return jobs


# Jobs 1, 3, 7 and 15 (the pair's 3, the stacks' 2L - 1); H that pad the
# 64-row tile (1, 5, 13: no 16-byte copies) and the models' 64; T * rows
# from 1 row to 48,180 (803 rows: no multiple of the 16-row stage or of a
# split).
@pytest.mark.parametrize("n_t,rows", [(1, 1), (1, 3), (1, 803), (2, 1), (2, 3),
                                      (2, 803), (60, 1), (60, 3), (60, 803)])
@pytest.mark.parametrize("hidden", [1, 5, 13, 64])
@pytest.mark.parametrize("n_jobs", [1, 3, 7, 15])
def test_weight_gradient_pass_matches_plain(cuda_device, n_jobs, hidden, n_t,
                                            rows):
    """Every job of one launch of the pass against lstm_wgrad_ref (and its
    bias against the row sum)."""
    jobs = _pass_jobs(n_jobs * 100 + hidden + rows, n_jobs, n_t, rows, hidden,
                      cuda_device)
    got = lk.lstm_wgrad_cuda(jobs)
    torch.cuda.synchronize()
    for (d_pre, src, shift, mask, with_bias), (dw, db) in zip(jobs, got):
        _close_rel(dw, lk.lstm_wgrad_ref(d_pre, src, shift, mask))
        if with_bias:
            _close_rel(db, d_pre.sum(dim=(0, 1)))
        else:
            assert db is None


# The 256-thread kernels (the pair's forward and sweep, both single-layer
# sweeps, both single-layer forwards) take 1, 2, 4 or 8 rows a block, the
# fewest that keep the grid in one wave of an H100's 132 SMs: rows at the
# edges of each tile (1-2: one row a block; 3, 7, 8, 9, 133 and 203: ragged
# tiles; 100: the training shape; 800 and 803: 8 rows a block, where the
# pair forward stages w1 instead of holding it in registers). H 1, 5 and 13
# pad the contraction to 16 with zeros; T 1 and 2 are the shortest sweeps.
SWEEP_ROWS = [1, 2, 3, 7, 8, 9, 100, 133, 203, 800, 803]


def _as_tuple(t):
    return t if isinstance(t, tuple) else (t,)


@pytest.mark.parametrize("n_t", [1, 2, 60])
@pytest.mark.parametrize("hidden", [1, 5, 13, 64])
@pytest.mark.parametrize("rows", SWEEP_ROWS)
def test_pair_sweep_matches_plain(cuda_device, rows, hidden, n_t):
    """The pair forward, every instance (maskless, masked, each with and
    without its stashes) and again bit for bit, and the pair's sweep, each
    against its plain version."""
    x, w1, wi2, b2, w2 = _case(rows * hidden + n_t, rows, hidden, n_t=n_t,
                               device=cuda_device)
    mask, dh = _mask_and_cotangent(rows + n_t, n_t, rows, hidden, cuda_device)
    for m in (None, mask):
        want = lk.lstm_pair_ref(x, w1, wi2, b2, w2, m, return_stash=True)
        for stash in (False, True):
            got = _as_tuple(lk.lstm_pair_fwd_cuda(x, w1, wi2, b2, w2, m, stash))
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, atol=2e-5, rtol=0)
            again = _as_tuple(lk.lstm_pair_fwd_cuda(x, w1, wi2, b2, w2, m, stash))
            for a, b in zip(got, again):
                assert torch.equal(a, b)
        h2s, h1s, c1s, c2s = want
        args = (dh, x, m, h1s, c1s, h2s, c2s, w1, wi2, b2, w2)
        for got, want in zip(lk.lstm_pair_bwd_cuda(*args),
                             lk.lstm_pair_bwd_ref(*args)):
            torch.testing.assert_close(got, want, atol=2e-5, rtol=0)


def test_pair_sweep_repeats_bit_for_bit(cuda_device):
    x, w1, wi2, b2, w2 = _case(8, 803, 64, n_t=60, device=cuda_device)
    mask, dh = _mask_and_cotangent(8, 60, 803, 64, cuda_device)
    h2s, h1s, c1s, c2s = lk.lstm_pair_ref(x, w1, wi2, b2, w2, mask,
                                          return_stash=True)
    args = (dh, x, mask, h1s, c1s, h2s, c2s, w1, wi2, b2, w2)
    first = lk.lstm_pair_bwd_cuda(*args)
    second = lk.lstm_pair_bwd_cuda(*args)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n_t", [1, 2, 60])
@pytest.mark.parametrize("hidden", [1, 5, 13, 64])
@pytest.mark.parametrize("rows", SWEEP_ROWS)
def test_single_sweep_matches_plain(cuda_device, rows, hidden, n_t):
    x, w1, *_ = _case(rows * hidden + n_t + 1, rows, hidden, n_t=n_t,
                      device=cuda_device)
    _, dh = _mask_and_cotangent(rows + n_t + 1, n_t, rows, hidden, cuda_device)
    hs, cs = lk.lstm_recurrence_ref(x, w1, return_c=True)
    torch.testing.assert_close(lk.lstm_bwd_cuda(dh, x, hs, cs, w1),
                               lk.lstm_bwd_ref(dh, x, hs, cs, w1),
                               atol=2e-5, rtol=0)


def test_single_sweep_repeats_bit_for_bit(cuda_device):
    x, w1, *_ = _case(9, 803, 64, n_t=60, device=cuda_device)
    _, dh = _mask_and_cotangent(9, 60, 803, 64, cuda_device)
    hs, cs = lk.lstm_recurrence_ref(x, w1, return_c=True)
    assert torch.equal(lk.lstm_bwd_cuda(dh, x, hs, cs, w1),
                       lk.lstm_bwd_cuda(dh, x, hs, cs, w1))


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
        "lstm_stack_fwd": 0,
        "lstm_stack_fwd_masked": 0,
        "lstm_stack_bwd": 0,
        "lstm_tb_fwd": 0,
        "lstm_tb_bwd": 0,
        "lstm_pair_fwd_stacked": 0,
        "lstm_pair_fwd_masked_stacked": 0,
        "lstm_pair_bwd_stacked": 0,
        "lstm_wgrad_stacked": 0,
        "lstm_fwd_stacked": 0,
        "lstm_bwd_stacked": 0,
        "lstm_stack_fwd_stacked": 0,
        "lstm_stack_fwd_masked_stacked": 0,
        "lstm_stack_bwd_stacked": 0,
        "lstm_tb_fwd_stacked": 0,
        "lstm_tb_bwd_stacked": 0,
        "lstm_pair_fwd_bf16": 0,
        "lstm_pair_fwd_masked_bf16": 0,
        "lstm_pair_bwd_bf16": 0,
        "lstm_wgrad_bf16": 0,
        "lstm_stack_fwd_bf16": 0,
        "lstm_stack_fwd_masked_bf16": 0,
        "lstm_stack_bwd_bf16": 0,
    }
    ref = [t.clone().requires_grad_(True) for t in base]
    plain = lk.lstm_pair_ref(*ref, mask)
    ((plain * dh).sum() + (lk.lstm_recurrence_ref(ref[0], ref[1]) * dh).sum()
     ).backward()
    for got, want in zip(leaves, ref):
        _close_rel(got.grad, want.grad)


def _refuse(*args, **kwargs):
    raise AssertionError("a CUDA tensor reached a plain backward")


# ---------------------------------------------------- the pair in bf16
#
# The bf16 instances against their plain versions on the card (f32
# arithmetic on the bf16 values, rounded stores). A bf16 entry may sit one
# bf16 ulp from the plain version's where the two f32 sums, taken in
# another order, fall on both sides of a rounding boundary; so each entry
# is held to the f32 bar (2e-5 abs for a forward, 2e-5 of the largest
# entry for a gradient) or to one ulp of the plain entry, and at least 99%
# to the bar. The f32 d_pre planes are held to the f32 bar.

BF16 = torch.bfloat16


def _bf16_ulp(want):
    mag = want.double().abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def _close_bf16(got, want, atol=2e-5, relative=False):
    assert got.dtype == want.dtype == BF16
    got, want_f = got.double(), want.double()
    if relative:
        atol = atol * max(float(want_f.abs().max()), 1.0)
    diff = (got - want_f).abs()
    beyond = diff > atol
    assert not bool((beyond & (diff > _bf16_ulp(want))).any()), float(diff.max())
    assert float(beyond.double().mean()) <= 0.01, float(beyond.double().mean())


def _bf16_case(seed, rows, hidden, n_t, device):
    x, w1, wi2, b2, w2 = (t.to(BF16) for t in _case(seed, rows, hidden, n_t=n_t,
                                                     device=device))
    mask, dh = (t.to(BF16) for t in _mask_and_cotangent(seed + 1, n_t, rows,
                                                          hidden, device))
    return (x, w1, wi2, b2, w2), mask, dh


@pytest.mark.parametrize("n_t", [1, 60])
@pytest.mark.parametrize("hidden", [1, 5, 13, 64])
@pytest.mark.parametrize("rows", SWEEP_ROWS)
def test_bf16_pair_kernels_match_plain(cuda_device, rows, hidden, n_t):
    """Every bf16 forward instance (maskless, masked, each with and without
    its stashes, again bit for bit), the bf16 sweep (dx1 bf16, both d_pre
    f32) and the bf16 pass, each against its plain version, on the tiles
    of SWEEP_ROWS and the H that pad the contraction."""
    pair, mask, dh = _bf16_case(rows * hidden + n_t, rows, hidden, n_t,
                                cuda_device)
    for m in (None, mask):
        want = lk.lstm_pair_ref(*pair, m, return_stash=True)
        for stash in (False, True):
            before = dict(lk.LAUNCHES)
            got = _as_tuple(lk.lstm_pair_fwd_cuda(*pair, m, stash))
            name = "lstm_pair_fwd_bf16" if m is None else "lstm_pair_fwd_masked_bf16"
            assert lk.LAUNCHES[name] == before[name] + 1
            for g, w in zip(got, want):
                _close_bf16(g, w)
            again = _as_tuple(lk.lstm_pair_fwd_cuda(*pair, m, stash))
            for a, b in zip(got, again):
                assert torch.equal(a, b)
        h2s, h1s, c1s, c2s = want
        args = (dh, pair[0], m, h1s, c1s, h2s, c2s, *pair[1:])
        dx1, d_pre1, d_pre2 = lk.lstm_pair_bwd_bf16_cuda(*args)
        dx1_ref, d_pre1_ref, d_pre2_ref = lk.lstm_pair_bwd_bf16_ref(*args)
        _close_bf16(dx1, dx1_ref, relative=True)
        _close_rel(d_pre1, d_pre1_ref)
        _close_rel(d_pre2, d_pre2_ref)
        got = lk.lstm_pair_wgrad(d_pre1_ref, d_pre2_ref, h1s, h2s, m)
        for g, w in zip(got, lk.lstm_pair_wgrad_ref(d_pre1_ref, d_pre2_ref,
                                                    h1s, h2s, m)):
            _close_bf16(g, w, relative=True)


def test_bf16_kernels_repeat_bit_for_bit(cuda_device):
    pair, mask, dh = _bf16_case(11, 803, 64, 60, cuda_device)
    h2s, h1s, c1s, c2s = lk.lstm_pair_ref(*pair, mask, return_stash=True)
    args = (dh, pair[0], mask, h1s, c1s, h2s, c2s, *pair[1:])
    first = lk.lstm_pair_bwd_bf16_cuda(*args)
    second = lk.lstm_pair_bwd_bf16_cuda(*args)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    grads = [lk.lstm_pair_wgrad(first[1], first[2], h1s, h2s, mask)
             for _ in range(2)]
    for a, b in zip(*grads):
        assert a.dtype == BF16 and torch.equal(a, b)


@pytest.mark.parametrize("n_t,rows", [(1, 1), (2, 3), (60, 100), (60, 803)])
@pytest.mark.parametrize("hidden", [1, 5, 13, 64])
@pytest.mark.parametrize("n_jobs", [1, 3])
def test_bf16_weight_gradient_pass_matches_plain(cuda_device, n_jobs, hidden,
                                                 n_t, rows):
    """The bf16 pass (bf16 src and mask, f32 d_pre, bf16 outputs) against
    lstm_wgrad_ref on the same values in f32, rounded once; H 1, 5 and 13
    take the one-value copies."""
    jobs = [(d_pre, src.to(BF16), shift, None if m is None else m.to(BF16), b)
            for d_pre, src, shift, m, b in _pass_jobs(
                n_jobs * 100 + hidden + rows + 7, n_jobs, n_t, rows, hidden,
                cuda_device)]
    before = lk.LAUNCHES["lstm_wgrad_bf16"]
    got = lk.lstm_wgrad_cuda(jobs)
    assert lk.LAUNCHES["lstm_wgrad_bf16"] == before + 1
    for (d_pre, src, shift, mask, with_bias), (dw, db) in zip(jobs, got):
        want = lk.lstm_wgrad_ref(d_pre, src.float(), shift,
                                 None if mask is None else mask.float())
        _close_bf16(dw, want.to(BF16), relative=True)
        if with_bias:
            _close_bf16(db, d_pre.sum(dim=(0, 1)).to(BF16), relative=True)


@pytest.mark.parametrize("masked", [False, True])
def test_bf16_gradients_go_through_the_kernels(cuda_device, monkeypatch,
                                               masked):
    """bf16 leaves that need a gradient run the bf16 forward with stashes,
    the bf16 sweep and the bf16 pass, never an f32 pair kernel or a plain
    backward; the gradients are bf16 and match autograd through the plain
    versions on the card (two ulps: a stash may flip)."""
    for name in ("lstm_pair_bwd_ref", "lstm_pair_bwd_bf16_ref",
                 "lstm_pair_wgrad_ref"):
        monkeypatch.setattr(lk, name, _refuse)
    pair, mask, dh = _bf16_case(5, 100, 64, 60, cuda_device)
    mask = mask if masked else None
    leaves = [t.clone().requires_grad_(True) for t in pair]
    lk.reset_launch_counts()
    (lk.lstm_pair_recurrence(*leaves, mask).float() * dh.float()).sum().backward()
    torch.cuda.synchronize()
    assert lk.LAUNCHES == dict.fromkeys(lk.LAUNCHES, 0) | {
        "lstm_pair_fwd_masked_bf16" if masked else "lstm_pair_fwd_bf16": 1,
        "lstm_pair_bwd_bf16": 1,
        "lstm_wgrad_bf16": 1,
    }
    monkeypatch.undo()
    ref = [t.detach().cpu().requires_grad_(True) for t in pair]
    out = lk.lstm_pair_recurrence(*ref, None if mask is None else mask.cpu())
    (out.float() * dh.float().cpu()).sum().backward()
    for got, want in zip(leaves, ref):
        assert got.grad.dtype == want.grad.dtype == BF16
        diff = (got.grad.cpu().double() - want.grad.double()).abs()
        bar = 2e-5 * max(float(want.grad.double().abs().max()), 1.0)
        assert not bool(((diff > bar) & (diff > 2 * _bf16_ulp(want.grad))).any())


def test_bf16_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    """Mixed dtypes, another type, and bf16 at the f32-only routes raise
    before any launch."""
    pair, mask, dh = _bf16_case(1, 4, 8, 6, cuda_device)
    x, w1, wi2, b2, w2 = pair
    before = dict(lk.LAUNCHES)
    with pytest.raises(TypeError, match="bfloat16 operands alike"):
        lk.lstm_pair_fwd_cuda(x, w1.float(), wi2, b2, w2)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        lk.lstm_pair_fwd_cuda(x.half(), w1.half(), wi2.half(), b2.half(),
                              w2.half())
    with pytest.raises(TypeError):
        lk.lstm_pair_bwd_cuda(dh, x, mask, dh, dh, dh, dh, w1, wi2, b2, w2)
    with pytest.raises(TypeError, match="queue 2"):
        lk.lstm_recurrence(x, w1)
    with pytest.raises(TypeError):
        lk.lstm_fwd_cuda(x, w1)
    with pytest.raises(TypeError, match="queue 2"):
        lk.lstm_pair_fwd_stacked_cuda(*(t[None] for t in pair))
    assert lk.LAUNCHES == before


def test_graphed_bf16_fit_equals_eager_fit(cuda_device, tmp_path):
    """Trainer.fit with precision=bf16-mixed for 2 epochs, graphed against
    eager from the same seed, dropout on: history, parameters and Adam
    moments bit-equal, the bf16 counters alike and no f32 pair launch."""
    from masters_thesis_tpu_torch.train.trainer import Trainer

    dm = _toy_datamodule(tmp_path)
    spec = ModelSpec(objective="combined", hidden_size=16, num_layers=2,
                     dropout=0.3, learning_rate=1e-3)
    runs, launches = {}, {}
    for graphs in (True, False):
        trainer = Trainer(max_epochs=2, gradient_clip_val=5.0, seed=3,
                          device=cuda_device, cuda_graphs=graphs,
                          precision="bf16-mixed")
        lk.reset_launch_counts()
        runs[graphs] = trainer.fit(spec, dm)
        launches[graphs] = dict(lk.LAUNCHES)
    assert launches[True] == launches[False]
    assert launches[True]["lstm_pair_fwd_masked_bf16"] == 2 * len(dm.train_range)
    assert launches[True]["lstm_pair_bwd_bf16"] == 2 * len(dm.train_range)
    assert not any(launches[True][k] for k in (
        "lstm_pair_fwd", "lstm_pair_fwd_masked", "lstm_pair_bwd", "lstm_wgrad"))
    assert runs[True].history == runs[False].history
    for name, value in runs[False].state.items():
        assert value.dtype == torch.float32
        assert torch.equal(runs[True].state[name], value), name
    for key in ("mu", "nu"):
        assert torch.equal(runs[True].opt_state[key], runs[False].opt_state[key])


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


@pytest.mark.parametrize("num_layers", [1, 2, 3, 4, 8])
def test_engine_on_the_card_matches_the_cpu(cuda_device, num_layers):
    """The engine on the card, each layer group through its kernel (at this
    small shape the reference's rule fuses every layer, up to 8)."""
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
    groups = gpu._module.layer_groups(10, 4 * 7, False, 7)
    assert groups == [num_layers]
    assert lk.LAUNCHES["lstm_fwd"] == int(num_layers == 1)
    assert lk.LAUNCHES["lstm_pair_fwd"] == int(num_layers == 2)
    assert lk.LAUNCHES["lstm_stack_fwd"] == int(num_layers >= 3)
    for g, w in zip(got, cpu.predict(x)):
        np.testing.assert_allclose(g, w, atol=5e-5, rtol=0)


# The mixed routes the encoder takes at T=60, H=64: pair + single, pair +
# pair, a stack then a single (model=large training: 7 + 1).
@pytest.mark.parametrize("groups", [[2, 1], [2, 2], [3, 1], [7, 1]])
def test_mixed_groups_on_the_card_match_the_cpu(cuda_device, monkeypatch,
                                                groups):
    """A training forward and backward with injected masks, the layers
    grouped as ``groups`` on both sides (set: at this small shape the rule
    fuses every layer), each group through its kernel on the card and its
    plain version on the CPU; outputs and every parameter gradient agree."""
    spec = ModelSpec(objective="mse", hidden_size=32, num_layers=sum(groups),
                     dropout=0.3)
    rng = np.random.default_rng(len(groups))
    x = torch.tensor(rng.normal(size=(25, 10, 3)), dtype=torch.float32)
    masks = [torch.tensor((rng.random((10, 25, 32)) >= 0.3) / 0.7,
                          dtype=torch.float32) for _ in range(sum(groups) - 1)]
    results = []
    for device in ("cpu", cuda_device):
        module = spec.build_module(
            device=device, generator=torch.Generator().manual_seed(5))
        monkeypatch.setattr(module, "layer_groups", lambda *a, **k: list(groups))
        lk.reset_launch_counts()
        alpha, beta = module(x.to(device), deterministic=False,
                             masks=[m.to(device) for m in masks])
        (alpha.sum() + beta.sum()).backward()
        results.append(([alpha, beta], [p.grad for p in module.parameters()]))
    torch.cuda.synchronize()
    stacks = sum(d >= 3 for d in groups)
    assert lk.LAUNCHES == dict.fromkeys(lk.LAUNCHES, 0) | {
        "lstm_fwd": groups.count(1),
        "lstm_bwd": groups.count(1),
        "lstm_pair_fwd_masked": groups.count(2),
        "lstm_pair_bwd": groups.count(2),
        "lstm_stack_fwd_masked": stacks,
        "lstm_stack_bwd": stacks,
        "lstm_wgrad": len(groups),
    }
    (cpu_out, cpu_grads), (gpu_out, gpu_grads) = results
    for g, w in zip(gpu_out, cpu_out):
        torch.testing.assert_close(g.cpu(), w.detach(), atol=5e-5, rtol=0)
    for g, w in zip(gpu_grads, cpu_grads):
        _close_rel(g.cpu(), w)


def _stack_case(seed, n_layers, rows, hidden, n_t=12, masked=True,
                device="cpu"):
    """x1_proj, the weights ``(w_hh, w_in, biases)``, the masks (or None) and
    a cotangent of the top layer's h."""
    rng = np.random.default_rng(seed)
    scale = 1.0 / np.sqrt(hidden)

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=device)

    x = t(rng.normal(size=(n_t, rows, 4 * hidden)))
    w_hh = [t(rng.uniform(-scale, scale, (hidden, 4 * hidden)))
            for _ in range(n_layers)]
    w_in = [t(rng.uniform(-scale, scale, (hidden, 4 * hidden)))
            for _ in range(n_layers - 1)]
    biases = [t(rng.uniform(-scale, scale, (4 * hidden,)))
              for _ in range(n_layers - 1)]
    masks = [t((rng.random((n_t, rows, hidden)) >= 0.2) / 0.8)
             for _ in range(n_layers - 1)] if masked else None
    return x, (w_hh, w_in, biases), masks, t(rng.normal(size=(n_t, rows, hidden)))


# Depths 3, 4, 7 (not a power of two) and 8; rows 1 to 803, so that the
# forward and the backward sweep take each of their row tiles (1, 2, 4 and 8
# rows: the fewest whose clusters all fit on the card at once), ragged ones
# included; H not a multiple of 4.
STACK_CASES = [(3, 1, 5), (3, 9, 16), (4, 25, 64), (4, 200, 64), (7, 37, 13),
               (7, 25, 64), (8, 203, 64), (8, 2, 64), (4, 1, 64), (4, 9, 64),
               (4, 100, 64), (4, 203, 64), (3, 803, 64)]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n_layers,rows,hidden", STACK_CASES)
def test_stack_kernels_match_plain(cuda_device, n_layers, rows, hidden, masked):
    """The stack forward (with and without its stashes, and a second
    stashed launch, bit for bit), its backward sweep (and a second sweep
    launch, bit for bit) and its 2L - 1 weight gradients, each against its
    plain version."""
    x, (w_hh, w_in, biases), masks, dh = _stack_case(
        rows + n_layers, n_layers, rows, hidden, masked=masked,
        device=cuda_device)
    want_hs, want_cs = lk.lstm_stack_ref(x, w_hh, w_in, biases, masks,
                                         return_stash=True)
    got_hs, got_cs = lk.lstm_stack_fwd_cuda(x, w_hh, w_in, biases, masks,
                                            stash=True)
    for g, w in zip(got_hs + got_cs, want_hs + want_cs):
        torch.testing.assert_close(g, w, atol=2e-5, rtol=0)
    again_hs, again_cs = lk.lstm_stack_fwd_cuda(x, w_hh, w_in, biases, masks,
                                                stash=True)
    for a, b in zip(again_hs + again_cs, got_hs + got_cs):
        assert torch.equal(a, b)
    top = lk.lstm_stack_fwd_cuda(x, w_hh, w_in, biases, masks)
    torch.testing.assert_close(top, want_hs[-1], atol=2e-5, rtol=0)
    args = (dh, x, masks, want_hs, want_cs, w_hh, w_in, biases)
    want = lk.lstm_stack_bwd_ref(*args)
    got = lk.lstm_stack_bwd_cuda(*args)
    for g, w in zip(got, want):
        _close_rel(g, w)
    for a, b in zip(lk.lstm_stack_bwd_cuda(*args), got):
        assert torch.equal(a, b)
    for got_group, want_group in zip(lk.lstm_stack_wgrad(want, want_hs, masks),
                                     lk.lstm_stack_wgrad_ref(want, want_hs, masks)):
        for g, w in zip(got_group, want_group):
            _close_rel(g, w)


def test_stack_cases_take_every_sweep_tile(cuda_device):
    """STACK_CASES reach every row tile of the stack's backward sweep and
    of both instances of its forward (maskless; masked with the stashes)."""
    for backward, masked, stash in ((True, False, False), (True, True, False),
                                    (False, False, False), (False, True, True)):
        tiles = {lk.lstm_stack_row_tile_cuda(n_layers, rows, hidden,
                                             cuda_device, backward=backward,
                                             masked=masked, stash=stash)
                 for n_layers, rows, hidden in STACK_CASES}
        assert tiles == {1, 2, 4, 8}, (backward, masked, stash, tiles)


@pytest.mark.parametrize("masked", [False, True])
def test_stack_gradients_go_through_the_kernels(cuda_device, monkeypatch,
                                                masked):
    """A CUDA tensor that needs a gradient runs the stack's stash forward,
    its sweep and one weight-gradient pass, never a plain version, and its
    gradients match autograd through the plain forward."""
    for name in ("lstm_stack_bwd_ref", "lstm_stack_wgrad_ref", "lstm_bwd_ref",
                 "lstm_stack_ref"):
        monkeypatch.setattr(lk, name, _refuse)
    x, weights, masks, dh = _stack_case(11, 4, 25, 64, masked=masked,
                                        device=cuda_device)
    flat = [x, *weights[0], *weights[1], *weights[2]]
    leaves = [t.clone().requires_grad_(True) for t in flat]
    lk.reset_launch_counts()
    out = lk.lstm_stack_recurrence(
        leaves[0], (leaves[1:5], leaves[5:8], leaves[8:11]), masks)
    (out * dh).sum().backward()
    torch.cuda.synchronize()
    assert lk.LAUNCHES == dict.fromkeys(lk.LAUNCHES, 0) | {
        "lstm_stack_fwd_masked" if masked else "lstm_stack_fwd": 1,
        "lstm_stack_bwd": 1,
        "lstm_wgrad": 1,
    }
    monkeypatch.undo()
    ref = [t.clone().requires_grad_(True) for t in flat]
    plain = lk.lstm_stack_ref(ref[0], ref[1:5], ref[5:8], ref[8:11], masks)
    (plain * dh).sum().backward()
    for got, want in zip(leaves, ref):
        _close_rel(got.grad, want.grad)


# ---------------------------------------------------- the stack in bf16
#
# The stack's bf16 instances against their plain versions on the card, by
# the pair's bf16 bar (_close_bf16): one ulp of the plain entry where the
# f32 bar misses, at least 99% within the bar; the sweep's f32 d_pre planes
# by the f32 bar.

# Depths 3, 4, 6 and 8 on the tiles of 1, 2, 4 and 8 rows (the training
# path's 25 and 100 rows among them); H 5, 13 (not a multiple of 4) and 64.
BF16_STACK_CASES = [(3, 1, 5), (3, 9, 16), (4, 25, 64), (4, 100, 64),
                    (6, 37, 13), (6, 203, 64), (8, 2, 64), (8, 25, 64),
                    (4, 803, 64)]


def _bf16_stack_case(seed, n_layers, rows, hidden, n_t=12, masked=True,
                     device="cuda"):
    x, (w_hh, w_in, biases), masks, dh = _stack_case(
        seed, n_layers, rows, hidden, n_t=n_t, masked=masked, device=device)

    def bf(group):
        return None if group is None else [t.to(BF16) for t in group]

    return (x.to(BF16), (bf(w_hh), bf(w_in), bf(biases)), bf(masks),
            dh.to(BF16))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n_layers,rows,hidden", BF16_STACK_CASES)
def test_bf16_stack_kernels_match_plain(cuda_device, n_layers, rows, hidden,
                                        masked):
    """The bf16 stack forward (with and without its stashes, a second
    stashed launch bit for bit), its bf16 sweep (dx1 bf16, every d_pre f32;
    a second launch bit for bit) and the bf16 pass over its 2L - 1 jobs,
    each against its plain version, each launch counted under its _bf16
    name."""
    x, weights, masks, dh = _bf16_stack_case(rows + n_layers + 1, n_layers,
                                             rows, hidden, masked=masked,
                                             device=cuda_device)
    want_hs, want_cs = lk.lstm_stack_ref(x, *weights, masks, return_stash=True)
    name = "lstm_stack_fwd_bf16" if masks is None else "lstm_stack_fwd_masked_bf16"
    before = dict(lk.LAUNCHES)
    got_hs, got_cs = lk.lstm_stack_fwd_cuda(x, *weights, masks, stash=True)
    assert lk.LAUNCHES[name] == before[name] + 1
    for g, w in zip(got_hs + got_cs, want_hs + want_cs):
        _close_bf16(g, w)
    again_hs, again_cs = lk.lstm_stack_fwd_cuda(x, *weights, masks, stash=True)
    for a, b in zip(again_hs + again_cs, got_hs + got_cs):
        assert torch.equal(a, b)
    _close_bf16(lk.lstm_stack_fwd_cuda(x, *weights, masks), want_hs[-1])
    args = (dh, x, masks, want_hs, want_cs, *weights)
    dx1, d_pres = lk.lstm_stack_bwd_bf16_cuda(*args)
    want_dx1, want_d_pres = lk.lstm_stack_bwd_bf16_ref(*args)
    _close_bf16(dx1, want_dx1, relative=True)
    assert len(d_pres) == n_layers
    for g, w in zip(d_pres, want_d_pres):
        assert g.dtype == torch.float32
        _close_rel(g, w)
    again = lk.lstm_stack_bwd_bf16_cuda(*args)
    assert torch.equal(again[0], dx1)
    for a, b in zip(again[1], d_pres):
        assert torch.equal(a, b)
    before = lk.LAUNCHES["lstm_wgrad_bf16"]
    got = lk.lstm_stack_wgrad(want_d_pres, want_hs, masks)
    assert lk.LAUNCHES["lstm_wgrad_bf16"] == before + 1
    want = lk.lstm_stack_wgrad_ref(want_d_pres, want_hs, masks)
    for got_group, want_group in zip(got, want):
        assert len(got_group) == len(want_group)
        for g, w in zip(got_group, want_group):
            _close_bf16(g, w, relative=True)


@pytest.mark.parametrize("n_layers,rows", [(4, 3200), (6, 3200), (8, 800)])
def test_bf16_stack_forward_at_evaluation_chunks(cuda_device, n_layers, rows):
    """The maskless bf16 forward at the evaluation chunks of a bf16 fit at
    T=60, H=64 (32 windows of 100 rows: model=medium's [4] and
    model=large's [6, 2]; 32 windows of 25 rows: model=large's [8]) against
    its plain version. At 3,200 rows no tile's clusters all fit at once, so
    the launch takes 8 rows in waves, as the f32 instance does."""
    x, weights, _, _ = _bf16_stack_case(rows + n_layers, n_layers, rows, 64,
                                        n_t=60, masked=False,
                                        device=cuda_device)
    tile = lk.lstm_stack_row_tile_cuda(n_layers, rows, 64, cuda_device,
                                       backward=False, dtype=BF16)
    assert tile == lk.lstm_stack_row_tile_cuda(n_layers, rows, 64, cuda_device,
                                               backward=False)
    if rows == 3200:
        assert tile == 8
    _close_bf16(lk.lstm_stack_fwd_cuda(x, *weights),
                lk.lstm_stack_ref(x, *weights))


def test_bf16_stack_tiles_are_the_f32_ones(cuda_device):
    """The bf16 instances take the f32 instances' row tiles (the same
    shared memory and cluster), for both directions, at every case."""
    for n_layers, rows, hidden in BF16_STACK_CASES:
        for backward, masked, stash in ((True, True, False), (False, True, True),
                                        (False, False, False)):
            tiles = [lk.lstm_stack_row_tile_cuda(
                n_layers, rows, hidden, cuda_device, backward=backward,
                masked=masked, stash=stash, dtype=dtype)
                for dtype in (torch.float32, BF16)]
            assert tiles[0] == tiles[1], (n_layers, rows, hidden, backward)


@pytest.mark.parametrize("masked", [False, True])
def test_bf16_stack_gradients_go_through_the_kernels(cuda_device, monkeypatch,
                                                     masked):
    """bf16 leaves that need a gradient run the bf16 stack forward with
    stashes, the bf16 sweep and one bf16 pass, never an f32 kernel or a
    plain backward, at model=medium's training shape (T=60, one 100-row
    window); the gradients are bf16 and match the plain sweep and pass on
    the forward kernel's own stashes (it repeats bit for bit). Against a
    CPU forward the stashes may flip a bf16 ulp, and at this depth and
    length a flip in a lower layer reaches the gates of the layers above:
    the forward is held to its plain version in
    test_bf16_stack_kernels_match_plain."""
    for name in ("lstm_stack_bwd_ref", "lstm_stack_bwd_bf16_ref",
                 "lstm_stack_wgrad_ref", "lstm_bwd_ref", "lstm_stack_ref"):
        monkeypatch.setattr(lk, name, _refuse)
    x, weights, masks, dh = _bf16_stack_case(13, 4, 100, 64, n_t=60,
                                             masked=masked, device=cuda_device)
    flat = [x, *weights[0], *weights[1], *weights[2]]
    leaves = [t.clone().requires_grad_(True) for t in flat]
    lk.reset_launch_counts()
    out = lk.lstm_stack_recurrence(
        leaves[0], (leaves[1:5], leaves[5:8], leaves[8:11]), masks)
    (out.float() * dh.float()).sum().backward()
    torch.cuda.synchronize()
    assert lk.LAUNCHES == dict.fromkeys(lk.LAUNCHES, 0) | {
        "lstm_stack_fwd_masked_bf16" if masked else "lstm_stack_fwd_bf16": 1,
        "lstm_stack_bwd_bf16": 1,
        "lstm_wgrad_bf16": 1,
    }
    monkeypatch.undo()
    with torch.no_grad():
        hs, cs = lk.lstm_stack_fwd_cuda(x, *weights, masks, stash=True)
        _close_bf16(out.detach(), hs[-1])
        assert torch.equal(out.detach(), hs[-1])
        dx1, d_pres = lk.lstm_stack_bwd_bf16_ref(dh, x, masks, hs, cs, *weights)
        dw_hh, dw_in, db = lk.lstm_stack_wgrad_ref(d_pres, hs, masks)
    for got, want in zip(leaves, [dx1, *dw_hh, *dw_in, *db]):
        assert got.grad.dtype == BF16
        _close_bf16(got.grad, want, relative=True)


def test_bf16_stack_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    """Mixed dtypes and the stack's replica axis in bf16 raise before any
    launch."""
    x, (w_hh, w_in, biases), masks, dh = _bf16_stack_case(3, 4, 9, 16,
                                                          device=cuda_device)
    before = dict(lk.LAUNCHES)
    with pytest.raises(TypeError, match="bfloat16 operands alike"):
        lk.lstm_stack_fwd_cuda(x, [w_hh[0].float(), *w_hh[1:]], w_in, biases)
    with pytest.raises(TypeError, match="bfloat16 operands alike"):
        lk.lstm_stack_fwd_cuda(x, w_hh, w_in, biases, [m.float() for m in masks])
    hs, cs = lk.lstm_stack_ref(x, w_hh, w_in, biases, masks, return_stash=True)
    with pytest.raises(TypeError, match="bfloat16 operands alike"):
        lk.lstm_stack_bwd_bf16_cuda(dh.float(), x, masks, hs, cs, w_hh, w_in,
                                    biases)
    with pytest.raises(TypeError):
        lk.lstm_stack_bwd_cuda(dh, x, masks, hs, cs, w_hh, w_in, biases)
    with pytest.raises(TypeError, match="queue 2"):
        lk.lstm_stack_fwd_stacked_cuda(x[None], [w[None] for w in w_hh],
                                       [w[None] for w in w_in],
                                       [b[None] for b in biases])
    with pytest.raises(TypeError, match="queue 2"):
        lk.lstm_stack_recurrence_stacked(x[None], ([w[None] for w in w_hh],
                                                   [w[None] for w in w_in],
                                                   [b[None] for b in biases]))
    assert lk.LAUNCHES == before


def test_graphed_bf16_medium_fit_equals_eager_fit(cuda_device, tmp_path):
    """Trainer.fit at precision=bf16-mixed on a 4-layer model (one 4-deep
    stack) for 2 epochs, graphed against eager from the same seed, dropout
    on: history, parameters and Adam moments bit-equal; each step launches
    the masked bf16 stack forward, the bf16 sweep and one bf16 pass, the
    validation the maskless bf16 forward, and nothing f32 or of the pair."""
    from masters_thesis_tpu_torch.train.trainer import Trainer

    dm = _toy_datamodule(tmp_path)
    spec = ModelSpec(objective="combined", hidden_size=16, num_layers=4,
                     dropout=0.3, learning_rate=1e-3)
    runs, launches = {}, {}
    for graphs in (True, False):
        trainer = Trainer(max_epochs=2, gradient_clip_val=5.0, seed=3,
                          device=cuda_device, cuda_graphs=graphs,
                          precision="bf16-mixed")
        lk.reset_launch_counts()
        runs[graphs] = trainer.fit(spec, dm)
        launches[graphs] = dict(lk.LAUNCHES)
    assert launches[True] == launches[False]
    steps = 2 * len(dm.train_range)
    trained = ("lstm_stack_fwd_masked_bf16", "lstm_stack_bwd_bf16",
               "lstm_wgrad_bf16")
    for name in trained:
        assert launches[True][name] == steps, name
    assert launches[True]["lstm_stack_fwd_bf16"] > 0
    assert not any(v for k, v in launches[True].items()
                   if k not in trained + ("lstm_stack_fwd_bf16",))
    assert runs[True].history == runs[False].history
    for name, value in runs[False].state.items():
        assert value.dtype == torch.float32
        assert torch.equal(runs[True].state[name], value), name
    for key in ("mu", "nu"):
        assert torch.equal(runs[True].opt_state[key], runs[False].opt_state[key])


def test_stack_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    x, (w_hh, w_in, biases), masks, dh = _stack_case(2, 9, 4, 8,
                                                     device=cuda_device)
    before = dict(lk.LAUNCHES)
    with pytest.raises(ValueError, match="3..8 layers, got 9"):
        lk.lstm_stack_recurrence(x, (w_hh, w_in, biases), masks)
    w_hh, w_in, biases, masks = w_hh[:4], w_in[:3], biases[:3], masks[:3]
    with pytest.raises(ValueError, match="3..8 layers, got 2"):
        lk.lstm_stack_fwd_cuda(x, w_hh[:2], w_in[:1], biases[:1])
    with pytest.raises(TypeError):
        lk.lstm_stack_recurrence(x.double(), ([w.double() for w in w_hh],
                                              [w.double() for w in w_in],
                                              [b.double() for b in biases]))
    with pytest.raises(TypeError):
        lk.lstm_stack_recurrence(*_grad_leaves(x.double(), w_hh, w_in, biases))
    strided = masks[1].transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        lk.lstm_stack_recurrence(x, (w_hh, w_in, biases),
                                 [masks[0], strided, masks[2]])
    with pytest.raises(ValueError, match="masks\\[2\\] has shape"):
        lk.lstm_stack_fwd_cuda(x, w_hh, w_in, biases,
                               masks[:2] + [masks[2][:, :, :4].contiguous()])
    wide = lk.MAX_HIDDEN + 1
    big = torch.zeros((2, 3, 4 * wide), device=cuda_device)
    wide_w = [torch.zeros((wide, 4 * wide), device=cuda_device) for _ in range(3)]
    wide_b = [torch.zeros((4 * wide,), device=cuda_device) for _ in range(2)]
    with pytest.raises(ValueError, match="outside the kernels' range"):
        lk.lstm_stack_recurrence(big, (wide_w, wide_w[:2], wide_b))
    hs, cs = lk.lstm_stack_ref(x, w_hh, w_in, biases, masks, return_stash=True)
    with pytest.raises(ValueError, match="contiguous"):
        lk.lstm_stack_bwd_cuda(dh.transpose(0, 1).contiguous().transpose(0, 1),
                               x, masks, hs, cs, w_hh, w_in, biases)
    assert lk.LAUNCHES == before


def _grad_leaves(x, w_hh, w_in, biases):
    """Leaves that need a gradient, in f64: the training path."""
    return (x.requires_grad_(True),
            ([w.double().requires_grad_(True) for w in w_hh],
             [w.double().requires_grad_(True) for w in w_in],
             [b.double().requires_grad_(True) for b in biases]))


# ------------------------------------------------------ time-blocked kernels

LENGTHS = ["chunk-1", "chunk", "chunk+1", "252"]


def _length(name, chunk):
    """A time length around the kernel's chunk: one chunk cut short, exactly
    one, one and a step (a ragged last chunk), or a one-year lookback."""
    return {"chunk-1": max(1, chunk - 1), "chunk": chunk, "chunk+1": chunk + 1,
            "252": 252}[name]


# The sweeps' rows: both kernels take the sweeps' tiles (1 row at up to 100
# rows, 2 at 133 and 203, 8 at 800 and 803; ragged at 203 and 803); H 1, 5
# and 13 padded, and H=64.
@pytest.mark.parametrize("length", LENGTHS)
@pytest.mark.parametrize("hidden", [1, 5, 13, 64])
@pytest.mark.parametrize("rows", SWEEP_ROWS)
def test_time_blocked_kernels_match_plain(cuda_device, rows, hidden, length):
    """The time-blocked forward (h and c, and again bit for bit) and
    backward (dx and dw) against their plain versions, at lengths around
    each kernel's own time chunk; the forward's h and c bit-equal to the
    resident forward's, and the backward's dx to the resident sweep's: each
    pair runs one step on one tile."""
    for backward in (False, True):
        chunk = lk.lstm_tb_time_chunk_cuda(252, rows, hidden, cuda_device,
                                           backward)
        n_t = _length(length, chunk)
        x, w1, *_ = _case(rows * hidden + n_t, rows, hidden, n_t=n_t,
                          device=cuda_device)
        _, dh = _mask_and_cotangent(rows + n_t, n_t, rows, hidden, cuda_device)
        hs, cs = lk.lstm_tb_fwd_ref(x, w1, chunk)
        if not backward:
            got_hs, got_cs = lk.lstm_tb_fwd_cuda(x, w1, return_c=True)
            torch.testing.assert_close(got_hs, hs, atol=2e-5, rtol=0)
            torch.testing.assert_close(got_cs, cs, atol=2e-5, rtol=0)
            torch.testing.assert_close(lk.lstm_tb_fwd_cuda(x, w1), got_hs,
                                       atol=0, rtol=0)
            for a, b in zip(lk.lstm_tb_fwd_cuda(x, w1, return_c=True),
                            (got_hs, got_cs)):
                assert torch.equal(a, b)
            for a, b in zip(lk.lstm_fwd_cuda(x, w1, return_c=True),
                            (got_hs, got_cs)):
                assert torch.equal(a, b)
            continue
        dx, dw = lk.lstm_tb_bwd_cuda(dh, x, hs, cs, w1)
        want_dx, want_dw = lk.lstm_tb_bwd_ref(dh, x, hs, cs, w1, chunk,
                                              lk._row_tile(rows))
        _close_rel(dx, want_dx)
        _close_rel(dw, want_dw)
        assert torch.equal(dx, lk.lstm_bwd_cuda(dh, x, hs, cs, w1))


# A kernel that leaves NaN in all of every SM's shared memory, built from
# this source with the port's own nvcc flags.
_NAN_FILL_SOURCE = r"""
#include <cuda_runtime.h>

__global__ void nan_fill_kernel(int n) {
  extern __shared__ float smem[];
  volatile float* s = smem;  // stores that nothing reads are kept
  for (int i = threadIdx.x; i < n; i += blockDim.x) s[i] = __int_as_float(0x7fffffff);
}

extern "C" int fill_shared_with_nan(int device, cudaStream_t stream) {
  int limit = 0, sms = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 device);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(nan_fill_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  nan_fill_kernel<<<4 * sms, 1024, limit, stream>>>(limit / 4);
  return static_cast<int>(cudaGetLastError());
}
"""


@pytest.fixture(scope="module")
def fill_shared_with_nan(tmp_path_factory):
    import ctypes
    import subprocess

    from masters_thesis_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    folder = tmp_path_factory.mktemp("nan_fill")
    src, lib = folder / "nan_fill.cu", folder / "libnan_fill.so"
    src.write_text(_NAN_FILL_SOURCE)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True, capture_output=True)
    fill = ctypes.CDLL(str(lib)).fill_shared_with_nan
    fill.argtypes = [ctypes.c_int, ctypes.c_void_p]

    def run(device):
        index = torch.cuda.current_device() if device.index is None else device.index
        assert fill(index, torch.cuda.current_stream(device).cuda_stream) == 0

    return run


@pytest.mark.parametrize("rows,n_t", [(1, 1), (3, 2), (100, 252), (803, 60)])
def test_backward_sweeps_read_no_shared_memory_they_did_not_write(
        cuda_device, fill_shared_with_nan, rows, n_t):
    """Both single-layer backward sweeps, both single-layer forwards, the
    pair forward (maskless, and masked with its stashes), the stack's
    forward (maskless, and masked with its stashes) and backward sweep
    (maskless and masked, 4 and 8 layers) and the weight-gradient pass (the
    pair's 3 jobs, a stack's 2L - 1), each launched right after a kernel
    that leaves NaN in every SM's shared memory, give what they give after a
    clean run, bit for bit: no step reads a plane it has not written (a read
    times zero is NaN all the same); the double-buffered planes, the stack's
    inboxes and the pass's ring of stages are what could."""
    x, w1, wi2, b2, w2 = _case(rows + n_t + 3, rows, 64, n_t=n_t,
                               device=cuda_device)
    mask, dh = _mask_and_cotangent(rows + n_t + 3, n_t, rows, 64, cuda_device)
    hs, cs = lk.lstm_tb_fwd_ref(x, w1, 16)
    calls = [
        lambda: lk.lstm_tb_bwd_cuda(dh, x, hs, cs, w1),
        lambda: lk.lstm_bwd_cuda(dh, x, hs, cs, w1),
        lambda: lk.lstm_tb_fwd_cuda(x, w1, return_c=True),
        lambda: lk.lstm_pair_fwd_cuda(x, w1, wi2, b2, w2),
        lambda: lk.lstm_pair_fwd_cuda(x, w1, wi2, b2, w2, mask, stash=True),
        lambda: lk.lstm_fwd_cuda(x, w1, return_c=True),
    ]
    h2s, h1s, c1s, c2s = lk.lstm_pair_ref(x, w1, wi2, b2, w2, mask,
                                          return_stash=True)
    dx1, d_pre2 = lk.lstm_pair_bwd_ref(dh, x, mask, h1s, c1s, h2s, c2s, w1,
                                       wi2, b2, w2)
    calls.append(lambda: lk.lstm_pair_wgrad(dx1, d_pre2, h1s, h2s, mask))
    for n_layers in (4, 8):
        for masked in (False, True):
            sx, weights, masks, sdh = _stack_case(rows + n_layers, n_layers,
                                                  rows, 64, n_t=n_t,
                                                  masked=masked,
                                                  device=cuda_device)
            shs, scs = lk.lstm_stack_ref(sx, *weights, masks, return_stash=True)
            calls.append(lambda a=(sdh, sx, masks, shs, scs, *weights):
                         tuple(lk.lstm_stack_bwd_cuda(*a)))
            fwd = (sx, *weights, masks)
            if masked:
                calls.append(lambda a=fwd: tuple(
                    t for plane in lk.lstm_stack_fwd_cuda(*a, stash=True)
                    for t in plane))
            else:
                calls.append(lambda a=fwd: lk.lstm_stack_fwd_cuda(*a))
            d_pres = lk.lstm_stack_bwd_ref(sdh, sx, masks, shs, scs, *weights)
            calls.append(lambda a=(d_pres, shs, masks): tuple(
                t for group in lk.lstm_stack_wgrad(*a) for t in group))
    for call in calls:
        want = _as_tuple(call())
        fill_shared_with_nan(cuda_device)
        got = _as_tuple(call())
        for g, w in zip(got, want):
            assert bool(torch.isfinite(w).all())
            assert torch.equal(g, w)


def test_time_blocked_weight_gradient_repeats_bit_for_bit(cuda_device):
    x, w1, *_ = _case(4, 203, 64, n_t=252, device=cuda_device)
    _, dh = _mask_and_cotangent(4, 252, 203, 64, cuda_device)
    hs, cs = lk.lstm_tb_fwd_cuda(x, w1, return_c=True)
    first = lk.lstm_tb_bwd_cuda(dh, x, hs, cs, w1)
    second = lk.lstm_tb_bwd_cuda(dh, x, hs, cs, w1)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_long_lookback_goes_through_the_time_blocked_kernels(cuda_device,
                                                             monkeypatch):
    """lstm_recurrence at T=252 on 100 rows, as the reference routes it:
    the time-blocked forward and backward, never the resident kernels or a
    plain version; gradients as autograd through the plain forward."""
    assert lk.single_layer_route(252, 100, 64) == "pallas-timeblocked"
    for name in ("lstm_tb_fwd_ref", "lstm_tb_bwd_ref", "lstm_bwd_ref"):
        monkeypatch.setattr(lk, name, _refuse)
    x, w1, *_ = _case(6, 100, 64, n_t=252, device=cuda_device)
    _, dh = _mask_and_cotangent(6, 252, 100, 64, cuda_device)
    leaves = [t.clone().requires_grad_(True) for t in (x, w1)]
    lk.reset_launch_counts()
    (lk.lstm_recurrence(*leaves) * dh).sum().backward()
    with torch.no_grad():
        served = lk.lstm_recurrence(x, w1, window_rows=100)
    torch.cuda.synchronize()
    assert lk.LAUNCHES == dict.fromkeys(lk.LAUNCHES, 0) | {
        "lstm_tb_fwd": 2, "lstm_tb_bwd": 1}
    monkeypatch.undo()
    ref = [t.clone().requires_grad_(True) for t in (x, w1)]
    plain = lk.lstm_recurrence_ref(*ref)
    (plain * dh).sum().backward()
    torch.testing.assert_close(served, plain.detach(), atol=2e-5, rtol=0)
    for got, want in zip(leaves, ref):
        _close_rel(got.grad, want.grad)


def test_time_blocked_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    x, w1, *_ = _case(1, 4, 8, n_t=20, device=cuda_device)
    h = torch.zeros(x.shape[:2] + (8,), device=cuda_device)
    before = dict(lk.LAUNCHES)
    with pytest.raises(TypeError):
        lk.lstm_tb_fwd_cuda(x.double(), w1.double())
    with pytest.raises(ValueError, match="contiguous"):
        lk.lstm_tb_fwd_cuda(x.transpose(0, 1).contiguous().transpose(0, 1), w1)
    with pytest.raises(TypeError):
        lk.lstm_tb_bwd_cuda(h.double(), x, h, h, w1)
    with pytest.raises(ValueError, match="contiguous"):
        lk.lstm_tb_bwd_cuda(h, x, h.transpose(0, 1).contiguous().transpose(0, 1),
                            h, w1)
    wide = lk.MAX_HIDDEN + 1
    big = torch.zeros((2, 3, 4 * wide), device=cuda_device)
    big_w = torch.zeros((wide, 4 * wide), device=cuda_device)
    with pytest.raises(ValueError, match="outside the kernels' range"):
        lk.lstm_tb_fwd_cuda(big, big_w)
    big_h = torch.zeros((2, 3, wide), device=cuda_device)
    with pytest.raises(ValueError, match="outside the kernels' range"):
        lk.lstm_tb_bwd_cuda(big_h, big, big_h, big_h, big_w)
    assert lk.LAUNCHES == before


def test_train_entry_point_on_the_card_matches_the_cpu(cuda_device, tmp_path):
    """``python -m masters_thesis_tpu_torch train`` at toy shape (4 stocks x
    1,200 samples, lookback 10, target 5, H=8) on the card against the same
    run with ``--device cpu``. Dropout 0 and batch_size the whole train split
    (56 windows) make the epoch one step whatever the shuffle, so the first
    epoch's train loss (the initial weights') and val loss (after one step
    through the forward and backward kernels and FlatAdam) agree within
    1e-5 relative."""
    from masters_thesis_tpu_torch.cli.train import main as train_main
    from masters_thesis_tpu_torch.train.logging import read_records

    common = ["datamodule.n_stocks=4", "datamodule.n_samples=1200",
              "datamodule.lookback_window=10", "datamodule.target_window=5",
              "datamodule.stride=15", "datamodule.batch_size=56",
              "model.hidden_size=8", "model.dropout=0.0",
              "trainer.max_epochs=1", f"datamodule.data_dir={tmp_path / 'data'}",
              f"logger.save_dir={tmp_path}"]
    lk.reset_launch_counts()
    train_main([*common, "logger.version=card"])
    assert sum(lk.LAUNCHES.values()) > 0
    train_main(["--device", "cpu", *common, "logger.version=cpu"])
    rows = {}
    for version in ("card", "cpu"):
        records = read_records(tmp_path / "FinancialLstm" / "synthetic" / version)
        rows[version] = [r for r in records if "lr-Adam" in r][0]
    for key in ("loss/total/train", "loss/total/val"):
        assert rows["card"][key] == pytest.approx(rows["cpu"][key], rel=1e-5)


# ------------------------------------------------------------- CUDA graphs


def test_flat_adam_device_scalars_equal_the_python_scalar_update(cuda_device):
    """On the card, FlatAdam's device count and rate against its update with
    Python scalars: 10 steps, some clipped, the rate halved after 5,
    bit-equal after every step."""
    from test_torch_graphs import PythonScalarAdam, _Vector

    from masters_thesis_tpu_torch.train.flatparams import FlatAdam

    rng = np.random.default_rng(0)
    p0 = rng.normal(size=4099).astype(np.float32)
    ref = PythonScalarAdam(_Vector(p0).to(cuda_device), 5.0, 1e-5)
    got = FlatAdam(_Vector(p0).to(cuda_device), 5.0, 1e-5)
    for i in range(10):
        g = rng.normal(0, 0.1 if i not in (2, 7) else 10.0, size=p0.shape)
        for opt in (ref, got):
            opt.grads.copy_(torch.tensor(g, dtype=torch.float32))
        lr = 1e-2 if i < 5 else 5e-3
        ref.step(lr)
        got.step(lr)
        for a, b in ((got.params, ref.params), (got.mu, ref.mu),
                     (got.nu, ref.nu)):
            assert torch.equal(a, b), i


def _toy_datamodule(tmp_path, stocks=4):
    from masters_thesis_tpu_torch.data.pipeline import (
        FinancialWindowDataModule,
        bootstrap_synthetic,
    )

    bootstrap_synthetic(tmp_path / "data", n_stocks=stocks, n_samples=1200,
                        seed=0)
    return FinancialWindowDataModule(tmp_path / "data", lookback_window=10,
                                     target_window=5, stride=15)


@pytest.mark.parametrize("num_layers", [2, 4])
def test_graphed_fit_equals_eager_fit(cuda_device, tmp_path, num_layers):
    """Trainer.fit for 2 epochs with CUDA graphs (the default) against
    cuda_graphs=False from the same seed, dropout on (a pair at 2 layers,
    a 4-deep stack at 4): every history value, parameter and Adam moment
    bit-equal, the same launch counts (replays counted), and
    Trainer.test's metrics equal."""
    from masters_thesis_tpu_torch.train.trainer import Trainer

    dm = _toy_datamodule(tmp_path)
    spec = ModelSpec(objective="combined", hidden_size=16,
                     num_layers=num_layers, dropout=0.3, learning_rate=1e-3)
    runs, launches, tests = {}, {}, {}
    for graphs in (True, False):
        trainer = Trainer(max_epochs=2, gradient_clip_val=5.0, seed=3,
                          device=cuda_device, cuda_graphs=graphs)
        lk.reset_launch_counts()
        runs[graphs] = trainer.fit(spec, dm)
        launches[graphs] = dict(lk.LAUNCHES)
        tests[graphs] = trainer.test(spec, runs[graphs].state, dm)
    masked = "lstm_pair_fwd_masked" if num_layers == 2 else "lstm_stack_fwd_masked"
    assert launches[True] == launches[False]
    assert launches[True][masked] == 2 * len(dm.train_range)
    assert runs[True].history == runs[False].history
    for name, value in runs[False].state.items():
        assert torch.equal(runs[True].state[name], value), name
    for key in ("mu", "nu"):
        assert torch.equal(runs[True].opt_state[key], runs[False].opt_state[key])
    assert runs[True].opt_state["count"] == runs[False].opt_state["count"]
    assert tests[True] == tests[False]


def test_graphed_engine_equals_the_eager_engine_per_bucket(cuda_device):
    """Every bucket's graph against the same engine with cuda_graphs=False,
    full and padded batches, bit-equal; warmup captures every bucket."""
    spec = ModelSpec(objective="mse", hidden_size=32, num_layers=2,
                     dropout=0.0)
    state = spec.build_module(
        device="cpu", generator=torch.Generator().manual_seed(0)).state_dict()
    kw = dict(n_stocks=7, lookback=10, n_features=3, buckets=(1, 2, 4, 8),
              device=cuda_device)
    graphed = PredictEngine(spec, state, **kw)
    eager = PredictEngine(spec, state, cuda_graphs=False, **kw)
    graphed.warmup()
    eager.warmup()
    assert graphed.compile_events == 4 and eager.compile_events == 0
    rng = np.random.default_rng(1)
    lk.reset_launch_counts()
    for n in (1, 2, 3, 4, 5, 8, 8, 1):
        x = rng.normal(size=(n, 7, 10, 3)).astype(np.float32)
        for g, e in zip(graphed.predict(x), eager.predict(x)):
            np.testing.assert_array_equal(g, e)
    assert lk.LAUNCHES["lstm_pair_fwd"] == 2 * 8  # replays counted
    assert graphed.compile_events == 4


def test_a_launch_off_the_capturing_stream_fails_the_capture(cuda_device):
    """With a capture underway on another stream, a kernel wrapper raises
    before it launches (the guard alone); inside a real capture, work on a
    second stream fails the capture (CUDA's own checks may refuse it
    first), and nothing runs it eagerly instead."""
    from masters_thesis_tpu_torch.utils.cuda_graph import CaptureError, GraphedCall

    x, w1, *_ = _case(0, 9, 16, device=cuda_device)
    other = torch.cuda.Stream(cuda_device)
    before = dict(lk.LAUNCHES)
    with lk.capturing(other):
        with pytest.raises(RuntimeError, match="outside the CUDA graph"):
            lk.lstm_fwd_cuda(x, w1)
    assert lk.LAUNCHES == before

    def body():
        lk.lstm_fwd_cuda(x, w1)
        with torch.cuda.stream(other):
            lk.lstm_fwd_cuda(x, w1)

    call = GraphedCall(body, device=cuda_device, name="two streams")
    with pytest.raises(CaptureError, match="capturing two streams failed"):
        call()
    assert not call.captured
    torch.cuda.synchronize()


def test_a_sync_inside_the_step_fails_the_capture(cuda_device, monkeypatch):
    """A kernel wrapper that synchronises (monkeypatched) makes the training
    step's capture raise; nothing runs the step eagerly instead."""
    from masters_thesis_tpu_torch.data.pipeline import Batch
    from masters_thesis_tpu_torch.train.flatparams import FlatAdam
    from masters_thesis_tpu_torch.train.steps import TrainProgram
    from masters_thesis_tpu_torch.utils.cuda_graph import CaptureError

    real = lk.lstm_pair_fwd_cuda

    def syncing(*args, **kwargs):
        torch.cuda.synchronize()
        return real(*args, **kwargs)

    monkeypatch.setattr(lk, "lstm_pair_fwd_cuda", syncing)
    spec = ModelSpec(objective="mse", hidden_size=16, num_layers=2, dropout=0.2)
    module = spec.build_module(device=cuda_device)
    rng = np.random.default_rng(0)
    data = Batch(*(torch.tensor(rng.normal(size=s), dtype=torch.float32,
                                device=cuda_device)
                   for s in ((4, 5, 8, 3), (4, 5, 6, 4), (4, 2), (4, 5))))
    data.inv_psi.abs_().add_(1.0)
    data.factor[:, 1].abs_().add_(0.5)
    program = TrainProgram(module, FlatAdam(module, 5.0, 1e-5),
                           spec.window_objective(), data, 1,
                           torch.Generator(device=cuda_device).manual_seed(0),
                           graphed=True)
    program.begin_epoch(1e-3)
    with pytest.raises(CaptureError):
        program.step()
    assert not program.step.captured
    monkeypatch.undo()
    torch.cuda.synchronize()


# ------------------------------------------------------------ stream epoch


def _stream_fit(dm, spec, device, **trainer_kw):
    from masters_thesis_tpu_torch.train.trainer import Trainer

    trainer = Trainer(max_epochs=2, gradient_clip_val=5.0, seed=3,
                      device=device, epoch_mode="stream", **trainer_kw)
    lk.reset_launch_counts()
    result = trainer.fit(spec, dm)
    return result, dict(lk.LAUNCHES)


def _assert_runs_bit_equal(got, want):
    for key in ("loss/total/train", "loss/total/val", "lr-Adam"):
        assert [r[key] for r in got.history] == [r[key] for r in want.history]
    for name, value in want.state.items():
        assert torch.equal(got.state[name], value), name
    for key in ("mu", "nu"):
        assert torch.equal(got.opt_state[key], want.opt_state[key])
    assert got.opt_state["count"] == want.opt_state["count"]


@pytest.mark.parametrize("num_layers", [2, 4])
def test_stream_prefetch_depth_two_equals_depth_zero(cuda_device, tmp_path,
                                                     num_layers):
    """The stream epoch (batch_size 3, a padded tail, dropout on) with the
    prefetcher two batches ahead against no prefetch, graphed: every
    history value, parameter and Adam moment bit-equal. A pinned or device
    buffer rewritten while a copy or a replay still read it would show
    here."""
    dm = _toy_datamodule(tmp_path)
    dm.batch_size = 3
    spec = ModelSpec(objective="combined", hidden_size=16,
                     num_layers=num_layers, dropout=0.3, learning_rate=1e-3)
    deep, deep_launches = _stream_fit(dm, spec, cuda_device, prefetch=2)
    flat, flat_launches = _stream_fit(dm, spec, cuda_device, prefetch=0)
    _assert_runs_bit_equal(deep, flat)
    assert deep_launches == flat_launches
    masked = "lstm_pair_fwd_masked" if num_layers == 2 else "lstm_stack_fwd_masked"
    assert deep_launches[masked] == 2 * -(-len(dm.train_range) // 3)
    assert all(0 < r["data/prefetch_mean_depth"] <= 2 for r in deep.history)


def test_graphed_stream_step_equals_the_eager_one(cuda_device, tmp_path):
    """The stream epoch's step as one CUDA graph (captured once, the
    padded tail replayed through it) against cuda_graphs=False."""
    dm = _toy_datamodule(tmp_path)
    dm.batch_size = 3
    spec = ModelSpec(objective="mse", hidden_size=16, num_layers=2,
                     dropout=0.3, learning_rate=1e-3)
    graphed, graphed_launches = _stream_fit(dm, spec, cuda_device)
    eager, eager_launches = _stream_fit(dm, spec, cuda_device,
                                        cuda_graphs=False)
    _assert_runs_bit_equal(graphed, eager)
    assert graphed_launches == eager_launches


def test_stream_fit_on_the_card_matches_the_cpu(cuda_device, tmp_path):
    """Dropout 0: the card's stream epoch against the CPU port's, 1e-5
    relative (losses) and 1e-5 abs (parameters)."""
    dm = _toy_datamodule(tmp_path)
    dm.batch_size = 3
    spec = ModelSpec(objective="mse", hidden_size=16, num_layers=2,
                     dropout=0.0, learning_rate=1e-3)
    card, _ = _stream_fit(dm, spec, cuda_device)
    cpu, _ = _stream_fit(dm, spec, "cpu")
    for g, w in zip(card.history, cpu.history):
        for key in ("loss/total/train", "loss/total/val"):
            assert g[key] == pytest.approx(w[key], rel=1e-5), key
    for name, value in cpu.state.items():
        torch.testing.assert_close(card.state[name], value, rtol=0, atol=1e-5)


def test_prefetcher_copies_to_the_card(cuda_device):
    from masters_thesis_tpu_torch.data.prefetch import (
        PrefetchStats,
        prefetch_to_device,
    )

    rng = np.random.default_rng(0)
    items = [(rng.normal(size=(3, 5)).astype(np.float32),
              rng.normal(size=(3,)).astype(np.float32)) for _ in range(6)]
    for size in (0, 2):
        stats = PrefetchStats()
        got = list(prefetch_to_device(iter(items), size, cuda_device, stats))
        torch.cuda.synchronize()
        for (a, b), (x, w) in zip(got, items):
            assert a.device.type == b.device.type == "cuda"
            np.testing.assert_array_equal(a.cpu().numpy(), x)
            np.testing.assert_array_equal(b.cpu().numpy(), w)
        assert stats.gets == stats.yields == 6 and stats.exhausted


def test_the_collector_is_off_inside_a_capture(cuda_device):
    """A program and its GraphedCall refer to each other, so a dead
    program's graph is freed by the cyclic collector, whenever that runs;
    destroying a graph inside another capture invalidates the capture
    (seen as a rare CaptureError of the stream epoch's step). So the
    collector is off while a capture runs, and as it was afterwards; the
    warm-up and the replays leave it alone."""
    import gc

    from masters_thesis_tpu_torch.utils.cuda_graph import GraphedCall

    x = torch.arange(8.0, device=cuda_device)
    out = torch.zeros_like(x)
    seen = []

    def body():
        out.copy_(x * 2)
        seen.append((torch.cuda.is_current_stream_capturing(), gc.isenabled()))

    for enabled in (True, False):
        (gc.enable if enabled else gc.disable)()
        try:
            seen.clear()
            call = GraphedCall(body, device=cuda_device, name="collector")
            call()
            call()
            torch.cuda.synchronize()
            assert seen == [(False, enabled), (True, False)]
            assert gc.isenabled() == enabled and torch.equal(out, x * 2)
        finally:
            gc.enable()


def test_graphed_stream_fits_repeat_without_a_capture_error(cuda_device,
                                                            tmp_path):
    """Graphed stream fits one after another in one process (6 rounds of
    2 and 4 layers, prefetch 2 and 0): each fit's programs become garbage
    that the collector frees at its next run, which must not fall inside
    a later fit's capture. Before the collector was kept off during a
    capture, this loop failed about one fit in six."""
    dm = _toy_datamodule(tmp_path)
    dm.batch_size = 3
    for _ in range(6):
        for num_layers in (2, 4):
            spec = ModelSpec(objective="combined", hidden_size=16,
                             num_layers=num_layers, dropout=0.3,
                             learning_rate=1e-3)
            for prefetch in (2, 0):
                _stream_fit(dm, spec, cuda_device, prefetch=prefetch)


def test_stream_steps_do_not_synchronise(cuda_device, tmp_path):
    """A graphed stream epoch (the prefetcher two ahead, the padded tail)
    under the synchronisation check set to raise, after its capture: no
    step waits for the card."""
    from masters_thesis_tpu_torch.data.prefetch import prefetch_to_device
    from masters_thesis_tpu_torch.train.optim import make_optimizer
    from masters_thesis_tpu_torch.train.steps import (
        StreamProgram,
        weighted_batches,
    )

    dm = _toy_datamodule(tmp_path)
    dm.batch_size = 3
    dm.prepare_data()
    dm.setup("fit")
    spec = ModelSpec(objective="mse", hidden_size=16, num_layers=2,
                     dropout=0.3)
    module = spec.build_module(device=cuda_device)
    program = StreamProgram(module, make_optimizer(module, 5.0, 1e-5),
                            spec.window_objective(), dm.train_arrays(), 3,
                            torch.Generator(device=cuda_device).manual_seed(0),
                            graphed=True)

    def epoch():
        return program.epoch(1e-3, prefetch_to_device(
            weighted_batches(dm.train_batches(0, seed=0), 3), 2, cuda_device))

    epoch()  # the capture
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, n_steps = epoch()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert n_steps == -(-len(dm.train_range) // 3)


# ------------------------------------------------------- hot-swap on the card


def _swap_case(tmp_path, buckets=(1, 2, 4, 8)):
    """A graphed engine on seeded weights, and published candidates: other
    seeded weights, the same with a NaN bias, and a 3-layer model's."""
    from masters_thesis_tpu_torch.train.checkpoint import save_checkpoint

    spec = ModelSpec(objective="mse", hidden_size=32, num_layers=2,
                     dropout=0.0)

    def state(seed, s=spec):
        return s.build_module(
            device="cpu", generator=torch.Generator().manual_seed(seed)
        ).state_dict()

    meta = {"epoch": 0, "datamodule": {"lookback_window": 10}}
    dirs = {}
    for name, s, sd in (("live", spec, state(0)), ("good", spec, state(1)),
                        ("nan", spec, {**state(2), "alpha_head.bias":
                                       torch.tensor([float("nan")])}),
                        ("deep", ModelSpec(objective="mse", hidden_size=32,
                                           num_layers=3, dropout=0.0),
                         None)):
        dirs[name] = tmp_path / name
        save_checkpoint(dirs[name], "best", state(3, s) if sd is None else sd,
                        spec=s, meta=meta)
    kw = dict(n_stocks=7, buckets=buckets, device="cuda")
    return dirs, kw


def test_committed_swap_equals_a_fresh_graphed_engine(cuda_device, tmp_path):
    from masters_thesis_tpu_torch.serve.swap import CheckpointSwapper

    dirs, kw = _swap_case(tmp_path)
    live = PredictEngine.from_checkpoint(dirs["live"], **kw)
    live.warmup()
    captures = live.compile_events
    verdict = CheckpointSwapper(live).try_swap(dirs["good"])
    assert verdict.ok and verdict.reason == "committed"
    fresh = PredictEngine.from_checkpoint(dirs["good"], **kw)
    fresh.warmup()
    rng = np.random.default_rng(3)
    for n in (1, 2, 3, 8):
        x = rng.normal(size=(n, 7, 10, 3)).astype(np.float32)
        for got, want in zip(live.predict(x), fresh.predict(x)):
            np.testing.assert_array_equal(got, want)
    assert live.compile_events == captures == 4


@pytest.mark.parametrize("candidate,reason", [
    ("good", "committed"), ("nan", "canary_nonfinite"),
    ("deep", "shape_mismatch")])
def test_a_canary_captures_nothing_and_a_refusal_changes_nothing(
        cuda_device, tmp_path, candidate, reason):
    from masters_thesis_tpu_torch.serve.swap import CheckpointSwapper

    dirs, kw = _swap_case(tmp_path)
    live = PredictEngine.from_checkpoint(dirs["live"], **kw)
    live.warmup()
    swapper = CheckpointSwapper(live)
    x = np.random.default_rng(4).normal(size=(5, 7, 10, 3)).astype(np.float32)
    before = live.predict(x), live.predict(swapper.golden_x)
    captures = live.compile_events
    verdict = swapper.try_swap(dirs[candidate])
    assert verdict.reason == reason
    assert live.compile_events == captures
    after = live.predict(x), live.predict(swapper.golden_x)
    same = all(np.array_equal(g, w) for pair in zip(after, before)
               for g, w in zip(*pair))
    assert same == (not verdict.ok)


def test_a_bucket_captured_after_a_swap_serves_the_new_weights(cuda_device,
                                                                tmp_path):
    from masters_thesis_tpu_torch.serve.swap import CheckpointSwapper

    dirs, kw = _swap_case(tmp_path)
    live = PredictEngine.from_checkpoint(dirs["live"], **kw)
    # Only bucket 1 is captured (the canary's); bucket 8 after the commit.
    assert CheckpointSwapper(live).try_swap(dirs["good"]).ok
    assert live.compile_events == 1
    fresh = PredictEngine.from_checkpoint(dirs["good"], **kw)
    x = np.random.default_rng(5).normal(size=(8, 7, 10, 3)).astype(np.float32)
    for got, want in zip(live.predict(x), fresh.predict(x)):
        np.testing.assert_array_equal(got, want)
    assert live.compile_events == 2


def test_a_graphed_predict_makes_no_implicit_sync(cuda_device):
    """After the captures, a predict's only wait is the event after its
    answers' copies: nothing raises under the sync debug mode set to
    raise, the canary path included."""
    spec = ModelSpec(objective="mse", hidden_size=32, num_layers=2,
                     dropout=0.0)
    state = spec.build_module(
        device="cpu", generator=torch.Generator().manual_seed(0)).state_dict()
    engine = PredictEngine(spec, state, n_stocks=7, lookback=10,
                           device=cuda_device)
    engine.warmup()
    candidate = engine.put_params(state)
    x = np.random.default_rng(6).normal(size=(3, 7, 10, 3)).astype(np.float32)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        plain = engine.predict(x)
        canary = engine.predict(x, params=candidate)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for got, want in zip(canary, plain):
        np.testing.assert_array_equal(got, want)


# model=kfactor at datamodule=universe: 2,048-asset windows, T=32, H=64,
# each layer alone (the grouping rule fuses no pair at 2,048-row windows).
# Training takes 4 windows a step (8,192 rows), serving's top bucket 64
# (131,072 rows: the forward alone).
@pytest.mark.parametrize("rows", [2048, 8192, 131072])
def test_single_layer_kernels_at_universe_rows(cuda_device, rows):
    x, w1, *_ = _case(rows, rows, 64, n_t=32, device=cuda_device)
    hs, cs = lk.lstm_recurrence_ref(x, w1, return_c=True)
    got_hs, got_cs = lk.lstm_fwd_cuda(x, w1, return_c=True)
    torch.testing.assert_close(got_hs, hs, atol=2e-5, rtol=0)
    torch.testing.assert_close(got_cs, cs, atol=2e-5, rtol=0)
    if rows > 8192:
        return
    _, dh = _mask_and_cotangent(rows + 1, 32, rows, 64, cuda_device)
    dx = lk.lstm_bwd_cuda(dh, x, hs, cs, w1)
    want_dx = lk.lstm_bwd_ref(dh, x, hs, cs, w1)
    _close_rel(dx, want_dx)
    _close_rel(lk.lstm_wgrad_cuda([(want_dx, hs, 1, None, False)])[0][0],
               lk.lstm_wgrad_ref(want_dx, hs, 1))


def test_graphed_kfactor_fit_equals_eager_fit(cuda_device, tmp_path):
    """model=kfactor (F=3, input width 7, the combined objective: the rank-3
    NLL's unrolled LU inside the graph) for 2 epochs with CUDA graphs
    against cuda_graphs=False, bit-equal, and Trainer.test's metrics
    equal."""
    from masters_thesis_tpu_torch.data.pipeline import (
        FinancialWindowDataModule,
        bootstrap_synthetic,
    )
    from masters_thesis_tpu_torch.train.trainer import Trainer

    bootstrap_synthetic(tmp_path / "data", n_stocks=64, n_samples=2000,
                        seed=0, n_factors=3)
    dm = FinancialWindowDataModule(tmp_path / "data", lookback_window=32,
                                   target_window=16, stride=48, batch_size=4,
                                   store_shards=8)
    spec = ModelSpec(objective="combined", hidden_size=64, num_layers=2,
                     dropout=0.2, learning_rate=1e-3, input_size=7,
                     n_factors=3)
    runs, tests = {}, {}
    for graphs in (True, False):
        trainer = Trainer(max_epochs=2, gradient_clip_val=5.0, seed=3,
                          device=cuda_device, cuda_graphs=graphs)
        runs[graphs] = trainer.fit(spec, dm)
        tests[graphs] = trainer.test(spec, runs[graphs].state, dm)
    assert runs[True].history == runs[False].history
    assert all(np.isfinite(v) for row in runs[True].history
               for v in row.values())
    for name, value in runs[False].state.items():
        assert torch.equal(runs[True].state[name], value), name
    assert tests[True] == tests[False]


# ------------------------------------------------------ the replica axis


def _stacked_case(seed, replicas, rows, hidden, n_t=12, device="cuda"):
    """R replicas' pair operands, each replica its own draw, stacked on a
    leading axis, with a mask and a cotangent each."""
    cases = [_case(seed + r, rows, hidden, n_t=n_t, device=device)
             for r in range(replicas)]
    extras = [_mask_and_cotangent(seed + 50 + r, n_t, rows, hidden, device)
              for r in range(replicas)]
    stacked = [torch.stack(parts) for parts in zip(*cases)]
    mask = torch.stack([m for m, _ in extras])
    dh = torch.stack([d for _, d in extras])
    return stacked, mask, dh


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("rows,hidden", [(100, 64), (37, 64), (9, 5)])
@pytest.mark.parametrize("replicas", [1, 2, 3, 8])
def test_replica_axis_kernels_match_plain_and_solo(cuda_device, replicas,
                                                   rows, hidden, masked):
    """The replica-axis pair forward (with and without its stashes), sweep
    and weight-gradient pass: within their tolerance of the plain versions
    (2e-5 abs; 2e-5 of the largest entry for the sweep's and the pass's
    sums), and each replica's slice bit for bit the solo kernel's on that
    replica's slices."""
    (x, w1, wi2, b2, w2), mask, dh = _stacked_case(rows, replicas, rows,
                                                   hidden, device=cuda_device)
    mask = mask if masked else None
    before = dict(lk.LAUNCHES)
    h2s = lk.lstm_pair_fwd_stacked_cuda(x, w1, wi2, b2, w2, mask)
    stash = lk.lstm_pair_fwd_stacked_cuda(x, w1, wi2, b2, w2, mask, stash=True)
    want = lk.lstm_pair_stacked_ref(x, w1, wi2, b2, w2, mask, return_stash=True)
    for g, w in zip((h2s,) + stash, (want[0],) + want):
        torch.testing.assert_close(g, w, atol=2e-5, rtol=0)
    _, h1s, c1s, c2s = want
    args = (dh, x, mask, h1s, c1s, want[0], c2s, w1, wi2, b2, w2)
    dx1, d_pre2 = lk.lstm_pair_bwd_stacked_cuda(*args)
    for g, w in zip((dx1, d_pre2), lk.lstm_pair_bwd_stacked_ref(*args)):
        _close_rel(g, w)
    grads = lk.lstm_pair_wgrad_stacked(dx1, d_pre2, h1s, want[0], mask)
    for g, w in zip(grads, lk.lstm_pair_wgrad_stacked_ref(dx1, d_pre2, h1s,
                                                          want[0], mask)):
        _close_rel(g, w)
    torch.cuda.synchronize()
    name = "lstm_pair_fwd_masked_stacked" if masked else "lstm_pair_fwd_stacked"
    assert lk.LAUNCHES[name] == before[name] + 2
    assert lk.LAUNCHES["lstm_pair_bwd_stacked"] == before["lstm_pair_bwd_stacked"] + 1
    assert lk.LAUNCHES["lstm_wgrad_stacked"] == before["lstm_wgrad_stacked"] + 1
    for r in range(replicas):
        m = None if mask is None else mask[r]
        solo = lk.lstm_pair_fwd_cuda(x[r], w1[r], wi2[r], b2[r], w2[r], m,
                                     stash=True)
        for got, one in zip(stash, solo):
            assert torch.equal(got[r], one)
        assert torch.equal(h2s[r], lk.lstm_pair_fwd_cuda(x[r], w1[r], wi2[r],
                                                         b2[r], w2[r], m))
        solo_bwd = lk.lstm_pair_bwd_cuda(dh[r], x[r], m, h1s[r], c1s[r],
                                         want[0][r], c2s[r], w1[r], wi2[r],
                                         b2[r], w2[r])
        assert torch.equal(dx1[r], solo_bwd[0]) and torch.equal(d_pre2[r], solo_bwd[1])
        solo_grads = lk.lstm_pair_wgrad(dx1[r], d_pre2[r], h1s[r], want[0][r], m)
        for got, one in zip(grads, solo_grads):
            assert torch.equal(got[r], one)


@pytest.mark.parametrize("rows", [1, 9, 100, 803])
def test_a_row_is_bit_equal_at_one_and_two_row_tiles(cuda_device, rows):
    """The pair forward (maskless; masked with stashes) and the sweep at a
    named row tile of 1 and of 2 rows: bit for bit the same, so replicas
    whose solo tile is 1 row may run 2-row tiles (lstm_sweep.cuh
    sweep_rows; 4- and 8-row solo tiles are kept: the rows' bits part
    there)."""
    (x, w1, wi2, b2, w2), mask, dh = _stacked_case(rows, 2, rows, 64, n_t=20,
                                                   device=cuda_device)
    outs = {}
    for tile in (1, 2):
        fwd = lk.lstm_pair_fwd_stacked_cuda(x, w1, wi2, b2, w2, tile=tile)
        stash = lk.lstm_pair_fwd_stacked_cuda(x, w1, wi2, b2, w2, mask,
                                              stash=True, tile=tile)
        bwd = lk.lstm_pair_bwd_stacked_cuda(dh, x, mask, stash[1], stash[2],
                                            stash[0], stash[3], w1, wi2, b2,
                                            w2, tile=tile)
        outs[tile] = (fwd,) + stash + bwd
    for a, b in zip(outs[1], outs[2]):
        assert torch.equal(a, b)
    assert lk.lstm_sweep_tile_cuda(100, 1) == 1
    assert lk.lstm_sweep_tile_cuda(100, 8) == 2
    assert lk.lstm_sweep_tile_cuda(37, 3) == 1
    assert lk.lstm_sweep_tile_cuda(400, 4) == 4
    assert lk.lstm_sweep_tile_cuda(800, 8) == 8


def test_stacked_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    (x, w1, wi2, b2, w2), mask, dh = _stacked_case(0, 2, 9, 8,
                                                   device=cuda_device)
    with pytest.raises(ValueError, match="R, T, B, 4H"):
        lk.lstm_pair_fwd_stacked_cuda(x[0], w1, wi2, b2, w2)
    with pytest.raises(ValueError, match="shape"):
        lk.lstm_pair_fwd_stacked_cuda(x, w1[:1], wi2, b2, w2)
    with pytest.raises(ValueError, match="shape"):
        lk.lstm_pair_fwd_stacked_cuda(x, w1, wi2, b2, w2, mask[:1])
    with pytest.raises(RuntimeError, match="launch failed"):
        lk.lstm_pair_fwd_stacked_cuda(x, w1, wi2, b2, w2, tile=3)


def _stacked_fit(dm, device, graphs=True, epochs=2):
    from masters_thesis_tpu_torch.train.stacked import ReplicaSpec, StackedTrainer

    spec = ModelSpec(objective="combined", hidden_size=16, num_layers=2,
                     dropout=0.3, learning_rate=1e-3)
    trainer = StackedTrainer(max_epochs=epochs, gradient_clip_val=5.0,
                             device=device, cuda_graphs=graphs)
    replicas = [ReplicaSpec(f"s{s}", s, lr)
                for s, lr in zip((0, 1, 2), (1e-2, 5e-3, 2e-2))]
    return spec, replicas, trainer.fit(spec, dm, replicas)


def test_graphed_stacked_fit_equals_eager_and_each_solo_run(cuda_device,
                                                            tmp_path):
    """A graphed stacked fit (3 replicas, dropout 0.3, 2 epochs) against
    the same fit eager, and each replica against the graphed solo
    Trainer.fit of its seed and rate: weights, moments and history bit for
    bit; the stacked kernels launched once a step for all replicas."""
    from masters_thesis_tpu_torch.train.trainer import Trainer

    dm = _toy_datamodule(tmp_path)
    runs, launches = {}, {}
    for graphs in (True, False):
        lk.reset_launch_counts()
        spec, replicas, runs[graphs] = _stacked_fit(dm, cuda_device, graphs)
        launches[graphs] = dict(lk.LAUNCHES)
    assert launches[True] == launches[False]
    steps = 2 * len(dm.train_range)
    assert launches[True]["lstm_pair_fwd_masked_stacked"] == steps
    assert launches[True]["lstm_pair_bwd_stacked"] == steps
    assert launches[True]["lstm_wgrad_stacked"] == steps
    assert launches[True]["lstm_pair_fwd_masked"] == 0
    for got, want in zip(runs[True].replicas, runs[False].replicas):
        assert got.history == want.history
        for name, value in want.state.items():
            assert torch.equal(got.state[name], value), name
    for rep, got in zip(replicas, runs[True].replicas):
        solo = Trainer(max_epochs=2, gradient_clip_val=5.0, seed=rep.seed,
                       device=cuda_device).fit(
            dataclasses_replace(spec, learning_rate=rep.learning_rate), dm)
        assert got.history == solo.history
        for name, value in solo.state.items():
            assert torch.equal(got.state[name], value), name
        for key in ("mu", "nu"):
            assert torch.equal(got.opt_state[key], solo.opt_state[key])


def dataclasses_replace(obj, **kw):
    import dataclasses

    return dataclasses.replace(obj, **kw)


def test_stacked_steps_do_not_synchronise(cuda_device, tmp_path):
    """Graphed stacked steps, after their capture, under the
    synchronisation check set to raise."""
    from masters_thesis_tpu_torch.models.lstm import StackedLstmEncoder
    from masters_thesis_tpu_torch.train.flatparams import StackedFlatAdam
    from masters_thesis_tpu_torch.train.steps import StackedTrainProgram
    from masters_thesis_tpu_torch.train.trainer import device_split

    dm = _toy_datamodule(tmp_path)
    dm.prepare_data()
    dm.setup("fit")
    spec = ModelSpec(objective="mse", hidden_size=16, num_layers=2,
                     dropout=0.3)
    module = StackedLstmEncoder([
        spec.build_module(device=cuda_device,
                          generator=torch.Generator().manual_seed(s))
        for s in range(3)])
    gens = [torch.Generator(device=cuda_device).manual_seed(s) for s in range(3)]
    program = StackedTrainProgram(
        module, StackedFlatAdam(module.replicas, 5.0, 1e-5),
        spec.window_objective(), device_split(dm.train_arrays(), cuda_device),
        1, gens, graphed=True)
    program.begin_epoch([1e-3] * 3)
    program.step()  # the capture
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            program.step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert program.step.launches["lstm_pair_fwd_masked_stacked"] == 1


def test_stacked_engine_lanes_equal_solo_engines_on_the_card(cuda_device):
    """Each lane of a graphed StackedPredictEngine bit for bit a graphed
    solo PredictEngine on its weights, every bucket and padded; one
    capture a bucket; a set_lane captures nothing and moves one lane."""
    from masters_thesis_tpu_torch.serve.stacked import StackedPredictEngine

    spec = ModelSpec(objective="mse", hidden_size=64, num_layers=2,
                     dropout=0.0)
    states = [spec.build_module(device="cpu",
                                generator=torch.Generator().manual_seed(s)
                                ).state_dict() for s in range(4)]
    kw = dict(n_stocks=100, lookback=60, n_features=3, buckets=(1, 2, 4, 8),
              device=cuda_device)
    engine = StackedPredictEngine(spec, states, **kw)
    solos = [PredictEngine(spec, s, **kw) for s in states]
    engine.warmup()
    for solo in solos:
        solo.warmup()
    assert engine.compile_events == 4
    rng = np.random.default_rng(2)
    lk.reset_launch_counts()
    for n in (1, 3, 8):
        x = rng.normal(size=(n, 100, 60, 3)).astype(np.float32)
        alpha, beta = engine.predict(x)
        for lane, solo in enumerate(solos):
            a, b = solo.predict(x)
            np.testing.assert_array_equal(alpha[:, lane], a)
            np.testing.assert_array_equal(beta[:, lane], b)
    assert lk.LAUNCHES["lstm_pair_fwd_stacked"] == 3
    x = rng.normal(size=(2, 100, 60, 3)).astype(np.float32)
    before = engine.predict(x)
    engine.set_lane(3, states[0])
    after = engine.predict(x)
    assert engine.compile_events == 4
    for lane in range(3):
        np.testing.assert_array_equal(after[0][:, lane], before[0][:, lane])
    np.testing.assert_array_equal(after[0][:, 3], before[0][:, 0])


# ------------------------- the replica axis of the single layer and stack


def _single_stacked_case(seed, replicas, rows, hidden, n_t=12, device="cuda"):
    """R replicas' single-layer operands (x, w), cotangents, stacked."""
    (x, w, *_), mask, dh = _stacked_case(seed, replicas, rows, hidden, n_t,
                                         device)
    return x, w, dh


@pytest.mark.parametrize("hidden", [16, 32, 64])
@pytest.mark.parametrize("rows", [100, 37])
@pytest.mark.parametrize("replicas", [1, 2, 4, 8])
def test_single_layer_replica_axis_matches_plain_and_solo(
        cuda_device, replicas, rows, hidden):
    """The replica-axis single-layer forward (with and without c), sweep
    and one-job pass: within their tolerance of the plain versions, each
    replica's slice bit for bit its solo launch, one launch each."""
    x, w, dh = _single_stacked_case(rows + hidden, replicas, rows, hidden,
                                    device=cuda_device)
    before = dict(lk.LAUNCHES)
    hs_only = lk.lstm_fwd_stacked_cuda(x, w)
    hs, cs = lk.lstm_fwd_stacked_cuda(x, w, return_c=True)
    hs_ref, cs_ref = lk.lstm_recurrence_stacked_ref(x, w, return_c=True)
    torch.testing.assert_close(hs, hs_ref, atol=2e-5, rtol=0)
    torch.testing.assert_close(cs, cs_ref, atol=2e-5, rtol=0)
    assert torch.equal(hs_only, hs)
    dx = lk.lstm_bwd_stacked_cuda(dh, x, hs_ref, cs_ref, w)
    _close_rel(dx, lk.lstm_bwd_stacked_ref(dh, x, hs_ref, cs_ref, w))
    dw = lk.lstm_single_wgrad_stacked(dx, hs_ref)
    _close_rel(dw, lk.lstm_single_wgrad_stacked_ref(dx, hs_ref))
    torch.cuda.synchronize()
    assert lk.LAUNCHES["lstm_fwd_stacked"] == before["lstm_fwd_stacked"] + 2
    assert lk.LAUNCHES["lstm_bwd_stacked"] == before["lstm_bwd_stacked"] + 1
    assert lk.LAUNCHES["lstm_wgrad_stacked"] == before["lstm_wgrad_stacked"] + 1
    for r in range(replicas):
        solo_h, solo_c = lk.lstm_fwd_cuda(x[r], w[r], return_c=True)
        assert torch.equal(hs[r], solo_h) and torch.equal(cs[r], solo_c)
        solo_dx = lk.lstm_bwd_cuda(dh[r], x[r], hs_ref[r], cs_ref[r], w[r])
        assert torch.equal(dx[r], solo_dx)
        assert torch.equal(dw[r], lk.lstm_single_wgrad(dx[r], hs_ref[r]))


def _stack_stacked_case(seed, replicas, n_layers, rows, hidden, n_t=12,
                        device="cuda"):
    """R replicas' stack operands: x1, the L recurrent and L - 1 seam
    weights and biases, L - 1 masks and the top cotangent, each replica its
    own draw, every entry with a leading R axis."""
    rng = np.random.default_rng(seed)
    scale = 1.0 / np.sqrt(hidden)

    def t(*shape, uniform=False):
        a = (rng.uniform(-scale, scale, size=(replicas,) + shape) if uniform
             else rng.normal(size=(replicas,) + shape))
        return torch.tensor(a, dtype=torch.float32, device=device)

    x = t(n_t, rows, 4 * hidden)
    w_hh = [t(hidden, 4 * hidden, uniform=True) for _ in range(n_layers)]
    w_in = [t(hidden, 4 * hidden, uniform=True) for _ in range(n_layers - 1)]
    biases = [t(4 * hidden, uniform=True) for _ in range(n_layers - 1)]
    masks = [torch.tensor((rng.random((replicas, n_t, rows, hidden)) >= 0.2)
                          / 0.8, dtype=torch.float32, device=device)
             for _ in range(n_layers - 1)]
    return x, w_hh, w_in, biases, masks, t(n_t, rows, hidden)


def _solo(group, r):
    return None if group is None else [g[r] for g in group]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("hidden", [16, 32, 64])
@pytest.mark.parametrize("replicas", [1, 2, 4, 8])
def test_stack_replica_axis_matches_plain_and_solo(cuda_device, replicas,
                                                   hidden, masked):
    """The replica-axis 4-deep stack on 25 rows (model=medium's window):
    forward (stash-free and with the stashes), sweep and the 7-job pass
    within their tolerance of the plain versions, each replica's slice bit
    for bit its solo launch, one launch each."""
    x, w_hh, w_in, biases, masks, dh = _stack_stacked_case(
        hidden + replicas, replicas, 4, 25, hidden, device=cuda_device)
    masks = masks if masked else None
    weights = (w_hh, w_in, biases)
    before = dict(lk.LAUNCHES)
    top = lk.lstm_stack_fwd_stacked_cuda(x, *weights, masks)
    hs, cs = lk.lstm_stack_fwd_stacked_cuda(x, *weights, masks, stash=True)
    hs_ref, cs_ref = lk.lstm_stack_stacked_ref(x, *weights, masks,
                                               return_stash=True)
    for got, want in zip(hs + cs, hs_ref + cs_ref):
        torch.testing.assert_close(got, want, atol=2e-5, rtol=0)
    assert torch.equal(top, hs[-1])
    d_pres = lk.lstm_stack_bwd_stacked_cuda(dh, x, masks, hs_ref, cs_ref,
                                            *weights)
    for got, want in zip(d_pres, lk.lstm_stack_bwd_stacked_ref(
            dh, x, masks, hs_ref, cs_ref, *weights)):
        _close_rel(got, want)
    grads = lk.lstm_stack_wgrad_stacked(d_pres, hs_ref, masks)
    for got_part, want_part in zip(grads, lk.lstm_stack_wgrad_stacked_ref(
            d_pres, hs_ref, masks)):
        for got, want in zip(got_part, want_part):
            _close_rel(got, want)
    torch.cuda.synchronize()
    name = "lstm_stack_fwd_masked_stacked" if masked else "lstm_stack_fwd_stacked"
    assert lk.LAUNCHES[name] == before[name] + 2
    assert lk.LAUNCHES["lstm_stack_bwd_stacked"] == before["lstm_stack_bwd_stacked"] + 1
    assert lk.LAUNCHES["lstm_wgrad_stacked"] == before["lstm_wgrad_stacked"] + 1
    for r in range(replicas):
        solo_w = [_solo(g, r) for g in weights]
        solo_m = _solo(masks, r)
        solo_hs, solo_cs = lk.lstm_stack_fwd_cuda(x[r], *solo_w, solo_m,
                                                  stash=True)
        assert all(torch.equal(a[r], b) for a, b in
                   zip(hs + cs, solo_hs + solo_cs))
        solo_d = lk.lstm_stack_bwd_cuda(dh[r], x[r], solo_m, _solo(hs_ref, r),
                                        _solo(cs_ref, r), *solo_w)
        assert all(torch.equal(a[r], b) for a, b in zip(d_pres, solo_d))
        solo_g = lk.lstm_stack_wgrad(_solo(d_pres, r), _solo(hs_ref, r), solo_m)
        for got_part, solo_part in zip(grads, solo_g):
            assert all(torch.equal(a[r], b) for a, b in zip(got_part, solo_part))


@pytest.mark.parametrize("rows", [1, 25, 100, 400, 803])
def test_new_replica_axes_sum_alike_within_their_tile_classes(cuda_device,
                                                              rows):
    """The tile class the replica-axis tile rule moves a replica within
    (lstm_sweep.cuh sweep_rows, lstm_stack.cuh with_stack_tile): the
    single-layer forward and sweep, and the 3-deep stack's forward (masked
    with its stashes) and sweep, give a row the same bits at row tiles of 1
    and 2 rows. (At 4 and 8 rows the single-layer forward's bits part, so
    a solo tile of 4 or 8 rows is kept.)"""
    x, w, dh = _single_stacked_case(rows, 2, rows, 64, n_t=20,
                                    device=cuda_device)
    sx, w_hh, w_in, biases, masks, sdh = _stack_stacked_case(
        rows, 2, 3, rows, 64, n_t=20, device=cuda_device)
    weights = (w_hh, w_in, biases)
    outs = {}
    for tile in (1, 2):
        hs, cs = lk.lstm_fwd_stacked_cuda(x, w, return_c=True, tile=tile)
        dx = lk.lstm_bwd_stacked_cuda(dh, x, hs, cs, w, tile=tile)
        shs, scs = lk.lstm_stack_fwd_stacked_cuda(sx, *weights, masks,
                                                  stash=True, tile=tile)
        sd = lk.lstm_stack_bwd_stacked_cuda(sdh, sx, masks, shs, scs,
                                            *weights, tile=tile)
        outs[tile] = [hs, cs, dx] + shs + scs + sd
    for i, (p, q) in enumerate(zip(outs[1], outs[2])):
        assert torch.equal(p, q), i


def test_replica_axis_tile_rule(cuda_device):
    """A solo tile of 4 or 8 rows stays for R replicas; one of 1 or 2
    rows becomes 1 when the R replicas' blocks (clusters) fit at once,
    else 2."""
    assert lk.lstm_sweep_tile_cuda(8192, 4) == 8
    for backward in (False, True):
        tile = functools.partial(lk.lstm_stack_row_tile_cuda, 4,
                                 hidden=64, device=cuda_device,
                                 backward=backward, masked=True,
                                 stash=not backward)
        assert tile(25) in (1, 2) and tile(25, replicas=8) in (1, 2)
        assert tile(200, replicas=8) == tile(200)


def test_new_stacked_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    x, w, dh = _single_stacked_case(0, 2, 9, 8, device=cuda_device)
    with pytest.raises(ValueError, match="R, T, B, 4H"):
        lk.lstm_fwd_stacked_cuda(x[0], w)
    with pytest.raises(ValueError, match="shape"):
        lk.lstm_fwd_stacked_cuda(x, w[:1])
    with pytest.raises(ValueError, match="shape"):
        lk.lstm_bwd_stacked_cuda(dh[:1], x, dh, dh, w)
    with pytest.raises(RuntimeError, match="launch failed"):
        lk.lstm_fwd_stacked_cuda(x, w, tile=3)
    sx, w_hh, w_in, biases, masks, sdh = _stack_stacked_case(0, 2, 3, 9, 8,
                                                             device=cuda_device)
    with pytest.raises(ValueError, match="R, T, B, 4H"):
        lk.lstm_stack_fwd_stacked_cuda(sx[0], w_hh, w_in, biases)
    with pytest.raises(ValueError, match="shape"):
        lk.lstm_stack_fwd_stacked_cuda(sx, [w_hh[0][:1]] + w_hh[1:], w_in,
                                       biases)
    with pytest.raises(ValueError, match="shape"):
        lk.lstm_stack_fwd_stacked_cuda(sx, w_hh, w_in, biases,
                                       [m[:1] for m in masks])
    with pytest.raises(RuntimeError, match="launch failed"):
        lk.lstm_stack_fwd_stacked_cuda(sx, w_hh, w_in, biases, tile=3)


# The replica-axis counters a training step of each depth launches once
# (the toy datamodule's 4-stock windows at H=16 fuse 4 layers into one
# stack).
DEPTH_COUNTERS = {
    1: ("lstm_fwd_stacked", "lstm_bwd_stacked", "lstm_wgrad_stacked"),
    4: ("lstm_stack_fwd_masked_stacked", "lstm_stack_bwd_stacked",
        "lstm_wgrad_stacked"),
}
# Their solo counterparts, which a stacked step never launches (each
# replica's validation runs its solo forward).
SOLO_COUNTERS = {
    1: ("lstm_bwd", "lstm_wgrad"),
    4: ("lstm_stack_fwd_masked", "lstm_stack_bwd", "lstm_wgrad"),
}


@pytest.mark.parametrize("num_layers", [1, 4])
def test_graphed_stacked_fit_at_one_and_four_layers(cuda_device, tmp_path,
                                                    num_layers):
    """A graphed stacked fit (3 replicas, dropout 0.3, 2 epochs) of one
    layer and of one 4-deep stack against the same fit eager and each
    replica's graphed solo Trainer.fit: weights, moments and history bit
    for bit; each replica-axis kernel launched once a step for all
    replicas, and no solo launch."""
    from masters_thesis_tpu_torch.train.stacked import ReplicaSpec, StackedTrainer
    from masters_thesis_tpu_torch.train.trainer import Trainer

    dm = _toy_datamodule(tmp_path)
    spec = ModelSpec(objective="combined", hidden_size=16,
                     num_layers=num_layers, dropout=0.3, learning_rate=1e-3)
    replicas = [ReplicaSpec(f"s{s}", s, lr)
                for s, lr in zip((0, 1, 2), (1e-2, 5e-3, 2e-2))]
    runs, launches = {}, {}
    for graphs in (True, False):
        lk.reset_launch_counts()
        runs[graphs] = StackedTrainer(
            max_epochs=2, gradient_clip_val=5.0, device=cuda_device,
            cuda_graphs=graphs).fit(spec, dm, replicas)
        launches[graphs] = dict(lk.LAUNCHES)
    assert launches[True] == launches[False]
    steps = 2 * len(dm.train_range)
    for counter in DEPTH_COUNTERS[num_layers]:
        assert launches[True][counter] == steps, counter
    assert not any(launches[True][c] for c in SOLO_COUNTERS[num_layers])
    for got, want in zip(runs[True].replicas, runs[False].replicas):
        assert got.history == want.history
        for name, value in want.state.items():
            assert torch.equal(got.state[name], value), name
    for rep, got in zip(replicas, runs[True].replicas):
        solo = Trainer(max_epochs=2, gradient_clip_val=5.0, seed=rep.seed,
                       device=cuda_device).fit(
            dataclasses_replace(spec, learning_rate=rep.learning_rate), dm)
        assert got.history == solo.history
        for name, value in solo.state.items():
            assert torch.equal(got.state[name], value), name
        for key in ("mu", "nu"):
            assert torch.equal(got.opt_state[key], solo.opt_state[key])


@pytest.mark.parametrize("num_layers", [1, 4])
def test_stacked_steps_of_other_groupings_do_not_synchronise(
        cuda_device, tmp_path, num_layers):
    """As test_stacked_steps_do_not_synchronise, one layer and one 4-deep
    stack."""
    from masters_thesis_tpu_torch.models.lstm import StackedLstmEncoder
    from masters_thesis_tpu_torch.train.flatparams import StackedFlatAdam
    from masters_thesis_tpu_torch.train.steps import StackedTrainProgram
    from masters_thesis_tpu_torch.train.trainer import device_split

    dm = _toy_datamodule(tmp_path)
    dm.prepare_data()
    dm.setup("fit")
    spec = ModelSpec(objective="mse", hidden_size=16, num_layers=num_layers,
                     dropout=0.3)
    module = StackedLstmEncoder([
        spec.build_module(device=cuda_device,
                          generator=torch.Generator().manual_seed(s))
        for s in range(3)])
    gens = [torch.Generator(device=cuda_device).manual_seed(s) for s in range(3)]
    program = StackedTrainProgram(
        module, StackedFlatAdam(module.replicas, 5.0, 1e-5),
        spec.window_objective(), device_split(dm.train_arrays(), cuda_device),
        1, gens, graphed=True)
    program.begin_epoch([1e-3] * 3)
    program.step()  # the capture
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            program.step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    for counter in DEPTH_COUNTERS[num_layers]:
        assert program.step.launches[counter] == 1, counter


@pytest.mark.parametrize("num_layers,stocks,counter", [
    (1, 100, "lstm_fwd_stacked"),
    (4, 25, "lstm_stack_fwd_stacked"),
])
def test_stacked_engine_of_other_groupings_on_the_card(cuda_device,
                                                       num_layers, stocks,
                                                       counter):
    """Lanes of one layer (100 stocks) and of model=medium (4 layers, 25
    stocks: one 4-deep stack): each lane bit for bit a graphed solo
    engine, every bucket and padded; one capture a bucket, one launch of
    the group's replica-axis forward a dispatch."""
    from masters_thesis_tpu_torch.serve.stacked import StackedPredictEngine

    spec = ModelSpec(objective="mse", hidden_size=64, num_layers=num_layers,
                     dropout=0.0)
    states = [spec.build_module(device="cpu",
                                generator=torch.Generator().manual_seed(s)
                                ).state_dict() for s in range(3)]
    kw = dict(n_stocks=stocks, lookback=60, n_features=3, buckets=(1, 2, 4, 8),
              device=cuda_device)
    engine = StackedPredictEngine(spec, states, **kw)
    solos = [PredictEngine(spec, s, **kw) for s in states]
    engine.warmup()
    for solo in solos:
        solo.warmup()
    assert engine.compile_events == 4
    rng = np.random.default_rng(3)
    lk.reset_launch_counts()
    for n in (1, 3, 8):
        x = rng.normal(size=(n, stocks, 60, 3)).astype(np.float32)
        alpha, beta = engine.predict(x)
        for lane, solo in enumerate(solos):
            a, b = solo.predict(x)
            np.testing.assert_array_equal(alpha[:, lane], a)
            np.testing.assert_array_equal(beta[:, lane], b)
    assert lk.LAUNCHES[counter] == 3


# ---------------------------------------------------------- run telemetry


def test_telemetry_adds_no_sync_and_counts_one_capture(cuda_device, tmp_path,
                                                       monkeypatch):
    """A graphed model=small Trainer.fit (H=64, 2 layers, dropout 0.2) for
    3 epochs with telemetry and the flight recorder on: from the first
    epoch's start to the run's last telemetry (its metrics snapshot) every
    call runs under the synchronisation check set to raise, apart from the
    reads the trainer makes without telemetry (each epoch's sums, the
    validation sums, the checkpoint saves with their quality fingerprints)
    and the captures; the train
    program captures once; every epoch event carries a positive device_s
    from its CUDA events; the history is bit for bit a run's with
    telemetry off. Each graphed epoch chains exactly one ``pmean`` entry
    into the collective schedule, recorded while the check raises (so the
    record reads nothing of the card), and the heartbeat and the stream
    carry the chain."""
    import json

    from masters_thesis_tpu_torch.telemetry import schedule
    from masters_thesis_tpu_torch.telemetry.events import read_events
    from masters_thesis_tpu_torch.telemetry.report import summarize_path
    from masters_thesis_tpu_torch.telemetry.run import (
        EpochRecorder,
        TelemetryRun,
    )
    from masters_thesis_tpu_torch.train import trainer as trainer_mod
    from masters_thesis_tpu_torch.train.trainer import Trainer
    from masters_thesis_tpu_torch.utils.cuda_graph import GraphedCall

    def allowed(fn):
        # The trainer's own reads: the check is lifted for them alone.
        def call(*args, **kwargs):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("default")
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        return call

    real_call = GraphedCall.__call__
    checked = []

    def checked_call(self):
        if not self.captured:
            return allowed(real_call)(self)
        if torch.cuda.get_sync_debug_mode() == 2:  # "error"
            checked.append(self.name)
        return real_call(self)

    real_begin = EpochRecorder.begin
    real_snapshot = TelemetryRun.snapshot_metrics
    epochs_checked = []

    def begin(self, epoch):
        real_begin(self, epoch)
        torch.cuda.set_sync_debug_mode("error")
        epochs_checked.append(epoch)

    def snapshot_metrics(self):
        try:
            return real_snapshot(self)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    real_record = trainer_mod.record_collective
    recorded = []

    def record(kind, **fields):
        recorded.append((kind, fields.get("step"),
                         torch.cuda.get_sync_debug_mode()))
        return real_record(kind, **fields)

    dm = _toy_datamodule(tmp_path)
    spec = ModelSpec(objective="mse", input_size=3, hidden_size=64,
                     num_layers=2, dropout=0.2, learning_rate=1e-3)
    runs = {}
    for label in ("off", "on"):
        tel = (TelemetryRun(tmp_path / "tel", run_id="card")
               if label == "on" else None)
        if label == "on":
            monkeypatch.setattr(GraphedCall, "__call__", checked_call)
            monkeypatch.setattr(EpochRecorder, "begin", begin)
            monkeypatch.setattr(TelemetryRun, "snapshot_metrics",
                                snapshot_metrics)
            monkeypatch.setattr(trainer_mod, "metric_means",
                                allowed(trainer_mod.metric_means))
            monkeypatch.setattr(Trainer, "_save", allowed(Trainer._save))
            monkeypatch.setattr(trainer_mod, "record_collective", record)
            schedule.GLOBAL_SCHEDULE.reset()
        trainer = Trainer(max_epochs=3, gradient_clip_val=5.0, seed=3,
                          device=cuda_device, telemetry=tel,
                          hang_timeout_s=600, ckpt_dir=tmp_path / label)
        try:
            runs[label] = trainer.fit(spec, dm)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if tel is not None:
            tel.close()
    assert epochs_checked == [0, 1, 2]
    assert checked.count("train step") == 3 * len(dm.train_range) - 1
    assert runs["on"].history == runs["off"].history
    for name, value in runs["off"].state.items():
        assert torch.equal(runs["on"].state[name], value), name
    events = read_events(tmp_path / "tel" / "events.jsonl")
    epochs = [e for e in events if e["kind"] == "epoch"]
    assert [e["compile_events"] for e in epochs] == [1, 0, 0]
    assert (sum(e["kind"] == "quality_fingerprint" for e in events)
            == sum(e["kind"] == "checkpoint_saved" for e in events) > 0)
    assert all(e["device_s"] > 0 for e in epochs)
    report = summarize_path(tmp_path / "tel")
    assert report["compiles"]["train_epoch"] == 1 and not report["violations"]
    assert report["memory"]["peak_bytes"] > 0
    assert report["utilization"]["available"]
    if torch.cuda.get_device_name(cuda_device) == "NVIDIA H100 80GB HBM3":
        assert report["utilization"]["flops_utilization_pct"] > 0
    gauges = next(e["metrics"] for e in reversed(events)
                  if e["kind"] == "metrics")
    assert gauges["telemetry/host_s"]["value"] > 0
    # One schedule entry an epoch, recorded under the raising check.
    assert recorded == [("pmean", epoch, 2) for epoch in range(3)]
    chain = schedule.GLOBAL_SCHEDULE.snapshot()
    assert [e["step"] for e in chain["tail"] if e["kind"] == "pmean"] == \
        [0, 1, 2]
    heartbeat = json.loads((tmp_path / "tel" / "heartbeat.json").read_text())
    assert heartbeat["collective_schedule"] == chain
    streamed = [e for e in events if e["kind"] == "collective_schedule"]
    assert [(e["n"], e["chain"]) for e in streamed] == \
        [(chain["n"], chain["chain"])]


# ------------------------------------- the replica axis of the time-blocked


@pytest.mark.parametrize("rows", [1, 3, 100, 803])
@pytest.mark.parametrize("replicas", [1, 2, 8])
def test_time_blocked_replica_axis_matches_plain_and_solo(cuda_device,
                                                          replicas, rows):
    """The replica-axis time-blocked forward (h and c, and h alone) and
    backward (dx and dw) at T=252, H=64: within their tolerance of the plain
    versions, each replica's slices bit for bit its solo launch's, one
    launch each. At 100 rows and R = 2 or 8 the launch takes 2-row tiles
    where the solo one takes 1 (the dw partials kept a row)."""
    x, w, dh = _single_stacked_case(rows + replicas, replicas, rows, 64,
                                    n_t=252, device=cuda_device)
    before = dict(lk.LAUNCHES)
    hs, cs = lk.lstm_tb_fwd_stacked_cuda(x, w, return_c=True)
    hs_only = lk.lstm_tb_fwd_stacked_cuda(x, w)
    chunk, tile = lk.tb_time_chunk(rows, 64), lk._row_tile(rows)
    hs_ref, cs_ref = lk.lstm_tb_stacked_ref(x, w, chunk)
    torch.testing.assert_close(hs, hs_ref, atol=2e-5, rtol=0)
    torch.testing.assert_close(cs, cs_ref, atol=2e-5, rtol=0)
    assert torch.equal(hs_only, hs)
    dx, dw = lk.lstm_tb_bwd_stacked_cuda(dh, x, hs_ref, cs_ref, w)
    want_dx, want_dw = lk.lstm_tb_bwd_stacked_ref(dh, x, hs_ref, cs_ref, w,
                                                  chunk, tile)
    for r in range(replicas):
        _close_rel(dx[r], want_dx[r])
        _close_rel(dw[r], want_dw[r])
    torch.cuda.synchronize()
    assert lk.LAUNCHES["lstm_tb_fwd_stacked"] == before["lstm_tb_fwd_stacked"] + 2
    assert lk.LAUNCHES["lstm_tb_bwd_stacked"] == before["lstm_tb_bwd_stacked"] + 1
    for r in range(replicas):
        solo_h, solo_c = lk.lstm_tb_fwd_cuda(x[r], w[r], return_c=True)
        assert torch.equal(hs[r], solo_h) and torch.equal(cs[r], solo_c)
        solo_dx, solo_dw = lk.lstm_tb_bwd_cuda(dh[r], x[r], hs_ref[r],
                                               cs_ref[r], w[r])
        assert torch.equal(dx[r], solo_dx) and torch.equal(dw[r], solo_dw)


def test_time_blocked_replica_axis_tile_and_chunk(cuda_device):
    """The tile rule the time-blocked launch shares with the single layer,
    and its time chunk, taken at one replica's rows and the launch's
    tile."""
    assert lk.lstm_sweep_tile_cuda(100) == 1
    assert lk.lstm_sweep_tile_cuda(100, 8) == 2
    assert lk.lstm_sweep_tile_cuda(800, 8) == lk.lstm_sweep_tile_cuda(800) == 8
    for backward in (False, True):
        solo = lk.lstm_tb_time_chunk_cuda(252, 100, 64, cuda_device, backward)
        eight = lk.lstm_tb_time_chunk_cuda(252, 100, 64, cuda_device, backward,
                                           replicas=8)
        assert 1 <= eight <= solo
        assert lk.lstm_tb_time_chunk_cuda(252, 800, 64, cuda_device, backward,
                                          replicas=8) == (
            lk.lstm_tb_time_chunk_cuda(252, 800, 64, cuda_device, backward))


def test_time_blocked_stacked_wrappers_refuse_what_the_kernels_do_not_take(
        cuda_device):
    x, w, dh = _single_stacked_case(0, 2, 9, 8, n_t=20, device=cuda_device)
    before = dict(lk.LAUNCHES)
    with pytest.raises(ValueError, match="R, T, B, 4H"):
        lk.lstm_tb_fwd_stacked_cuda(x[0], w)
    with pytest.raises(ValueError, match="shape"):
        lk.lstm_tb_fwd_stacked_cuda(x, w[:1])
    with pytest.raises(ValueError, match="shape"):
        lk.lstm_tb_bwd_stacked_cuda(dh[:1], x, dh, dh, w)
    with pytest.raises(TypeError):
        lk.lstm_tb_fwd_stacked_cuda(x.double(), w.double())
    assert lk.LAUNCHES == before


def _long_datamodule(tmp_path, stocks=100):
    from masters_thesis_tpu_torch.data.pipeline import (
        FinancialWindowDataModule,
        bootstrap_synthetic,
    )

    bootstrap_synthetic(tmp_path / "data", n_stocks=stocks, n_samples=3400,
                        seed=0)
    return FinancialWindowDataModule(tmp_path / "data", batch_size=1,
                                     lookback_window=252, target_window=5,
                                     stride=257)


def test_graphed_stacked_time_blocked_fit_equals_each_solo_run(cuda_device,
                                                               tmp_path):
    """A graphed stacked fit of R = 2 model=small replicas at a one-year
    lookback (T=252 on 100-row windows: both layers time-blocked) against
    each replica's graphed solo Trainer.fit: weights, moments and history
    bit for bit; the time-blocked replica-axis kernels launched twice a
    step (one a layer), the solo ones never in the stacked steps."""
    from masters_thesis_tpu_torch.train.stacked import ReplicaSpec, StackedTrainer
    from masters_thesis_tpu_torch.train.trainer import Trainer

    dm = _long_datamodule(tmp_path)
    spec = ModelSpec(objective="combined", hidden_size=64, num_layers=2,
                     dropout=0.2, learning_rate=1e-3)
    replicas = [ReplicaSpec("s0", 0, 1e-3), ReplicaSpec("s1", 1, 5e-4)]
    lk.reset_launch_counts()
    stacked = StackedTrainer(max_epochs=2, gradient_clip_val=5.0,
                             device=cuda_device).fit(spec, dm, replicas)
    counts = dict(lk.LAUNCHES)
    steps = 2 * len(dm.train_range)
    assert counts["lstm_tb_fwd_stacked"] >= 2 * steps
    assert counts["lstm_tb_bwd_stacked"] == 2 * steps
    assert counts["lstm_tb_bwd"] == 0
    for rep, got in zip(replicas, stacked.replicas):
        solo = Trainer(max_epochs=2, gradient_clip_val=5.0, seed=rep.seed,
                       device=cuda_device).fit(
            dataclasses_replace(spec, learning_rate=rep.learning_rate), dm)
        assert got.history == solo.history
        for name, value in solo.state.items():
            assert torch.equal(got.state[name], value), name
        for key in ("mu", "nu"):
            assert torch.equal(got.opt_state[key], solo.opt_state[key])


# ------------------------------------------------ the quality gate, on the card


def test_a_fingerprinted_swap_commits_through_the_bucket_graphs(cuda_device,
                                                                tmp_path):
    """A candidate shipping the fingerprint the trainer would write for it
    (its outputs on 32 golden windows) commits through the quality gate:
    the golden windows run through the captured bucket graphs in chunks of
    the largest bucket, with no new capture, and the monitor takes the
    candidate's fingerprint; the same weights with heads scaled by 50 under
    that fingerprint are refused as quality_self, answers unchanged."""
    from masters_thesis_tpu_torch.serve.swap import CheckpointSwapper
    from masters_thesis_tpu_torch.telemetry import quality
    from masters_thesis_tpu_torch.train.checkpoint import (
        restore_checkpoint,
        save_checkpoint,
    )
    from masters_thesis_tpu_torch.train.trainer import fingerprint

    dirs, kw = _swap_case(tmp_path)
    state, _, spec, meta = restore_checkpoint(dirs["good"], "best")
    module = spec.build_module(device="cuda")
    module.load_state_dict(state)
    qx = np.random.default_rng(6).normal(size=(40, 7, 10, 3)).astype(np.float32)
    fp = fingerprint(module, qx, quality.golden_windows(32, 7, 10, 3, seed=0))
    extra = {quality.FINGERPRINT_FILENAME: quality.fingerprint_to_json(fp)}
    save_checkpoint(tmp_path / "fp", "best", state, spec=spec, meta=meta,
                    extra_files=extra)
    scaled = {k: v * (50.0 if "head" in k else 1.0) for k, v in state.items()}
    save_checkpoint(tmp_path / "diverged", "best", scaled, spec=spec,
                    meta=meta, extra_files=extra)
    live = PredictEngine.from_checkpoint(dirs["live"], **kw)
    live.warmup()
    captures = live.compile_events
    monitor = quality.QualityMonitor(None)
    swapper = CheckpointSwapper(live, quality_monitor=monitor)
    x = np.random.default_rng(7).normal(size=(5, 7, 10, 3)).astype(np.float32)
    before = live.predict(x)
    refused = swapper.try_swap(tmp_path / "diverged")
    assert refused.reason == "quality_self"
    for got, want in zip(live.predict(x), before):
        np.testing.assert_array_equal(got, want)
    verdict = swapper.try_swap(tmp_path / "fp")
    assert verdict.ok and verdict.checks["quality_self_ks"] < quality.GATE_MAX_SELF_KS
    assert monitor.reference == fp
    assert live.compile_events == captures == 4


# ------------------------------------------- data-parallel at world size 1


@pytest.fixture
def nccl_world_of_one(cuda_device):
    """A world-1 NCCL group in this process (what ``tpu_xla`` at
    ``n_devices=1`` makes), left behind by nothing."""
    import torch.distributed as dist

    from masters_thesis_tpu_torch.parallel.mesh import data_mesh

    mesh = data_mesh("tpu_xla", 1, cuda_device)
    yield mesh
    if dist.is_initialized():
        dist.destroy_process_group()


def _world_one_programs(tmp_path, mesh, graphed_dp):
    """Two ``TrainProgram``s from one seed on the toy windows, dropout on:
    one with ``mesh`` (graphed when ``graphed_dp``), one solo and eager."""
    from masters_thesis_tpu_torch.train.optim import make_optimizer
    from masters_thesis_tpu_torch.train.steps import TrainProgram
    from masters_thesis_tpu_torch.train.trainer import device_split

    dm = _toy_datamodule(tmp_path)
    dm.prepare_data()
    dm.setup("fit")
    spec = ModelSpec(objective="combined", hidden_size=16, num_layers=2,
                     dropout=0.3)
    data = device_split(dm.train_arrays(), mesh.device)
    programs = []
    for with_mesh in (True, False):
        module = spec.build_module(device=mesh.device,
                                   generator=torch.Generator().manual_seed(0))
        programs.append(TrainProgram(
            module, make_optimizer(module, 5.0, 1e-5), spec.window_objective(),
            data, 2, torch.Generator(device=mesh.device).manual_seed(7),
            graphed=graphed_dp and with_mesh,
            mesh=mesh if with_mesh else None))
    return programs


def test_graphed_world_one_step_equals_the_ungraphed_solo_step(
        nccl_world_of_one, tmp_path):
    """``tpu_xla`` at world size 1 on NCCL: the graphed step, its gradient
    all-reduced inside the graph (one capture), against the eager step with
    no group, 2 epochs: parameters and Adam moments bit-equal, one
    gradient all-reduce a step counted through the replays, and the
    replays make no host synchronisation."""
    from masters_thesis_tpu_torch.parallel.mesh import (
        COLLECTIVES,
        reset_collective_counts,
    )

    mesh = nccl_world_of_one
    assert mesh.world == 1 and mesh.backend == "nccl"
    dp, solo = _world_one_programs(tmp_path, mesh, graphed_dp=True)
    reset_collective_counts()
    steps = 0
    for epoch in range(2):
        for program in (dp, solo):
            program.begin_epoch(1e-3)
        for i in range(dp.n_steps):
            if dp.step.captured:
                torch.cuda.set_sync_debug_mode("error")
            try:
                dp.step()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            solo.step()
            steps += 1
    torch.cuda.synchronize()
    assert dp.step.captures == 1
    assert COLLECTIVES["all_reduce_grad"] == steps
    for a, b in ((dp.optimizer.params, solo.optimizer.params),
                 (dp.optimizer.mu, solo.optimizer.mu),
                 (dp.optimizer.nu, solo.optimizer.nu)):
        assert torch.equal(a, b)


def _all_reduce_events(prof) -> tuple[list, list]:
    """A trace's host calls of an all-reduce (the ``c10d`` op and NCCL's
    record) and its NCCL kernels on the card."""
    calls, kernels = [], []
    for e in prof.events():
        name = e.name.lower()
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if "nccl" in name:
                kernels.append(e)
        elif "allreduce" in name.replace("_", ""):
            calls.append(e)
    return calls, kernels


def test_the_step_all_reduce_is_replayed_from_the_graph(nccl_world_of_one,
                                                       tmp_path):
    """5 replays of the graphed world-1 step: 5 gradient all-reduces
    counted through the replays, one capture, and no all-reduce issued on
    the host (an eager all-reduce of the same mesh shows one). NCCL does
    an in-place SUM at one rank with no work on the card, so the replays
    hold no NCCL kernel either."""
    from torch.profiler import ProfilerActivity, profile

    from masters_thesis_tpu_torch.parallel.mesh import (
        COLLECTIVES,
        reset_collective_counts,
    )

    mesh = nccl_world_of_one
    dp, _ = _world_one_programs(tmp_path, mesh, graphed_dp=True)
    dp.begin_epoch(1e-3)
    dp.step()  # the warm-up and the capture
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities) as eager:
        mesh.all_reduce_mean_(torch.ones(8, device=mesh.device))
        torch.cuda.synchronize()
    assert _all_reduce_events(eager)[0]
    reset_collective_counts()
    with profile(activities=activities) as prof:
        for _ in range(5):
            dp.step()
        torch.cuda.synchronize()
    calls, kernels = _all_reduce_events(prof)
    assert dp.step.captures == 1
    assert COLLECTIVES["all_reduce_grad"] == 5
    assert calls == [] and kernels == []


def test_more_devices_than_the_card_are_refused(cuda_device, tmp_path):
    """``trainer.n_devices`` above the visible cards raises, naming the key,
    in the process and through the entry point (exit non-zero, never a
    run at world size 1)."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    from masters_thesis_tpu_torch.parallel.mesh import resolve_world

    n = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match=rf"^trainer\.n_devices={n}: "):
        resolve_world("tpu_xla", n, cuda_device)
    repo = Path(__file__).resolve().parent.parent
    proc = subprocess.run(
        [sys.executable, "-m", "masters_thesis_tpu_torch", "train",
         "trainer=tpu_xla", f"trainer.n_devices={n}",
         f"datamodule.data_dir={tmp_path / 'data'}",
         f"logger.save_dir={tmp_path / 'logs'}"],
        cwd=repo, env=dict(os.environ, PYTHONPATH=str(repo)),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert f"trainer.n_devices={n}" in proc.stderr
    assert not (tmp_path / "logs").exists()


def test_an_engine_stream_is_never_a_capture_stream(cuda_device):
    """A capture draws its stream from the default-priority pool (round
    robin over its streams): however many it draws, none is an engine's
    own stream, so no capture runs on a stream an engine records on."""
    engine = _small_serving_engine(cuda_device)
    drawn = {torch.cuda.Stream(cuda_device).cuda_stream for _ in range(256)}
    assert engine._stream.cuda_stream not in drawn
    assert engine._stream.cuda_stream != torch.cuda.default_stream(
        cuda_device).cuda_stream


def _small_serving_engine(device, seed=0, program_cache=None):
    """model=small's serving engine at full width (100 stocks, T=60, H=64,
    the 2 layers one pair), buckets 1-8, seeded weights."""
    spec = ModelSpec(objective="mse", hidden_size=64, num_layers=2,
                     dropout=0.0)
    state = spec.build_module(
        device="cpu",
        generator=torch.Generator().manual_seed(seed)).state_dict()
    return PredictEngine(spec, state, n_stocks=100, lookback=60,
                         n_features=3, buckets=(1, 2, 4, 8), device=device,
                         program_cache=program_cache)


def _boot_beside(server, x, want, groups, seeds):
    """Engines of ``seeds`` boot (capture) on threads, group by group, while
    ``server`` replays ``x`` in a loop on this thread, each answer ``want``
    bit for bit. Returns the booted engines, the errors, the replays."""
    import threading

    errors: list[BaseException] = []
    booted: list[PredictEngine] = []
    replays = 0
    seeds = iter(seeds)

    def boot(engine):
        try:
            engine.warmup()
        except BaseException as exc:  # noqa: BLE001 — reported below
            errors.append(exc)

    for size in groups:
        engines = [_small_serving_engine(server.device, seed=next(seeds))
                   for _ in range(size)]
        booted += engines
        threads = [threading.Thread(target=boot, args=(e,)) for e in engines]
        for t in threads:
            t.start()
        while any(t.is_alive() for t in threads):
            got = server.predict(x)
            replays += 1
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
        for t in threads:
            t.join()
    return booted, errors, replays


def test_engines_capture_while_a_sibling_replays_and_two_at_once(
        cuda_device):
    """The serving fleet on one card: new engines capture their buckets on
    a thread while another engine replays in a loop (three rounds), then
    two capture at once beside it. No capture fails, the collector is on
    afterwards, each graph's own launches are a solo capture's, and the
    launch counts are exactly each graph's runs (warm-up and replays)
    times its launches."""
    import gc

    solo = _small_serving_engine(cuda_device)
    solo.warmup()
    solo_launches = {b: dict(p.run.launches)
                     for b, p in solo._programs.items()}
    assert all(v == {"lstm_pair_fwd": 1} for v in solo_launches.values())
    server = _small_serving_engine(cuda_device, seed=1)
    server.warmup()
    x = np.random.default_rng(0).normal(size=(8, 100, 60, 3)).astype(
        np.float32)
    want = server.predict(x)
    lk.reset_launch_counts()
    base = {b: p.run.replays for b, p in server._programs.items()}
    booted, errors, replays = _boot_beside(server, x, want, [1, 1, 1, 2],
                                           range(2, 7))
    assert not errors, errors
    assert gc.isenabled()
    assert replays > 0
    for engine in booted:
        assert engine.compile_events == 4
        for b, program in engine._programs.items():
            assert program.run.launches == solo_launches[b]
    # Since the reset: the server's replays, and each booted graph's
    # warm-up run and replays.
    runs = [(p.run.replays - base[b], p.run.launches)
            for b, p in server._programs.items()]
    runs += [(p.run.captures + p.run.replays, p.run.launches)
             for e in booted for p in e._programs.values()]
    want_launches = {}
    for n, launches in runs:
        for name, k in launches.items():
            want_launches[name] = want_launches.get(name, 0) + n * k
    assert server._programs[8].run.replays - base[8] == replays
    assert {k: v for k, v in lk.LAUNCHES.items() if v} == want_launches


def test_sibling_captures_beside_replays_fifty_times(cuda_device):
    """The scenario above 50 times over (one boot, then two at once, each
    round): no ``cudaErrorCapturedEvent`` or other error. Each engine
    records its ``done`` event on its own stream, never on the legacy
    default stream while a sibling captures."""
    server = _small_serving_engine(cuda_device, seed=1)
    server.warmup()
    x = np.random.default_rng(0).normal(size=(8, 100, 60, 3)).astype(
        np.float32)
    want = server.predict(x)
    rounds = 0
    for i in range(50):
        booted, errors, replays = _boot_beside(server, x, want, [1, 2],
                                               range(2 + 3 * i, 5 + 3 * i))
        assert not errors, (i, errors)
        assert all(e.compile_events == 4 for e in booted)
        for engine in booted:
            engine.close()
        rounds += 1
    assert rounds == 50


def test_a_warm_boot_on_the_card_replays_the_cold_graphs(cuda_device):
    """model=small's ladder: a cold engine captures 4 graphs and closes
    into the cache; a warm engine on the same weights captures none, hits
    once a bucket and answers bit for bit as the cold one; a third engine,
    booted while the warm one lives, takes nothing of it (captures 4)."""
    from masters_thesis_tpu_torch.serve.program_cache import ProgramCache

    cache = ProgramCache()
    cold, warm, third = (
        _small_serving_engine(cuda_device, program_cache=cache)
        for _ in range(3))
    cold.warmup()
    x = np.random.default_rng(3).normal(size=(5, 100, 60, 3)).astype(
        np.float32)
    want = cold.predict(x)
    cold.close()
    assert cold.compile_events == 4 and cache.stores == 4
    warm.warmup()
    assert (warm.compile_events, warm.cache_hits, warm.programs_made) == (
        0, 4, 0)
    assert all(p.captured for p in warm._programs.values())
    for g, w in zip(warm.predict(x), want):
        np.testing.assert_array_equal(g, w)
    third.warmup()
    assert (third.compile_events, third.cache_hits) == (4, 0)
    assert not {id(p.run) for p in third._programs.values()} & {
        id(p.run) for p in warm._programs.values()}
    for g, w in zip(third.predict(x), want):
        np.testing.assert_array_equal(g, w)
    cache.close()


def test_a_corrupted_entry_is_refused_on_the_card_and_captured_fresh(
        cuda_device):
    from masters_thesis_tpu_torch.resilience import faults
    from masters_thesis_tpu_torch.serve.program_cache import ProgramCache

    cache = ProgramCache()
    cold, warm = (_small_serving_engine(cuda_device, program_cache=cache)
                  for _ in range(2))
    cold.warmup()
    x = np.random.default_rng(4).normal(size=(3, 100, 60, 3)).astype(
        np.float32)
    want = cold.predict(x)
    cold.close()
    faults.install_plan(faults.FaultPlan(faults=[faults.FaultSpec(
        point="cache.load", kind="corrupt", attempt=None)]))
    try:
        warm.warmup()
    finally:
        faults.clear_plan()
    reasons = [e["reason"] for e in cache.events
               if e["kind"] == "cache_rejected"]
    assert reasons == ["golden_mismatch"] * 4
    assert (warm.compile_events, warm.cache_hits) == (4, 0)
    for g, w in zip(warm.predict(x), want):
        np.testing.assert_array_equal(g, w)
    cache.close()


def test_the_probe_answers_on_the_card(cuda_device):
    from masters_thesis_tpu_torch.utils.backend_probe import (
        backend_fingerprint,
        probe_cuda_backend,
    )

    probe = probe_cuda_backend(timeout_s=120.0)
    assert probe.ok and probe.attempts == 1 and probe.detail == ""
    fp = backend_fingerprint(cuda_device)
    assert fp["platform"] == "cuda" and fp["device_index"] == 0
    assert fp["device_name"] == torch.cuda.get_device_name(0)


# ------------------------------------------------- the trainer preflight


def test_trace_audit_is_clean_on_the_card(cuda_device):
    from masters_thesis_tpu_torch.analysis.traceaudit import run_trace_audit

    facts: dict = {}
    spec = ModelSpec(objective="mse", hidden_size=16, num_layers=2,
                     dropout=0.2)
    assert run_trace_audit(spec=spec, device=cuda_device, stacked_replicas=2,
                           facts=facts) == []
    assert facts["captures"] == 1 and facts["replays"] == facts["steps"]
    assert facts["all_reduces_per_step"] == 1.0
    assert "not_applicable" not in facts
    stacked = facts["stacked"]
    assert stacked["captures"] == 1 and stacked["replays"] == stacked["steps"]
    assert stacked["all_reduces_per_step"] == 1.0
    assert not torch.distributed.is_initialized()  # its group is left


def test_trainer_preflights_are_clean_on_the_card(cuda_device, tmp_path):
    import json

    from masters_thesis_tpu_torch.data.pipeline import bootstrap_synthetic
    from masters_thesis_tpu_torch.telemetry.run import TelemetryRun
    from masters_thesis_tpu_torch.train.stacked import (
        ReplicaSpec,
        StackedTrainer,
    )
    from masters_thesis_tpu_torch.train.trainer import Trainer

    bootstrap_synthetic(tmp_path / "data", n_stocks=4, n_samples=1200, seed=0)
    spec = ModelSpec(objective="mse", hidden_size=8, num_layers=1)
    runs = {
        "solo": lambda tel: Trainer(max_epochs=1, device=cuda_device,
                                    telemetry=tel, preflight=True).fit(
            spec, _preflight_dm(tmp_path / "data")),
        "stacked": lambda tel: StackedTrainer(
            max_epochs=1, device=cuda_device, telemetry=tel,
            preflight=True).fit(spec, _preflight_dm(tmp_path / "data"),
                                [ReplicaSpec("a", 0, 1e-3),
                                 ReplicaSpec("b", 1, 1e-4)]),
    }
    for name, fit in runs.items():
        tel = TelemetryRun(tmp_path / name, run_id=name)
        fit(tel)
        tel.close()
        events = [json.loads(line) for line in
                  (tmp_path / name / "events.jsonl").read_text().splitlines()]
        kinds = [e["kind"] for e in events]
        assert kinds.index("preflight") < kinds.index("epoch"), name
        assert events[kinds.index("preflight")]["status"] == "ok", name


def _preflight_dm(data_dir):
    from masters_thesis_tpu_torch.data.pipeline import (
        FinancialWindowDataModule,
    )

    return FinancialWindowDataModule(data_dir, batch_size=4,
                                     lookback_window=10, target_window=5,
                                     stride=15)


def test_a_host_read_in_the_step_is_ta202(cuda_device, monkeypatch):
    from masters_thesis_tpu_torch.analysis.traceaudit import run_trace_audit
    from masters_thesis_tpu_torch.train import steps

    real = steps.train_step

    def reading(*args, **kwargs):
        sums = real(*args, **kwargs)
        sums["total"][0].item()  # a planted host read
        return sums

    monkeypatch.setattr(steps, "train_step", reading)
    findings = run_trace_audit(device=cuda_device)
    assert {f.rule for f in findings} == {"TA202"}, findings


def test_a_capture_failure_that_is_no_host_read_is_ta205(cuda_device,
                                                         monkeypatch):
    from masters_thesis_tpu_torch.analysis.traceaudit import run_trace_audit
    from masters_thesis_tpu_torch.train import steps

    real = steps.train_step

    def refusing(*args, **kwargs):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("planted capture failure")
        return real(*args, **kwargs)

    monkeypatch.setattr(steps, "train_step", refusing)
    findings = run_trace_audit(device=cuda_device)
    assert [f.rule for f in findings] == ["TA205"], findings
    assert "planted capture failure" in findings[0].message


def test_an_ungraphed_trainer_is_audited_ungraphed(cuda_device):
    # cuda_graphs=False: nothing is captured, so the capture counts have
    # no object; the eager steps are still held to TA202 and TA206/TA207.
    from masters_thesis_tpu_torch.analysis.traceaudit import run_trace_audit

    facts: dict = {}
    assert run_trace_audit(device=cuda_device, graphed=False,
                           stacked_replicas=2, facts=facts) == []
    assert facts["graphed"] is False and "captures" not in facts
    assert facts["not_applicable"].keys() == {"TA201"}
    assert facts["all_reduces_per_step"] == 1.0
    stacked = facts["stacked"]
    assert stacked["not_applicable"].keys() == {"TA207"}
    assert stacked["all_reduces_per_step"] == 1.0


# Forwards of three of the five libraries (lstm_fwd.cu, lstm_tb.cu,
# lstm_stack.cu) on seeded inputs: run by a child that builds afresh and by
# the test's own process, on the cached libraries.
_FRESH_BUILD_FORWARDS = """
import numpy as np
import torch
from masters_thesis_tpu_torch.ops import lstm_kernel as lk


def forward_outputs(device):
    rng = np.random.default_rng(25)
    t = lambda *shape, s=1.0: torch.tensor(
        rng.uniform(-s, s, size=shape), dtype=torch.float32, device=device)
    n_t, hidden = 60, 64
    s = 1.0 / np.sqrt(hidden)
    x = t(n_t, 100, 4 * hidden)
    w1, wi2, w2 = (t(hidden, 4 * hidden, s=s) for _ in range(3))
    b2 = t(4 * hidden, s=s)
    xs = t(n_t, 25, 4 * hidden)
    w_hh = [t(hidden, 4 * hidden, s=s) for _ in range(4)]
    w_in = [t(hidden, 4 * hidden, s=s) for _ in range(3)]
    biases = [t(4 * hidden, s=s) for _ in range(3)]
    return [lk.lstm_pair_fwd_cuda(x, w1, wi2, b2, w2),
            *lk.lstm_fwd_cuda(x, w1, return_c=True),
            *lk.lstm_tb_fwd_cuda(x, w1, return_c=True),
            lk.lstm_stack_fwd_cuda(xs, w_hh, w_in, biases)]
"""

_FRESH_BUILD_CHILD = _FRESH_BUILD_FORWARDS + """
import json, sys, time
from pathlib import Path
from masters_thesis_tpu_torch.ops import _build
from masters_thesis_tpu_torch.utils.compilation_cache import (
    enable_persistent_compilation_cache)
enabled = enable_persistent_compilation_cache()
t0 = time.perf_counter()
libs = _build.build_all()
build_s = time.perf_counter() - t0
outputs = [o.cpu() for o in forward_outputs(torch.device("cuda"))]
torch.save(outputs, sys.argv[1])
print(json.dumps({"enabled": enabled, "build_s": build_s,
                  "dir": str(_build.build_dir()),
                  "loaded": sorted(str(Path(lib._name).parent)
                                   for lib in _build._loaded.values()),
                  "libs": sorted(p.name for p in libs.values())}))
"""


def test_a_fresh_build_without_the_cache_is_bit_equal(cuda_device, tmp_path):
    """MT_NO_COMPILE_CACHE=1: a child builds every library into a directory
    of its own (its seconds printed: the build alone), and its forwards
    equal those of this process's cached libraries bit for bit."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    from masters_thesis_tpu_torch.ops import _build

    repo = Path(__file__).resolve().parent.parent
    namespace: dict = {}
    exec(_FRESH_BUILD_FORWARDS, namespace)
    want = [o.cpu() for o in namespace["forward_outputs"](cuda_device)]
    cached = {p.name for p in _build.build_all().values()}
    env = dict(os.environ, MT_NO_COMPILE_CACHE="1", PYTHONPATH=str(repo))
    out = tmp_path / "fresh.pt"
    proc = subprocess.run([sys.executable, "-c", _FRESH_BUILD_CHILD, str(out)],
                          cwd=repo, env=env, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    child = json.loads(proc.stdout.splitlines()[-1])
    print(json.dumps({"fresh_build": child}))
    assert child["enabled"] is False
    fresh = Path(child["dir"])
    assert fresh.resolve() != _build.BUILD_DIR.resolve()
    assert child["loaded"] and set(child["loaded"]) == {str(fresh)}
    assert set(child["libs"]) == cached
    assert not fresh.exists()  # removed when the child exited
    got = torch.load(out)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert torch.equal(g, w)
