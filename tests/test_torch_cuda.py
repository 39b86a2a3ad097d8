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
