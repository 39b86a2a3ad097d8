"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA device and skips without one. The file imports
no JAX, so on a machine with a card and no JAX it runs on its own:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q

Tolerance 2e-5 abs for a kernel against its plain version (f32, the sums
taken in another order over up to 12 dependent steps), 5e-5 for the
encoder and engine end to end (input projection and heads added).
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


@pytest.mark.parametrize(
    "rows,hidden",
    # Ragged row tiles, H not a multiple of 4, and each row tile of the
    # launch heuristic (2, 4 and 8 rows at 100, 400 and 803 rows).
    [(1, 1), (9, 5), (12, 16), (100, 64), (400, 64), (803, 64), (37, 64)],
)
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
