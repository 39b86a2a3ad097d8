"""The step programs over static buffers, on the CPU, against the eager
steps they replace; the capture helper's launch accounting.

On the card each program is one CUDA graph (``utils/cuda_graph.py``); here
the same bodies run eagerly, so these tests hold what the graph replays to
the eager loop it replaces, bit for bit (``torch.equal``): the device
cursor and index table against ``perm[i]``, the in-place accumulators
against ``s + new``, ``FlatAdam``'s device count and learning rate against
its Python-scalar update. The JAX side holds the same code through
``tests/test_torch_train.py`` (``test_fit_and_test_match_the_jax_trainer``,
``test_ten_step_trajectory_matches_jax_train_step``,
``test_flat_adam_matches_jax_flat_adam``). The card's tests
(``tests/test_torch_cuda.py``) hold graphed against eager there.
"""

import gc
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from torch import nn

from masters_thesis_tpu_torch.data.pipeline import Batch
from masters_thesis_tpu_torch.models.objectives import ModelSpec, batched_objective
from masters_thesis_tpu_torch.ops import lstm_kernel as lk
from masters_thesis_tpu_torch.train import flatparams
from masters_thesis_tpu_torch.train.flatparams import FlatAdam
from masters_thesis_tpu_torch.train.steps import (
    EvalProgram,
    TrainProgram,
    evaluate,
    forward_rows,
    metric_means,
    train_epoch,
    train_step,
    window_eval_metrics,
)
from masters_thesis_tpu_torch.train.trainer import epoch_seed
from masters_thesis_tpu_torch.utils.cuda_graph import (
    CaptureError,
    GraphedCall,
    collector_paused,
)

REPO = Path(__file__).resolve().parent.parent
CLIP, WD = 5.0, 1e-5


class PythonScalarAdam(FlatAdam):
    """FlatAdam's update as it was with a Python step count and learning
    rate: the reference the device-scalar update must equal bit for bit."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.host_count = 0

    @torch.no_grad()
    def step(self, lr: float) -> None:
        B1, B2 = flatparams.B1, flatparams.B2
        g = self.grads
        if self.gradient_clip_val is not None:
            max_norm = self.gradient_clip_val
            g_norm = torch.linalg.vector_norm(g)
            g = torch.where(g_norm < max_norm, g, (g / g_norm) * max_norm)
        if self.weight_decay:
            g = g + self.weight_decay * self.params
        self.mu.mul_(B1).add_((1 - B1) * g)
        self.nu.mul_(B2).add_((1 - B2) * (g * g))
        self.host_count += 1
        mu_hat = self.mu / (1 - B1 ** self.host_count)
        nu_hat = self.nu / (1 - B2 ** self.host_count)
        update = mu_hat / (torch.sqrt(nu_hat) + flatparams.EPS)
        self.params.sub_(lr * update)


class _Vector(nn.Module):
    def __init__(self, values):
        super().__init__()
        self.w = nn.Parameter(torch.from_numpy(values.copy()))


def _equal_state(a: FlatAdam, b: FlatAdam) -> bool:
    return all(torch.equal(x, y) for x, y in ((a.params, b.params),
                                              (a.mu, b.mu), (a.nu, b.nu)))


# ------------------------------------------------------------------ FlatAdam


def test_device_scalar_adam_equals_the_python_scalar_update():
    """10 updates from the same gradients, some clipped, the rate halved
    after step 5 as the plateau scheduler would: parameters and both
    moments bit-equal after every step, the rate given to step() or
    filled once with set_lr()."""
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=1000).astype(np.float32)
    grads = [rng.normal(0, 0.1, size=1000).astype(np.float32) for _ in range(10)]
    grads[2] *= 100.0  # clipped
    grads[7] *= 100.0
    rates = [1e-2] * 5 + [5e-3] * 5
    ref = PythonScalarAdam(_Vector(p0), CLIP, WD)
    by_arg = FlatAdam(_Vector(p0), CLIP, WD)
    by_fill = FlatAdam(_Vector(p0), CLIP, WD)
    for i, (g, lr) in enumerate(zip(grads, rates)):
        for opt in (ref, by_arg, by_fill):
            opt.grads.copy_(torch.from_numpy(g))
        ref.step(lr)
        by_arg.step(lr)
        if i in (0, 5):  # once an epoch, as the trainer does
            by_fill.set_lr(lr)
        by_fill.step()
        assert _equal_state(by_arg, ref) and _equal_state(by_fill, ref), i
    assert by_fill.count == by_arg.count == ref.host_count == 10
    assert float(by_fill.lr) == np.float32(5e-3)


def test_adam_state_dict_keeps_an_int_count():
    opt = FlatAdam(_Vector(np.ones(7, np.float32)))
    for _ in range(3):
        opt.grads.fill_(0.5)
        opt.step(1e-3)
    state = opt.state_dict()
    assert type(state["count"]) is int and state["count"] == 3
    restored = FlatAdam(_Vector(np.ones(7, np.float32)))
    count_buffer = restored.count_t
    restored.load_state_dict(state)
    assert restored.count_t is count_buffer  # filled in place
    assert restored.count == 3
    for a, b in ((restored.mu, opt.mu), (restored.nu, opt.nu)):
        assert torch.equal(a, b)


# ------------------------------------------------------------ the capture helper


class _FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


class _FakeGraphedCall(GraphedCall):
    """A GraphedCall whose "capture" runs the body (bumping the launch
    counts as a capture runs the wrappers) and records a fake graph."""

    def _warm_up(self):
        self.body()

    def _record(self, stream):
        self.body()
        return _FakeGraph()


def _counting_body():
    lk.LAUNCHES["lstm_pair_fwd_masked"] += 1
    lk.LAUNCHES["lstm_pair_bwd"] += 1
    lk.LAUNCHES["lstm_wgrad"] += 2


@pytest.mark.parametrize("replays", [0, 1, 7])
def test_replays_add_the_launch_counts_of_the_capture(replays):
    lk.reset_launch_counts()
    call = _FakeGraphedCall(_counting_body, device="cpu", name="fake step")
    call()  # the warm-up, counted, then the capture, not counted
    assert call.captured and call.launches == {
        "lstm_pair_fwd_masked": 1, "lstm_pair_bwd": 1, "lstm_wgrad": 2}
    for _ in range(replays):
        call()
    assert call.graph.replays == replays
    runs = 1 + replays
    assert lk.LAUNCHES == dict.fromkeys(lk.LAUNCHES, 0) | {
        "lstm_pair_fwd_masked": runs, "lstm_pair_bwd": runs,
        "lstm_wgrad": 2 * runs}
    lk.reset_launch_counts()


def test_a_failed_capture_raises_and_counts_nothing():
    class Refused(_FakeGraphedCall):
        def _record(self, stream):
            self.body()
            raise RuntimeError("operation not permitted when stream is capturing")

    lk.reset_launch_counts()
    call = Refused(_counting_body, device="cpu", name="refused step")
    with pytest.raises(CaptureError, match="capturing refused step failed"):
        call()
    assert not call.captured and call.launches == {}
    # The warm-up ran and counts; the failed capture does not.
    assert lk.LAUNCHES["lstm_wgrad"] == 2 and lk.LAUNCHES["lstm_pair_bwd"] == 1
    lk.reset_launch_counts()


def test_the_programs_import_without_touching_cuda():
    """Importing the helper and the modules that use it calls nothing of
    torch.cuda (the tests import every module on machines without a
    card)."""
    code = (
        "import torch\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError('torch.cuda called at import')\n"
        "for name in ('is_available', 'current_stream', 'Stream', 'CUDAGraph',\n"
        "             'graph', 'synchronize', 'init', 'current_device'):\n"
        "    setattr(torch.cuda, name, refuse)\n"
        "torch.cuda._lazy_init = refuse\n"
        "import masters_thesis_tpu_torch.utils.cuda_graph\n"
        "import masters_thesis_tpu_torch.train.trainer\n"
        "import masters_thesis_tpu_torch.serve.engine\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   timeout=120)


# ---------------------------------------------------------- the step programs


def _windows(n, k, n_t, seed):
    rng = np.random.default_rng(seed)
    arrays = (
        rng.normal(0.1, 0.5, size=(n, k, n_t, 3)),
        rng.normal(0.1, 0.5, size=(n, k, 6, 4)),
        np.stack([rng.normal(size=n), rng.uniform(0.5, 2, size=n)], axis=-1),
        rng.uniform(1, 2, size=(n, k)),
    )
    return Batch(*(torch.tensor(a, dtype=torch.float32) for a in arrays))


def _eager_epochs(spec, state, data, batch_size, rates, seed):
    """The epochs as train_epoch ran them before the programs: a plain loop
    of the eager train_step over ``perm[i]`` slices, Python-scalar
    FlatAdam, sums chained as ``s + new``."""
    module = spec.build_module(device="cpu")
    module.load_state_dict(state)
    opt = PythonScalarAdam(module, CLIP, spec.weight_decay)
    loss_fn = batched_objective(spec.window_objective())
    n = data.x.shape[0]
    n_steps = n // batch_size
    sums_by_epoch = []
    for epoch, lr in enumerate(rates):
        gen = torch.Generator().manual_seed(epoch_seed(seed, epoch))
        perm = torch.randperm(n, generator=gen)
        idx = perm[: n_steps * batch_size].view(n_steps, batch_size)
        module.train()
        sums = None
        for i in range(n_steps):
            batch = Batch(*(a.index_select(0, idx[i]) for a in data))
            new = train_step(module, opt, loss_fn, batch, lr, gen)
            sums = new if sums is None else {
                k: (sums[k][0] + new[k][0], sums[k][1] + new[k][1]) for k in sums}
        sums_by_epoch.append(sums)
    return sums_by_epoch, opt


@pytest.mark.parametrize("num_layers,n_t,k,hidden,groups", [
    (2, 8, 5, 16, [2]),        # model=small's pair
    (4, 8, 5, 16, [4]),        # model=medium's stack
    (3, 60, 100, 64, [2, 1]),  # the pair, then one layer alone
])
def test_train_program_equals_the_eager_epoch_loop(num_layers, n_t, k, hidden,
                                                   groups):
    """Two epochs of TrainProgram (batch_size 2, a tail window dropped,
    dropout 0.3 drawn from the epoch generator, the rate halved in epoch
    1) against the eager loop over the same permutations and generators:
    each epoch's metric sums, the parameters, both Adam moments and the
    step count bit-equal."""
    spec = ModelSpec(objective="combined", hidden_size=hidden,
                     num_layers=num_layers, dropout=0.3, weight_decay=WD)
    init = spec.build_module(device="cpu",
                             generator=torch.Generator().manual_seed(num_layers))
    assert init.layer_groups(n_t, k, True, k) == groups
    data = _windows(5 if num_layers < 3 else 3, k, n_t, seed=num_layers)
    rates, seed = [1e-2, 5e-3], 11
    want, ref = _eager_epochs(spec, init.state_dict(), data, 2, rates, seed)

    module = spec.build_module(device="cpu")
    module.load_state_dict(init.state_dict())
    opt = FlatAdam(module, CLIP, spec.weight_decay)
    gen = torch.Generator()
    program = TrainProgram(module, opt, spec.window_objective(), data, 2, gen)
    for epoch, lr in enumerate(rates):
        gen.manual_seed(epoch_seed(seed, epoch))
        got, n_steps = train_epoch(module, opt, spec.window_objective(), data,
                                   2, lr, gen, program=program)
        assert n_steps == data.x.shape[0] // 2
        assert list(got) == list(want[epoch]) == ["mse", "nll", "total"]
        for key, (v, w) in want[epoch].items():
            assert torch.equal(got[key][0], v) and torch.equal(got[key][1], w), key
    assert _equal_state(opt, ref) and opt.count == ref.host_count
    assert opt.count == len(rates) * (data.x.shape[0] // 2)


def test_train_epoch_without_a_program_is_one_eager_epoch():
    spec = ModelSpec(objective="mse", hidden_size=8, num_layers=2, dropout=0.2)
    init = spec.build_module(device="cpu",
                             generator=torch.Generator().manual_seed(0))
    data = _windows(4, 3, 6, seed=5)
    want, ref = _eager_epochs(spec, init.state_dict(), data, 1, [1e-3], seed=2)
    module = spec.build_module(device="cpu")
    module.load_state_dict(init.state_dict())
    opt = FlatAdam(module, CLIP, spec.weight_decay)
    got, n_steps = train_epoch(
        module, opt, spec.window_objective(), data, 1, 1e-3,
        torch.Generator().manual_seed(epoch_seed(2, 0)))
    assert n_steps == 4 and _equal_state(opt, ref)
    for key, (v, w) in want[0].items():
        assert torch.equal(got[key][0], v) and torch.equal(got[key][1], w)


def _plain_eval(module, objective, data, chunk):
    module.eval()
    sums = None
    with torch.no_grad():
        for start in range(0, data.x.shape[0], chunk):
            batch = Batch(*(a[start:start + chunk] for a in data))
            alpha, beta = forward_rows(module, batch.x)
            args = (alpha, beta, batch.y, batch.factor, batch.inv_psi)
            metrics = window_eval_metrics(*args)
            loss, _ = objective(*args)
            metrics["total"] = (loss, torch.ones_like(loss))
            new = {k: (v.sum(), w.sum()) for k, (v, w) in metrics.items()}
            sums = new if sums is None else {
                k: (sums[k][0] + new[k][0], sums[k][1] + new[k][1]) for k in sums}
    return sums


@pytest.mark.parametrize("n,chunk", [(11, 4), (8, 4), (3, 4), (37, 32)])
def test_eval_program_equals_the_plain_chunk_loop(n, chunk):
    """The full-chunk program and the short tail's against a plain loop of
    forward_rows and window_eval_metrics over slices, bit-equal, also on a
    second pass (the accumulators and cursors start over)."""
    spec = ModelSpec(objective="combined", hidden_size=8, num_layers=3,
                     dropout=0.3)
    module = spec.build_module(device="cpu",
                               generator=torch.Generator().manual_seed(n))
    data = _windows(n, 4, 7, seed=n)
    objective = spec.window_objective()
    want = _plain_eval(module, objective, data, chunk)
    program = EvalProgram(module, objective, data, chunk)
    assert [runs for runs, _, _ in program.parts] == (
        [n // chunk] * (n >= chunk) + [1] * (n % chunk > 0))
    for got in (program.run(), program.run(), evaluate(module, objective,
                                                       data, chunk)):
        assert list(got) == ["mse", "nll", "mae", "total"]
        for key, (v, w) in want.items():
            assert torch.equal(got[key][0], v) and torch.equal(got[key][1], w)
    assert metric_means(want) == metric_means(program.run())


def test_engine_answers_outlive_the_next_batch():
    """The engine's static outputs are copied out: an answer handed back is
    not overwritten by the next batch of its bucket (on the CPU .cpu()
    would alias the buffer)."""
    from masters_thesis_tpu_torch.serve.engine import PredictEngine

    spec = ModelSpec(objective="mse", hidden_size=8, num_layers=2, dropout=0.0)
    state = spec.build_module(
        device="cpu", generator=torch.Generator().manual_seed(0)).state_dict()
    engine = PredictEngine(spec, state, n_stocks=3, lookback=6, device="cpu",
                           buckets=(2,))
    rng = np.random.default_rng(0)
    first_x, second_x = (rng.normal(size=(2, 3, 6, 3)).astype(np.float32)
                         for _ in range(2))
    first = engine.predict(first_x)
    kept = [a.copy() for a in first]
    engine.predict(second_x)
    for got, want in zip(first, kept):
        np.testing.assert_array_equal(got, want)
    assert engine.compile_events == 0  # nothing is captured on the CPU


# ------------------------------------------- several captures at once, on the CPU


def test_the_collector_stays_off_until_the_last_capture_ends():
    """Two captures that overlap: the first to start turns the collector
    off, the first to end leaves it off, the last turns it back on."""
    assert gc.isenabled()
    first_in, second_in, first_out = (threading.Event() for _ in range(3))
    seen = {}

    def first():
        with collector_paused():
            first_in.set()
            second_in.wait(5.0)
        first_out.set()

    def second():
        first_in.wait(5.0)
        with collector_paused():
            second_in.set()
            first_out.wait(5.0)
            seen["after_first"] = gc.isenabled()

    threads = [threading.Thread(target=f) for f in (first, second)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10.0)
    assert not any(t.is_alive() for t in threads)
    assert seen == {"after_first": False}
    assert gc.isenabled()
    gc.disable()
    try:  # a collector that was off before stays off after
        with collector_paused():
            pass
        assert not gc.isenabled()
    finally:
        gc.enable()


def test_a_thread_local_capture_counts_only_its_own_thread():
    """While one thread captures (``thread_local``), another thread's
    launches and replays count as they run; the capture's own counts go to
    its graph only, and every replay adds them once."""
    lk.reset_launch_counts()
    captured = threading.Event()
    release = threading.Event()
    sibling = _FakeGraphedCall(_counting_body, device="cpu", name="sibling")
    sibling()  # warm-up + capture: 1 run counted
    call = {}

    class Held(_FakeGraphedCall):
        def _record(self, stream):
            self.body()
            captured.set()
            release.wait(5.0)
            return _FakeGraph()

    def capture():
        call["c"] = Held(_counting_body, device="cpu", name="held",
                         capture_error_mode="thread_local")
        call["c"]()

    t = threading.Thread(target=capture)
    t.start()
    assert captured.wait(5.0)
    for _ in range(3):  # the sibling replays while the capture is open
        sibling()
    _counting_body()  # and a real eager run on this thread
    release.set()
    t.join(5.0)
    assert not t.is_alive()
    assert call["c"].launches == sibling.launches == {
        "lstm_pair_fwd_masked": 1, "lstm_pair_bwd": 1, "lstm_wgrad": 2}
    call["c"]()  # one replay of the new graph
    # Runs: the sibling's warm-up and 3 replays, the eager run, the held
    # call's warm-up and its replay.
    runs = 1 + 3 + 1 + 1 + 1
    assert lk.LAUNCHES == dict.fromkeys(lk.LAUNCHES, 0) | {
        "lstm_pair_fwd_masked": runs, "lstm_pair_bwd": runs,
        "lstm_wgrad": 2 * runs}
    lk.reset_launch_counts()


def test_launch_counts_lose_nothing_across_threads():
    """More threads than cores, switching every microsecond: a lost
    increment would show in the totals."""
    lk.reset_launch_counts()
    n_threads, n = 2 * (os.cpu_count() or 4), 2000

    def launch():
        for _ in range(n):
            lk.LAUNCHES.count("lstm_fwd")
            lk.LAUNCHES.add({"lstm_pair_fwd": 1})

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=launch) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert (lk.LAUNCHES["lstm_fwd"] == lk.LAUNCHES["lstm_pair_fwd"]
            == n_threads * n)
    lk.reset_launch_counts()
