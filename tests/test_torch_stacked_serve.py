"""Stacked serving on the CPU: the port's StackedPredictEngine against the
JAX package's on the same R weight trees, and each lane against the port's
solo PredictEngine.

Against JAX: ``(n, R, K)`` answers within 1e-5 abs for every bucket and
through the pad path (f32 on both sides, summed in another order, as
``test_torch_serve.py``); ``ensemble_stats`` of the same answers within
1e-12 (f64 host statistics on both sides). Against the port's solo engine:
each lane bit for bit. Lane tools: ``set_lane`` moves one lane only,
``stage_lane`` commits nothing, ``try_swap_lane`` commits with its sibling
proof and refuses corrupt or foreign candidates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masters_thesis_tpu.models.objectives import ModelSpec as JaxSpec
from masters_thesis_tpu.serve.stacked import StackedPredictEngine as JaxStacked
from masters_thesis_tpu.serve.stacked import ensemble_stats as jax_ensemble_stats
from masters_thesis_tpu_torch.models.convert import params_from_jax
from masters_thesis_tpu_torch.models.objectives import ModelSpec
from masters_thesis_tpu_torch.serve.engine import BucketOverflowError, PredictEngine
from masters_thesis_tpu_torch.serve.queue import STATUS_OK
from masters_thesis_tpu_torch.serve.server import PredictServer
from masters_thesis_tpu_torch.serve.stacked import (
    LaneMismatchError,
    StackedPredictEngine,
    ensemble_stats,
    lane_digest,
)
from masters_thesis_tpu_torch.serve.swap import CheckpointSwapper
from masters_thesis_tpu_torch.train.checkpoint import (
    CorruptCheckpointError,
    save_checkpoint,
)

K, T, F, H = 5, 8, 3, 16
BUCKETS = (1, 2, 4)
LANES = 3
ATOL = 1e-5


def _spec(num_layers=2):
    return ModelSpec(objective="mse", hidden_size=H, num_layers=num_layers,
                     dropout=0.0)


def _state(seed, num_layers=2):
    return _spec(num_layers).build_module(
        device="cpu", generator=torch.Generator().manual_seed(seed)
    ).state_dict()


def _windows(n, seed=0):
    return np.random.default_rng(seed).normal(size=(n, K, T, F)).astype(np.float32)


def _engine(states, **kw):
    return StackedPredictEngine(_spec(), states, n_stocks=K, lookback=T,
                                n_features=F, buckets=BUCKETS, device="cpu",
                                **kw)


@pytest.fixture(scope="module")
def engine_pair():
    spec = JaxSpec(objective="mse", hidden_size=H, num_layers=2, dropout=0.0,
                   kernel_impl="xla")
    module = spec.build_module()
    trees = [module.init(jax.random.key(seed), jnp.zeros((1, T, F)))["params"]
             for seed in range(LANES)]
    jax_engine = JaxStacked(spec, trees, n_stocks=K, lookback=T, n_features=F,
                            buckets=BUCKETS)
    jax_engine.warmup()
    states = [params_from_jax(jax.tree_util.tree_map(np.asarray, t))
              for t in trees]
    return jax_engine, _engine(states)


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_stacked_engine_matches_the_jax_stacked_engine(engine_pair, n):
    """Every bucket, and the pad path (n = 3 pads to 4)."""
    jax_engine, engine = engine_pair
    x = _windows(n, seed=n)
    want_a, want_b = jax_engine.predict(x)
    got_a, got_b = engine.predict(x)
    assert got_a.shape == got_b.shape == (n, LANES, K)
    np.testing.assert_allclose(got_a, want_a, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_b, want_b, atol=ATOL, rtol=0)
    got = ensemble_stats(got_a, got_b)
    want = jax_ensemble_stats(got_a, got_b)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=1e-12, rtol=0)
    ens = engine.predict_ensemble(x)
    np.testing.assert_array_equal(ens["alpha"], got_a)
    np.testing.assert_allclose(ens["beta_mean"],
                               got_b.astype(np.float64).mean(axis=1), atol=1e-12)


def test_each_lane_is_the_solo_engine_bitwise():
    states = [_state(seed) for seed in range(LANES)]
    engine = _engine(states)
    solos = [PredictEngine(_spec(), s, n_stocks=K, lookback=T, n_features=F,
                           buckets=BUCKETS, device="cpu") for s in states]
    for n in (1, 3, 4):
        x = _windows(n, seed=10 + n)
        alpha, beta = engine.predict(x)
        for lane, solo in enumerate(solos):
            want_a, want_b = solo.predict(x)
            np.testing.assert_array_equal(alpha[:, lane], want_a)
            np.testing.assert_array_equal(beta[:, lane], want_b)
            lane_a, lane_b = engine.predict_lane(x, lane)
            np.testing.assert_array_equal(lane_a, want_a)


def test_engine_contract_and_lane_tools():
    states = [_state(seed) for seed in range(LANES)]
    engine = _engine(states, lanes=("a", "b", "c"))
    assert engine.window_shape == (K, T, F) and engine.max_bucket == 4
    assert engine.bucket_for(3) == 4 and engine.platform == "cpu"
    assert engine.num_lanes == LANES and engine.lanes == ("a", "b", "c")
    assert engine.warmup() > 0 and engine.compile_events == 0
    with pytest.raises(BucketOverflowError):
        engine.predict(_windows(5))
    with pytest.raises(IndexError):
        engine.predict_lane(_windows(1), LANES)
    assert engine.lane_digests() == tuple(lane_digest(s) for s in states)
    x = _windows(2, seed=3)
    before_a, before_b = engine.predict(x)
    # Staging commits nothing; the staged lane runs through the same
    # program while the siblings stay bitwise.
    staged = engine.stage_lane(1, _state(7))
    stg_a, _ = engine.predict(x, params=staged)
    after_a, _ = engine.predict(x)
    np.testing.assert_array_equal(after_a, before_a)
    for lane in (0, 2):
        np.testing.assert_array_equal(stg_a[:, lane], before_a[:, lane])
    assert not np.array_equal(stg_a[:, 1], before_a[:, 1])
    # set_lane moves lane 1 only.
    digest = engine.set_lane(1, _state(7), staged=staged)
    assert digest == lane_digest(_state(7)) == engine.lane_digests()[1]
    new_a, new_b = engine.predict(x)
    np.testing.assert_array_equal(new_a[:, 1], stg_a[:, 1])
    for lane in (0, 2):
        np.testing.assert_array_equal(new_a[:, lane], before_a[:, lane])
        np.testing.assert_array_equal(new_b[:, lane], before_b[:, lane])
    for key, value in engine.lane_params(1).items():
        assert torch.equal(value, _state(7)[key])
    # A lane of another architecture is refused.
    with pytest.raises(LaneMismatchError):
        engine.stage_lane(0, _state(0, num_layers=3))
    with pytest.raises(LaneMismatchError):
        _engine([_state(0), _state(1, num_layers=3)])


def _publish(tmp_path, name, state, spec=None, lookback=T):
    save_checkpoint(tmp_path / name, "best", state, spec=spec or _spec(),
                    meta={"epoch": 1, "datamodule": {"lookback_window": lookback}})
    return tmp_path / name


def test_from_checkpoints_verifies_every_lane(tmp_path):
    dirs = [_publish(tmp_path, f"l{i}", _state(i)) for i in range(LANES)]
    engine = StackedPredictEngine.from_checkpoints(
        dirs, n_stocks=K, n_features=F, buckets=BUCKETS, device="cpu")
    assert engine.lookback == T
    assert engine.lane_digests() == tuple(lane_digest(_state(i))
                                          for i in range(LANES))
    other = _publish(tmp_path, "long", _state(0), lookback=T + 1)
    with pytest.raises(LaneMismatchError):
        StackedPredictEngine.from_checkpoints(
            [dirs[0], other], n_stocks=K, n_features=F, device="cpu")
    state_file = dirs[1] / "best" / "state.pt"
    data = bytearray(state_file.read_bytes())
    data[len(data) // 2] ^= 0xFF
    state_file.write_bytes(bytes(data))
    with pytest.raises(CorruptCheckpointError):
        StackedPredictEngine.from_checkpoints(
            dirs, n_stocks=K, n_features=F, device="cpu")


def test_try_swap_lane_commits_with_the_sibling_proof(tmp_path):
    engine = _engine([_state(seed) for seed in range(LANES)])
    golden = engine.golden_batch()
    before_a, _ = engine.predict(golden)
    swapper = CheckpointSwapper(engine)
    verdict = swapper.try_swap_lane(2, _publish(tmp_path, "good", _state(9)))
    assert verdict.ok and verdict.reason == "committed", verdict.detail
    assert verdict.checks["siblings_bitwise"] is True
    assert swapper.lane_committed == 1
    after_a, _ = engine.predict(golden)
    for lane in (0, 1):
        np.testing.assert_array_equal(after_a[:, lane], before_a[:, lane])
    solo = PredictEngine(_spec(), _state(9), n_stocks=K, lookback=T,
                         n_features=F, buckets=BUCKETS, device="cpu")
    np.testing.assert_array_equal(after_a[:, 2], solo.predict(golden)[0])


@pytest.mark.parametrize("candidate,reason", [
    ("corrupt", "verify_failed"),
    ("nan", "canary_nonfinite"),
    ("deep", "shape_mismatch"),
])
def test_try_swap_lane_refuses_a_bad_candidate(tmp_path, candidate, reason):
    engine = _engine([_state(seed) for seed in range(LANES)])
    before = engine.predict(engine.golden_batch())
    if candidate == "deep":
        path = _publish(tmp_path, "deep", _state(4, num_layers=3), _spec(3))
    else:
        state = _state(4)
        if candidate == "nan":
            state["alpha_head.bias"] = torch.tensor([float("nan")])
        path = _publish(tmp_path, candidate, state)
        if candidate == "corrupt":
            f = path / "best" / "state.pt"
            data = bytearray(f.read_bytes())
            data[-10] ^= 0xFF
            f.write_bytes(bytes(data))
    swapper = CheckpointSwapper(engine)
    verdict = swapper.try_swap_lane(1, path)
    assert not verdict.ok and verdict.reason == reason
    assert swapper.lane_rejected == 1 and swapper.lane_committed == 0
    after = engine.predict(engine.golden_batch())
    np.testing.assert_array_equal(after[0], before[0])
    np.testing.assert_array_equal(after[1], before[1])
    with pytest.raises(TypeError, match="lanes"):
        CheckpointSwapper(PredictEngine(
            _spec(), _state(0), n_stocks=K, lookback=T, n_features=F,
            device="cpu")).try_swap_lane(0, path)


def test_server_answers_each_request_on_every_lane():
    states = [_state(seed) for seed in range(LANES)]
    engine = _engine(states)
    server = PredictServer(engine, max_wait_s=0.002)
    server.register_tenant("desk", deadline_s=5.0)
    server.start()
    windows = _windows(6, seed=21)
    pending = [server.submit(w, tenant="desk") for w in windows]
    results = [p.result(timeout=10.0) for p in pending]
    stats = server.stop()
    assert all(r.status == STATUS_OK for r in results)
    assert stats["lanes"] == LANES
    assert stats["tenants"]["desk"]["admitted"] == 6
    for w, r in zip(windows, results):
        assert r.outputs[0].shape == (LANES, K)
        # Batched with other requests or alone: the same answer up to the
        # CPU product's blocking.
        np.testing.assert_allclose(r.outputs[0], engine.predict(w[None])[0][0],
                                   atol=1e-6, rtol=0)


@pytest.mark.parametrize("num_layers", [1, 4])
def test_lanes_of_other_groupings_match_the_jax_engine_and_the_solo_engine(
        num_layers):
    """Lanes of one layer (the single-layer replica axis) and of four (one
    4-deep stack at this toy shape) against the JAX stacked engine on the
    same trees, within ATOL, every bucket and the pad path; each lane bit
    for bit the port's solo engine."""
    spec = JaxSpec(objective="mse", hidden_size=H, num_layers=num_layers,
                   dropout=0.0, kernel_impl="xla")
    module = spec.build_module()
    trees = [module.init(jax.random.key(seed), jnp.zeros((1, T, F)))["params"]
             for seed in range(LANES)]
    jax_engine = JaxStacked(spec, trees, n_stocks=K, lookback=T, n_features=F,
                            buckets=BUCKETS)
    jax_engine.warmup()
    states = [params_from_jax(jax.tree_util.tree_map(np.asarray, t))
              for t in trees]
    engine = StackedPredictEngine(_spec(num_layers), states, n_stocks=K,
                                  lookback=T, n_features=F, buckets=BUCKETS,
                                  device="cpu")
    assert engine._module.layer_groups(T, K, False, K) == [num_layers]
    solos = [PredictEngine(_spec(num_layers), s, n_stocks=K, lookback=T,
                           n_features=F, buckets=BUCKETS, device="cpu")
             for s in states]
    for n in (1, 3, 4):
        x = _windows(n, seed=30 + n)
        want_a, want_b = jax_engine.predict(x)
        got_a, got_b = engine.predict(x)
        np.testing.assert_allclose(got_a, want_a, atol=ATOL, rtol=0)
        np.testing.assert_allclose(got_b, want_b, atol=ATOL, rtol=0)
        for lane, solo in enumerate(solos):
            solo_a, solo_b = solo.predict(x)
            np.testing.assert_array_equal(got_a[:, lane], solo_a)
            np.testing.assert_array_equal(got_b[:, lane], solo_b)


def test_a_four_layer_lane_swap_keeps_the_sibling_proof(tmp_path):
    """try_swap_lane on a stack of 4-layer lanes: committed with its
    sibling proof, the other lanes' answers unchanged bit for bit."""
    engine = StackedPredictEngine(
        _spec(4), [_state(seed, num_layers=4) for seed in range(LANES)],
        n_stocks=K, lookback=T, n_features=F, buckets=BUCKETS, device="cpu")
    golden = engine.golden_batch()
    before_a, _ = engine.predict(golden)
    path = _publish(tmp_path, "deep", _state(9, num_layers=4), _spec(4))
    verdict = CheckpointSwapper(engine).try_swap_lane(0, path)
    assert verdict.ok and verdict.checks["siblings_bitwise"] is True
    after_a, _ = engine.predict(golden)
    for lane in (1, 2):
        np.testing.assert_array_equal(after_a[:, lane], before_a[:, lane])
