"""The port's PredictEngine and PredictServer on the CPU.

The engine is held against the JAX package's PredictEngine on the same
weights (1e-5 abs: f32 on both sides, summed in a different order); the
server is driven end to end on the port's CPU engine.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masters_thesis_tpu.models.objectives import ModelSpec as JaxSpec
from masters_thesis_tpu.serve.engine import PredictEngine as JaxEngine
from masters_thesis_tpu_torch.models.convert import params_from_jax
from masters_thesis_tpu_torch.models.objectives import ModelSpec
from masters_thesis_tpu_torch.serve.engine import (
    BucketOverflowError,
    PredictEngine,
)
from masters_thesis_tpu_torch.serve.queue import (
    STATUS_ERROR,
    STATUS_OK,
    STATUS_SHED,
)
from masters_thesis_tpu_torch.serve.server import PredictServer

K, T, F, H = 5, 8, 3, 16
BUCKETS = (1, 2, 4, 8)
ATOL = 1e-5


def _spec(num_layers=2):
    return ModelSpec(objective="mse", hidden_size=H, num_layers=num_layers,
                     dropout=0.0)


def _state(seed=0, num_layers=2):
    return _spec(num_layers).build_module(
        device="cpu", generator=torch.Generator().manual_seed(seed)
    ).state_dict()


def _engine(state=None, **kw):
    return PredictEngine(
        _spec(), _state() if state is None else state,
        n_stocks=K, lookback=T, n_features=F, buckets=BUCKETS, device="cpu", **kw,
    )


def _windows(n, seed=0):
    return np.random.default_rng(seed).normal(size=(n, K, T, F)).astype(np.float32)


@pytest.fixture(scope="module")
def engine_pair():
    spec = JaxSpec(objective="mse", hidden_size=H, num_layers=2, dropout=0.0)
    params = spec.build_module().init(
        jax.random.key(0), jnp.zeros((1, T, F), jnp.float32)
    )["params"]
    jax_engine = JaxEngine(spec, params, n_stocks=K, lookback=T, n_features=F,
                           buckets=BUCKETS)
    jax_engine.warmup()
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    return jax_engine, _engine(state)


@pytest.mark.parametrize("n", [1, 3, 8])
def test_engine_matches_jax_engine(engine_pair, n):
    jax_engine, engine = engine_pair
    x = _windows(n, seed=n)
    want_a, want_b = jax_engine.predict(x)
    got_a, got_b = engine.predict(x)
    assert got_a.shape == (n, K) and got_b.shape == (n, K)
    np.testing.assert_allclose(got_a, want_a, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_b, want_b, atol=ATOL, rtol=0)


def test_engine_contract():
    engine = _engine()
    assert engine.bucket_for(3) == 4 and engine.bucket_for(8) == 8
    assert engine.window_shape == (K, T, F) and engine.max_bucket == 8
    assert engine.platform == "cpu" and engine.compile_events == 0
    assert engine.warmup() > 0
    with pytest.raises(BucketOverflowError):
        engine.predict(_windows(9))
    with pytest.raises(ValueError, match="request shape"):
        engine.predict(np.zeros((1, K, T + 1, F), np.float32))
    # Padding repeats the first window and is sliced off: a padded window's
    # answer is the answer it gets alone.
    x = _windows(3, seed=11)
    a3, _ = engine.predict(x)
    a1, _ = engine.predict(x[:1])
    np.testing.assert_allclose(a3[:1], a1, atol=1e-6, rtol=0)


def test_server_answers_a_burst_like_the_engine():
    engine = _engine()
    server = PredictServer(engine, max_wait_s=0.01)
    server.start()
    x = _windows(13, seed=2)
    try:
        pending = [server.submit(w, deadline_s=30.0) for w in x]
        responses = [p.result(timeout=30.0) for p in pending]
    finally:
        stats = server.stop()
    assert [r.status for r in responses] == [STATUS_OK] * 13
    want_a, want_b = engine.predict(x[:8])
    want_a2, want_b2 = engine.predict(x[8:])
    want_a, want_b = np.concatenate([want_a, want_a2]), np.concatenate([want_b, want_b2])
    # Rows are independent, so a window's answer does not depend on which
    # micro-batch carried it; 1e-6 allows a different BLAS blocking.
    for i, r in enumerate(responses):
        np.testing.assert_allclose(r.outputs[0], want_a[i], atol=1e-6, rtol=0)
        np.testing.assert_allclose(r.outputs[1], want_b[i], atol=1e-6, rtol=0)
    assert stats["completed"] == 13 and stats["late_deliveries"] == 0
    assert stats["errors"] == 0 and stats["p50_ms"] is not None
    sizes = stats["batch_size_counts"]
    assert sum(n * c for n, c in sizes.items()) == 13
    assert max(sizes) <= engine.max_bucket


def test_non_finite_batch_resolves_as_error():
    state = _state()
    state["alpha_head.bias"] = torch.full_like(state["alpha_head.bias"], float("nan"))
    server = PredictServer(_engine(state))
    server.start()
    try:
        responses = [server.submit(w, deadline_s=30.0).result(timeout=30.0)
                     for w in _windows(2)]
    finally:
        stats = server.stop()
    assert [r.status for r in responses] == [STATUS_ERROR] * 2
    assert all("non-finite" in r.detail for r in responses)
    assert stats["errors"] == 2 and stats["completed"] == 0


def test_infeasible_deadline_is_shed():
    server = PredictServer(_engine())
    server.start()
    try:
        response = server.submit(_windows(1)[0], deadline_s=1e-9).result(timeout=5.0)
    finally:
        stats = server.stop()
    assert response.status == STATUS_SHED
    assert "deadline infeasible" in response.detail
    assert stats["shed_by_reason"] == {"deadline_infeasible": 1}
    assert stats["late_deliveries"] == 0


class _FailingEngine:
    window_shape = (K, T, F)
    max_bucket = 2

    def warmup(self):
        return 0.001

    def predict(self, x):
        raise RuntimeError("device fault")


def test_dispatch_failures_are_errors_and_trip_the_breaker():
    server = PredictServer(_FailingEngine(), breaker_threshold=2, max_wait_s=0.0)
    server.start()
    try:
        responses = []
        for w in _windows(4):
            responses.append(server.submit(w, deadline_s=30.0).result(timeout=30.0))
            time.sleep(0.01)
    finally:
        stats = server.stop()
    assert [r.status for r in responses] == [STATUS_ERROR] * 4
    assert all("device fault" in r.detail for r in responses)
    assert stats["errors"] == 4 and stats["breaker_trips"] == stats["dispatches"] // 2
    assert stats["breaker_trips"] >= 1


def test_submit_validates_shape_and_deadline():
    server = PredictServer(_engine())
    with pytest.raises(ValueError, match="window shape"):
        server.submit(np.zeros((K, T, F + 1), np.float32), deadline_s=1.0)
    with pytest.raises(ValueError, match="no deadline"):
        server.submit(np.zeros((K, T, F), np.float32))
    server.register_tenant("batch", deadline_s=30.0)
    server.start()
    try:
        r = server.submit(_windows(1)[0], tenant="batch").result(timeout=30.0)
    finally:
        stats = server.stop()
    assert r.status == STATUS_OK
    assert stats["tenants"]["batch"]["admitted"] == 1


def test_concurrent_submitters_account_for_every_request():
    """Many submitter threads at once, with a short switch interval: every
    request resolves exactly once and the counters add up."""
    import sys
    import threading

    server = PredictServer(_engine(), max_wait_s=0.001)
    server.start()
    windows = _windows(8, seed=4)
    results, lock = [], threading.Lock()

    def submitter(seed):
        for i in range(10):
            r = server.submit(windows[(seed + i) % 8], deadline_s=30.0).result(timeout=30.0)
            with lock:
                results.append(r)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=submitter, args=(s,)) for s in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        stats = server.stop()
    assert len(results) == 160 and len({r.rid for r in results}) == 160
    assert stats["requests"] == 160
    assert stats["completed"] + stats["shed"] + stats["errors"] + stats["late_converted"] == 160
    assert stats["completed"] == sum(r.ok for r in results)
    assert sum(n * c for n, c in stats["batch_size_counts"].items()) == stats["completed"]
    assert stats["late_deliveries"] == 0
