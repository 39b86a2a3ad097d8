"""The port's program cache on the CPU, held against the JAX package's.

The JAX program-cache scenarios of ``tests/test_fleet.py`` and
``tests/test_stacked_serve.py::TestProgramCacheLaneKeys``, adapted to the
port's check-out rule (an engine gives its programs back at ``close``, and
a warm boot takes them): in each, the port's decisions (hits, misses,
stores, rejections, and each engine's hits and programs made) are the JAX
cache's on the same weights. A port engine that made programs is closed
where the JAX engine would have stored them, so that the stores count
alike. Reasons differ where the JAX cache reads a damaged file: its
``torn`` is the port's ``golden_mismatch`` (the ``cache.load`` fault flips
one stored weight). Warm answers are the cold engine's bit for bit, and
within 1e-5 abs of the JAX engine's (f32 on both sides, summed in another
order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masters_thesis_tpu.models.objectives import ModelSpec as JaxSpec
from masters_thesis_tpu.resilience import faults as jax_faults
from masters_thesis_tpu.serve import program_cache as jax_pc
from masters_thesis_tpu.serve.engine import PredictEngine as JaxEngine
from masters_thesis_tpu.serve.stacked import StackedPredictEngine as JaxStacked
from masters_thesis_tpu_torch.models.convert import params_from_jax
from masters_thesis_tpu_torch.models.objectives import ModelSpec
from masters_thesis_tpu_torch.resilience import faults
from masters_thesis_tpu_torch.serve import program_cache as pc
from masters_thesis_tpu_torch.serve.engine import PredictEngine
from masters_thesis_tpu_torch.serve.program_cache import ProgramCache
from masters_thesis_tpu_torch.serve.stacked import StackedPredictEngine

K, T, F, H = 4, 8, 3, 8
BUCKETS = (1, 2)
ATOL = 1e-5
DECISIONS = ("hits", "misses", "stores", "rejections")


def _jax_spec():
    return JaxSpec(objective="mse", hidden_size=H, num_layers=1, dropout=0.0,
                   kernel_impl="xla")


def _spec():
    return ModelSpec(objective="mse", hidden_size=H, num_layers=1,
                     dropout=0.0)


def _tree(seed):
    return _jax_spec().build_module().init(
        jax.random.key(seed), jnp.zeros((1, T, F), jnp.float32))["params"]


def _state(tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree))


def _jax_engine(tree, cache, buckets=BUCKETS):
    return JaxEngine(_jax_spec(), tree, n_stocks=K, lookback=T, n_features=F,
                     buckets=buckets, program_cache=cache)


def _engine(tree, cache, buckets=BUCKETS):
    return PredictEngine(_spec(), _state(tree), n_stocks=K, lookback=T,
                         n_features=F, buckets=buckets, device="cpu",
                         program_cache=cache)


def _jax_decisions(*caches) -> dict:
    return {k: sum(getattr(c, k) for c in caches) for k in DECISIONS}


def _decisions(cache) -> dict:
    return {k: getattr(cache, k) for k in DECISIONS}


def _reasons(events) -> list:
    return [e["reason"] for e in events if e["kind"] == "cache_rejected"]


def _windows(n, seed):
    return np.random.default_rng(seed).standard_normal(
        (n, K, T, F)).astype(np.float32)


@pytest.fixture(scope="module")
def trees():
    return [_tree(seed) for seed in range(3)]


def test_warm_boot_replays_the_cold_engines_programs(trees, tmp_path):
    """JAX ``test_program_cache_round_trip_zero_compiles``."""
    jcold_cache = jax_pc.ProgramCache(tmp_path)
    jcold = _jax_engine(trees[0], jcold_cache)
    jcold.warmup()
    jwarm_cache = jax_pc.ProgramCache(tmp_path)
    jwarm = _jax_engine(trees[0], jwarm_cache)
    jwarm.warmup()
    assert (jcold.compile_events, jwarm.compile_events) == (2, 0)

    cache = ProgramCache()
    cold = _engine(trees[0], cache)
    cold.warmup()
    x = cold.golden_batch(2, seed=123)
    want = cold.predict(x)
    cold.close()
    warm = _engine(trees[0], cache)
    warm.warmup()
    assert _decisions(cache) == _jax_decisions(jcold_cache, jwarm_cache)
    assert (cold.programs_made, warm.programs_made) == (len(BUCKETS), 0)
    assert warm.cache_hits == jwarm.cache_hits == len(BUCKETS)
    assert warm.compile_events == 0
    got = warm.predict(x)
    for g, w, j in zip(got, want, jwarm.predict(x)):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_allclose(g, j, atol=ATOL, rtol=0)
    # Every padded size through the taken programs.
    for n in (1, 2):
        xs = _windows(n, seed=n)
        for g, j in zip(warm.predict(xs), jwarm.predict(xs)):
            np.testing.assert_allclose(g, j, atol=ATOL, rtol=0)


def test_a_live_engines_programs_are_never_handed_out(trees):
    cache = ProgramCache()
    cold = _engine(trees[0], cache)
    cold.warmup()
    cold.close()
    live = _engine(trees[0], cache)
    live.warmup()
    assert live.cache_hits == len(BUCKETS) and len(cache) == 0
    other = _engine(trees[0], cache)
    other.warmup()
    assert (other.cache_hits, other.programs_made) == (0, len(BUCKETS))
    assert not set(map(id, other._programs.values())) & set(
        map(id, live._programs.values()))
    # A closed engine serves no more; another warm boot takes its programs.
    live.close()
    with pytest.raises(RuntimeError, match="closed"):
        live.predict(_windows(1, seed=0))
    again = _engine(trees[1], cache)
    again.warmup()
    assert again.cache_hits == len(BUCKETS)


def test_an_engine_with_a_dispatch_in_flight_gives_nothing_back(trees):
    cache = ProgramCache()
    engine = _engine(trees[0], cache)
    engine.warmup()
    with engine._lock:  # a dispatch holds the engine's lock
        engine.close()
    assert cache.stores == 0 and len(cache) == 0
    with pytest.raises(RuntimeError, match="closed"):
        engine.predict(_windows(1, seed=0))


def test_warm_engine_serves_its_own_weights_not_the_cached_ones(trees):
    """The taken module carries the booting engine's weights (copied in
    after the golden check): a warm engine on other weights answers as a
    cold engine on them."""
    cache = ProgramCache()
    first = _engine(trees[0], cache)
    first.warmup()
    first.close()
    warm = _engine(trees[1], cache)
    warm.warmup()
    assert warm.cache_hits == len(BUCKETS)
    cold = _engine(trees[1], None)
    cold.warmup()
    x = _windows(2, seed=4)
    for g, w in zip(warm.predict(x), cold.predict(x)):
        np.testing.assert_array_equal(g, w)


def test_a_stale_fingerprint_is_refused(trees, tmp_path):
    """JAX ``test_program_cache_refuses_stale_fingerprint``."""
    import json

    jcold_cache = jax_pc.ProgramCache(tmp_path)
    _jax_engine(trees[0], jcold_cache).warmup()
    manifest_path = tmp_path / "MANIFEST.json"
    manifest = json.loads(manifest_path.read_text())
    for entry in manifest["entries"].values():
        entry["fingerprint"]["jaxlib"] = "some-other-build"
    manifest_path.write_text(json.dumps(manifest))
    jcache = jax_pc.ProgramCache(tmp_path)
    jeng = _jax_engine(trees[0], jcache)
    jeng.warmup()

    cache = ProgramCache()
    cold = _engine(trees[0], cache)
    cold.warmup()
    cold.close()
    for programs in cache._sets:
        for entry in programs.entries.values():
            entry.fingerprint = {**entry.fingerprint,
                                 "torch": "some-other-build"}
    eng = _engine(trees[0], cache)
    eng.warmup()
    eng.close()
    assert _decisions(cache) == _jax_decisions(jcold_cache, jcache)
    assert _reasons(cache.events) == _reasons(jcache.events) == \
        ["stale"] * len(BUCKETS)
    assert eng.programs_made == jeng.compile_events == len(BUCKETS)
    assert eng.cache_hits == jeng.cache_hits == 0


def test_the_cache_load_fault_corrupts_then_refuses(trees, tmp_path):
    """JAX ``test_program_cache_fault_point_corrupts_then_refuses``: JAX's
    ``torn`` is the port's ``golden_mismatch``."""
    jcold_cache = jax_pc.ProgramCache(tmp_path)
    _jax_engine(trees[0], jcold_cache).warmup()
    jax_faults.install_plan(jax_faults.FaultPlan(faults=[
        jax_faults.FaultSpec(point="cache.load", kind="corrupt", attempt=1)]))
    try:
        jcache = jax_pc.ProgramCache(tmp_path)
        jeng = _jax_engine(trees[0], jcache)
        jeng.warmup()
    finally:
        jax_faults.clear_plan()

    cache = ProgramCache()
    cold = _engine(trees[0], cache)
    cold.warmup()
    x = _windows(2, seed=7)
    want = cold.predict(x)
    cold.close()
    faults.install_plan(faults.FaultPlan(faults=[
        faults.FaultSpec(point="cache.load", kind="corrupt", attempt=1)]))
    try:
        eng = _engine(trees[0], cache)
        eng.warmup()
    finally:
        faults.clear_plan()
    assert [{"torn": "golden_mismatch"}[r] for r in _reasons(jcache.events)] \
        == _reasons(cache.events)
    assert eng.programs_made == jeng.compile_events >= 1
    assert eng.cache_hits == jeng.cache_hits
    for g, w in zip(eng.predict(x), want):  # the fresh programs serve right
        np.testing.assert_array_equal(g, w)
    eng.close()
    assert _decisions(cache) == _jax_decisions(jcold_cache, jcache)


def test_entry_key_tracks_identity():
    """JAX ``test_entry_key_tracks_identity``; the port's key of a JAX
    identity is the JAX key, and the port's own fields move it too."""
    base = {
        "spec": {"objective": "mse"}, "params": {"n": 1},
        "window": [4, 8, 3], "bucket": 2,
        "fingerprint": {"jaxlib": "x", "device_ids": [0]},
    }
    k0 = pc.entry_key(base)
    assert k0 == pc.entry_key(dict(base)) == jax_pc.entry_key(base)
    for field, value in (
        ("bucket", 4),
        ("window", [4, 8, 4]),
        ("fingerprint", {"jaxlib": "x", "device_ids": [1]}),
        ("params", {"n": 2}),
        ("graphed", True),
        ("lanes", ["a", "b"]),
    ):
        assert pc.entry_key({**base, field: value}) != k0
        assert pc.entry_key({**base, field: value}) == \
            jax_pc.entry_key({**base, field: value})


def test_the_keys_follow_the_weights_signature_and_the_device():
    cache = ProgramCache()
    wide_spec = ModelSpec(objective="mse", hidden_size=2 * H, num_layers=1,
                          dropout=0.0)
    one, wide = (PredictEngine(spec, spec.build_module(device="cpu")
                               .state_dict(), n_stocks=K, lookback=T,
                               n_features=F, buckets=(1,), device="cpu",
                               program_cache=cache)
                 for spec in (_spec(), wide_spec))
    assert one._cache_key(1) != wide._cache_key(1)
    assert one._cache_key(1) != one._cache_key(2)
    fp = one._fingerprint
    assert fp["platform"] == "cpu" and fp["torch"] == torch.__version__
    assert len(fp["kernels"]) == 16


# ------------------------------------------------ stacked lanes in the key


def _jax_stacked(trees, cache, buckets=BUCKETS):
    return JaxStacked(_jax_spec(), trees, n_stocks=K, lookback=T,
                      n_features=F, buckets=buckets, program_cache=cache)


def _stacked(trees, cache, buckets=BUCKETS):
    return StackedPredictEngine(_spec(), [_state(t) for t in trees],
                                n_stocks=K, lookback=T, n_features=F,
                                buckets=buckets, device="cpu",
                                program_cache=cache)


def test_lane_swap_rekeys_the_stack_but_not_the_solo_engine(trees, tmp_path):
    """JAX ``TestProgramCacheLaneKeys.test_lane_swap_rekeys_stack_but_not_
    solo``, engine by engine."""
    jcache = jax_pc.ProgramCache(tmp_path)
    cache = ProgramCache()
    lanes, swapped_lanes = trees[:2], [trees[0], trees[2]]
    steps = []
    for name, jbuild, build, close in (
            ("cold", lambda c: _jax_stacked(lanes, c),
             lambda c: _stacked(lanes, c), True),
            ("solo_cold", lambda c: _jax_engine(lanes[0], c),
             lambda c: _engine(lanes[0], c), True),
            ("warm", lambda c: _jax_stacked(lanes, c),
             lambda c: _stacked(lanes, c), False),
            ("swapped", lambda c: _jax_stacked(swapped_lanes, c),
             lambda c: _stacked(swapped_lanes, c), True),
            ("solo_warm", lambda c: _jax_engine(lanes[0], c),
             lambda c: _engine(lanes[0], c), False)):
        jeng, eng = jbuild(jcache), build(cache)
        jeng.warmup()
        eng.warmup()
        steps.append((name, jeng, eng))
        assert (eng.cache_hits, eng.programs_made) == \
            (jeng.cache_hits, jeng.compile_events), name
        if name == "cold":
            x = _windows(2, seed=6)
            want = eng.predict(x)
        if name == "warm":
            got = eng.predict(x)
            for g, w, j in zip(got, want, jeng.predict(x)):
                np.testing.assert_array_equal(g, w)
                np.testing.assert_allclose(g, j, atol=ATOL, rtol=0)
        if close:
            eng.close()
    got = {name: (eng.cache_hits, eng.programs_made)
           for name, _, eng in steps}
    assert got == {"cold": (0, 2), "solo_cold": (0, 2), "warm": (2, 0),
                   "swapped": (0, 2), "solo_warm": (2, 0)}
    assert _decisions(cache) == _jax_decisions(jcache)


def test_lane_order_is_part_of_the_key(trees, tmp_path):
    """JAX ``TestProgramCacheLaneKeys.test_lane_order_is_part_of_the_key``."""
    jcache = jax_pc.ProgramCache(tmp_path)
    _jax_stacked(trees[:2], jcache, buckets=(1,)).warmup()
    jb = _jax_stacked(trees[:2][::-1], jcache, buckets=(1,))
    jb.warmup()

    cache = ProgramCache()
    a = _stacked(trees[:2], cache, buckets=(1,))
    a.warmup()
    a.close()
    b = _stacked(trees[:2][::-1], cache, buckets=(1,))
    b.warmup()
    assert (b.cache_hits, b.programs_made) == \
        (jb.cache_hits, jb.compile_events) == (0, 1)
    b.close()
    assert _decisions(cache) == _jax_decisions(jcache)


def test_a_stacked_warm_boot_keeps_a_set_lane(trees):
    """A lane committed by ``set_lane`` is in the key the stack closes
    under, and in the weights a warm boot on those lanes serves."""
    cache = ProgramCache()
    eng = _stacked(trees[:2], cache)
    eng.warmup()
    eng.set_lane(1, _state(trees[2]))
    eng.close()
    warm = _stacked([trees[0], trees[2]], cache)
    warm.warmup()
    assert (warm.cache_hits, warm.programs_made) == (len(BUCKETS), 0)
    cold = _stacked([trees[0], trees[2]], None)
    x = _windows(2, seed=8)
    for g, w in zip(warm.predict(x), cold.predict(x)):
        np.testing.assert_array_equal(g, w)


def test_engines_booting_and_closing_on_threads_never_share_a_program(trees):
    """More threads than cores boot engines from one cache and close them,
    under a short switch interval: no program is ever held by two live
    engines, and every load is counted once (hit, miss or rejection)."""
    import sys
    import threading

    cache = ProgramCache()
    held: dict[int, int] = {}
    lock = threading.Lock()
    clashes, errors = [], []
    state = _state(trees[0])

    def worker(me: int) -> None:
        try:
            for _ in range(6):
                engine = PredictEngine(_spec(), state, n_stocks=K, lookback=T,
                                       n_features=F, buckets=BUCKETS,
                                       device="cpu", program_cache=cache)
                engine.warmup()
                ids = [id(p) for p in engine._programs.values()]
                with lock:
                    clashes.extend(i for i in ids if i in held)
                    held.update((i, me) for i in ids)
                engine.predict(_windows(1, seed=me))
                with lock:
                    for i in ids:
                        del held[i]
                engine.close()
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors and not clashes
    loads = 12 * 6 * len(BUCKETS)
    assert cache.hits + cache.misses + cache.rejections == loads
    assert cache.rejections == 0 and cache.hits > 0
    assert cache.stores == loads  # every engine gave back what it held
