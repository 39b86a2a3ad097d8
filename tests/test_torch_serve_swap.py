"""The port's canaried hot-swap, preflight and selfcheck against the JAX
package's, on the CPU.

``canary_checks`` gives the JAX verdict on the same arrays;
``golden_batch`` is bitwise the JAX one; ``CheckpointSwapper.try_swap`` on
a CPU engine gives the JAX swapper's reason on every case, each side's
checkpoints saved from the same numpy weights (``models/convert.py``);
after a commit the two engines agree within 1e-5 abs (f32 on both sides,
summed in another order), and after a refusal each side's answers are
bit-equal to its answers before.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from masters_thesis_tpu.models.objectives import ModelSpec as JaxSpec
from masters_thesis_tpu.resilience import faults as jax_faults
from masters_thesis_tpu.serve import swap as jax_swap
from masters_thesis_tpu.serve.engine import PredictEngine as JaxEngine
from masters_thesis_tpu.train.checkpoint import save_checkpoint as jax_save
from masters_thesis_tpu_torch.models.convert import params_from_jax
from masters_thesis_tpu_torch.models.objectives import ModelSpec
from masters_thesis_tpu_torch.resilience import faults
from masters_thesis_tpu_torch.serve import swap
from masters_thesis_tpu_torch.serve.engine import PredictEngine
from masters_thesis_tpu_torch.serve.preflight import run_serve_preflight
from masters_thesis_tpu_torch.telemetry.events import read_events
from masters_thesis_tpu_torch.telemetry.run import TelemetryRun
from masters_thesis_tpu_torch.train.checkpoint import save_checkpoint

K, T, F, H = 4, 8, 3, 8
BUCKETS = (1, 4)
ATOL = 1e-5
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _no_leaked_faults(monkeypatch):
    monkeypatch.delenv(faults.FAULT_PLAN_ENV, raising=False)
    monkeypatch.delenv(faults.ATTEMPT_ENV, raising=False)
    yield
    faults.clear_plan()
    jax_faults.clear_plan()


Z = (np.zeros((2, 3)), np.zeros((2, 3)))
CANARY_CASES = {
    "committed": (Z, (np.full((2, 3), 0.25), np.zeros((2, 3))), None),
    "committed_in_budget": (Z, (np.full((2, 3), 0.25), np.zeros((2, 3))), 0.5),
    "canary_nonfinite": (Z, (np.full((2, 3), np.nan), np.zeros((2, 3))), None),
    "canary_nonfinite_inf": (Z, (np.zeros((2, 3)), np.full((2, 3), -np.inf)),
                             0.5),
    "canary_abs": (Z, (np.full((2, 3), 1e9), np.zeros((2, 3))), None),
    "canary_drift": (Z, (np.ones((2, 3)), np.zeros((2, 3))), 0.5),
    "f32_inputs": ((np.zeros((1, 3), np.float32),) * 2,
                   (np.full((1, 3), 1e-3, np.float32),) * 2, 1e-3),
}


@pytest.mark.parametrize("case", sorted(CANARY_CASES))
def test_canary_checks_equal_the_jax_verdict(case):
    current, candidate, max_drift = CANARY_CASES[case]
    got = swap.canary_checks(current, candidate, max_drift=max_drift)
    want = jax_swap.canary_checks(current, candidate, max_drift=max_drift)
    assert (got.ok, got.reason, got.detail) == (want.ok, want.reason, want.detail)
    assert got.checks == want.checks


def _jax_spec(hidden=H, layers=2):
    return JaxSpec(objective="mse", hidden_size=hidden, num_layers=layers,
                   dropout=0.0, kernel_impl="xla")


def _spec(hidden=H, layers=2):
    return ModelSpec(objective="mse", hidden_size=hidden, num_layers=layers,
                     dropout=0.0)


def _params(seed, hidden=H, layers=2):
    params = _jax_spec(hidden, layers).build_module().init(
        jax.random.key(seed), jnp.zeros((1, T, F), jnp.float32))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


META = {"epoch": 1, "datamodule": {"lookback_window": T}}


def _save_both(root: Path, params, hidden=H, layers=2,
               extra_files=None) -> tuple[Path, Path]:
    """The same numpy weights (and extra files) published by each package:
    (jax dir, port dir)."""
    jax_dir, port_dir = root / "jax", root / "port"
    jax_save(jax_dir, "best", params, {}, _jax_spec(hidden, layers),
             meta=META, extra_files=extra_files)
    save_checkpoint(port_dir, "best", params_from_jax(params),
                    spec=_spec(hidden, layers), meta=META,
                    extra_files=extra_files)
    return jax_dir, port_dir


def test_golden_batch_is_bitwise_the_jax_one(tmp_path):
    jax_dir, port_dir = _save_both(tmp_path, _params(0))
    ours = PredictEngine.from_checkpoint(port_dir, n_stocks=K, device="cpu")
    theirs = JaxEngine.from_checkpoint(jax_dir, n_stocks=K, buckets=(1,))
    for n, seed in ((1, 0), (3, 11), (8, 1009 * 8 + 7)):
        np.testing.assert_array_equal(ours.golden_batch(n, seed),
                                      theirs.golden_batch(n, seed))
    assert ours.golden_batch().dtype == np.float32


def _nan_params(seed):
    params = _params(seed)
    params["alpha_head"]["bias"] = np.full_like(params["alpha_head"]["bias"],
                                                np.nan)
    return params


def _drop_manifest(jax_dir, port_dir):
    for d in (jax_dir, port_dir):
        (d / "best" / "MANIFEST.json").unlink()


# case -> (candidate weights, the candidate's (hidden, layers), what to do to
# the published trees, swapper keywords, expected reason)
SWAP_CASES = {
    "commit": (lambda: _params(7), (H, 2), None, {}, "committed"),
    "corrupt": (lambda: _params(7), (H, 2), "pre_swap", {}, "verify_failed"),
    "manifestless": (lambda: _params(7), (H, 2), _drop_manifest, {},
                     "verify_failed"),
    "shape_mismatch": (lambda: _params(7, 16, 1), (16, 1), None, {},
                       "shape_mismatch"),
    "nan": (lambda: _nan_params(7), (H, 2), None, {}, "canary_nonfinite"),
    "over_drift_budget": (lambda: _params(7), (H, 2), None,
                          {"max_drift": 1e-6}, "canary_drift"),
}


@pytest.fixture(scope="module")
def windows():
    return np.random.default_rng(2).normal(size=(3, K, T, F)).astype(np.float32)


def _answers(engine, x):
    return [engine.predict(x[:1]), engine.predict(x)]


@pytest.mark.parametrize("case", sorted(SWAP_CASES))
def test_try_swap_gives_the_jax_swappers_reason(tmp_path, windows, case):
    make, (hidden, layers), mutate, kw, reason = SWAP_CASES[case]
    live_jax, live_port = _save_both(tmp_path / "live", _params(0))
    ours = PredictEngine.from_checkpoint(live_port, n_stocks=K, device="cpu",
                                         buckets=BUCKETS)
    theirs = JaxEngine.from_checkpoint(live_jax, n_stocks=K, buckets=BUCKETS)
    theirs.warmup()
    ours.warmup()
    before = _answers(ours, windows), _answers(theirs, windows)
    cand_jax, cand_port = _save_both(tmp_path / "cand", make(), hidden, layers)
    if mutate == "pre_swap":
        plan = '{"seed": 5, "faults": [{"point": "serve.pre_swap", "kind": "corrupt", "attempt": null}]}'
        faults.install_plan(faults.FaultPlan.parse(plan))
        jax_faults.install_plan(jax_faults.FaultPlan.parse(plan))
    elif mutate is not None:
        mutate(cand_jax, cand_port)
    tel = TelemetryRun(tmp_path / "tel", run_id="swap")
    got = swap.CheckpointSwapper(ours, telemetry=tel, **kw).try_swap(cand_port)
    want = jax_swap.CheckpointSwapper(theirs, **kw).try_swap(cand_jax)
    tel.close()
    (event,) = [e for e in read_events(tmp_path / "tel" / "events.jsonl")
                if e["kind"].startswith("swap_")]
    assert event["kind"] == ("swap_committed" if got.ok else "swap_rejected")
    assert got.reason == want.reason == reason
    assert got.ok == want.ok
    after = _answers(ours, windows), _answers(theirs, windows)
    if got.ok:
        for (ga, gb), (wa, wb) in zip(*after):
            np.testing.assert_allclose(ga, wa, atol=ATOL, rtol=0)
            np.testing.assert_allclose(gb, wb, atol=ATOL, rtol=0)
        assert not np.array_equal(after[0][1][0], before[0][1][0])
    else:
        for side in (0, 1):
            for now, then in zip(after[side], before[side]):
                for a, b in zip(now, then):
                    np.testing.assert_array_equal(a, b)
    assert got.checks.keys() == want.checks.keys()


def test_a_candidate_with_a_quality_fingerprint_is_refused(tmp_path, windows):
    """A candidate whose quality.json is malformed (a golden section with
    no sketches) is refused by name, as the JAX swapper refuses it, never
    swapped in unscored; the serving answers stay as they were."""
    bad = '{"golden": {"seed": 0, "shape": [3, %d, %d, %d]}}' % (K, T, F)
    _, live = _save_both(tmp_path / "live", _params(0))
    cand_jax, cand = _save_both(tmp_path / "cand", _params(7),
                                extra_files={"quality.json": bad})
    engine = PredictEngine.from_checkpoint(live, n_stocks=K, device="cpu")
    tel = TelemetryRun(tmp_path / "tel", run_id="swap")
    swapper = swap.CheckpointSwapper(engine, telemetry=tel)
    before = _answers(engine, windows)
    verdict = swapper.try_swap(cand)
    tel.close()
    (event,) = [e for e in read_events(tmp_path / "tel" / "events.jsonl")
                if e["kind"].startswith("swap_")]
    assert event["kind"] == "swap_rejected"
    assert event["reason"] == "quality_error" and event["tag"] == "best"
    assert not verdict.ok and verdict.reason == "quality_error"
    assert "could not score" in verdict.detail and verdict.checks["finite"]
    for now, then in zip(_answers(engine, windows), before):
        for a, b in zip(now, then):
            np.testing.assert_array_equal(a, b)
    assert (swapper.committed, swapper.rejected) == (0, 1)
    assert list(swapper.step_seconds) == ["pre_swap", "verify", "restore",
                                          "signature", "canary", "quality"]
    theirs = JaxEngine.from_checkpoint(tmp_path / "live" / "jax", n_stocks=K,
                                       buckets=(1,))
    theirs.warmup()
    want = jax_swap.CheckpointSwapper(theirs).try_swap(cand_jax)
    assert want.reason == verdict.reason


def test_put_params_checks_the_signature():
    engine = PredictEngine(_spec(), params_from_jax(_params(0)), n_stocks=K,
                           lookback=T, device="cpu")
    state = params_from_jax(_params(1))
    old = engine.set_params(engine.put_params(state))
    assert set(old) == set(state)
    del state["alpha_head.bias"]
    with pytest.raises(ValueError, match="does not match"):
        engine.put_params(state)


def test_preflight_on_the_cpu_finds_nothing():
    findings, facts = run_serve_preflight(device="cpu")
    assert findings == []
    assert facts["captures"] == 0 and facts["steady_new_captures"] == 0
    assert facts["swap"]["reason"] == "committed"
    assert facts["swap"]["unresolved"] == facts["swap"]["late_deliveries"] == 0


def test_selfcheck_runs_without_torch_or_jax():
    code = (
        "import runpy, sys\n"
        "for name in ('torch', 'jax', 'jaxlib', 'flax',\n"
        "             'masters_thesis_tpu'):\n"
        "    sys.modules[name] = None\n"
        "sys.argv = ['serve', 'selfcheck']\n"
        "runpy.run_module('masters_thesis_tpu_torch.serve',\n"
        "                 run_name='__main__', alter_sys=True)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop(faults.FAULT_PLAN_ENV, None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "serve: selfcheck ok" in proc.stdout
