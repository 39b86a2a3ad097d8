"""The port's backend probe and its cache policy on the CPU, against the JAX
package's.

JAX ``tests/test_resilience.py::TestBackendHealth``, with
``probe_cuda_backend`` in place of ``probe_tpu_backend``: the same scripted
probe outcomes give the same decisions (ok, attempts, known-wedged, the
budget the probe was given) from both packages' ``BackendHealth``. Then one
real probe here, where torch has no CUDA: the child exits non-zero, a
deterministic crash, refused in ONE attempt well inside 30 s; and the
program identity ``backend_fingerprint`` of the CPU.
"""

import time

import pytest

import masters_thesis_tpu.utils.backend_probe as jbp
import masters_thesis_tpu_torch.utils.backend_probe as bp
from masters_thesis_tpu.resilience import faults as jax_faults
from masters_thesis_tpu_torch.resilience import faults


def _health(module, tmp_path, **kw):
    defaults = dict(timeout_s=1.0, budget_s=10.0, backoff_s=0.0)
    defaults.update(kw)
    return module.BackendHealth(tmp_path / "probe_cache.json", **defaults)


def _scripted(monkeypatch, ok: bool, detail: str = ""):
    """Both packages' probe replaced by one scripted outcome; returns the
    keyword arguments each was called with."""
    seen = {"jax": {}, "port": {}}

    def fake(side, module):
        def probe(**kw):
            seen[side].update(kw)
            return module.ProbeResult(ok, 1, detail)
        return probe

    monkeypatch.setattr(jbp, "probe_tpu_backend", fake("jax", jbp))
    monkeypatch.setattr(bp, "probe_cuda_backend", fake("port", bp))
    return seen


def _decision(d) -> tuple:
    return (d.ok, d.degraded, d.attempts, d.known_wedged)


def test_a_healthy_probe_is_recorded(tmp_path, monkeypatch):
    _scripted(monkeypatch, ok=True)
    got = _health(bp, tmp_path / "port")
    decision = got.ensure_responsive()
    want = _health(jbp, tmp_path / "jax").ensure_responsive()
    assert _decision(decision) == _decision(want) == (True, False, 1, False)
    assert got.read_cache()["ok"]


def test_a_known_wedge_gets_a_single_attempt(tmp_path, monkeypatch):
    seen = _scripted(monkeypatch, ok=False, detail="probe timed out")
    decisions = []
    for side, module in (("port", bp), ("jax", jbp)):
        health = _health(module, tmp_path / side)
        health.record_wedge("test wedge")
        decisions.append(_decision(health.ensure_responsive()))
    assert decisions[0] == decisions[1] == (False, True, 1, True)
    assert seen["port"]["budget_s"] == seen["jax"]["budget_s"] == 0.0


@pytest.mark.parametrize("single_attempt", [True, False])
def test_the_budget_the_probe_gets(tmp_path, monkeypatch, single_attempt):
    seen = _scripted(monkeypatch, ok=False, detail="nope")
    for side, module in (("port", bp), ("jax", jbp)):
        decision = _health(module, tmp_path / side).ensure_responsive(
            single_attempt=single_attempt)
        assert not decision.ok
    want = 0.0 if single_attempt else 10.0
    assert seen["port"]["budget_s"] == seen["jax"]["budget_s"] == want


def test_the_cache_expires_after_its_ttl(tmp_path):
    health = _health(bp, tmp_path, ttl_s=0.05)
    health.record(True, "fine")
    assert health.read_cache() is not None
    time.sleep(0.1)
    assert health.read_cache() is None
    (tmp_path / "probe_cache.json").write_text("{not json")
    assert health.read_cache() is None


def test_an_injected_wedge_fails_the_probe_at_once():
    """The ``probe.attempt`` wedge runs the real retry loop without the
    real timeout, in both packages."""
    plan = dict(point="probe.attempt", kind="wedge", attempt=None)
    faults.install_plan(faults.FaultPlan(faults=[faults.FaultSpec(**plan)]))
    jax_faults.install_plan(jax_faults.FaultPlan(
        faults=[jax_faults.FaultSpec(**plan)]))
    try:
        t0 = time.monotonic()
        got = bp.probe_cuda_backend(timeout_s=60.0, budget_s=0.0,
                                    backoff_s=0.0)
        want = jbp.probe_tpu_backend(timeout_s=60.0, budget_s=0.0,
                                     backoff_s=0.0)
        # With a budget the wedge is retried until it is spent.
        retried = bp.probe_cuda_backend(timeout_s=60.0, budget_s=0.2,
                                        backoff_s=0.05)
    finally:
        faults.clear_plan()
        jax_faults.clear_plan()
    assert time.monotonic() - t0 < 5.0
    assert (got.ok, got.attempts) == (want.ok, want.attempts) == (False, 1)
    assert "timed out" in got.detail
    assert not retried.ok and retried.attempts > 1


def test_the_real_probe_fails_in_one_attempt_without_a_card(tmp_path):
    """Here torch has no CUDA: the child exits non-zero, a crash that is
    not retried, whatever the budget."""
    t0 = time.monotonic()
    probe = bp.probe_cuda_backend(timeout_s=25.0, budget_s=60.0,
                                  backoff_s=5.0)
    assert time.monotonic() - t0 < 30.0
    assert not probe.ok and probe.attempts == 1
    assert probe.detail.startswith("init crashed (rc=")
    decision = _health(bp, tmp_path, timeout_s=25.0).ensure_responsive(
        single_attempt=True)
    assert _decision(decision) == (False, True, 1, False)
    assert _health(bp, tmp_path).read_cache()["ok"] is False


def test_the_fingerprint_of_the_cpu():
    import torch

    fp = bp.backend_fingerprint("cpu")
    assert fp == {"torch": torch.__version__, "cuda": torch.version.cuda,
                  "platform": "cpu", "device_index": None,
                  "device_name": "cpu", "capability": None,
                  "kernels": bp.kernels_digest()}
    assert fp == bp.backend_fingerprint(torch.device("cpu"))


def test_the_kernel_digest_follows_the_sources(monkeypatch, tmp_path):
    from masters_thesis_tpu_torch.ops import _build

    before = bp.kernels_digest()
    extra = tmp_path / "extra.cu"
    extra.write_text("// another kernel\n")
    monkeypatch.setattr(_build, "sources",
                        lambda: sorted(_build.CSRC_DIR.glob("*.cu")) + [extra])
    assert bp.kernels_digest() != before
