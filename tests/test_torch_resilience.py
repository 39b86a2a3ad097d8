"""The port's fault plan, checkpoint manifests and crash-safe publish
against the JAX package's.

Every torn layout of ``tests/test_resilience.py`` (TestCheckpointManifest)
and of ``tests/test_trainer.py``'s staged-publish cases is built from the
port's own saves; the port's restore must restore, fall back or raise as
the JAX restore does there, and the JAX package's ``verify_checkpoint`` /
``last_verified_checkpoint`` (filesystem and hashing only) must agree with
the port's on the same tree. A kill at ``checkpoint.mid_publish`` followed
by a resume ends bit for bit where an unbroken run ends.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from masters_thesis_tpu.train import manifest as jax_manifest
from masters_thesis_tpu_torch.models.objectives import ModelSpec
from masters_thesis_tpu_torch.resilience import faults
from masters_thesis_tpu_torch.resilience.faults import (
    FaultInjected,
    FaultPlan,
    FaultSpec,
)
from masters_thesis_tpu_torch.serve.engine import PredictEngine
from masters_thesis_tpu_torch.train import manifest
from masters_thesis_tpu_torch.train.checkpoint import (
    MANIFEST_NAME,
    CorruptCheckpointError,
    checkpoint_restorable,
    load_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)

REPO = Path(__file__).resolve().parent.parent
SPEC = ModelSpec(objective="mse", hidden_size=8, num_layers=1, dropout=0.0,
                 learning_rate=1e-2)


@pytest.fixture(autouse=True)
def _no_leaked_faults(monkeypatch):
    """Every test starts and ends with injection off, whatever it does."""
    monkeypatch.delenv(faults.FAULT_PLAN_ENV, raising=False)
    monkeypatch.delenv(faults.ATTEMPT_ENV, raising=False)
    yield
    faults.clear_plan()


# --------------------------------------------------------------- fault plan


def test_plan_parse_roundtrip_and_forms():
    plan = FaultPlan.parse(
        '[{"point": "trainer.loss", "kind": "nan", "attempt": 2}]')
    assert plan.faults[0].attempt == 2
    assert FaultPlan.parse(plan.to_json()).faults == plan.faults
    wrapped = FaultPlan.parse(
        '{"seed": 7, "faults": [{"point": "data.epoch", "kind": "raise"}]}')
    assert wrapped.seed == 7


def test_plans_are_the_jax_packages_format(tmp_path):
    """One plan drives either package: each parses the other's JSON to the
    same specs, also from an ``@file``."""
    from masters_thesis_tpu.resilience.faults import FaultPlan as JaxPlan

    text = json.dumps({"seed": 3, "faults": [
        {"point": "checkpoint.mid_publish", "kind": "kill",
         "match": {"tag": "last", "epoch": 1}},
        {"point": "trainer.loss", "kind": "nan", "attempt": None}]})
    (tmp_path / "plan.json").write_text(text)
    for source in (text, f"@{tmp_path / 'plan.json'}"):
        port, jax_plan = FaultPlan.parse(source), JaxPlan.parse(source)
        assert json.loads(port.to_json()) == json.loads(jax_plan.to_json())
        assert json.loads(FaultPlan.parse(jax_plan.to_json()).to_json()) == \
            json.loads(port.to_json())


def test_unknown_point_or_kind_rejected():
    with pytest.raises(ValueError):
        FaultSpec(point="trainer.typo", kind="nan")
    with pytest.raises(ValueError):
        FaultSpec(point="trainer.loss", kind="explode")


def test_disabled_is_inert():
    assert faults.fire("trainer.loss", epoch=0) is None


def test_install_plan_and_ctx_match():
    faults.install_plan(FaultPlan(faults=(
        FaultSpec(point="trainer.loss", kind="nan", match={"epoch": 2}),)))
    assert faults.fire("trainer.loss", epoch=1) is None
    assert faults.fire("trainer.loss", epoch=2) == "nan"
    assert faults.fire("trainer.epoch_start", epoch=2) is None
    faults.clear_plan()
    assert faults.fire("trainer.loss", epoch=2) is None


def test_attempt_scoping(monkeypatch):
    faults.install_plan(FaultPlan(faults=(
        FaultSpec(point="worker.epoch", kind="nan", attempt=1),)))
    assert faults.fire("worker.epoch", epoch=0) == "nan"
    monkeypatch.setenv(faults.ATTEMPT_ENV, "2")
    assert faults.fire("worker.epoch", epoch=0) is None


def test_env_activation_and_raise(monkeypatch):
    monkeypatch.setenv(faults.FAULT_PLAN_ENV,
                       '[{"point": "data.epoch", "kind": "raise", "attempt": null}]')
    with pytest.raises(FaultInjected):
        faults.fire("data.epoch", epoch=0)


def test_install_none_overrides_env(monkeypatch):
    monkeypatch.setenv(faults.FAULT_PLAN_ENV,
                       '[{"point": "data.epoch", "kind": "raise", "attempt": null}]')
    faults.install_plan(None)
    assert faults.fire("data.epoch", epoch=0) is None


# ------------------------------------------------------- checkpoint layouts


def _save(d, epoch, tag="last", state=None):
    """A save of ``epoch``: its weights are ``epoch`` everywhere, or
    ``state``."""
    state = state or {"w": torch.full((64,), float(epoch))}
    save_checkpoint(d, tag, state, {}, {"lr": 0.1},
                    meta={"epoch": epoch, "datamodule": {"lookback_window": 5}},
                    spec=SPEC)


def _encoder_state(seed: int) -> dict:
    return SPEC.build_module(
        device="cpu", generator=torch.Generator().manual_seed(seed)).state_dict()


def _corrupt_primary(d, offset=None):
    victim = max((p for p in (d / "last").rglob("*")
                  if p.is_file() and p.name != MANIFEST_NAME),
                 key=lambda p: p.stat().st_size)
    blob = bytearray(victim.read_bytes())
    blob[len(blob) // 2 if offset is None else offset] ^= 0xFF
    victim.write_bytes(bytes(blob))


def _move_pair(src, dst):
    """``src``'s last pair becomes ``dst``'s staged pair."""
    shutil.move(str(src / "last"), str(dst / "last.new"))
    shutil.move(str(src / "last.json"), str(dst / "last.json.new"))


def _saved(*epochs):
    def build(d, tmp):
        for e in epochs:
            _save(d, e)
    return build


def _then(build, tear):
    def both(d, tmp):
        build(d, tmp)
        tear(d, tmp)
    return both


def _corrupt_latest(d, tmp):
    _corrupt_primary(d)


def _drop_manifest(d, tmp):
    (d / "last" / MANIFEST_NAME).unlink()


def _drop_prev_sidecar(d, tmp):
    (d / "last.prev.json").unlink()


def _drop_prev_tree(d, tmp):
    shutil.rmtree(d / "last.prev")


def _staged_pair(d, tmp):
    _save(d, 0)
    _save(tmp / "b", 1)
    _move_pair(tmp / "b", d)


def _orphan_staged_tree(d, tmp):
    _save(d, 0)
    _save(tmp / "b", 1)
    shutil.move(str(tmp / "b" / "last"), str(d / "last.new"))


def _sidecar_swap_lost(d, tmp):
    _save(d, 0)
    stale = (d / "last.json").read_text()
    _save(d, 1)
    (d / "last.json.new").write_text((d / "last.json").read_text())
    (d / "last.json").write_text(stale)


def _mid_tree_swap(d, tmp):
    _staged_pair(d, tmp)
    (d / "last").rename(d / "last.old")


def _killed_mid_publish(d, tmp):
    _save(d, 0)
    faults.install_plan(FaultPlan(faults=(FaultSpec(
        point="checkpoint.mid_publish", kind="raise",
        match={"tag": "last", "epoch": 1}),)))
    with pytest.raises(FaultInjected):
        _save(d, 1)
    faults.clear_plan()
    assert sorted(p.name for p in d.iterdir()) == [
        "last.json.new", "last.new", "last.prev", "last.prev.json"]


def _post_publish_corruption(d, tmp):
    _save(d, 0)
    faults.install_plan(FaultPlan(faults=(FaultSpec(
        point="checkpoint.post_publish", kind="corrupt", attempt=None),),
        seed=3))
    _save(d, 1)
    faults.clear_plan()


# (name, build, the epoch restored or the error raised, restorable, falls
# back to .prev)
LAYOUTS = [
    ("intact", _saved(0, 1), 1, True, False),
    ("corrupt_latest_falls_back", _then(_saved(0, 1), _corrupt_latest), 0,
     True, True),
    ("corrupt_without_fallback_raises", _then(_saved(0), _corrupt_latest),
     CorruptCheckpointError, False, False),
    ("manifest_less_tree_is_lenient", _then(_saved(0), _drop_manifest), 0,
     True, False),
    ("rotation_lost_prev_sidecar", _then(_saved(0, 1), _drop_prev_sidecar), 1,
     True, False),
    ("rotation_lost_prev_sidecar_corrupt",
     _then(_then(_saved(0, 1), _drop_prev_sidecar), _corrupt_latest),
     CorruptCheckpointError, False, False),
    ("rotation_lost_prev_tree", _then(_saved(0, 1), _drop_prev_tree), 1, True,
     False),
    ("rotation_lost_prev_tree_corrupt",
     _then(_then(_saved(0, 1), _drop_prev_tree), _corrupt_latest),
     CorruptCheckpointError, False, False),
    ("staged_pair_supersedes", _staged_pair, 1, True, False),
    ("orphan_staged_tree_dropped", _orphan_staged_tree, 0, True, False),
    ("sidecar_swap_finished", _sidecar_swap_lost, 1, True, False),
    ("mid_tree_swap_recovered", _mid_tree_swap, 1, True, False),
    ("killed_mid_publish_finished", _killed_mid_publish, 1, True, False),
    ("post_publish_corruption_detected", _post_publish_corruption, 0, True,
     True),
]


@pytest.mark.parametrize("name,build,want,restorable,falls_back", LAYOUTS,
                         ids=[layout[0] for layout in LAYOUTS])
def test_torn_layout_restores_as_the_jax_package_does(tmp_path, capsys, name,
                                                      build, want, restorable,
                                                      falls_back):
    d = tmp_path / "a"
    build(d, tmp_path)
    # Before any recovery: the JAX package's view of the port's tree.
    assert manifest.last_verified_checkpoint(d) == \
        jax_manifest.last_verified_checkpoint(d)
    for tree in (d / n for n in ("last", "last.prev", "last.new")):
        for strict in (False, True):
            assert manifest.verify_checkpoint(tree, strict) == \
                jax_manifest.verify_checkpoint(tree, strict), (tree, strict)
    capsys.readouterr()
    assert checkpoint_restorable(d, "last") == restorable
    assert not (d / "last.new").exists() and not (d / "last.json.new").exists()
    if isinstance(want, type):
        with pytest.raises(want):
            restore_checkpoint(d, "last")
        return
    state, _, spec, meta = restore_checkpoint(d, "last")
    assert spec == SPEC and meta["epoch"] == want
    assert float(state["w"][0]) == float(want)  # tree and meta are one save
    err = capsys.readouterr().err
    assert ("failed verification; restoring previous good" in err) == falls_back
    # After recovery both packages pick the same restore point.
    assert manifest.last_verified_checkpoint(d) == \
        jax_manifest.last_verified_checkpoint(d)


def test_manifest_written_and_verified_by_both_packages(tmp_path):
    _save(tmp_path, 0)
    tree = tmp_path / "last"
    assert sorted(p.name for p in tree.iterdir()) == [MANIFEST_NAME, "state.pt"]
    body = json.loads((tree / MANIFEST_NAME).read_text())
    assert body["algo"] == "sha256" and list(body["files"]) == ["state.pt"]
    assert body["files"]["state.pt"]["size"] == (tree / "state.pt").stat().st_size
    for verify in (manifest.verify_checkpoint, jax_manifest.verify_checkpoint):
        assert verify(tree) and verify(tree, require_manifest=True)
    (tree / MANIFEST_NAME).unlink()
    for verify in (manifest.verify_checkpoint, jax_manifest.verify_checkpoint):
        assert verify(tree) and not verify(tree, require_manifest=True)


def _legacy_checkpoint(root: Path, tag: str, epoch: int) -> None:
    """A checkpoint as the port wrote it before the tree layout: one
    ``<tag>.pt`` beside its ``<tag>.json``."""
    sidecar = {"spec": dataclasses.asdict(SPEC), "scheduler": {"lr": 0.1},
               "meta": {"epoch": epoch, "datamodule": {"lookback_window": 5}}}
    root.mkdir(parents=True, exist_ok=True)
    torch.save({"state_dict": _encoder_state(epoch),
                "opt_state": {"count": torch.tensor(3)}, **sidecar},
               root / f"{tag}.pt")
    (root / f"{tag}.json").write_text(json.dumps(sidecar))


def test_pre_manifest_pt_restores_and_is_not_served(tmp_path):
    _legacy_checkpoint(tmp_path, "best", 4)
    for path in (tmp_path, tmp_path / "best", tmp_path / "best.pt"):
        state, opt_state, spec, meta = restore_checkpoint(path, "best")
        assert spec == SPEC and meta["epoch"] == 4
        assert int(opt_state["count"]) == 3
        for name, value in _encoder_state(4).items():
            assert torch.equal(state[name], value), name
    assert checkpoint_restorable(tmp_path, "best")
    assert load_checkpoint(tmp_path, "best")[2] == {"lr": 0.1}
    with pytest.raises(CorruptCheckpointError, match="strict manifest"):
        PredictEngine.from_checkpoint(tmp_path, "best", n_stocks=2,
                                      device="cpu")
    # A new save in the same directory takes precedence over the old file.
    _save(tmp_path, 7, tag="best", state=_encoder_state(7))
    assert restore_checkpoint(tmp_path, "best")[3]["epoch"] == 7
    engine = PredictEngine.from_checkpoint(tmp_path, "best", n_stocks=2,
                                           device="cpu", buckets=(1,))
    assert engine.window_shape == (2, 5, 3)


def test_from_checkpoint_refuses_a_corrupted_tree(tmp_path):
    _save(tmp_path, 0, state=_encoder_state(0))
    _save(tmp_path, 1, state=_encoder_state(1))
    x = np.random.default_rng(0).standard_normal((1, 2, 5, 3)).astype(np.float32)
    engine = PredictEngine.from_checkpoint(tmp_path, "last", n_stocks=2,
                                           device="cpu", buckets=(1,))
    state, _, spec, meta = restore_checkpoint(tmp_path, "last")
    direct = PredictEngine(spec, state, n_stocks=2, lookback=5, device="cpu",
                           buckets=(1,))
    for got, want in zip(engine.predict(x), direct.predict(x)):
        np.testing.assert_array_equal(got, want)
    _corrupt_primary(tmp_path, offset=-1)
    with pytest.raises(CorruptCheckpointError, match="strict manifest"):
        PredictEngine.from_checkpoint(tmp_path, "last", n_stocks=2,
                                      device="cpu")
    # The lenient restore still falls back to the previous good save.
    assert restore_checkpoint(tmp_path, "last")[3]["epoch"] == 0


# ------------------------------------------------------- kill, then resume

TOY = [
    "datamodule.n_stocks=4",
    "datamodule.n_samples=1200",
    "datamodule.lookback_window=10",
    "datamodule.target_window=5",
    "datamodule.stride=15",
    "model.hidden_size=8",
    "trainer.enable_progress_bar=false",
    "trainer.max_epochs=3",
]


def _train(tmp_path, version, *extra, plan=None):
    env = {k: v for k, v in os.environ.items()
           if k not in (faults.FAULT_PLAN_ENV, faults.ATTEMPT_ENV)}
    env["PYTHONPATH"] = str(REPO)
    if plan is not None:
        env[faults.FAULT_PLAN_ENV] = plan
    return subprocess.run(
        [sys.executable, "-m", "masters_thesis_tpu_torch", "train", "--device",
         "cpu", *TOY, f"datamodule.data_dir={tmp_path / 'data'}",
         f"logger.save_dir={tmp_path}", f"logger.version={version}", *extra],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)


def test_kill_mid_publish_then_resume_is_bit_equal(tmp_path):
    whole = _train(tmp_path, "whole")
    assert whole.returncode == 0, whole.stderr
    plan = json.dumps([{"point": "checkpoint.mid_publish", "kind": "kill",
                        "match": {"tag": "last", "epoch": 1}}])
    killed = _train(tmp_path, "split", plan=plan)
    assert killed.returncode == -9, killed.stderr
    assert "[faults] firing kind=kill at point=checkpoint.mid_publish" in \
        killed.stderr
    ckpts = tmp_path / "FinancialLstm" / "synthetic"
    split = ckpts / "split" / "checkpoints"
    assert {"last.new", "last.json.new", "last.prev"} <= {
        p.name for p in split.iterdir()}
    assert "last" not in {p.name for p in split.iterdir()}
    resumed = _train(tmp_path, "split", "trainer.resume=true")
    assert resumed.returncode == 0, resumed.stderr
    for tag in ("best", "last"):
        got = load_checkpoint(split, tag)
        want = load_checkpoint(ckpts / "whole" / "checkpoints", tag)
        for name, value in want[0].items():
            assert torch.equal(got[0][name], value), (tag, name)
        for name, value in want[1].items():
            same = (torch.equal(got[1][name], value) if torch.is_tensor(value)
                    else got[1][name] == value)
            assert same, (tag, name)
        assert got[2:] == want[2:]
        assert got[3]["epoch"] == 2


def test_trainer_fault_points(tmp_path, capsys):
    """``trainer.loss`` (nan) drives the divergence halt with ``last`` kept
    at the last finite epoch; ``trainer.epoch_dispatched`` fires once the
    epoch is queued, before anything of it is read or saved."""
    from masters_thesis_tpu_torch.data.pipeline import (
        FinancialWindowDataModule,
        bootstrap_synthetic,
    )
    from masters_thesis_tpu_torch.train.trainer import Trainer

    bootstrap_synthetic(tmp_path / "data", n_stocks=4, n_samples=1200, seed=0)
    dm = FinancialWindowDataModule(tmp_path / "data", lookback_window=10,
                                   target_window=5, stride=15)
    spec = ModelSpec(objective="mse", hidden_size=8, num_layers=2, dropout=0.0)
    faults.install_plan(FaultPlan(faults=(
        FaultSpec(point="trainer.loss", kind="nan", match={"epoch": 1}),)))
    result = Trainer(max_epochs=3, ckpt_dir=tmp_path / "nan", device="cpu",
                     enable_progress_bar=True).fit(spec, dm)
    assert [r["epoch"] for r in result.history] == [0, 1]
    assert "epoch 1: non-finite training loss (nan); halting (diverged)" in \
        capsys.readouterr().out
    assert load_checkpoint(tmp_path / "nan", "last")[3]["epoch"] == 0
    faults.install_plan(FaultPlan(faults=(FaultSpec(
        point="trainer.epoch_dispatched", kind="raise", match={"epoch": 1}),)))
    with pytest.raises(FaultInjected, match="trainer.epoch_dispatched"):
        Trainer(max_epochs=3, ckpt_dir=tmp_path / "raise", device="cpu",
                epoch_mode="stream").fit(spec, dm)
    assert load_checkpoint(tmp_path / "raise", "last")[3]["epoch"] == 0
