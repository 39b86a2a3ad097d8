"""The port's drivers end to end on the CPU at toy shape: ``python -m
masters_thesis_tpu_torch train`` then ``test``, checkpoint modes, the sweep
layout, the refused config keys, resume and the divergence halt.

Toy shape: 4 stocks x 1,200 samples of the synthetic DGP, lookback 10,
target 5, stride 15 (56 train windows), H=8, 2 layers, dropout 0.2. The
resumed run is held bit for bit against the unbroken one: the same weights,
the same optimizer state, the same per-epoch draws.
"""

import dataclasses
import json
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from masters_thesis_tpu_torch.__main__ import main as entry_main
from masters_thesis_tpu_torch.cli import train as cli_train
from masters_thesis_tpu_torch.cli import test as cli_test
from masters_thesis_tpu_torch.cli.train import main as train_main
from masters_thesis_tpu_torch.train import trainer as trainer_mod
from masters_thesis_tpu_torch.train.checkpoint import (
    load_checkpoint,
    restore_checkpoint,
)
from masters_thesis_tpu_torch.train.logging import read_records

REPO = Path(__file__).resolve().parent.parent
RUN_DIR = ("FinancialLstm", "synthetic")
TOY = [
    "datamodule.n_stocks=4",
    "datamodule.n_samples=1200",
    "datamodule.lookback_window=10",
    "datamodule.target_window=5",
    "datamodule.stride=15",
    "model.hidden_size=8",
    "trainer.enable_progress_bar=false",
]
N_TRAIN = 56  # train windows of the toy shape (70% of 81)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("data") / "toy"


def _args(data_dir, save_dir, *extra):
    return ["--device", "cpu", *TOY, f"datamodule.data_dir={data_dir}",
            f"logger.save_dir={save_dir}", *extra]


def _log_dir(save_dir, version):
    return Path(save_dir, *RUN_DIR, version)


def _epoch_rows(log_dir) -> list[dict]:
    return [r for r in read_records(log_dir) if "lr-Adam" in r]


def test_train_then_test_through_the_entry_point(data_dir, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    train = subprocess.run(
        [sys.executable, "-m", "masters_thesis_tpu_torch", "train",
         *_args(data_dir, tmp_path, "trainer.max_epochs=2",
                "trainer.enable_progress_bar=true", "logger.version=run")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert train.returncode == 0, train.stderr
    lines = train.stdout.splitlines()
    assert not [ln for ln in lines if ln.startswith("note:")]
    assert len([ln for ln in lines if ln.startswith("epoch ")]) == 2
    done = re.fullmatch(r"done: best_val=(\S+) test_mae=(\S+) test_nll=(\S+) "
                        r"steps/sec=(\S+)", lines[-1])
    assert done and all(math.isfinite(float(v)) for v in done.groups())
    log_dir = _log_dir(tmp_path, "run")
    # trainer.telemetry=auto: the run's events under <log_dir>/telemetry.
    assert lines[-2] == ("telemetry: python -m masters_thesis_tpu_torch."
                         f"telemetry summarize {log_dir / 'telemetry'}")
    assert (log_dir / "telemetry" / "events.jsonl").is_file()
    ckpts = log_dir / "checkpoints"
    # Both epochs improve the val loss, so each tag was saved twice or more
    # and its previous save rotated to .prev.
    tags = ("best", "best.prev", "last", "last.prev")
    assert {p.name for p in ckpts.iterdir()} == {
        *tags, *(f"{tag}.json" for tag in tags)}
    for tag in tags:
        assert {p.name for p in (ckpts / tag).iterdir()} == {
            "state.pt", "MANIFEST.json", "quality.json"}
    rows = _epoch_rows(log_dir)
    assert [r["step"] for r in rows] == [0, 1]
    assert float(done.group(1)) == pytest.approx(
        min(r["loss/total/val"] for r in rows), rel=1e-5)

    test = subprocess.run(
        [sys.executable, "-m", "masters_thesis_tpu_torch", "test",
         *_args(data_dir, tmp_path, f"checkpoint={log_dir / 'checkpoints'}")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert test.returncode == 0, test.stderr
    table = [ln for ln in test.stdout.splitlines() if "dL_MSE" in ln]
    assert [ln.split(":")[0].strip() for ln in table] == ["model", "ols"]
    for line in table:
        values = re.search(r"dL_MSE\(x1e-5\)=\s*(\S+)\s+dL_NLL=\s*(\S+)\s+"
                           r"dL_MIX\(zeta=1e5\)=\s*(\S+)$", line).groups()
        assert all(math.isfinite(float(v)) for v in values)
    results = json.loads((log_dir / "results.json").read_text())
    assert set(results["test"]) == {"mse", "nll", "mae", "total"}
    numbers = [v for key in ("model", "ols")
               for v in results["delta_losses"][key].values()]
    numbers += list(results["test"].values())
    assert all(math.isfinite(v) for v in numbers)
    with np.load(log_dir / "results.npz") as arrays:
        assert arrays["alpha/model"].shape == (len(arrays["alpha/true"]), 4)
        assert {"recon_residuals/model", "beta/ols", "beta_residuals/model"} \
            <= set(arrays.files)


def test_test_driver_takes_a_tag_path_and_refuses_orbax(data_dir, tmp_path,
                                                         capsys):
    train_main(_args(data_dir, tmp_path, "trainer.max_epochs=1",
                     "logger.version=run"))
    ckpt = _log_dir(tmp_path, "run") / "checkpoints"
    capsys.readouterr()
    assert cli_test.main(_args(data_dir, tmp_path, f"checkpoint={ckpt / 'best'}")) == 0
    root_table = capsys.readouterr().out
    assert cli_test.main(_args(data_dir, tmp_path, f"checkpoint={ckpt}")) == 0
    assert capsys.readouterr().out == root_table
    # The JAX package's layout: <root>/best/ an orbax tree, best.json beside.
    orbax = tmp_path / "orbax" / "checkpoints"
    (orbax / "best").mkdir(parents=True)
    (orbax / "best.json").write_text("{}")
    for path in (orbax, orbax / "best"):
        with pytest.raises(ValueError, match="orbax checkpoint of the JAX package"):
            cli_test.main(_args(data_dir, tmp_path, f"checkpoint={path}"))
    assert cli_test.main(["--device", "cpu"]) == 1  # no checkpoint= given


def test_entry_points_need_cuda_unless_told_cpu(monkeypatch, data_dir, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = _args(data_dir, tmp_path)[2:]  # without --device cpu
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_main(args)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_test.main(args + [f"checkpoint={tmp_path}"])
    assert not (tmp_path / RUN_DIR[0]).exists()
    assert entry_main([]) == 2 and entry_main(["serve"]) == 2


def _run(data_dir, save_dir, version, *extra):
    train_main(_args(data_dir, save_dir, f"logger.version={version}", *extra))
    return _log_dir(save_dir, version)


@pytest.mark.parametrize("mode", ["full", "params"])
def test_checkpoint_modes(data_dir, tmp_path, mode):
    first = _run(data_dir, tmp_path, "first", "trainer.max_epochs=2")
    _, first_opt, _, _ = load_checkpoint(first / "checkpoints", "last")
    assert first_opt["count"] == 2 * N_TRAIN
    second = _run(data_dir, tmp_path, "second", "trainer.max_epochs=1",
                  "loss=nll", f"checkpoint={first / 'checkpoints' / 'last'}",
                  f"checkpoint_mode={mode}")
    state, opt_state, spec, meta = restore_checkpoint(second / "checkpoints", "last")
    if mode == "full":
        # The FlatAdam state goes on from the checkpoint's; its spec wins.
        assert opt_state["count"] == 3 * N_TRAIN and spec.objective == "mse"
    else:
        # A fresh optimizer; the config decides the objective.
        assert opt_state["count"] == N_TRAIN and spec.objective == "nll"
    assert meta["epoch"] == 0 and meta["scheduler"]["lr"] == spec.learning_rate


def test_warm_start_needs_a_matching_architecture(data_dir, tmp_path):
    first = _run(data_dir, tmp_path, "first", "trainer.max_epochs=1")
    with pytest.raises(ValueError) as info:
        _run(data_dir, tmp_path, "second", "model.hidden_size=16",
             f"checkpoint={first / 'checkpoints'}", "checkpoint_mode=params")
    assert str(info.value) == (
        "checkpoint_mode=params needs a matching architecture: checkpoint is "
        "hidden=8/layers=2, config asks hidden=16/layers=2")
    with pytest.raises(ValueError, match="checkpoint_mode must be"):
        _run(data_dir, tmp_path, "third", f"checkpoint={first / 'checkpoints'}",
             "checkpoint_mode=weights")


def test_multirun_writes_numbered_job_dirs(data_dir, tmp_path):
    sweep = tmp_path / "sweep"
    train_main(["-m", "--device", "cpu", *TOY, f"datamodule.data_dir={data_dir}",
                "trainer.max_epochs=1", "model.learning_rate=1e-3,1e-4",
                f"launcher.sweep_dir={sweep}"])
    assert sorted(p.name for p in sweep.iterdir()) == ["0", "1"]
    for index, lr in ((0, 0.001), (1, 0.0001)):
        job = sweep / str(index)
        cfg = yaml.safe_load((job / ".hydra" / "config.yaml").read_text())
        overrides = yaml.safe_load((job / ".hydra" / "overrides.yaml").read_text())
        assert cfg["model"]["learning_rate"] == lr
        assert overrides[-3:] == ["trainer.max_epochs=1",
                                  f"model.learning_rate={['1e-3', '1e-4'][index]}",
                                  f"launcher.sweep_dir={sweep}"]
        version = f"mse_small_lr{lr}_fast"
        assert cfg["logger"] == {"save_dir": str(job / "logs"),
                                 "name": "FinancialLstm/synthetic",
                                 "version": version}
        assert (_log_dir(job / "logs", version) / "checkpoints" / "best"
                / "state.pt").is_file()


REFUSED = [
    ("trainer.precision", ["trainer.precision=16-mixed"]),
    ("trainer.n_devices", ["+trainer.n_devices=0"]),
    ("trainer.strategy", ["trainer.strategy=ddp"]),
    ("trainer.distributed", ["trainer.distributed=sometimes"]),
    ("trainer.epoch_mode", ["trainer.epoch_mode=pipelined"]),
    ("trainer.shard_axis", ["trainer.shard_axis=stock"]),
    ("datamodule.n_factors", ["datamodule.n_factors=3"]),
    ("datamodule.engine", ["datamodule.engine=native", "model=kfactor",
                           "datamodule.n_factors=3"]),
    ("datamodule", ["datamodule=real", "~datamodule.raw_dir"]),
    ("model.kernel_impl", ["model.kernel_impl=pallas"]),
    ("model.n_factors", ["model=kfactor", "model.n_factors=2"]),
    ("launcher", ["-m", "launcher.name=ray"]),
    ("launcher.n_jobs", ["-m", "launcher.n_jobs=0"]),
    ("launcher.num_hosts", ["-m", "launcher.num_hosts=0"]),
]


@pytest.mark.parametrize("key,overrides", REFUSED, ids=[k for k, _ in REFUSED])
def test_refused_keys_raise_and_name_themselves(data_dir, tmp_path, key,
                                                overrides):
    with pytest.raises(ValueError, match=rf"^{re.escape(key)}=\S+: .*cannot "
                                         "honour it"):
        if "datamodule=real" in overrides:  # the toy keys are synthetic's
            train_main(["--device", "cpu", *overrides,
                        f"logger.save_dir={tmp_path}"])
        else:
            train_main(_args(data_dir, tmp_path, *overrides))
    assert not (tmp_path / RUN_DIR[0]).exists()


#: The toy keys put back at full width (H=64, T=60, 100 stocks), where
#: the grouping rule leaves a layer alone.
FULL_WIDTH = ["model.hidden_size=64", "datamodule.lookback_window=60",
              "datamodule.n_stocks=100"]


@pytest.mark.parametrize("overrides,groups", [
    (["model.num_layers=5", *FULL_WIDTH], "[4, 1]"),
    ([*FULL_WIDTH, "datamodule.lookback_window=252"], "[1, 1]"),
    (["datamodule=universe", "model=kfactor", "model.hidden_size=64",
      "datamodule.lookback_window=32", "datamodule.n_stocks=2048"], "[1, 1]"),
])
def test_bf16_is_refused_where_the_layers_group_past_the_pair(
        data_dir, tmp_path, overrides, groups):
    """bf16 runs the pair's and the L-deep stack's kernels only: a shape
    that groups a single layer at itemsize 2 is refused by key, naming the
    grouping, before any data is touched."""
    with pytest.raises(ValueError, match=rf"^trainer\.precision=bf16-mixed: "
                                         rf".*group as {re.escape(groups)}.*"
                                         "cannot honour it"):
        train_main(_args(data_dir, tmp_path, *overrides,
                         "trainer.precision=bf16-mixed"))
    assert not (tmp_path / RUN_DIR[0]).exists()


@pytest.mark.parametrize("key,value", [
    ("telemetry", "auto"), ("cost_profile", "true"), ("profile", "true"),
    ("profile_steps", "[1, 2]"), ("hang_timeout_s", "60"), ("preflight", "true"),
])
def test_observation_keys_are_named_and_ignored(capsys, data_dir, tmp_path,
                                                monkeypatch, key, value):
    """Every observation key, ``preflight`` included, reaches the trainer
    and leaves its trace in the run directory; none is reported as
    ignored."""
    seen = {}
    real_init = trainer_mod.Trainer.__init__

    def spy(self, *args, **kwargs):
        seen.update(kwargs)
        real_init(self, *args, **kwargs)

    monkeypatch.setattr(trainer_mod.Trainer, "__init__", spy)
    train_main(_args(data_dir, tmp_path, "trainer.max_epochs=2",
                     f"+trainer.{key}={value}" if key not in ("telemetry",)
                     else f"trainer.{key}={value}"))
    assert "note:" not in capsys.readouterr().out
    run = _log_dir(tmp_path, "mse_small_lr0.0001_fast") / "telemetry"
    events = [json.loads(ln) for ln in (run / "events.jsonl").open()]
    kinds = [e["kind"] for e in events]
    if key == "telemetry":
        assert seen["telemetry"].run_dir == run
        assert kinds[0] == "run_started" and "run_finished" in kinds
    elif key == "cost_profile":
        assert seen["cost_profile"] is True
        cost = next(e for e in events if e["kind"] == "cost_profile")
        assert cost["source"] == "analytic" and cost["flops_per_step"] > 0
    elif key == "profile":
        assert seen["profile"] is True
        assert [p.name for p in (run / "profile").iterdir()] == [
            "trace_epochs_1_1.json"]
        assert kinds.count("profile_window") == 1
    elif key == "profile_steps":
        assert seen["profile_steps"] == (1, 2)
        # Two epochs: the window closes with the run.
        assert [p.name for p in (run / "profile").iterdir()] == [
            "trace_epochs_1_2.json"]
    elif key == "preflight":
        # The trace audit ran before the first epoch and passed.
        assert seen["preflight"] is True
        assert kinds.index("preflight") < kinds.index("epoch")
        assert next(e for e in events
                    if e["kind"] == "preflight")["status"] == "ok"
    else:
        assert seen["hang_timeout_s"] == 60
        heartbeat = json.loads((run / "heartbeat.json").read_text())
        assert heartbeat["hang_timeout_s"] == 60 and heartbeat["closed"]


def test_resume_is_bit_equal_to_an_unbroken_run(data_dir, tmp_path):
    whole = _run(data_dir, tmp_path, "whole", "trainer.max_epochs=3")
    split = _run(data_dir, tmp_path, "split", "trainer.max_epochs=2")
    _run(data_dir, tmp_path, "split", "trainer.max_epochs=3", "trainer.resume=true")
    assert [r["step"] for r in _epoch_rows(split)] == [0, 1, 2]
    assert _epoch_rows(split) == _epoch_rows(whole)
    for tag in ("best", "last"):
        got = load_checkpoint(split / "checkpoints", tag)
        want = load_checkpoint(whole / "checkpoints", tag)
        for name, value in want[0].items():
            assert torch.equal(got[0][name], value), (tag, name)
        assert got[1]["count"] == want[1]["count"] == 3 * N_TRAIN
        assert torch.equal(got[1]["mu"], want[1]["mu"])
        assert torch.equal(got[1]["nu"], want[1]["nu"])
        assert got[2:] == want[2:]


def test_checkpoint_every_n_epochs_refreshes_last(data_dir, tmp_path, monkeypatch):
    saves = []
    real_save = trainer_mod.ckpt_lib.save_checkpoint

    def spy(ckpt_dir, tag, *args, meta, **kwargs):
        saves.append((tag, meta["epoch"]))
        return real_save(ckpt_dir, tag, *args, meta=meta, **kwargs)

    monkeypatch.setattr(trainer_mod.ckpt_lib, "save_checkpoint", spy)
    common = ("trainer.max_epochs=3", "trainer.check_val_every_n_epoch=2")
    _run(data_dir, tmp_path, "every", *common,
         "resilience.checkpoint_every_n_epochs=1")
    assert saves == [("last", 0), ("best", 1), ("last", 1), ("last", 2),
                     ("last", 2)]
    saves.clear()
    _run(data_dir, tmp_path, "default", *common)
    assert saves == [("best", 1), ("last", 1), ("last", 2)]


def test_nan_halts_the_run_and_last_stays_finite(data_dir, tmp_path,
                                                 monkeypatch, capsys):
    real_epoch = trainer_mod.train_epoch
    calls = []

    def poisoned(module, optimizer, *args, **kwargs):
        sums, n_steps = real_epoch(module, optimizer, *args, **kwargs)
        calls.append(1)
        if len(calls) == 2:  # epoch 1 blows up
            optimizer.params.fill_(float("nan"))
            sums = {k: (v * float("nan"), w) for k, (v, w) in sums.items()}
        return sums, n_steps

    monkeypatch.setattr(trainer_mod, "train_epoch", poisoned)
    run = _run(data_dir, tmp_path, "halt", "trainer.max_epochs=4",
               "trainer.enable_progress_bar=true")
    assert len(calls) == 2
    out = capsys.readouterr().out
    assert "epoch 1: non-finite training loss (nan); halting (diverged)" in out
    rows = _epoch_rows(run)
    assert [r["step"] for r in rows] == [0, 1]
    assert math.isnan(rows[1]["loss/total/train"]) and "loss/total/val" not in rows[1]
    for tag in ("best", "last"):
        state, _, _, meta = load_checkpoint(run / "checkpoints", tag)
        assert meta["epoch"] == 0
        assert all(torch.isfinite(v).all() for v in state.values())


def _write_ken_french_csvs(raw_dir: Path, n_rows: int, seed: int = 0) -> None:
    """Seeded daily returns in the Ken French data-library layout (the two
    CSVs ``datamodule=real`` reads): a 4-line and an 18-line preamble, each
    closed by a blank line, then the header and ``n_rows`` rows."""
    from masters_thesis_tpu_torch.data.fama_french import FamaFrench25Portfolios as FF

    rng = np.random.default_rng(seed)
    market = rng.normal(0.03, 1.0, n_rows)
    ff3 = ["created by CMPT_ME_BEME_RETS_DAILY"] * (FF.ff3_skip - 1) + [""]
    ff3.append("," + ",".join(FF.ff3_cols[1:]))
    p25 = ["created by CMPT_ME_BEME_RETS_DAILY"] * (FF.p25_skip - 1) + [""]
    p25.append("," + ",".join(FF.p25_cols[1:]))
    for i in range(n_rows):
        date = 19260701 + i
        ff3.append(f"{date},{market[i]:8.2f},{0.0:8.2f},{0.0:8.2f},{0.01:8.3f}")
        values = 1.1 * market[i] + rng.normal(0.0, 0.8, 25)
        p25.append(f"{date}," + ",".join(f"{v:8.2f}" for v in values))
    raw_dir.mkdir(parents=True, exist_ok=True)
    (raw_dir / FF.ff3_filename).write_text("\n".join(ff3) + "\n")
    (raw_dir / FF.p25_filename).write_text("\n".join(p25) + "\n")


def test_real_data_stream_epoch_then_test(tmp_path, capsys):
    """``train datamodule=real trainer.epoch_mode=stream`` on CSVs in the
    Ken French layout (3,125 old rows skipped, 400 kept: 63 windows, 44 to
    train), then ``test`` on its checkpoint root, its ``best`` tree and a
    pre-manifest copy of ``best`` as a ``.pt`` file."""
    from masters_thesis_tpu_torch.data.fama_french import FamaFrench25Portfolios as FF

    raw = tmp_path / "raw"
    _write_ken_french_csvs(raw, FF.skip_old_data + 400)
    common = ["--device", "cpu", "datamodule=real",
              f"datamodule.raw_dir={raw}",
              f"datamodule.data_dir={tmp_path / 'real'}",
              f"logger.save_dir={tmp_path}", "model.hidden_size=8",
              "trainer.enable_progress_bar=true"]
    train_main([*common, "trainer.epoch_mode=stream", "trainer.max_epochs=2"])
    out = capsys.readouterr().out.splitlines()
    done = re.fullmatch(r"done: best_val=(\S+) test_mae=(\S+) test_nll=(\S+) "
                        r"steps/sec=(\S+)", out[-1])
    assert done and all(math.isfinite(float(v)) for v in done.groups())
    assert len([ln for ln in out if ln.startswith("epoch ")]) == 2
    assert np.load(tmp_path / "real" / "stocks.npy").shape == (25, 400)
    log_dir = Path(tmp_path, "FinancialLstm", "real", "mse_small_lr0.0001_fast")
    rows = _epoch_rows(log_dir)
    assert [r["step"] for r in rows] == [0, 1]
    assert all(r["data/prefetch_mean_depth"] > 0 and r["data/get_wait_s"] > 0
               for r in rows)
    ckpts = log_dir / "checkpoints"
    state, opt_state, spec, meta = restore_checkpoint(ckpts, "last")
    assert opt_state["count"] == 2 * 44  # batch_size 1: no tail to pad
    assert meta["datamodule"] == {
        "lookback_window": 60, "target_window": 30, "stride": 5,
        "prediction_task": True, "interaction_only": True, "batch_size": 1}

    legacy = tmp_path / "legacy"
    legacy.mkdir()
    best, best_opt, best_spec, best_meta = restore_checkpoint(ckpts, "best")
    torch.save({"state_dict": best, "opt_state": best_opt,
                "spec": dataclasses.asdict(best_spec),
                "scheduler": best_meta.pop("scheduler"), "meta": best_meta},
               legacy / "best.pt")
    tables = []
    for checkpoint in (ckpts, ckpts / "best", legacy / "best.pt"):
        assert cli_test.main(["--device", "cpu", "datamodule=real",
                              f"datamodule.raw_dir={raw}",
                              f"datamodule.data_dir={tmp_path / 'real'}",
                              f"logger.save_dir={tmp_path}",
                              f"checkpoint={checkpoint}"]) == 0
        table = [ln for ln in capsys.readouterr().out.splitlines()
                 if "dL_MSE" in ln]
        assert [ln.split(":")[0].strip() for ln in table] == ["model", "ols"]
        tables.append(table)
    assert tables[0] == tables[1] == tables[2]
    results = json.loads((log_dir / "results.json").read_text())
    assert all(math.isfinite(v) for key in ("model", "ols")
               for v in results["delta_losses"][key].values())


@pytest.mark.parametrize("overrides", [
    ["trainer.epoch_mode=stream"],
    ["datamodule=real"],
], ids=["trainer.epoch_mode=stream", "datamodule=real"])
def test_lifted_keys_are_accepted(overrides):
    cli_train.check_supported(cli_train.compose_config(overrides))
