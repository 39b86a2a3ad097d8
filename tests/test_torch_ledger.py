"""The port's perf ledger (``telemetry/ledger.py``, ``telemetry ledger``)
against the JAX package's: each case of the JAX ``TestLedger`` on the same
rows through both packages, reports equal dict for dict, the text report
line for line, the CLI's exit codes and output the same; the repo's JAX
ledger diffed by both; the CLI with torch, numpy and JAX blocked."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from masters_thesis_tpu.telemetry import ledger as jax_led
from masters_thesis_tpu.telemetry.__main__ import main as jax_main
from masters_thesis_tpu_torch import telemetry
from masters_thesis_tpu_torch.telemetry import ledger as led
from masters_thesis_tpu_torch.telemetry.__main__ import main

REPO = Path(__file__).resolve().parent.parent
JAX_LEDGER = REPO / "results" / "perf_ledger.jsonl"


def _row(module, round_id, sps, util, ts, **over):
    """The JAX test's row (``tests/test_costs.py::_row``) from ``module``."""
    base = dict(
        point="mse/bs=1", round_id=round_id, platform="cpu",
        steps_per_sec=sps, objective="mse", batch_size=1,
        mesh_shape=[8], pack_width=1, flops_per_step=1.6e5,
        bytes_per_step=7.2e5, peak_memory_bytes=3_000_000,
        utilization_pct=util, regime="memory-bound", rev="deadbee", ts=ts,
    )
    base.update(over)
    return module.ledger_record(**base)


def _write(path: Path, *rows: tuple) -> None:
    """Append each ``(round, sps, util, ts, over)`` row through both
    packages, the port's to ``path`` and the JAX one's beside it; the two
    records and the two files must be the same."""
    twin = path.with_name(path.stem + "_jax.jsonl")
    for round_id, sps, util, ts, over in rows:
        got = _row(led, round_id, sps, util, ts, **over)
        want = _row(jax_led, round_id, sps, util, ts, **over)
        assert got == want
        led.append_record(path, got)
        jax_led.append_record(twin, want)
    assert path.read_bytes() == twin.read_bytes()


def _same_report(path: Path, **kw) -> dict:
    got = led.diff_path(path, **kw)
    want = jax_led.diff_path(path, **kw)
    assert got == want
    assert (led.render_ledger_text(got).splitlines()
            == jax_led.render_ledger_text(want).splitlines())
    return got


def _as_json(report: dict) -> dict:
    return json.loads(json.dumps(report, default=str))


def _same_cli(capsys, *argv) -> tuple[int, str]:
    """Both command lines on ``argv``: the same exit code, stdout and
    stderr."""
    rc = main(["ledger", *argv])
    out = capsys.readouterr()
    jax_rc = jax_main(["ledger", *argv])
    jax_out = capsys.readouterr()
    assert (rc, out.out.splitlines(), out.err) == (
        jax_rc, jax_out.out.splitlines(), jax_out.err)
    return rc, out.out


STEADY = (("r1", 100.0, 4.0, 1.0, {}), ("r2", 98.0, 3.9, 2.0, {}))


def test_the_names_are_the_jax_ledgers():
    assert led.LEDGER_SCHEMA_VERSION == jax_led.LEDGER_SCHEMA_VERSION == 1
    assert led.REGRESSION_PCT == jax_led.REGRESSION_PCT == 15.0
    assert led.GATED_METRICS == jax_led.GATED_METRICS
    assert led.CONFIG_KEYS == jax_led.CONFIG_KEYS
    # The port's own file, never the JAX package's.
    assert led.DEFAULT_LEDGER_PATH == Path("results") / "perf_ledger_torch.jsonl"
    assert led.DEFAULT_LEDGER_PATH != jax_led.DEFAULT_LEDGER_PATH
    for name in ("append_record", "ledger_diff", "ledger_record",
                 "read_ledger", "knee_from_ledger"):
        assert name in telemetry.__all__ and callable(getattr(telemetry, name))
    assert telemetry.read_ledger is led.read_ledger
    # ledger_record without a rev asks git, as the JAX one does.
    assert (led.ledger_record(point="p", round_id="r", platform=None,
                              steps_per_sec=None, ts=0.0)["git_rev"]
            == jax_led.git_rev())


def test_append_read_round_trip(tmp_path):
    path = tmp_path / "perf_ledger.jsonl"
    _write(path, ("r1", 100.0, 4.0, 1.0, {}), ("r2", 101.0, 4.1, 2.0, {}))
    rows = led.read_ledger(path)
    assert rows == jax_led.read_ledger(path)
    assert [r["round"] for r in rows] == ["r1", "r2"]
    assert rows[0]["schema"] == led.LEDGER_SCHEMA_VERSION
    assert rows[0]["steps_per_sec"] == 100.0
    # Torn tail (a killed writer) and a corrupt line: skipped, not fatal.
    with open(path, "a") as fh:
        fh.write("not json\n[1, 2]\n")
        fh.write('{"schema": 1, "point": "mse/bs=1", "trunc')
    assert led.read_ledger(path) == jax_led.read_ledger(path) == rows
    assert led.read_ledger(tmp_path / "nope.jsonl") == []


def test_equal_rounds_not_regressed(tmp_path, capsys):
    path = tmp_path / "perf_ledger.jsonl"
    _write(path, *STEADY)
    report = _same_report(path)
    assert not report["regressed"]
    assert report["compared"]
    assert _same_cli(capsys, str(path))[0] == 0


def test_doctored_slow_round_exits_2(tmp_path, capsys):
    path = tmp_path / "perf_ledger.jsonl"
    _write(path, *STEADY, ("r3", 60.0, 2.4, 3.0, {}))
    report = _same_report(path)
    assert report["regressed"]
    (reg,) = report["regressions"]
    assert set(reg["regressed_metrics"]) == {"steps_per_sec",
                                             "utilization_pct"}
    rc, out = _same_cli(capsys, str(path))
    assert rc == 2 and "REGRESSED" in out
    # A looser threshold lets the same round pass.
    assert _same_cli(capsys, str(path), "--threshold", "50")[0] == 0
    # Against only the last baseline round (98 steps/s): still regressed.
    report = _same_report(path, baseline_rounds=1)
    assert report["baseline_window"] == ["r2"]
    assert report["compared"][0]["steps_per_sec"]["baseline"] == 98.0
    assert _same_cli(capsys, str(path), "--baseline", "1")[0] == 2


def test_config_drift_is_not_a_regression(tmp_path, capsys):
    path = tmp_path / "perf_ledger.jsonl"
    # Same point, another batch size: a new config, never a regression.
    _write(path, ("r1", 100.0, 4.0, 1.0, {}),
           ("r2", 60.0, 2.4, 2.0, {"batch_size": 64}))
    report = _same_report(path)
    assert not report["regressed"]
    assert report["new_configs"] and not report["compared"]
    rc, out = _same_cli(capsys, str(path))
    assert rc == 0 and "new config" in out


def test_missing_ledger_is_rc_1(tmp_path, capsys):
    rc, _ = _same_cli(capsys, str(tmp_path / "nope.jsonl"))
    assert rc == 1


def test_empty_ledger_has_nothing_to_gate(tmp_path, capsys):
    path = tmp_path / "perf_ledger.jsonl"
    path.write_text("")
    assert _same_report(path)["rounds"] == 0
    rc, out = _same_cli(capsys, str(path))
    assert rc == 0 and "nothing to gate" in out


def test_json_report_is_the_jax_one(tmp_path, capsys):
    path = tmp_path / "perf_ledger.jsonl"
    _write(path, *STEADY, ("r3", 60.0, 2.4, 3.0, {}),
           ("r3", None, None, 3.0, {"point": "serve/knee_qps",
                                   "batch_size": None, "knee_qps": 40.0}))
    rc, out = _same_cli(capsys, str(path), "--json")
    assert rc == 2
    assert json.loads(out) == _as_json(jax_led.diff_path(path))


def test_the_repo_jax_ledger_diffs_the_same(capsys):
    """The JAX package's own ledger (read only) through both packages."""
    before = JAX_LEDGER.read_bytes()
    report = _same_report(JAX_LEDGER)
    assert report["rounds"] > 1 and report["compared"]
    for argv in ((), ("--baseline", "2"), ("--threshold", "5"), ("--json",)):
        _same_cli(capsys, str(JAX_LEDGER), *argv)
    assert JAX_LEDGER.read_bytes() == before


def test_selfcheck(capsys):
    assert main(["ledger", "--selfcheck"]) == 0
    assert "ledger selfcheck ok" in capsys.readouterr().out
    assert jax_main(["ledger", "--selfcheck"]) == 0


def test_ledger_cli_imports_no_torch_numpy_or_jax(tmp_path):
    path = tmp_path / "perf_ledger.jsonl"
    _write(path, ("r1", 100.0, 4.0, 1.0, {}), ("r2", 50.0, 2.0, 2.0, {}))
    poison = tmp_path / "poison"
    poison.mkdir()
    for name in ("jax", "torch", "numpy", "masters_thesis_tpu"):
        (poison / f"{name}.py").write_text(
            f"raise ImportError('the ledger CLI imported {name}')\n")
    env = {**os.environ, "PYTHONPATH": f"{poison}{os.pathsep}{REPO}"}

    def cli(*argv):
        # From tmp_path: the working directory comes first on sys.path.
        return subprocess.run(
            [sys.executable, "-m", "masters_thesis_tpu_torch.telemetry",
             "ledger", *argv], cwd=tmp_path, env=env, capture_output=True,
            text=True, timeout=60)

    out = cli(str(path))
    assert out.returncode == 2, out.stdout + out.stderr
    assert "REGRESSION" in out.stdout
    out = cli(str(path), "--json")
    assert out.returncode == 2, out.stderr
    assert json.loads(out.stdout) == _as_json(jax_led.diff_path(path))
    out = cli("--selfcheck")
    assert out.returncode == 0, out.stdout + out.stderr
    # The default path is the port's own, relative to the working directory.
    out = cli()
    assert out.returncode == 1
    assert "results/perf_ledger_torch.jsonl does not exist" in out.stderr
