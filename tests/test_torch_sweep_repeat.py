"""``python -m masters_thesis_tpu_torch.cli.sweep_repeat`` on the CPU at
toy shape (4 stocks x 1,200 samples, lookback 10, target 5, stride 15,
H=8): a sweep's job in a fresh process and twice more in one process after
a seed-0 fit, each run's history row and ``last`` weights bit for bit the
fresh run's."""

import json
import tempfile

from masters_thesis_tpu_torch.cli import sweep_repeat

TOY = [
    "datamodule.n_stocks=4",
    "datamodule.n_samples=1200",
    "datamodule.lookback_window=10",
    "datamodule.target_window=5",
    "datamodule.stride=15",
    "model.hidden_size=8",
]


def test_a_job_repeats_in_a_fresh_process_and_after_another_fit(
        tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "runs"))
    (tmp_path / "runs").mkdir()
    code = sweep_repeat.main(["--device", "cpu", "--fresh", "1",
                              "--in-process", "2", *TOY,
                              f"datamodule.data_dir={tmp_path / 'data'}"])
    line = next(ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith('{"sweep_repeat"'))
    report = json.loads(line)["sweep_repeat"]
    assert code == 0 and report["all_equal"], report
    assert [r["run"] for r in report["runs"]] == [
        "fresh0", "in_process0", "in_process1_nan"]
    assert all(r["rows_equal"] and r["weights_equal"]
               for r in report["runs"])
    assert report["kept"] is None
    assert not list((tmp_path / "runs").iterdir())
