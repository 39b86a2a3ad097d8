"""The port's Fama-French loader and real-data bootstrap against the JAX
package's: the same arrays bit for bit on fixture CSVs in the Ken French
layout (preamble lines, a header, sentinel rows), and the same windows."""

import numpy as np
import pytest

from masters_thesis_tpu.data import FamaFrench25Portfolios as JaxFF
from masters_thesis_tpu.data.pipeline import (
    FinancialWindowDataModule as JaxDataModule,
    bootstrap_real as jax_bootstrap_real,
)
from masters_thesis_tpu_torch.cli import train as cli_train
from masters_thesis_tpu_torch.data.fama_french import FamaFrench25Portfolios as FF
from masters_thesis_tpu_torch.data.pipeline import (
    FinancialWindowDataModule,
    bootstrap_real,
)


def _write_fixtures(tmp_path, n_rows, sentinel_rows=()):
    """A copy of ``tests/test_data_fama_french.py``'s writer: row i has
    Mkt-RF = 0.01*i, RF = 0.001*i, portfolio j value = 0.01*i + 0.1*j;
    sentinel rows carry -99.99 in every portfolio column with a NONZERO
    RF."""
    ff3_lines = ["preamble"] * FF.ff3_skip
    ff3_lines.append(",".join(FF.ff3_cols))
    p25_lines = ["preamble"] * FF.p25_skip
    p25_lines.append(",".join(f'"{c}"' for c in FF.p25_cols))
    for i in range(n_rows):
        date = 19260700 + i
        ff3_lines.append(f"{date},{0.01 * i:.4f},0.0,0.0,{0.001 * i:.4f}")
        if i in sentinel_rows:
            vals = ["-99.99"] * 25
        else:
            vals = [f"{0.01 * i + 0.1 * j:.4f}" for j in range(25)]
        p25_lines.append(f"{date}," + ",".join(vals))
    (tmp_path / FF.ff3_filename).write_text("\n".join(ff3_lines) + "\n")
    (tmp_path / FF.p25_filename).write_text("\n".join(p25_lines) + "\n")


def _write_ken_french(tmp_path, n_rows, seed=0, sentinel_rows=()):
    """Seeded returns in the data library's own layout: a blank line closing
    each preamble, space-padded values and, at the published row count, a
    copyright footer and a second section after the first, which the
    loader's row count leaves out (short of it, both loaders would read
    them as rows)."""
    rng = np.random.default_rng(seed)
    factors = rng.normal(0.03, 1.0, (n_rows, 3))
    rf = rng.uniform(0.0, 0.02, n_rows)
    p25 = factors[:, :1] + rng.normal(0.0, 0.8, (n_rows, 25))
    ff3 = ["This file was created by CMPT_ME_BEME_RETS_DAILY",
           "The Tbill return is the simple daily rate",
           "in the month, compounds to 1-month TBill rate", "",
           ",Mkt-RF,SMB,HML,RF"]
    ff3 += [f"{19260701 + i},{factors[i, 0]:8.2f},{factors[i, 1]:8.2f},"
            f"{factors[i, 2]:8.2f},{rf[i]:9.3f}" for i in range(n_rows)]
    full = n_rows >= FF.n_samples
    ff3 += ["", "Copyright 2024 Kenneth R. French"] if full else []
    lines = ["This file was created by CMPT_ME_BEME_RETS_DAILY"] * (FF.p25_skip - 2)
    lines += ["  Average Value Weighted Returns -- Daily", "",
              "," + ",".join(FF.p25_cols[1:])]
    for i in range(n_rows):
        vals = (["  -99.99"] * 25 if i in sentinel_rows
                else [f"{v:8.2f}" for v in p25[i]])
        lines.append(f"{19260701 + i}," + ",".join(vals))
    lines += ["", "  Average Equal Weighted Returns -- Daily",
              "," + ",".join(FF.p25_cols[1:]),
              "19260701," + ",".join(["    0.10"] * 25)] if full else []
    (tmp_path / FF.ff3_filename).write_text("\n".join(ff3) + "\n")
    (tmp_path / FF.p25_filename).write_text("\n".join(lines) + "\n")


def _assert_bitwise(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32))


I0 = FF.skip_old_data


@pytest.mark.parametrize("sentinels", [(), (I0 + 5, I0 + 17), (I0 + 3,)],
                         ids=["clean", "sentinels", "nonzero_rf_sentinel_day"])
def test_loader_is_bitwise_the_jax_loader(tmp_path, sentinels):
    _write_fixtures(tmp_path, I0 + 300, sentinel_rows=set(sentinels))
    got = FF.load(tmp_path)
    _assert_bitwise(got, JaxFF.load(tmp_path))
    assert got[1].shape == (300 - len(sentinels),)
    assert np.isfinite(got[0]).all() and np.isfinite(got[1]).all()


def test_loader_reads_the_data_library_layout_at_full_size(tmp_path):
    """The published row count (26,129, the last 23,004 kept) with blank
    lines, padding, a footer and a second section: the JAX loader's
    arrays bit for bit, the sentinel day dropped."""
    _write_ken_french(tmp_path, FF.n_samples, sentinel_rows={9000})
    got = FF.load(tmp_path)
    _assert_bitwise(got, JaxFF.load(tmp_path))
    assert got[0].shape == (25, FF.n_samples - FF.skip_old_data - 1)


def test_bootstrap_real_and_windows_match_the_jax_packages(tmp_path):
    """The arrays bit for bit; the windows' x and return channels bit for
    bit. The label channels (the target-window OLS alpha and beta, which
    the real source has in place of a DGP's truth), the factor stats and
    the inverse idiosyncratic variances come from other reductions (torch
    against XLA) and are held at 1e-5 relative, as ``test_torch_data.py``
    holds the synthetic set's, or 1e-5 of the largest entry (an alpha
    label near zero has no relative digits to spare)."""
    raw = tmp_path / "raw"
    raw.mkdir()
    _write_ken_french(raw, I0 + 400, seed=3, sentinel_rows={I0 + 50})
    assert bootstrap_real(raw, tmp_path / "port")
    assert jax_bootstrap_real(raw, tmp_path / "jax")
    for name in ("stocks.npy", "market.npy"):
        _assert_bitwise([np.load(tmp_path / "port" / name)],
                        [np.load(tmp_path / "jax" / name)])
    windows = dict(lookback_window=60, target_window=30, stride=5,
                   batch_size=1)
    dm = FinancialWindowDataModule(tmp_path / "port", **windows)
    jdm = JaxDataModule(tmp_path / "jax", engine="python", **windows)
    for module in (dm, jdm):
        module.prepare_data()
        module.setup()
    assert dm.n_stocks == 25
    assert (dm.train_range, dm.val_range, dm.test_range) == (
        jdm.train_range, jdm.val_range, jdm.test_range)
    for split in ("train", "val", "test"):
        got = getattr(dm, f"{split}_arrays")()
        want = getattr(jdm, f"{split}_arrays")()
        _assert_bitwise([got.x, got.y[..., :2]],
                        [np.asarray(want.x), np.asarray(want.y)[..., :2]])
        for g, w in ((got.y[..., 2:], want.y[..., 2:]),
                     (got.factor, want.factor), (got.inv_psi, want.inv_psi)):
            w = np.asarray(w)
            np.testing.assert_allclose(g, w, rtol=1e-5,
                                       atol=1e-5 * np.abs(w).max())


def test_missing_csv_trains_nothing(tmp_path, capsys):
    raw = tmp_path / "raw"
    raw.mkdir()
    assert not bootstrap_real(raw, tmp_path / "data")
    _write_fixtures(raw, I0 + 100)
    (raw / FF.p25_filename).unlink()
    assert not bootstrap_real(raw, tmp_path / "data")
    assert not jax_bootstrap_real(raw, tmp_path / "jax")
    assert not (tmp_path / "data").exists()
    best = cli_train.run(cli_train.compose_config([
        "datamodule=real", f"datamodule.raw_dir={raw}",
        f"datamodule.data_dir={tmp_path / 'data'}",
        f"logger.save_dir={tmp_path / 'logs'}"]), device="cpu")
    assert best == float("inf")
    assert capsys.readouterr().err.splitlines()[-1] == (
        f"Real data CSVs not found under {raw}; download the Fama-French "
        "daily factors + 25 portfolios files first.")
    assert not (tmp_path / "logs").exists() and not (tmp_path / "data").exists()
