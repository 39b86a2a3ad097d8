"""Fama-French 25-Portfolios daily dataset, read with numpy.

Counterpart of ``masters_thesis_tpu/data/fama_french.py``: reads the Ken
French data-library CSVs ("F-F_Research_Data_Factors_daily" and
"25_Portfolios_5x5_Daily"), skips the header preambles plus the first
``skip_old_data`` rows, subtracts the risk-free rate, drops the days that
carry the -99.99 / -999 missing-data sentinels, and converts percent
arithmetic returns to percent log returns ``100 * (log(R + 100) - log
100)``. The JAX loader reads with pandas, which the card's machine lacks;
this one parses the same rows itself and gives the same arrays bit for
bit:

- ``skiprows=skip + skip_old_data`` lines are dropped, and with
  ``header=0`` the next non-blank line is taken as the header, so the
  first row kept is data row ``skip_old_data`` and at most ``n_samples -
  skip_old_data`` rows follow (blank lines are skipped, as pandas does);
- each value is parsed as a double and rounded to f32, as pandas parses a
  ``float32`` column;
- the arithmetic is the JAX loader's, in numpy, on the same dtypes.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def _read_rows(path: Path, skip: int, nrows: int, ncols: int) -> np.ndarray:
    """The value columns (all but the first, the date) of the ``nrows``
    data rows after the preamble of ``skip`` lines and the line read as
    the header: ``(rows, ncols - 1)`` f32."""
    lines = Path(path).read_text().splitlines()[skip:]
    body = [line for line in lines if line.strip()][1:1 + nrows]
    values = np.empty((len(body), ncols - 1), np.float64)  # mtt: disable=TL104 -- host-side CSV parse; the arrays are cast to f32 before any tensor
    for i, line in enumerate(body):
        fields = line.split(",")
        if len(fields) != ncols:
            raise ValueError(f"{path}: expected {ncols} columns, got "
                             f"{len(fields)} in {line!r}")
        values[i] = [float(v) for v in fields[1:]]
    return values.astype(np.float32)


class FamaFrench25Portfolios:
    """Loader for 25 Portfolios Formed on Size and Book-to-Market [Daily]."""

    n_samples = 26129
    skip_old_data = 3125

    ff3_filename = "F-F_Research_Data_Factors_daily.csv"
    ff3_skip = 4
    ff3_cols = ["DATE", "Mkt-RF", "SMB", "HML", "RF"]

    p25_filename = "25_Portfolios_5x5_Daily.csv"
    p25_skip = 18
    p25_cols = ["DATE", "SMALL LoBM", "ME1 BM2", "ME1 BM3", "ME1 BM4", "SMALL HiBM",
                        "ME2 BM1", "ME2 BM2", "ME2 BM3", "ME2 BM4", "ME2 BM5",
                        "ME3 BM1", "ME3 BM2", "ME3 BM3", "ME3 BM4", "ME3 BM5",
                        "ME4 BM1", "ME4 BM2", "ME4 BM3", "ME4 BM4", "ME4 BM5",
                        "BIG LoBM", "ME5 BM2", "ME5 BM3", "ME5 BM4", "BIG HiBM"]

    @staticmethod
    def load(data_dir: Path) -> tuple[np.ndarray, np.ndarray]:
        """Load (portfolio log returns ``(25, T)``, market log returns
        ``(T,)``), f32."""
        cls = FamaFrench25Portfolios
        nrows = cls.n_samples - cls.skip_old_data
        ff3 = _read_rows(Path(data_dir) / cls.ff3_filename,
                         cls.ff3_skip + cls.skip_old_data, nrows,
                         len(cls.ff3_cols))
        p25_raw = _read_rows(Path(data_dir) / cls.p25_filename,
                             cls.p25_skip + cls.skip_old_data, nrows,
                             len(cls.p25_cols)).T
        mkt_excess = ff3[:, cls.ff3_cols.index("Mkt-RF") - 1]
        risk_free = ff3[:, cls.ff3_cols.index("RF") - 1]
        if p25_raw.shape[1] != mkt_excess.shape[0]:
            raise ValueError(f"{p25_raw.shape[1]} portfolio rows against "
                             f"{mkt_excess.shape[0]} factor rows")

        # Drop the days where any portfolio carries a missing-data sentinel,
        # matched on the raw values (the JAX loader's deviation from the
        # reference, which matched after subtracting RF and let a sentinel
        # on a nonzero-RF day through into the log as NaN).
        missing = ((p25_raw == -99.99) | (p25_raw == -999)).any(axis=0)
        p25_excess = (p25_raw - risk_free)[:, ~missing]
        mkt_excess = mkt_excess[~missing]

        # Percent arithmetic returns -> percent log returns.
        mkt = 100.0 * (np.log(mkt_excess + 100.0) - np.log(100.0))
        p25 = 100.0 * (np.log(p25_excess + 100.0) - np.log(100.0))
        return p25.astype(np.float32), mkt.astype(np.float32)
