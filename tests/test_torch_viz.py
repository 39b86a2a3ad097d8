"""The port's evaluation figures against the JAX package's ``viz/plots.py``.

Both draw the same seeded arrays; the figures must carry the same titles,
line and scatter data, histogram bins and legends, and the per-stock series
stop at nine stocks. Then the ``test`` driver's figure set: the JAX
``test.py``'s tags, as PNG files, drawn again from ``results.npz`` by the
``plots`` subcommand, and one line instead where matplotlib is missing.
"""

from __future__ import annotations

import numpy as np
import pytest

import masters_thesis_tpu.viz.plots as jax_plots
from masters_thesis_tpu_torch.__main__ import main as port_main
from masters_thesis_tpu_torch.cli import test as cli_test
from masters_thesis_tpu_torch.viz import plots


class _Figures:
    """A figure sink keeping each (tag, step, figure)."""

    def __init__(self):
        self.logged = []

    def log_figure(self, tag, figure, step=0):
        self.logged.append((tag, step, figure))


def _axes_data(fig) -> list:
    """What a figure shows: each axes' title, labels, lines, scatter
    offsets, bar heights and legend texts."""
    out = [fig._suptitle.get_text() if fig._suptitle else None]
    for ax in fig.axes:
        legend = ax.get_legend()
        out.append((
            ax.get_title(), ax.get_xlabel(), ax.get_ylabel(),
            [np.asarray(line.get_xydata()) for line in ax.lines],
            [np.asarray(c.get_offsets()) for c in ax.collections],
            [p.get_height() for p in ax.patches],
            [t.get_text() for t in legend.get_texts()] if legend else [],
        ))
    return out


def _assert_same_figure(got, want):
    for a, b in zip(_axes_data(got), _axes_data(want), strict=True):
        if a is None or isinstance(a, str):
            assert a == b
            continue
        assert a[:3] == b[:3]
        for x, y in zip(a[3] + a[4], b[3] + b[4], strict=True):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(a[5], b[5])
        assert a[6] == b[6]


@pytest.fixture
def arrays():
    rng = np.random.default_rng(0)
    t = rng.normal(size=(40, 12))
    return t + 0.1 * rng.normal(size=t.shape), t, t + 0.2


def test_scatter_matches_the_jax_figure(arrays):
    model, ols, _ = arrays
    got = plots.scatter_plot(model, ols, title="Alphas")
    _assert_same_figure(got, jax_plots.scatter_plot(model, ols,
                                                    title="Alphas"))
    assert "corr=" in got.axes[0].get_title()
    assert len(got.axes[0].lines) == 1  # the identity line


def test_hist_matches_the_jax_figure_and_its_bins():
    data = np.random.default_rng(0).normal(size=1000)
    got = plots.hist_plot(data, data + 1, title="resid")
    _assert_same_figure(got, jax_plots.hist_plot(data, data + 1,
                                                 title="resid"))
    assert len(got.axes[0].patches) == 2 * (int(1000 * 0.01) + 1)
    assert len(got.axes[0].get_legend().get_texts()) == 4


def test_estimation_scatter_matches_the_jax_figure(arrays):
    got = plots.estimation_scatter(*arrays, est_kind="beta")
    assert len(got.axes) == 2
    _assert_same_figure(got, jax_plots.estimation_scatter(*arrays,
                                                          est_kind="beta"))


def test_estimation_plots_cap_at_nine_stocks_as_the_jax_ones(arrays):
    got, want = _Figures(), _Figures()
    plots.estimation_plots(got, *arrays, est_kind="alpha")
    jax_plots.estimation_plots(want, *arrays, est_kind="alpha")
    assert [(t, s) for t, s, _ in got.logged] == [
        ("estimation/examples_alpha", s) for s in range(9)]
    assert [(t, s) for t, s, _ in got.logged] == [
        (t, s) for t, s, _ in want.logged]
    for (_, _, a), (_, _, b) in zip(got.logged, want.logged):
        _assert_same_figure(a, b)


def _results(rng, n=30, k=12) -> dict:
    pair = lambda: {"model": rng.normal(size=(n, k)),  # noqa: E731
                    "ols": rng.normal(size=(n, k))}
    out = {q: pair() for q in ("recon_residuals", "alpha_residuals",
                               "beta_residuals")}
    for kind in ("alpha", "beta"):
        out[kind] = dict(pair(), true=rng.normal(size=(n, k)))
    return out


#: The JAX test.py's figure tags (the estimation series per stock).
TEST_TAGS = (["scatter/recon_residuals", "scatter/alphas", "scatter/betas",
              "hist/recon_residuals", "hist/alphas", "hist/betas"]
             + [f"estimation/examples_alpha_{s}" for s in range(9)]
             + ["estimation/alpha"]
             + [f"estimation/examples_beta_{s}" for s in range(9)]
             + ["estimation/beta"])


def test_test_figures_are_written_under_the_jax_tags(tmp_path):
    sink = plots.FigureDir(tmp_path / "figures")
    plots.draw_test_figures(_results(np.random.default_rng(1)), sink)
    assert [str(p.relative_to(sink.root).with_suffix(""))
            for p in sink.written] == TEST_TAGS
    assert all(p.stat().st_size > 0 for p in sink.written)


def test_plots_subcommand_draws_from_results_npz(tmp_path, capsys):
    results = _results(np.random.default_rng(2), n=10, k=3)
    np.savez(tmp_path / "results.npz", **cli_test._flatten(results))
    back = plots.results_from_npz(tmp_path / "results.npz")
    for quantity, sources in results.items():
        for source, values in sources.items():
            np.testing.assert_array_equal(back[quantity][source], values)
    assert port_main(["plots", str(tmp_path)]) == 0
    assert "figures: 14 written" in capsys.readouterr().out  # 3 stocks
    assert (tmp_path / "figures" / "estimation" / "beta.png").exists()
    assert port_main(["plots", str(tmp_path / "none")]) == 1


def test_without_matplotlib_one_line_names_the_plots_command(
        tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(plots, "matplotlib_available", lambda: False)
    assert not cli_test.draw_figures(tmp_path, {})
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    assert f"python -m masters_thesis_tpu_torch plots {tmp_path}" in out[0]
    assert not (tmp_path / "figures").exists()
