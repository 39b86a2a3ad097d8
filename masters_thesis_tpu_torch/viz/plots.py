"""Evaluation figures: model against OLS against the ground truth.

The port's counterpart of ``masters_thesis_tpu/viz/plots.py`` (which
mirrors the reference's ``src/plots.py``): the same four figure kinds with
the same annotations (the Pearson correlation in the titles, mean and std
lines on the histograms, the identity line, at most nine stocks' series),
on numpy arrays. :func:`draw_test_figures` draws the JAX ``test.py``'s
figure set under its tags, as PNG files in a directory
(:class:`FigureDir`).

matplotlib is imported inside the functions, never at module scope: the
card's machine has none, and the modules it imports must import without
it. :func:`matplotlib_available` says whether this machine can draw.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np

FIGSIZE = (16, 9)
#: Per-stock series drawn at most (the reference's cap).
MAX_STOCKS = 9


def matplotlib_available() -> bool:
    return importlib.util.find_spec("matplotlib") is not None


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")  # headless: figures only ever go to files
    import matplotlib.pyplot as plt

    return plt


def _corr(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.corrcoef(a.ravel(), b.ravel())[0, 1])


def scatter_plot(model: np.ndarray, ols: np.ndarray, title: str):
    """Model-vs-OLS scatter with the identity line; the correlation in the
    title (reference: src/plots.py:10-28)."""
    plt = _pyplot()
    model = np.asarray(model).ravel()
    ols = np.asarray(ols).ravel()
    fig, ax = plt.subplots(figsize=FIGSIZE)
    ax.scatter(model, ols, marker=".")
    identity = (model.min(), model.max())
    ax.plot(identity, identity, "r--")
    ax.set_xlabel("Model")
    ax.set_ylabel("OLS")
    ax.set_title(f"{title}, corr={_corr(model, ols):.4f}")
    ax.grid(alpha=0.5)
    return fig


def hist_plot(model: np.ndarray, ols: np.ndarray, title: str):
    """Overlaid density histograms with mean/std lines; the bin count is 1%
    of the samples, plus one (reference: src/plots.py:30-54)."""
    plt = _pyplot()
    model = np.asarray(model).ravel()
    ols = np.asarray(ols).ravel()
    bins = int(len(model) * 0.01) + 1
    fig, ax = plt.subplots(figsize=FIGSIZE)
    ax.hist(model, bins=bins, density=True, alpha=0.6, label="Model",
            color="blue")
    ax.hist(ols, bins=bins, density=True, alpha=0.6, label="OLS",
            color="orange")
    for data, color, label in ((model, "blue", "Model"),
                               (ols, "orange", "OLS")):
        ax.axvline(data.mean(), color=color, linestyle="--",
                   label=f"{label} Residual Avg: {data.mean():.4f} "
                         f"(std={data.std():.4f})")
    ax.set_title(title)
    ax.grid(alpha=0.5)
    ax.legend()
    return fig


def estimation_plots(sink, model_ests, ols_ests, trues,
                     est_kind: str = "alpha") -> None:
    """Per-stock estimate series, one figure a stock for the first nine at
    most, each to ``sink.log_figure("estimation/examples_<kind>", fig,
    step=<stock>)`` (reference: src/plots.py:56-76)."""
    plt = _pyplot()
    model_ests = np.asarray(model_ests)
    ols_ests = np.asarray(ols_ests)
    trues = np.asarray(trues)
    for stock in range(min(model_ests.shape[1], MAX_STOCKS)):
        fig, ax = plt.subplots(figsize=FIGSIZE)
        sample = np.arange(model_ests.shape[0])
        ax.plot(sample, trues[:, stock], color="magenta", linestyle="--",
                alpha=0.5, label=f"True {est_kind}")
        ax.scatter(sample, model_ests[:, stock], marker=".", color="blue",
                   label="Model")
        ax.scatter(sample, ols_ests[:, stock], marker=".", color="orange",
                   label="OLS")
        ax.set_title(f"Model vs OLS {est_kind} estimation (Stock {stock})")
        ax.legend()
        ax.grid(alpha=0.5)
        sink.log_figure(f"estimation/examples_{est_kind}", fig, step=stock)
        plt.close(fig)


def estimation_scatter(model_ests, ols_ests, trues, est_kind: str = "alpha"):
    """Two panels of truth against estimate (model above, OLS below),
    shared axes, identity lines, each panel's correlation (reference:
    src/plots.py:78-110)."""
    plt = _pyplot()
    model_ests = np.asarray(model_ests).ravel()
    ols_ests = np.asarray(ols_ests).ravel()
    trues = np.asarray(trues).ravel()
    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=FIGSIZE, sharex=True,
                                   sharey=True)
    fig.suptitle(f"Ground Truth {est_kind} vs Estimated {est_kind}")
    identity = (trues.min(), trues.max())
    for ax, ests, color, label in ((ax1, model_ests, "blue", "Model"),
                                   (ax2, ols_ests, "orange", "OLS")):
        ax.set_title(f"{label} corr={_corr(ests, trues):.4f}")
        ax.set_ylabel(f"{label} {est_kind}")
        ax.plot(identity, identity, color="magenta", linestyle="--")
        ax.scatter(trues, ests, marker=".", alpha=0.15, color=color)
        ax.grid()
    ax2.set_xlabel(f"Ground Truth {est_kind}")
    return fig


class FigureDir:
    """A figure sink that writes ``<root>/<tag>.png`` (``<tag>_<step>.png``
    for a stepped figure) and closes the figure."""

    def __init__(self, root: str | Path):
        self.root = Path(root)
        self.written: list[Path] = []

    def log_figure(self, tag: str, figure, step: int | None = None) -> None:
        name = tag if step is None else f"{tag}_{step}"
        path = self.root / f"{name}.png"
        path.parent.mkdir(parents=True, exist_ok=True)
        figure.savefig(path)
        _pyplot().close(figure)
        self.written.append(path)


def draw_test_figures(results: dict, sink) -> None:
    """The JAX ``test.py``'s figures of ``collect_test_results``'s arrays,
    under its tags: the residual scatters and histograms, each kind's
    per-stock series and its truth-vs-estimate scatter."""
    for tag, key, title in (
            ("recon_residuals", "recon_residuals",
             "Model vs OLS Reconstruction Residuals"),
            ("alphas", "alpha", "Model vs OLS Alphas"),
            ("betas", "beta", "Model vs OLS Betas")):
        sink.log_figure(f"scatter/{tag}", scatter_plot(
            results[key]["model"], results[key]["ols"], title=title))
    for tag, key, title in (
            ("recon_residuals", "recon_residuals",
             "Model vs OLS Reconstruction Residuals"),
            ("alphas", "alpha_residuals", "Model vs OLS Alpha Residuals"),
            ("betas", "beta_residuals", "Model vs OLS Beta Residuals")):
        sink.log_figure(f"hist/{tag}", hist_plot(
            results[key]["model"], results[key]["ols"], title=title))
    for kind in ("alpha", "beta"):
        estimation_plots(sink, results[kind]["model"], results[kind]["ols"],
                         results[kind]["true"], est_kind=kind)
        sink.log_figure(f"estimation/{kind}", estimation_scatter(
            results[kind]["model"], results[kind]["ols"],
            results[kind]["true"], est_kind=kind))


def results_from_npz(path: str | Path) -> dict:
    """``collect_test_results``'s nested dict back from ``results.npz``
    (keys ``<quantity>/<source>``)."""
    out: dict = {}
    with np.load(path) as data:
        for key in data.files:
            quantity, source = key.split("/", 1)
            out.setdefault(quantity, {})[source] = data[key]
    return out
