"""Evaluation figures (model against OLS against the ground truth), drawn
with matplotlib where it imports; importing this package does not import
it."""

from masters_thesis_tpu_torch.viz.plots import (
    FigureDir,
    draw_test_figures,
    estimation_plots,
    estimation_scatter,
    hist_plot,
    matplotlib_available,
    scatter_plot,
)

__all__ = ["scatter_plot", "hist_plot", "estimation_plots",
           "estimation_scatter", "FigureDir", "draw_test_figures",
           "matplotlib_available"]
