"""Evaluation driver: the port's counterpart of ``test.py``.

    python -m masters_thesis_tpu_torch test checkpoint=<log_dir>/checkpoints
    python -m masters_thesis_tpu_torch test checkpoint=<...>/checkpoints/best
    python -m masters_thesis_tpu_torch test --device cpu checkpoint=...

Restores a checkpoint of the port (the root picks ``best``; a tag path
names one; a checkpoint of the port's older ``<tag>.pt`` form is read
too), windows the data as the checkpoint was trained (its datamodule
sidecar), compares model against OLS against ground truth on the test split
(``collect_test_results``), and prints the thesis's ΔL table
(``delta_losses``): the model's row and the lookback-OLS row, in
``test.py``'s format. It writes ``results.json`` (the ΔL table and the
test-split metrics of ``Trainer.test``) and ``results.npz`` (the arrays of
``collect_test_results``, keyed ``<quantity>/<source>``) into the run's log
dir, and logs the ΔL scalars there (``metrics.jsonl``). Where matplotlib
imports it draws ``test.py``'s figures under the same tags, as PNG files in
``<log_dir>/figures/`` (``viz/plots.py``); the card's machine has no
matplotlib, so there it prints one line naming ``python -m
masters_thesis_tpu_torch plots <log_dir>``, which draws the same figures
from ``results.npz`` on a machine that has it (:func:`plots_main`). A JAX
package (orbax) checkpoint is refused.

With ``datamodule.n_factors > 1`` it writes the test-split metrics of
``Trainer.test`` alone, and says so in one printed line: the ΔL table and
its arrays read the scalar market model's channels (the market, its true
beta, one loading), and on K-factor windows they would read the first
factor as the market and the last as the true beta. The JAX ``test.py``
prints that table at K > 1 all the same.

It runs on CUDA unless given ``--device cpu``, and raises without a card.
``trainer.strategy``, ``trainer.n_devices`` and ``trainer.distributed`` act
as in ``train``: over N ranks (started by this command) each evaluates its
slice of the test split and the metric sums are all-reduced; rank 0 alone
computes the ΔL table, prints and writes.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

from masters_thesis_tpu_torch.cli.train import (
    bootstrap,
    build_datamodule,
    check_data_supported,
    compose_config,
    data_factors,
    launches_ranks,
)
from masters_thesis_tpu_torch.config import Config


def derive_logger_dirs(checkpoint: Path, cfg: Config) -> tuple[str, str, str]:
    """Recover (save_dir, name, version) from the checkpoint path layout
    ``<save_dir>/<name...>/<version>/checkpoints[/tag]``."""
    parts = list(Path(checkpoint).resolve().parts)
    if "checkpoints" in parts:
        i = parts.index("checkpoints")
        version = parts[i - 1]
        save_root = Path(cfg.logger.save_dir).resolve()
        try:
            # name = whatever sits between save_dir and version
            rel = Path(*parts[: i - 1]).relative_to(save_root)
            return str(save_root), str(rel), version
        except ValueError:
            pass
    return cfg.logger.save_dir, cfg.logger.name, cfg.logger.version


def _flatten(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flatten(value, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(value)
    return out


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m masters_thesis_tpu_torch test",
        description=__doc__.split("\n\n")[0],
    )
    parser.add_argument("overrides", nargs="*", help="key=value config overrides")
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    args = parser.parse_intermixed_args(argv)
    cfg = compose_config(args.overrides)
    if not cfg.checkpoint:
        print("No model checkpoint found, exiting...", file=sys.stderr)
        return 1

    world = launches_ranks(cfg, args.device)
    if world:
        from masters_thesis_tpu_torch.parallel.launch import as_ranks

        return as_ranks("test", args.overrides, world, args.device)

    from masters_thesis_tpu_torch import resolve_device
    from masters_thesis_tpu_torch.evaluation import (
        collect_test_results,
        delta_losses,
    )
    from masters_thesis_tpu_torch.parallel.mesh import (
        data_mesh,
        distributed_initialize,
    )
    from masters_thesis_tpu_torch.train.checkpoint import (
        apply_datamodule_sidecar,
        restore_checkpoint,
    )
    from masters_thesis_tpu_torch.train.logging import RunLogger
    from masters_thesis_tpu_torch.train.trainer import Trainer
    from masters_thesis_tpu_torch.utils.compilation_cache import (
        enable_persistent_compilation_cache,
    )

    enable_persistent_compilation_cache()
    device = resolve_device(args.device)
    check_data_supported(cfg)
    t = cfg.trainer
    if t.get("distributed", False):
        distributed_initialize(required=True, device=device)
    mesh = data_mesh(t.get("strategy", "auto"), t.get("n_devices", None),
                     device)
    state, _, spec, meta = restore_checkpoint(Path(cfg.checkpoint))
    # Evaluate on the SAME windowing the checkpoint was trained with.
    apply_datamodule_sidecar(cfg, meta)
    if spec.n_factors != data_factors(cfg):
        raise ValueError(
            f"datamodule.n_factors={data_factors(cfg)}: the checkpoint's model "
            f"has {spec.n_factors} loading(s); compose the data module it was "
            "trained on")
    if not bootstrap(cfg):
        return 1
    dm = build_datamodule(cfg)
    dm.prepare_data()
    save_dir, name, version = derive_logger_dirs(Path(cfg.checkpoint), cfg)
    tester = Trainer(max_epochs=0, device=device, strategy=mesh.strategy,
                     n_devices=mesh.world)
    if spec.n_factors > 1:
        code = _test_kfactor(cfg, spec, state, dm, tester,
                             RunLogger(save_dir, name, version))
        mesh.shutdown()
        return code
    metrics = tester.test(spec, state, dm)
    mesh.shutdown()
    if not mesh.is_main:
        return 0
    results = collect_test_results(spec, state, dm, device=mesh.device)
    deltas = delta_losses(spec, state, dm, estimates=results,
                          device=mesh.device)

    logger = RunLogger(save_dir, name, version)
    # Thesis results-table metrics: losses above the OLS-on-target
    # baseline (ΔL_MSE ×1e-5, ΔL_NLL, ΔL_MIX at ζ=1e5), model and
    # lookback-OLS rows.
    scalars = {}
    for key in ("model", "ols"):
        d = deltas[key]
        scalars.update({
            f"delta/{key}/mse": d["delta_mse"],
            f"delta/{key}/nll": d["delta_nll"],
            f"delta/{key}/mix": d["delta_mix"],
        })
        print(
            f"{key:>6}: dL_MSE(x1e-5)={d['delta_mse'] * 1e5:7.3f}  "
            f"dL_NLL={d['delta_nll']:7.3f}  "
            f"dL_MIX(zeta=1e5)={d['delta_mix']:7.3f}",
            flush=True,
        )
    logger.log_scalars(scalars, 0)
    logger.close()
    (logger.log_dir / "results.json").write_text(json.dumps(
        {"checkpoint": str(cfg.checkpoint), "delta_losses": deltas,
         "test": metrics},
        indent=2,
    ))
    np.savez(logger.log_dir / "results.npz", **_flatten(results))
    print(f"results written to {logger.log_dir}", flush=True)
    draw_figures(logger.log_dir, results)
    return 0


def draw_figures(log_dir: Path, results: dict) -> bool:
    """``test.py``'s figures into ``<log_dir>/figures/``, or one line
    saying where to draw them when matplotlib does not import here."""
    from masters_thesis_tpu_torch.viz import plots

    if not plots.matplotlib_available():
        print("figures: not drawn (no matplotlib here); draw them from "
              "results.npz with `python -m masters_thesis_tpu_torch plots "
              f"{log_dir}` on a machine that has it", flush=True)
        return False
    sink = plots.FigureDir(Path(log_dir) / "figures")
    plots.draw_test_figures(results, sink)
    print(f"figures: {len(sink.written)} written to {sink.root}", flush=True)
    return True


def plots_main(argv: list[str] | None = None) -> int:
    """``python -m masters_thesis_tpu_torch plots <log_dir>``: the figures
    of a ``test`` run's ``results.npz`` into ``<log_dir>/figures/``."""
    from masters_thesis_tpu_torch.viz.plots import results_from_npz

    parser = argparse.ArgumentParser(
        prog="python -m masters_thesis_tpu_torch plots",
        description="draw the test figures of a run's results.npz")
    parser.add_argument("log_dir", type=Path)
    args = parser.parse_args(argv)
    npz = args.log_dir / "results.npz"
    if not npz.exists():
        print(f"no results.npz under {args.log_dir}; run the test command "
              "first", file=sys.stderr)
        return 1
    return 0 if draw_figures(args.log_dir, results_from_npz(npz)) else 1


def _test_kfactor(cfg: Config, spec, state, dm, tester, logger) -> int:
    """The test-split metrics of a K-factor checkpoint, without the ΔL
    table: ``results.json`` holds ``Trainer.test``'s metrics only (rank 0
    writes)."""
    main = tester.mesh.is_main
    if main:
        print(f"note: datamodule.n_factors={spec.n_factors}: the dL table "
              "and results.npz compare with the scalar market model (one "
              "market channel, one loading); masters_thesis_tpu_torch writes "
              "the test metrics only", flush=True)
    tester.logger = logger if main else None
    metrics = tester.test(spec, state, dm)
    if not main:
        return 0
    print("test: " + " ".join(f"{k}={v:.6g}" for k, v in metrics.items()),
          flush=True)
    logger.close()
    (logger.log_dir / "results.json").write_text(json.dumps(
        {"checkpoint": str(cfg.checkpoint), "test": metrics}, indent=2))
    print(f"results written to {logger.log_dir}", flush=True)
    return 0
