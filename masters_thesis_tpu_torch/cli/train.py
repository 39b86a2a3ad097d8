"""Training driver: the port's counterpart of ``train.py``.

    python -m masters_thesis_tpu_torch train                        # defaults
    python -m masters_thesis_tpu_torch train model=large loss=nll   # groups
    python -m masters_thesis_tpu_torch train model.learning_rate=1e-3
    python -m masters_thesis_tpu_torch train -m model.learning_rate=1e-3,1e-4
    python -m masters_thesis_tpu_torch train --device cpu ...       # no card

It composes ``configs/`` with the port's own composer, bootstraps the data
(the synthetic DGP, scalar or with ``datamodule.n_factors`` factors, or
``datamodule=real``'s Fama-French CSVs under ``datamodule.raw_dir``:
without them it prints ``train.py``'s message and trains nothing), builds
the data module (``datamodule.engine``, ``datamodule.store_shards``) and
the model spec, trains with the port's ``Trainer`` (``trainer.epoch_mode``
scan or stream; best/last checkpoints under ``<log_dir>/checkpoints``),
tests, logs the hparams with the test metrics, prints ``train.py``'s
``done:`` line and returns the best val loss. ``checkpoint=`` with
``checkpoint_mode=full``
(weights and FlatAdam state; the checkpoint's spec wins) or ``params``
(weights only, a fresh optimizer, the config's spec: the warm-up protocol)
starts from a checkpoint; ``trainer.resume`` continues from ``last``. ``-m``
runs the sweep's jobs, each in its numbered job dir (Hydra's multirun
layout): one after another in this process (``launcher=sequential``), or
one child process a job, at most ``launcher.n_jobs`` at once
(``launcher=joblib`` with ``n_jobs`` >= 2; joblib runs ``n_jobs=1`` in
process). ``launcher.num_hosts`` / ``MT_NUM_HOSTS`` and
``launcher.host_index`` / ``MT_HOST_INDEX`` give this host every
``num_hosts``-th job (``partition_jobs``), under its global job index.

Data-parallel training (``parallel/``): ``trainer.strategy=tpu_xla``
(``trainer=tpu_xla``) with ``trainer.n_devices=N`` trains as N ranks, one
process each, which the entry point starts itself (``parallel/launch.py``):
on the card rank r owns ``cuda:r`` over NCCL, and asking for more cards
than are visible raises, naming ``trainer.n_devices``; with ``--device
cpu`` the ranks are N gloo processes. ``trainer.shard_axis=asset`` shards
the asset rows instead of the windows. ``trainer.distributed=true`` makes
this process one rank of an outside launch (the coordinator and the
process index and count from the environment ``parallel/mesh.py`` reads);
initialisation is then required. Rank 0 prints, logs and writes the
checkpoints; each rank's telemetry goes to its own stream (rank r > 0
under ``<telemetry>/rank<r>``).

It runs on CUDA unless given ``--device cpu``, and raises without a card. A
config key the port cannot honour raises and names the key
(:func:`check_supported`). The observation keys reach the trainer as in
``train.py``: ``trainer.telemetry`` (``auto``: ``<log_dir>/telemetry``; a
path pins the run directory; null turns it off) writes ``events.jsonl``
there, with the flight recorder (``trainer.hang_timeout_s``), the profiler
window (``trainer.profile_steps``, ``trainer.profile``) and the analytic
cost profile (``trainer.cost_profile``), and the run ends with the
``telemetry: python -m masters_thesis_tpu_torch.telemetry summarize <dir>``
line. ``trainer.preflight=true`` runs the trace audit of the configured
model's training step (``analysis/traceaudit.py``, TA201–TA206) on the
trainer's device before ``fit`` and writes its ``preflight`` event; a
finding stops the run before any real epoch.
"""

from __future__ import annotations

import argparse
import datetime
import os
import sys
import time
from pathlib import Path

from masters_thesis_tpu_torch.config import (
    Config,
    compose,
    expand_multirun,
    register_resolver,
    to_flat_dict,
)
from masters_thesis_tpu_torch.config import yaml_subset

CONFIG_DIR = Path(__file__).resolve().parents[2] / "configs"

def register_resolvers() -> None:
    """The derived-config resolvers of ``train.py``."""
    register_resolver(
        "input_size_from_interaction",
        lambda interaction: 3 if interaction else 5,
    )
    # Features [r_stock, f_1..f_K, r_stock*f_k...] (2K+1) with
    # interaction_only, plus the squared channels (3K+2) otherwise.
    register_resolver(
        "input_size_from_factors",
        lambda interaction, n_factors: (
            2 * int(n_factors) + 1 if interaction else 3 * int(n_factors) + 2
        ),
    )


def compose_config(overrides: list[str]) -> Config:
    """``configs/config.yaml`` composed with ``overrides``."""
    register_resolvers()
    return compose(CONFIG_DIR, overrides=overrides)


def _refuse(key: str, value, why: str) -> None:
    raise ValueError(f"{key}={value}: {why}; masters_thesis_tpu_torch cannot "
                     "honour it yet")


def check_data_supported(cfg: Config) -> None:
    """Raise, naming the key, where the data config asks for what the port's
    data module does not do."""
    d = cfg.datamodule
    if "n_stocks" not in d and "raw_dir" not in d:
        _refuse("datamodule", d.get("name"), "it has neither n_stocks (the "
                "synthetic DGP) nor raw_dir (the Fama-French CSVs)")
    if (d.get("engine", "auto") == "native" and data_factors(cfg) > 1
            and d.get("store_shards") is None):
        _refuse("datamodule.engine", d.engine, "the C++ window engine takes "
                "the scalar market series only; K-factor windows build "
                "through the python engine (auto or python)")


def data_factors(cfg: Config) -> int:
    """Factors of the configured source: ``datamodule.n_factors`` of the
    synthetic DGP; the Fama-French data has the market alone."""
    d = cfg.datamodule
    return int(d.get("n_factors", 1)) if "n_stocks" in d else 1


#: Asset rows of a ``datamodule=real`` window: the 25 Fama-French
#: portfolios.
FAMA_FRENCH_ROWS = 25


def window_rows(cfg: Config) -> int:
    """Rows of one window of the configured data: ``datamodule.n_stocks``
    (the synthetic and universe DGPs), or the 25 Fama-French portfolios."""
    return int(cfg.datamodule.get("n_stocks", FAMA_FRENCH_ROWS))


def check_precision(cfg: Config, shapes: bool = True) -> None:
    """Raise, naming ``trainer.precision``, for a value the JAX trainer
    does not take, and (with ``shapes``) for bf16 where the configured
    model groups a single layer at itemsize 2, in training or in
    evaluation: the pair's and the L-deep stack's kernels are the port's
    only bf16 ones."""
    import torch

    from masters_thesis_tpu_torch.models.lstm import group_depths
    from masters_thesis_tpu_torch.train.trainer import (
        EVAL_CHUNK,
        PRECISIONS,
        precision_dtype,
    )

    precision = cfg.trainer.get("precision", "32-true")
    if precision not in PRECISIONS:
        _refuse("trainer.precision", precision, "the precisions are "
                f"{', '.join(PRECISIONS)}")
    if not shapes or precision_dtype(precision) != torch.bfloat16:
        return
    m, d = cfg.model, cfg.datamodule
    k = window_rows(cfg)
    runs = {"training": (int(d.batch_size) * k, float(m.dropout) > 0),
            "evaluation": (EVAL_CHUNK * k, False)}
    for run, (rows, has_mask) in runs.items():
        groups = group_depths(int(m.num_layers), int(d.lookback_window), rows,
                              int(m.hidden_size), has_mask, window_rows=k,
                              itemsize=2)
        if 1 in groups:
            _refuse("trainer.precision", precision, f"in bf16 the "
                    f"{m.num_layers} layers (H={m.hidden_size}) over "
                    f"{k}-row windows of {d.lookback_window} steps group as "
                    f"{groups} in {run}, and bf16 runs groups of two or more "
                    "layers (the pair and the L-deep stack) only; the "
                    "single-layer and time-blocked kernels in bf16 are "
                    "ROADMAP.md queue 2")


def check_supported(cfg: Config, precision_shapes: bool = True) -> None:
    """Raise, naming the key, for every config value the port cannot
    honour; nothing is dropped silently. ``precision_shapes=False`` checks
    ``trainer.precision``'s value only (a run that builds f32 whatever it
    says: the stacked entry point)."""
    from masters_thesis_tpu_torch.parallel.mesh import SHARD_AXES, STRATEGIES

    check_data_supported(cfg)
    check_precision(cfg, precision_shapes)
    t = cfg.trainer
    if t.get("strategy", "auto") not in STRATEGIES:
        _refuse("trainer.strategy", t.strategy, f"the strategies are "
                f"{', '.join(STRATEGIES)}")
    n_devices = t.get("n_devices", None)
    if n_devices is not None and (not isinstance(n_devices, int)
                                  or isinstance(n_devices, bool)
                                  or n_devices < 1):
        _refuse("trainer.n_devices", n_devices, "it counts ranks (an "
                "integer >= 1, or null for every visible card)")
    if t.get("distributed", False) not in (True, False):
        _refuse("trainer.distributed", t.distributed, "it is true (join an "
                "outside launch) or false")
    if t.get("epoch_mode", "scan") not in ("scan", "stream"):
        _refuse("trainer.epoch_mode", t.epoch_mode, "the epochs are scan and "
                "stream")
    if t.get("shard_axis", "window") not in SHARD_AXES:
        _refuse("trainer.shard_axis", t.shard_axis, "the shard axes are "
                "window and asset")
    if (t.get("shard_axis", "window") == "asset"
            and t.get("epoch_mode", "scan") != "scan"):
        _refuse("trainer.shard_axis", t.shard_axis, "asset sharding runs "
                "scan epochs only (trainer.epoch_mode=scan)")
    m = cfg.model
    if m.get("kernel_impl", "auto") != "auto":
        _refuse("model.kernel_impl", m.kernel_impl, "the port picks its "
                "kernels itself (auto only)")
    n_model, n_data = int(m.get("n_factors", 1)), data_factors(cfg)
    if n_model != n_data:
        # Name the side that left the scalar model.
        if n_model != 1:
            _refuse("model.n_factors", n_model, f"the data has {n_data} "
                    "factor(s) and the beta head must match them")
        _refuse("datamodule.n_factors", n_data, f"the model has {n_model} "
                "loading(s) (model.n_factors); model=kfactor follows the "
                "data")


def check_launcher(cfg: Config) -> None:
    """Raise for a multirun launcher the port does not have (sequential
    and joblib are) or a count below one."""
    launcher = cfg.launcher
    if launcher.get("name", "sequential") not in ("sequential", "joblib"):
        _refuse("launcher", launcher.name, "the launchers are sequential and "
                "joblib")
    if int(launcher.get("n_jobs", 1)) < 1:
        _refuse("launcher.n_jobs", launcher.n_jobs, "a sweep runs at least "
                "one job at a time")
    num_hosts = int(os.environ.get("MT_NUM_HOSTS",
                                   launcher.get("num_hosts", 1)))
    if num_hosts < 1:
        _refuse("launcher.num_hosts", num_hosts, "a sweep runs on at least "
                "one host")
    host_index = int(os.environ.get("MT_HOST_INDEX",
                                    launcher.get("host_index", 0)))
    if not 0 <= host_index < num_hosts:
        _refuse("launcher.host_index", host_index, f"the hosts are 0 .. "
                f"{num_hosts - 1}")


def partition_jobs(jobs: list, host_index: int, num_hosts: int) -> list:
    """Round-robin shard of a sweep's jobs for multi-host dispatch: host
    ``host_index`` of ``num_hosts`` runs every ``num_hosts``-th job,
    starting at its own index (``train.py``'s rule)."""
    if not 0 <= host_index < num_hosts:
        raise ValueError(
            f"host_index {host_index} out of range for {num_hosts} hosts")
    return jobs[host_index::num_hosts]


def run_world(cfg: Config, device) -> int:
    """The number of ranks ``cfg`` trains as on ``device`` (``cuda`` when
    None): raises, naming ``trainer.n_devices``, for more cards than are
    visible."""
    from masters_thesis_tpu_torch.parallel.mesh import resolve_world

    t = cfg.trainer
    return resolve_world(t.get("strategy", "auto"), t.get("n_devices", None),
                         "cuda" if device is None else device)[1]


def launches_ranks(cfg: Config, device) -> int:
    """The world this process must start as ranks (``parallel/launch.py``),
    or 0 when it runs the job itself: a process that is already a rank
    (or joins an outside launch) and a world of one run in place."""
    from masters_thesis_tpu_torch.parallel.mesh import launched_rank

    if launched_rank() or cfg.trainer.get("distributed", False):
        return 0
    world = run_world(cfg, device)
    return world if world > 1 else 0


def make_telemetry(cfg: Config, log_dir: Path, rank: int = 0):
    """The run's ``TelemetryRun`` from ``trainer.telemetry``: ``auto`` puts
    it under ``<log_dir>/telemetry``, a path pins it there, null or false
    turns it off (None). Rank r > 0 of a launch writes its own stream, in
    ``rank<r>`` under that directory."""
    from masters_thesis_tpu_torch.telemetry.run import TelemetryRun

    tel_cfg = cfg.trainer.get("telemetry", None)
    if not tel_cfg:
        return None
    run_dir = log_dir / "telemetry" if tel_cfg == "auto" else Path(tel_cfg)
    return TelemetryRun(run_dir / f"rank{rank}" if rank else run_dir)


def observation_kwargs(cfg: Config) -> dict:
    """The trainer's observation keys as ``Trainer`` arguments."""
    t = cfg.trainer
    profile_steps = t.get("profile_steps", None)
    return dict(
        cost_profile=t.get("cost_profile", None),
        profile=bool(t.get("profile", False)),
        profile_steps=tuple(profile_steps) if profile_steps else None,
        hang_timeout_s=t.get("hang_timeout_s", None),
        preflight=bool(t.get("preflight", False)),
    )


def print_summarize_line(telemetry) -> None:
    """Close the run's telemetry and say how to read it."""
    telemetry.close()
    print("telemetry: python -m masters_thesis_tpu_torch.telemetry summarize "
          f"{telemetry.run_dir}", flush=True)


def bootstrap(cfg: Config) -> bool:
    """Make the source arrays of the selected data module unless they are
    there: the synthetic DGP's for a data module with ``n_stocks`` (its
    seed is ``dgp_seed``, not ``seed``, so a seed sweep shares one
    dataset), else the Fama-French CSVs' under ``raw_dir``. False, with
    ``train.py``'s message on stderr, when the CSVs are missing."""
    from masters_thesis_tpu_torch.data.pipeline import (
        bootstrap_real,
        bootstrap_synthetic,
    )

    d = cfg.datamodule
    if "n_stocks" in d:
        bootstrap_synthetic(
            Path(d.data_dir),
            n_stocks=d.n_stocks,
            n_samples=d.n_samples,
            seed=d.get("dgp_seed", 0),
            variant=d.get("dgp_variant", "no_outliers"),
            n_factors=d.get("n_factors", 1),
        )
        return True
    if not bootstrap_real(Path(d.raw_dir), Path(d.data_dir)):
        print(f"Real data CSVs not found under {d.raw_dir}; download the "
              "Fama-French daily factors + 25 portfolios files first.",
              file=sys.stderr)
        return False
    return True


def build_datamodule(cfg: Config):
    from masters_thesis_tpu_torch.data.pipeline import FinancialWindowDataModule

    d = cfg.datamodule
    return FinancialWindowDataModule(
        Path(d.data_dir),
        lookback_window=d.lookback_window,
        target_window=d.target_window,
        stride=d.stride,
        prediction_task=d.prediction_task,
        interaction_only=d.interaction_only,
        batch_size=d.batch_size,
        engine=d.get("engine", "auto"),
        store_shards=d.get("store_shards"),
    )


def build_spec(cfg: Config):
    """Model registry lookup + hparams."""
    from masters_thesis_tpu_torch.models.objectives import get_model_spec

    hparams = dict(
        input_size=cfg.model.input_size,
        hidden_size=cfg.model.hidden_size,
        num_layers=cfg.model.num_layers,
        dropout=cfg.model.dropout,
        n_factors=cfg.model.get("n_factors", 1),
        learning_rate=cfg.model.learning_rate,
        weight_decay=cfg.model.weight_decay,
        remat=cfg.model.get("remat", False),
    )
    if "mse_weight" in cfg.loss:
        hparams["mse_weight"] = cfg.loss.mse_weight
    return get_model_spec(cfg.loss.module_class, **hparams)


def _init_state(cfg: Config, spec):
    """``(spec, init_state)`` for ``Trainer.fit`` from ``cfg.checkpoint``
    and ``cfg.checkpoint_mode``."""
    from masters_thesis_tpu_torch.train.checkpoint import restore_checkpoint

    mode = cfg.get("checkpoint_mode", "full")
    if mode not in ("full", "params"):
        raise ValueError(
            f"checkpoint_mode must be 'full' or 'params', got {mode!r}"
        )
    state, opt_state, ckpt_spec, _ = restore_checkpoint(Path(cfg.checkpoint))
    if mode == "full":
        # Exact continuation: the checkpoint's spec (objective, lr, ...) wins.
        return ckpt_spec, (state, opt_state)
    # 'params' = the warm-up protocol: reuse the weights with a fresh
    # optimizer, and the config keeps deciding the objective, lr and
    # dropout. Only the weight shapes must match the checkpoint: the
    # layers, and the input and beta-head widths that the factor count sets.
    for labels in ({"hidden_size": "hidden", "num_layers": "layers"},
                   {"input_size": "inputs", "n_factors": "factors"}):
        def shape(s) -> str:
            return "/".join(f"{label}={getattr(s, key)}"
                            for key, label in labels.items())

        if shape(ckpt_spec) != shape(spec):
            raise ValueError(
                "checkpoint_mode=params needs a matching architecture: "
                f"checkpoint is {shape(ckpt_spec)}, config asks {shape(spec)}"
            )
    return spec, (state, None)


def run(cfg: Config, device=None) -> float:
    """One training run; returns the best validation loss."""
    from masters_thesis_tpu_torch import resolve_device
    from masters_thesis_tpu_torch.train.logging import RunLogger
    from masters_thesis_tpu_torch.train.trainer import Trainer

    from masters_thesis_tpu_torch.parallel.mesh import (
        data_mesh,
        distributed_initialize,
    )
    from masters_thesis_tpu_torch.utils.compilation_cache import (
        enable_persistent_compilation_cache,
    )

    # A run after the first loads the kernels nvcc built for it.
    enable_persistent_compilation_cache()
    device = resolve_device(device)
    check_supported(cfg)
    t = cfg.trainer
    if t.get("distributed", False):
        # One rank of an outside launch: its coordinator must answer.
        distributed_initialize(required=True, device=device)
    mesh = data_mesh(t.get("strategy", "auto"), t.get("n_devices", None),
                     device)
    if not bootstrap(cfg):
        return float("inf")
    dm = build_datamodule(cfg)
    spec = build_spec(cfg)

    logger = RunLogger(cfg.logger.save_dir, cfg.logger.name, cfg.logger.version)
    telemetry = make_telemetry(cfg, logger.log_dir, mesh.rank)
    resume = t.get("resume", False)
    if isinstance(resume, str):
        # 'auto' (the supervised-run setting) and true both mean "continue
        # from <ckpt_dir>/last when it is there".
        resume = resume.lower() in ("true", "auto", "1", "yes")
    trainer = Trainer(
        max_epochs=t.max_epochs,
        gradient_clip_val=t.gradient_clip_val,
        check_val_every_n_epoch=t.get("check_val_every_n_epoch", 1),
        ckpt_dir=logger.log_dir / "checkpoints",
        seed=cfg.seed,
        device=device,
        logger=logger,
        resume=resume,
        checkpoint_every_n_epochs=cfg.get("resilience", {}).get(
            "checkpoint_every_n_epochs", None
        ),
        enable_progress_bar=t.get("enable_progress_bar", True),
        enable_model_summary=t.get("enable_model_summary", True),
        epoch_mode=t.get("epoch_mode", "scan"),
        name=t.get("name", "fast"),
        telemetry=telemetry,
        strategy=t.get("strategy", "auto"),
        n_devices=t.get("n_devices", None),
        shard_axis=t.get("shard_axis", "window"),
        precision=t.get("precision", "32-true"),
        **observation_kwargs(cfg),
    )
    init_state = None
    if cfg.checkpoint:
        spec, init_state = _init_state(cfg, spec)

    result = trainer.fit(spec, dm, init_state=init_state)
    test_metrics = trainer.test(spec, result.state, dm)
    if mesh.is_main:
        logger.log_hparams(
            to_flat_dict(cfg),
            {
                "test/mae": test_metrics.get("mae", float("nan")),
                "test/nll": test_metrics.get("nll", float("nan")),
                "test/best_val_loss": result.best_val_loss,
            },
        )
    logger.close()
    if telemetry is not None:
        if mesh.is_main:
            print_summarize_line(telemetry)
        else:
            telemetry.close()
    if mesh.is_main:
        print(
            f"done: best_val={result.best_val_loss:.6g} "
            f"test_mae={test_metrics.get('mae', float('nan')):.6g} "
            f"test_nll={test_metrics.get('nll', float('nan')):.6g} "
            f"steps/sec={result.steps_per_sec:.1f}",
            flush=True,
        )
    mesh.shutdown()
    return result.best_val_loss


def _write_job_metadata(job_dir: Path, cfg: Config, overrides: list[str]):
    """Hydra-style per-job metadata: .hydra/config.yaml + overrides.yaml."""
    meta_dir = job_dir / ".hydra"
    meta_dir.mkdir(parents=True, exist_ok=True)
    (meta_dir / "config.yaml").write_text(yaml_subset.dump(cfg))
    (meta_dir / "overrides.yaml").write_text(yaml_subset.dump(list(overrides)))


def _job_overrides(overrides: list[str], job_index: int | None,
                   sweep_dir: str | None) -> list[str]:
    """A sweep job's overrides with its own output place: Hydra's multirun
    layout (each job a numbered dir ``<sweep_dir>/<job>/`` with its logs,
    checkpoints and ``.hydra`` metadata, written here), or, where
    ``logger.save_dir`` is absolute and pins the output, a ``_job<N>``
    version suffix."""
    if job_index is None:
        return list(overrides)
    cfg = compose_config(overrides)
    if sweep_dir is not None and not Path(cfg.logger.save_dir).is_absolute():
        job_dir = Path(sweep_dir) / str(job_index)
        extra = [f"logger.save_dir={job_dir / cfg.logger.save_dir}"]
        _write_job_metadata(job_dir, compose_config([*overrides, *extra]),
                            overrides)
    else:
        extra = [f"logger.version={cfg.logger.version}_job{job_index}"]
    return [*overrides, *extra]


def _run_job(overrides: list[str], job_index: int | None = None,
             sweep_dir: str | None = None, device=None) -> int:
    """One job: in this process, or as the ranks ``trainer.n_devices``
    asks for (``parallel/launch.py``); returns the exit code."""
    from masters_thesis_tpu_torch.parallel.launch import as_ranks

    overrides = _job_overrides(overrides, job_index, sweep_dir)
    cfg = compose_config(overrides)
    check_supported(cfg)
    world = launches_ranks(cfg, device)
    if world:
        return as_ranks("train", overrides, world, device)
    run(cfg, device=device)
    return 0


def _pool(jobs: list[tuple[int, list[str]]], n_jobs: int, sweep_dir: str,
          device) -> int:
    """``launcher=joblib``: each job a child ``python -m
    masters_thesis_tpu_torch train`` of its overrides (its job dir and
    metadata made here), at most ``n_jobs`` at once, each the host's cores
    shared out; returns the first failure's exit code (the others still
    run to their end), else 0."""
    import subprocess

    from masters_thesis_tpu_torch.parallel.launch import exit_code

    env = dict(os.environ)
    if str(device) == "cpu" and "OMP_NUM_THREADS" not in env:
        env["OMP_NUM_THREADS"] = str(max(1, (os.cpu_count() or 1) // n_jobs))
    command = [sys.executable, "-m", "masters_thesis_tpu_torch", "train"]
    if device is not None:
        command += ["--device", str(device)]
    pending = list(jobs)
    running: list[tuple[int, subprocess.Popen]] = []
    failed = 0
    try:
        while pending or running:
            while pending and len(running) < n_jobs:
                i, ov = pending.pop(0)
                print(f"--- job {i}: {ov}", flush=True)
                running.append((i, subprocess.Popen(
                    [*command, *_job_overrides(ov, i, sweep_dir)], env=env)))
            for entry in list(running):
                i, proc = entry
                code = proc.poll()
                if code is None:
                    continue
                running.remove(entry)
                if code:
                    print(f"--- job {i} exited {exit_code(code)}",
                          file=sys.stderr, flush=True)
                    failed = failed or exit_code(code)
            time.sleep(0.05)
    finally:
        for _, proc in running:
            proc.kill()
            proc.wait()
    return failed


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m masters_thesis_tpu_torch train",
        description=__doc__.split("\n\n")[0],
    )
    parser.add_argument("overrides", nargs="*", help="key=value config overrides")
    parser.add_argument(
        "-m", "--multirun", action="store_true",
        help="expand comma-separated override values into a sweep",
    )
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    args = parser.parse_intermixed_args(argv)

    if not args.multirun:
        return _run_job(args.overrides, device=args.device)

    jobs = expand_multirun(args.overrides)
    cfg0 = compose_config(jobs[0])
    check_launcher(cfg0)
    launcher = cfg0.launcher
    n_jobs = int(launcher.get("n_jobs", 1))
    num_hosts = int(os.environ.get("MT_NUM_HOSTS",
                                   launcher.get("num_hosts", 1)))
    host_index = int(os.environ.get("MT_HOST_INDEX",
                                    launcher.get("host_index", 0)))
    # Numbered sweep output root (Hydra's multirun/<date>/<time>); pin it
    # with launcher.sweep_dir or MT_SWEEP_DIR (across hosts, one tree).
    sweep_dir = os.environ.get("MT_SWEEP_DIR") or launcher.get("sweep_dir")
    if not sweep_dir:
        now = datetime.datetime.now()
        sweep_dir = f"multirun/{now:%Y-%m-%d}/{now:%H-%M-%S}"
    # Jobs keep their global sweep index across hosts, so job dirs do not
    # collide.
    indexed = list(enumerate(jobs))
    if num_hosts > 1:
        indexed = partition_jobs(indexed, host_index, num_hosts)
        print(f"multirun: host {host_index}/{num_hosts} takes "
              f"{len(indexed)}/{len(jobs)} jobs", flush=True)
    print(f"multirun: {len(indexed)} jobs, n_jobs={n_jobs}", flush=True)
    if n_jobs >= 2:
        return _pool(indexed, n_jobs, sweep_dir, args.device)
    for i, ov in indexed:
        print(f"--- job {i}: {ov}", flush=True)
        code = _run_job(ov, job_index=i, sweep_dir=sweep_dir,
                        device=args.device)
        if code:
            return code
    return 0
