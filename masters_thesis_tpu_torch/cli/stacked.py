"""Stacked-cell driver: the port's counterpart of ``sweeps/stacked_cell.py``.

    python -m masters_thesis_tpu_torch stacked model=small loss=mse \
        --replicas '[{"name": "s0", "seed": 0}, {"name": "s1", "seed": 1,
                      "lr": 1e-3}]' \
        --ckpt-dir logs/FinancialLstm/synthetic_stacked/mse_small_fast
    python -m masters_thesis_tpu_torch stacked --device cpu ... --max-epochs 2

Trains a stack-compatible group of cells (one model, loss and trainer; each
replica its own seed and, with ``"lr"``, its own learning rate, else
``model.learning_rate``) as one ``StackedTrainer`` program, each replica's
checkpoints under ``<ckpt-dir>/<name>/`` in the layout ``train`` writes, so
``test`` and the serving engines take each cell as they take a solo run.
It resumes from the replicas' common ``last`` epoch when there is one. It
composes ``configs/`` with the port's composer and refuses what ``train``
refuses, and the stream epoch (stacked training runs scan epochs). It prints
one JSON line, ``{"replicas": [{name, status, best_val, rollbacks,
checkpoint}], "steps_per_sec", "epochs"}``, and exits 0 when at least one
replica ends unmasked, 1 otherwise. It runs on CUDA unless given
``--device cpu``. ``trainer.telemetry`` (``auto``: ``<ckpt-dir>/telemetry``,
where ``sweeps/stacked_cell.py`` puts it; a path pins it; null turns it
off) writes the stacked trainer's events there, with the flight recorder
(``trainer.hang_timeout_s``), and the run ends with the ``telemetry:
... summarize <dir>`` line; the profiler window and the cost profile are
``train``'s only, and a set ``trainer.profile``, ``profile_steps`` or
``cost_profile`` is named in a printed note. ``trainer.strategy``,
``trainer.n_devices`` and ``trainer.distributed`` act as in ``train``: the
replicas train data-parallel over that many ranks (window sharding),
which this command starts itself; rank 0 prints and writes.
"""

from __future__ import annotations

import argparse
import json
import math
from pathlib import Path

from masters_thesis_tpu_torch.cli import train as cli_train


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m masters_thesis_tpu_torch stacked",
        description=__doc__.split("\n\n")[0])
    parser.add_argument("overrides", nargs="*", help="key=value overrides")
    parser.add_argument("--replicas", required=True,
                        help='JSON list of {"name", "seed", optional "lr"} '
                        "entries")
    parser.add_argument("--ckpt-dir", required=True, type=Path,
                        help="root dir; each replica checkpoints under "
                        "<ckpt-dir>/<name>/")
    parser.add_argument("--max-epochs", type=int, default=None,
                        help="override trainer.max_epochs")
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    args = parser.parse_intermixed_args(argv)

    from masters_thesis_tpu_torch import resolve_device
    from masters_thesis_tpu_torch.parallel.launch import as_ranks
    from masters_thesis_tpu_torch.parallel.mesh import (
        data_mesh,
        distributed_initialize,
    )
    from masters_thesis_tpu_torch.train.stacked import ReplicaSpec, StackedTrainer

    cfg = cli_train.compose_config(args.overrides)
    # Replicas build f32 whatever trainer.precision says, as the JAX
    # stacked trainer does: only its value is checked.
    cli_train.check_supported(cfg, precision_shapes=False)
    t = cfg.trainer
    if t.get("epoch_mode", "scan") != "scan":
        raise ValueError(f"trainer.epoch_mode={t.epoch_mode}: stacked training "
                         "runs scan epochs only; masters_thesis_tpu_torch "
                         "cannot honour it yet")
    if t.get("shard_axis", "window") != "window":
        raise ValueError(f"trainer.shard_axis={t.shard_axis}: stacked "
                         "training shards windows only; "
                         "masters_thesis_tpu_torch cannot honour it yet")
    world = cli_train.launches_ranks(cfg, args.device)
    if world:
        argv = [*args.overrides, "--replicas", args.replicas,
                "--ckpt-dir", str(args.ckpt_dir)]
        if args.max_epochs is not None:
            argv += ["--max-epochs", str(args.max_epochs)]
        return as_ranks("stacked", argv, world, args.device)
    device = resolve_device(args.device)
    if t.get("distributed", False):
        distributed_initialize(required=True, device=device)
    mesh = data_mesh(t.get("strategy", "auto"), t.get("n_devices", None),
                     device)
    if not cli_train.bootstrap(cfg):
        return 1
    dm = cli_train.build_datamodule(cfg)
    spec = cli_train.build_spec(cfg)
    for key in ("profile", "profile_steps", "cost_profile"):
        if t.get(key) and mesh.is_main:
            print(f"note: trainer.{key}={t[key]} applies to the train "
                  "command only; ignored here", flush=True)
    telemetry = cli_train.make_telemetry(cfg, args.ckpt_dir, mesh.rank)
    replicas = [
        ReplicaSpec(name=str(r["name"]), seed=int(r["seed"]),
                    learning_rate=float(r.get("lr") or spec.learning_rate))
        for r in json.loads(args.replicas)
    ]
    trainer = StackedTrainer(
        max_epochs=args.max_epochs or t.max_epochs,
        gradient_clip_val=t.gradient_clip_val,
        check_val_every_n_epoch=t.get("check_val_every_n_epoch", 1),
        ckpt_dir=args.ckpt_dir,
        device=device,
        # A relaunch picks the group up at its last common 'last' epoch.
        resume=True,
        enable_progress_bar=t.get("enable_progress_bar", True),
        telemetry=telemetry,
        hang_timeout_s=t.get("hang_timeout_s", None),
        strategy=t.get("strategy", "auto"),
        n_devices=t.get("n_devices", None),
        preflight=bool(t.get("preflight", False)),
    )
    result = trainer.fit(spec, dm, replicas)
    mesh.shutdown()
    if telemetry is not None:
        if mesh.is_main:
            cli_train.print_summarize_line(telemetry)
        else:
            telemetry.close()
    rows = [
        {
            "name": r.name,
            "status": r.status,
            "best_val": (r.best_val_loss if math.isfinite(r.best_val_loss)
                         else None),
            "rollbacks": r.rollbacks,
            "checkpoint": str(args.ckpt_dir / r.name / "best"),
        }
        for r in result.replicas
    ]
    if mesh.is_main:
        print(json.dumps({"replicas": rows,
                          "steps_per_sec": result.steps_per_sec,
                          "epochs": result.epochs}), flush=True)
    return 0 if any(r.status != "masked" for r in result.replicas) else 1
