"""Ranks of a launched test job for the data-parallel tests
(``tests/test_torch_parallel.py``, ``tests/test_torch_parallel_launch.py``):
``launch_ranks(tmp_path, world, job)`` runs ``RANK_MAIN`` as ``world`` gloo
ranks through the port's launcher, rendezvousing in ``tmp_path`` and cut
at ``RANK_TIMEOUT_S``. Imports no JAX."""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

import torch

from masters_thesis_tpu_torch.parallel import launch as launch_lib

REPO = Path(__file__).resolve().parent.parent
RANK_TIMEOUT_S = 120
WINDOWS = dict(lookback_window=10, target_window=5, stride=15)
TOY = ["datamodule.n_stocks=4", "datamodule.n_samples=1200",
       "datamodule.lookback_window=10", "datamodule.target_window=5",
       "datamodule.stride=15", "model.hidden_size=8",
       "trainer.enable_progress_bar=false"]

# One rank of a launched test job: joins the launch's group, runs the job
# that job.json describes, and saves what it found as rank<r>.pt.
RANK_MAIN = r'''
import json, os, sys, time
from pathlib import Path

import torch

torch.set_num_threads(1)
job = json.loads(Path(sys.argv[1]).read_text())
out_dir = Path(job["out"])
from masters_thesis_tpu_torch.parallel import mesh as mesh_lib

rank, world = mesh_lib.join_fleet(device="cpu")
(out_dir / f"pid{rank}").write_text(str(os.getpid()))
if job.get("fault_rank") == rank:
    os.environ["MTT_FAULT_PLAN"] = json.dumps(job["fault_plan"])
if job.get("no_writes") and rank != 0:
    from masters_thesis_tpu_torch.train import checkpoint

    def refuse(*args, **kwargs):
        raise AssertionError(f"rank {rank} wrote a checkpoint file")

    for name in ("publish", "atomic_write_text", "write_manifest", "_publish"):
        setattr(checkpoint, name, refuse)
out = {}
kind = job["kind"]
if kind == "masked":
    # Replica 0 masked; rank 1's gradient row for it is NaN. The step's
    # all-reduce spreads the NaN to every rank's row 0, which must stay
    # frozen; row 1 trains on the average.
    from masters_thesis_tpu_torch.models.objectives import ModelSpec
    from masters_thesis_tpu_torch.parallel.mesh import DataMesh
    from masters_thesis_tpu_torch.train.flatparams import StackedFlatAdam

    spec = ModelSpec(objective="mse", hidden_size=4, num_layers=1)
    modules = [spec.build_module(device="cpu",
                                 generator=torch.Generator().manual_seed(s))
               for s in (0, 1)]
    opt = StackedFlatAdam(modules, 5.0)
    opt.set_lr([1e-3, 1e-3])
    opt.set_active([False, True])
    before = opt.snapshot()
    grads = torch.Generator().manual_seed(rank)
    opt.grads.copy_(torch.randn(opt.grads.shape, generator=grads))
    if rank == 1:
        opt.grads[0] = float("nan")
    mesh = DataMesh(world, rank, torch.device("cpu"), "gloo", "tpu_xla")
    mesh.all_reduce_mean_(opt.grad_storage)
    opt.step()
    out.update(before=before, after=opt.snapshot(),
               row0_grad_finite=bool(torch.isfinite(opt.grads[0]).all()))
elif kind == "rendezvous":
    from masters_thesis_tpu_torch.data import pipeline

    if rank != 0:
        def refuse(*args, **kwargs):
            raise AssertionError(f"rank {rank} built data")

        pipeline.SyntheticLogReturns.generate = staticmethod(refuse)
        pipeline.FinancialWindowDataModule.build_windows = refuse
    else:
        time.sleep(1.0)
    pipeline.bootstrap_synthetic(Path(job["data"]), n_stocks=4,
                                 n_samples=1200, seed=0)
    out["bootstrapped_at"] = time.time()
    dm = pipeline.FinancialWindowDataModule(Path(job["data"]),
                                            **job["windows"])
    dm.prepare_data()
    dm.setup("fit")
    out["arrays"] = [torch.as_tensor(a) for a in dm.train_arrays()]
else:
    from masters_thesis_tpu_torch.data.pipeline import FinancialWindowDataModule
    from masters_thesis_tpu_torch.models.objectives import ModelSpec

    dm = FinancialWindowDataModule(Path(job["data"]),
                                   batch_size=job["batch_size"],
                                   engine="python", **job["windows"])
    spec = ModelSpec(**job["hparams"])
    init = torch.load(job["init"])
    mesh_lib.reset_collective_counts()
    if kind == "stacked":
        from masters_thesis_tpu_torch.train.stacked import (
            ReplicaSpec,
            StackedTrainer,
        )

        class Loaded(StackedTrainer):
            def build(self, spec, replicas):
                module = super().build(spec, replicas)
                for enc, state in zip(module.replicas, init):
                    enc.load_state_dict(state)
                return module

        trainer = Loaded(max_epochs=job["epochs"], gradient_clip_val=job["clip"],
                         device="cpu", strategy="tpu_xla", n_devices=world,
                         ckpt_dir=job.get("ckpt_dir"))
        result = trainer.fit(spec, dm, [ReplicaSpec(*r) for r in job["replicas"]])
        out["replicas"] = [
            {"history": r.history, "best": r.best_val_loss, "state": r.state,
             "status": r.status} for r in result.replicas]
    else:
        from masters_thesis_tpu_torch.train.trainer import Trainer

        trainer = Trainer(max_epochs=job["epochs"], gradient_clip_val=job["clip"],
                          device="cpu", strategy="tpu_xla", n_devices=world,
                          shard_axis=job.get("shard_axis", "window"),
                          epoch_mode=job.get("epoch_mode", "scan"),
                          seed=job.get("seed", 0),
                          ckpt_dir=job.get("ckpt_dir"))
        result = trainer.fit(spec, dm, init_state=(init, None))
        out.update(history=result.history, best=result.best_val_loss,
                   state=result.state, steps=int(result.opt_state["count"]))
        out["collectives"] = dict(mesh_lib.COLLECTIVES)
        if job.get("test"):
            out["test"] = trainer.test(spec, torch.load(job["test"]), dm)
torch.save(out, out_dir / f"rank{rank}.pt")
'''


def rank_env() -> dict:
    return dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")


def launch_ranks(tmp_path: Path, world: int, job: dict) -> tuple[int, list]:
    """``RANK_MAIN`` as ``world`` ranks on ``job``: the launch's exit code
    and each rank's saved results (when it exited 0)."""
    out = tmp_path / "ranks"
    out.mkdir(exist_ok=True)
    (tmp_path / "rank_main.py").write_text(RANK_MAIN)
    (tmp_path / "job.json").write_text(json.dumps({**job, "out": str(out)}))
    code = launch_lib.launch(
        [sys.executable, str(tmp_path / "rank_main.py"),
         str(tmp_path / "job.json")], world, env=rank_env(),
        timeout_s=RANK_TIMEOUT_S, rendezvous_dir=tmp_path)
    results = ([torch.load(out / f"rank{r}.pt") for r in range(world)]
               if code == 0 else [])
    return code, results
