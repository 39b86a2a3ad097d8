"""Checkpoints of the port: ``best`` and ``last``.

Counterpart of ``save_checkpoint`` / ``restore_checkpoint`` /
``apply_datamodule_sidecar`` in ``masters_thesis_tpu/train/checkpoint.py``
with the port's own format: one ``<ckpt_dir>/<tag>.pt`` file (``torch.save``
of the encoder's state dict on the CPU, the FlatAdam state, the scheduler
state, the ``ModelSpec`` fields and the metadata) beside a ``<tag>.json``
sidecar holding everything but the tensors, for people and tools. The spec
in the file is what lets a driver rebuild the model from the checkpoint
alone. Each file is published atomically (``utils/io.py``), so a reader
sees the previous checkpoint or the new one, never a torn file. Orbax, the
manifest with its digests, ``.prev`` rotation and the quality fingerprint
are not ported; a JAX package (orbax) checkpoint is refused by name.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import torch

from masters_thesis_tpu_torch.models.objectives import ModelSpec
from masters_thesis_tpu_torch.utils.io import publish


def save_checkpoint(ckpt_dir, tag: str, state_dict: dict,
                    opt_state: dict | None = None,
                    scheduler_state: dict | None = None,
                    meta: dict | None = None,
                    spec: ModelSpec | None = None) -> Path:
    """Write ``<ckpt_dir>/<tag>.pt`` and its ``<tag>.json`` sidecar."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)

    def cpu(value):
        return value.detach().cpu().clone() if torch.is_tensor(value) else value

    sidecar = {
        "spec": None if spec is None else dataclasses.asdict(spec),
        "scheduler": scheduler_state,
        "meta": meta or {},
    }
    payload = {
        "state_dict": {k: cpu(v) for k, v in state_dict.items()},
        "opt_state": None if opt_state is None
        else {k: cpu(v) for k, v in opt_state.items()},
        **sidecar,
    }
    path = ckpt_dir / f"{tag}.pt"
    publish(path, lambda f: torch.save(payload, f))
    publish(ckpt_dir / f"{tag}.json",
            lambda f: f.write(json.dumps(sidecar, indent=2).encode()))
    return path


def load_checkpoint(ckpt_dir, tag: str):
    """``(state_dict, opt_state, scheduler_state, meta)`` of a checkpoint,
    tensors on the CPU."""
    payload = torch.load(Path(ckpt_dir) / f"{tag}.pt", map_location="cpu",
                         weights_only=True)
    return (payload["state_dict"], payload["opt_state"], payload["scheduler"],
            payload["meta"])


def _locate(path: Path, tag: str) -> tuple[Path, str]:
    """``(checkpoint root, tag)`` of a root directory (which picks ``tag``),
    a tag path (``<root>/best``) or a file (``<root>/best.pt``)."""
    if path.suffix == ".pt" and path.is_file():
        return path.parent, path.stem
    if (path / f"{tag}.pt").is_file():
        return path, tag
    if (path.parent / f"{path.name}.pt").is_file():
        return path.parent, path.name
    # The JAX package's layout: <root>/<tag>/ an orbax tree beside
    # <root>/<tag>.json.
    for tree in (path / tag, path):
        if tree.is_dir() and (tree.parent / f"{tree.name}.json").is_file():
            raise ValueError(
                f"{tree} is an orbax checkpoint of the JAX package "
                "(masters_thesis_tpu); the port reads only its own format, "
                f"'<checkpoints>/<tag>.pt' files written by "
                "masters_thesis_tpu_torch"
            )
    raise FileNotFoundError(f"no checkpoint at {path} (looked for "
                            f"{path / f'{tag}.pt'} and {path}.pt)")


def restore_checkpoint(path, tag: str = "best"):
    """``(state_dict, opt_state, spec, meta)`` of a checkpoint.

    ``path`` is the checkpoint root (``<log_dir>/checkpoints``, which picks
    ``tag``) or a direct tag path (``.../checkpoints/best``, with or without
    ``.pt``), as the JAX function takes either. ``meta`` carries the
    scheduler state under ``"scheduler"``. Tensors are on the CPU.
    """
    root, name = _locate(Path(path), tag)
    payload = torch.load(root / f"{name}.pt", map_location="cpu",
                         weights_only=True)
    if payload.get("spec") is None:
        raise ValueError(f"{root / name}.pt holds no model spec; it was not "
                         "written by the port's Trainer")
    meta = dict(payload["meta"], scheduler=payload["scheduler"])
    return (payload["state_dict"], payload["opt_state"],
            ModelSpec(**payload["spec"]), meta)


def apply_datamodule_sidecar(cfg, meta: dict) -> None:
    """Overwrite cfg.datamodule's window hparams from a checkpoint's meta.

    Evaluation must window the data exactly the way the checkpoint was
    trained (lookback/target/stride/...); ``data_dir`` and ``engine`` stay
    config-driven — they are environment-, not model-specific.
    """
    for key, value in meta.get("datamodule", {}).items():
        if key in cfg.datamodule:
            cfg.datamodule[key] = value
