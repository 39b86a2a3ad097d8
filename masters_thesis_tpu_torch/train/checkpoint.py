"""Checkpoints of the port: ``best`` and ``last``.

Counterpart of ``save_checkpoint`` / ``restore_checkpoint`` in
``masters_thesis_tpu/train/checkpoint.py`` with the port's own format: one
``<ckpt_dir>/<tag>.pt`` file (``torch.save`` of the encoder's state dict on
the CPU, the FlatAdam state, the scheduler state and the metadata) beside a
``<tag>.json`` sidecar holding the metadata for people and tools. Each file
is published atomically (``utils/io.py``), so a reader sees the previous
checkpoint or the new one, never a torn file. Orbax, the manifest with its
digests, ``.prev`` rotation and the quality fingerprint are not ported.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from masters_thesis_tpu_torch.utils.io import publish


def save_checkpoint(ckpt_dir, tag: str, state_dict: dict,
                    opt_state: dict | None = None,
                    scheduler_state: dict | None = None,
                    meta: dict | None = None) -> Path:
    """Write ``<ckpt_dir>/<tag>.pt`` and its ``<tag>.json`` sidecar."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)

    def cpu(value):
        return value.detach().cpu().clone() if torch.is_tensor(value) else value

    payload = {
        "state_dict": {k: cpu(v) for k, v in state_dict.items()},
        "opt_state": None if opt_state is None
        else {k: cpu(v) for k, v in opt_state.items()},
        "scheduler": scheduler_state,
        "meta": meta or {},
    }
    path = ckpt_dir / f"{tag}.pt"
    publish(path, lambda f: torch.save(payload, f))
    publish(ckpt_dir / f"{tag}.json",
            lambda f: f.write(json.dumps(payload["meta"], indent=2).encode()))
    return path


def load_checkpoint(ckpt_dir, tag: str):
    """``(state_dict, opt_state, scheduler_state, meta)`` of a checkpoint,
    tensors on the CPU."""
    payload = torch.load(Path(ckpt_dir) / f"{tag}.pt", map_location="cpu",
                         weights_only=True)
    return (payload["state_dict"], payload["opt_state"], payload["scheduler"],
            payload["meta"])
