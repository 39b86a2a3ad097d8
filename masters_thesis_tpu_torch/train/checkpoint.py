"""Checkpoints of the port: ``best`` and ``last``, published crash-safely.

Counterpart of ``masters_thesis_tpu/train/checkpoint.py``, with its layout
and its publish protocol around the port's own payload::

    <ckpt_dir>/
      best/  last/           # state.pt (+ quality.json) + MANIFEST.json
                             # (sha256 a file)
      best.json  last.json   # the sidecar: spec, scheduler, meta
      last.prev/ + last.prev.json   # the previous good save (fallback)

``state.pt`` is ``torch.save`` of the encoder's state dict on the CPU, the
FlatAdam state, the scheduler state, the ``ModelSpec`` fields and the
metadata; the sidecar holds everything but the tensors, for people and
tools. The spec in the file is what lets a driver rebuild the model from
the checkpoint alone. A save stages the pair (``<tag>.new/``,
``<tag>.json.new``) and publishes it by renames only, rotating the
outgoing pair to ``<tag>.prev``; a kill at any point leaves the previous
checkpoint intact or a staged pair that the next restore finishes. A
restore verifies the tree against its manifest and falls back to
``.prev`` (saying so on stderr) when the latest fails; it raises
:class:`CorruptCheckpointError` when nothing verifies.

A checkpoint of the port before the tree layout (a bare ``<tag>.pt``
beside ``<tag>.json``) restores as a pre-manifest checkpoint, which the
lenient rule trusts and the strict one (serving) refuses. An orbax tree
of the JAX package (a ``<tag>/`` without ``state.pt``) is refused by name.
``extra_files`` (the trainer's ``quality.json`` fingerprint) are written
into the staged tree before its manifest, so the manifest covers them, they
rotate to ``.prev`` with the pair, and a torn or doctored copy fails
verification as a torn ``state.pt`` does.

Across the ranks of a data-parallel launch (a shared checkpoint
directory, as orbax assumes) rank 0 alone stages and publishes, and every
rank then passes ``fleet_barrier("checkpoint.publish.<tag>")``, so no rank
races ahead of a publish still under way. Recovery is rank 0's too; the
others wait for the staged pair to go and pass
``fleet_barrier("checkpoint.recover.<tag>")``, so every rank restores the
same file. Outside a launch the barriers do nothing.
"""

from __future__ import annotations

import dataclasses
import json
import random
import shutil
import sys
from pathlib import Path

import torch

from masters_thesis_tpu_torch.models.objectives import ModelSpec
from masters_thesis_tpu_torch.parallel.mesh import fleet_barrier
from masters_thesis_tpu_torch.resilience import faults
from masters_thesis_tpu_torch.train.manifest import (
    MANIFEST_NAME,
    verify_checkpoint,
    write_manifest,
)
from masters_thesis_tpu_torch.utils.backend_probe import multihost_rank
from masters_thesis_tpu_torch.utils.io import (
    atomic_write_text,
    fsync_path,
    publish,
    wait_until,
)

#: The payload's file name inside a checkpoint tree.
STATE_NAME = "state.pt"


class CorruptCheckpointError(RuntimeError):
    """No restorable checkpoint: the latest (and any previous-good
    fallback) failed content verification."""


def save_checkpoint(ckpt_dir, tag: str, state_dict: dict,
                    opt_state: dict | None = None,
                    scheduler_state: dict | None = None,
                    meta: dict | None = None,
                    spec: ModelSpec | None = None,
                    extra_files: dict[str, str] | None = None) -> Path:
    """Publish ``<ckpt_dir>/<tag>/`` (``state.pt``, the ``extra_files``
    (name -> text) and its manifest) and the ``<tag>.json`` sidecar;
    returns the tree's path.

    The order: the staged sidecar is cleared before the staged tree (a
    kill in between leaves an orphan tree, which recovery drops, never an
    orphan sidecar that could pair with another save's tree); then the
    tree, its manifest (fsync'd), the staged sidecar (fsync'd), and the
    publish (renames only). In a launch only rank 0 writes; every rank
    passes the publish barrier.
    """
    ckpt_dir = Path(ckpt_dir).resolve()
    if multihost_rank()[0] == 0:
        _write_and_publish(ckpt_dir, tag, state_dict, opt_state,
                           scheduler_state, meta, spec, extra_files)
    fleet_barrier(f"checkpoint.publish.{tag}")
    return ckpt_dir / tag


def _write_and_publish(ckpt_dir: Path, tag: str, state_dict: dict,
                       opt_state: dict | None, scheduler_state: dict | None,
                       meta: dict | None, spec: ModelSpec | None,
                       extra_files: dict[str, str] | None) -> None:
    """Rank 0's part of :func:`save_checkpoint`: stage the tree and its
    sidecar, then publish them."""
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    staging = ckpt_dir / f"{tag}.new"
    staged_sidecar = ckpt_dir / f"{tag}.json.new"
    staged_sidecar.unlink(missing_ok=True)
    if staging.exists():
        shutil.rmtree(staging)
    staging.mkdir()

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
    publish(staging / STATE_NAME, lambda f: torch.save(payload, f))
    for name, text in (extra_files or {}).items():
        target = staging / name
        target.write_text(text)
        fsync_path(target)
    write_manifest(staging)
    atomic_write_text(staged_sidecar, json.dumps(sidecar, indent=2), fsync=True)
    # The fault points' context: the tag, as in the JAX package, and the
    # epoch of the save, which a plan may match to pick one save.
    ctx = {"tag": tag, "epoch": sidecar["meta"].get("epoch")}
    faults.fire("checkpoint.pre_publish", **ctx)
    _publish(ckpt_dir, tag, ctx)
    if faults.fire("checkpoint.post_publish", **ctx) == "corrupt":
        _corrupt_tree(ckpt_dir / tag, seed=faults.corruption_seed())


def _corrupt_tree(path: Path, seed: int) -> None:
    """Flip one byte, chosen by ``seed``, in the largest data file of a
    tree (the ``corrupt`` fault)."""
    files = sorted(
        (p for p in Path(path).rglob("*")
         if p.is_file() and p.name != MANIFEST_NAME),
        key=lambda p: (-p.stat().st_size, str(p)),
    )
    if not files:
        return
    data = bytearray(files[0].read_bytes())
    if not data:
        return
    data[random.Random(seed).randrange(len(data))] ^= 0xFF
    files[0].write_bytes(bytes(data))


def _publish(ckpt_dir: Path, tag: str, ctx: dict | None = None) -> None:
    """Swap a complete staged pair into place, by renames only; shared by
    ``save_checkpoint`` and recovery so the order cannot diverge. The
    outgoing pair rotates to ``<tag>.prev`` (the restore's fallback). The
    directory is fsync'd after the rotation and after the swap, so the
    order of the renames is what reaches stable storage. ``ctx`` is the
    mid-publish fault point's context (the tag alone in recovery)."""
    path = ckpt_dir / tag
    prev = ckpt_dir / f"{tag}.prev"
    prev_sidecar = ckpt_dir / f"{tag}.prev.json"
    if path.exists():
        if prev.exists():
            shutil.rmtree(prev)
        prev_sidecar.unlink(missing_ok=True)
        path.rename(prev)
        sidecar = ckpt_dir / f"{tag}.json"
        if sidecar.exists():
            sidecar.replace(prev_sidecar)
        fsync_path(ckpt_dir)
    # The most exposed instant: the old pair is aside, the staged tree not
    # yet live. A kill here must leave .prev restorable and the staged
    # pair whole for recovery.
    faults.fire("checkpoint.mid_publish", **(ctx or {"tag": tag}))
    (ckpt_dir / f"{tag}.new").rename(path)
    (ckpt_dir / f"{tag}.json.new").replace(ckpt_dir / f"{tag}.json")
    fsync_path(ckpt_dir)


def _recover_staged(ckpt_dir: Path, tag: str) -> None:
    """Finish (or discard) an interrupted publish.

    A staged PAIR (tree and sidecar) supersedes what is in place and is
    swapped in; a staged tree without its sidecar predates the publish, so
    the previous checkpoint is current and the orphan is dropped; a staged
    sidecar alone means the tree swap finished and only the sidecar's
    rename was lost. The staged tree is complete once it exists with its
    sidecar: the sidecar is staged after the tree and its manifest.
    """
    path = ckpt_dir / tag
    old = ckpt_dir / f"{tag}.old"
    staging = ckpt_dir / f"{tag}.new"
    staged_sidecar = ckpt_dir / f"{tag}.json.new"
    if staging.exists() or staged_sidecar.exists():
        # The torn layout, as a relaunch found it.
        names = sorted(p.name for p in ckpt_dir.iterdir())
        print(f"[checkpoint] interrupted publish of {path}: found "
              f"{' '.join(names)}; recovering", file=sys.stderr, flush=True)
    if staging.exists():
        if staged_sidecar.exists():
            _publish(ckpt_dir, tag)
        else:
            shutil.rmtree(staging)
    elif staged_sidecar.exists():
        staged_sidecar.replace(ckpt_dir / f"{tag}.json")
    if old.exists() and path.exists():
        shutil.rmtree(old, ignore_errors=True)


def _run_recovery(ckpt_dir: Path, tag: str) -> None:
    """``_recover_staged`` on rank 0; every other rank waits for the
    staged pair to go, then all pass the recovery barrier, so no rank
    reads the tree before rank 0's recovery is done (one process: just
    the recovery)."""
    staging = ckpt_dir / f"{tag}.new"
    staged_sidecar = ckpt_dir / f"{tag}.json.new"
    if multihost_rank()[0] == 0:
        _recover_staged(ckpt_dir, tag)
    elif staging.exists() or staged_sidecar.exists():
        wait_until(lambda: not staging.exists()
                   and not staged_sidecar.exists(), 60.0)
    fleet_barrier(f"checkpoint.recover.{tag}")


def _candidates(ckpt_dir: Path, tag: str) -> list[tuple[Path, Path]]:
    """(tree, sidecar) pairs in restore order: the latest, then the
    previous good rotation."""
    return [
        (ckpt_dir / tag, ckpt_dir / f"{tag}.json"),
        (ckpt_dir / f"{tag}.prev", ckpt_dir / f"{tag}.prev.json"),
    ]


def _pick_restorable(ckpt_dir: Path, tag: str) -> tuple[Path, Path] | None:
    for tree, sidecar in _candidates(ckpt_dir, tag):
        if tree.exists() and sidecar.exists() and verify_checkpoint(tree):
            return tree, sidecar
    return None


def _has_tree(root: Path, name: str) -> bool:
    return any((root / n).exists() for n in (name, f"{name}.new", f"{name}.prev"))


def _is_legacy(root: Path, name: str) -> bool:
    """A pre-manifest checkpoint of the port: ``<name>.pt`` and no tree."""
    return (root / f"{name}.pt").is_file() and not _has_tree(root, name)


def _locate(path: Path, tag: str) -> tuple[Path, str]:
    """``(checkpoint root, tag)`` of a root directory (which picks ``tag``),
    a tag path (``<root>/best``) or a pre-manifest file
    (``<root>/best.pt``)."""
    if path.suffix == ".pt" and path.is_file():
        return path.parent, path.stem
    for root, name in ((path, tag), (path.parent, path.name)):
        if _has_tree(root, name):
            tree = root / name
            if (tree.is_dir() and not (tree / STATE_NAME).exists()
                    and (root / f"{name}.json").is_file()):
                raise ValueError(
                    f"{tree} is an orbax checkpoint of the JAX package "
                    "(masters_thesis_tpu); the port reads only its own "
                    f"format, '<checkpoints>/<tag>/{STATE_NAME}' trees "
                    "written by masters_thesis_tpu_torch"
                )
            return root, name
        if _is_legacy(root, name):
            return root, name
    raise FileNotFoundError(f"no checkpoint at {path} (looked for "
                            f"{path / tag} and {path})")


def checkpoint_restorable(ckpt_dir, tag: str) -> bool:
    """True if ``<ckpt_dir>/<tag>``, or its ``.prev`` rotation, verifies
    and can be restored, after finishing any interrupted publish; a
    pre-manifest ``<tag>.pt`` counts (lenient)."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return False
    if _is_legacy(ckpt_dir, tag):
        return True
    _run_recovery(ckpt_dir, tag)
    return _pick_restorable(ckpt_dir, tag) is not None


def _read(path, tag: str) -> dict:
    """The payload of the checkpoint ``path`` names (see
    ``restore_checkpoint``), after finishing any interrupted publish and
    verifying the tree, falling back to ``.prev``."""
    root, name = _locate(Path(path).resolve(), tag)
    if _is_legacy(root, name):
        source = root / f"{name}.pt"
    else:
        _run_recovery(root, name)
        chosen = _pick_restorable(root, name)
        if chosen is None:
            primary, primary_sidecar = _candidates(root, name)[0]
            if primary.exists() and primary_sidecar.exists():
                raise CorruptCheckpointError(
                    f"checkpoint {primary} failed content verification and "
                    f"no previous-good fallback ({primary}.prev) is "
                    "restorable"
                )
            raise FileNotFoundError(f"no checkpoint at {primary}")
        tree = chosen[0]
        if tree.name.endswith(".prev"):
            print(f"[checkpoint] latest {root / name} failed verification; "
                  f"restoring previous good {tree}", file=sys.stderr,
                  flush=True)
        source = tree / STATE_NAME
    return torch.load(source, map_location="cpu", weights_only=True)


def restore_checkpoint(path, tag: str = "best"):
    """``(state_dict, opt_state, spec, meta)`` of a checkpoint.

    ``path`` is the checkpoint root (``<log_dir>/checkpoints``, which picks
    ``tag``) or a direct tag path (``.../checkpoints/best``), as the JAX
    function takes either, or a pre-manifest ``.pt`` file. An interrupted
    publish is finished first; a latest tree that fails its manifest
    falls back to ``.prev``. ``meta`` carries the scheduler state under
    ``"scheduler"``. Tensors are on the CPU.
    """
    payload = _read(path, tag)
    if payload.get("spec") is None:
        raise ValueError(f"the checkpoint at {path} holds no model spec; it "
                         "was not written by the port's Trainer")
    meta = dict(payload["meta"], scheduler=payload["scheduler"])
    return (payload["state_dict"], payload["opt_state"],
            ModelSpec(**payload["spec"]), meta)


def load_checkpoint(ckpt_dir, tag: str):
    """``(state_dict, opt_state, scheduler_state, meta)`` of a checkpoint,
    read as ``restore_checkpoint`` reads it, tensors on the CPU."""
    payload = _read(ckpt_dir, tag)
    return (payload["state_dict"], payload["opt_state"], payload["scheduler"],
            payload["meta"])


def apply_datamodule_sidecar(cfg, meta: dict) -> None:
    """Overwrite cfg.datamodule's window hparams from a checkpoint's meta.

    Evaluation must window the data exactly the way the checkpoint was
    trained (lookback/target/stride/...); ``data_dir`` and ``engine`` stay
    config-driven — they are environment-, not model-specific.
    """
    for key, value in meta.get("datamodule", {}).items():
        if key in cfg.datamodule:
            cfg.datamodule[key] = value
