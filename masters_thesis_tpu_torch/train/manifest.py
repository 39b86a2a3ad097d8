"""Checkpoint content manifests: sha256 and size of every file of a tree.

Counterpart of ``masters_thesis_tpu/train/manifest.py``, with the same
schema (``{"algo": "sha256", "files": {rel: {"sha256", "size"}}}``) and
the same semantics, so either package's ``verify_checkpoint`` reads the
other's trees. The manifest is written INSIDE the checkpoint tree, so it
rides the publish renames with the data it describes. Hashing and json
only.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

from masters_thesis_tpu_torch.utils.io import atomic_write_text

#: The manifest's file name inside a checkpoint tree.
MANIFEST_NAME = "MANIFEST.json"


def write_manifest(tree: Path) -> None:
    """Write ``MANIFEST.json`` (sha256 + size a file) into ``tree``, fsync'd
    so the checksums are durable before the publish rename."""
    files = {}
    for p in sorted(Path(tree).rglob("*")):
        if p.is_file() and p.name != MANIFEST_NAME:
            files[str(p.relative_to(tree))] = {
                "sha256": hashlib.sha256(p.read_bytes()).hexdigest(),
                "size": p.stat().st_size,
            }
    atomic_write_text(Path(tree) / MANIFEST_NAME,
                      json.dumps({"algo": "sha256", "files": files}, indent=2),
                      fsync=True)


def verify_checkpoint(path: Path, require_manifest: bool = False) -> bool:
    """Check a checkpoint tree against its content manifest.

    A tree without a manifest (a pre-manifest checkpoint) verifies when
    lenient, the training restore's rule, and fails with
    ``require_manifest=True``, serving's rule: nothing unproven is served.
    A manifest whose files are missing, truncated or mismatched fails
    either way.
    """
    path = Path(path)
    manifest_path = path / MANIFEST_NAME
    if not manifest_path.exists():
        return path.exists() and not require_manifest
    try:
        manifest = json.loads(manifest_path.read_text())
        for rel, want in manifest["files"].items():
            p = path / rel
            if not p.is_file() or p.stat().st_size != want["size"]:
                return False
            if hashlib.sha256(p.read_bytes()).hexdigest() != want["sha256"]:
                return False
    except (OSError, ValueError, KeyError, TypeError):
        return False
    return True


def last_verified_checkpoint(ckpt_dir: Path | str | None,
                             tag: str = "last") -> str | None:
    """The newest verified restore point under ``ckpt_dir``: ``<tag>`` if
    its (tree, sidecar) pair is complete and verifies, else the
    ``<tag>.prev`` rotation, else ``None``. Filesystem and hashing only;
    the restore (which also finishes an interrupted publish) decides what
    actually loads."""
    if ckpt_dir is None:
        return None
    ckpt_dir = Path(ckpt_dir)
    for name in (tag, f"{tag}.prev"):
        tree = ckpt_dir / name
        sidecar = ckpt_dir / f"{name}.json"
        if tree.is_dir() and sidecar.is_file() and verify_checkpoint(tree):
            return str(tree)
    return None
