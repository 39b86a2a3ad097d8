"""Crash-safe file publishing, in one place.

Counterpart of ``masters_thesis_tpu/utils/io.py``: the dataset cache and the
checkpoints are written to a private scratch name, flushed to stable storage
and renamed into place, so a reader sees the previous file or the new one,
never a torn one. The scratch name carries a uuid, so concurrent writers
each use their own. ``wait_until`` is the polling half of the multi-process
rendezvous: a rank that does not write waits for the writer's published
file.
"""

from __future__ import annotations

import os
import time
import uuid
from pathlib import Path


def publish(path: Path | str, write) -> None:
    """Write ``path`` through ``write(f)`` on a binary file object opened on
    a scratch name, fsync it, then rename it onto ``path``. On an exception
    the scratch file is removed and ``path`` is untouched."""
    path = Path(path)
    tmp = path.with_name(f".{path.name}.{uuid.uuid4().hex[:12]}.tmp")
    try:
        with open(tmp, "wb") as f:
            write(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)


def atomic_write_text(path: Path | str, text: str, fsync: bool = False) -> None:
    """Publish ``text`` at ``path``; with ``fsync`` the directory entry is
    flushed too, so the rename itself survives a power cut (what a
    checkpoint's manifest and sidecar need)."""
    path = Path(path)
    publish(path, lambda f: f.write(text.encode()))
    if fsync:
        fsync_path(path.parent)


def fsync_path(path: Path | str) -> None:
    """fsync a file or directory, best effort (not every filesystem lets a
    directory be opened, and a failed flush must not fail the publish)."""
    try:
        fd = os.open(str(path), os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def wait_until(predicate, timeout_s: float, interval_s: float = 0.5) -> bool:
    """Poll ``predicate`` until it returns True; False on timeout (a rank
    waiting for another rank's published file)."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval_s)
    return False
