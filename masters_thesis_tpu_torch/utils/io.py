"""Crash-safe file publishing, in one place.

Counterpart of ``masters_thesis_tpu/utils/io.py``: the dataset cache and the
checkpoints are written to a private scratch name and renamed into place, so
a reader sees the previous file or the new one, never a torn one. The
scratch name carries a uuid, so concurrent writers each use their own.
"""

from __future__ import annotations

import os
import uuid
from pathlib import Path


def publish(path: Path | str, write) -> None:
    """Write ``path`` through ``write(f)`` on a binary file object opened on
    a scratch name, then rename it onto ``path``. On an exception the
    scratch file is removed and ``path`` is untouched."""
    path = Path(path)
    tmp = path.with_name(f".{path.name}.{uuid.uuid4().hex[:12]}.tmp")
    try:
        with open(tmp, "wb") as f:
            write(f)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)
