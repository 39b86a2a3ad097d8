"""Run logs: the history rows, the test metrics and the final hparams.

Counterpart of ``masters_thesis_tpu/train/logging.py``, with its directory
layout, ``<save_dir>/<name>/<version>/`` (checkpoints under
``checkpoints/`` inside), and its tags: ``loss/<metric>/<split>``,
``lr-Adam``, ``test/<metric>``. Every record is appended as one JSON line to
``<log_dir>/metrics.jsonl``: ``{"step": N, <tag>: value, ...}`` for scalars,
``{"hparams": {...}, "metrics": {...}}`` for the final table. The same
scalars also go to TensorBoard where ``tensorboardX`` imports; where it does
not, the logger warns once and the JSON lines are the whole record.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import Any

METRICS_FILE = "metrics.jsonl"


class RunLogger:
    """Scalars and hparams under ``<save_dir>/<name>/<version>``."""

    def __init__(self, save_dir: str | Path, name: str, version: str):
        self.log_dir = Path(save_dir) / name / version
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._writer = None
        self._tb_missing = False

    @property
    def writer(self):
        """The lazy SummaryWriter, or None (warned once) when tensorboardX
        is not installed."""
        if self._writer is None and not self._tb_missing:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                self._tb_missing = True
                print("masters_thesis_tpu_torch: tensorboardX is not "
                      "installed — TensorBoard logging disabled "
                      f"({METRICS_FILE} is still written)", file=sys.stderr)
                return None
            self._writer = SummaryWriter(logdir=str(self.log_dir))
        return self._writer

    def _append(self, record: dict) -> None:
        with open(self.log_dir / METRICS_FILE, "a") as f:
            f.write(json.dumps(record) + "\n")

    def log_scalars(self, scalars: dict[str, float], step: int) -> None:
        self._append({"step": int(step),
                      **{k: float(v) for k, v in scalars.items()}})
        w = self.writer
        if w is not None:
            for tag, value in scalars.items():
                w.add_scalar(tag, float(value), step)
            w.flush()

    def log_hparams(self, hparams: dict[str, Any],
                    metrics: dict[str, float]) -> None:
        """Final hparams + metrics table."""
        clean = {k: (v if isinstance(v, (int, float, str, bool)) else str(v))
                 for k, v in hparams.items() if v is not None}
        metrics = {k: float(v) for k, v in metrics.items()}
        self._append({"hparams": clean, "metrics": metrics})
        w = self.writer
        if w is not None:
            w.add_hparams(clean, metrics)
            w.flush()

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None


def read_records(log_dir: str | Path) -> list[dict]:
    """The JSON records of ``<log_dir>/metrics.jsonl``, in order."""
    path = Path(log_dir) / METRICS_FILE
    return [json.loads(line) for line in path.read_text().splitlines() if line]
