"""Which rank of which launch this process is, without touching a device.

Counterpart of ``multihost_rank`` in ``masters_thesis_tpu/utils/
backend_probe.py``: the data module asks it before a device is set up, so
it reads the live process group when there is one and the launch
environment (``parallel/mesh.py``'s ``JAX_PROCESS_INDEX`` and
``JAX_PROCESS_COUNT``, exported with a coordinator) before
initialisation. It imports ``torch.distributed`` only where torch is
already imported.
"""

from __future__ import annotations

import os
import sys

from masters_thesis_tpu_torch.parallel.mesh import (
    COORDINATOR_ENV,
    COUNT_ENV,
    INDEX_ENV,
)


def multihost_rank() -> tuple[int, int]:
    """``(process_index, process_count)``: the process group's rank and
    world when one is initialised, else the launch environment's, else
    ``(0, 1)``."""
    if "torch" in sys.modules:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return dist.get_rank(), dist.get_world_size()
    if os.environ.get(COORDINATOR_ENV):
        try:
            return (int(os.environ.get(INDEX_ENV, "0") or 0),
                    int(os.environ.get(COUNT_ENV, "1") or 1))
        except ValueError:
            pass
    return 0, 1
