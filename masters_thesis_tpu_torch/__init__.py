"""masters_thesis_tpu_torch — the factor-model framework in PyTorch and CUDA.

The same system as ``masters_thesis_tpu`` (an LSTM encoder estimating
per-stock alpha/beta from lookback windows of returns), written for an NVIDIA
Hopper card. Module names mirror the JAX package so each part's counterpart is
easy to find:

- ``ops``    — the LSTM recurrences forward and backward (hand-written CUDA
               kernels for ``sm_90a`` plus their plain PyTorch versions),
               the window functions, OLS and the losses
- ``data``   — the synthetic data-generating processes (numpy) and the
               windowed data module (bootstrap, cache, 70/20/10 split)
- ``models`` — the ``LstmEncoder`` module, the window objectives,
               ``ModelSpec`` and the weight converter from the JAX
               package's parameter tree
- ``train``  — the step functions, ``FlatAdam``, the plateau scheduler,
               checkpoints and the ``Trainer``
- ``serve``  — the micro-batching queue, ``PredictEngine``,
               ``PredictServer``, the canaried hot-swap, the preflight
               and the ``python -m masters_thesis_tpu_torch.serve`` CLI
- ``telemetry`` — the event log, metrics registry, request spans and the
               ``/metrics`` endpoint (stdlib only)

The package imports ``torch`` and numpy only, and this module imports
neither, so the torch-free serving selfcheck can import the package. Entry
points run on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

__version__ = "0.1.0"


def resolve_device(device=None) -> "torch.device":
    """The device an entry point runs on: ``cuda`` unless told otherwise.

    Raises when CUDA is asked for (explicitly or by default) and absent —
    the port never carries on on the CPU by itself; a caller that wants the
    CPU passes ``device="cpu"``.
    """
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: expected cuda or cpu")
    return dev
