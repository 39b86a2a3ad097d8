"""LSTM encoder with torch.nn.LSTM semantics over the port's recurrences.

Counterpart of ``masters_thesis_tpu/models/lstm.py``: a stacked LSTM over the
lookback window whose last hidden state feeds two heads, alpha
``(batch, 1)`` and beta ``(batch, n_factors)``. Parameters keep the flax
module's names and shapes — ``w_ih_l{n}`` ``(4H, in)``, ``w_hh_l{n}``
``(4H, H)``, ``b_ih_l{n}``, ``b_hh_l{n}`` ``(4H,)`` and the ``alpha_head`` /
``beta_head`` linears — so a JAX parameter tree loads one to one
(``models/convert.py``).

Per group of layers, the input projection for every time step is one
``torch.matmul`` (the JAX package leaves it to XLA likewise); the serial part
runs through ``ops/lstm_kernel.py``. Consecutive layers pair into the
wavefront kernel and a trailing odd layer runs the single-layer kernel. The
CUDA kernels are row-tiled, so every row count fits and the grouping is
simply "pairs, then one" — the JAX package's VMEM byte model has no
counterpart here.

This slice serves: the deterministic forward only. Dropout in training mode
comes with the training slice (masked pair kernel and backward kernels).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from masters_thesis_tpu_torch import resolve_device
from masters_thesis_tpu_torch.ops.lstm_kernel import (
    lstm_pair_recurrence,
    lstm_recurrence,
)


class LstmEncoder(nn.Module):
    """Stacked LSTM over ``(batch, time, features)`` with alpha/beta heads."""

    def __init__(
        self,
        input_size: int = 3,
        hidden_size: int = 64,
        num_layers: int = 2,
        dropout: float = 0.2,
        n_factors: int = 1,
        *,
        device=None,
        generator: torch.Generator | None = None,
    ):
        """Weights are drawn uniform(-1/sqrt(H), 1/sqrt(H)) on the CPU from
        ``generator`` (torch.nn.LSTM's and Linear's init), then moved to
        ``device`` (``cuda`` unless told otherwise)."""
        super().__init__()
        if num_layers < 1:
            raise ValueError(f"num_layers must be >= 1, got {num_layers}")
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.dropout = dropout
        self.n_factors = n_factors
        device = resolve_device(device)
        hidden = hidden_size
        for layer in range(num_layers):
            in_dim = input_size if layer == 0 else hidden
            self.register_parameter(
                f"w_ih_l{layer}", nn.Parameter(torch.empty(4 * hidden, in_dim))
            )
            self.register_parameter(
                f"w_hh_l{layer}", nn.Parameter(torch.empty(4 * hidden, hidden))
            )
            self.register_parameter(
                f"b_ih_l{layer}", nn.Parameter(torch.empty(4 * hidden))
            )
            self.register_parameter(
                f"b_hh_l{layer}", nn.Parameter(torch.empty(4 * hidden))
            )
        self.alpha_head = nn.Linear(hidden, 1)
        self.beta_head = nn.Linear(hidden, n_factors)
        scale = 1.0 / math.sqrt(hidden)
        with torch.no_grad():
            for p in self.parameters():
                p.uniform_(-scale, scale, generator=generator)
        self.to(device)

    def _layer(self, layer: int):
        return (
            getattr(self, f"w_ih_l{layer}"),
            getattr(self, f"w_hh_l{layer}"),
            getattr(self, f"b_ih_l{layer}"),
            getattr(self, f"b_hh_l{layer}"),
        )

    def forward(
        self, x: torch.Tensor, *, deterministic: bool = True
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Encode lookback windows into per-row (alpha, beta) estimates.

        Args:
            x: ``(batch, time, features)`` feature-expanded lookback windows.
            deterministic: must stay True when ``dropout > 0`` in this slice.

        Returns:
            ``(alpha, beta)``: ``(batch, 1)`` and ``(batch, n_factors)``.
        """
        if not deterministic and self.dropout > 0.0:
            raise NotImplementedError(
                "dropout in training mode needs the masked pair kernel, "
                "which comes with the training slice"
            )
        # Time-major throughout, the kernels' layout: (T, B, ·).
        inputs = x.transpose(0, 1)
        layer = 0
        while layer < self.num_layers:
            w_ih, w_hh, b_ih, b_hh = self._layer(layer)
            # One matmul for every time step's input projection.
            x_proj = torch.matmul(inputs, w_ih.T) + (b_ih + b_hh)  # (T, B, 4H)
            x_proj = x_proj.contiguous()
            if layer + 1 < self.num_layers:
                w_ih2, w_hh2, b_ih2, b_hh2 = self._layer(layer + 1)
                inputs = lstm_pair_recurrence(
                    x_proj,
                    w_hh.T.contiguous(),
                    w_ih2.T.contiguous(),
                    (b_ih2 + b_hh2).contiguous(),
                    w_hh2.T.contiguous(),
                )
                layer += 2
            else:
                inputs = lstm_recurrence(x_proj, w_hh.T.contiguous())
                layer += 1
        final_hidden = inputs[-1]
        return self.alpha_head(final_hidden), self.beta_head(final_hidden)
