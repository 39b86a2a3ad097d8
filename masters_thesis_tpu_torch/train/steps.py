"""Step functions: the encoder applied to a window batch.

Counterpart of ``forward_rows`` in ``masters_thesis_tpu/train/steps.py``; the
epoch and evaluation programs come with the training slice.
"""

from __future__ import annotations

import torch


def forward_rows(module, x: torch.Tensor):
    """Apply the encoder to a window batch, deterministically:
    ``(B, K, T, F) -> (B, K, 1)`` alpha and ``(B, K, n_factors)`` beta.

    Flattens (batch, stocks) into rows like the reference's ``flatten(0, 1)``.
    The row-tiled kernels need no window boundaries, so unlike the JAX
    function there is no ``window_rows``.
    """
    b, k = x.shape[:2]
    alpha, beta = module(x.reshape(b * k, *x.shape[2:]), deterministic=True)
    return alpha.reshape(b, k, 1), beta.reshape(b, k, -1)
