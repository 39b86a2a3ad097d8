"""Adam over one flat parameter buffer.

Counterpart of ``FlatAdam`` in ``masters_thesis_tpu/train/flatparams.py``:
clip → L2 → Adam as one pass over a single contiguous f32 buffer. Here the
module's parameters and their gradients are views into two flat buffers
(``params`` and ``grads``), so autograd accumulates straight into the flat
gradient and the update is a handful of elementwise kernels over ~50K
floats, with no copy in or out and no host synchronisation (the clip
decision stays on the device).

Semantics, term for term as in the JAX class (and so optax's chain):

- clip by global norm: ``g / ‖g‖ · max`` when ``‖g‖ ≥ max`` (no ``+1e-6``);
- L2 decay folded into the clipped gradient: ``g + wd · p`` (torch Adam's
  ``weight_decay``, not AdamW);
- Adam moments with bias correction, ``eps`` outside the square root
  (optax's defaults ``B1``, ``B2``, ``EPS``, which every configuration uses);
- the caller's learning rate: ``p ← p − lr · update``.
"""

from __future__ import annotations

import torch
from torch import nn

B1, B2, EPS = 0.9, 0.999, 1e-8


class FlatAdam:
    """``make_optimizer``'s chain over one flat buffer of ``module``'s
    parameters (all f32, on one device)."""

    def __init__(
        self,
        module: nn.Module,
        gradient_clip_val: float | None = None,
        weight_decay: float = 0.0,
    ):
        self.gradient_clip_val = (
            float(gradient_clip_val)
            if gradient_clip_val is not None and gradient_clip_val > 0
            else None
        )
        self.weight_decay = float(weight_decay)
        named = list(module.named_parameters())
        if any(p.dtype != torch.float32 for _, p in named):
            raise TypeError("FlatAdam takes float32 parameters only")
        device = named[0][1].device
        n = sum(p.numel() for _, p in named)
        self.params = torch.empty(n, device=device)
        self.grads = torch.zeros(n, device=device)
        self.mu = torch.zeros(n, device=device)
        self.nu = torch.zeros(n, device=device)
        self.count = 0
        #: (name, offset, shape) of each parameter in the flat buffers.
        self.views: list[tuple[str, int, torch.Size]] = []
        offset = 0
        with torch.no_grad():
            for name, p in named:
                k = p.numel()
                self.params[offset:offset + k].copy_(p.reshape(-1))
                p.data = self.params[offset:offset + k].view(p.shape)
                p.grad = self.grads[offset:offset + k].view(p.shape)
                self.views.append((name, offset, p.shape))
                offset += k

    def zero_grad(self) -> None:
        """Zero the flat gradient in place; the views stay attached."""
        self.grads.zero_()

    @torch.no_grad()
    def step(self, lr: float) -> None:
        """One fused clip → L2 → Adam update of the flat buffer."""
        g = self.grads
        if self.gradient_clip_val is not None:
            max_norm = self.gradient_clip_val
            g_norm = torch.linalg.vector_norm(g)
            g = torch.where(g_norm < max_norm, g, (g / g_norm) * max_norm)
        if self.weight_decay:
            g = g + self.weight_decay * self.params
        self.mu.mul_(B1).add_((1 - B1) * g)
        self.nu.mul_(B2).add_((1 - B2) * (g * g))
        self.count += 1
        mu_hat = self.mu / (1 - B1 ** self.count)
        nu_hat = self.nu / (1 - B2 ** self.count)
        update = mu_hat / (torch.sqrt(nu_hat) + EPS)
        self.params.sub_(lr * update)

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": self.mu.clone(), "nu": self.nu.clone()}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        self.mu.copy_(state["mu"])
        self.nu.copy_(state["nu"])
