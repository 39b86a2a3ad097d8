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

The step count and the learning rate live on the device (``count_t``, an
int64, and ``lr``, an f32), and the step reads nothing from the host, so a
CUDA graph that captures it replays a correct update: the step increments
the count, the trainer fills ``lr`` between epochs (``set_lr``). The bias
corrections ``1 - B ** count`` are taken in f64 on the device and applied as
PyTorch applies a Python double divisor to an f32 tensor: on the CPU it
divides by the double rounded to f32, on the card it multiplies by the
double's reciprocal rounded to f32. So the update is bit for bit the one a
Python-scalar step gives on either device.
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
        #: Updates taken, on the device.
        self.count_t = torch.zeros((), dtype=torch.int64, device=device)
        #: The learning rate the next update applies, on the device.
        self.lr = torch.zeros((), device=device)
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

    @property
    def count(self) -> int:
        """Updates taken (reads the device)."""
        return int(self.count_t)

    def set_lr(self, lr: float) -> None:
        """The learning rate of the updates from now on (a device fill)."""
        self.lr.fill_(lr)

    @torch.no_grad()
    def step(self, lr: float | None = None) -> None:
        """One fused clip → L2 → Adam update of the flat buffer, at ``lr``
        when given (it stays the rate), else at the rate ``set_lr`` gave."""
        if lr is not None:
            self.set_lr(lr)
        g = self.grads
        if self.gradient_clip_val is not None:
            max_norm = self.gradient_clip_val
            g_norm = torch.linalg.vector_norm(g)
            g = torch.where(g_norm < max_norm, g, (g / g_norm) * max_norm)
        if self.weight_decay:
            g = g + self.weight_decay * self.params
        self.mu.mul_(B1).add_((1 - B1) * g)
        self.nu.mul_(B2).add_((1 - B2) * (g * g))
        self.count_t.add_(1)
        count = self.count_t.double()
        mu_hat = _divide(self.mu, 1 - torch.pow(B1, count))
        nu_hat = _divide(self.nu, 1 - torch.pow(B2, count))
        update = mu_hat / (torch.sqrt(nu_hat) + EPS)
        self.params.sub_(update * self.lr)

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": self.mu.clone(), "nu": self.nu.clone()}

    def load_state_dict(self, state: dict) -> None:
        self.count_t.fill_(int(state["count"]))
        self.mu.copy_(state["mu"])
        self.nu.copy_(state["nu"])


def _divide(t: torch.Tensor, divisor: torch.Tensor) -> torch.Tensor:
    """``t / divisor`` for an f64 0-dim ``divisor`` on ``t``'s device, as
    PyTorch computes ``t / d`` for a Python double ``d``: on the card as
    ``t * float(1 / d)`` (its kernel's reciprocal of a host scalar), on the
    CPU as ``t / float(d)``."""
    if t.device.type == "cuda":
        return t * (1 / divisor).float()
    return t / divisor.float()
