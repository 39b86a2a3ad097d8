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

``StackedFlatAdam`` is the same chain over R replicas' ``[R, n]`` buffers
(the counterpart of ``vmap`` over ``FlatAdam.update_flat`` in the JAX
stacked epoch): per-replica clip norm, count and learning rate, each row's
update bit for bit the solo ``FlatAdam``'s on that row's inputs. The
helpers below it (``stack_flat`` ... ``stacked_size_bytes``) are the JAX
module's seams between R solo states and one stacked state.
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
        count = self.count_t.double()  # mtt: disable=TL104 -- the bias-correction scalar in f64, as the eager step's Python double; rounded to f32 before it touches a buffer
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


class StackedFlatAdam:
    """``FlatAdam`` over R replica modules of one architecture, their
    parameters and gradients views into rows of ``[R, n]`` buffers (row r
    is module r's, laid out as the solo ``FlatAdam`` lays it out).

    Per replica: the clip norm (each row's own ``vector_norm``, the solo
    reduction over ``[n]``, so the clip factor is the solo one to the last
    bit), the step count ``count_t [R]`` and the rate ``lr [R]``, both on
    the device. ``active [R]`` marks the replicas that train: a masked row
    (the stacked trainer's divergence policy) keeps its parameters, moments
    and count exactly, whatever its gradient holds, where the JAX update
    ``p - 0 * u`` turns a non-finite ``u`` into NaN. The step reads nothing
    from the host, so a CUDA graph captures it.

    The rows of ``params`` and ``grads`` start ``ROW_ALIGN`` floats apart
    (the allocator's 512-byte alignment), so that replica r's parameter
    views sit at the solo buffer's alignments: cuBLAS picks its kernels by
    the operands' alignment too, and a product on a view 8 bytes off the
    solo one's parted from it in its last bits on the card.
    """

    #: Floats between the starts of two rows (512 bytes).
    ROW_ALIGN = 128

    def __init__(self, modules, gradient_clip_val: float | None = None,
                 weight_decay: float = 0.0):
        self.gradient_clip_val = (
            float(gradient_clip_val)
            if gradient_clip_val is not None and gradient_clip_val > 0
            else None
        )
        self.weight_decay = float(weight_decay)
        named = [list(m.named_parameters()) for m in modules]
        layout = [(name, p.shape, p.dtype) for name, p in named[0]]
        for r, params in enumerate(named):
            if [(name, p.shape, p.dtype) for name, p in params] != layout:
                raise ValueError(f"replica {r}'s parameters differ from "
                                 "replica 0's: a stack takes one architecture")
        if any(dtype != torch.float32 for _, _, dtype in layout):
            raise TypeError("StackedFlatAdam takes float32 parameters only")
        device = named[0][0][1].device
        n = sum(p.numel() for _, p in named[0])
        self.replicas = len(modules)
        shape = (self.replicas, n)
        stride = -(-n // self.ROW_ALIGN) * self.ROW_ALIGN
        self.params = torch.zeros((self.replicas, stride), device=device)[:, :n]
        #: The gradient rows with their padding: one contiguous buffer, the
        #: one a data-parallel step all-reduces.
        self.grad_storage = torch.zeros((self.replicas, stride), device=device)
        self.grads = self.grad_storage[:, :n]
        self.mu = torch.zeros(shape, device=device)
        self.nu = torch.zeros(shape, device=device)
        #: Updates each replica has taken, on the device.
        self.count_t = torch.zeros(self.replicas, dtype=torch.int64,
                                   device=device)
        #: Each replica's rate for the next update, on the device.
        self.lr = torch.zeros(self.replicas, device=device)
        #: The replicas that train; a masked row stays as it is.
        self.active = torch.ones(self.replicas, dtype=torch.bool, device=device)
        #: (name, offset, shape) of each parameter in a row.
        self.views: list[tuple[str, int, torch.Size]] = []
        with torch.no_grad():
            for r, params in enumerate(named):
                offset = 0
                for name, p in params:
                    k = p.numel()
                    self.params[r, offset:offset + k].copy_(p.reshape(-1))
                    p.data = self.params[r, offset:offset + k].view(p.shape)
                    p.grad = self.grads[r, offset:offset + k].view(p.shape)
                    if r == 0:
                        self.views.append((name, offset, p.shape))
                    offset += k

    def zero_grad(self) -> None:
        self.grads.zero_()

    def set_lr(self, lrs) -> None:
        """Each replica's rate from now on (one copy to the device)."""
        self.lr.copy_(torch.as_tensor(lrs, dtype=torch.float32))

    def set_active(self, flags) -> None:
        """Which replicas train from now on (one copy to the device)."""
        self.active.copy_(torch.as_tensor(flags, dtype=torch.bool))

    @torch.no_grad()
    def step(self) -> None:
        """One clip → L2 → Adam update of every active row at its rate."""
        g = self.grads
        if self.gradient_clip_val is not None:
            max_norm = self.gradient_clip_val
            # One solo-shaped reduction a row: vector_norm over [R, n]
            # along dim 1 need not sum in the solo order.
            g_norm = torch.stack([torch.linalg.vector_norm(g[r])
                                  for r in range(self.replicas)])[:, None]
            g = torch.where(g_norm < max_norm, g, (g / g_norm) * max_norm)
        if self.weight_decay:
            g = g + self.weight_decay * self.params
        active = self.active[:, None]
        self.mu.copy_(torch.where(active, self.mu * B1 + (1 - B1) * g, self.mu))
        self.nu.copy_(torch.where(active, self.nu * B2 + (1 - B2) * (g * g),
                                  self.nu))
        self.count_t.add_(self.active.long())
        count = self.count_t.double()[:, None]  # mtt: disable=TL104 -- the bias-correction scalar in f64, as the eager step's Python double; rounded to f32 before it touches a buffer
        mu_hat = _divide(self.mu, 1 - torch.pow(B1, count))
        nu_hat = _divide(self.nu, 1 - torch.pow(B2, count))
        update = mu_hat / (torch.sqrt(nu_hat) + EPS)
        self.params.sub_(torch.where(active, update * self.lr[:, None], 0.0))

    def replica_state_dict(self, r: int) -> dict:
        """Replica ``r``'s optimizer state in the solo ``FlatAdam`` form."""
        return {"count": int(self.count_t[r]), "mu": self.mu[r].clone(),
                "nu": self.nu[r].clone()}

    def load_replica_state_dict(self, r: int, state: dict) -> None:
        """A solo ``FlatAdam`` state into row ``r``, in place."""
        self.count_t[r] = int(state["count"])
        self.mu[r].copy_(state["mu"])
        self.nu[r].copy_(state["nu"])

    def snapshot(self) -> tuple:
        """Copies of the whole stack's state: parameters, moments, counts."""
        return tuple(t.clone() for t in (self.params, self.mu, self.nu,
                                         self.count_t))

    def restore_row(self, r: int, snapshot: tuple) -> None:
        """Row ``r`` of parameters, moments and count back to ``snapshot``'s,
        in place; the other rows are not touched."""
        for live, saved in zip((self.params, self.mu, self.nu, self.count_t),
                               snapshot):
            live[r].copy_(saved[r])


def flatten(module: nn.Module) -> torch.Tensor:
    """``module``'s parameters as one flat f32 vector in the ``FlatAdam``
    layout (a copy)."""
    return torch.cat([p.detach().reshape(-1) for p in module.parameters()])


def stack_flat(bufs: list) -> torch.Tensor:
    """R flat ``[n]`` buffers -> one ``[R, n]``."""
    return torch.stack(list(bufs))


def replica_flat(stacked: torch.Tensor, r: int) -> torch.Tensor:
    """Replica ``r``'s row of a stacked buffer (a copy)."""
    return stacked[r].clone()


def set_lane(stacked: torch.Tensor, r: int, buf: torch.Tensor) -> torch.Tensor:
    """A new ``[R, n]`` buffer with row ``r`` replaced by ``buf`` and every
    other row bit for bit ``stacked``'s."""
    out = stacked.clone()
    out[r].copy_(buf)
    return out


def stack_opt_states(states: list) -> dict:
    """R solo ``FlatAdam`` states -> one stacked state (``count [R]``)."""
    return {"count": torch.tensor([int(s["count"]) for s in states]),
            "mu": stack_flat([s["mu"] for s in states]),
            "nu": stack_flat([s["nu"] for s in states])}


def replica_opt_state(state: dict, r: int) -> dict:
    """Replica ``r``'s solo ``FlatAdam`` state out of a stacked one."""
    return {"count": int(state["count"][r]), "mu": replica_flat(state["mu"], r),
            "nu": replica_flat(state["nu"], r)}


def stacked_size_bytes(module: nn.Module, replicas: int) -> int:
    """Bytes of one ``[R, n]`` copy of ``module``'s flat parameters; the
    stacked optimizer holds four (parameters, gradients, two moments)."""
    return replicas * 4 * sum(p.numel() for p in module.parameters())


def _divide(t: torch.Tensor, divisor: torch.Tensor) -> torch.Tensor:
    """``t / divisor`` for an f64 0-dim ``divisor`` on ``t``'s device, as
    PyTorch computes ``t / d`` for a Python double ``d``: on the card as
    ``t * float(1 / d)`` (its kernel's reciprocal of a host scalar), on the
    CPU as ``t / float(d)``."""
    if t.device.type == "cuda":
        return t * (1 / divisor).float()
    return t / divisor.float()
