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
runs through ``ops/lstm_kernel.py``, differentiable through the hand-written
backward kernels. Consecutive layers group into wavefronts exactly as the
JAX encoder groups them (``fused_depth``, its rule over the reference's
byte budget, ``window_rows`` included): a group of 3 to 8 layers runs the
stack kernel, 2 the pair kernel, 1 the single-layer kernels (resident, or
time-blocked where the reference's route says so: ``single_layer_route``).
At the canonical window (T=60, 100 rows, H=64) that is pairs then one; at
25-row windows a 4-layer model is one 4-deep stack; at a one-year lookback
(T=252) on 100-row windows every layer runs alone, time-blocked.

``remat`` recomputes each group's recurrence in the backward pass
(``torch.utils.checkpoint``, the counterpart of the JAX encoder's
``jax.checkpoint``): only the group's inputs are kept, not its h/c stashes.

Dropout in training mode follows the JAX encoder: torch semantics (every
layer's output except the last), as pre-scaled ``(T, B, H)`` keep-masks,
one per layer but the last, in layer order — those at a seam inside a group
are applied inside its kernel, those at a boundary between groups
multiplied outside. The masks are drawn with ``torch.bernoulli`` from an
explicit generator on the module's device, or injected with ``masks=``. The
JAX and torch generators give different bits, so cross-framework parity
with dropout on holds only for injected masks.

``StackedLstmEncoder`` runs R encoders of one architecture as one (the
counterpart of the JAX package's ``vmap`` over the encoder in its stacked
epoch, and of its stacked engine's lanes): each replica's input projection
and heads are its own products, exactly the solo encoder's, and the
recurrence is one replica-axis pair (``lstm_pair_recurrence_stacked``). It
takes the one grouping this slice stacks, a single depth-2 group, and
refuses any other (ROADMAP queue 1 item 1 lists the replica axes still to
add).
"""

from __future__ import annotations

import functools
import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from masters_thesis_tpu_torch import resolve_device
from masters_thesis_tpu_torch.ops.lstm_kernel import (
    MAX_STACK_LAYERS,
    lstm_pair_recurrence,
    lstm_pair_recurrence_stacked,
    lstm_recurrence,
    lstm_stack_recurrence,
    stack_fits,
    window_schedulable,
)


def fused_depth(layers_left: int, n_t: int, rows: int, hidden: int,
                has_mask: bool, window_rows: int | None = None) -> int:
    """Layers the next group takes: the JAX encoder's ``fused_depth``.

    The deepest wavefront, of at most ``layers_left`` layers, that the
    reference fuses over ``rows`` rows, or over one window of
    ``window_rows`` when the rows are whole windows (f32, the port's only
    compute type).
    """
    def depth_fits(depth: int) -> bool:
        return stack_fits(n_t, rows, hidden, depth, has_mask) or (
            window_schedulable(rows, window_rows)
            and stack_fits(n_t, window_rows, hidden, depth, has_mask)
        )

    # The stack kernel's limit; no config in configs/model goes deeper.
    limit = min(layers_left, MAX_STACK_LAYERS)
    depth = 1
    while depth < limit and depth_fits(depth + 1):
        depth += 1
    return depth


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
        remat: bool = False,
    ):
        """Weights are drawn uniform(-1/sqrt(H), 1/sqrt(H)) on the CPU from
        ``generator`` (torch.nn.LSTM's and Linear's init), then moved to
        ``device`` (``cuda`` unless told otherwise). ``remat`` recomputes
        each layer group's recurrence in the backward pass."""
        super().__init__()
        if num_layers < 1:
            raise ValueError(f"num_layers must be >= 1, got {num_layers}")
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.dropout = dropout
        self.n_factors = n_factors
        self.remat = remat
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

    @property
    def n_masks(self) -> int:
        """Dropout planes a training forward uses: one per seam inside each
        group and one per boundary between groups, one per layer but the
        last whatever the grouping."""
        return self.num_layers - 1

    def layer_groups(self, n_t: int, rows: int, has_mask: bool,
                     window_rows: int | None = None) -> list[int]:
        """The depths of the wavefronts a forward over ``rows`` rows runs,
        bottom layer first (``fused_depth`` from each group's first
        layer)."""
        groups, layer = [], 0
        while layer < self.num_layers:
            groups.append(fused_depth(self.num_layers - layer, n_t, rows,
                                      self.hidden_size, has_mask, window_rows))
            layer += groups[-1]
        return groups

    def draw_masks(self, n_t: int, rows: int,
                   generator: torch.Generator | None = None) -> list:
        """The ``n_masks`` pre-scaled keep-masks ``(T, rows, H)`` of one
        training forward: bernoulli(1 - p) / (1 - p), drawn on the module's
        device from ``generator`` (torch's default generator when None)."""
        device = self.w_hh_l0.device
        keep = 1.0 - self.dropout
        return [
            torch.empty((n_t, rows, self.hidden_size), device=device)
            .bernoulli_(keep, generator=generator) / keep
            for _ in range(self.n_masks)
        ]

    def forward(
        self,
        x: torch.Tensor,
        *,
        deterministic: bool = True,
        generator: torch.Generator | None = None,
        masks: list | None = None,
        window_rows: int | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Encode lookback windows into per-row (alpha, beta) estimates.

        Args:
            x: ``(batch, time, features)`` feature-expanded lookback windows.
            deterministic: disables inter-layer dropout (eval mode).
            generator: the ``torch.Generator`` (on the module's device) the
                training masks are drawn from.
            masks: the ``n_masks`` time-major ``(time, batch, hidden)``
                pre-scaled keep-masks to use instead of drawing them, in
                layer order (mask l multiplies layer l's output).
            window_rows: rows per window when ``batch`` is a flattened stack
                of independent windows (``forward_rows`` passes it); the
                grouping rule then also considers one window's rows, as the
                JAX encoder's does.

        Returns:
            ``(alpha, beta)``: ``(batch, 1)`` and ``(batch, n_factors)``.
        """
        # Time-major throughout, the kernels' layout: (T, B, ·).
        inputs = x.transpose(0, 1)
        n_t, rows = inputs.shape[:2]
        if deterministic or self.dropout <= 0.0:
            masks = None
        elif masks is None:
            masks = self.draw_masks(n_t, rows, generator)
        elif len(masks) != self.n_masks:
            raise ValueError(
                f"{self.num_layers} layers take {self.n_masks} masks, "
                f"got {len(masks)}"
            )
        pending = iter(masks or ())
        layer = 0
        for depth in self.layer_groups(n_t, rows, masks is not None, window_rows):
            w_ih, w_hh, b_ih, b_hh = self._layer(layer)
            # One matmul for every time step's input projection.
            x_proj = torch.matmul(inputs, w_ih.T) + (b_ih + b_hh)  # (T, B, 4H)
            x_proj = x_proj.contiguous()
            w_hhs, w_ins, biases = [w_hh.T.contiguous()], [], []
            for above in range(layer + 1, layer + depth):
                w_ih_a, w_hh_a, b_ih_a, b_hh_a = self._layer(above)
                w_hhs.append(w_hh_a.T.contiguous())
                w_ins.append(w_ih_a.T.contiguous())
                biases.append((b_ih_a + b_hh_a).contiguous())
            seams = [next(pending) for _ in range(depth - 1)] if masks else None
            if depth >= 3:
                run, args = lstm_stack_recurrence, (x_proj, (w_hhs, w_ins, biases),
                                                    seams)
            elif depth == 2:
                run, args = lstm_pair_recurrence, (x_proj, w_hhs[0], w_ins[0],
                                                   biases[0], w_hhs[1],
                                                   seams[0] if seams else None)
            else:
                run = functools.partial(lstm_recurrence, window_rows=window_rows)
                args = (x_proj, w_hhs[0])
            if self.remat and torch.is_grad_enabled():
                # The masks were drawn above and are arguments, so the
                # recomputation sees the same ones; the recurrence draws no
                # random numbers, so no RNG state needs keeping.
                inputs = checkpoint(run, *args, use_reentrant=False,
                                    preserve_rng_state=False)
            else:
                inputs = run(*args)
            layer += depth
            if masks and layer < self.num_layers:
                inputs = inputs * next(pending)
        final_hidden = inputs[-1]
        return self.alpha_head(final_hidden), self.beta_head(final_hidden)


#: Where the groupings that do not stack yet are queued.
STACKED_QUEUE = ("ROADMAP.md queue 1 item 1 (replica axes for the single-layer, "
                 "stack and time-blocked kernels)")


class GroupingNotStackedError(NotImplementedError):
    """A stacked encoder asked to run a layer grouping other than one
    depth-2 group (the pair), which is all this slice stacks."""


class StackedLstmEncoder(nn.Module):
    """R ``LstmEncoder`` replicas of one architecture as one module.

    ``replicas`` are solo encoders (each drawn from its own generator, so
    replica r's initial weights are exactly what ``LstmEncoder(...,
    generator=<replica r's generator>)`` draws); their parameters stay
    theirs (a stacked optimizer may make them views into ``[R, n]`` rows).
    A forward runs, for replica r, the solo encoder's input projection and
    heads on its own parameters, and one replica-axis pair recurrence for
    all R.
    """

    def __init__(self, replicas):
        super().__init__()
        replicas = list(replicas)
        if not replicas:
            raise ValueError("a stacked encoder needs at least one replica")
        first = replicas[0]
        arch = self._architecture(first)
        for r, enc in enumerate(replicas[1:], start=1):
            if self._architecture(enc) != arch:
                raise ValueError(f"replica {r} is {self._architecture(enc)}, "
                                 f"replica 0 {arch}: a stack takes one "
                                 "architecture")
        if first.num_layers != 2:
            raise GroupingNotStackedError(
                f"num_layers={first.num_layers}: stacked replicas run the "
                f"layer pair only (num_layers=2); see {STACKED_QUEUE}")
        self.replicas = nn.ModuleList(replicas)

    @staticmethod
    def _architecture(enc: LstmEncoder) -> tuple:
        return (enc.input_size, enc.hidden_size, enc.num_layers, enc.dropout,
                enc.n_factors, enc.remat)

    @property
    def num_replicas(self) -> int:
        return len(self.replicas)

    def check_groups(self, n_t: int, rows: int, has_mask: bool,
                     window_rows: int | None = None) -> None:
        """Raise ``GroupingNotStackedError`` unless a forward over ``rows``
        rows runs one depth-2 group (the solo encoder's rule)."""
        groups = self.replicas[0].layer_groups(n_t, rows, has_mask, window_rows)
        if groups != [2]:
            raise GroupingNotStackedError(
                f"layer groups {groups} at T={n_t}, {rows} rows: stacked "
                f"replicas run one depth-2 group (the pair) only; see "
                f"{STACKED_QUEUE}")

    def forward(self, x: torch.Tensor, *, deterministic: bool = True,
                generators=None, masks=None,
                window_rows: int | None = None):
        """Encode each replica's windows.

        Args:
            x: ``(R, batch, time, features)``, replica r's windows in row r,
                or ``(batch, time, features)`` shared by every replica.
            deterministic: disables the dropout.
            generators: one generator a replica (on the module's device),
                each replica's masks drawn from its own, as the solo
                encoder draws them.
            masks: per replica, its list of masks instead of drawing them.
            window_rows: as ``LstmEncoder.forward``.

        Returns:
            ``(alpha (R, batch, 1), beta (R, batch, n_factors))``; replica
            r's rows are the solo encoder's on its windows and masks.
        """
        n_rep = self.num_replicas
        shared = x.dim() == 3
        inputs = [(x if shared else x[r]).transpose(0, 1) for r in range(n_rep)]
        n_t, rows = inputs[0].shape[:2]
        first = self.replicas[0]
        seams = None
        if not deterministic and first.dropout > 0.0:
            if masks is None:
                gens = generators if generators is not None else [None] * n_rep
                masks = [enc.draw_masks(n_t, rows, gen)
                         for enc, gen in zip(self.replicas, gens)]
            if len(masks) != n_rep or any(len(m) != first.n_masks
                                          for m in masks):
                raise ValueError(f"{n_rep} replicas of {first.num_layers} "
                                 f"layers take {n_rep} lists of "
                                 f"{first.n_masks} masks")
            seams = torch.stack([m[0] for m in masks])
        self.check_groups(n_t, rows, seams is not None, window_rows)
        x_proj, w_hh1, w_ih2, bias2, w_hh2 = [], [], [], [], []
        for enc, inp in zip(self.replicas, inputs):
            w_ih, w_hh, b_ih, b_hh = enc._layer(0)
            x_proj.append((torch.matmul(inp, w_ih.T) + (b_ih + b_hh))
                          .contiguous())
            w_hh1.append(w_hh.T.contiguous())
            w_ih_a, w_hh_a, b_ih_a, b_hh_a = enc._layer(1)
            w_hh2.append(w_hh_a.T.contiguous())
            w_ih2.append(w_ih_a.T.contiguous())
            bias2.append((b_ih_a + b_hh_a).contiguous())
        args = (torch.stack(x_proj), torch.stack(w_hh1), torch.stack(w_ih2),
                torch.stack(bias2), torch.stack(w_hh2), seams)
        if first.remat and torch.is_grad_enabled():
            h2s = checkpoint(lstm_pair_recurrence_stacked, *args,
                             use_reentrant=False, preserve_rng_state=False)
        else:
            h2s = lstm_pair_recurrence_stacked(*args)
        final = h2s[:, -1]
        alphas = [enc.alpha_head(final[r]) for r, enc in enumerate(self.replicas)]
        betas = [enc.beta_head(final[r]) for r, enc in enumerate(self.replicas)]
        return torch.stack(alphas), torch.stack(betas)
