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

``compute_dtype=torch.bfloat16`` is the JAX encoder's bf16 compute dtype
(``trainer.precision=bf16-mixed``): the parameters stay f32, the inputs,
each group's input projection (``x.bf16 @ w_ih.T.bf16``, its products
summed in f32 and rounded once, ``+ bias.bf16``), the
recurrence weights and the dropout masks are bf16, the groups are taken
at itemsize 2, and the last hidden state is cast to f32 for the heads.
Groups of two or more layers (the pair's and the L-deep stack's bf16
kernels) run it; a grouping with a single layer raises, naming it.

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
epoch, and of its stacked engine's lanes): the solo encoder's group loop,
each replica's input projections, dropout planes and heads its own
products, exactly the solo encoder's, and each group's recurrence one
replica-axis launch (``lstm_stack_recurrence_stacked``,
``lstm_pair_recurrence_stacked``, ``lstm_recurrence_stacked``). It takes
every grouping the solo encoder runs, a layer on the time-blocked route
included.
"""

from __future__ import annotations

import contextlib
import functools
import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from masters_thesis_tpu_torch import resolve_device
from masters_thesis_tpu_torch.ops.lstm_kernel import (
    COMPUTE_DTYPES,
    MAX_STACK_LAYERS,
    lstm_pair_recurrence,
    lstm_pair_recurrence_stacked,
    lstm_recurrence,
    lstm_recurrence_stacked,
    lstm_stack_recurrence,
    lstm_stack_recurrence_stacked,
    stack_fits,
    window_schedulable,
)


def fused_depth(layers_left: int, n_t: int, rows: int, hidden: int,
                has_mask: bool, window_rows: int | None = None,
                itemsize: int = 4) -> int:
    """Layers the next group takes: the JAX encoder's ``fused_depth``.

    The deepest wavefront, of at most ``layers_left`` layers, that the
    reference fuses over ``rows`` rows, or over one window of
    ``window_rows`` when the rows are whole windows, in a compute dtype of
    ``itemsize`` bytes (4: f32, 2: bf16).
    """
    def depth_fits(depth: int) -> bool:
        return stack_fits(n_t, rows, hidden, depth, has_mask, itemsize) or (
            window_schedulable(rows, window_rows)
            and stack_fits(n_t, window_rows, hidden, depth, has_mask, itemsize)
        )

    # The stack kernel's limit; no config in configs/model goes deeper.
    limit = min(layers_left, MAX_STACK_LAYERS)
    depth = 1
    while depth < limit and depth_fits(depth + 1):
        depth += 1
    return depth


def group_depths(num_layers: int, n_t: int, rows: int, hidden: int,
                 has_mask: bool, window_rows: int | None = None,
                 itemsize: int = 4) -> list[int]:
    """The depths of the wavefronts ``num_layers`` layers run over ``rows``
    rows, bottom layer first (``fused_depth`` from each group's first
    layer)."""
    groups, layer = [], 0
    while layer < num_layers:
        groups.append(fused_depth(num_layers - layer, n_t, rows, hidden,
                                  has_mask, window_rows, itemsize))
        layer += groups[-1]
    return groups


#: Shape classes ``(min_layers, hidden)`` where bf16 measured faster than
#: f32 on the card (the counterpart of the JAX constant, which holds the
#: TPU's): empty until a card A/B records a win, so ``precision=auto``
#: keeps f32 everywhere.
MEASURED_BF16_WAVEFRONT_WINS: tuple[tuple[int, int], ...] = ()


def preferred_compute_dtype(num_layers: int, hidden: int, n_t: int,
                            rows: int, device=None) -> torch.dtype:
    """``precision=auto`` for one model shape, the JAX policy on the card:
    bf16 only where the shape class has a measured win
    (``MEASURED_BF16_WAVEFRONT_WINS``), the device (None: the card) is a
    card, itemsize 2 fuses a deeper wavefront over a window of ``rows``
    than itemsize 4, and no group at itemsize 2 is a single layer (the
    port's bf16 kernels are the pair's and the stack's); f32 otherwise, the
    CPU included."""
    qualifies = any(num_layers >= min_layers and hidden == h
                    for min_layers, h in MEASURED_BF16_WAVEFRONT_WINS)
    on_card = torch.device("cuda" if device is None else device).type == "cuda"
    if not qualifies or not on_card:
        return torch.float32
    bf16 = group_depths(num_layers, n_t, rows, hidden, True, itemsize=2)
    f32 = group_depths(num_layers, n_t, rows, hidden, True)
    if max(bf16) > max(f32) and min(bf16) >= 2:
        return torch.bfloat16
    return torch.float32


@contextlib.contextmanager
def _f32_reduction():
    """cuBLAS sums bf16 products in f32 inside the block (PyTorch's default
    lets it reduce them in bf16); the process's setting is restored after
    it. Only the bf16 projection's own products run inside it."""
    matmul = torch.backends.cuda.matmul
    before = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        matmul.allow_bf16_reduced_precision_reduction = before


class _Bf16Projection(torch.autograd.Function):
    """``inputs @ weight`` on bf16 operands as the JAX encoder's bf16 dot
    computes it: the products summed in f32 and rounded to bf16 once, in
    the forward and in both backward products (the weight's sums over
    T * rows terms)."""

    @staticmethod
    def forward(ctx, inputs, weight):
        ctx.save_for_backward(inputs, weight)
        with _f32_reduction():
            return torch.matmul(inputs, weight)

    @staticmethod
    def backward(ctx, grad):
        inputs, weight = ctx.saved_tensors
        d_inputs = d_weight = None
        with _f32_reduction():
            if ctx.needs_input_grad[0]:
                d_inputs = torch.matmul(grad, weight.T)
            if ctx.needs_input_grad[1]:
                d_weight = (inputs.reshape(-1, inputs.shape[-1]).T
                            @ grad.reshape(-1, grad.shape[-1]))
        return d_inputs, d_weight


def _group_weights(layers: list, layer: int, depth: int,
                   dtype: torch.dtype | None = None):
    """A group's recurrence weights from the per-layer ``(w_ih, w_hh, b_ih,
    b_hh)`` of ``layers``: ``(w_hhs, w_ins, biases)``, the layout of the
    kernels (transposed weights, combined seam biases), cast to ``dtype``
    (None: the parameters' own)."""
    def cast(t):
        return t if dtype is None else t.to(dtype)

    w_hhs = [cast(layers[layer][1].T).contiguous()]
    w_ins, biases = [], []
    for above in range(layer + 1, layer + depth):
        w_ih_a, w_hh_a, b_ih_a, b_hh_a = layers[above]
        w_hhs.append(cast(w_hh_a.T).contiguous())
        w_ins.append(cast(w_ih_a.T).contiguous())
        biases.append(cast(b_ih_a + b_hh_a).contiguous())
    return w_hhs, w_ins, biases


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
        compute_dtype: torch.dtype = torch.float32,
    ):
        """Weights are drawn uniform(-1/sqrt(H), 1/sqrt(H)) on the CPU from
        ``generator`` (torch.nn.LSTM's and Linear's init), then moved to
        ``device`` (``cuda`` unless told otherwise). ``remat`` recomputes
        each layer group's recurrence in the backward pass.
        ``compute_dtype`` (f32 or bf16) is the recurrences' and the input
        projections' type; the parameters are f32 either way."""
        super().__init__()
        if num_layers < 1:
            raise ValueError(f"num_layers must be >= 1, got {num_layers}")
        if compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, "
                             f"got {compute_dtype}")
        self.compute_dtype = compute_dtype
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
        bottom layer first (``group_depths`` at the compute dtype's
        itemsize)."""
        return group_depths(self.num_layers, n_t, rows, self.hidden_size,
                            has_mask, window_rows,
                            self.compute_dtype.itemsize)

    def draw_masks(self, n_t: int, rows: int,
                   generator: torch.Generator | None = None) -> list:
        """The ``n_masks`` pre-scaled keep-masks ``(T, rows, H)`` of one
        training forward: bernoulli(1 - p) / (1 - p), drawn on the module's
        device from ``generator`` (torch's default generator when None)."""
        device = self.w_hh_l0.device
        keep = 1.0 - self.dropout
        return [
            torch.empty((n_t, rows, self.hidden_size), device=device,
                        dtype=self._low_dtype)
            .bernoulli_(keep, generator=generator) / keep
            for _ in range(self.n_masks)
        ]

    @property
    def _low_dtype(self) -> torch.dtype | None:
        """The type the forward casts its inputs, projections, recurrence
        weights and masks to: bf16, or None at f32 (no cast: the module
        computes in its parameters' type, f64 included)."""
        return None if self.compute_dtype == torch.float32 else self.compute_dtype

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
        dtype = self._low_dtype

        def cast(t):
            return t if dtype is None else t.to(dtype)

        inputs = cast(x.transpose(0, 1))
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
        else:
            masks = [cast(m) for m in masks]
        groups = self.layer_groups(n_t, rows, masks is not None, window_rows)
        if dtype is not None and 1 in groups:
            raise TypeError(
                f"bf16 compute runs groups of two or more layers (the pair "
                f"and the L-deep stack) only; {self.num_layers} layers over "
                f"{rows} rows of {n_t} steps group as {groups} at itemsize 2, "
                f"and the single-layer kernels in bf16 are ROADMAP.md queue 2")
        pending = iter(masks or ())
        layers = [self._layer(layer) for layer in range(self.num_layers)]
        layer = 0
        for depth in groups:
            w_ih, _, b_ih, b_hh = layers[layer]
            # One matmul for every time step's input projection (at bf16
            # the JAX encoder's bf16 dot, ``_Bf16Projection``).
            if dtype is None:
                x_proj = torch.matmul(inputs, w_ih.T)
            else:
                x_proj = _Bf16Projection.apply(inputs, cast(w_ih.T))
            x_proj = x_proj + cast(b_ih + b_hh)  # (T, B, 4H)
            x_proj = x_proj.contiguous()
            w_hhs, w_ins, biases = _group_weights(layers, layer, depth, dtype)
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
        final_hidden = inputs[-1] if dtype is None else inputs[-1].float()
        return self.alpha_head(final_hidden), self.beta_head(final_hidden)


class StackedLstmEncoder(nn.Module):
    """R ``LstmEncoder`` replicas of one architecture as one module.

    ``replicas`` are solo encoders (each drawn from its own generator, so
    replica r's initial weights are exactly what ``LstmEncoder(...,
    generator=<replica r's generator>)`` draws); their parameters stay
    theirs (a stacked optimizer may make them views into ``[R, n]`` rows).
    A forward runs the solo encoder's group loop: for replica r the solo
    input projections, dropout planes and heads on its own parameters, and
    for each group one replica-axis recurrence for all R.
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
        self.replicas = nn.ModuleList(replicas)

    @staticmethod
    def _architecture(enc: LstmEncoder) -> tuple:
        return (enc.input_size, enc.hidden_size, enc.num_layers, enc.dropout,
                enc.n_factors, enc.remat)

    @property
    def num_replicas(self) -> int:
        return len(self.replicas)

    def layer_groups(self, n_t: int, rows: int, has_mask: bool,
                     window_rows: int | None = None) -> list[int]:
        """The groups a forward over ``rows`` rows runs: the solo
        encoder's rule, every one of them with a replica axis."""
        return self.replicas[0].layer_groups(n_t, rows, has_mask, window_rows)

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
        outs = self.replica_outputs(x, deterministic=deterministic,
                                    generators=generators, masks=masks,
                                    window_rows=window_rows)
        return (torch.stack([a for a, _ in outs]),
                torch.stack([b for _, b in outs]))

    def replica_outputs(self, x: torch.Tensor, *, deterministic: bool = True,
                        generators=None, masks=None,
                        window_rows: int | None = None) -> list:
        """``forward``'s answers as one ``(alpha, beta)`` pair a replica,
        each the solo encoder's own tensors: a training step takes its
        losses from these, so that each replica's gradients flow back into
        its heads in the solo layout (a slice of a stacked output would
        hand its heads a gradient of another layout, whose bias reduction
        sums in another order)."""
        n_rep = self.num_replicas
        shared = x.dim() == 3
        inputs = [(x if shared else x[r]).transpose(0, 1) for r in range(n_rep)]
        n_t, rows = inputs[0].shape[:2]
        first = self.replicas[0]
        if deterministic or first.dropout <= 0.0:
            masks = None
        else:
            if masks is None:
                gens = generators if generators is not None else [None] * n_rep
                masks = [enc.draw_masks(n_t, rows, gen)
                         for enc, gen in zip(self.replicas, gens)]
            if len(masks) != n_rep or any(len(m) != first.n_masks
                                          for m in masks):
                raise ValueError(f"{n_rep} replicas of {first.num_layers} "
                                 f"layers take {n_rep} lists of "
                                 f"{first.n_masks} masks")
        groups = self.layer_groups(n_t, rows, masks is not None, window_rows)
        layers = [[enc._layer(layer) for layer in range(first.num_layers)]
                  for enc in self.replicas]
        layer = 0
        for depth in groups:
            # Each replica's input projection, its own product as in the
            # solo encoder, then the group's operands stacked along R.
            x_proj = torch.stack([
                (torch.matmul(inp, lay[layer][0].T)
                 + (lay[layer][2] + lay[layer][3])).contiguous()
                for inp, lay in zip(inputs, layers)])
            w_hhs, w_ins, biases = (
                [torch.stack(parts) for parts in zip(*group)]
                for group in zip(*(_group_weights(lay, layer, depth)
                                   for lay in layers)))
            seams = ([torch.stack([m[layer + i] for m in masks])
                      for i in range(depth - 1)] if masks else None)
            if depth >= 3:
                run, args = lstm_stack_recurrence_stacked, (
                    x_proj, (w_hhs, w_ins, biases), seams)
            elif depth == 2:
                run, args = lstm_pair_recurrence_stacked, (
                    x_proj, w_hhs[0], w_ins[0], biases[0], w_hhs[1],
                    seams[0] if seams else None)
            else:
                run = functools.partial(lstm_recurrence_stacked,
                                        window_rows=window_rows)
                args = (x_proj, w_hhs[0])
            if first.remat and torch.is_grad_enabled():
                hs = checkpoint(run, *args, use_reentrant=False,
                                preserve_rng_state=False)
            else:
                hs = run(*args)
            layer += depth
            if masks and layer < first.num_layers:
                # The mask at a boundary between groups, the solo encoder's
                # product replica by replica.
                inputs = [hs[r] * masks[r][layer - 1] for r in range(n_rep)]
            else:
                inputs = list(hs)
        return [(enc.alpha_head(inp[-1]), enc.beta_head(inp[-1]))
                for enc, inp in zip(self.replicas, inputs)]
