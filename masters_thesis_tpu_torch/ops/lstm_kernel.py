"""LSTM recurrences over precomputed input projections: CUDA kernels, their
plain PyTorch versions, and the autograd functions that tie them together.

Counterpart of ``masters_thesis_tpu/ops/lstm_kernel.py``. The same split
holds: the input projection for every time step is one large matmul done by
the caller, and only the serial part — the per-step recurrent product plus
the gate math — is a kernel, forward and backward. Layout is the JAX
functions' own: time-major ``(T, B, 4H)`` projections (``x @ w_ihᵀ`` plus
both biases), gate order i, f, g, o, and transposed ``(H, 4H)`` weights.

Three recurrences, as in the JAX package: one layer, the layer pair, and
the L-deep stack (``lstm_stack_recurrence``, 3 <= L <= 8 layers in one
wavefront). One layer takes the reference's route (``single_layer_route``,
a copy of its rule): the resident kernels, or at long lookbacks the
time-blocked ones (``csrc/lstm_tb.cu``: h and c carried from one time chunk
to the next, the recurrent weight gradient accumulated inside the sweep).
Otherwise dispatch is on the tensors' device and nothing else: a CUDA
tensor goes to the hand-written kernels in ``csrc/lstm_fwd.cu``,
``csrc/lstm_bwd.cu``, ``csrc/lstm_stack.cu``, ``csrc/lstm_stack_bwd.cu``
and ``csrc/lstm_tb.cu`` (the bf16 instances in ``csrc/lstm_fwd_bf16.cu``,
``csrc/lstm_bwd_bf16.cu``, ``csrc/lstm_stack_bf16.cu`` and
``csrc/lstm_stack_bwd_bf16.cu``) (or raises), a CPU tensor to the plain
versions. When an input needs a gradient, the recurrence runs as a
``torch.autograd.Function`` whose forward also writes the stashes (h and c
planes) and whose backward recomputes the gates from them, as the TPU
kernels do: the serial sweep (``lstm_pair_bwd`` / ``lstm_bwd`` /
``lstm_stack_bwd``), then the weight-gradient reduction (``lstm_wgrad``).
Each kernel counts its launches in ``LAUNCHES`` (``utils/counts.py``:
exact across threads, a capture's counts kept apart) so a run can show
that its main path went through it.

The single layer, the pair and the stack also run with a replica axis
(``lstm_recurrence_stacked``, ``lstm_pair_recurrence_stacked``,
``lstm_stack_recurrence_stacked``: the counterparts of ``vmap`` over the
JAX recurrences, which stacked training and serving run): R replicas'
operands stacked on a leading axis, one launch of each kernel for all R,
replica r's slice of every output the solo kernel's on its slices; so do
the time-blocked kernels where the reference takes them.

The CUDA kernels take H <= 64, in f32. The layer pair and the L-deep
stack also run in bf16 (the JAX kernels' bf16 compute dtype,
``trainer.precision=bf16-mixed``): their forwards, sweeps and the
weight-gradient pass take bf16 planes and weights, do their arithmetic in
f32 with f32 state (the seam from the f32 h) and round only what they
store, as the TPU kernels do; each sweep recomputes the gates from the
rounded stashes and also writes every layer's d_pre in f32 for the pass,
which rounds each weight gradient once (the stack's pass runs its 2L - 1
jobs). A bf16 tensor at the single-layer or time-blocked recurrences, or
at a replica axis, raises (``BF16_QUEUED``); nothing converts it to f32.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading

import torch

from masters_thesis_tpu_torch.ops._build import load_library
from masters_thesis_tpu_torch.utils.counts import CallCounts

#: Largest hidden size the kernels take (``kMaxHidden`` in csrc/lstm_common.cuh):
#: the pair stages three (H, 4H) f32 weights in one block's shared memory,
#: 192 KiB at H=64, the width of every model in configs/model.
MAX_HIDDEN = 64

#: The compute dtypes the pair's and the stack's kernels take; the others
#: take f32.
COMPUTE_DTYPES = (torch.float32, torch.bfloat16)

#: Why a bf16 tensor at a route other than the solo pair and the solo stack
#: raises.
BF16_QUEUED = ("bf16 compute runs the layer pair and the L-deep stack only; "
               "the {route} in bf16 is still to be ported (ROADMAP.md, "
               "queue 2)")

#: Depths the stack kernels take: the pair kernel is the 2-deep wavefront,
#: and a cluster holds at most 8 CTAs, one a layer (``kMinLayers`` and
#: ``kMaxLayers`` in csrc/lstm_stack.cuh).
MIN_STACK_LAYERS, MAX_STACK_LAYERS = 3, 8

#: Launches of each CUDA kernel since the last reset_launch_counts():
#: ``lstm_pair_fwd`` counts the maskless pair forward (serving, dropout 0),
#: ``lstm_pair_fwd_masked`` the instance with a seam mask (training with
#: dropout), and likewise for the stack; ``lstm_wgrad`` is one call of the
#: weight-gradient pass; ``lstm_tb_fwd`` and ``lstm_tb_bwd`` the time-blocked
#: forward and backward (its weight gradient included). A wrapper counts when
#: it launches; a CUDA graph's replay adds the counts of its capture
#: (``utils/cuda_graph.py``). The ``_stacked`` names count the replica-axis
#: launches of the same kernels (R replicas in one launch, stacked training
#: and serving), apart from their solo launches. The ``_bf16`` names count
#: the pair's and the stack's bf16 instances
#: (``trainer.precision=bf16-mixed``), apart from the f32 ones; the bf16
#: pass counts as ``lstm_wgrad_bf16`` at either's jobs.
LAUNCHES = CallCounts((
    "lstm_pair_fwd",
    "lstm_pair_fwd_masked",
    "lstm_pair_fwd_bf16",
    "lstm_pair_fwd_masked_bf16",
    "lstm_pair_bwd_bf16",
    "lstm_wgrad_bf16",
    "lstm_stack_fwd_bf16",
    "lstm_stack_fwd_masked_bf16",
    "lstm_stack_bwd_bf16",
    "lstm_fwd",
    "lstm_pair_bwd",
    "lstm_bwd",
    "lstm_wgrad",
    "lstm_pair_fwd_stacked",
    "lstm_pair_fwd_masked_stacked",
    "lstm_pair_bwd_stacked",
    "lstm_wgrad_stacked",
    "lstm_fwd_stacked",
    "lstm_bwd_stacked",
    "lstm_stack_fwd",
    "lstm_stack_fwd_masked",
    "lstm_stack_bwd",
    "lstm_stack_fwd_stacked",
    "lstm_stack_fwd_masked_stacked",
    "lstm_stack_bwd_stacked",
    "lstm_tb_fwd",
    "lstm_tb_bwd",
    "lstm_tb_fwd_stacked",
    "lstm_tb_bwd_stacked",
))


def reset_launch_counts() -> None:
    LAUNCHES.reset()


# ------------------------------------------------------------ plain versions


def _cell(gates: torch.Tensor, c: torch.Tensor):
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def lstm_recurrence_ref(x_proj: torch.Tensor, w_hh_t: torch.Tensor,
                        return_c: bool = False):
    """Plain version of the single-layer recurrence: a loop over T.

    Mirrors ``lstm_recurrence_xla`` in the JAX package. Returns ``hs``
    ``(T, B, H)``, or ``(hs, cs)`` with ``return_c``.
    """
    n_t, b, _ = x_proj.shape
    hidden = w_hh_t.shape[0]
    h = x_proj.new_zeros((b, hidden))
    c = x_proj.new_zeros((b, hidden))
    hs, cs = [], []
    for t in range(n_t):
        h, c = _cell(x_proj[t] + h @ w_hh_t, c)
        hs.append(h)
        cs.append(c)
    hs = torch.stack(hs)
    return (hs, torch.stack(cs)) if return_c else hs


def _f32(*tensors):
    """Each tensor in f32 (None stays None)."""
    return [None if t is None else t.float() for t in tensors]


def lstm_pair_ref(x1_proj, w_hh1_t, w_ih2_t, bias2, w_hh2_t, mask=None,
                  return_stash: bool = False):
    """Plain version of the layer pair: two loops and a projection.

    Mirrors ``lstm_pair_xla`` in the JAX package: ``mask`` (optional,
    ``(T, B, H)``, pre-scaled) multiplies layer 1's output at the seam.
    Returns layer 2's ``h2s`` ``(T, B, H)``, or with ``return_stash``
    ``(h2s, h1s, c1s, c2s)``, the planes the backward recomputes from.
    bf16 operands run the kernels' semantics: f32 arithmetic on their
    values, h and c carried in f32 (the seam too), and the returned planes
    rounded to bf16.
    """
    if x1_proj.dtype == torch.bfloat16:
        out = lstm_pair_ref(*_f32(x1_proj, w_hh1_t, w_ih2_t, bias2, w_hh2_t,
                                  mask), return_stash=return_stash)
        return (tuple(t.to(torch.bfloat16) for t in out) if return_stash
                else out.to(torch.bfloat16))
    h1s, c1s = lstm_recurrence_ref(x1_proj, w_hh1_t, return_c=True)
    seam = h1s if mask is None else h1s * mask
    h2s, c2s = lstm_recurrence_ref(seam @ w_ih2_t + bias2, w_hh2_t,
                                   return_c=True)
    return (h2s, h1s, c1s, c2s) if return_stash else h2s


def _bwd_step(x_t, h_prev, c_prev, c_t, dh, dc, w_hh_t):
    """One step of the single-layer backward sweep: the gates recomputed
    from ``x_t + h_prev @ w_hh_t``, then ``(d_pre (B, 4H), dc carried to
    step t - 1)`` from the incoming ``dh`` and ``dc``."""
    i, f, g, o = (x_t + h_prev @ w_hh_t).chunk(4, dim=-1)
    i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
    tanh_c = torch.tanh(c_t)
    d_o = dh * tanh_c
    dc = dh * o * (1.0 - tanh_c * tanh_c) + dc
    di, dg, df = dc * g, dc * i, dc * c_prev
    d_pre = torch.cat(
        [di * i * (1.0 - i), df * f * (1.0 - f), dg * (1.0 - g * g),
         d_o * o * (1.0 - o)], dim=-1,
    )
    return d_pre, dc * f


def lstm_bwd_ref(dhs, x_proj, hs, cs, w_hh_t) -> torch.Tensor:
    """Plain version of the single-layer backward sweep.

    Recomputes each step's gates from ``x_proj[t] + h[t-1] @ w_hh_t`` (the
    stashed ``hs``/``cs``, as ``_bwd_kernel`` does) and returns the
    pre-activation gradients ``d_pre`` ``(T, B, 4H)``, which are the
    gradient of ``x_proj``.
    """
    n_t = x_proj.shape[0]
    dh_rec = torch.zeros_like(hs[0])
    dc = torch.zeros_like(hs[0])
    d_pre = torch.empty_like(x_proj)
    for t in range(n_t - 1, -1, -1):
        h_prev = hs[t - 1] if t > 0 else torch.zeros_like(hs[0])
        c_prev = cs[t - 1] if t > 0 else torch.zeros_like(cs[0])
        d_pre[t], dc = _bwd_step(x_proj[t], h_prev, c_prev, cs[t],
                                 dhs[t] + dh_rec, dc, w_hh_t)
        dh_rec = d_pre[t] @ w_hh_t.T
    return d_pre


def lstm_tb_fwd_ref(x_proj: torch.Tensor, w_hh_t: torch.Tensor,
                    time_chunk: int):
    """Plain version of the time-blocked forward: the time axis walked in
    chunks of ``time_chunk`` steps, h and c carried from one chunk to the
    next (``_tb_fwd_kernel``). Returns ``(hs, cs)`` ``(T, B, H)``; every
    step does the same arithmetic as ``lstm_recurrence_ref``'s."""
    n_t, b, _ = x_proj.shape
    hidden = w_hh_t.shape[0]
    h = x_proj.new_zeros((b, hidden))
    c = x_proj.new_zeros((b, hidden))
    hs, cs = [], []
    for t0 in range(0, n_t, time_chunk):
        for t in range(t0, min(t0 + time_chunk, n_t)):
            h, c = _cell(x_proj[t] + h @ w_hh_t, c)
            hs.append(h)
            cs.append(c)
    return torch.stack(hs), torch.stack(cs)


def lstm_tb_bwd_ref(dhs, x_proj, hs, cs, w_hh_t, time_chunk: int,
                    row_tile: int):
    """Plain version of the time-blocked backward: ``(dx (T, B, 4H),
    dw (H, 4H))`` as ``_tb_bwd_kernel`` computes them.

    The chunks are walked in reverse, each step's gates recomputed from
    ``h[t-1]`` and ``c[t-1]`` (read from the stash across a chunk's first
    step), ``dx`` (= d_pre) written as its own plane, and ``dw += h[t-1]ᵀ
    d_pre[t]`` accumulated inside the sweep, one partial per tile of
    ``row_tile`` rows (the last one zero-padded); the partials are summed
    over the tiles at the end, as the JAX wrapper sums its kernel's.
    """
    n_t, b, four_h = x_proj.shape
    hidden = four_h // 4
    n_tiles = -(-b // row_tile)

    def tiles(a):  # (B, n) -> (n_tiles, row_tile, n), rows past B zero
        return torch.nn.functional.pad(a, (0, 0, 0, n_tiles * row_tile - b)
                                       ).view(n_tiles, row_tile, -1)

    zeros = torch.zeros_like(hs[0])
    dh_rec, dc = zeros, zeros
    dx = torch.empty_like(x_proj)
    dw_part = x_proj.new_zeros((n_tiles, hidden, four_h))
    for t0 in reversed(range(0, n_t, time_chunk)):
        for t in range(min(t0 + time_chunk, n_t) - 1, t0 - 1, -1):
            h_prev = hs[t - 1] if t > 0 else zeros
            c_prev = cs[t - 1] if t > 0 else zeros
            dx[t], dc = _bwd_step(x_proj[t], h_prev, c_prev, cs[t],
                                  dhs[t] + dh_rec, dc, w_hh_t)
            dh_rec = dx[t] @ w_hh_t.T
            dw_part += tiles(h_prev).transpose(1, 2) @ tiles(dx[t])
    return dx, dw_part.sum(dim=0)


def lstm_pair_bwd_ref(dh2s, x1_proj, mask, h1s, c1s, h2s, c2s, w_hh1_t,
                      w_ih2_t, bias2, w_hh2_t):
    """Plain version of the pair's backward sweep: ``(dx1, d_pre2)``.

    Layer 2's input projection is recomputed from the stashed (masked) h1,
    its sweep gives ``d_pre2``; the cotangent into h1 is
    ``(d_pre2 @ w_ih2ᵀ) ⊙ mask``, and layer 1's sweep gives ``d_pre1``,
    the gradient of ``x1_proj``. The same math as ``_pair_bwd_kernel``, one
    layer after the other instead of one step apart.
    """
    seam = h1s if mask is None else h1s * mask
    d_pre2 = lstm_bwd_ref(dh2s, seam @ w_ih2_t + bias2, h2s, c2s, w_hh2_t)
    dh1 = d_pre2 @ w_ih2_t.T
    if mask is not None:
        dh1 = dh1 * mask
    return lstm_bwd_ref(dh1, x1_proj, h1s, c1s, w_hh1_t), d_pre2


def lstm_pair_bwd_bf16_ref(dh2s, x1_proj, mask, h1s, c1s, h2s, c2s, w_hh1_t,
                           w_ih2_t, bias2, w_hh2_t):
    """Plain version of the pair's bf16 sweep: ``(dx1, d_pre1, d_pre2)``.

    ``lstm_pair_bwd_ref`` on the bf16 operands' values in f32, so the gates
    are recomputed from the rounded stashes, as ``_pair_bwd_kernel`` does
    in bf16; ``dx1`` is layer 1's d_pre rounded to bf16 (the gradient of
    the bf16 projection), ``d_pre1`` and ``d_pre2`` stay f32 (the
    weight-gradient pass's operands)."""
    d_pre1, d_pre2 = lstm_pair_bwd_ref(*_f32(dh2s, x1_proj, mask, h1s, c1s,
                                             h2s, c2s, w_hh1_t, w_ih2_t,
                                             bias2, w_hh2_t))
    return d_pre1.to(torch.bfloat16), d_pre1, d_pre2


def lstm_wgrad_ref(d_pre, src, shift: int, mask=None) -> torch.Tensor:
    """Plain version of one weight gradient of the reduction pass:
    ``sum_rows a[row]ᵀ d_pre[row]`` ``(H, 4H)`` with ``a = src[t - shift]``
    (zero before the first step), times ``mask`` when given."""
    a = src
    if shift:
        a = torch.cat([torch.zeros_like(src[:shift]), src[:-shift]])
    if mask is not None:
        a = a * mask
    return a.reshape(-1, a.shape[-1]).T @ d_pre.reshape(-1, d_pre.shape[-1])


def lstm_pair_wgrad_ref(dx1, d_pre2, h1s, h2s, mask=None):
    """Plain version of the pair's weight gradients:
    ``(dW_hh1, dW_ih2, db2, dW_hh2)``. With bf16 stashes (``dx1`` then
    layer 1's f32 d_pre, ``d_pre2`` f32) the sums are taken in f32 and
    each gradient rounded to bf16 once."""
    if h1s.dtype == torch.bfloat16:
        h1s, h2s, mask = _f32(h1s, h2s, mask)
        return tuple(g.to(torch.bfloat16)
                     for g in lstm_pair_wgrad_ref(dx1, d_pre2, h1s, h2s, mask))
    return (
        lstm_wgrad_ref(dx1, h1s, 1),
        lstm_wgrad_ref(d_pre2, h1s, 0, mask),
        d_pre2.sum(dim=(0, 1)),
        lstm_wgrad_ref(d_pre2, h2s, 1),
    )


def _per_replica(fn, *stacked):
    """``fn`` on each replica's slices of ``stacked`` (a leading R axis; a
    None stays None), its outputs stacked back along R."""
    n = next(t for t in stacked if t is not None).shape[0]
    outs = [_as_tuple(fn(*(None if t is None else t[r] for t in stacked)))
            for r in range(n)]
    stacked_outs = tuple(torch.stack(parts) for parts in zip(*outs))
    return stacked_outs if len(stacked_outs) > 1 else stacked_outs[0]


def _as_tuple(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def lstm_pair_stacked_ref(x1_proj, w_hh1_t, w_ih2_t, bias2, w_hh2_t,
                          mask=None, return_stash: bool = False):
    """Plain version of the replica-axis pair forward: ``lstm_pair_ref`` on
    each replica's slices (``x1_proj (R, T, B, 4H)``, weights ``(R, H,
    4H)``, ``bias2 (R, 4H)``, ``mask (R, T, B, H)``), stacked. The
    counterpart of ``vmap`` over the JAX pair."""
    return _per_replica(
        lambda *a: lstm_pair_ref(*a, return_stash=return_stash),
        x1_proj, w_hh1_t, w_ih2_t, bias2, w_hh2_t, mask)


def lstm_pair_bwd_stacked_ref(dh2s, x1_proj, mask, h1s, c1s, h2s, c2s,
                              w_hh1_t, w_ih2_t, bias2, w_hh2_t):
    """Plain version of the replica-axis pair sweep: ``lstm_pair_bwd_ref``
    replica by replica; ``(dx1, d_pre2)`` ``(R, T, B, 4H)``."""
    return _per_replica(lstm_pair_bwd_ref, dh2s, x1_proj, mask, h1s, c1s,
                        h2s, c2s, w_hh1_t, w_ih2_t, bias2, w_hh2_t)


def lstm_pair_wgrad_stacked_ref(dx1, d_pre2, h1s, h2s, mask=None):
    """Plain version of the replica-axis weight-gradient pass:
    ``lstm_pair_wgrad_ref`` replica by replica, each gradient ``(R, ...)``."""
    return _per_replica(lstm_pair_wgrad_ref, dx1, d_pre2, h1s, h2s, mask)


def lstm_recurrence_stacked_ref(x_proj, w_hh_t, return_c: bool = False):
    """Plain version of the replica-axis single layer: ``lstm_recurrence_ref``
    on each replica's slices (``x_proj (R, T, B, 4H)``, ``w_hh_t (R, H,
    4H)``), stacked: ``hs`` or ``(hs, cs)`` ``(R, T, B, H)``."""
    return _per_replica(
        lambda *a: lstm_recurrence_ref(*a, return_c=return_c), x_proj, w_hh_t)


def lstm_bwd_stacked_ref(dhs, x_proj, hs, cs, w_hh_t):
    """Plain version of the replica-axis single-layer sweep:
    ``lstm_bwd_ref`` replica by replica; ``d_pre (R, T, B, 4H)``."""
    return _per_replica(lstm_bwd_ref, dhs, x_proj, hs, cs, w_hh_t)


def lstm_tb_stacked_ref(x_proj, w_hh_t, time_chunk: int):
    """Plain version of the replica-axis time-blocked forward:
    ``lstm_tb_fwd_ref`` replica by replica (``x_proj (R, T, B, 4H)``,
    ``w_hh_t (R, H, 4H)``); ``(hs, cs)`` ``(R, T, B, H)``."""
    return _per_replica(lambda x, w: lstm_tb_fwd_ref(x, w, time_chunk),
                        x_proj, w_hh_t)


def lstm_tb_bwd_stacked_ref(dhs, x_proj, hs, cs, w_hh_t, time_chunk: int,
                            row_tile: int):
    """Plain version of the replica-axis time-blocked backward:
    ``lstm_tb_bwd_ref`` replica by replica; ``(dx (R, T, B, 4H), dw (R, H,
    4H))``."""
    return _per_replica(
        lambda *a: lstm_tb_bwd_ref(*a, time_chunk, row_tile),
        dhs, x_proj, hs, cs, w_hh_t)


def lstm_single_wgrad_stacked_ref(dx, hs):
    """Plain version of one layer's recurrent weight gradient for R
    replicas: ``sum h[t-1]ᵀ dx[t]`` replica by replica, ``(R, H, 4H)``."""
    return _per_replica(lambda d, h: lstm_wgrad_ref(d, h, 1), dx, hs)


def lstm_stack_ref(x1_proj, w_hh_ts, w_in_ts, biases, masks=None,
                   return_stash: bool = False):
    """Plain version of the L-deep stack: chained loops and projections.

    Mirrors ``lstm_stack_xla`` in the JAX package: layer 0 runs over
    ``x1_proj``; layer l >= 1 over ``(m ⊙ h_{l-1}) @ w_in_ts[l-1] +
    biases[l-1]``, with ``masks[l-1]`` (optional, pre-scaled) multiplying
    layer l-1's output. Returns the top layer's ``hs`` ``(T, B, H)``, or with
    ``return_stash`` ``(hs, cs)``, the lists of every layer's h and c planes.
    bf16 operands run the kernels' semantics: f32 arithmetic on their
    values, h and c carried in f32 (every seam too), and the returned
    planes rounded to bf16.
    """
    if x1_proj.dtype == torch.bfloat16:
        out = lstm_stack_ref(*_f32(x1_proj), _f32(*w_hh_ts), _f32(*w_in_ts),
                             _f32(*biases), None if masks is None
                             else _f32(*masks), return_stash=return_stash)
        if not return_stash:
            return out.to(torch.bfloat16)
        return tuple([t.to(torch.bfloat16) for t in group] for group in out)
    hs, cs = lstm_recurrence_ref(x1_proj, w_hh_ts[0], return_c=True)
    h_all, c_all = [hs], [cs]
    for layer in range(1, len(w_hh_ts)):
        seam = hs if masks is None else hs * masks[layer - 1]
        hs, cs = lstm_recurrence_ref(seam @ w_in_ts[layer - 1] + biases[layer - 1],
                                     w_hh_ts[layer], return_c=True)
        h_all.append(hs)
        c_all.append(cs)
    return (h_all, c_all) if return_stash else hs


def lstm_stack_bwd_ref(dh_top, x1_proj, masks, hs, cs, w_hh_ts, w_in_ts,
                       biases) -> list:
    """Plain version of the stack's backward sweep: every layer's ``d_pre``
    ``(T, B, 4H)``, layer 0's being the gradient of ``x1_proj``.

    Per-layer ``lstm_bwd_ref`` sweeps from the top down, each layer's input
    projection recomputed from the stashes; the cotangent into the layer
    below is ``(d_pre_l @ w_inᵀ) ⊙ m``. The same math as
    ``_stack_bwd_kernel``, one layer after the other instead of one step
    apart.
    """
    n_layers = len(w_hh_ts)
    d_pres = [None] * n_layers
    dh = dh_top
    for layer in range(n_layers - 1, 0, -1):
        seam = hs[layer - 1] if masks is None else hs[layer - 1] * masks[layer - 1]
        x_proj = seam @ w_in_ts[layer - 1] + biases[layer - 1]
        d_pres[layer] = lstm_bwd_ref(dh, x_proj, hs[layer], cs[layer],
                                     w_hh_ts[layer])
        dh = d_pres[layer] @ w_in_ts[layer - 1].T
        if masks is not None:
            dh = dh * masks[layer - 1]
    d_pres[0] = lstm_bwd_ref(dh, x1_proj, hs[0], cs[0], w_hh_ts[0])
    return d_pres


def lstm_stack_bwd_bf16_ref(dh_top, x1_proj, masks, hs, cs, w_hh_ts, w_in_ts,
                            biases):
    """Plain version of the stack's bf16 sweep: ``(dx1, d_pres)``.

    ``lstm_stack_bwd_ref`` on the bf16 operands' values in f32, so the
    gates and seam projections are recomputed from the rounded stashes, as
    ``_stack_bwd_kernel`` does in bf16; ``dx1`` is layer 0's d_pre rounded
    to bf16 (the gradient of the bf16 projection), ``d_pres`` every
    layer's d_pre in f32 (the weight-gradient pass's operands)."""
    d_pres = lstm_stack_bwd_ref(
        *_f32(dh_top, x1_proj), None if masks is None else _f32(*masks),
        _f32(*hs), _f32(*cs), _f32(*w_hh_ts), _f32(*w_in_ts), _f32(*biases))
    return d_pres[0].to(torch.bfloat16), d_pres


def _stack_wgrad_jobs(d_pres, hs, masks):
    """The stack's 2L - 1 weight gradients as ``(d_pre, src, shift, mask,
    with_bias)`` jobs: dW_hh[l] = sum h_l[t-1]ᵀ d_pre_l[t], then
    dW_in[l-1] = sum (m ⊙ h_{l-1})[t]ᵀ d_pre_l[t] with db[l-1] its row sum."""
    n_layers = len(d_pres)
    return (
        [(d_pres[layer], hs[layer], 1, None, False) for layer in range(n_layers)]
        + [(d_pres[layer], hs[layer - 1], 0,
            None if masks is None else masks[layer - 1], True)
           for layer in range(1, n_layers)]
    )


def lstm_stack_wgrad_ref(d_pres, hs, masks=None):
    """Plain version of the stack's weight gradients:
    ``(dW_hh list[L], dW_in list[L-1], db list[L-1])``. With bf16 stashes
    (``d_pres`` f32) the sums are taken in f32 and each gradient rounded to
    bf16 once."""
    if hs[0].dtype == torch.bfloat16:
        out = lstm_stack_wgrad_ref(d_pres, _f32(*hs),
                                   None if masks is None else _f32(*masks))
        return tuple([g.to(torch.bfloat16) for g in group] for group in out)
    jobs = _stack_wgrad_jobs(d_pres, hs, masks)
    n_layers = len(d_pres)
    dw = [lstm_wgrad_ref(d_pre, src, shift, mask)
          for d_pre, src, shift, mask, _ in jobs]
    db = [d_pre.sum(dim=(0, 1)) for d_pre, *_ in jobs[n_layers:]]
    return dw[:n_layers], dw[n_layers:], db


def _replica(group, r: int):
    """Replica r's slices of a list of stacked tensors (None stays None)."""
    return None if group is None else [t[r] for t in group]


def _stack_lists(per_replica: list) -> list:
    """R lists of per-layer tensors -> one list of per-layer ``(R, ...)``
    stacks."""
    return [torch.stack(parts) for parts in zip(*per_replica)]


def lstm_stack_stacked_ref(x1_proj, w_hh_ts, w_in_ts, biases, masks=None,
                           return_stash: bool = False):
    """Plain version of the replica-axis stack: ``lstm_stack_ref`` on each
    replica's slices (``x1_proj (R, T, B, 4H)``, every weight ``(R, H,
    4H)``, bias ``(R, 4H)``, mask ``(R, T, B, H)``), stacked: the top
    layer's ``hs (R, T, B, H)``, or with ``return_stash`` the lists of
    every layer's ``(R, T, B, H)`` h and c planes."""
    outs = [lstm_stack_ref(x1_proj[r], _replica(w_hh_ts, r),
                           _replica(w_in_ts, r), _replica(biases, r),
                           _replica(masks, r), return_stash=return_stash)
            for r in range(x1_proj.shape[0])]
    if not return_stash:
        return torch.stack(outs)
    return (_stack_lists([h for h, _ in outs]),
            _stack_lists([c for _, c in outs]))


def lstm_stack_bwd_stacked_ref(dh_top, x1_proj, masks, hs, cs, w_hh_ts,
                               w_in_ts, biases) -> list:
    """Plain version of the replica-axis stack sweep: ``lstm_stack_bwd_ref``
    replica by replica; every layer's ``d_pre (R, T, B, 4H)``."""
    return _stack_lists([
        lstm_stack_bwd_ref(dh_top[r], x1_proj[r], _replica(masks, r),
                           _replica(hs, r), _replica(cs, r),
                           _replica(w_hh_ts, r), _replica(w_in_ts, r),
                           _replica(biases, r))
        for r in range(x1_proj.shape[0])])


def lstm_stack_wgrad_stacked_ref(d_pres, hs, masks=None):
    """Plain version of the stack's weight gradients for R replicas:
    ``lstm_stack_wgrad_ref`` replica by replica, each gradient ``(R, ...)``
    in its list."""
    outs = [lstm_stack_wgrad_ref(_replica(d_pres, r), _replica(hs, r),
                                 _replica(masks, r))
            for r in range(d_pres[0].shape[0])]
    return tuple(_stack_lists([o[i] for o in outs]) for i in range(3))


# ------------------------------------------- the reference's grouping rule
#
# The JAX encoder groups consecutive layers into the deepest wavefront whose
# backward program fits a TPU VMEM byte budget (``stack_fits`` and
# ``window_schedulable`` in masters_thesis_tpu/ops/lstm_kernel.py). The
# port's copy of that integer arithmetic is kept so that both packages fuse
# the same layers at every shape, and the port's kernels run the routes the
# reference runs. It is the reference's rule, not a model of this card: the
# CUDA kernels take any row count.


def _stack_bwd_vmem_bytes(n_t: int, b_pad: int, hidden: int, n_layers: int,
                          has_mask: bool, itemsize: int = 4) -> int:
    """The reference's byte count of an L-layer wavefront backward program:
    planes and weights at ``itemsize`` (4 for f32, 2 for bf16), the
    gradient scratch in f32."""
    four_h = 4 * hidden
    ell = n_layers
    planes = n_t * b_pad * hidden * (1 + 2 * ell + (ell - 1) * int(has_mask))
    planes += n_t * b_pad * four_h
    weights = 2 * ((2 * ell - 1) * hidden * four_h + (ell - 1) * four_h)
    scratch = (3 * ell - 1) * b_pad * hidden + (
        (2 * ell - 1) * hidden * four_h + (ell - 1) * four_h
    )
    return (planes + weights) * itemsize + scratch * 4


#: The reference's budget: the canonical pair (T=60, 104 rows, H=64, masked).
_PAIR_VMEM_BUDGET = _stack_bwd_vmem_bytes(60, 104, 64, 2, True)


def stack_fits(n_t: int, b: int, hidden: int, n_layers: int,
               has_mask: bool, itemsize: int = 4) -> bool:
    """True when the reference fuses ``n_layers`` layers over ``b`` rows in
    a compute dtype of ``itemsize`` bytes."""
    b_pad = -(-b // 8) * 8
    return (_stack_bwd_vmem_bytes(n_t, b_pad, hidden, n_layers, has_mask,
                                  itemsize) <= _PAIR_VMEM_BUDGET)


def window_schedulable(b: int, window_rows: int | None) -> bool:
    """True when ``b`` rows are several whole windows of ``window_rows``."""
    return window_rows is not None and 0 < window_rows < b and b % window_rows == 0


# The reference's single-layer route. The JAX ``lstm_recurrence`` runs one
# layer as one resident program when its backward's planes fit the VMEM
# budget (``single_layer_fits``), as window-packed resident programs when
# whole windows do, and otherwise as the time-blocked kernels. This copy of
# its arithmetic (``route_plan`` for ``n_layers == 1`` on a TPU, f32, without
# the ``MT_LSTM_ROW_TILE`` knob) keeps the port on the reference's routes; it
# is the reference's rule, not a model of this card, whose kernels stream
# x_proj and hold no T-sized plane on chip. The packed route runs the
# resident kernel over all rows in one launch: rows are independent.

#: The reference's single-program row limit and its row tile beyond it.
SINGLE_TILE_MAX_ROWS = 104
ROW_TILE = 32


def _row_tile(b: int) -> int:
    b_pad8 = -(-b // 8) * 8
    return b_pad8 if b_pad8 <= SINGLE_TILE_MAX_ROWS else ROW_TILE


def _single_layer_vmem_bytes(n_t: int, b: int, hidden: int,
                             itemsize: int = 4) -> int:
    """The reference's byte count of the single-layer backward program: one
    aliased x/dx plane, three (T, tile, H) planes, the weight and its
    gradient at ``itemsize``, and f32 scratch; separate x and dx planes,
    double-buffered, when the rows span more than one tile."""
    four_h = 4 * hidden
    tile = _row_tile(b)
    b_pad = -(-b // 8) * 8
    if b_pad <= tile:
        planes = n_t * tile * (four_h + 3 * hidden)
    else:
        planes = n_t * tile * (2 * four_h + 3 * hidden) * 2
    scratch = 2 * tile * hidden + hidden * four_h
    weights = 2 * hidden * four_h
    return (planes + weights) * itemsize + scratch * 4


def single_layer_fits(n_t: int, b: int, hidden: int) -> bool:
    """True when the reference runs one layer over ``b`` rows resident."""
    return _single_layer_vmem_bytes(n_t, b, hidden) <= _PAIR_VMEM_BUDGET


def single_layer_route(n_t: int, b: int, hidden: int,
                       window_rows: int | None = None) -> str:
    """The reference's route for one layer over ``b`` rows:
    ``"pallas-packed"``, ``"pallas-single"`` or ``"pallas-timeblocked"``."""
    def pad8(rows):
        return -(-rows // 8) * 8

    if (pad8(b) > SINGLE_TILE_MAX_ROWS and window_schedulable(b, window_rows)
            and pad8(window_rows) <= SINGLE_TILE_MAX_ROWS
            and single_layer_fits(n_t, window_rows, hidden)):
        return "pallas-packed"
    if single_layer_fits(n_t, b, hidden):
        return "pallas-single"
    return "pallas-timeblocked"


def tb_time_chunk(b: int, hidden: int) -> int:
    """The reference's time chunk over ``b`` rows (``_tb_time_chunk`` at its
    row tile, f32): the plain versions walk the same chunks and row tiles."""
    four_h = 4 * hidden
    tile = _row_tile(b)
    fixed = (2 * tile * hidden + 2 * hidden * four_h + hidden * four_h
             + 2 * 2 * tile * hidden) * 4
    per_step = 2 * 4 * tile * (2 * four_h + 3 * hidden)
    return max(1, (_PAIR_VMEM_BUDGET - fixed) // per_step)


# ----------------------------------------------------------- CUDA wrappers


def _declare(lib: ctypes.CDLL, name: str, n_ptr: int, n_int: int) -> None:
    """``name(n_ptr pointers, n_int ints, stream) -> int`` (a CUDA error)."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn = getattr(lib, name)
    fn.argtypes = [ptr] * n_ptr + [i32] * n_int + [ptr]
    fn.restype = i32


@functools.cache
def _library() -> ctypes.CDLL:
    """csrc/lstm_fwd.cu, built at first use, with its functions' types."""
    lib = load_library("lstm_fwd")
    _declare(lib, "lstm_fwd", 4, 6)
    _declare(lib, "lstm_pair_fwd", 10, 6)
    lib.lstm_sweep_tile.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    lib.lstm_sweep_tile.restype = ctypes.c_int
    lib.lstm_error_string.argtypes = [ctypes.c_int]
    lib.lstm_error_string.restype = ctypes.c_char_p
    lib.lstm_max_hidden.argtypes = []
    lib.lstm_max_hidden.restype = ctypes.c_int
    _check_max_hidden("lstm_fwd", lib.lstm_max_hidden())
    return lib


@functools.cache
def _bwd_library() -> ctypes.CDLL:
    """csrc/lstm_bwd.cu, built at first use, with its functions' types."""
    lib = load_library("lstm_bwd")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    _declare(lib, "lstm_pair_bwd", 13, 6)
    _declare(lib, "lstm_bwd", 6, 6)
    lib.lstm_wgrad_splits.argtypes = [i32] * 5 + [ctypes.POINTER(i32)]
    lib.lstm_wgrad_splits.restype = i32
    _declare_wgrad(lib, "lstm_wgrad")
    lib.lstm_bwd_max_hidden.argtypes = []
    lib.lstm_bwd_max_hidden.restype = i32
    _check_max_hidden("lstm_bwd", lib.lstm_bwd_max_hidden())
    return lib


def _declare_wgrad(lib: ctypes.CDLL, name: str) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    getattr(lib, name).argtypes = [i32] + [ptr] * 7 + [i32] * 6 + [ptr]
    getattr(lib, name).restype = i32


@functools.cache
def _fwd_bf16_library() -> ctypes.CDLL:
    """csrc/lstm_fwd_bf16.cu (the pair's bf16 forward), built at first use."""
    lib = load_library("lstm_fwd_bf16")
    _declare(lib, "lstm_pair_fwd_bf16", 10, 6)
    return lib


@functools.cache
def _bwd_bf16_library() -> ctypes.CDLL:
    """csrc/lstm_bwd_bf16.cu (the pair's bf16 sweep and pass), built at
    first use."""
    lib = load_library("lstm_bwd_bf16")
    _declare(lib, "lstm_pair_bwd_bf16", 14, 6)
    _declare_wgrad(lib, "lstm_wgrad_bf16")
    return lib


def _declare_stack(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The stack's entry points' types on ``lib`` (csrc/lstm_stack.cu's or
    csrc/lstm_stack_bwd.cu's build), whichever it holds."""
    ptr, i32, out = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    arr = ctypes.POINTER(ctypes.c_void_p)
    for name, argtypes in (
            ("lstm_stack_fwd", [ptr] + [arr] * 6 + [i32] * 7 + [ptr]),
            ("lstm_stack_row_tile", [i32] * 7 + [out]),
            ("lstm_stack_bwd", [ptr, ptr] + [arr] * 7 + [i32] * 7 + [ptr]),
            ("lstm_stack_bwd_row_tile", [i32] * 6 + [out]),
            ("lstm_stack_fwd_bf16", [ptr] + [arr] * 6 + [i32] * 7 + [ptr]),
            ("lstm_stack_row_tile_bf16", [i32] * 7 + [out]),
            ("lstm_stack_bwd_bf16",
             [ptr, ptr] + [arr] * 6 + [ptr, arr] + [i32] * 7 + [ptr]),
            ("lstm_stack_bwd_row_tile_bf16", [i32] * 6 + [out])):
        if hasattr(lib, name):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = i32
    return lib


@functools.cache
def _stack_library() -> ctypes.CDLL:
    """csrc/lstm_stack.cu (the forward, f32), built at first use, with its
    functions' types."""
    lib = _declare_stack(load_library("lstm_stack"))
    i32 = ctypes.c_int
    for name in ("lstm_stack_max_layers", "lstm_stack_max_hidden"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i32
    _check_max_hidden("lstm_stack", lib.lstm_stack_max_hidden())
    if lib.lstm_stack_max_layers() != MAX_STACK_LAYERS:
        raise RuntimeError(
            f"csrc/lstm_stack.cu takes L <= {lib.lstm_stack_max_layers()}, "
            f"the wrapper assumes {MAX_STACK_LAYERS}"
        )
    return lib


@functools.cache
def _stack_bwd_library() -> ctypes.CDLL:
    """csrc/lstm_stack_bwd.cu (the backward sweep, f32), built at first
    use, with its functions' types."""
    return _declare_stack(load_library("lstm_stack_bwd"))


@functools.cache
def _stack_bf16_library() -> ctypes.CDLL:
    """csrc/lstm_stack_bf16.cu (the stack's bf16 forward), built at first
    use."""
    return _declare_stack(load_library("lstm_stack_bf16"))


@functools.cache
def _stack_bwd_bf16_library() -> ctypes.CDLL:
    """csrc/lstm_stack_bwd_bf16.cu (the stack's bf16 sweep), built at first
    use."""
    return _declare_stack(load_library("lstm_stack_bwd_bf16"))


@functools.cache
def _tb_library() -> ctypes.CDLL:
    """csrc/lstm_tb.cu, built at first use, with its functions' types."""
    lib = load_library("lstm_tb")
    i32, out = ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    _declare(lib, "lstm_tb_fwd", 4, 5)
    _declare(lib, "lstm_tb_bwd", 7, 5)
    lib.lstm_tb_row_tiles.argtypes = [i32, i32, out]
    lib.lstm_tb_row_tiles.restype = i32
    lib.lstm_tb_time_chunk.argtypes = [i32] * 6 + [out]
    lib.lstm_tb_time_chunk.restype = i32
    lib.lstm_tb_max_hidden.argtypes = []
    lib.lstm_tb_max_hidden.restype = i32
    _check_max_hidden("lstm_tb", lib.lstm_tb_max_hidden())
    return lib


def _check_max_hidden(name: str, got: int) -> None:
    if got != MAX_HIDDEN:
        raise RuntimeError(
            f"csrc/{name}.cu takes H <= {got}, the wrapper assumes {MAX_HIDDEN}"
        )


def _check_operand(name: str, t: torch.Tensor, shape: tuple, device,
                   dtype: torch.dtype = torch.float32) -> None:
    if t.dtype != dtype:
        if dtype == torch.float32:
            raise TypeError(f"{name}: the CUDA kernels take float32, got {t.dtype}")
        raise TypeError(f"{name}: this launch takes {dtype} operands alike, "
                        f"got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_sizes(n_t: int, b: int, hidden: int) -> None:
    if n_t < 1 or b < 1:
        raise ValueError(f"empty recurrence: T={n_t}, rows={b}")
    if not 1 <= hidden <= MAX_HIDDEN:
        raise ValueError(
            f"hidden size {hidden} outside the kernels' range 1..{MAX_HIDDEN}"
        )


def _raise_on_error(kernel: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(
            f"{kernel} launch failed: CUDA error {err} "
            f"({_library().lstm_error_string(err).decode()})"
        )


def _shapes(x_proj: torch.Tensor) -> tuple[int, int, int]:
    n_t, b, four_h = x_proj.shape
    _check_sizes(n_t, b, four_h // 4)
    return n_t, b, four_h // 4


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


#: The streams a ``global`` CUDA graph capture is underway on
#: (``capturing``): checked from every thread.
_CAPTURE_STREAMS: set[int] = set()
#: This thread's streams of ``thread_local`` captures: checked from it only.
_LOCAL = threading.local()


@contextlib.contextmanager
def capturing(stream, mode: str = "global"):
    """Mark a CUDA graph capture on ``stream`` as underway: until it ends, a
    kernel wrapper whose current stream is another one raises instead of
    launching outside the graph. A ``global`` capture (training) holds every
    thread to it: a backward run by the autograd engine's thread launches
    on the stream its forward ran on, the capture's. A ``thread_local`` one
    (a serving bucket) holds only the capturing thread: another thread's
    launches on its own stream (a sibling replica's warm-up run) are real,
    and go on."""
    key = stream.cuda_stream
    if mode == "global":
        streams = _CAPTURE_STREAMS
    else:
        streams = _LOCAL.__dict__.setdefault("streams", set())
    streams.add(key)
    try:
        yield
    finally:
        streams.discard(key)


def _stream(dev: torch.device) -> int:
    stream = torch.cuda.current_stream(dev).cuda_stream
    local = getattr(_LOCAL, "streams", None) or set()
    capturing_on = _CAPTURE_STREAMS | local
    if capturing_on and stream not in capturing_on:
        raise RuntimeError(
            "a kernel would launch outside the CUDA graph being captured "
            f"(stream {stream:#x}, capturing on "
            f"{sorted(map(hex, capturing_on))})"
        )
    return stream


def _launch_fwd(x_proj, w_hh_t, return_c: bool, lead: tuple, tile: int):
    """One launch of the single-layer forward over ``lead`` (``()`` or
    ``(R,)``) replicas, after the wrappers' checks."""
    n_t, b, hidden = _shapes(x_proj[0] if lead else x_proj)
    dev = x_proj.device
    _check_operand("x_proj", x_proj, lead + (n_t, b, 4 * hidden), dev)
    _check_operand("w_hh_t", w_hh_t, lead + (hidden, 4 * hidden), dev)
    lib = _library()
    hs = torch.empty(lead + (n_t, b, hidden), device=dev, dtype=torch.float32)
    cs = torch.empty_like(hs) if return_c else None
    err = lib.lstm_fwd(
        x_proj.data_ptr(), w_hh_t.data_ptr(), hs.data_ptr(), _ptr(cs),
        n_t, b, hidden, lead[0] if lead else 1, tile, dev.index, _stream(dev),
    )
    name = "lstm_fwd_stacked" if lead else "lstm_fwd"
    _raise_on_error(name, err)
    LAUNCHES.count(name)
    return (hs, cs) if return_c else hs


def lstm_fwd_cuda(x_proj: torch.Tensor, w_hh_t: torch.Tensor,
                  return_c: bool = False):
    """Launch the single-layer kernel; ``hs`` or ``(hs, cs)`` as the plain
    version returns them."""
    return _launch_fwd(x_proj, w_hh_t, return_c, (), 0)


def lstm_fwd_stacked_cuda(x_proj: torch.Tensor, w_hh_t: torch.Tensor,
                          return_c: bool = False, tile: int = 0):
    """Launch the single-layer kernel once for R replicas (``x_proj (R, T,
    B, 4H)``, ``w_hh_t (R, H, 4H)``); ``hs`` or ``(hs, cs)`` ``(R, T, B,
    H)``, each replica's slice the solo kernel's on its slices. ``tile`` 0
    takes the row tile from the R replicas' rows within the solo tile's
    summation class (``lstm_sweep_tile_cuda``, the pair's rule); 1, 2, 4 or
    8 names it.
    Counted as ``lstm_fwd_stacked``."""
    return _launch_fwd(x_proj, w_hh_t, return_c, _replicas(x_proj)[:1], tile)


def _launch_tb_fwd(x_proj, w_hh_t, return_c: bool, lead: tuple):
    """One launch of the time-blocked forward over ``lead`` (``()`` or
    ``(R,)``) replicas, after the wrappers' checks."""
    n_t, b, hidden = _shapes(x_proj[0] if lead else x_proj)
    dev = x_proj.device
    _check_operand("x_proj", x_proj, lead + (n_t, b, 4 * hidden), dev)
    _check_operand("w_hh_t", w_hh_t, lead + (hidden, 4 * hidden), dev)
    lib = _tb_library()
    hs = torch.empty(lead + (n_t, b, hidden), device=dev, dtype=torch.float32)
    cs = torch.empty_like(hs) if return_c else None
    err = lib.lstm_tb_fwd(
        x_proj.data_ptr(), w_hh_t.data_ptr(), hs.data_ptr(), _ptr(cs),
        n_t, b, hidden, lead[0] if lead else 1, dev.index, _stream(dev),
    )
    name = "lstm_tb_fwd_stacked" if lead else "lstm_tb_fwd"
    _raise_on_error(name, err)
    LAUNCHES.count(name)
    return (hs, cs) if return_c else hs


def lstm_tb_fwd_cuda(x_proj: torch.Tensor, w_hh_t: torch.Tensor,
                     return_c: bool = False):
    """Launch the time-blocked forward; ``hs`` or ``(hs, cs)`` as
    ``lstm_tb_fwd_ref`` returns them."""
    return _launch_tb_fwd(x_proj, w_hh_t, return_c, ())


def lstm_tb_fwd_stacked_cuda(x_proj: torch.Tensor, w_hh_t: torch.Tensor,
                             return_c: bool = False):
    """Launch the time-blocked forward once for R replicas (``x_proj (R, T,
    B, 4H)``, ``w_hh_t (R, H, 4H)``); ``hs`` or ``(hs, cs)`` ``(R, T, B,
    H)``, each replica's slice the solo kernel's on its slices. The row tile
    comes from the R replicas' rows within the solo tile's summation class
    (``lstm_sweep_tile_cuda``). Counted as ``lstm_tb_fwd_stacked``."""
    return _launch_tb_fwd(x_proj, w_hh_t, return_c, _replicas(x_proj)[:1])


def _launch_tb_bwd(dhs, x_proj, hs, cs, w_hh_t, lead: tuple):
    """One launch of the time-blocked backward over ``lead`` replicas; the
    dw partials (one per solo row tile and replica) summed replica by
    replica, each as the solo wrapper sums its own."""
    n_t, b, hidden = _shapes(x_proj[0] if lead else x_proj)
    dev = x_proj.device
    _check_operand("x_proj", x_proj, lead + (n_t, b, 4 * hidden), dev)
    for name, t in (("dhs", dhs), ("hs", hs), ("cs", cs)):
        _check_operand(name, t, lead + (n_t, b, hidden), dev)
    _check_operand("w_hh_t", w_hh_t, lead + (hidden, 4 * hidden), dev)
    lib = _tb_library()
    name = "lstm_tb_bwd_stacked" if lead else "lstm_tb_bwd"
    tiles = ctypes.c_int(0)
    _raise_on_error(name, lib.lstm_tb_row_tiles(b, dev.index, ctypes.byref(tiles)))
    dx = torch.empty_like(x_proj)
    dw_part = torch.empty(lead + (tiles.value, hidden, 4 * hidden), device=dev,
                          dtype=torch.float32)
    err = lib.lstm_tb_bwd(
        dhs.data_ptr(), x_proj.data_ptr(), hs.data_ptr(), cs.data_ptr(),
        w_hh_t.data_ptr(), dx.data_ptr(), dw_part.data_ptr(), n_t, b, hidden,
        lead[0] if lead else 1, dev.index, _stream(dev),
    )
    _raise_on_error(name, err)
    LAUNCHES.count(name)
    if not lead:
        return dx, dw_part.sum(dim=0)
    return dx, torch.stack([part.sum(dim=0) for part in dw_part])


def lstm_tb_bwd_cuda(dhs, x_proj, hs, cs, w_hh_t):
    """Launch the time-blocked backward; returns ``(dx (T, B, 4H), dw
    (H, 4H))`` as ``lstm_tb_bwd_ref`` does. The kernel writes one dw partial
    per row tile; they are summed here, in a fixed order."""
    return _launch_tb_bwd(dhs, x_proj, hs, cs, w_hh_t, ())


def lstm_tb_bwd_stacked_cuda(dhs, x_proj, hs, cs, w_hh_t):
    """Launch the time-blocked backward once for R replicas (every operand
    with a leading R axis); ``(dx (R, T, B, 4H), dw (R, H, 4H))``, each
    replica's slices the solo wrapper's. Counted as
    ``lstm_tb_bwd_stacked``."""
    return _launch_tb_bwd(dhs, x_proj, hs, cs, w_hh_t, _replicas(x_proj)[:1])


def lstm_tb_time_chunk_cuda(n_t: int, rows: int, hidden: int,
                            device: torch.device, backward: bool,
                            replicas: int = 1) -> int:
    """The time chunk the time-blocked forward (or backward) kernel takes
    at this shape on ``device`` for ``replicas`` replicas of ``rows`` rows
    each: the longest whose buffers fit a block's shared memory at the
    launch's row tile."""
    device = torch.device(device)
    index = torch.cuda.current_device() if device.index is None else device.index
    tc = ctypes.c_int(0)
    _raise_on_error("lstm_tb_time_chunk", _tb_library().lstm_tb_time_chunk(
        n_t, rows, hidden, replicas, int(backward), index, ctypes.byref(tc)))
    return tc.value


def _check_pair_weights(w_hh1_t, w_ih2_t, bias2, w_hh2_t, hidden, dev,
                        lead: tuple = (), dtype: torch.dtype = torch.float32):
    for name, w in (("w_hh1_t", w_hh1_t), ("w_ih2_t", w_ih2_t),
                    ("w_hh2_t", w_hh2_t)):
        _check_operand(name, w, lead + (hidden, 4 * hidden), dev, dtype)
    _check_operand("bias2", bias2, lead + (4 * hidden,), dev, dtype)


def _compute_dtype(x1_proj: torch.Tensor, lead: tuple, route: str
                   ) -> torch.dtype:
    """The compute dtype of a pair or stack launch, from its projection:
    f32, or bf16 for a solo launch (the replica axes run f32 only)."""
    dtype = x1_proj.dtype
    if dtype not in COMPUTE_DTYPES:
        raise TypeError(f"x1_proj: the {route}'s kernels take float32 or "
                        f"bfloat16, got {dtype}")
    if dtype == torch.bfloat16 and lead:
        raise TypeError(BF16_QUEUED.format(route=f"{route}'s replica axis"))
    return dtype


def _replicas(x1_proj: torch.Tensor) -> tuple[int, int, int, int]:
    """``(R, T, B, H)`` of a stacked ``(R, T, B, 4H)`` projection."""
    if x1_proj.dim() != 4 or x1_proj.shape[0] < 1:
        raise ValueError("a replica-axis launch takes (R, T, B, 4H) inputs, "
                         f"got {tuple(x1_proj.shape)}")
    return (x1_proj.shape[0],) + _shapes(x1_proj[0])


def _launch_pair_fwd(x1_proj, w_hh1_t, w_ih2_t, bias2, w_hh2_t, mask, stash,
                     lead: tuple, tile: int):
    """One launch of the pair forward over ``lead`` (``()`` or ``(R,)``)
    replicas of ``(T, B)`` rows, after the wrappers' checks."""
    n_t, b, hidden = _shapes(x1_proj[0] if lead else x1_proj)
    dev = x1_proj.device
    dtype = _compute_dtype(x1_proj, lead, "pair")
    bf16 = dtype == torch.bfloat16
    _check_operand("x1_proj", x1_proj, lead + (n_t, b, 4 * hidden), dev, dtype)
    _check_pair_weights(w_hh1_t, w_ih2_t, bias2, w_hh2_t, hidden, dev, lead,
                        dtype)
    if mask is not None:
        _check_operand("mask", mask, lead + (n_t, b, hidden), dev, dtype)
    launch = (_fwd_bf16_library().lstm_pair_fwd_bf16 if bf16
              else _library().lstm_pair_fwd)
    planes = [torch.empty(lead + (n_t, b, hidden), device=dev, dtype=dtype)
              for _ in range(4 if stash else 1)]
    h1s, c1s, c2s = planes[1:] if stash else (None, None, None)
    err = launch(
        x1_proj.data_ptr(), _ptr(mask), w_hh1_t.data_ptr(), w_ih2_t.data_ptr(),
        bias2.data_ptr(), w_hh2_t.data_ptr(), planes[0].data_ptr(), _ptr(h1s),
        _ptr(c1s), _ptr(c2s), n_t, b, hidden, lead[0] if lead else 1, tile,
        dev.index, _stream(dev),
    )
    name = "lstm_pair_fwd" if mask is None else "lstm_pair_fwd_masked"
    if lead:
        name += "_stacked"
    if bf16:
        name += "_bf16"
    _raise_on_error(name, err)
    LAUNCHES.count(name)
    return tuple(planes) if stash else planes[0]


def lstm_pair_fwd_cuda(x1_proj, w_hh1_t, w_ih2_t, bias2, w_hh2_t, mask=None,
                       stash: bool = False):
    """Launch the pair kernel; returns ``h2s`` ``(T, B, H)``, or with
    ``stash`` ``(h2s, h1s, c1s, c2s)``. ``mask`` selects the masked
    instance (counted as ``lstm_pair_fwd_masked``). Every operand f32, or
    every operand bf16: the bf16 instance, whose planes are bf16 (counted
    as ``lstm_pair_fwd_bf16`` or ``lstm_pair_fwd_masked_bf16``)."""
    return _launch_pair_fwd(x1_proj, w_hh1_t, w_ih2_t, bias2, w_hh2_t, mask,
                            stash, (), 0)


def lstm_pair_fwd_stacked_cuda(x1_proj, w_hh1_t, w_ih2_t, bias2, w_hh2_t,
                               mask=None, stash: bool = False, tile: int = 0):
    """Launch the pair kernel once for R replicas: every operand with a
    leading R axis (``x1_proj (R, T, B, 4H)``, weights ``(R, H, 4H)``,
    ``bias2 (R, 4H)``, ``mask (R, T, B, H)``); returns ``h2s (R, T, B, H)``
    (and the stashes, likewise), each replica's slice the solo kernel's on
    its slices. ``tile`` 0 takes the row tile from the R replicas' rows,
    within the solo tile's summation class so that the bits stay the solo
    ones (``lstm_sweep_tile_cuda``); 1, 2, 4 or 8 names it. Counted as
    ``lstm_pair_fwd_stacked`` or ``lstm_pair_fwd_masked_stacked``."""
    lead = _replicas(x1_proj)[:1]
    return _launch_pair_fwd(x1_proj, w_hh1_t, w_ih2_t, bias2, w_hh2_t, mask,
                            stash, lead, tile)


def _launch_pair_bwd(dh2s, x1_proj, mask, h1s, c1s, h2s, c2s, w_hh1_t,
                     w_ih2_t, bias2, w_hh2_t, lead: tuple, tile: int):
    n_t, b, hidden = _shapes(x1_proj[0] if lead else x1_proj)
    dev = x1_proj.device
    _check_operand("x1_proj", x1_proj, lead + (n_t, b, 4 * hidden), dev)
    for name, t in (("dh2s", dh2s), ("h1s", h1s), ("c1s", c1s), ("h2s", h2s),
                    ("c2s", c2s)) + ((("mask", mask),) if mask is not None else ()):
        _check_operand(name, t, lead + (n_t, b, hidden), dev)
    _check_pair_weights(w_hh1_t, w_ih2_t, bias2, w_hh2_t, hidden, dev, lead)
    lib = _bwd_library()
    dx1 = torch.empty_like(x1_proj)
    d_pre2 = torch.empty_like(x1_proj)
    err = lib.lstm_pair_bwd(
        dh2s.data_ptr(), x1_proj.data_ptr(), _ptr(mask), h1s.data_ptr(),
        c1s.data_ptr(), h2s.data_ptr(), c2s.data_ptr(), w_hh1_t.data_ptr(),
        w_ih2_t.data_ptr(), bias2.data_ptr(), w_hh2_t.data_ptr(),
        dx1.data_ptr(), d_pre2.data_ptr(), n_t, b, hidden,
        lead[0] if lead else 1, tile, dev.index, _stream(dev),
    )
    name = "lstm_pair_bwd_stacked" if lead else "lstm_pair_bwd"
    _raise_on_error(name, err)
    LAUNCHES.count(name)
    return dx1, d_pre2


def lstm_pair_bwd_cuda(dh2s, x1_proj, mask, h1s, c1s, h2s, c2s, w_hh1_t,
                       w_ih2_t, bias2, w_hh2_t):
    """Launch the pair's backward sweep; returns ``(dx1, d_pre2)``
    ``(T, B, 4H)`` as ``lstm_pair_bwd_ref`` does."""
    return _launch_pair_bwd(dh2s, x1_proj, mask, h1s, c1s, h2s, c2s, w_hh1_t,
                            w_ih2_t, bias2, w_hh2_t, (), 0)


def lstm_pair_bwd_bf16_cuda(dh2s, x1_proj, mask, h1s, c1s, h2s, c2s, w_hh1_t,
                            w_ih2_t, bias2, w_hh2_t):
    """Launch the pair's bf16 sweep on bf16 operands; returns ``(dx1 bf16,
    d_pre1 f32, d_pre2 f32)`` ``(T, B, 4H)`` as ``lstm_pair_bwd_bf16_ref``
    does. Counted as ``lstm_pair_bwd_bf16``."""
    n_t, b, hidden = _shapes(x1_proj)
    dev, bf16 = x1_proj.device, torch.bfloat16
    _check_operand("x1_proj", x1_proj, (n_t, b, 4 * hidden), dev, bf16)
    for name, t in (("dh2s", dh2s), ("h1s", h1s), ("c1s", c1s), ("h2s", h2s),
                    ("c2s", c2s)) + ((("mask", mask),) if mask is not None else ()):
        _check_operand(name, t, (n_t, b, hidden), dev, bf16)
    _check_pair_weights(w_hh1_t, w_ih2_t, bias2, w_hh2_t, hidden, dev, (), bf16)
    lib = _bwd_bf16_library()
    dx1 = torch.empty_like(x1_proj)
    d_pre1 = torch.empty(x1_proj.shape, device=dev, dtype=torch.float32)
    d_pre2 = torch.empty_like(d_pre1)
    err = lib.lstm_pair_bwd_bf16(
        dh2s.data_ptr(), x1_proj.data_ptr(), _ptr(mask), h1s.data_ptr(),
        c1s.data_ptr(), h2s.data_ptr(), c2s.data_ptr(), w_hh1_t.data_ptr(),
        w_ih2_t.data_ptr(), bias2.data_ptr(), w_hh2_t.data_ptr(),
        dx1.data_ptr(), d_pre1.data_ptr(), d_pre2.data_ptr(), n_t, b, hidden,
        1, 0, dev.index, _stream(dev),
    )
    _raise_on_error("lstm_pair_bwd_bf16", err)
    LAUNCHES.count("lstm_pair_bwd_bf16")
    return dx1, d_pre1, d_pre2


def lstm_pair_bwd_stacked_cuda(dh2s, x1_proj, mask, h1s, c1s, h2s, c2s,
                               w_hh1_t, w_ih2_t, bias2, w_hh2_t,
                               tile: int = 0):
    """Launch the pair's backward sweep once for R replicas (every operand
    with a leading R axis); ``(dx1, d_pre2)`` ``(R, T, B, 4H)``, each
    replica's slice the solo sweep's. ``tile`` as in
    ``lstm_pair_fwd_stacked_cuda``; counted as ``lstm_pair_bwd_stacked``."""
    lead = _replicas(x1_proj)[:1]
    return _launch_pair_bwd(dh2s, x1_proj, mask, h1s, c1s, h2s, c2s, w_hh1_t,
                            w_ih2_t, bias2, w_hh2_t, lead, tile)


def lstm_sweep_tile_cuda(rows: int, replicas: int = 1, device=None) -> int:
    """The row tile (1, 2, 4 or 8 rows a block) a pair or single-layer
    forward or sweep of ``replicas`` replicas of ``rows`` rows takes on the
    card."""
    dev = torch.device("cuda" if device is None else device)
    tile = ctypes.c_int(0)
    _raise_on_error("lstm_sweep_tile", _library().lstm_sweep_tile(
        rows, replicas, dev.index or 0, ctypes.byref(tile)))
    return tile.value


def _launch_bwd(dhs, x_proj, hs, cs, w_hh_t, lead: tuple, tile: int):
    n_t, b, hidden = _shapes(x_proj[0] if lead else x_proj)
    dev = x_proj.device
    _check_operand("x_proj", x_proj, lead + (n_t, b, 4 * hidden), dev)
    for name, t in (("dhs", dhs), ("hs", hs), ("cs", cs)):
        _check_operand(name, t, lead + (n_t, b, hidden), dev)
    _check_operand("w_hh_t", w_hh_t, lead + (hidden, 4 * hidden), dev)
    lib = _bwd_library()
    dx = torch.empty_like(x_proj)
    err = lib.lstm_bwd(
        dhs.data_ptr(), x_proj.data_ptr(), hs.data_ptr(), cs.data_ptr(),
        w_hh_t.data_ptr(), dx.data_ptr(), n_t, b, hidden,
        lead[0] if lead else 1, tile, dev.index, _stream(dev),
    )
    name = "lstm_bwd_stacked" if lead else "lstm_bwd"
    _raise_on_error(name, err)
    LAUNCHES.count(name)
    return dx


def lstm_bwd_cuda(dhs, x_proj, hs, cs, w_hh_t) -> torch.Tensor:
    """Launch the single-layer backward sweep; returns ``d_pre``
    ``(T, B, 4H)`` as ``lstm_bwd_ref`` does."""
    return _launch_bwd(dhs, x_proj, hs, cs, w_hh_t, (), 0)


def lstm_bwd_stacked_cuda(dhs, x_proj, hs, cs, w_hh_t,
                          tile: int = 0) -> torch.Tensor:
    """Launch the single-layer sweep once for R replicas (every operand
    with a leading R axis); ``d_pre (R, T, B, 4H)``, each replica's slice
    the solo sweep's. ``tile`` as in ``lstm_fwd_stacked_cuda``; counted as
    ``lstm_bwd_stacked``."""
    return _launch_bwd(dhs, x_proj, hs, cs, w_hh_t, _replicas(x_proj)[:1],
                       tile)


def lstm_wgrad_cuda(jobs) -> list:
    """Launch the weight-gradient pass for up to 15 jobs (a stack of 8's
    2L - 1) ``(d_pre, src, shift, mask, with_bias)`` over the same (T, B)
    rows.

    Returns one ``(dW (H, 4H), db (4H,) or None)`` per job, each as
    ``lstm_wgrad_ref`` (and ``d_pre.sum((0, 1))``) computes it. ``d_pre``
    is f32; every ``src`` and mask f32, or every one bf16 (the pair's or
    the stack's bf16 stashes: the bf16 instance, whose sums are f32 and
    whose outputs are rounded to bf16 once, counted as
    ``lstm_wgrad_bf16``).
    """
    return _launch_wgrad(jobs, ())


def _launch_wgrad(jobs, lead: tuple) -> list:
    """One launch of the pass over ``lead`` (``()`` or ``(R,)``) replicas:
    every operand of a job, and so every output, with the leading axis.
    The splits are the solo pass's for this many jobs, so replica r's sums
    run in its solo pass's order."""
    n_t, b, hidden = _shapes(jobs[0][0][0] if lead else jobs[0][0])
    dev = jobs[0][0].device
    dtype = jobs[0][1].dtype
    if dtype not in COMPUTE_DTYPES:
        raise TypeError(f"src: the pass takes float32 or bfloat16, got {dtype}")
    bf16 = dtype == torch.bfloat16
    if bf16 and lead:
        raise TypeError(BF16_QUEUED.format(route="replica axis"))
    for d_pre, src, _, mask, _ in jobs:
        _check_operand("d_pre", d_pre, lead + (n_t, b, 4 * hidden), dev)
        _check_operand("src", src, lead + (n_t, b, hidden), dev, dtype)
        if mask is not None:
            _check_operand("mask", mask, lead + (n_t, b, hidden), dev, dtype)
    lib = _bwd_library()
    n = len(jobs)
    replicas = lead[0] if lead else 1
    splits = ctypes.c_int(0)
    _raise_on_error("lstm_wgrad", lib.lstm_wgrad_splits(
        n, n_t, b, hidden, dev.index, ctypes.byref(splits)))
    part = torch.empty((replicas * n * splits.value * (hidden + 1) * 4 * hidden,),
                       device=dev, dtype=torch.float32)
    outs = [torch.empty(lead + (hidden, 4 * hidden), device=dev, dtype=dtype)
            for _ in jobs]
    biases = [torch.empty(lead + (4 * hidden,), device=dev, dtype=dtype)
              if job[4] else None for job in jobs]

    def array(values, ctype=ctypes.c_void_p):
        return (ctype * n)(*values)

    launch = _bwd_bf16_library().lstm_wgrad_bf16 if bf16 else lib.lstm_wgrad
    err = launch(
        n,
        array(_ptr(job[1]) for job in jobs),
        array(_ptr(job[3]) for job in jobs),
        array(_ptr(job[0]) for job in jobs),
        array(_ptr(o) for o in outs),
        array(_ptr(bias) for bias in biases),
        array((job[2] for job in jobs), ctypes.c_int),
        part.data_ptr(), splits.value, n_t, b, hidden, replicas, dev.index,
        _stream(dev),
    )
    name = ("lstm_wgrad_stacked" if lead
            else "lstm_wgrad_bf16" if bf16 else "lstm_wgrad")
    _raise_on_error(name, err)
    LAUNCHES.count(name)
    return list(zip(outs, biases))


def _pointers(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * max(1, len(tensors)))(*map(_ptr, tensors))


def _check_stack(x1_proj, w_hh_ts, w_in_ts, biases, masks, planes=(),
                 lead: tuple = (), dtype: torch.dtype = torch.float32
                 ) -> tuple[int, int, int, int, torch.device]:
    """Shapes, device, dtype (every operand ``dtype``) and contiguity of a
    stack call over ``lead`` (``()`` or ``(R,)``) replicas; its sizes."""
    n_t, b, hidden = _shapes(x1_proj[0] if lead else x1_proj)
    n_layers = len(w_hh_ts)
    if not MIN_STACK_LAYERS <= n_layers <= MAX_STACK_LAYERS:
        raise ValueError(
            f"the stack kernels take {MIN_STACK_LAYERS}..{MAX_STACK_LAYERS} "
            f"layers, got {n_layers}"
        )
    seams = n_layers - 1
    if len(w_in_ts) != seams or len(biases) != seams or (
            masks is not None and len(masks) != seams):
        raise ValueError(f"{n_layers} layers take {seams} seam weights, "
                         f"biases and masks each")
    dev = x1_proj.device
    _check_operand("x1_proj", x1_proj, lead + (n_t, b, 4 * hidden), dev, dtype)
    for name, group in (("w_hh_ts", w_hh_ts), ("w_in_ts", w_in_ts)):
        for i, w in enumerate(group):
            _check_operand(f"{name}[{i}]", w, lead + (hidden, 4 * hidden), dev,
                           dtype)
    for i, bias in enumerate(biases):
        _check_operand(f"biases[{i}]", bias, lead + (4 * hidden,), dev, dtype)
    for name, group in (("masks", masks or ()),) + tuple(planes):
        for i, t in enumerate(group):
            _check_operand(f"{name}[{i}]", t, lead + (n_t, b, hidden), dev,
                           dtype)
    return n_t, b, hidden, n_layers, dev


def _launch_stack_fwd(x1_proj, w_hh_ts, w_in_ts, biases, masks, stash: bool,
                      lead: tuple, tile: int):
    dtype = _compute_dtype(x1_proj, lead, "stack")
    bf16 = dtype == torch.bfloat16
    n_t, b, hidden, n_layers, dev = _check_stack(x1_proj, w_hh_ts, w_in_ts,
                                                 biases, masks, lead=lead,
                                                 dtype=dtype)
    launch = (_stack_bf16_library().lstm_stack_fwd_bf16 if bf16
              else _stack_library().lstm_stack_fwd)

    def plane():
        return torch.empty(lead + (n_t, b, hidden), device=dev, dtype=dtype)

    hs = [plane() if stash or layer == n_layers - 1 else None
          for layer in range(n_layers)]
    cs = [plane() if stash else None for _ in range(n_layers)]
    err = launch(
        x1_proj.data_ptr(), None if masks is None else _pointers(masks),
        _pointers(w_hh_ts), _pointers(w_in_ts), _pointers(biases),
        _pointers(hs), _pointers(cs), n_layers, n_t, b, hidden,
        lead[0] if lead else 1, tile, dev.index, _stream(dev),
    )
    name = "lstm_stack_fwd" if masks is None else "lstm_stack_fwd_masked"
    if lead:
        name += "_stacked"
    if bf16:
        name += "_bf16"
    _raise_on_error(name, err)
    LAUNCHES.count(name)
    return (hs, cs) if stash else hs[-1]


def lstm_stack_fwd_cuda(x1_proj, w_hh_ts, w_in_ts, biases, masks=None,
                        stash: bool = False):
    """Launch the stack's forward kernel; returns the top layer's ``hs``
    ``(T, B, H)``, or with ``stash`` ``(hs, cs)`` as ``lstm_stack_ref``
    returns them. ``masks`` selects the masked instance (counted as
    ``lstm_stack_fwd_masked``). Every operand f32, or every operand bf16:
    the bf16 instance, whose planes are bf16 (counted as
    ``lstm_stack_fwd_bf16`` or ``lstm_stack_fwd_masked_bf16``)."""
    return _launch_stack_fwd(x1_proj, w_hh_ts, w_in_ts, biases, masks, stash,
                             (), 0)


def lstm_stack_fwd_stacked_cuda(x1_proj, w_hh_ts, w_in_ts, biases, masks=None,
                                stash: bool = False, tile: int = 0):
    """Launch the stack's forward once for R replicas: ``x1_proj (R, T, B,
    4H)``, each layer's weight ``(R, H, 4H)``, each seam's bias ``(R, 4H)``
    and mask ``(R, T, B, H)``; the top layer's ``hs (R, T, B, H)`` (and with
    ``stash`` every layer's h and c, likewise), each replica's slice the
    solo launch's. ``tile`` 0 takes the row tile from the R replicas' rows
    within the solo tile's summation class; 1, 2, 4 or 8 names it. Counted
    as ``lstm_stack_fwd_stacked`` or ``lstm_stack_fwd_masked_stacked``."""
    return _launch_stack_fwd(x1_proj, w_hh_ts, w_in_ts, biases, masks, stash,
                             _replicas(x1_proj)[:1], tile)


def _launch_stack_bwd(dh_top, x1_proj, masks, hs, cs, w_hh_ts, w_in_ts,
                      biases, lead: tuple, tile: int) -> list:
    n_t, b, hidden, n_layers, dev = _check_stack(
        x1_proj, w_hh_ts, w_in_ts, biases, masks,
        planes=(("dh_top", (dh_top,)), ("hs", hs), ("cs", cs)), lead=lead)
    if len(hs) != n_layers or len(cs) != n_layers:
        raise ValueError(f"{n_layers} layers take {n_layers} h and c stashes")
    lib = _stack_bwd_library()
    d_pres = [torch.empty_like(x1_proj) for _ in range(n_layers)]
    err = lib.lstm_stack_bwd(
        dh_top.data_ptr(), x1_proj.data_ptr(),
        None if masks is None else _pointers(masks), _pointers(hs),
        _pointers(cs), _pointers(w_hh_ts), _pointers(w_in_ts),
        _pointers(biases), _pointers(d_pres), n_layers, n_t, b, hidden,
        lead[0] if lead else 1, tile, dev.index, _stream(dev),
    )
    name = "lstm_stack_bwd_stacked" if lead else "lstm_stack_bwd"
    _raise_on_error(name, err)
    LAUNCHES.count(name)
    return d_pres


def lstm_stack_bwd_cuda(dh_top, x1_proj, masks, hs, cs, w_hh_ts, w_in_ts,
                        biases) -> list:
    """Launch the stack's backward sweep; returns every layer's ``d_pre``
    ``(T, B, 4H)`` as ``lstm_stack_bwd_ref`` does."""
    return _launch_stack_bwd(dh_top, x1_proj, masks, hs, cs, w_hh_ts, w_in_ts,
                             biases, (), 0)


def lstm_stack_bwd_bf16_cuda(dh_top, x1_proj, masks, hs, cs, w_hh_ts,
                             w_in_ts, biases):
    """Launch the stack's bf16 sweep on bf16 operands; returns ``(dx1 bf16
    (T, B, 4H), d_pres list[L] f32 (T, B, 4H))`` as
    ``lstm_stack_bwd_bf16_ref`` does. Counted as ``lstm_stack_bwd_bf16``."""
    bf16 = torch.bfloat16
    n_t, b, hidden, n_layers, dev = _check_stack(
        x1_proj, w_hh_ts, w_in_ts, biases, masks,
        planes=(("dh_top", (dh_top,)), ("hs", hs), ("cs", cs)), dtype=bf16)
    if len(hs) != n_layers or len(cs) != n_layers:
        raise ValueError(f"{n_layers} layers take {n_layers} h and c stashes")
    lib = _stack_bwd_bf16_library()
    dx1 = torch.empty_like(x1_proj)
    d_pres = [torch.empty(x1_proj.shape, device=dev, dtype=torch.float32)
              for _ in range(n_layers)]
    err = lib.lstm_stack_bwd_bf16(
        dh_top.data_ptr(), x1_proj.data_ptr(),
        None if masks is None else _pointers(masks), _pointers(hs),
        _pointers(cs), _pointers(w_hh_ts), _pointers(w_in_ts),
        _pointers(biases), dx1.data_ptr(), _pointers(d_pres), n_layers, n_t,
        b, hidden, 1, 0, dev.index, _stream(dev),
    )
    _raise_on_error("lstm_stack_bwd_bf16", err)
    LAUNCHES.count("lstm_stack_bwd_bf16")
    return dx1, d_pres


def lstm_stack_bwd_stacked_cuda(dh_top, x1_proj, masks, hs, cs, w_hh_ts,
                                w_in_ts, biases, tile: int = 0) -> list:
    """Launch the stack's backward sweep once for R replicas (every operand
    with a leading R axis, the per-layer ones in their lists); every layer's
    ``d_pre (R, T, B, 4H)``, each replica's slice the solo sweep's. ``tile``
    as in ``lstm_stack_fwd_stacked_cuda``; counted as
    ``lstm_stack_bwd_stacked``."""
    return _launch_stack_bwd(dh_top, x1_proj, masks, hs, cs, w_hh_ts, w_in_ts,
                             biases, _replicas(x1_proj)[:1], tile)


def lstm_stack_row_tile_cuda(n_layers: int, rows: int, hidden: int,
                             device: torch.device, backward: bool,
                             masked: bool = False, stash: bool = False,
                             replicas: int = 1,
                             dtype: torch.dtype = torch.float32) -> int:
    """The row tile a stack launch of ``n_layers`` layers on ``replicas``
    replicas of ``rows`` rows takes on ``device``: the forward's (with or
    without the mask and the stash) or the backward sweep's (with or
    without the mask), of the f32 or the bf16 (``dtype``) instances."""
    _check_sizes(1, rows, hidden)
    device = torch.device(device)
    index = torch.cuda.current_device() if device.index is None else device.index
    tile = ctypes.c_int(0)
    bf16 = dtype == torch.bfloat16
    if backward:
        lib = _stack_bwd_bf16_library() if bf16 else _stack_bwd_library()
        query = (lib.lstm_stack_bwd_row_tile_bf16 if bf16
                 else lib.lstm_stack_bwd_row_tile)
        err = query(n_layers, rows, hidden, int(masked), replicas, index,
                    ctypes.byref(tile))
    else:
        lib = _stack_bf16_library() if bf16 else _stack_library()
        query = lib.lstm_stack_row_tile_bf16 if bf16 else lib.lstm_stack_row_tile
        err = query(n_layers, rows, hidden, int(masked), int(stash), replicas,
                    index, ctypes.byref(tile))
    _raise_on_error("lstm_stack_row_tile", err)
    return tile.value


def lstm_stack_wgrad(d_pres, hs, masks=None):
    """The stack's weight gradients ``(dW_hh list[L], dW_in list[L-1],
    db list[L-1])``: one launch of the reduction pass over its 2L - 1 jobs
    for a CUDA tensor, the plain version for a CPU tensor. With bf16
    stashes ``d_pres`` are the sweep's f32 planes and the gradients are
    bf16 (``lstm_wgrad_bf16``)."""
    if _device_type(d_pres[0]) == "cpu":
        return lstm_stack_wgrad_ref(d_pres, hs, masks)
    n_layers = len(d_pres)
    outs = lstm_wgrad_cuda(_stack_wgrad_jobs(d_pres, hs, masks))
    return ([dw for dw, _ in outs[:n_layers]], [dw for dw, _ in outs[n_layers:]],
            [db for _, db in outs[n_layers:]])


def lstm_pair_wgrad(dx1, d_pre2, h1s, h2s, mask=None):
    """The pair's weight gradients ``(dW_hh1, dW_ih2, db2, dW_hh2)``: one
    launch of the reduction pass for a CUDA tensor, the plain version for a
    CPU tensor. With bf16 stashes ``dx1`` is layer 1's f32 d_pre (the
    sweep's ``d_pre1``) and the gradients are bf16."""
    if _device_type(dx1) == "cpu":
        return lstm_pair_wgrad_ref(dx1, d_pre2, h1s, h2s, mask)
    (dw1, _), (dwi2, db2), (dw2, _) = lstm_wgrad_cuda([
        (dx1, h1s, 1, None, False),
        (d_pre2, h1s, 0, mask, True),
        (d_pre2, h2s, 1, None, False),
    ])
    return dw1, dwi2, db2, dw2


def lstm_pair_wgrad_stacked(dx1, d_pre2, h1s, h2s, mask=None):
    """The pair's weight gradients for R replicas, every operand and
    gradient with a leading R axis: one launch of the pass over R x 3 jobs
    for a CUDA tensor (``lstm_wgrad_stacked``), the plain version replica
    by replica for a CPU tensor."""
    if _device_type(dx1) == "cpu":
        return lstm_pair_wgrad_stacked_ref(dx1, d_pre2, h1s, h2s, mask)
    (dw1, _), (dwi2, db2), (dw2, _) = _launch_wgrad([
        (dx1, h1s, 1, None, False),
        (d_pre2, h1s, 0, mask, True),
        (d_pre2, h2s, 1, None, False),
    ], _replicas(dx1)[:1])
    return dw1, dwi2, db2, dw2


def lstm_single_wgrad(dx, hs) -> torch.Tensor:
    """One layer's recurrent weight gradient ``sum h[t-1]ᵀ dx[t]``."""
    if _device_type(dx) == "cpu":
        return lstm_wgrad_ref(dx, hs, 1)
    return lstm_wgrad_cuda([(dx, hs, 1, None, False)])[0][0]


def lstm_single_wgrad_stacked(dx, hs) -> torch.Tensor:
    """One layer's recurrent weight gradient for R replicas ``(R, H, 4H)``:
    one launch of the pass over R x 1 job for a CUDA tensor
    (``lstm_wgrad_stacked``), the plain version replica by replica for a
    CPU tensor."""
    if _device_type(dx) == "cpu":
        return lstm_single_wgrad_stacked_ref(dx, hs)
    return _launch_wgrad([(dx, hs, 1, None, False)], _replicas(dx)[:1])[0][0]


def lstm_stack_wgrad_stacked(d_pres, hs, masks=None):
    """The stack's weight gradients for R replicas, each ``(R, ...)`` in
    its list: one launch of the pass over R x (2L - 1) jobs for a CUDA
    tensor (``lstm_wgrad_stacked``), the plain version replica by replica
    for a CPU tensor."""
    if _device_type(d_pres[0]) == "cpu":
        return lstm_stack_wgrad_stacked_ref(d_pres, hs, masks)
    n_layers = len(d_pres)
    outs = _launch_wgrad(_stack_wgrad_jobs(d_pres, hs, masks),
                         _replicas(d_pres[0])[:1])
    return ([dw for dw, _ in outs[:n_layers]], [dw for dw, _ in outs[n_layers:]],
            [db for _, db in outs[n_layers:]])


# ------------------------------------------------------ autograd functions


def _device_type(t: torch.Tensor) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


class _PairFunction(torch.autograd.Function):
    """The layer pair with its hand-written backward; the mask gets no
    gradient. Forward saves the stashes, backward recomputes from them."""

    @staticmethod
    def forward(ctx, x1_proj, w_hh1_t, w_ih2_t, bias2, w_hh2_t, mask):
        if _device_type(x1_proj) == "cuda":
            h2s, h1s, c1s, c2s = lstm_pair_fwd_cuda(
                x1_proj, w_hh1_t, w_ih2_t, bias2, w_hh2_t, mask, stash=True
            )
        else:
            h2s, h1s, c1s, c2s = lstm_pair_ref(
                x1_proj, w_hh1_t, w_ih2_t, bias2, w_hh2_t, mask,
                return_stash=True,
            )
        ctx.save_for_backward(x1_proj, w_hh1_t, w_ih2_t, bias2, w_hh2_t, mask,
                              h1s, c1s, h2s, c2s)
        return h2s

    @staticmethod
    def backward(ctx, dh2s):
        x1_proj, w1, wi2, b2, w2, mask, h1s, c1s, h2s, c2s = ctx.saved_tensors
        dh2s = dh2s.contiguous()
        args = (dh2s, x1_proj, mask, h1s, c1s, h2s, c2s, w1, wi2, b2, w2)
        cuda = _device_type(x1_proj) == "cuda"
        if x1_proj.dtype == torch.bfloat16:
            # bf16: the pass sums over layer 1's f32 d_pre, not over the
            # rounded dx1 that the projection takes; every gradient bf16.
            dx1, d_pre1, d_pre2 = (lstm_pair_bwd_bf16_cuda if cuda
                                   else lstm_pair_bwd_bf16_ref)(*args)
        else:
            dx1, d_pre2 = (lstm_pair_bwd_cuda if cuda
                           else lstm_pair_bwd_ref)(*args)
            d_pre1 = dx1  # f32: dx1 is layer 1's d_pre
        dw1, dwi2, db2, dw2 = lstm_pair_wgrad(d_pre1, d_pre2, h1s, h2s, mask)
        return dx1, dw1, dwi2, db2, dw2, None


class _StackedPairFunction(torch.autograd.Function):
    """R layer pairs with a leading replica axis on every operand, each
    replica's forward, sweep and weight gradients those of ``_PairFunction``
    on its slices: one launch of each kernel for all R on the card."""

    @staticmethod
    def forward(ctx, x1_proj, w_hh1_t, w_ih2_t, bias2, w_hh2_t, mask):
        if _device_type(x1_proj) == "cuda":
            h2s, h1s, c1s, c2s = lstm_pair_fwd_stacked_cuda(
                x1_proj, w_hh1_t, w_ih2_t, bias2, w_hh2_t, mask, stash=True)
        else:
            h2s, h1s, c1s, c2s = lstm_pair_stacked_ref(
                x1_proj, w_hh1_t, w_ih2_t, bias2, w_hh2_t, mask,
                return_stash=True)
        ctx.save_for_backward(x1_proj, w_hh1_t, w_ih2_t, bias2, w_hh2_t, mask,
                              h1s, c1s, h2s, c2s)
        return h2s

    @staticmethod
    def backward(ctx, dh2s):
        x1_proj, w1, wi2, b2, w2, mask, h1s, c1s, h2s, c2s = ctx.saved_tensors
        dh2s = dh2s.contiguous()
        args = (dh2s, x1_proj, mask, h1s, c1s, h2s, c2s, w1, wi2, b2, w2)
        if _device_type(x1_proj) == "cuda":
            dx1, d_pre2 = lstm_pair_bwd_stacked_cuda(*args)
        else:
            dx1, d_pre2 = lstm_pair_bwd_stacked_ref(*args)
        dw1, dwi2, db2, dw2 = lstm_pair_wgrad_stacked(dx1, d_pre2, h1s, h2s,
                                                      mask)
        return dx1, dw1, dwi2, db2, dw2, None


class _SingleFunction(torch.autograd.Function):
    """One layer with its hand-written backward (odd layer counts)."""

    @staticmethod
    def forward(ctx, x_proj, w_hh_t):
        if _device_type(x_proj) == "cuda":
            hs, cs = lstm_fwd_cuda(x_proj, w_hh_t, return_c=True)
        else:
            hs, cs = lstm_recurrence_ref(x_proj, w_hh_t, return_c=True)
        ctx.save_for_backward(x_proj, w_hh_t, hs, cs)
        return hs

    @staticmethod
    def backward(ctx, dhs):
        x_proj, w_hh_t, hs, cs = ctx.saved_tensors
        args = (dhs.contiguous(), x_proj, hs, cs, w_hh_t)
        if _device_type(x_proj) == "cuda":
            dx = lstm_bwd_cuda(*args)
        else:
            dx = lstm_bwd_ref(*args)
        return dx, lstm_single_wgrad(dx, hs)


class _StackedSingleFunction(torch.autograd.Function):
    """R single layers with a leading replica axis on every operand, each
    replica's forward, sweep and weight gradient those of
    ``_SingleFunction`` on its slices: one launch of each kernel for all R
    on the card."""

    @staticmethod
    def forward(ctx, x_proj, w_hh_t):
        if _device_type(x_proj) == "cuda":
            hs, cs = lstm_fwd_stacked_cuda(x_proj, w_hh_t, return_c=True)
        else:
            hs, cs = lstm_recurrence_stacked_ref(x_proj, w_hh_t, return_c=True)
        ctx.save_for_backward(x_proj, w_hh_t, hs, cs)
        return hs

    @staticmethod
    def backward(ctx, dhs):
        x_proj, w_hh_t, hs, cs = ctx.saved_tensors
        args = (dhs.contiguous(), x_proj, hs, cs, w_hh_t)
        if _device_type(x_proj) == "cuda":
            dx = lstm_bwd_stacked_cuda(*args)
        else:
            dx = lstm_bwd_stacked_ref(*args)
        return dx, lstm_single_wgrad_stacked(dx, hs)


class _TimeBlockedFunction(torch.autograd.Function):
    """One layer through the time-blocked kernels (long lookbacks): the
    forward writes the c stash, the backward recomputes the gates from it
    and returns the weight gradient its sweep accumulated."""

    @staticmethod
    def forward(ctx, x_proj, w_hh_t):
        if _device_type(x_proj) == "cuda":
            hs, cs = lstm_tb_fwd_cuda(x_proj, w_hh_t, return_c=True)
        else:
            hs, cs = lstm_tb_fwd_ref(
                x_proj, w_hh_t, tb_time_chunk(x_proj.shape[1], w_hh_t.shape[0]))
        ctx.save_for_backward(x_proj, w_hh_t, hs, cs)
        return hs

    @staticmethod
    def backward(ctx, dhs):
        x_proj, w_hh_t, hs, cs = ctx.saved_tensors
        args = (dhs.contiguous(), x_proj, hs, cs, w_hh_t)
        if _device_type(x_proj) == "cuda":
            return lstm_tb_bwd_cuda(*args)
        b = x_proj.shape[1]
        return lstm_tb_bwd_ref(*args, tb_time_chunk(b, w_hh_t.shape[0]),
                               _row_tile(b))


class _StackedTimeBlockedFunction(torch.autograd.Function):
    """R single layers through the time-blocked kernels, each replica's
    forward, sweep and weight gradient those of ``_TimeBlockedFunction`` on
    its slices: one launch of each kernel for all R on the card."""

    @staticmethod
    def forward(ctx, x_proj, w_hh_t):
        if _device_type(x_proj) == "cuda":
            hs, cs = lstm_tb_fwd_stacked_cuda(x_proj, w_hh_t, return_c=True)
        else:
            hs, cs = lstm_tb_stacked_ref(
                x_proj, w_hh_t, tb_time_chunk(x_proj.shape[2], w_hh_t.shape[-2]))
        ctx.save_for_backward(x_proj, w_hh_t, hs, cs)
        return hs

    @staticmethod
    def backward(ctx, dhs):
        x_proj, w_hh_t, hs, cs = ctx.saved_tensors
        args = (dhs.contiguous(), x_proj, hs, cs, w_hh_t)
        if _device_type(x_proj) == "cuda":
            return lstm_tb_bwd_stacked_cuda(*args)
        b = x_proj.shape[2]
        return lstm_tb_bwd_stacked_ref(*args, tb_time_chunk(b, w_hh_t.shape[-2]),
                                       _row_tile(b))


class _StackFunction(torch.autograd.Function):
    """The L-deep stack with its hand-written backward; the masks get no
    gradient. Arguments after ``has_mask``: the L recurrent weights, the
    L - 1 seam weights, the L - 1 seam biases, then the L - 1 masks (with
    ``has_mask``). Forward saves the stashes, backward recomputes from them."""

    @staticmethod
    def forward(ctx, x1_proj, n_layers, has_mask, *tensors):
        w_hh, w_in, biases, masks = _split_stack(tensors, n_layers, has_mask)
        if _device_type(x1_proj) == "cuda":
            hs, cs = lstm_stack_fwd_cuda(x1_proj, w_hh, w_in, biases, masks,
                                         stash=True)
        else:
            hs, cs = lstm_stack_ref(x1_proj, w_hh, w_in, biases, masks,
                                    return_stash=True)
        ctx.n_layers, ctx.has_mask = n_layers, has_mask
        ctx.save_for_backward(x1_proj, *tensors, *hs, *cs)
        return hs[-1]

    @staticmethod
    def backward(ctx, dh_top):
        n_layers = ctx.n_layers
        x1_proj, *rest = ctx.saved_tensors
        n_in = len(rest) - 2 * n_layers
        w_hh, w_in, biases, masks = _split_stack(rest[:n_in], n_layers,
                                                 ctx.has_mask)
        hs, cs = rest[n_in:n_in + n_layers], rest[n_in + n_layers:]
        args = (dh_top.contiguous(), x1_proj, masks, hs, cs, w_hh, w_in, biases)
        cuda = _device_type(x1_proj) == "cuda"
        if x1_proj.dtype == torch.bfloat16:
            # bf16: the pass sums over every layer's f32 d_pre, not over
            # the rounded dx1 that the projection takes; every gradient
            # bf16.
            dx1, d_pres = (lstm_stack_bwd_bf16_cuda if cuda
                           else lstm_stack_bwd_bf16_ref)(*args)
        else:
            d_pres = (lstm_stack_bwd_cuda if cuda else lstm_stack_bwd_ref)(*args)
            dx1 = d_pres[0]  # f32: dx1 is layer 0's d_pre
        dw_hh, dw_in, db = lstm_stack_wgrad(d_pres, hs, masks)
        no_masks = [None] * (n_layers - 1 if ctx.has_mask else 0)
        return (dx1, None, None, *dw_hh, *dw_in, *db, *no_masks)


class _StackedStackFunction(torch.autograd.Function):
    """R L-deep stacks with a leading replica axis on every operand (the
    flat argument layout of ``_StackFunction``), each replica's forward,
    sweep and weight gradients those of ``_StackFunction`` on its slices:
    one launch of each kernel for all R on the card."""

    @staticmethod
    def forward(ctx, x1_proj, n_layers, has_mask, *tensors):
        w_hh, w_in, biases, masks = _split_stack(tensors, n_layers, has_mask)
        if _device_type(x1_proj) == "cuda":
            hs, cs = lstm_stack_fwd_stacked_cuda(x1_proj, w_hh, w_in, biases,
                                                 masks, stash=True)
        else:
            hs, cs = lstm_stack_stacked_ref(x1_proj, w_hh, w_in, biases, masks,
                                            return_stash=True)
        ctx.n_layers, ctx.has_mask = n_layers, has_mask
        ctx.save_for_backward(x1_proj, *tensors, *hs, *cs)
        return hs[-1]

    @staticmethod
    def backward(ctx, dh_top):
        n_layers = ctx.n_layers
        x1_proj, *rest = ctx.saved_tensors
        n_in = len(rest) - 2 * n_layers
        w_hh, w_in, biases, masks = _split_stack(rest[:n_in], n_layers,
                                                 ctx.has_mask)
        hs, cs = rest[n_in:n_in + n_layers], rest[n_in + n_layers:]
        args = (dh_top.contiguous(), x1_proj, masks, hs, cs, w_hh, w_in, biases)
        if _device_type(x1_proj) == "cuda":
            d_pres = lstm_stack_bwd_stacked_cuda(*args)
        else:
            d_pres = lstm_stack_bwd_stacked_ref(*args)
        dw_hh, dw_in, db = lstm_stack_wgrad_stacked(d_pres, hs, masks)
        no_masks = [None] * (n_layers - 1 if ctx.has_mask else 0)
        return (d_pres[0], None, None, *dw_hh, *dw_in, *db, *no_masks)


def _split_stack(tensors, n_layers: int, has_mask: bool):
    """``(w_hh, w_in, biases, masks or None)`` from the flat tensor list."""
    seams = n_layers - 1
    w_hh = tuple(tensors[:n_layers])
    w_in = tuple(tensors[n_layers:n_layers + seams])
    biases = tuple(tensors[n_layers + seams:n_layers + 2 * seams])
    masks = tuple(tensors[n_layers + 2 * seams:]) if has_mask else None
    return w_hh, w_in, biases, masks


def _refuse_bf16(x_proj: torch.Tensor, route: str) -> None:
    """Raise for a bf16 projection at a route whose bf16 kernels are not
    ported, on the CPU as on the card."""
    if x_proj.dtype == torch.bfloat16:
        raise TypeError(BF16_QUEUED.format(route=route))


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


# -------------------------------------------------------------- public API


def lstm_recurrence(x_proj: torch.Tensor, w_hh_t: torch.Tensor,
                    window_rows: int | None = None) -> torch.Tensor:
    """Run one LSTM layer's time recurrence over pre-projected inputs.

    Args:
        x_proj: ``(T, B, 4H)`` time-major input projections (``x @ w_ihᵀ``
            plus both biases), gate order i, f, g, o.
        w_hh_t: ``(H, 4H)`` transposed recurrent weight.
        window_rows: rows per window when the B axis is a flattened stack
            of independent windows; it enters the route as in the JAX
            function.

    Returns:
        ``(T, B, H)`` hidden states: the CUDA kernels for a CUDA tensor, the
        plain versions for a CPU tensor; differentiable through the
        hand-written backward when an input needs a gradient. Where the
        reference takes its time-blocked kernels (``single_layer_route``),
        so does the port; otherwise the resident ones. f32 only: a bf16
        tensor raises on either device (``BF16_QUEUED``).
    """
    _refuse_bf16(x_proj, "single layer (resident or time-blocked)")
    n_t, b = x_proj.shape[:2]
    hidden = w_hh_t.shape[0]
    if single_layer_route(n_t, b, hidden, window_rows) == "pallas-timeblocked":
        if _needs_grad(x_proj, w_hh_t):
            return _TimeBlockedFunction.apply(x_proj, w_hh_t)
        if _device_type(x_proj) == "cuda":
            return lstm_tb_fwd_cuda(x_proj, w_hh_t)
        return lstm_tb_fwd_ref(x_proj, w_hh_t, tb_time_chunk(b, hidden))[0]
    if _needs_grad(x_proj, w_hh_t):
        return _SingleFunction.apply(x_proj, w_hh_t)
    if _device_type(x_proj) == "cuda":
        return lstm_fwd_cuda(x_proj, w_hh_t)
    return lstm_recurrence_ref(x_proj, w_hh_t)


def lstm_recurrence_stacked(x_proj: torch.Tensor, w_hh_t: torch.Tensor,
                            window_rows: int | None = None) -> torch.Tensor:
    """R independent single layers, one per replica, as one recurrence: the
    counterpart of ``vmap`` over the JAX ``lstm_recurrence``.

    Args:
        x_proj: ``(R, T, B, 4H)`` each replica's input projections.
        w_hh_t: ``(R, H, 4H)`` each replica's transposed recurrent weight.
        window_rows: as in ``lstm_recurrence``; the route is taken on one
            replica's ``(T, B)`` rows, as ``vmap`` keeps it.

    Returns:
        ``(R, T, B, H)`` hidden states; replica r's slice is what
        ``lstm_recurrence`` gives on replica r's slices. On the card each
        kernel launches once for all R replicas (the ``_stacked`` counts),
        the time-blocked ones where the reference takes them, or raises; a
        CPU tensor runs the plain versions replica by replica. f32 only.
    """
    _refuse_bf16(x_proj, "single layer's replica axis")
    n_t, b = x_proj.shape[1:3]
    hidden = w_hh_t.shape[-2]
    if single_layer_route(n_t, b, hidden, window_rows) == "pallas-timeblocked":
        if _needs_grad(x_proj, w_hh_t):
            return _StackedTimeBlockedFunction.apply(x_proj, w_hh_t)
        if _device_type(x_proj) == "cuda":
            return lstm_tb_fwd_stacked_cuda(x_proj, w_hh_t)
        return lstm_tb_stacked_ref(x_proj, w_hh_t, tb_time_chunk(b, hidden))[0]
    if _needs_grad(x_proj, w_hh_t):
        return _StackedSingleFunction.apply(x_proj, w_hh_t)
    if _device_type(x_proj) == "cuda":
        return lstm_fwd_stacked_cuda(x_proj, w_hh_t)
    return lstm_recurrence_stacked_ref(x_proj, w_hh_t)


def lstm_pair_recurrence(x1_proj, w_hh1_t, w_ih2_t, bias2, w_hh2_t,
                         mask=None):
    """Run two stacked LSTM layers as one wavefront recurrence.

    Args:
        x1_proj: ``(T, B, 4H)`` layer-1 input projections plus both biases.
        w_hh1_t: ``(H, 4H)`` transposed layer-1 recurrent weight.
        w_ih2_t: ``(H, 4H)`` transposed layer-2 input weight.
        bias2: ``(4H,)`` layer-2 combined bias (``b_ih + b_hh``).
        w_hh2_t: ``(H, 4H)`` transposed layer-2 recurrent weight.
        mask: optional ``(T, B, H)`` inter-layer dropout mask, already
            scaled by ``1/(1-p)``, applied to layer 1's outputs before the
            layer-2 projection. It gets no gradient.

    Returns:
        ``(T, B, H)`` layer-2 hidden states: the CUDA kernels for a CUDA
        tensor, the plain versions for a CPU tensor. Without a gradient to
        take, the stash-free forward runs; otherwise the autograd function
        with the hand-written backward. Every operand f32, or every operand
        bf16 (the kernels' bf16 instances; bf16 planes and gradients).
    """
    if _needs_grad(x1_proj, w_hh1_t, w_ih2_t, bias2, w_hh2_t):
        return _PairFunction.apply(x1_proj, w_hh1_t, w_ih2_t, bias2, w_hh2_t,
                                   mask)
    if _device_type(x1_proj) == "cuda":
        return lstm_pair_fwd_cuda(x1_proj, w_hh1_t, w_ih2_t, bias2, w_hh2_t,
                                  mask)
    return lstm_pair_ref(x1_proj, w_hh1_t, w_ih2_t, bias2, w_hh2_t, mask)


def lstm_pair_recurrence_stacked(x1_proj, w_hh1_t, w_ih2_t, bias2, w_hh2_t,
                                 mask=None):
    """R independent layer pairs, one per replica, as one recurrence: the
    counterpart of ``vmap`` over the JAX pair (``lstm_pair_recurrence``).

    Args:
        x1_proj: ``(R, T, B, 4H)`` each replica's layer-1 projections.
        w_hh1_t, w_ih2_t, w_hh2_t: ``(R, H, 4H)`` each replica's weights.
        bias2: ``(R, 4H)``.
        mask: optional ``(R, T, B, H)`` each replica's pre-scaled seam mask.

    Returns:
        ``(R, T, B, H)`` layer-2 hidden states; replica r's slice is what
        ``lstm_pair_recurrence`` gives on replica r's slices. On the card
        each kernel launches once for all R replicas (the ``_stacked``
        counts), or raises; a CPU tensor runs the plain versions replica by
        replica. f32 only.
    """
    _refuse_bf16(x1_proj, "pair's replica axis")
    if _needs_grad(x1_proj, w_hh1_t, w_ih2_t, bias2, w_hh2_t):
        return _StackedPairFunction.apply(x1_proj, w_hh1_t, w_ih2_t, bias2,
                                          w_hh2_t, mask)
    if _device_type(x1_proj) == "cuda":
        return lstm_pair_fwd_stacked_cuda(x1_proj, w_hh1_t, w_ih2_t, bias2,
                                          w_hh2_t, mask)
    return lstm_pair_stacked_ref(x1_proj, w_hh1_t, w_ih2_t, bias2, w_hh2_t,
                                 mask)


def lstm_stack_recurrence(x1_proj, weights, masks=None):
    """Run L stacked LSTM layers as one wavefront recurrence.

    Args:
        x1_proj: ``(T, B, 4H)`` layer-0 input projections plus both biases.
        weights: ``(w_hh_ts, w_in_ts, biases)``: the L transposed recurrent
            weights ``(H, 4H)``, the L - 1 transposed seam input weights
            ``(H, 4H)`` of layers 1..L-1, and their L - 1 combined biases
            ``(4H,)`` (``b_ih + b_hh``), the JAX function's layout.
        masks: optional L - 1 ``(T, B, H)`` inter-layer dropout masks,
            already scaled by ``1/(1-p)``; mask l multiplies layer l's
            output where it enters layer l + 1. They get no gradient.

    Returns:
        ``(T, B, H)`` top-layer hidden states: the CUDA kernels for a CUDA
        tensor (3 <= L <= 8), the plain versions for a CPU tensor. Without a
        gradient to take, the stash-free forward runs; otherwise the
        autograd function with the hand-written backward. Every operand
        f32, or every operand bf16 (the kernels' bf16 instances; bf16
        planes and gradients).
    """
    w_hh_ts, w_in_ts, biases = (tuple(part) for part in weights)
    masks = None if masks is None else tuple(masks)
    if _needs_grad(x1_proj, *w_hh_ts, *w_in_ts, *biases):
        return _StackFunction.apply(x1_proj, len(w_hh_ts), masks is not None,
                                    *w_hh_ts, *w_in_ts, *biases, *(masks or ()))
    if _device_type(x1_proj) == "cuda":
        return lstm_stack_fwd_cuda(x1_proj, w_hh_ts, w_in_ts, biases, masks)
    return lstm_stack_ref(x1_proj, w_hh_ts, w_in_ts, biases, masks)


def lstm_stack_recurrence_stacked(x1_proj, weights, masks=None):
    """R independent L-deep stacks, one per replica, as one recurrence: the
    counterpart of ``vmap`` over the JAX ``lstm_stack_recurrence``.

    Args:
        x1_proj: ``(R, T, B, 4H)`` each replica's layer-0 projections.
        weights: ``(w_hh_ts, w_in_ts, biases)`` as in
            ``lstm_stack_recurrence``, each entry with a leading R axis:
            ``(R, H, 4H)`` weights, ``(R, 4H)`` biases.
        masks: optional L - 1 ``(R, T, B, H)`` pre-scaled seam masks.

    Returns:
        ``(R, T, B, H)`` top-layer hidden states; replica r's slice is what
        ``lstm_stack_recurrence`` gives on replica r's slices. On the card
        each kernel launches once for all R replicas (the ``_stacked``
        counts), or raises; a CPU tensor runs the plain versions replica by
        replica. f32 only.
    """
    _refuse_bf16(x1_proj, "stack's replica axis")
    w_hh_ts, w_in_ts, biases = (tuple(part) for part in weights)
    masks = None if masks is None else tuple(masks)
    if _needs_grad(x1_proj, *w_hh_ts, *w_in_ts, *biases):
        return _StackedStackFunction.apply(
            x1_proj, len(w_hh_ts), masks is not None, *w_hh_ts, *w_in_ts,
            *biases, *(masks or ()))
    if _device_type(x1_proj) == "cuda":
        return lstm_stack_fwd_stacked_cuda(x1_proj, w_hh_ts, w_in_ts, biases,
                                           masks)
    return lstm_stack_stacked_ref(x1_proj, w_hh_ts, w_in_ts, biases, masks)
