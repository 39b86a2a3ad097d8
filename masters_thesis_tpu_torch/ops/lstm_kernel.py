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
``csrc/lstm_bwd.cu``, ``csrc/lstm_stack.cu`` and ``csrc/lstm_tb.cu`` (or
raises), a CPU tensor to the plain versions. When an input needs a gradient, the recurrence runs as a
``torch.autograd.Function`` whose forward also writes the stashes (h and c
planes) and whose backward recomputes the gates from them, as the TPU
kernels do: the serial sweep (``lstm_pair_bwd`` / ``lstm_bwd`` /
``lstm_stack_bwd``), then the weight-gradient reduction (``lstm_wgrad``).
Each kernel counts its launches in ``LAUNCHES`` so a run can show that its
main path went through it.

The CUDA kernels take f32 only and H <= 64; bf16 compute is not ported.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from masters_thesis_tpu_torch.ops._build import load_library

#: Largest hidden size the kernels take (``kMaxHidden`` in csrc/lstm_common.cuh):
#: the pair stages three (H, 4H) f32 weights in one block's shared memory,
#: 192 KiB at H=64, the width of every model in configs/model.
MAX_HIDDEN = 64

#: Depths the stack kernels take: the pair kernel is the 2-deep wavefront,
#: and a cluster holds at most 8 CTAs, one a layer (``kMinLayers`` and
#: ``kMaxLayers`` in csrc/lstm_stack.cu).
MIN_STACK_LAYERS, MAX_STACK_LAYERS = 3, 8

#: Launches of each CUDA kernel since the last reset_launch_counts():
#: ``lstm_pair_fwd`` counts the maskless pair forward (serving, dropout 0),
#: ``lstm_pair_fwd_masked`` the instance with a seam mask (training with
#: dropout), and likewise for the stack; ``lstm_wgrad`` is one call of the
#: weight-gradient pass; ``lstm_tb_fwd`` and ``lstm_tb_bwd`` the time-blocked
#: forward and backward (its weight gradient included).
LAUNCHES: dict[str, int] = {
    "lstm_pair_fwd": 0,
    "lstm_pair_fwd_masked": 0,
    "lstm_fwd": 0,
    "lstm_pair_bwd": 0,
    "lstm_bwd": 0,
    "lstm_wgrad": 0,
    "lstm_stack_fwd": 0,
    "lstm_stack_fwd_masked": 0,
    "lstm_stack_bwd": 0,
    "lstm_tb_fwd": 0,
    "lstm_tb_bwd": 0,
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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


def lstm_pair_ref(x1_proj, w_hh1_t, w_ih2_t, bias2, w_hh2_t, mask=None,
                  return_stash: bool = False):
    """Plain version of the layer pair: two loops and a projection.

    Mirrors ``lstm_pair_xla`` in the JAX package: ``mask`` (optional,
    ``(T, B, H)``, pre-scaled) multiplies layer 1's output at the seam.
    Returns layer 2's ``h2s`` ``(T, B, H)``, or with ``return_stash``
    ``(h2s, h1s, c1s, c2s)``, the planes the backward recomputes from.
    """
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
    ``(dW_hh1, dW_ih2, db2, dW_hh2)``."""
    return (
        lstm_wgrad_ref(dx1, h1s, 1),
        lstm_wgrad_ref(d_pre2, h1s, 0, mask),
        d_pre2.sum(dim=(0, 1)),
        lstm_wgrad_ref(d_pre2, h2s, 1),
    )


def lstm_stack_ref(x1_proj, w_hh_ts, w_in_ts, biases, masks=None,
                   return_stash: bool = False):
    """Plain version of the L-deep stack: chained loops and projections.

    Mirrors ``lstm_stack_xla`` in the JAX package: layer 0 runs over
    ``x1_proj``; layer l >= 1 over ``(m ⊙ h_{l-1}) @ w_in_ts[l-1] +
    biases[l-1]``, with ``masks[l-1]`` (optional, pre-scaled) multiplying
    layer l-1's output. Returns the top layer's ``hs`` ``(T, B, H)``, or with
    ``return_stash`` ``(hs, cs)``, the lists of every layer's h and c planes.
    """
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
    ``(dW_hh list[L], dW_in list[L-1], db list[L-1])``."""
    jobs = _stack_wgrad_jobs(d_pres, hs, masks)
    n_layers = len(d_pres)
    dw = [lstm_wgrad_ref(d_pre, src, shift, mask)
          for d_pre, src, shift, mask, _ in jobs]
    db = [d_pre.sum(dim=(0, 1)) for d_pre, *_ in jobs[n_layers:]]
    return dw[:n_layers], dw[n_layers:], db


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
                          has_mask: bool) -> int:
    """The reference's byte count of an L-layer wavefront backward program,
    in f32 (the port's only compute type)."""
    four_h = 4 * hidden
    ell = n_layers
    planes = n_t * b_pad * hidden * (1 + 2 * ell + (ell - 1) * int(has_mask))
    planes += n_t * b_pad * four_h
    weights = 2 * ((2 * ell - 1) * hidden * four_h + (ell - 1) * four_h)
    scratch = (3 * ell - 1) * b_pad * hidden + (
        (2 * ell - 1) * hidden * four_h + (ell - 1) * four_h
    )
    return (planes + weights + scratch) * 4


#: The reference's budget: the canonical pair (T=60, 104 rows, H=64, masked).
_PAIR_VMEM_BUDGET = _stack_bwd_vmem_bytes(60, 104, 64, 2, True)


def stack_fits(n_t: int, b: int, hidden: int, n_layers: int,
               has_mask: bool) -> bool:
    """True when the reference fuses ``n_layers`` layers over ``b`` rows."""
    b_pad = -(-b // 8) * 8
    return (_stack_bwd_vmem_bytes(n_t, b_pad, hidden, n_layers, has_mask)
            <= _PAIR_VMEM_BUDGET)


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


def _single_layer_vmem_bytes(n_t: int, b: int, hidden: int) -> int:
    """The reference's byte count of the single-layer backward program, in
    f32: one aliased x/dx plane, three (T, tile, H) planes, the weight and
    its gradient, and scratch; separate x and dx planes, double-buffered,
    when the rows span more than one tile."""
    four_h = 4 * hidden
    tile = _row_tile(b)
    b_pad = -(-b // 8) * 8
    if b_pad <= tile:
        planes = n_t * tile * (four_h + 3 * hidden)
    else:
        planes = n_t * tile * (2 * four_h + 3 * hidden) * 2
    scratch = 2 * tile * hidden + hidden * four_h
    weights = 2 * hidden * four_h
    return (planes + weights + scratch) * 4


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
    _declare(lib, "lstm_fwd", 4, 4)
    _declare(lib, "lstm_pair_fwd", 10, 4)
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
    _declare(lib, "lstm_pair_bwd", 13, 4)
    _declare(lib, "lstm_bwd", 6, 4)
    lib.lstm_wgrad_splits.argtypes = [i32] * 5 + [ctypes.POINTER(i32)]
    lib.lstm_wgrad_splits.restype = i32
    lib.lstm_wgrad.argtypes = [i32] + [ptr] * 7 + [i32] * 5 + [ptr]
    lib.lstm_wgrad.restype = i32
    lib.lstm_bwd_max_hidden.argtypes = []
    lib.lstm_bwd_max_hidden.restype = i32
    _check_max_hidden("lstm_bwd", lib.lstm_bwd_max_hidden())
    return lib


@functools.cache
def _stack_library() -> ctypes.CDLL:
    """csrc/lstm_stack.cu, built at first use, with its functions' types."""
    lib = load_library("lstm_stack")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    arr = ctypes.POINTER(ctypes.c_void_p)
    lib.lstm_stack_fwd.argtypes = [ptr] + [arr] * 6 + [i32] * 5 + [ptr]
    lib.lstm_stack_fwd.restype = i32
    lib.lstm_stack_bwd.argtypes = [ptr, ptr] + [arr] * 7 + [i32] * 5 + [ptr]
    lib.lstm_stack_bwd.restype = i32
    lib.lstm_stack_row_tile.argtypes = [i32] * 7 + [ctypes.POINTER(i32)]
    lib.lstm_stack_row_tile.restype = i32
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
def _tb_library() -> ctypes.CDLL:
    """csrc/lstm_tb.cu, built at first use, with its functions' types."""
    lib = load_library("lstm_tb")
    i32, out = ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    _declare(lib, "lstm_tb_fwd", 4, 4)
    _declare(lib, "lstm_tb_bwd", 7, 4)
    lib.lstm_tb_row_tiles.argtypes = [i32, i32, out]
    lib.lstm_tb_row_tiles.restype = i32
    lib.lstm_tb_time_chunk.argtypes = [i32] * 5 + [out]
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


def _check_operand(name: str, t: torch.Tensor, shape: tuple, device) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: the CUDA kernels take float32, got {t.dtype}")
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


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def lstm_fwd_cuda(x_proj: torch.Tensor, w_hh_t: torch.Tensor,
                  return_c: bool = False):
    """Launch the single-layer kernel; ``hs`` or ``(hs, cs)`` as the plain
    version returns them."""
    n_t, b, hidden = _shapes(x_proj)
    dev = x_proj.device
    _check_operand("x_proj", x_proj, (n_t, b, 4 * hidden), dev)
    _check_operand("w_hh_t", w_hh_t, (hidden, 4 * hidden), dev)
    lib = _library()
    hs = torch.empty((n_t, b, hidden), device=dev, dtype=torch.float32)
    cs = torch.empty_like(hs) if return_c else None
    err = lib.lstm_fwd(
        x_proj.data_ptr(), w_hh_t.data_ptr(), hs.data_ptr(), _ptr(cs),
        n_t, b, hidden, dev.index, _stream(dev),
    )
    _raise_on_error("lstm_fwd", err)
    LAUNCHES["lstm_fwd"] += 1
    return (hs, cs) if return_c else hs


def lstm_tb_fwd_cuda(x_proj: torch.Tensor, w_hh_t: torch.Tensor,
                     return_c: bool = False):
    """Launch the time-blocked forward; ``hs`` or ``(hs, cs)`` as
    ``lstm_tb_fwd_ref`` returns them."""
    n_t, b, hidden = _shapes(x_proj)
    dev = x_proj.device
    _check_operand("x_proj", x_proj, (n_t, b, 4 * hidden), dev)
    _check_operand("w_hh_t", w_hh_t, (hidden, 4 * hidden), dev)
    lib = _tb_library()
    hs = torch.empty((n_t, b, hidden), device=dev, dtype=torch.float32)
    cs = torch.empty_like(hs) if return_c else None
    err = lib.lstm_tb_fwd(
        x_proj.data_ptr(), w_hh_t.data_ptr(), hs.data_ptr(), _ptr(cs),
        n_t, b, hidden, dev.index, _stream(dev),
    )
    _raise_on_error("lstm_tb_fwd", err)
    LAUNCHES["lstm_tb_fwd"] += 1
    return (hs, cs) if return_c else hs


def lstm_tb_bwd_cuda(dhs, x_proj, hs, cs, w_hh_t):
    """Launch the time-blocked backward; returns ``(dx (T, B, 4H), dw
    (H, 4H))`` as ``lstm_tb_bwd_ref`` does. The kernel writes one dw partial
    per row tile; they are summed here, in a fixed order."""
    n_t, b, hidden = _shapes(x_proj)
    dev = x_proj.device
    _check_operand("x_proj", x_proj, (n_t, b, 4 * hidden), dev)
    for name, t in (("dhs", dhs), ("hs", hs), ("cs", cs)):
        _check_operand(name, t, (n_t, b, hidden), dev)
    _check_operand("w_hh_t", w_hh_t, (hidden, 4 * hidden), dev)
    lib = _tb_library()
    tiles = ctypes.c_int(0)
    _raise_on_error("lstm_tb_bwd", lib.lstm_tb_row_tiles(
        b, dev.index, ctypes.byref(tiles)))
    dx = torch.empty_like(x_proj)
    dw_part = torch.empty((tiles.value, hidden, 4 * hidden), device=dev,
                          dtype=torch.float32)
    err = lib.lstm_tb_bwd(
        dhs.data_ptr(), x_proj.data_ptr(), hs.data_ptr(), cs.data_ptr(),
        w_hh_t.data_ptr(), dx.data_ptr(), dw_part.data_ptr(), n_t, b, hidden,
        dev.index, _stream(dev),
    )
    _raise_on_error("lstm_tb_bwd", err)
    LAUNCHES["lstm_tb_bwd"] += 1
    return dx, dw_part.sum(dim=0)


def lstm_tb_time_chunk_cuda(n_t: int, rows: int, hidden: int,
                            device: torch.device, backward: bool) -> int:
    """The time chunk the time-blocked forward (or backward) kernel takes
    at this shape on ``device``: the longest whose buffers fit a block's
    shared memory."""
    device = torch.device(device)
    index = torch.cuda.current_device() if device.index is None else device.index
    tc = ctypes.c_int(0)
    _raise_on_error("lstm_tb_time_chunk", _tb_library().lstm_tb_time_chunk(
        n_t, rows, hidden, int(backward), index, ctypes.byref(tc)))
    return tc.value


def _check_pair_weights(w_hh1_t, w_ih2_t, bias2, w_hh2_t, hidden, dev):
    for name, w in (("w_hh1_t", w_hh1_t), ("w_ih2_t", w_ih2_t),
                    ("w_hh2_t", w_hh2_t)):
        _check_operand(name, w, (hidden, 4 * hidden), dev)
    _check_operand("bias2", bias2, (4 * hidden,), dev)


def lstm_pair_fwd_cuda(x1_proj, w_hh1_t, w_ih2_t, bias2, w_hh2_t, mask=None,
                       stash: bool = False):
    """Launch the pair kernel; returns ``h2s`` ``(T, B, H)``, or with
    ``stash`` ``(h2s, h1s, c1s, c2s)``. ``mask`` selects the masked
    instance (counted as ``lstm_pair_fwd_masked``)."""
    n_t, b, hidden = _shapes(x1_proj)
    dev = x1_proj.device
    _check_operand("x1_proj", x1_proj, (n_t, b, 4 * hidden), dev)
    _check_pair_weights(w_hh1_t, w_ih2_t, bias2, w_hh2_t, hidden, dev)
    if mask is not None:
        _check_operand("mask", mask, (n_t, b, hidden), dev)
    lib = _library()
    planes = [torch.empty((n_t, b, hidden), device=dev, dtype=torch.float32)
              for _ in range(4 if stash else 1)]
    h1s, c1s, c2s = planes[1:] if stash else (None, None, None)
    err = lib.lstm_pair_fwd(
        x1_proj.data_ptr(), _ptr(mask), w_hh1_t.data_ptr(), w_ih2_t.data_ptr(),
        bias2.data_ptr(), w_hh2_t.data_ptr(), planes[0].data_ptr(), _ptr(h1s),
        _ptr(c1s), _ptr(c2s), n_t, b, hidden, dev.index, _stream(dev),
    )
    name = "lstm_pair_fwd" if mask is None else "lstm_pair_fwd_masked"
    _raise_on_error(name, err)
    LAUNCHES[name] += 1
    return tuple(planes) if stash else planes[0]


def lstm_pair_bwd_cuda(dh2s, x1_proj, mask, h1s, c1s, h2s, c2s, w_hh1_t,
                       w_ih2_t, bias2, w_hh2_t):
    """Launch the pair's backward sweep; returns ``(dx1, d_pre2)``
    ``(T, B, 4H)`` as ``lstm_pair_bwd_ref`` does."""
    n_t, b, hidden = _shapes(x1_proj)
    dev = x1_proj.device
    _check_operand("x1_proj", x1_proj, (n_t, b, 4 * hidden), dev)
    for name, t in (("dh2s", dh2s), ("h1s", h1s), ("c1s", c1s), ("h2s", h2s),
                    ("c2s", c2s)) + ((("mask", mask),) if mask is not None else ()):
        _check_operand(name, t, (n_t, b, hidden), dev)
    _check_pair_weights(w_hh1_t, w_ih2_t, bias2, w_hh2_t, hidden, dev)
    lib = _bwd_library()
    dx1 = torch.empty_like(x1_proj)
    d_pre2 = torch.empty_like(x1_proj)
    err = lib.lstm_pair_bwd(
        dh2s.data_ptr(), x1_proj.data_ptr(), _ptr(mask), h1s.data_ptr(),
        c1s.data_ptr(), h2s.data_ptr(), c2s.data_ptr(), w_hh1_t.data_ptr(),
        w_ih2_t.data_ptr(), bias2.data_ptr(), w_hh2_t.data_ptr(),
        dx1.data_ptr(), d_pre2.data_ptr(), n_t, b, hidden, dev.index,
        _stream(dev),
    )
    _raise_on_error("lstm_pair_bwd", err)
    LAUNCHES["lstm_pair_bwd"] += 1
    return dx1, d_pre2


def lstm_bwd_cuda(dhs, x_proj, hs, cs, w_hh_t) -> torch.Tensor:
    """Launch the single-layer backward sweep; returns ``d_pre``
    ``(T, B, 4H)`` as ``lstm_bwd_ref`` does."""
    n_t, b, hidden = _shapes(x_proj)
    dev = x_proj.device
    _check_operand("x_proj", x_proj, (n_t, b, 4 * hidden), dev)
    for name, t in (("dhs", dhs), ("hs", hs), ("cs", cs)):
        _check_operand(name, t, (n_t, b, hidden), dev)
    _check_operand("w_hh_t", w_hh_t, (hidden, 4 * hidden), dev)
    lib = _bwd_library()
    dx = torch.empty_like(x_proj)
    err = lib.lstm_bwd(
        dhs.data_ptr(), x_proj.data_ptr(), hs.data_ptr(), cs.data_ptr(),
        w_hh_t.data_ptr(), dx.data_ptr(), n_t, b, hidden, dev.index,
        _stream(dev),
    )
    _raise_on_error("lstm_bwd", err)
    LAUNCHES["lstm_bwd"] += 1
    return dx


def lstm_wgrad_cuda(jobs) -> list:
    """Launch the weight-gradient pass for up to 15 jobs (a stack of 8's
    2L - 1) ``(d_pre, src, shift, mask, with_bias)`` over the same (T, B)
    rows.

    Returns one ``(dW (H, 4H), db (4H,) or None)`` per job, each as
    ``lstm_wgrad_ref`` (and ``d_pre.sum((0, 1))``) computes it.
    """
    n_t, b, hidden = _shapes(jobs[0][0])
    dev = jobs[0][0].device
    for d_pre, src, _, mask, _ in jobs:
        _check_operand("d_pre", d_pre, (n_t, b, 4 * hidden), dev)
        _check_operand("src", src, (n_t, b, hidden), dev)
        if mask is not None:
            _check_operand("mask", mask, (n_t, b, hidden), dev)
    lib = _bwd_library()
    n = len(jobs)
    splits = ctypes.c_int(0)
    _raise_on_error("lstm_wgrad", lib.lstm_wgrad_splits(
        n, n_t, b, hidden, dev.index, ctypes.byref(splits)))
    part = torch.empty((n * splits.value * (hidden + 1) * 4 * hidden,),
                       device=dev, dtype=torch.float32)
    outs = [torch.empty((hidden, 4 * hidden), device=dev, dtype=torch.float32)
            for _ in jobs]
    biases = [torch.empty((4 * hidden,), device=dev, dtype=torch.float32)
              if job[4] else None for job in jobs]

    def array(values, ctype=ctypes.c_void_p):
        return (ctype * n)(*values)

    err = lib.lstm_wgrad(
        n,
        array(_ptr(job[1]) for job in jobs),
        array(_ptr(job[3]) for job in jobs),
        array(_ptr(job[0]) for job in jobs),
        array(_ptr(o) for o in outs),
        array(_ptr(bias) for bias in biases),
        array((job[2] for job in jobs), ctypes.c_int),
        part.data_ptr(), splits.value, n_t, b, hidden, dev.index, _stream(dev),
    )
    _raise_on_error("lstm_wgrad", err)
    LAUNCHES["lstm_wgrad"] += 1
    return list(zip(outs, biases))


def _pointers(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * max(1, len(tensors)))(*map(_ptr, tensors))


def _check_stack(x1_proj, w_hh_ts, w_in_ts, biases, masks, planes=()):
    """Shapes, device, dtype and contiguity of a stack call; its sizes."""
    n_t, b, hidden = _shapes(x1_proj)
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
    _check_operand("x1_proj", x1_proj, (n_t, b, 4 * hidden), dev)
    for name, group in (("w_hh_ts", w_hh_ts), ("w_in_ts", w_in_ts)):
        for i, w in enumerate(group):
            _check_operand(f"{name}[{i}]", w, (hidden, 4 * hidden), dev)
    for i, bias in enumerate(biases):
        _check_operand(f"biases[{i}]", bias, (4 * hidden,), dev)
    for name, group in (("masks", masks or ()),) + tuple(planes):
        for i, t in enumerate(group):
            _check_operand(f"{name}[{i}]", t, (n_t, b, hidden), dev)
    return n_t, b, hidden, n_layers, dev


def lstm_stack_fwd_cuda(x1_proj, w_hh_ts, w_in_ts, biases, masks=None,
                        stash: bool = False):
    """Launch the stack's forward kernel; returns the top layer's ``hs``
    ``(T, B, H)``, or with ``stash`` ``(hs, cs)`` as ``lstm_stack_ref``
    returns them. ``masks`` selects the masked instance (counted as
    ``lstm_stack_fwd_masked``)."""
    n_t, b, hidden, n_layers, dev = _check_stack(x1_proj, w_hh_ts, w_in_ts,
                                                 biases, masks)
    lib = _stack_library()

    def plane():
        return torch.empty((n_t, b, hidden), device=dev, dtype=torch.float32)

    hs = [plane() if stash or layer == n_layers - 1 else None
          for layer in range(n_layers)]
    cs = [plane() if stash else None for _ in range(n_layers)]
    err = lib.lstm_stack_fwd(
        x1_proj.data_ptr(), None if masks is None else _pointers(masks),
        _pointers(w_hh_ts), _pointers(w_in_ts), _pointers(biases),
        _pointers(hs), _pointers(cs), n_layers, n_t, b, hidden, dev.index,
        _stream(dev),
    )
    name = "lstm_stack_fwd" if masks is None else "lstm_stack_fwd_masked"
    _raise_on_error(name, err)
    LAUNCHES[name] += 1
    return (hs, cs) if stash else hs[-1]


def lstm_stack_bwd_cuda(dh_top, x1_proj, masks, hs, cs, w_hh_ts, w_in_ts,
                        biases) -> list:
    """Launch the stack's backward sweep; returns every layer's ``d_pre``
    ``(T, B, 4H)`` as ``lstm_stack_bwd_ref`` does."""
    n_t, b, hidden, n_layers, dev = _check_stack(
        x1_proj, w_hh_ts, w_in_ts, biases, masks,
        planes=(("dh_top", (dh_top,)), ("hs", hs), ("cs", cs)))
    if len(hs) != n_layers or len(cs) != n_layers:
        raise ValueError(f"{n_layers} layers take {n_layers} h and c stashes")
    lib = _stack_library()
    d_pres = [torch.empty_like(x1_proj) for _ in range(n_layers)]
    err = lib.lstm_stack_bwd(
        dh_top.data_ptr(), x1_proj.data_ptr(),
        None if masks is None else _pointers(masks), _pointers(hs),
        _pointers(cs), _pointers(w_hh_ts), _pointers(w_in_ts),
        _pointers(biases), _pointers(d_pres), n_layers, n_t, b, hidden,
        dev.index, _stream(dev),
    )
    _raise_on_error("lstm_stack_bwd", err)
    LAUNCHES["lstm_stack_bwd"] += 1
    return d_pres


def lstm_stack_row_tile_cuda(n_layers: int, rows: int, hidden: int,
                             device: torch.device, backward: bool,
                             masked: bool = False, stash: bool = False) -> int:
    """The row tile a stack launch of ``n_layers`` layers on ``rows`` rows
    takes on ``device``: the forward's (with or without the mask and the
    stash) or the backward sweep's (with or without the mask)."""
    _check_sizes(1, rows, hidden)
    device = torch.device(device)
    index = torch.cuda.current_device() if device.index is None else device.index
    tile = ctypes.c_int(0)
    _raise_on_error("lstm_stack_row_tile", _stack_library().lstm_stack_row_tile(
        n_layers, rows, hidden, int(backward), int(masked), int(stash), index,
        ctypes.byref(tile)))
    return tile.value


def lstm_stack_wgrad(d_pres, hs, masks=None):
    """The stack's weight gradients ``(dW_hh list[L], dW_in list[L-1],
    db list[L-1])``: one launch of the reduction pass over its 2L - 1 jobs
    for a CUDA tensor, the plain version for a CPU tensor."""
    if _device_type(d_pres[0]) == "cpu":
        return lstm_stack_wgrad_ref(d_pres, hs, masks)
    n_layers = len(d_pres)
    outs = lstm_wgrad_cuda(_stack_wgrad_jobs(d_pres, hs, masks))
    return ([dw for dw, _ in outs[:n_layers]], [dw for dw, _ in outs[n_layers:]],
            [db for _, db in outs[n_layers:]])


def lstm_pair_wgrad(dx1, d_pre2, h1s, h2s, mask=None):
    """The pair's weight gradients ``(dW_hh1, dW_ih2, db2, dW_hh2)``: one
    launch of the reduction pass for a CUDA tensor, the plain version for a
    CPU tensor."""
    if _device_type(dx1) == "cpu":
        return lstm_pair_wgrad_ref(dx1, d_pre2, h1s, h2s, mask)
    (dw1, _), (dwi2, db2), (dw2, _) = lstm_wgrad_cuda([
        (dx1, h1s, 1, None, False),
        (d_pre2, h1s, 0, mask, True),
        (d_pre2, h2s, 1, None, False),
    ])
    return dw1, dwi2, db2, dw2


def lstm_single_wgrad(dx, hs) -> torch.Tensor:
    """One layer's recurrent weight gradient ``sum h[t-1]ᵀ dx[t]``."""
    if _device_type(dx) == "cpu":
        return lstm_wgrad_ref(dx, hs, 1)
    return lstm_wgrad_cuda([(dx, hs, 1, None, False)])[0][0]


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
        if _device_type(x1_proj) == "cuda":
            dx1, d_pre2 = lstm_pair_bwd_cuda(*args)
        else:
            dx1, d_pre2 = lstm_pair_bwd_ref(*args)
        dw1, dwi2, db2, dw2 = lstm_pair_wgrad(dx1, d_pre2, h1s, h2s, mask)
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
        if _device_type(x1_proj) == "cuda":
            d_pres = lstm_stack_bwd_cuda(*args)
        else:
            d_pres = lstm_stack_bwd_ref(*args)
        dw_hh, dw_in, db = lstm_stack_wgrad(d_pres, hs, masks)
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
        so does the port; otherwise the resident ones.
    """
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
        with the hand-written backward.
    """
    if _needs_grad(x1_proj, w_hh1_t, w_ih2_t, bias2, w_hh2_t):
        return _PairFunction.apply(x1_proj, w_hh1_t, w_ih2_t, bias2, w_hh2_t,
                                   mask)
    if _device_type(x1_proj) == "cuda":
        return lstm_pair_fwd_cuda(x1_proj, w_hh1_t, w_ih2_t, bias2, w_hh2_t,
                                  mask)
    return lstm_pair_ref(x1_proj, w_hh1_t, w_ih2_t, bias2, w_hh2_t, mask)


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
        autograd function with the hand-written backward.
    """
    w_hh_ts, w_in_ts, biases = (tuple(part) for part in weights)
    masks = None if masks is None else tuple(masks)
    if _needs_grad(x1_proj, *w_hh_ts, *w_in_ts, *biases):
        return _StackFunction.apply(x1_proj, len(w_hh_ts), masks is not None,
                                    *w_hh_ts, *w_in_ts, *biases, *(masks or ()))
    if _device_type(x1_proj) == "cuda":
        return lstm_stack_fwd_cuda(x1_proj, w_hh_ts, w_in_ts, biases, masks)
    return lstm_stack_ref(x1_proj, w_hh_ts, w_in_ts, biases, masks)
