"""LSTM recurrences over precomputed input projections: CUDA kernels and
their plain PyTorch versions.

Counterpart of ``masters_thesis_tpu/ops/lstm_kernel.py``. The same split
holds: the input projection for every time step is one large matmul done by
the caller, and only the serial part — the per-step recurrent product plus
the gate math — is a kernel. Layout is the JAX functions' own: time-major
``(T, B, 4H)`` projections (``x @ w_ihᵀ`` plus both biases), gate order
i, f, g, o, and transposed ``(H, 4H)`` weights.

Dispatch is on the tensors' device and nothing else: a CUDA tensor goes to
the hand-written kernel in ``csrc/lstm_fwd.cu`` (or raises), a CPU tensor to
the plain version. Each kernel counts its launches in ``LAUNCHES`` so a run
can show that its main path went through the kernel.

The CUDA kernels are forward only and f32 only: the backward kernels, the
masked pair and bf16 compute come with the training slice.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from masters_thesis_tpu_torch.ops._build import load_library

#: Largest hidden size the kernels take (``kMaxHidden`` in csrc/lstm_fwd.cu):
#: the pair stages three (H, 4H) f32 weights in one block's shared memory,
#: 192 KiB at H=64, the width of every model in configs/model.
MAX_HIDDEN = 64

#: Launches of each CUDA kernel since the last reset_launch_counts().
LAUNCHES: dict[str, int] = {"lstm_pair_fwd": 0, "lstm_fwd": 0}


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


def lstm_pair_ref(x1_proj, w_hh1_t, w_ih2_t, bias2, w_hh2_t) -> torch.Tensor:
    """Plain version of the maskless layer pair: two loops and a projection.

    Mirrors ``lstm_pair_xla`` in the JAX package; returns layer 2's ``h2s``
    ``(T, B, H)``.
    """
    h1s = lstm_recurrence_ref(x1_proj, w_hh1_t)
    return lstm_recurrence_ref(h1s @ w_ih2_t + bias2, w_hh2_t)


# ----------------------------------------------------------- CUDA wrappers


@functools.cache
def _library() -> ctypes.CDLL:
    """csrc/lstm_fwd.cu, built at first use, with its functions' types."""
    lib = load_library("lstm_fwd")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.lstm_fwd.argtypes = [ptr] * 4 + [i32] * 4 + [ptr]
    lib.lstm_fwd.restype = i32
    lib.lstm_pair_fwd.argtypes = [ptr] * 6 + [i32] * 4 + [ptr]
    lib.lstm_pair_fwd.restype = i32
    lib.lstm_error_string.argtypes = [i32]
    lib.lstm_error_string.restype = ctypes.c_char_p
    lib.lstm_max_hidden.argtypes = []
    lib.lstm_max_hidden.restype = i32
    if lib.lstm_max_hidden() != MAX_HIDDEN:
        raise RuntimeError(
            f"csrc/lstm_fwd.cu takes H <= {lib.lstm_max_hidden()}, "
            f"the wrapper assumes {MAX_HIDDEN}"
        )
    return lib


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


def _raise_on_error(lib: ctypes.CDLL, kernel: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(
            f"{kernel} launch failed: CUDA error {err} "
            f"({lib.lstm_error_string(err).decode()})"
        )


def lstm_fwd_cuda(x_proj: torch.Tensor, w_hh_t: torch.Tensor,
                  return_c: bool = False):
    """Launch the single-layer kernel; ``hs`` or ``(hs, cs)`` as the plain
    version returns them."""
    n_t, b, four_h = x_proj.shape
    hidden = four_h // 4
    _check_sizes(n_t, b, hidden)
    dev = x_proj.device
    _check_operand("x_proj", x_proj, (n_t, b, 4 * hidden), dev)
    _check_operand("w_hh_t", w_hh_t, (hidden, 4 * hidden), dev)
    lib = _library()
    hs = torch.empty((n_t, b, hidden), device=dev, dtype=torch.float32)
    cs = torch.empty_like(hs) if return_c else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.lstm_fwd(
        x_proj.data_ptr(), w_hh_t.data_ptr(), hs.data_ptr(),
        None if cs is None else cs.data_ptr(), n_t, b, hidden, dev.index,
        stream,
    )
    _raise_on_error(lib, "lstm_fwd", err)
    LAUNCHES["lstm_fwd"] += 1
    return (hs, cs) if return_c else hs


def lstm_pair_fwd_cuda(x1_proj, w_hh1_t, w_ih2_t, bias2, w_hh2_t):
    """Launch the maskless pair kernel; returns ``h2s`` ``(T, B, H)``."""
    n_t, b, four_h = x1_proj.shape
    hidden = four_h // 4
    _check_sizes(n_t, b, hidden)
    dev = x1_proj.device
    _check_operand("x1_proj", x1_proj, (n_t, b, 4 * hidden), dev)
    for name, w in (("w_hh1_t", w_hh1_t), ("w_ih2_t", w_ih2_t),
                    ("w_hh2_t", w_hh2_t)):
        _check_operand(name, w, (hidden, 4 * hidden), dev)
    _check_operand("bias2", bias2, (4 * hidden,), dev)
    lib = _library()
    h2s = torch.empty((n_t, b, hidden), device=dev, dtype=torch.float32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.lstm_pair_fwd(
        x1_proj.data_ptr(), w_hh1_t.data_ptr(), w_ih2_t.data_ptr(),
        bias2.data_ptr(), w_hh2_t.data_ptr(), h2s.data_ptr(),
        n_t, b, hidden, dev.index, stream,
    )
    _raise_on_error(lib, "lstm_pair_fwd", err)
    LAUNCHES["lstm_pair_fwd"] += 1
    return h2s


# -------------------------------------------------------------- public API


def lstm_recurrence(x_proj: torch.Tensor, w_hh_t: torch.Tensor) -> torch.Tensor:
    """Run one LSTM layer's time recurrence over pre-projected inputs.

    Args:
        x_proj: ``(T, B, 4H)`` time-major input projections (``x @ w_ihᵀ``
            plus both biases), gate order i, f, g, o.
        w_hh_t: ``(H, 4H)`` transposed recurrent weight.

    Returns:
        ``(T, B, H)`` hidden states: the CUDA kernel for a CUDA tensor, the
        plain version for a CPU tensor.
    """
    if x_proj.device.type == "cuda":
        return lstm_fwd_cuda(x_proj, w_hh_t)
    if x_proj.device.type == "cpu":
        return lstm_recurrence_ref(x_proj, w_hh_t)
    raise ValueError(f"unsupported device {x_proj.device}")


def lstm_pair_recurrence(x1_proj, w_hh1_t, w_ih2_t, bias2, w_hh2_t):
    """Run two stacked LSTM layers as one wavefront recurrence (no dropout).

    Args:
        x1_proj: ``(T, B, 4H)`` layer-1 input projections plus both biases.
        w_hh1_t: ``(H, 4H)`` transposed layer-1 recurrent weight.
        w_ih2_t: ``(H, 4H)`` transposed layer-2 input weight.
        bias2: ``(4H,)`` layer-2 combined bias (``b_ih + b_hh``).
        w_hh2_t: ``(H, 4H)`` transposed layer-2 recurrent weight.

    Returns:
        ``(T, B, H)`` layer-2 hidden states: the CUDA kernel for a CUDA
        tensor, the plain version for a CPU tensor.
    """
    if x1_proj.device.type == "cuda":
        return lstm_pair_fwd_cuda(x1_proj, w_hh1_t, w_ih2_t, bias2, w_hh2_t)
    if x1_proj.device.type == "cpu":
        return lstm_pair_ref(x1_proj, w_hh1_t, w_ih2_t, bias2, w_hh2_t)
    raise ValueError(f"unsupported device {x1_proj.device}")
