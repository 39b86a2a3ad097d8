"""The port's cost model: FLOPs and bytes of each kernel and of a step,
the card's peaks, and the roofline arithmetic of the run report.

Counterpart of ``masters_thesis_tpu/telemetry/costs.py``. The JAX package
reads its programs' costs from the compiler (``Compiled.cost_analysis``);
the card has nothing to ask, so the port counts them: :func:`kernel_cost`
holds the operations and bytes of every hand-written kernel (the counts
behind the *bound* column of ``PERF.md`` §6, which ``chip_smoke.py`` reads
from here), and :func:`cost_of_step` sums them over the layer groups a
training step (or a forward) runs, as the encoder's grouping rule and
single-layer route pick them, with the step's cuBLAS products (the input
projections and the heads, forward and backward). Elementwise work (the
loss, dropout, the optimizer) is left out: it moves a few bytes a
parameter and is not counted. :func:`emit_cost_profile` writes the result
as a ``cost_profile`` event with ``source="analytic"``.

Operations count each ``(rows, H) @ (H, 4H)`` product of a time step as
``2 * H * 4H`` a row; bytes count each input read once and each output
written once: planes and weights at the compute dtype's ``itemsize`` (4
for f32, 2 for the pair's and the stack's bf16 instances), the d_pre
planes that the sweeps hand to the weight-gradient pass at 4 whatever it
is (the counterpart of the JAX ``lstm_route_cost(itemsize=)``: operands
at the compute dtype, scratch in f32). ``bound_ms`` is the larger of the
two roofline terms at the card's peaks.

Peaks exist only for the card the port is measured on, by
``torch.cuda.get_device_name``: NVIDIA H100 80GB HBM3 (the H100 SXM data
sheet at 700 W: 67 TFLOP/s f32 without tensor cores, the kernels' rate,
and 3.35 TB/s). Any other device and the CPU get ``None``, and the report
prints ``n/a``: the JAX table's "gpu" entry is another card's.

Stdlib only at import: the report and the supervisor read this module in a
process without torch; :func:`cost_of_step` imports the grouping rule when
it is called.
"""

from __future__ import annotations

import dataclasses
from typing import Any

#: The card whose peaks the port knows (``torch.cuda.get_device_name``).
H100 = "NVIDIA H100 80GB HBM3"
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
PEAK_SOURCE = "H100 SXM data sheet: 67 TFLOP/s f32 (no tensor cores), 3.35 TB/s"
DEVICE_PEAKS: dict[str, dict[str, float]] = {
    H100: {"flops_per_sec": PEAK_F32_FLOPS, "bytes_per_sec": PEAK_BYTES_PER_S},
}

#: Collective-wait fraction past which a program is comms-bound whatever
#: its intensity (the JAX constant; one card never reaches it).
COMMS_BOUND_FRAC = 0.25

#: The JAX report's TPU utilization floor (CP403). The port's report
#: applies it only to a run whose platform is ``tpu``, which no port run
#: is.
TPU_UTILIZATION_FLOOR = 0.01

F32 = 4


# ------------------------------------------------------------- kernels


def kernel_cost(name: str, rows: int, n_t: int = 60, hidden: int = 64,
                n_layers: int = 4, with_c: bool = False,
                itemsize: int = F32) -> tuple[int, int]:
    """``(operations, bytes)`` of one launch of kernel ``name`` over
    ``rows`` rows and ``n_t`` steps at width ``hidden``; ``n_layers`` is a
    stack kernel's depth, ``with_c`` a single-layer forward (resident or
    time-blocked) that also writes its c plane; ``itemsize`` the bytes of
    its planes and weights (the d_pre planes are f32 at any).

    Forwards: 1 product a step for one layer, 3 for the pair (both
    recurrences and the seam projection), 2L - 1 for an L-deep stack.
    Backward sweeps recompute the gates and form the transposed products:
    2 for one layer (3 time-blocked, where dW is summed in the sweep), 6
    for the pair, 4L - 2 for the stack. Weight-gradient passes: 1 a job
    (1, 3, 2L - 1 jobs). In bf16 the pair's and the stack's sweeps write
    the bottom layer's d_pre twice: rounded (dx1, the projection's
    gradient) and in f32 (the pass's operand), and every other layer's in
    f32.
    """
    h4 = 4 * hidden
    product = 2 * n_t * rows * hidden * h4
    plane_h = itemsize * n_t * rows * hidden
    plane_x = itemsize * n_t * rows * h4
    d_pre = F32 * n_t * rows * h4  # the sweeps' d_pre, the pass's operand
    weight = itemsize * hidden * h4
    bias = itemsize * h4
    n = n_layers
    stack_params = (2 * n - 1) * weight + (n - 1) * bias
    counts = {
        "lstm_fwd": (product,
                     plane_x + weight + (2 if with_c else 1) * plane_h),
        "lstm_tb_fwd": (product,
                        plane_x + weight + (2 if with_c else 1) * plane_h),
        "lstm_bwd": (2 * product, 3 * plane_h + 2 * plane_x + weight),
        "lstm_wgrad_single": (product, d_pre + plane_h + weight),
        "lstm_tb_bwd": (3 * product, 3 * plane_h + 2 * plane_x + 2 * weight),
        "lstm_pair_fwd": (3 * product,
                          plane_x + 3 * weight + bias + plane_h),
        "lstm_pair_fwd_masked": (3 * product, plane_x + plane_h + 3 * weight
                                 + bias + 4 * plane_h),
        "lstm_pair_bwd": (6 * product, 6 * plane_h + 2 * plane_x + d_pre
                          + (d_pre if itemsize != F32 else 0)
                          + 3 * weight + bias),
        "lstm_wgrad": (3 * product,
                       2 * d_pre + 3 * plane_h + 3 * weight + bias),
        "lstm_stack_fwd": ((2 * n - 1) * product,
                           plane_x + stack_params + plane_h),
        "lstm_stack_fwd_masked": ((2 * n - 1) * product,
                                  plane_x + (n - 1) * plane_h + stack_params
                                  + 2 * n * plane_h),
        "lstm_stack_bwd": ((4 * n - 2) * product,
                           plane_h + plane_x + (n - 1) * plane_h
                           + 2 * n * plane_h + stack_params + n * d_pre
                           + (plane_x if itemsize != F32 else 0)),
        "lstm_wgrad_stack": ((2 * n - 1) * product,
                             n * d_pre + n * plane_h + (n - 1) * plane_h
                             + stack_params),
    }
    if name not in counts:
        raise KeyError(f"no cost for kernel {name!r} "
                       f"(known: {', '.join(sorted(counts))})")
    return counts[name]


def bound_ms(flops: float, nbytes: float,
             peaks: dict[str, float] | None = None) -> tuple[float, str]:
    """Least milliseconds for the work at ``peaks`` (the H100's by
    default): the larger of the two roofline terms, and which one it is
    (``"operations"`` or ``"bytes"``)."""
    peaks = peaks or DEVICE_PEAKS[H100]
    ops_ms = flops / peaks["flops_per_sec"] * 1e3
    bytes_ms = nbytes / peaks["bytes_per_sec"] * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


# ---------------------------------------------------------------- steps


def _group_kernels(depth: int, route: str, training: bool, masked: bool
                   ) -> list[str]:
    """The kernels one layer group runs: its forward, and in training its
    sweep and weight-gradient pass (their cost names; a bf16 launch
    counts under the name with ``_bf16``)."""
    if depth == 1:
        if route == "pallas-timeblocked":
            return ["lstm_tb_fwd", "lstm_tb_bwd"] if training else ["lstm_tb_fwd"]
        fwd = ["lstm_fwd"]
        return fwd + ["lstm_bwd", "lstm_wgrad_single"] if training else fwd
    if depth == 2:
        fwd = ["lstm_pair_fwd_masked" if masked else "lstm_pair_fwd"]
        return fwd + ["lstm_pair_bwd", "lstm_wgrad"] if training else fwd
    fwd = ["lstm_stack_fwd_masked" if masked else "lstm_stack_fwd"]
    return fwd + ["lstm_stack_bwd", "lstm_wgrad_stack"] if training else fwd


def cost_of_step(spec, rows: int, n_t: int, *, window_rows: int | None = None,
                 training: bool = True, itemsize: int = F32) -> dict:
    """Operations and bytes of one step of ``spec``'s encoder over ``rows``
    rows of ``n_t`` steps (``window_rows`` a window's rows, as
    ``forward_rows`` passes it) in a compute dtype of ``itemsize`` bytes:
    the layer groups ``fused_depth`` picks and the single-layer route
    (``single_layer_route``), each group's input projection (and its two
    backward products in training: the weight gradient, and the input
    gradient above layer 0), each group's kernels, and the heads (f32).
    ``{"flops", "bytes", "transcendentals", "groups", "kernels"}``;
    ``kernels`` counts launches by their ``LAUNCHES`` name (``_bf16``
    names at itemsize 2)."""
    from masters_thesis_tpu_torch.models.lstm import fused_depth
    from masters_thesis_tpu_torch.ops.lstm_kernel import single_layer_route

    hidden, h4 = spec.hidden_size, 4 * spec.hidden_size
    masked = training and spec.dropout > 0
    suffix = "_bf16" if itemsize != F32 else ""
    flops = nbytes = 0
    groups, kernels = [], {}
    layer = 0
    while layer < spec.num_layers:
        depth = fused_depth(spec.num_layers - layer, n_t, rows, hidden,
                            masked, window_rows, itemsize)
        route = (single_layer_route(n_t, rows, hidden, window_rows)
                 if depth == 1 else ("pair" if depth == 2 else "stack"))
        groups.append({"layer": layer, "depth": depth, "route": route})
        in_dim = spec.input_size if layer == 0 else hidden
        proj = 2 * n_t * rows * in_dim * h4
        proj_bytes = itemsize * (n_t * rows * in_dim + in_dim * h4 + 2 * h4
                                 + n_t * rows * h4)
        flops += proj
        nbytes += proj_bytes
        if training:
            # dW_ih always; the input's gradient only above the data.
            flops += proj * (2 if layer > 0 else 1)
            nbytes += proj_bytes * (2 if layer > 0 else 1)
        for name in _group_kernels(depth, route, training, masked):
            f, b = kernel_cost(name, rows, n_t, hidden, n_layers=depth,
                               with_c=training and name == "lstm_fwd",
                               itemsize=itemsize)
            flops += f
            nbytes += b
            kernels[name + suffix] = kernels.get(name + suffix, 0) + 1
        layer += depth
    heads = 2 * rows * hidden * (1 + spec.n_factors)
    heads_bytes = F32 * (rows * hidden + hidden * (1 + spec.n_factors)
                         + rows * (1 + spec.n_factors))
    flops += heads * (3 if training else 1)
    nbytes += heads_bytes * (3 if training else 1)
    # Three sigmoids and two tanh a cell and step; a sweep recomputes them.
    transcendentals = (5 * n_t * rows * hidden * spec.num_layers
                       * (2 if training else 1))
    return {"flops": flops, "bytes": nbytes,
            "transcendentals": transcendentals, "groups": groups,
            "kernels": kernels}


# ------------------------------------------------------------- roofline


def platform_peaks(platform: str | None,
                   device: str | None = None) -> dict[str, float] | None:
    """The card's nominal peaks: only for a CUDA ``platform`` whose
    ``device`` name is in ``DEVICE_PEAKS``; None otherwise (the CPU, other
    cards)."""
    if (platform or "").lower() not in ("cuda", "gpu"):
        return None
    peaks = DEVICE_PEAKS.get(device or "")
    if peaks is None:
        return None
    return dict(peaks)


def roofline_regime(intensity: float | None, platform: str | None,
                    comms_frac: float | None = None,
                    device: str | None = None) -> str | None:
    """compute-bound / memory-bound / comms-bound, or None when unknowable
    (no peaks for the device)."""
    if comms_frac is not None and comms_frac > COMMS_BOUND_FRAC:
        return "comms-bound"
    peaks = platform_peaks(platform, device)
    if intensity is None or peaks is None:
        return None
    ridge = peaks["flops_per_sec"] / peaks["bytes_per_sec"]
    return "compute-bound" if intensity >= ridge else "memory-bound"


def utilization(flops_per_step: float | None, bytes_per_step: float | None,
                steps_per_sec: float | None, platform: str | None,
                n_devices: int | None = 1, comms_frac: float | None = None,
                device: str | None = None) -> dict:
    """Achieved rates and the roofline verdict from the counted cost and
    the measured step rate, the JAX function's fields. Every field may be
    None (the report prints ``n/a``)."""
    achieved_flops = achieved_bytes = None
    if steps_per_sec is not None and steps_per_sec > 0:
        if flops_per_step is not None:
            achieved_flops = flops_per_step * steps_per_sec
        if bytes_per_step is not None:
            achieved_bytes = bytes_per_step * steps_per_sec
    intensity = None
    if flops_per_step and bytes_per_step:
        intensity = flops_per_step / bytes_per_step
    peaks = platform_peaks(platform, device)
    n = max(1, int(n_devices or 1))
    flops_util = bytes_util = None
    if peaks is not None:
        if achieved_flops is not None:
            flops_util = achieved_flops / (peaks["flops_per_sec"] * n)
        if achieved_bytes is not None:
            bytes_util = achieved_bytes / (peaks["bytes_per_sec"] * n)
    return {
        "achieved_flops_per_sec": achieved_flops,
        "achieved_bytes_per_sec": achieved_bytes,
        "arithmetic_intensity": intensity,
        "flops_utilization_pct": (
            None if flops_util is None else 100.0 * flops_util),
        "bytes_utilization_pct": (
            None if bytes_util is None else 100.0 * bytes_util),
        "regime": roofline_regime(intensity, platform, comms_frac, device),
        "comms_wait_frac": comms_frac,
        "nominal_peaks": peaks,
    }


# --------------------------------------------------------- cost models


@dataclasses.dataclass(frozen=True)
class CostModel:
    """One program's cost, in the JAX ``CostModel``'s fields. ``source``
    is ``"analytic"`` (counted by :func:`cost_of_step`); the buffer-
    assignment fields stay None (no compiler to ask)."""

    program: str
    flops: float | None = None
    bytes_accessed: float | None = None
    transcendentals: float | None = None
    argument_bytes: int | None = None
    output_bytes: int | None = None
    temp_bytes: int | None = None
    alias_bytes: int | None = None
    source: str = "unavailable"
    steps_per_execution: int = 1
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def available(self) -> bool:
        return self.flops is not None or self.bytes_accessed is not None

    @property
    def peak_bytes(self) -> int | None:
        parts = [self.argument_bytes, self.output_bytes, self.temp_bytes]
        if all(p is None for p in parts):
            return None
        return max(0, sum(p or 0 for p in parts) - (self.alias_bytes or 0))

    @property
    def flops_per_step(self) -> float | None:
        if self.flops is None:
            return None
        return self.flops / max(1, self.steps_per_execution)

    @property
    def bytes_per_step(self) -> float | None:
        if self.bytes_accessed is None:
            return None
        return self.bytes_accessed / max(1, self.steps_per_execution)

    def to_payload(self) -> dict:
        """The ``cost_profile`` event's payload (the JAX keys)."""
        return {
            "program": self.program,
            "source": self.source,
            "available": self.available,
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "transcendentals": self.transcendentals,
            "steps_per_execution": self.steps_per_execution,
            "flops_per_step": self.flops_per_step,
            "bytes_per_step": self.bytes_per_step,
            "argument_bytes": self.argument_bytes,
            "output_bytes": self.output_bytes,
            "temp_bytes": self.temp_bytes,
            "alias_bytes": self.alias_bytes,
            "peak_bytes": self.peak_bytes,
            "meta": self.meta,
        }


def step_cost_model(spec, rows: int, n_t: int, *, program: str,
                    steps_per_execution: int = 1,
                    window_rows: int | None = None,
                    meta: dict | None = None,
                    itemsize: int = F32) -> CostModel:
    """:func:`cost_of_step` of one training step as a :class:`CostModel`
    over ``steps_per_execution`` steps (an epoch for ``train_epoch_scan``),
    the grouping and kernel launches in its ``meta``."""
    step = cost_of_step(spec, rows, n_t, window_rows=window_rows,
                        itemsize=itemsize)
    return CostModel(
        program=program,
        flops=float(step["flops"] * steps_per_execution),
        bytes_accessed=float(step["bytes"] * steps_per_execution),
        transcendentals=float(step["transcendentals"] * steps_per_execution),
        source="analytic",
        steps_per_execution=steps_per_execution,
        meta={**(meta or {}), "groups": step["groups"],
              "kernels_per_step": step["kernels"]},
    )


def emit_cost_profile(tel: Any, cost: CostModel, **extra: Any) -> dict:
    """One ``cost_profile`` event for ``cost`` (a ``cost_unavailable``
    event, once a run, when it holds nothing), as the JAX function."""
    payload = {**cost.to_payload(), **extra}
    if not cost.available and cost.peak_bytes is None:
        if not getattr(tel, "_cost_unavailable_warned", False):
            tel._cost_unavailable_warned = True
            return tel.event(
                "cost_unavailable", program=cost.program, source=cost.source,
                note="no cost model for this program; utilization reports "
                     "will render n/a")
        return {}
    return tel.event("cost_profile", **payload)
