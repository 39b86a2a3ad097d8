"""The trainer preflight: an audit of the real training step on the device.

The port's counterpart of ``masters_thesis_tpu/analysis/traceaudit.py``.
The graph-path lint reasons about source; this pass builds the configured
model's real ``TrainProgram`` (``train/steps.py``) over a tiny synthetic
split on the trainer's device, runs one step (on the card: the warm-up and
the capture), then ``steps`` more with varied inputs (each epoch its own
rate, dropout seed and shuffle), and holds the invariants the port's
performance contract rests on:

- **TA201** — the step is captured once: ``GraphedCall.captures == 1`` and
  ``replays == steps``.
- **TA202** — the replays make no host synchronisation: they run under
  ``torch.cuda.set_sync_debug_mode("error")``, which raises at any call
  PyTorch knows to synchronise (``serve/preflight.py``'s SV302 holds the
  serving buckets to the same). A host read inside the step itself
  (``.item()``, ``.cpu()``) shows earlier, as a capture that refuses it
  (``CaptureError``): that is TA202 too. Only those errors are: any other
  failure of a capture or a replay (out of memory, an op that cannot be
  captured, a failed collective) is TA205, with its cause.
- **TA203** — no gather: the step's collectives are the gradient
  all-reduce alone (``parallel.mesh.COLLECTIVES`` holds only
  ``all_reduce_grad`` and ``all_reduce_sums``), and no
  ``torch.distributed`` gather, scatter, all-to-all or broadcast is called
  while the audit runs.
- **TA204** — parameters come back in their dtype, and the metric sums
  are float32.
- **TA205** — the audit could not run; a finding, never a pass.
- **TA206** — exactly one ``all_reduce_grad`` a step, world size 1
  included: without the trainer's own process group the audit makes a
  group of one (gloo on the CPU, NCCL on the card) for its run and
  leaves it after, so the step runs its all-reduce as a ``tpu_xla`` run
  of one rank does.
- **TA207** — the stacked program (``StackedTrainProgram``, R replicas)
  is captured once and all-reduces its ``[R, n]`` gradient once a step.

TA201 and TA202 have no object on the CPU, where the programs run eagerly
(nothing is captured, nothing is asynchronous): there the audit's facts
list them under ``not_applicable``. A card trainer run with
``cuda_graphs=False`` (``graphed=False``) captures nothing either: TA201
and TA207's capture count are listed so, and its eager steps are still
held to TA202. Everything is sized to run in seconds.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from masters_thesis_tpu_torch.analysis.findings import Finding

# A tiny but real geometry: two steps an epoch.
AUDIT_STOCKS = 4
AUDIT_LOOKBACK = 8
AUDIT_BATCH = 2
AUDIT_WINDOWS = 2 * AUDIT_BATCH
#: Steps run after the first (on the card: replays after the capture).
AUDIT_STEPS = 3
AUDIT_REPLICAS = 2
#: The collectives a training step may issue (``parallel/mesh.py``).
STEP_COLLECTIVES = {"all_reduce_grad", "all_reduce_sums"}
#: ``torch.distributed`` calls that gather, scatter or broadcast (TA203).
GATHERS = ("all_gather", "all_gather_into_tensor", "all_gather_object",
           "gather", "scatter", "reduce_scatter", "reduce_scatter_tensor",
           "all_to_all", "all_to_all_single", "broadcast")
NOT_APPLICABLE_ON_CPU = {
    "TA201": "nothing is captured on the CPU: the step runs eagerly",
    "TA202": "nothing is asynchronous on the CPU: there is no host "
             "synchronisation to find",
}
#: Why the capture count has no object when the trainer runs ungraphed.
UNGRAPHED = "the trainer runs with cuda_graphs=False: the step is not captured"
#: The errors that mean a host synchronisation (TA202), lower-cased: the
#: raising sync check's, and a capture's refusal of a sync or a blocking
#: copy (cudaErrorStreamCaptureUnsupported and cudaErrorStreamCaptureImplicit,
#: by their messages and names; PyTorch's own check of a pageable copy).
#: Not cudaErrorStreamCaptureInvalidated: a capture's end fails so after any
#: error inside it, whatever that error was.
HOST_SYNC_ERRORS = (
    "called a synchronizing cuda operation",
    "operation not permitted when stream is capturing",
    "operation would make the legacy stream depend on a capturing "
    "blocking stream",
    "cudaerrorstreamcaptureunsupported",
    "cudaerrorstreamcaptureimplicit",
    "during cuda graph capture unless the cpu tensor is pinned",
)


class PreflightError(RuntimeError):
    """Raised by :func:`assert_trace_clean` when the audit has findings."""

    def __init__(self, findings: list[Finding]):
        self.findings = findings
        super().__init__("trace audit failed:\n"
                         + "\n".join(f.format() for f in findings))


def default_spec():
    """A tiny MSE model, as the JAX audit's default."""
    from masters_thesis_tpu_torch.models.objectives import ModelSpec

    return ModelSpec(objective="mse", hidden_size=8, num_layers=1,
                     dropout=0.0)


def synthetic_split(n_windows: int, rng: np.random.Generator,
                    n_factors: int = 1, n_stocks: int = AUDIT_STOCKS,
                    n_features: int | None = None):
    """A ``Batch`` of numpy arrays with the pipeline's window schema (the
    JAX audit's ``_synthetic_split``): ``x (N, K, T, 2F+1)``, ``y (N, K,
    T, 2F+2)``, ``factor (N, F+F²)`` (a positive market variance at F=1,
    an SPD covariance above), ``inv_psi (N, K)``."""
    from masters_thesis_tpu_torch.data.pipeline import Batch

    k, t, nf = n_stocks, AUDIT_LOOKBACK, n_factors
    if nf == 1:
        factor = (np.abs(rng.standard_normal((n_windows, 2))).astype(np.float32)
                  + 0.1)
    else:
        f_mean = rng.standard_normal((n_windows, nf)).astype(np.float32)
        a = rng.standard_normal((n_windows, nf, nf)).astype(np.float32)
        f_cov = np.einsum("wij,wkj->wik", a, a) / nf
        f_cov += 0.1 * np.eye(nf, dtype=np.float32)
        factor = np.concatenate([f_mean, f_cov.reshape(n_windows, -1)],
                                axis=-1).astype(np.float32)
    features = 2 * nf + 1 if n_features is None else n_features
    return Batch(
        rng.standard_normal((n_windows, k, t, features)).astype(np.float32),
        rng.standard_normal((n_windows, k, t, 2 * nf + 2)).astype(np.float32),
        factor,
        np.ones((n_windows, k), np.float32),
    )


def _device_data(spec, device: torch.device, seed: int):
    from masters_thesis_tpu_torch.data.pipeline import Batch

    split = synthetic_split(AUDIT_WINDOWS, np.random.default_rng(seed),
                            n_factors=spec.n_factors,
                            n_features=spec.input_size)
    return Batch(*(torch.as_tensor(a, device=device) for a in split))


@contextlib.contextmanager
def _audit_mesh(mesh, device: torch.device):
    """The mesh the audited step all-reduces over: the caller's when it
    has a process group, else a group of one made for the audit and left
    after it."""
    import torch.distributed as dist

    from masters_thesis_tpu_torch.parallel.mesh import data_mesh

    if mesh is not None and mesh.distributed:
        yield mesh
        return
    made = not dist.is_initialized()
    own = data_mesh("tpu_xla", 1, device)
    try:
        yield own
    finally:
        if made:
            own.shutdown()


@contextlib.contextmanager
def _counting_gathers():
    """Count the ``torch.distributed`` gathers called while the block runs
    (dict yielded; the functions are put back after)."""
    import torch.distributed as dist

    counts: dict[str, int] = {}
    saved = {name: getattr(dist, name) for name in GATHERS
             if hasattr(dist, name)}

    def counting(name, fn):
        def call(*args, **kwargs):
            counts[name] = counts.get(name, 0) + 1
            return fn(*args, **kwargs)
        return call

    for name, fn in saved.items():
        setattr(dist, name, counting(name, fn))
    try:
        yield counts
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def is_host_sync(exc: BaseException) -> bool:
    """Whether ``exc``, or an error it was raised from or during (unless
    that context was suppressed), is a host synchronisation refused by a
    capture or by the raising sync check (``HOST_SYNC_ERRORS``)."""
    seen: set[int] = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        text = str(exc).lower()
        if any(marker in text for marker in HOST_SYNC_ERRORS):
            return True
        exc = exc.__cause__ or (None if exc.__suppress_context__
                                else exc.__context__)
    return False


def _run_steps(program, begin_epoch, steps: int, on_card: bool,
               device: torch.device) -> tuple[list[Finding], dict | None]:
    """One step (on the card: the warm-up and the capture), then ``steps``
    more, a new epoch (``begin_epoch(e)``) whenever the shuffle's rows run
    out; on the card the ``steps`` run under the raising sync check
    (TA202). Returns the findings and the collectives of the ``steps``
    (None when the step could not be captured: nothing more to hold). An
    error that is not a host synchronisation (:func:`is_host_sync`) is
    raised: the caller reports it as TA205."""
    from masters_thesis_tpu_torch.parallel.mesh import COLLECTIVES

    from masters_thesis_tpu_torch.utils.cuda_graph import CaptureError

    findings: list[Finding] = []
    begin_epoch(0)
    try:
        program.step()
    except CaptureError as exc:
        # A host read in the step shows on the card at its capture, which
        # refuses it; no replay runs Python to read anything.
        if not is_host_sync(exc):
            raise
        return [Finding("TA202", "host synchronisation inside the training "
                        f"step: its capture refused it: {exc}")], None
    before = dict(COLLECTIVES)
    done, taken, epoch = 0, 1, 0
    while done < steps:
        if taken == program.n_steps:
            epoch += 1
            begin_epoch(epoch)
            taken = 0
        if on_card:
            torch.cuda.synchronize(device)
            torch.cuda.set_sync_debug_mode("error")
        try:
            program.step()
        except RuntimeError as exc:
            if not (on_card and is_host_sync(exc)):
                raise
            findings.append(Finding(
                "TA202", f"host synchronisation inside the replayed training "
                f"step: {exc}"))
            break
        finally:
            if on_card:
                torch.cuda.set_sync_debug_mode("default")
        done += 1
        taken += 1
    if on_card:
        torch.cuda.synchronize(device)
    return findings, {k: COLLECTIVES[k] - before.get(k, 0)
                      for k in COLLECTIVES}


def _capture_findings(rule: str, what: str, step, steps: int,
                      facts: dict) -> list[Finding]:
    """TA201/TA207's capture counts of a ``GraphedCall`` step."""
    facts["captures"] = step.captures
    facts["replays"] = step.replays
    if step.captures == 1 and step.replays == steps:
        return []
    return [Finding(rule, f"{what} captured {step.captures} time(s) and "
                    f"replayed {step.replays} time(s) over {steps + 1} "
                    f"varied-input steps (expected 1 capture and {steps} "
                    "replays) — the step does not keep one graph")]


def _collective_findings(rule: str, what: str, delta: dict, steps: int,
                         gathers: dict, facts: dict) -> list[Finding]:
    """TA203 (no gather) and TA206/TA207 (one gradient all-reduce a step)
    from the collective counts of ``steps`` steps."""
    findings = []
    grads = delta.get("all_reduce_grad", 0)
    facts["all_reduces_per_step"] = grads / steps
    facts["collectives"] = {k: n for k, n in delta.items() if n}
    other = {k: n for k, n in delta.items()
             if n and k not in STEP_COLLECTIVES}
    if other or gathers:
        findings.append(Finding(
            "TA203", f"{what} issues collectives other than the gradient "
            f"all-reduce: {dict(other, **gathers)} — parameters or data "
            "are gathered instead of reduced"))
    if grads != steps or delta.get("all_reduce_sums", 0):
        findings.append(Finding(
            rule, f"{what} issued {grads} gradient all-reduce(s) over "
            f"{steps} steps (expected exactly one a step: the flat "
            "gradient's) and "
            f"{delta.get('all_reduce_sums', 0)} metric all-reduce(s) "
            "(expected none inside a step)"))
    return findings


def run_trace_audit(spec=None, mesh=None, steps: int = AUDIT_STEPS,
                    stacked_replicas: int | None = None, device=None,
                    gradient_clip_val: float | None = None,
                    graphed: bool | None = None,
                    facts: dict | None = None) -> list[Finding]:
    """Build and run the real training step on synthetic data; the
    findings (empty when every invariant holds).

    ``spec`` defaults to a tiny MSE model; ``device`` to the mesh's, else
    CUDA (``resolve_device``); ``mesh`` is the caller's ``DataMesh``. With
    ``stacked_replicas`` the stacked program is audited too (TA207).
    ``graphed`` is whether the step is captured, as the trainer's own
    ``cuda_graphs`` setting says (default: on the card). ``facts``
    receives what was measured: captures, replays, all-reduces a step,
    the rules that do not apply on this device or setting.
    """
    facts = {} if facts is None else facts
    try:
        findings = _run_trace_audit(spec, mesh, steps, device,
                                    gradient_clip_val, graphed, facts)
    except Exception as exc:  # noqa: BLE001 — TA205 carries the cause
        return [Finding("TA205", f"audit could not run: "
                        f"{type(exc).__name__}: {exc}")]
    if stacked_replicas is not None:
        facts["stacked"] = {}
        findings.extend(run_stacked_trace_audit(
            spec=spec, mesh=mesh, replicas=stacked_replicas, steps=steps,
            device=device, gradient_clip_val=gradient_clip_val,
            graphed=graphed, facts=facts["stacked"]))
    return findings


def _resolve(spec, mesh, device, graphed) -> tuple:
    """The spec, the device, whether it is the card and whether the step
    is captured (never on the CPU)."""
    from masters_thesis_tpu_torch import resolve_device

    spec = default_spec() if spec is None else spec
    if device is None and mesh is not None:
        device = mesh.device
    device = resolve_device(device)
    on_card = device.type == "cuda"
    graphed = on_card if graphed is None else bool(graphed) and on_card
    return spec, device, on_card, graphed


def _run_trace_audit(spec, mesh, steps, device, gradient_clip_val, graphed,
                     facts) -> list[Finding]:
    from masters_thesis_tpu_torch.train.optim import make_optimizer
    from masters_thesis_tpu_torch.train.steps import TrainProgram

    spec, device, on_card, graphed = _resolve(spec, mesh, device, graphed)
    facts.update(device=str(device), graphed=graphed, steps=steps)
    if not on_card:
        facts["not_applicable"] = dict(NOT_APPLICABLE_ON_CPU)
    elif not graphed:
        facts["not_applicable"] = {"TA201": UNGRAPHED}
    findings: list[Finding] = []
    with _audit_mesh(mesh, device) as audit_mesh, \
            _counting_gathers() as gathers:
        facts["world"] = audit_mesh.world
        module = spec.build_module(device=device,
                                   generator=torch.Generator().manual_seed(0))
        optimizer = make_optimizer(module, gradient_clip_val,
                                   spec.weight_decay)
        in_dtypes = [p.dtype for p in module.parameters()]
        generator = torch.Generator(device=device)
        program = TrainProgram(module, optimizer, spec.window_objective(),
                               _device_data(spec, device, 0), AUDIT_BATCH,
                               generator, graphed=graphed, mesh=audit_mesh)

        def begin_epoch(epoch: int) -> None:
            # Varied inputs: each epoch its own rate, dropout stream and
            # shuffle (the graph must not care).
            program.begin_epoch(1e-3 * 2.0 ** -epoch, dropout_seed=7 + epoch)

        findings, delta = _run_steps(program, begin_epoch, steps, on_card,
                                     device)
    if delta is None:
        return findings
    if graphed:
        findings += _capture_findings("TA201", "the training step",
                                      program.step, steps, facts)
    findings += _collective_findings("TA206", "the training step", delta,
                                     steps, gathers, facts)
    out_dtypes = [p.dtype for p in module.parameters()]
    if out_dtypes != in_dtypes or optimizer.params.dtype != torch.float32:
        findings.append(Finding(
            "TA204", "parameter dtypes changed through the steps: "
            f"{sorted(set(map(str, in_dtypes)))} -> "
            f"{sorted(set(map(str, out_dtypes)))} (flat buffer "
            f"{optimizer.params.dtype})"))
    bad = {k: (str(v.dtype), str(w.dtype))
           for k, (v, w) in (program.sums or {}).items()
           if v.dtype != torch.float32 or w.dtype != torch.float32}
    if bad:
        findings.append(Finding(
            "TA204", f"metric sums not accumulated in float32: {bad}"))
    return findings


def run_stacked_trace_audit(spec=None, mesh=None,
                            replicas: int = AUDIT_REPLICAS,
                            steps: int = AUDIT_STEPS, device=None,
                            gradient_clip_val: float | None = None,
                            graphed: bool | None = None,
                            facts: dict | None = None) -> list[Finding]:
    """TA207: the stacked program of ``replicas`` replicas (each its own
    seed and rate) is captured once across varied-input steps (where it
    is ``graphed``, by default on the card), and all-reduces its
    ``[R, n]`` gradient once a step, whatever R."""
    facts = {} if facts is None else facts
    try:
        return _run_stacked_trace_audit(spec, mesh, replicas, steps, device,
                                        gradient_clip_val, graphed, facts)
    except Exception as exc:  # noqa: BLE001 — TA205 carries the cause
        return [Finding("TA205", f"stacked audit could not run: "
                        f"{type(exc).__name__}: {exc}")]


def _run_stacked_trace_audit(spec, mesh, replicas, steps, device,
                             gradient_clip_val, graphed, facts
                             ) -> list[Finding]:
    from masters_thesis_tpu_torch.models.lstm import StackedLstmEncoder
    from masters_thesis_tpu_torch.train.flatparams import StackedFlatAdam
    from masters_thesis_tpu_torch.train.steps import StackedTrainProgram

    spec, device, on_card, graphed = _resolve(spec, mesh, device, graphed)
    facts.update(device=str(device), graphed=graphed, steps=steps,
                 replicas=replicas)
    if on_card and not graphed:
        facts["not_applicable"] = {"TA207": f"capture count: {UNGRAPHED}"}
    with _audit_mesh(mesh, device) as audit_mesh, \
            _counting_gathers() as gathers:
        module = StackedLstmEncoder([
            spec.build_module(device=device,
                              generator=torch.Generator().manual_seed(seed))
            for seed in range(replicas)])
        optimizer = StackedFlatAdam(module.replicas, gradient_clip_val,
                                    spec.weight_decay)
        generators = [torch.Generator(device=device) for _ in range(replicas)]
        program = StackedTrainProgram(
            module, optimizer, spec.window_objective(),
            _device_data(spec, device, 1), AUDIT_BATCH, generators,
            graphed=graphed, mesh=audit_mesh)

        def begin_epoch(epoch: int) -> None:
            for r, generator in enumerate(generators):
                generator.manual_seed(10 * r + epoch)
            program.begin_epoch([1e-3 * 2.0 ** (r - epoch)
                                 for r in range(replicas)])

        findings, delta = _run_steps(program, begin_epoch, steps, on_card,
                                     device)
    if delta is None:
        return findings
    what = f"the stacked training step (R={replicas})"
    if graphed:
        findings += _capture_findings("TA207", what, program.step, steps,
                                      facts)
    findings += _collective_findings("TA207", what, delta, steps, gathers,
                                     facts)
    return findings


def assert_trace_clean(**kwargs) -> None:
    """Run the audit; raise :class:`PreflightError` on any finding."""
    findings = run_trace_audit(**kwargs)
    if findings:
        raise PreflightError(findings)


def preflight(telemetry, say, **kwargs) -> None:
    """The trainers' preflight: :func:`assert_trace_clean` with ``kwargs``,
    its verdict written as the JAX trainers' ``preflight`` event to
    ``telemetry`` (a ``TelemetryRun`` or None) and said through ``say``;
    ``PreflightError`` on a finding, after its ``failed`` event."""
    stacked = kwargs.get("stacked_replicas")
    say(f"preflight: trace audit on {kwargs.get('device')}"
        + (f" (single + stacked R={stacked})" if stacked else "") + " ...")
    try:
        assert_trace_clean(**kwargs)
    except PreflightError as exc:
        if telemetry:
            telemetry.event("preflight", status="failed",
                            rules=sorted({f.rule for f in exc.findings}),
                            findings=[f.format() for f in exc.findings])
        raise
    if telemetry and stacked:
        telemetry.event("preflight", status="ok", stacked_replicas=stacked)
    elif telemetry:
        telemetry.event("preflight", status="ok")
    say("preflight: ok")
