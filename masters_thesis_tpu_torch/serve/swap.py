"""Canaried checkpoint hot-swap: verify, canary, then commit or refuse.

Counterpart of ``CheckpointSwapper.try_swap`` in
``masters_thesis_tpu/serve/swap.py``. A serving engine picks up newly
trained weights without a restart, and a torn, bit-flipped or NaN
checkpoint never reaches traffic. :meth:`CheckpointSwapper.try_swap` runs,
in order, and refuses at the first failure without touching the serving
weights:

1. the fault point ``serve.pre_swap`` (context ``tag``; kind ``corrupt``
   flips one byte of the candidate's tree, as ``train/checkpoint.py``'s
   ``corrupt`` faults do);
2. strict manifest verification (``verify_failed``): a tree whose content
   does not prove itself against its ``MANIFEST.json``, or that has none,
   is refused; no ``.prev`` fallback, which would serve stale weights while
   reporting success;
3. the restore (``restore_failed``);
4. the signature: ``PredictEngine.put_params`` stages the candidate on
   the engine's device and raises unless its state-dict keys, shapes and
   dtypes are the serving tensors' (``shape_mismatch``), because the
   bucket programs are shape-specialised CUDA graphs;
5. the canary on the golden batch, run through the SAME bucket program as
   live traffic (``PredictEngine.predict(x, params=...)``): finite,
   bounded and, when ``max_drift`` is set, within that budget of the
   serving weights' answers (:func:`canary_checks`, numpy in f64, the JAX
   order of checks);
6. the model-quality gate (``telemetry/quality.py`` ``quality_gate``):
   the candidate's outputs on the golden windows of its own fingerprint
   (``quality.json`` in its tree, regenerated from the fingerprint's seed
   and shape), run through the engine's bucket programs in chunks of its
   largest bucket, scored against that fingerprint and, with a
   ``quality_monitor``, against the live serving sketch (with no usable
   fingerprint, the canary's outputs against the live sketch alone). A
   failure is refused by name (``quality_self``, ``quality_shadow``,
   ``quality_live``); a malformed fingerprint is refused as
   ``quality_error`` and never takes the server down. A candidate with
   neither a fingerprint nor a live sketch is not scored;
7. the commit: ``PredictEngine.set_params``, an in-place copy under the
   engine lock, with the event ``swap_committed`` (``swap_rejected`` for a
   refusal); the candidate's fingerprint becomes the monitor's reference.

:meth:`CheckpointSwapper.try_swap_lane` swaps ONE lane of a
``StackedPredictEngine`` (``serve/stacked.py``) through the same gate
(fault point, strict verification, restore, the lane's signature, the
canary on that lane), plus the JAX package's sibling-isolation check: the
staged stack's answers on every OTHER lane must be bitwise the serving
stack's, through the same bucket program (``sibling_perturbed``
otherwise: a staged lane that moves a sibling is a fault, never noise),
and the quality gate against the candidate's own fingerprint on that lane
(no live sketch: the monitor watches the ensemble's answer, not a lane).
The commit is ``StackedPredictEngine.set_lane``, a copy into the lane's
captured tensors (event ``lane_swap_committed``, ``lane_swap_rejected``
for a refusal). This module imports no torch at import: the serving
selfcheck runs :func:`canary_checks` without it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from masters_thesis_tpu_torch.resilience import faults
from masters_thesis_tpu_torch.telemetry import quality as quality_lib

#: Default canary bound on |output|: alpha and beta are standardized-return
#: quantities; anything this large is a blown-up tree even before NaN.
DEFAULT_MAX_ABS = 1e3


@dataclass
class SwapVerdict:
    ok: bool
    reason: str  # "committed" | "verify_failed" | "restore_failed" |
    #              "shape_mismatch" | "canary_<check>" | "quality_<check>"
    detail: str = ""
    checks: dict = field(default_factory=dict)


def canary_checks(
    current: tuple,
    candidate: tuple,
    max_abs: float = DEFAULT_MAX_ABS,
    max_drift: float | None = None,
) -> SwapVerdict:
    """Pure-numpy canary verdict over (alpha, beta) output pairs.

    ``max_drift`` bounds the max elementwise |candidate - current|; None
    disables the drift check (a retrain may move answers arbitrarily).
    """
    # f64 on purpose: the thresholds must not be blurred by the
    # comparison's own f32 rounding.
    cur = [np.asarray(a, np.float64) for a in current]  # mtt: disable=TL104 -- host-only f64 canary comparison; parameter deltas must not blur in f32
    cand = [np.asarray(a, np.float64) for a in candidate]  # mtt: disable=TL104 -- host-only f64 canary comparison; parameter deltas must not blur in f32
    checks: dict[str, float | bool] = {}
    finite = all(bool(np.isfinite(a).all()) for a in cand)
    checks["finite"] = finite
    if not finite:
        return SwapVerdict(
            False, "canary_nonfinite",
            "candidate produced NaN/inf on the golden batch", checks,
        )
    peak = max(float(np.abs(a).max()) for a in cand)
    checks["max_abs"] = peak
    if peak > max_abs:
        return SwapVerdict(
            False, "canary_abs",
            f"candidate |output| {peak:.3g} exceeds bound {max_abs:.3g}",
            checks,
        )
    drift = max(float(np.abs(a - b).max()) for a, b in zip(cand, cur))
    checks["drift"] = drift
    if max_drift is not None and drift > max_drift:
        return SwapVerdict(
            False, "canary_drift",
            f"candidate drifted {drift:.3g} from serving outputs "
            f"(budget {max_drift:.3g})",
            checks,
        )
    return SwapVerdict(True, "committed", checks=checks)


class CheckpointSwapper:
    """Drives the swap protocol against one engine."""

    def __init__(self, engine, *, telemetry=None,
                 max_abs: float = DEFAULT_MAX_ABS,
                 max_drift: float | None = None, quality_monitor=None):
        self.engine = engine
        #: The serving ``QualityMonitor``, or None: its live sketch enters
        #: the gate, and a commit makes the candidate's fingerprint its
        #: reference.
        self.quality = quality_monitor
        #: The canary's input: the engine's golden batch (one window).
        self.golden_x = engine.golden_batch()
        self.telemetry = telemetry
        self.max_abs = max_abs
        self.max_drift = max_drift
        self.committed = 0
        self.rejected = 0
        self.lane_committed = 0
        self.lane_rejected = 0
        #: Seconds of each step of the last ``try_swap``, in order.
        self.step_seconds: dict[str, float] = {}

    def _event(self, kind: str, **payload) -> None:
        if self.telemetry is not None:
            self.telemetry.event(kind, **payload)

    def _reject(self, tag: str, verdict: SwapVerdict) -> SwapVerdict:
        self.rejected += 1
        self._event("swap_rejected", tag=tag, reason=verdict.reason,
                    detail=verdict.detail, checks=verdict.checks)
        return verdict

    def try_swap(self, ckpt_dir, tag: str = "best") -> SwapVerdict:
        """Verify and canary ``<ckpt_dir>/<tag>``; commit on a pass, keep
        the serving weights (and say why) on any failure. Never raises for
        a bad candidate: a broken checkpoint is refused, it does not take
        the server down."""
        from masters_thesis_tpu_torch.train import checkpoint as ckpt
        from masters_thesis_tpu_torch.train.manifest import verify_checkpoint

        self.step_seconds = steps = {}
        clock = [time.perf_counter()]

        def lap(step: str) -> None:
            now = time.perf_counter()
            steps[step] = now - clock[0]
            clock[0] = now

        ckpt_dir = Path(ckpt_dir)
        path = ckpt_dir / tag
        if faults.fire("serve.pre_swap", tag=tag) == "corrupt":
            ckpt._corrupt_tree(path, seed=faults.corruption_seed())
        lap("pre_swap")
        verified = verify_checkpoint(path, require_manifest=True)
        lap("verify")
        if not verified:
            return self._reject(tag, SwapVerdict(
                False, "verify_failed",
                f"strict manifest verification failed for {path} "
                "(torn/corrupt tree, or no MANIFEST.json)"))
        try:
            state, _, _, meta = ckpt.restore_checkpoint(ckpt_dir, tag)
        except Exception as exc:  # noqa: BLE001 — any restore failure rejects
            return self._reject(tag, SwapVerdict(
                False, "restore_failed", f"{type(exc).__name__}: {exc}"))
        lap("restore")
        try:
            candidate, mismatch = self.engine.put_params(state), None
        except ValueError as exc:
            candidate, mismatch = None, exc
        lap("signature")
        if mismatch is not None:
            return self._reject(tag, SwapVerdict(
                False, "shape_mismatch",
                f"{mismatch} (an architecture change needs a restart: the "
                "bucket programs are shape-specialised)"))
        current_out = self.engine.predict(self.golden_x)
        candidate_out = self.engine.predict(self.golden_x, params=candidate)
        verdict = canary_checks(current_out, candidate_out,
                                max_abs=self.max_abs, max_drift=self.max_drift)
        lap("canary")
        if not verdict.ok:
            return self._reject(tag, verdict)
        fp = quality_lib.read_fingerprint(path)
        live = self.quality.live_summaries() if self.quality is not None else None
        refusal = self._quality_gate(
            fp, verdict, lambda x: self.engine.predict(x, params=candidate),
            live, (self.golden_x, candidate_out))
        lap("quality")
        if refusal is not None:
            return self._reject(tag, refusal)
        self.engine.set_params(candidate)
        if self.quality is not None and fp is not None:
            # The new weights' fingerprint is the drift baseline now.
            self.quality.set_reference(fp)
        lap("commit")
        self.committed += 1
        self._event("swap_committed", tag=tag, epoch=meta.get("epoch"),
                    checks=verdict.checks)
        return verdict

    def try_swap_lane(self, lane: int, ckpt_dir, tag: str = "best"
                      ) -> SwapVerdict:
        """Verify and canary ``<ckpt_dir>/<tag>`` on lane ``lane`` of a
        ``StackedPredictEngine``; commit it on that lane on a pass, with
        every sibling lane's answers proven bitwise unchanged. Never raises
        for a bad candidate."""
        from masters_thesis_tpu_torch.serve.engine import state_signature
        from masters_thesis_tpu_torch.train import checkpoint as ckpt
        from masters_thesis_tpu_torch.train.manifest import verify_checkpoint

        if not hasattr(self.engine, "stage_lane"):
            raise TypeError("try_swap_lane needs a StackedPredictEngine; "
                            f"{type(self.engine).__name__} has no lanes")
        lane = int(lane)
        ckpt_dir = Path(ckpt_dir)
        path = ckpt_dir / tag
        self.step_seconds = steps = {}
        clock = [time.perf_counter()]

        def lap(step: str) -> None:
            now = time.perf_counter()
            steps[step] = now - clock[0]
            clock[0] = now

        if faults.fire("serve.pre_swap", tag=tag) == "corrupt":
            ckpt._corrupt_tree(path, seed=faults.corruption_seed())
        lap("pre_swap")
        if not verify_checkpoint(path, require_manifest=True):
            return self._reject_lane(tag, lane, SwapVerdict(
                False, "verify_failed",
                f"strict manifest verification failed for {path} "
                "(torn/corrupt tree, or no MANIFEST.json)"))
        lap("verify")
        try:
            state, _, _, meta = ckpt.restore_checkpoint(ckpt_dir, tag)
        except Exception as exc:  # noqa: BLE001 — any restore failure rejects
            return self._reject_lane(tag, lane, SwapVerdict(
                False, "restore_failed", f"{type(exc).__name__}: {exc}"))
        lap("restore")
        if state_signature(state) != state_signature(
                self.engine.lane_params(lane)):
            return self._reject_lane(tag, lane, SwapVerdict(
                False, "shape_mismatch",
                "candidate does not match the lane's serving weights (a "
                "lane swap cannot change the architecture: the bucket "
                "programs are shape-specialised)"))
        try:
            staged = self.engine.stage_lane(lane, state)
        except Exception as exc:  # noqa: BLE001 — a staging failure rejects
            return self._reject_lane(tag, lane, SwapVerdict(
                False, "stage_failed", f"{type(exc).__name__}: {exc}"))
        lap("signature")
        cur_a, cur_b = self.engine.predict(self.golden_x)
        stg_a, stg_b = self.engine.predict(self.golden_x, params=staged)
        verdict = canary_checks(
            (cur_a[:, lane, :], cur_b[:, lane, :]),
            (stg_a[:, lane, :], stg_b[:, lane, :]),
            max_abs=self.max_abs, max_drift=self.max_drift)
        lap("canary")
        if not verdict.ok:
            return self._reject_lane(tag, lane, verdict)
        siblings_clean = all(
            np.array_equal(cur_a[:, r, :], stg_a[:, r, :])
            and np.array_equal(cur_b[:, r, :], stg_b[:, r, :])
            for r in range(self.engine.num_lanes) if r != lane)
        verdict.checks["siblings_bitwise"] = siblings_clean
        if not siblings_clean:
            return self._reject_lane(tag, lane, SwapVerdict(
                False, "sibling_perturbed",
                "staging the candidate moved a SIBLING lane's answers "
                "through the same bucket program: lane isolation is broken; "
                "refusing to commit", verdict.checks))
        refusal = self._quality_gate(
            quality_lib.read_fingerprint(path), verdict,
            lambda x: self.engine.predict_lane(x, lane, params=staged),
            None, None)
        lap("quality")
        if refusal is not None:
            return self._reject_lane(tag, lane, refusal)
        digest = self.engine.set_lane(lane, state, staged=staged)
        lap("commit")
        self.lane_committed += 1
        self._event("lane_swap_committed", tag=tag, lane=lane, digest=digest,
                    epoch=meta.get("epoch"), checks=verdict.checks)
        return verdict

    def _quality_gate(self, fp, verdict: SwapVerdict, predict, live,
                      fallback) -> SwapVerdict | None:
        """The model-quality gate of a candidate that passed the canary:
        None to go on, or the refusal. ``predict(x)`` runs the candidate on
        at most ``max_bucket`` windows ``x`` (the fingerprint's golden
        windows go through it in such chunks); ``fallback`` is ``(x,
        outputs)`` of the canary, which the live sketch scores when the
        candidate ships no usable fingerprint. The checks go into
        ``verdict.checks``."""
        try:
            gold = (fp or {}).get("golden")
            q_x = q_out = None
            if gold is not None and tuple(gold["shape"][1:]) == tuple(
                    self.engine.window_shape):
                q_x = quality_lib.golden_windows(*gold["shape"],
                                                 seed=gold.get("seed", 0))
                cap = self.engine.max_bucket
                outs = [predict(q_x[i:i + cap]) for i in range(0, len(q_x), cap)]
                q_out = tuple(np.concatenate([np.asarray(o[k]) for o in outs])
                              for k in (0, 1))
            elif live and fallback is not None:
                q_x, q_out = fallback
            if q_out is None:
                return None
            ok, reason, detail, checks = quality_lib.quality_gate(
                fp, q_x, q_out[0], q_out[1], live=live)
            verdict.checks.update(checks)
            if not ok:
                return SwapVerdict(False, reason, detail, verdict.checks)
        except Exception as exc:  # noqa: BLE001 — a malformed fingerprint
            # is refused; it never takes the server down.
            return SwapVerdict(
                False, "quality_error",
                "quality gate could not score the candidate: "
                f"{type(exc).__name__}: {exc}", verdict.checks)
        return None

    def _reject_lane(self, tag: str, lane: int, verdict: SwapVerdict
                     ) -> SwapVerdict:
        self.lane_rejected += 1
        self._event("lane_swap_rejected", tag=tag, lane=lane,
                    reason=verdict.reason, detail=verdict.detail,
                    checks=verdict.checks)
        return verdict
