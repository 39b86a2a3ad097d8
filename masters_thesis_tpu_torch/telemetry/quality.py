"""Model-quality plane: streaming drift sketches and shadow-OLS monitoring.

Counterpart of ``masters_thesis_tpu/telemetry/quality.py``, copied whole
(stdlib and numpy only, no torch): it runs in the ``python -m
masters_thesis_tpu_torch.telemetry quality`` reader, beside a hung run, and
on the serving thread after a hand-back, where it touches no device.

Three stages share one sketch format:

- **Train**: the trainer fingerprints the validation windows at checkpoint
  time (a sketch a feature, the predicted alpha and beta, shadow-OLS
  disagreement, and a golden-window section) into ``quality.json`` inside
  the checkpoint tree (``<tag>/quality.json`` beside ``state.pt``), covered
  by its ``MANIFEST.json``.
- **Serve**: ``QualityMonitor`` samples 1 in K delivered answers on the
  host, runs the closed-form OLS shadow estimate on each sampled window,
  and publishes ``quality_sample`` events and ``quality/*`` gauges that the
  SLO engine folds into its drift and disagreement rules.
- **Publish**: ``quality_gate`` scores a swap candidate's golden-window
  outputs against the candidate's own fingerprint and the live serving
  sketch, so that a diverged fine-tune is rejected with a named reason
  while a retrain with a fresh fingerprint passes.

Sketch = Welford moments, min/max and P² quantile estimators on a fixed
probability grid. Two sketches compare by PSI (bins from the reference's
quantile grid) and a two-sample KS score (the largest CDF gap over the
union of both grids). Summaries round-trip through JSON exactly
(shortest-repr floats).
"""

from __future__ import annotations

import json
import math
import threading
from pathlib import Path

import numpy as np

__all__ = [
    "P2Quantile",
    "StreamSketch",
    "psi",
    "ks",
    "infer_factors",
    "shadow_ols",
    "shadow_error",
    "golden_windows",
    "build_fingerprint",
    "fingerprint_to_json",
    "read_fingerprint",
    "sketch_to_json",
    "sketch_from_json",
    "QualityMonitor",
    "quality_gate",
    "quality_report",
    "render_quality",
    "selfcheck",
    "FINGERPRINT_FILENAME",
]

QUANTILE_GRID = (0.05, 0.10, 0.25, 0.50, 0.75, 0.90, 0.95)
FINGERPRINT_FILENAME = "quality.json"
FINGERPRINT_VERSION = 1

# Detector defaults. PSI reads on the usual industry scale (< 0.1 calm,
# 0.1-0.25 drifting, > 0.25 act); the shadow threshold is a mean |model
# minus OLS| disagreement in (α, β) units.
DEFAULT_INPUT_THRESHOLD = 0.25
DEFAULT_PREDICTION_THRESHOLD = 0.25
DEFAULT_SHADOW_THRESHOLD = 0.50

# Gate defaults (see docs/quality.md for semantics).
GATE_MAX_SELF_KS = 0.35
GATE_SHADOW_SLACK = 4.0
GATE_SHADOW_FLOOR = 0.50
GATE_MAX_LIVE_KS = 0.60


# ------------------------------------------------------------------ sketches


class P2Quantile:
    """Single-quantile streaming estimator (Jain & Chlamtac's P², 1985).

    O(1) memory: five markers whose heights track the min, the p/2, p,
    (1+p)/2 quantiles and the max, nudged toward their desired positions
    with a piecewise-parabolic update on every observation.
    """

    __slots__ = ("p", "_first", "_q", "_n", "_np", "_dn")

    def __init__(self, p: float):
        if not 0.0 < p < 1.0:
            raise ValueError(f"quantile probability must be in (0, 1): {p}")
        self.p = float(p)
        self._first: list[float] = []
        self._q: list[float] | None = None  # marker heights
        self._n: list[float] | None = None  # marker positions (1-based)
        self._np: list[float] | None = None  # desired positions
        self._dn = (0.0, self.p / 2.0, self.p, (1.0 + self.p) / 2.0, 1.0)

    def update(self, x: float) -> None:
        x = float(x)
        if self._q is None:
            self._first.append(x)
            if len(self._first) == 5:
                self._first.sort()
                self._q = list(self._first)
                self._n = [1.0, 2.0, 3.0, 4.0, 5.0]
                self._np = [1.0 + 4.0 * d for d in self._dn]
            return
        q, n, np_ = self._q, self._n, self._np
        if x < q[0]:
            q[0] = x
            k = 0
        elif x >= q[4]:
            if x > q[4]:
                q[4] = x
            k = 3
        else:
            k = next(i for i in range(4) if q[i] <= x < q[i + 1])
        for i in range(k + 1, 5):
            n[i] += 1.0
        for i in range(5):
            np_[i] += self._dn[i]
        for i in (1, 2, 3):
            d = np_[i] - n[i]
            if (d >= 1.0 and n[i + 1] - n[i] > 1.0) or (
                d <= -1.0 and n[i - 1] - n[i] < -1.0
            ):
                d = 1.0 if d > 0 else -1.0
                h = self._parabolic(i, d)
                if not q[i - 1] < h < q[i + 1]:
                    h = self._linear(i, d)
                q[i] = h
                n[i] += d

    def _parabolic(self, i: int, d: float) -> float:
        q, n = self._q, self._n
        return q[i] + d / (n[i + 1] - n[i - 1]) * (
            (n[i] - n[i - 1] + d) * (q[i + 1] - q[i]) / (n[i + 1] - n[i])
            + (n[i + 1] - n[i] - d) * (q[i] - q[i - 1]) / (n[i] - n[i - 1])
        )

    def _linear(self, i: int, d: float) -> float:
        q, n = self._q, self._n
        j = i + int(d)
        return q[i] + d * (q[j] - q[i]) / (n[j] - n[i])

    def value(self) -> float:
        if self._q is not None:
            return float(self._q[2])
        if not self._first:
            return math.nan
        return float(np.quantile(np.asarray(self._first, dtype=np.float64), self.p))  # mtt: disable=TL104 -- host-only sketch/OLS math in f64; never in a graph


class StreamSketch:
    """Welford moments + min/max + a P² quantile grid for one scalar stream.

    ``update`` accepts scalars or arrays (non-finite values are dropped).
    ``from_values`` builds the same summary shape from a full sample with
    *exact* numpy quantiles — used for checkpoint-time fingerprints where
    the whole validation set is in hand.
    """

    def __init__(self, grid=QUANTILE_GRID):
        self.grid = tuple(float(p) for p in grid)
        self.count = 0
        self.mean = 0.0
        self._m2 = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._quant = [P2Quantile(p) for p in self.grid]
        self._exact: list[float] | None = None

    def update(self, values) -> None:
        arr = np.asarray(values, dtype=np.float64).ravel()  # mtt: disable=TL104 -- host-only sketch/OLS math in f64; never in a graph
        arr = arr[np.isfinite(arr)]
        for x in arr.tolist():
            self.count += 1  # mtt: disable=CL502 -- single-thread or guarded by the owning QualityMonitor._lock
            delta = x - self.mean
            self.mean += delta / self.count  # mtt: disable=CL502 -- single-thread or guarded by the owning QualityMonitor._lock
            self._m2 += delta * (x - self.mean)  # mtt: disable=CL502 -- single-thread or guarded by the owning QualityMonitor._lock
            if x < self.min:
                self.min = x
            if x > self.max:
                self.max = x
            for q in self._quant:
                q.update(x)

    @classmethod
    def from_values(cls, values, grid=QUANTILE_GRID) -> "StreamSketch":
        arr = np.asarray(values, dtype=np.float64).ravel()  # mtt: disable=TL104 -- host-only sketch/OLS math in f64; never in a graph
        arr = arr[np.isfinite(arr)]
        sk = cls(grid)
        if arr.size == 0:
            return sk
        sk.count = int(arr.size)
        sk.mean = float(arr.mean())
        sk._m2 = float(((arr - arr.mean()) ** 2).sum())
        sk.min = float(arr.min())
        sk.max = float(arr.max())
        sk._exact = [float(np.quantile(arr, p)) for p in sk.grid]
        return sk

    def summary(self) -> dict:
        if self.count == 0:
            quantiles = [math.nan] * len(self.grid)
            lo = hi = math.nan
            var = 0.0
        else:
            if self._exact is not None:
                quantiles = list(self._exact)
            else:
                quantiles = [q.value() for q in self._quant]
            lo, hi = float(self.min), float(self.max)
            var = self._m2 / (self.count - 1) if self.count > 1 else 0.0
        return {
            "count": int(self.count),
            "mean": float(self.mean),
            "var": float(var),
            "min": lo,
            "max": hi,
            "grid": [float(p) for p in self.grid],
            "quantiles": [float(v) for v in quantiles],
        }


def sketch_to_json(summary: dict) -> str:
    """Canonical JSON for a sketch summary — bit-stable round trip."""
    return json.dumps(summary, sort_keys=True, separators=(",", ":"))


def sketch_from_json(text: str) -> dict:
    return json.loads(text)


# ------------------------------------------------------- distribution scores


def _cdf_points(summary: dict):
    """Monotone (x, F(x)) knots from a sketch summary."""
    xs = np.asarray(
        [summary["min"], *summary["quantiles"], summary["max"]], dtype=np.float64  # mtt: disable=TL104 -- host-only sketch/OLS math in f64; never in a graph
    )
    ps = np.asarray([0.0, *summary["grid"], 1.0], dtype=np.float64)  # mtt: disable=TL104 -- host-only sketch/OLS math in f64; never in a graph
    xs = np.maximum.accumulate(xs)
    return xs, ps


def _cdf(summary: dict, at: np.ndarray) -> np.ndarray:
    xs, ps = _cdf_points(summary)
    return np.interp(at, xs, ps, left=0.0, right=1.0)


def psi(reference: dict, live: dict, eps: float = 1e-4) -> float:
    """Population-stability index of ``live`` against ``reference``.

    Bins are the reference quantile grid (plus min/max), so the expected
    mass per bin comes straight from the grid probabilities; the actual
    mass is the live CDF evaluated at the reference edges.
    """
    if not reference.get("count") or not live.get("count"):
        return 0.0
    edges, edge_p = _cdf_points(reference)
    expected = np.diff(edge_p)
    actual = np.diff(_cdf(live, edges))
    keep = expected > 0
    if not keep.any():
        return 0.0
    expected = np.clip(expected[keep], eps, None)
    actual = np.clip(actual[keep], eps, None)
    expected = expected / expected.sum()
    actual = actual / actual.sum()
    return float(np.sum((actual - expected) * np.log(actual / expected)))


def ks(reference: dict, live: dict) -> float:
    """Two-sample KS score: max CDF gap over the union of both grids."""
    if not reference.get("count") or not live.get("count"):
        return 0.0
    rx, _ = _cdf_points(reference)
    lx, _ = _cdf_points(live)
    at = np.union1d(rx, lx)
    return float(np.max(np.abs(_cdf(reference, at) - _cdf(live, at))))


# ------------------------------------------------------------- shadow OLS


def infer_factors(n_features: int) -> int:
    """Factor count K from a window's feature channel count.

    The interaction-only pipeline layout (data/pipeline.py) is
    ``[r_stock, f_1..f_K, r_stock*f_1..r_stock*f_K]`` → ``f = 2K + 1``.
    ``f == 3`` is the scalar-market anchor (K = 1).
    """
    return 1 if n_features == 3 else max(1, (int(n_features) - 1) // 2)


def shadow_ols(x, n_factors: int | None = None):
    """Closed-form per-window OLS (α, β) — the thesis baseline, in numpy.

    Mirrors ``ops/linalg.ols``/``ols_k`` + the ``evaluation.py`` slicing
    convention: regressors = features ``1..K`` of stock 0 (the broadcast
    factor series), regressand = feature 0 of every stock. ``x`` is
    ``(n, k, t, f)`` or one window ``(k, t, f)``; ``n_factors`` overrides
    the channel-count inference (:func:`infer_factors`).

    Returns ``(alpha, beta)``: ``alpha`` is ``(n, k)``; ``beta`` is
    ``(n, k)`` at K = 1 (the original scalar path, op for op — the
    bitwise parity anchor) and ``(n, k, K)`` for K > 1 (one loading per
    factor, the numpy twin of ``ops/linalg._batched_ols_k``).
    """
    x = np.asarray(x, dtype=np.float64)  # mtt: disable=TL104 -- host-only sketch/OLS math in f64; never in a graph
    if x.ndim == 3:
        x = x[None]
    if n_factors is None:
        n_factors = infer_factors(x.shape[-1])
    rets = x[:, :, :, 0]  # (n, k, t)
    if n_factors == 1:
        # Scalar path kept op for op: K=1 results must stay bit-identical
        # to every fingerprint and test pinned before K-factor support.
        market = x[:, 0, :, 1]  # (n, t)
        design = np.stack([np.ones_like(market), market], axis=-1)
        gram = design.transpose(0, 2, 1) @ design  # (n, 2, 2)
        moment = design.transpose(0, 2, 1) @ rets.transpose(0, 2, 1)
        coef = np.linalg.pinv(gram) @ moment
        return coef[:, 0, :], coef[:, 1, :]
    factors = x[:, 0, :, 1 : 1 + n_factors]  # (n, t, K)
    ones = np.ones(factors.shape[:-1] + (1,), factors.dtype)
    design = np.concatenate([ones, factors], axis=-1)  # (n, t, K+1)
    gram = design.transpose(0, 2, 1) @ design  # (n, K+1, K+1)
    moment = design.transpose(0, 2, 1) @ rets.transpose(0, 2, 1)
    coef = np.linalg.pinv(gram) @ moment  # (n, K+1, k)
    return coef[:, 0, :], np.swapaxes(coef[:, 1:, :], -1, -2)


def shadow_error(x, alpha, beta, n_factors: int | None = None) -> float:
    """Mean |model − shadow-OLS| disagreement over a window batch.

    With K > 1 factors the OLS betas are ``(n, k, K)``; a model that
    serves the full loading matrix is scored loading-for-loading, while
    one that serves a single ``(n, k)`` beta is scored against the FIRST
    factor's loading (the market line — the K = 1 semantics).
    """
    sa, sb = shadow_ols(x, n_factors=n_factors)
    a = np.asarray(alpha, dtype=np.float64).reshape(sa.shape)  # mtt: disable=TL104 -- host-only sketch/OLS math in f64; never in a graph
    b = np.asarray(beta, dtype=np.float64)  # mtt: disable=TL104 -- host-only sketch/OLS math in f64; never in a graph
    if b.size != sb.size and sb.ndim == 3:
        sb = sb[..., 0]
    b = b.reshape(sb.shape)
    return float(0.5 * (np.mean(np.abs(a - sa)) + np.mean(np.abs(b - sb))))


def golden_windows(n: int, n_stocks: int, lookback: int, n_features: int, seed: int = 0):
    """Deterministic standard-normal golden windows ``(n, k, t, f)`` f32.

    numpy-only so the trainer fingerprint and the swap gate agree on the
    exact bytes without a device in the loop.
    """
    rng = np.random.default_rng(int(seed))
    return rng.standard_normal((n, n_stocks, lookback, n_features)).astype(np.float32)


# ------------------------------------------------------------- fingerprints


def build_fingerprint(
    x,
    alpha,
    beta,
    *,
    golden=None,
    golden_seed: int = 0,
    max_windows: int = 256,
) -> dict:
    """Checkpoint-time quality fingerprint.

    ``x`` is validation windows ``(n, k, t, f)``; ``alpha``/``beta`` the
    model's predictions on them ``(n, k)``. ``golden`` is an optional
    ``(gx, galpha, gbeta)`` triple of the model's outputs on
    ``golden_windows(..., seed=golden_seed)`` — the section the swap
    quality gate scores candidates against.
    """
    x = np.asarray(x, dtype=np.float64)[:max_windows]  # mtt: disable=TL104 -- host-only sketch/OLS math in f64; never in a graph
    alpha = np.asarray(alpha, dtype=np.float64)[: x.shape[0]]  # mtt: disable=TL104 -- host-only sketch/OLS math in f64; never in a graph
    beta = np.asarray(beta, dtype=np.float64)[: x.shape[0]]  # mtt: disable=TL104 -- host-only sketch/OLS math in f64; never in a graph
    sa, sb = shadow_ols(x)
    if beta.size != sb.size and sb.ndim == 3:
        # Single-loading model under a K-factor window: fingerprint the
        # first factor's loading, matching shadow_error's convention.
        sb = sb[..., 0]
    fp = {
        "version": FINGERPRINT_VERSION,
        "windows": int(x.shape[0]),
        "window_shape": [int(s) for s in x.shape[1:]],
        "features": {
            str(fi): StreamSketch.from_values(x[..., fi]).summary()
            for fi in range(x.shape[-1])
        },
        "alpha": StreamSketch.from_values(alpha).summary(),
        "beta": StreamSketch.from_values(beta).summary(),
        "shadow": {
            "err_mean": shadow_error(x, alpha, beta),
            "alpha_mae": float(np.mean(np.abs(alpha.reshape(sa.shape) - sa))),
            "beta_mae": float(np.mean(np.abs(beta.reshape(sb.shape) - sb))),
        },
    }
    if golden is not None:
        gx, ga, gb = golden
        gx = np.asarray(gx, dtype=np.float64)  # mtt: disable=TL104 -- host-only sketch/OLS math in f64; never in a graph
        fp["golden"] = {
            "seed": int(golden_seed),
            "shape": [int(s) for s in gx.shape],
            "alpha": StreamSketch.from_values(ga).summary(),
            "beta": StreamSketch.from_values(gb).summary(),
            "shadow_err": shadow_error(gx, ga, gb),
        }
    return fp


def fingerprint_to_json(fp: dict) -> str:
    return json.dumps(fp, sort_keys=True, separators=(",", ":"))


def read_fingerprint(tree) -> dict | None:
    """Load ``quality.json`` from a checkpoint tree, or None."""
    path = Path(tree) / FINGERPRINT_FILENAME
    if not path.exists():
        return None
    try:
        return json.loads(path.read_text())
    except (OSError, json.JSONDecodeError):
        return None


# ------------------------------------------------------------ live monitor


class QualityMonitor:
    """1-in-K post-delivery sampler + drift detectors for a serve process.

    ``sample(x, alpha, beta)`` is called by the server strictly *after*
    a response is delivered, with host-side numpy arrays (one window
    ``(k, t, f)`` and its ``(k,)`` outputs) — no fences, no transfers.
    Every ``sample_every``-th call updates the live sketches, runs the
    shadow OLS on that window, and (once ``min_samples`` windows are in)
    scores the live sketches against the reference fingerprint, sets
    ``quality/*`` gauges (exposed as ``mtt_quality_*``) and emits one
    ``quality_sample`` event for the SLO engine and the report readers.
    """

    def __init__(
        self,
        reference: dict | None = None,
        *,
        sample_every: int = 16,
        min_samples: int = 8,
        input_threshold: float = DEFAULT_INPUT_THRESHOLD,
        prediction_threshold: float = DEFAULT_PREDICTION_THRESHOLD,
        shadow_threshold: float = DEFAULT_SHADOW_THRESHOLD,
        shadow_alpha: float = 0.25,
        telemetry=None,
    ):
        self.sample_every = max(1, int(sample_every))
        self.min_samples = max(1, int(min_samples))
        self.input_threshold = float(input_threshold)
        self.prediction_threshold = float(prediction_threshold)
        self.shadow_threshold = float(shadow_threshold)
        self._shadow_alpha = float(shadow_alpha)
        self._telemetry = telemetry
        self._lock = threading.Lock()
        self.reference = reference
        self._reset_locked()

    def _reset_locked(self) -> None:
        self._seen = 0  # mtt: disable=CL502 -- _locked contract: callers hold self._lock (or __init__ pre-share)
        self._sampled = 0
        self._features: dict[int, StreamSketch] = {}
        self._alpha = StreamSketch()
        self._beta = StreamSketch()
        self._shadow = StreamSketch()
        self._shadow_ewm: float | None = None
        self._last: dict | None = None  # mtt: disable=CL502 -- _locked contract: callers hold self._lock (or __init__ pre-share)

    def set_reference(self, fingerprint: dict | None) -> None:
        """Swap in a new baseline (post-commit); live sketches restart."""
        with self._lock:
            self.reference = fingerprint
            self._reset_locked()

    def live_summaries(self) -> dict:
        """Current serving sketches for the swap gate's live check."""
        with self._lock:
            if self._sampled < self.min_samples:
                return {}
            return {
                "sampled": self._sampled,
                "alpha": self._alpha.summary(),
                "beta": self._beta.summary(),
                "shadow_err": self._shadow_ewm,
            }

    def last_scores(self) -> dict | None:
        with self._lock:
            return dict(self._last) if self._last is not None else None

    def sample(self, x, alpha, beta) -> dict | None:
        """Post-delivery hook; returns the scores dict on sampled windows."""
        with self._lock:
            self._seen += 1
            if (self._seen - 1) % self.sample_every:
                return None
            scores = self._ingest_locked(
                np.asarray(x), np.asarray(alpha), np.asarray(beta)
            )
            self._last = scores
        self._publish_sample(scores)
        return scores

    def _ingest_locked(self, x, alpha, beta) -> dict:
        for fi in range(x.shape[-1]):
            self._features.setdefault(fi, StreamSketch()).update(x[..., fi])
        self._alpha.update(alpha)
        self._beta.update(beta)
        err = shadow_error(x, alpha, beta)
        self._shadow.update(err)
        if self._shadow_ewm is None:
            self._shadow_ewm = err
        else:
            a = self._shadow_alpha
            self._shadow_ewm = a * err + (1.0 - a) * self._shadow_ewm  # mtt: disable=CL502 -- _locked contract: sample() holds self._lock
        self._sampled += 1  # mtt: disable=CL502 -- _locked contract: sample() holds self._lock
        scores = {
            "sampled": self._sampled,
            "scored": False,
            "shadow_err": float(self._shadow_ewm),
            "shadow_thr": self.shadow_threshold,
            "input_psi": 0.0,
            "input_ks": 0.0,
            "pred_psi": 0.0,
            "pred_ks": 0.0,
            "input_thr": self.input_threshold,
            "pred_thr": self.prediction_threshold,
        }
        ref = self.reference
        if ref is not None and self._sampled >= self.min_samples:
            in_psi = in_ks = 0.0
            ref_features = ref.get("features", {})
            for fi, sk in self._features.items():
                ref_sk = ref_features.get(str(fi))
                if ref_sk is None:
                    continue
                live = sk.summary()
                in_psi = max(in_psi, psi(ref_sk, live))
                in_ks = max(in_ks, ks(ref_sk, live))
            live_a = self._alpha.summary()
            live_b = self._beta.summary()
            pr_psi = max(psi(ref["alpha"], live_a), psi(ref["beta"], live_b))
            pr_ks = max(ks(ref["alpha"], live_a), ks(ref["beta"], live_b))
            scores.update(
                scored=True,
                input_psi=float(in_psi),
                input_ks=float(in_ks),
                pred_psi=float(pr_psi),
                pred_ks=float(pr_ks),
            )
        scores["input_breached"] = bool(
            scores["scored"] and scores["input_psi"] > self.input_threshold
        )
        scores["pred_breached"] = bool(
            scores["scored"] and scores["pred_psi"] > self.prediction_threshold
        )
        scores["shadow_breached"] = bool(
            self._sampled >= self.min_samples
            and scores["shadow_err"] > self.shadow_threshold
        )
        return scores

    def _publish_sample(self, scores: dict) -> None:
        # Outside the monitor lock: the registry and the sink have their
        # own locks and the sink does file IO.
        t = self._telemetry
        if t is None:
            return
        t.counter("quality/sampled").inc(1)
        t.gauge("quality/shadow_err").set(float(scores["shadow_err"]))
        if scores["scored"]:
            t.gauge("quality/input_psi").set(float(scores["input_psi"]))
            t.gauge("quality/input_ks").set(float(scores["input_ks"]))
            t.gauge("quality/prediction_psi").set(float(scores["pred_psi"]))
            t.gauge("quality/prediction_ks").set(float(scores["pred_ks"]))
        t.event(
            "quality_sample",
            sampled=int(scores["sampled"]),
            scored=bool(scores["scored"]),
            input_psi=float(scores["input_psi"]),
            input_ks=float(scores["input_ks"]),
            pred_psi=float(scores["pred_psi"]),
            pred_ks=float(scores["pred_ks"]),
            shadow_err=float(scores["shadow_err"]),
            input_thr=float(scores["input_thr"]),
            pred_thr=float(scores["pred_thr"]),
            shadow_thr=float(scores["shadow_thr"]),
            input_breached=bool(scores["input_breached"]),
            pred_breached=bool(scores["pred_breached"]),
            shadow_breached=bool(scores["shadow_breached"]),
        )


# ---------------------------------------------------------------- swap gate


def quality_gate(
    fingerprint: dict | None,
    x,
    alpha,
    beta,
    *,
    live: dict | None = None,
    max_self_ks: float = GATE_MAX_SELF_KS,
    shadow_slack: float = GATE_SHADOW_SLACK,
    shadow_floor: float = GATE_SHADOW_FLOOR,
    max_live_ks: float = GATE_MAX_LIVE_KS,
):
    """Score candidate golden-batch outputs for the hot-swap canary.

    ``x`` are the golden windows the candidate was evaluated on and
    ``alpha``/``beta`` its outputs. Returns ``(ok, reason, detail,
    checks)`` with reasons named ``quality_self`` (outputs diverge from
    the candidate's own shipped fingerprint — the diverged-fine-tune
    case), ``quality_shadow`` (shadow-OLS disagreement beyond the
    shipped budget), and ``quality_live`` (no fingerprint shipped and
    outputs diverge from the live serving sketch).
    """
    checks: dict[str, float] = {}
    a_sum = StreamSketch.from_values(alpha).summary()
    b_sum = StreamSketch.from_values(beta).summary()
    err = shadow_error(x, alpha, beta)
    checks["quality_shadow_err"] = err
    gold = (fingerprint or {}).get("golden")
    if gold is not None:
        self_ks = max(ks(gold["alpha"], a_sum), ks(gold["beta"], b_sum))
        checks["quality_self_ks"] = self_ks
        budget = max(shadow_floor, shadow_slack * float(gold.get("shadow_err", 0.0)))
        checks["quality_shadow_budget"] = budget
        if self_ks > max_self_ks:
            return (
                False,
                "quality_self",
                f"golden outputs diverge from the shipped fingerprint "
                f"(ks={self_ks:.4f} > {max_self_ks})",
                checks,
            )
        if err > budget:
            return (
                False,
                "quality_shadow",
                f"shadow-OLS disagreement {err:.4f} exceeds the shipped "
                f"budget {budget:.4f}",
                checks,
            )
    if live:
        live_ks = 0.0
        if live.get("alpha"):
            live_ks = max(ks(live["alpha"], a_sum), ks(live["beta"], b_sum))
        checks["quality_live_ks"] = live_ks
        if gold is None and live_ks > max_live_ks:
            return (
                False,
                "quality_live",
                f"no fingerprint shipped and golden outputs diverge from "
                f"the live serving sketch (ks={live_ks:.4f} > {max_live_ks})",
                checks,
            )
    return True, "", "", checks


# ------------------------------------------------------------ event folding


def quality_report(events) -> dict:
    """Fold a merged event stream into the quality section dict.

    Shared by ``report.summarize_events``, the watch console and the
    ``quality`` CLI verb. Input is an iterable of decoded event dicts.
    """
    samples = [e for e in events if e.get("kind") == "quality_sample"]
    out: dict = {"samples": len(samples)}
    if samples:
        last = samples[-1]
        out["last"] = {
            "sampled": last.get("sampled"),
            "scored": bool(last.get("scored")),
            "input_psi": last.get("input_psi"),
            "pred_psi": last.get("pred_psi"),
            "shadow_err": last.get("shadow_err"),
        }
        out["max"] = {
            "input_psi": max(float(e.get("input_psi") or 0.0) for e in samples),
            "pred_psi": max(float(e.get("pred_psi") or 0.0) for e in samples),
            "shadow_err": max(float(e.get("shadow_err") or 0.0) for e in samples),
        }
        out["breaches"] = {
            "input": sum(1 for e in samples if e.get("input_breached")),
            "prediction": sum(1 for e in samples if e.get("pred_breached")),
            "shadow": sum(1 for e in samples if e.get("shadow_breached")),
        }
    rejected = [
        e
        for e in events
        if e.get("kind") == "swap_rejected"
        and str(e.get("reason") or "").startswith("quality")
    ]
    if rejected:
        out["swaps_rejected_quality"] = len(rejected)
        out["last_rejection"] = {
            "tag": rejected[-1].get("tag"),
            "reason": rejected[-1].get("reason"),
        }
    fired = [
        e
        for e in events
        if e.get("kind") == "alert_fired"
        and e.get("slo_kind")
        in ("input_drift", "prediction_drift", "shadow_disagreement")
    ]
    if fired:
        out["alerts_fired"] = len(fired)
    return out


def quality_violations(events, quality: dict | None = None) -> list[str]:
    """Detector-wiring contract: sustained shadow breach must alert.

    Only meaningful when an SLO engine was actually attached (we see
    ``slo_snapshot`` or any ``alert_*`` traffic); a bare serve run with
    no monitor thread is not a violation.
    """
    quality = quality if quality is not None else quality_report(events)
    breaches = (quality.get("breaches") or {}).get("shadow", 0)
    if breaches < 3:
        return []
    slo_attached = any(
        e.get("kind") in ("slo_snapshot", "alert_fired", "alert_resolved")
        for e in events
    )
    if not slo_attached:
        return []
    shadow_alerts = any(
        e.get("kind") == "alert_fired"
        and e.get("slo_kind") == "shadow_disagreement"
        for e in events
    )
    if shadow_alerts:
        return []
    return [
        f"shadow-OLS disagreement breached on {breaches} sampled windows "
        "but no shadow_disagreement alert fired (detector wiring broken)"
    ]


def render_quality(quality: dict) -> str:
    """One-line QUALITY row for the watch console / text report."""
    if not quality or not quality.get("samples"):
        return "QUALITY   (no sampled windows)"
    last = quality.get("last") or {}
    br = quality.get("breaches") or {}

    def _mark(value, breached):
        v = "-" if value is None else f"{float(value):.3f}"
        return v + ("!" if breached else "")

    parts = [
        f"samples={quality['samples']}",
        "input_psi=" + _mark(last.get("input_psi"), br.get("input")),
        "pred_psi=" + _mark(last.get("pred_psi"), br.get("prediction")),
        "shadow=" + _mark(last.get("shadow_err"), br.get("shadow")),
    ]
    if quality.get("swaps_rejected_quality"):
        parts.append(f"swaps_rejected={quality['swaps_rejected_quality']}")
    if quality.get("alerts_fired"):
        parts.append(f"alerts={quality['alerts_fired']}")
    return "QUALITY   " + "  ".join(parts)


# ---------------------------------------------------------------- selfcheck


def _check(ok: bool, label: str, failures: list[str]) -> None:
    print(f"  {'ok' if ok else 'FAIL'}  {label}")
    if not ok:
        failures.append(label)


def selfcheck(verbose: bool = True) -> bool:
    """Hermetic fixture: sketch math, detectors, gate."""
    failures: list[str] = []
    rng = np.random.default_rng(7)

    # 1. P² accuracy vs exact quantiles on three stream shapes.
    streams = {
        "normal": rng.standard_normal(4000),
        "student_t": rng.standard_t(3, size=4000),
        "bimodal": np.concatenate(
            [rng.normal(-2.0, 0.5, 2000), rng.normal(2.0, 0.5, 2000)]
        ),
    }
    for name, data in streams.items():
        sk = StreamSketch()
        sk.update(data)
        got = np.asarray(sk.summary()["quantiles"])
        want = np.quantile(data, np.asarray(QUANTILE_GRID))
        # Per-quantile: accept x-space closeness OR probability-space
        # closeness — heavy tails (student-t) blow up x-space error where
        # density is thin, density gaps (bimodal) blow up probability
        # space where the CDF is flat; neither alone is fair to both.
        ecdf = np.asarray([(data <= v).mean() for v in got])
        x_ok = np.abs(got - want) < 0.1 * float(data.std()) + 0.02
        p_ok = np.abs(ecdf - np.asarray(QUANTILE_GRID)) < 0.02
        _check(
            bool(np.all(x_ok | p_ok)),
            f"p2 quantiles ~ exact ({name})",
            failures,
        )

    # 2. PSI/KS: IID halves quiet, injected shift loud.
    base = rng.standard_normal(20_000)
    ref = StreamSketch.from_values(base[:10_000]).summary()
    iid = StreamSketch.from_values(base[10_000:]).summary()
    shifted = StreamSketch.from_values(base[10_000:] * 1.5 + 0.75).summary()
    _check(psi(ref, iid) < 0.02 and ks(ref, iid) < 0.03, "psi/ks ~ 0 on IID halves", failures)
    _check(psi(ref, shifted) > 0.3 and ks(ref, shifted) > 0.2, "psi/ks large under shift", failures)

    # 3. JSON round trip is bit-stable.
    js = sketch_to_json(ref)
    _check(sketch_to_json(sketch_from_json(js)) == js, "sketch JSON round-trip bit-stable", failures)

    # 4. Shadow OLS matches per-window polyfit.
    x = rng.standard_normal((4, 6, 32, 3))
    sa, sb = shadow_ols(x)
    ok = True
    for n in range(4):
        for k_i in range(6):
            b1, b0 = np.polyfit(x[n, 0, :, 1], x[n, k_i, :, 0], 1)
            ok = ok and abs(sa[n, k_i] - b0) < 1e-8 and abs(sb[n, k_i] - b1) < 1e-8
    _check(ok, "shadow OLS == per-window polyfit", failures)

    # 5. Monitor: IID twin stays silent, shifted stream breaches input
    #    drift, garbage predictions breach shadow disagreement.
    def _windows(m, shift_scale=1.0, shift_off=0.0, seed=11):
        g = np.random.default_rng(seed)
        xs = g.standard_normal((m, 6, 32, 3)).astype(np.float32)
        xs = xs * shift_scale + shift_off
        a, b = shadow_ols(xs)
        return xs, a, b

    fx, fa, fb = _windows(64)
    fp = build_fingerprint(fx, fa, fb)

    def _run(monitor, m, **kw):
        xs, a, b = _windows(m, **kw)
        out = []
        for i in range(m):
            s = monitor.sample(xs[i], a[i], b[i])
            if s is not None:
                out.append(s)
        return out

    mon = QualityMonitor(fp, sample_every=1, min_samples=8)
    quiet = _run(mon, 48, seed=12)
    _check(
        not any(s["input_breached"] or s["shadow_breached"] for s in quiet),
        "monitor silent on IID twin",
        failures,
    )
    mon = QualityMonitor(fp, sample_every=1, min_samples=8)
    loud = _run(mon, 48, shift_scale=1.6, shift_off=0.8, seed=13)
    fired_at = next(
        (s["sampled"] for s in loud if s["input_breached"]), None
    )
    _check(
        fired_at is not None and fired_at <= 24,
        "input drift fires within 24 sampled windows under shift",
        failures,
    )
    mon = QualityMonitor(fp, sample_every=1, min_samples=4)
    xs, a, b = _windows(24, seed=14)
    bad = [mon.sample(xs[i], a[i] * 40.0 + 3.0, b[i] * 40.0) for i in range(24)]
    _check(
        any(s["shadow_breached"] for s in bad if s),
        "shadow disagreement fires on garbage predictions",
        failures,
    )

    # 6. Gate: honest fingerprint passes, diverged fine-tune rejected.
    gx = golden_windows(16, 6, 32, 3, seed=0)
    ga, gb = shadow_ols(gx)
    fp_gold = build_fingerprint(fx, fa, fb, golden=(gx, ga, gb), golden_seed=0)
    ok, reason, _, _ = quality_gate(fp_gold, gx, ga, gb)
    _check(ok and not reason, "gate passes the honest candidate", failures)
    ok, reason, _, checks = quality_gate(fp_gold, gx, ga * 50.0 + 5.0, gb * 50.0)
    _check(
        not ok and reason in ("quality_self", "quality_shadow"),
        f"gate rejects the diverged candidate ({reason or 'no reason'})",
        failures,
    )

    # 7. Report folding + violation contract.
    events = [
        {"kind": "quality_sample", "sampled": i + 1, "scored": True,
         "input_psi": 0.01, "pred_psi": 0.01, "shadow_err": 0.9,
         "input_breached": False, "pred_breached": False,
         "shadow_breached": True}
        for i in range(4)
    ]
    events.append({"kind": "slo_snapshot"})
    viol = quality_violations(events)
    _check(len(viol) == 1, "breach-without-alert is a contract violation", failures)
    events.append({"kind": "alert_fired", "slo_kind": "shadow_disagreement"})
    _check(not quality_violations(events), "alerted breach is clean", failures)

    if failures:
        print(f"quality selfcheck: {len(failures)} failure(s)")
        return False
    print("quality selfcheck: all checks passed")
    return True
