"""Multi-tenant stacked serving: R checkpoints, one program per bucket.

Counterpart of ``masters_thesis_tpu/serve/stacked.py``. A
``StackedPredictEngine`` holds R lanes (ensemble members, grid winners,
tenants' models) of one architecture and answers every request on all of
them at once: ``predict`` maps ``x (n, K, T, F)`` to batch-major
``(alpha (n, R, K), beta (n, R, K))``, so ``alpha[i]`` is request i's
``(R, K)`` fan-out, as the server's dispatch loop indexes a solo engine's
answers. A bucket is one program, as in the solo engine: on the card one
CUDA graph a bucket, captured by ``warmup`` and replayed, in which each
layer group's recurrence is one replica-axis launch of its maskless
forward (the pair's, the single layer's or the stack's) over all R lanes
(``StackedLstmEncoder``).

The lane contract is the JAX engine's: lane r's answers are **bit for
bit** the solo ``PredictEngine``'s on the same checkpoint. Each lane's
input projection and heads are its own products, the solo engine's (a
batched product over the lanes could take another cuBLAS algorithm and
part the bits), and the replica-axis kernel gives each lane the solo
kernel's bits.

Per-lane hot-swap (``serve/swap.py``, ``try_swap_lane``):
``stage_lane`` places a candidate on the device after checking its
signature (``LaneMismatchError``), ``predict(x, params=staged)`` runs it
through the SAME bucket programs as live traffic and puts the serving
weights back before the lock is released, and ``set_lane`` commits it by
``copy_`` into the lane's captured tensors under the engine lock: no
capture, and every sibling lane's tensors are untouched. ``lane_digest``
is a lane's content hash; ``ensemble_stats`` folds the lane axis into f64
mean, spread and envelope.

The program cache (``program_cache=``, ``close``) is the solo engine's
(``engine.py`` ``BucketPrograms``), with the ordered lane digests in the
key: when one lane's content changes the stack's entries get new keys,
while a solo engine's entries for an unchanged lane still hit (the JAX
rule). ``cost_profiles`` is the solo engine's cost times R.
"""

from __future__ import annotations

import hashlib
from pathlib import Path
from typing import Mapping, Sequence

import numpy as np
import torch

from masters_thesis_tpu_torch import resolve_device
from masters_thesis_tpu_torch.models.lstm import StackedLstmEncoder
from masters_thesis_tpu_torch.models.objectives import ModelSpec
from masters_thesis_tpu_torch.serve.engine import (
    DEFAULT_BUCKETS,
    BucketPrograms,
    bucket_cost_profiles,
    state_signature,
)
from masters_thesis_tpu_torch.train.checkpoint import (
    CorruptCheckpointError,
    restore_checkpoint,
)
from masters_thesis_tpu_torch.train.manifest import verify_checkpoint
from masters_thesis_tpu_torch.train.steps import forward_rows_stacked
from masters_thesis_tpu_torch.utils.cuda_graph import GraphedCall


def lane_digest(state_dict: Mapping[str, torch.Tensor]) -> str:
    """Content hash of one lane's weights: key, dtype and bytes of each
    tensor in key order (16 hex digits)."""
    h = hashlib.sha256()
    for key in sorted(state_dict):
        arr = np.ascontiguousarray(
            torch.as_tensor(state_dict[key]).detach().cpu().numpy())
        h.update(key.encode())
        h.update(str(arr.dtype).encode())
        h.update(arr.tobytes())
    return h.hexdigest()[:16]


def ensemble_stats(alpha: np.ndarray, beta: np.ndarray) -> dict:
    """Ensemble mean and bands over per-lane answers ``(n, R, K)``: f64
    ``{alpha,beta}_mean``, ``_std`` (population std over the lanes),
    ``_lo`` and ``_hi`` (the lane envelope), each ``(n, K)``. f64 so that
    the host statistics add no f32 rounding of their own."""
    out: dict[str, np.ndarray] = {}
    for name, v in (("alpha", alpha), ("beta", beta)):
        a = np.asarray(v, np.float64)  # mtt: disable=TL104 -- host-only ensemble statistics; never in a graph
        if a.ndim != 3:
            raise ValueError(
                f"{name} must be (n, R, K) per-lane outputs, got {a.shape}")
        out[f"{name}_mean"] = a.mean(axis=1)
        out[f"{name}_std"] = a.std(axis=1)
        out[f"{name}_lo"] = a.min(axis=1)
        out[f"{name}_hi"] = a.max(axis=1)
    return out


class LaneMismatchError(ValueError):
    """Lane weights that do not match the stack's shared architecture."""


class StackedPredictEngine(BucketPrograms):
    """Bucketed predict programs over R stacked model lanes on one device.

    The solo engine's API contract (``window_shape``, ``max_bucket``,
    ``platform``, ``buckets``, ``compile_events``, ``cache_hits``,
    ``warmup``, ``close``, ``bucket_for``, ``predict``, ``golden_batch``,
    ``cost_profiles``), plus the lanes' (``num_lanes``, ``lanes``,
    ``predict_lane``, ``predict_ensemble``, ``lane_params``,
    ``lane_digests``, ``stage_lane``, ``set_lane``).
    """

    #: The JAX stacked engine's golden seeds (never a solo entry's).
    GOLDEN_SEED = (2003, 11)

    def __init__(
        self,
        spec: ModelSpec,
        state_dicts: Sequence[Mapping[str, torch.Tensor]],
        *,
        n_stocks: int,
        lookback: int,
        n_features: int = 3,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        device=None,
        cuda_graphs: bool = True,
        lanes: Sequence[str] | None = None,
        program_cache=None,
    ):
        if not state_dicts:
            raise ValueError("need at least one lane (R >= 1)")
        self.spec = spec
        self.n_stocks = n_stocks
        self.lookback = lookback
        self.n_features = n_features
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"invalid buckets: {buckets!r}")
        self.device = resolve_device(device)
        self.num_lanes = len(state_dicts)
        #: Lane names (tenants, checkpoint tags): descriptive only.
        self.lanes = (tuple(str(x) for x in lanes) if lanes is not None
                      else tuple(f"lane{i}" for i in range(self.num_lanes)))
        if len(self.lanes) != self.num_lanes:
            raise ValueError(f"{len(self.lanes)} lane names for "
                             f"{self.num_lanes} lanes")
        self._init_stream()
        encoders = []
        with self._on_stream():
            for i, state in enumerate(state_dicts):
                enc = spec.build_module(device=self.device)
                if i == 0:
                    self._signature = state_signature(enc.state_dict())
                self._check_signature(state, f"lane {i} ({self.lanes[i]})")
                enc.load_state_dict(state)
                encoders.append(enc)
        self._sync()
        self._module = StackedLstmEncoder(encoders)
        self._module.eval()
        self.graphed = cuda_graphs and self.device.type == "cuda"
        self._lane_digests = [lane_digest(s) for s in state_dicts]
        self._init_programs(program_cache)
        self._bind_live()
        #: One analytic cost a bucket: the solo engine's, R times.
        self.cost_profiles = bucket_cost_profiles(
            spec, self.buckets, n_stocks, lookback, self.platform,
            lanes=self.num_lanes)

    def _bind_live(self) -> None:
        #: Each lane's tensors the programs read (and the graphs were
        #: captured on), by state-dict key.
        self._live = [enc.state_dict(keep_vars=True)
                      for enc in self._module.replicas]

    def _identity_extra(self) -> dict:
        return {"lanes": list(self._lane_digests)}

    def _new_program(self, bucket: int) -> "_StackedBucketProgram":
        return _StackedBucketProgram(self._module,
                                     (bucket, *self.window_shape),
                                     self.device, self.graphed)

    @classmethod
    def from_checkpoints(cls, ckpt_dirs: Sequence, tag: str = "best", *,
                         n_stocks: int, n_features: int = 3,
                         buckets: Sequence[int] = DEFAULT_BUCKETS,
                         device=None, cuda_graphs: bool = True,
                         lanes: Sequence[str] | None = None,
                         program_cache=None) -> "StackedPredictEngine":
        """A stack of R published checkpoints, each verified STRICTLY
        against its own manifest first (one unprovable lane keeps the whole
        stack from booting: ``CorruptCheckpointError``); their specs and
        lookbacks must agree (``LaneMismatchError``)."""
        if not ckpt_dirs:
            raise ValueError("need at least one checkpoint directory")
        states, spec0, lookback0 = [], None, None
        for i, d in enumerate(ckpt_dirs):
            path = Path(d) / tag
            if not verify_checkpoint(path, require_manifest=True):
                raise CorruptCheckpointError(
                    f"refusing to serve lane {i} from {path}: strict "
                    "manifest verification failed")
            state, _, spec, meta = restore_checkpoint(d, tag)
            lookback = meta.get("datamodule", {}).get("lookback_window")
            if lookback is None:
                raise ValueError(f"checkpoint sidecar for {path} has no "
                                 "datamodule.lookback_window; cannot size "
                                 "predict programs")
            if spec0 is None:
                spec0, lookback0 = spec, int(lookback)
            elif spec != spec0 or int(lookback) != lookback0:
                raise LaneMismatchError(
                    f"lane {i} ({path}) spec or lookback differs from lane "
                    "0's: a stack serves one architecture")
            states.append(state)
        return cls(spec0, states, n_stocks=n_stocks, lookback=lookback0,
                   n_features=n_features, buckets=buckets, device=device,
                   cuda_graphs=cuda_graphs, lanes=lanes,
                   program_cache=program_cache)

    def _check_signature(self, state, what: str) -> None:
        if state_signature(state) != self._signature:
            raise LaneMismatchError(
                f"{what} does not match the stack's shared architecture (a "
                "lane cannot change shapes: the bucket programs are "
                "shape-specialised)")

    def predict(self, x: np.ndarray, params: tuple | None = None
                ) -> tuple[np.ndarray, np.ndarray]:
        """One micro-batch on every lane, padded to its bucket; batch-major
        ``(alpha (n, R, K), beta (n, R, K))``. ``params`` (from
        ``stage_lane``) runs a staged lane for this call only, through the
        same bucket program, the serving weights copied back before the
        lock is released (the canary path)."""
        x = np.asarray(x, np.float32)
        if x.ndim != 4 or x.shape[1:] != self.window_shape:
            raise ValueError(
                f"request shape {x.shape} != (n, {self.n_stocks}, "
                f"{self.lookback}, {self.n_features})")
        n = x.shape[0]
        b = self.bucket_for(n)
        if n < b:
            pad = np.broadcast_to(x[:1], (b - n,) + x.shape[1:])
            x = np.concatenate([x, pad], axis=0)
        with self._lock, self._on_stream(), torch.inference_mode():
            self._check_open()
            program = self._program(b)
            program.load(x)
            saved = None
            if params is not None:
                lane, candidate = params
                saved = (lane, {k: v.clone() for k, v in self._live[lane].items()})
                self._copy_in(lane, candidate)
            try:
                program.run()
            finally:
                if saved is not None:
                    self._copy_in(*saved)
            alpha, beta = program.read()
        return alpha[:n], beta[:n]

    def predict_lane(self, x: np.ndarray, lane: int, params: tuple | None = None
                     ) -> tuple[np.ndarray, np.ndarray]:
        """Lane ``lane``'s slice of ``predict``: ``(alpha (n, K), beta (n,
        K))``, the solo engine's view of that lane."""
        self._check_lane(lane)
        alpha, beta = self.predict(x, params=params)
        return alpha[:, lane, :], beta[:, lane, :]

    def predict_ensemble(self, x: np.ndarray) -> dict:
        """Per-lane answers and their ensemble statistics, one dispatch."""
        alpha, beta = self.predict(x)
        out = ensemble_stats(alpha, beta)
        out["alpha"] = alpha
        out["beta"] = beta
        return out

    # -------------------------------------------------------------- lanes

    def _check_lane(self, lane: int) -> None:
        if not 0 <= int(lane) < self.num_lanes:
            raise IndexError(f"lane {lane} out of range (the stack has "
                             f"{self.num_lanes})")

    def lane_params(self, lane: int) -> dict[str, torch.Tensor]:
        """The weights serving on lane ``lane`` (CPU copies)."""
        self._check_lane(lane)
        with self._lock, self._on_stream():
            return {k: v.detach().cpu().clone()
                    for k, v in self._live[int(lane)].items()}

    def lane_digests(self) -> tuple[str, ...]:
        with self._lock:
            return tuple(self._lane_digests)

    def stage_lane(self, lane: int, state_dict: Mapping[str, torch.Tensor]
                   ) -> tuple:
        """A candidate for lane ``lane`` placed on the device (commits
        nothing): ``(lane, tensors)`` for ``predict(x, params=...)`` and
        ``set_lane``. Raises ``LaneMismatchError`` unless its keys, shapes
        and dtypes are the lane's."""
        self._check_lane(lane)
        self._check_signature(state_dict, "the candidate lane")
        with self._on_stream():
            return (int(lane), {k: torch.as_tensor(v).detach().to(
                self.device, copy=True) for k, v in state_dict.items()})

    def set_lane(self, lane: int, state_dict: Mapping[str, torch.Tensor],
                 staged: tuple | None = None) -> str:
        """Commit ``state_dict`` on lane ``lane``: a ``copy_`` into the
        lane's captured tensors under the engine lock (no capture; the
        sibling lanes' tensors are not touched). ``staged`` (from
        ``stage_lane``) skips placing it again. Returns the lane's new
        content digest."""
        if staged is None:
            staged = self.stage_lane(lane, state_dict)
        elif staged[0] != int(lane):
            raise ValueError(f"staged for lane {staged[0]}, not lane {lane}")
        digest = lane_digest(state_dict)
        with self._lock, self._on_stream(), torch.inference_mode():
            self._copy_in(*staged)
            self._lane_digests[int(lane)] = digest
        return digest

    def _copy_in(self, lane: int, tensors: Mapping[str, torch.Tensor]) -> None:
        for k, v in self._live[lane].items():
            v.copy_(tensors[k])


class _StackedBucketProgram:
    """The deterministic forward of every lane at one bucket's shape, from
    the static input ``x`` into the static batch-major answers ``alpha``
    and ``beta`` ``(b, R, K)``; eager, or its CUDA graph (thread-local
    capture, so a server's other threads keep running). On the card the
    batch and the answers pass through pinned host buffers."""

    def __init__(self, module, shape: tuple, device, graphed: bool):
        self.module = module
        self.device = device
        lanes = module.num_replicas
        out = (shape[0], lanes, shape[1])
        self.x = torch.zeros(shape, device=device)
        self.alpha = torch.zeros(out, device=device)
        self.beta = torch.zeros(out, device=device)
        if device.type == "cuda":
            self.x_host = torch.zeros(shape, pin_memory=True)
            self.alpha_host = torch.zeros(out, pin_memory=True)
            self.beta_host = torch.zeros(out, pin_memory=True)
        self.run = (GraphedCall(self._forward, device=device,
                                name=f"stacked bucket {shape[0]}",
                                capture_error_mode="thread_local")
                    if graphed else self._forward)

    @property
    def captured(self) -> bool:
        return isinstance(self.run, GraphedCall) and self.run.captured

    def _forward(self) -> None:
        alpha, beta = forward_rows_stacked(self.module, self.x)
        # (R, b, K) lane-major to the batch-major layout the server indexes.
        self.alpha.copy_(alpha[..., 0].transpose(0, 1))
        self.beta.copy_(beta[..., 0].transpose(0, 1))

    def load(self, x: np.ndarray) -> None:
        if self.device.type != "cuda":
            self.x.copy_(torch.from_numpy(np.ascontiguousarray(x)))
            return
        self.x_host.numpy()[...] = x
        self.x.copy_(self.x_host, non_blocking=True)

    def read(self) -> tuple[np.ndarray, np.ndarray]:
        if self.device.type != "cuda":
            return self.alpha.numpy().copy(), self.beta.numpy().copy()
        self.alpha_host.copy_(self.alpha, non_blocking=True)
        self.beta_host.copy_(self.beta, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        done.synchronize()
        return self.alpha_host.numpy().copy(), self.beta_host.numpy().copy()
