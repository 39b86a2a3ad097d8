"""Step functions: the encoder on a window batch, the training step and
epoch, and the evaluation pass.

Counterpart of ``forward_rows``, the scan epoch (``_flat_epoch_body``),
``window_eval_metrics`` and ``make_eval_fn`` in
``masters_thesis_tpu/train/steps.py``. The JAX package compiles an epoch into
one program; the port writes the training step and the evaluation chunk as
programs over static buffers (``TrainProgram``, ``EvalProgram``): a step
reads its windows' indices from a device table through a device cursor that
it advances itself, and adds its metric sums into device accumulators in
place. On the card each program is one CUDA graph, captured once and
replayed (``utils/cuda_graph.py``); on the CPU, or with ``graphed=False``,
the same body runs eagerly. The train split lives on the device, the
epoch's shuffle is drawn there, and the host reads the sums once per epoch.
The stream epoch's step (``StreamProgram``, the counterpart of
``make_train_step(weighted=True)``) reads instead a host batch that the
prefetcher has put on the device, padded to the batch shape with
zero-weight windows (``weighted_batches``). ``StackedTrainProgram`` is
the counterpart of ``make_stacked_train_epoch``: R replicas' steps as one
program over ``[R, n]`` buffers, each replica with its own shuffle and
dropout stream, the recurrence one replica-axis launch.

Data-parallel (``parallel/mesh.py``): each program takes the run's
``DataMesh``. A step's gradient is all-reduced once, in the flat buffer,
between ``backward`` and the optimizer's step (``lax.pmean`` of the flat
gradient in ``_flat_epoch_body``; the ``[R, n]`` buffer in the stacked
step), inside the step's CUDA graph on the card; the clip then acts on the
averaged gradient, as the JAX step clips after its ``pmean``. The metric
sums are all-reduced once an epoch, by the trainer, at the epoch's read.
``begin_epoch``'s ``dropout_seed`` re-seeds the generator after the
shuffle is drawn: under asset sharding the shuffle is common to every rank
and only the dropout stream is the rank's own (``_epoch_rngs``).
"""

from __future__ import annotations

import functools
from typing import Iterable, Iterator

import numpy as np
import torch

from masters_thesis_tpu_torch.data.pipeline import Batch
from masters_thesis_tpu_torch.models.objectives import (
    batched_objective,
    mse_window,
    nll_window,
    predicted_returns,
)
from masters_thesis_tpu_torch.utils.cuda_graph import GraphedCall


def forward_rows(module, x: torch.Tensor, *, deterministic: bool = True,
                 generator: torch.Generator | None = None, masks=None):
    """Apply the encoder to a window batch: ``(B, K, T, F) -> (B, K, 1)``
    alpha and ``(B, K, n_factors)`` beta.

    Flattens (batch, stocks) into rows like the reference's ``flatten(0, 1)``
    and passes ``window_rows=k``, as the JAX function does, so the encoder
    groups its layers as the JAX encoder does at this window shape.
    ``deterministic=False`` is the training forward: dropout masks drawn
    from ``generator`` (or ``masks``).
    """
    b, k = x.shape[:2]
    alpha, beta = module(x.reshape(b * k, *x.shape[2:]),
                         deterministic=deterministic, generator=generator,
                         masks=masks, window_rows=k)
    return alpha.reshape(b, k, 1), beta.reshape(b, k, -1)


def forward_rows_stacked(module, x: torch.Tensor, *,
                         deterministic: bool = True, generators=None,
                         masks=None):
    """``forward_rows`` for a ``StackedLstmEncoder``: ``x (R, B, K, T, F)``
    (replica r's windows in row r) or ``(B, K, T, F)`` (shared) ->
    ``alpha (R, B, K, 1)`` and ``beta (R, B, K, n_factors)``, replica r's
    as ``forward_rows`` of its solo encoder gives them."""
    outs = forward_rows_replicas(module, x, deterministic=deterministic,
                                 generators=generators, masks=masks)
    return (torch.stack([a for a, _ in outs]),
            torch.stack([b for _, b in outs]))


def forward_rows_replicas(module, x: torch.Tensor, *,
                          deterministic: bool = True, generators=None,
                          masks=None) -> list:
    """``forward_rows_stacked`` as one ``(alpha (B, K, 1), beta (B, K,
    n_factors))`` pair a replica, each reshaped from the replica's own head
    outputs as ``forward_rows`` reshapes the solo encoder's, so that the
    losses a stacked step takes from them send each replica the solo
    step's gradients (``StackedLstmEncoder.replica_outputs``)."""
    b, k = x.shape[-4:-2]
    rows = x.reshape(*x.shape[:-4], b * k, *x.shape[-2:])
    outs = module.replica_outputs(rows, deterministic=deterministic,
                                  generators=generators, masks=masks,
                                  window_rows=k)
    return [(a.reshape(b, k, 1), beta.reshape(b, k, -1)) for a, beta in outs]


def _add_into(sums: dict | None, new: dict) -> dict:
    """Add ``new``'s (value, weight) sums into the accumulators ``sums`` in
    place (made as zeros by the first call): adding into zeros keeps every
    value as it was, so the total is the eager chain's ``s + new``."""
    if sums is None:
        sums = {k: (torch.zeros_like(v), torch.zeros_like(w))
                for k, (v, w) in new.items()}
    for k, (v, w) in new.items():
        sums[k][0].add_(v)
        sums[k][1].add_(w)
    return sums


def _copies(sums: dict | None) -> dict | None:
    if sums is None:
        return None
    return {k: (v.clone(), w.clone()) for k, (v, w) in sums.items()}


def _gather(data: Batch, table: torch.Tensor, cursor: torch.Tensor) -> Batch:
    """The windows of row ``cursor`` of ``table``, gathered on the device;
    the cursor moves to the next row."""
    idx = table.index_select(0, cursor).view(-1)
    cursor.add_(1)
    return Batch(*(a.index_select(0, idx) for a in data))


def metric_means(sums: dict) -> dict:
    """Host side: (value_sum, weight) pairs to means. One device read."""
    host = {k: torch.stack([v, w]).double().cpu() for k, (v, w) in sums.items()}  # mtt: disable=TL104 -- host-side means of the sums after the epoch's one read; never in a graph
    return {k: float(vw[0]) / max(float(vw[1]), 1e-30) for k, vw in host.items()}


def train_step(module, optimizer, loss_fn, batch: Batch, lr: float | None,
               generator: torch.Generator | None = None, masks=None,
               weights: torch.Tensor | None = None, mesh=None,
               wsum: torch.Tensor | None = None) -> dict:
    """One update: training forward, loss, backward through the kernels, the
    gradient averaged over ``mesh``'s ranks (one all-reduce of the flat
    buffer), the flat optimizer step (at ``lr``, or at the rate
    ``optimizer.set_lr`` gave when None). Returns the step's metric sums
    (on the device). ``masks`` injects the dropout planes instead of
    drawing them; ``weights`` ``(B,)`` makes the loss and the sums
    weighted, ``wsum`` their divisor (``batched_objective``)."""
    alpha, beta = forward_rows(module, batch.x, deterministic=False,
                               generator=generator, masks=masks)
    loss, sums = loss_fn(alpha, beta, batch.y, batch.factor, batch.inv_psi,
                         weights, wsum)
    optimizer.zero_grad()
    loss.backward()
    if mesh is not None:
        mesh.all_reduce_mean_(optimizer.grads)
    optimizer.step(lr)
    return {k: (v.detach(), w.detach()) for k, (v, w) in sums.items()}


class TrainProgram:
    """The training step over static buffers, for every epoch of a run.

    A step reads row ``cursor`` of ``order`` (the epoch's shuffle, one row
    of ``batch_size`` window indices a step), gathers those windows from
    the device-resident ``data``, runs ``train_step`` with the dropout
    masks drawn from ``generator`` and the rate in ``optimizer.lr``, and
    adds its metric sums into ``sums``. With ``graphed`` (the card) the
    step is one CUDA graph: the first step run is its warm-up and capture,
    every later one a replay that draws the same Philox stream from
    ``generator`` as the eager step would. Nothing may replace the
    module's parameters or the optimizer's buffers afterwards: the graph
    holds their addresses (loading copies in place). With ``mesh`` the
    step all-reduces its gradient over the mesh's ranks, inside the graph.
    """

    def __init__(self, module, optimizer, window_objective, data: Batch,
                 batch_size: int, generator: torch.Generator | None = None,
                 graphed: bool = False, mesh=None):
        self.module = module
        self.optimizer = optimizer
        self.mesh = mesh
        self.data = data
        self.batch_size = batch_size
        self.generator = generator
        self.loss_fn = batched_objective(window_objective)
        device = data.x.device
        self.n_steps = data.x.shape[0] // batch_size
        #: The epoch's window indices, one row a step.
        self.order = torch.zeros((self.n_steps, batch_size),
                                 dtype=torch.int64, device=device)
        #: The row of ``order`` the next step takes.
        self.cursor = torch.zeros(1, dtype=torch.int64, device=device)
        #: The epoch's metric sums, made by the first step.
        self.sums: dict | None = None
        #: The last step's loss sum and its weight (written in place).
        self.step_total = torch.zeros(2, device=device)
        self.step = (GraphedCall(self._step, device=device, name="train step",
                                 generator=generator)
                     if graphed else self._step)

    def _step(self) -> None:
        batch = _gather(self.data, self.order, self.cursor)
        sums = train_step(self.module, self.optimizer, self.loss_fn, batch,
                          None, self.generator, mesh=self.mesh)
        torch.stack(sums["total"], out=self.step_total)
        self.sums = _add_into(self.sums, sums)

    def epoch(self, lr: float, dropout_seed: int | None = None
              ) -> tuple[dict | None, int]:
        """One epoch at ``lr``: ``begin_epoch``, then ``n // batch_size``
        steps (the tail dropped, as in scan mode). Returns the epoch's
        metric sums, still on the device, and the number of steps."""
        self.begin_epoch(lr, dropout_seed)
        for _ in range(self.n_steps):
            self.step()
        return _copies(self.sums), self.n_steps

    def begin_epoch(self, lr: float, dropout_seed: int | None = None) -> None:
        """Set the rate, draw the epoch's shuffle (one ``torch.randperm`` on
        the device from the generator, in its state as the epoch starts)
        into ``order``, re-seed the generator with ``dropout_seed`` when
        given, and reset the cursor and the sums."""
        self.optimizer.set_lr(lr)
        perm = torch.randperm(self.data.x.shape[0], generator=self.generator,
                              device=self.order.device)
        self.order.copy_(perm[: self.n_steps * self.batch_size]
                         .view(-1, self.batch_size))
        if dropout_seed is not None:
            self.generator.manual_seed(dropout_seed)
        self.cursor.zero_()
        _zero(self.sums)
        self.module.train()


def _zero(sums: dict | None) -> None:
    for v, w in (sums or {}).values():
        v.zero_()
        w.zero_()


def weighted_batches(batches: Iterable[Batch], batch_size: int
                     ) -> Iterator[tuple[Batch, np.ndarray]]:
    """``(batch, weights)`` of every host batch, each of ``batch_size``
    windows: a full batch with unit weights; the short tail padded back to
    ``batch_size`` by cycling its own windows (finite data: ``0 * nan`` is
    nan) with zero weight, so every step has one shape."""
    full = np.ones((batch_size,), np.float32)
    for b in batches:
        n = b.x.shape[0]
        if n == batch_size:
            yield b, full
        else:
            idx = np.arange(batch_size) % n
            yield (Batch(*(np.asarray(a)[idx] for a in b)),
                   (np.arange(batch_size) < n).astype(np.float32))


def sharded_weighted_batches(order: np.ndarray, take, batch_size: int,
                             world: int, rank: int
                             ) -> Iterator[tuple[Batch, np.ndarray, np.ndarray]]:
    """Rank ``rank``'s ``(batch, weights, wsum)`` of each global batch of
    ``batch_size * world`` windows of ``order`` (every rank draws the same
    sequence): the global batch padded as ``weighted_batches`` pads it,
    then the rank's ``shard_bounds`` slice, its windows read by
    ``take(idx)``; ``wsum`` (``(1,)``) is the global weight sum over the
    world size, the divisor of the rank's loss."""
    from masters_thesis_tpu_torch.parallel.mesh import shard_bounds

    global_b = batch_size * world
    lo, hi = shard_bounds(global_b, world, rank)
    pos = np.arange(lo, hi)  # mtt: disable=DV703 -- the rank's slice of a global batch of batch_size * world windows is batch_size long on every rank; only its host offsets differ
    for start in range(0, len(order), global_b):
        chunk = order[start:start + global_b]
        n = len(chunk)
        yield (take(chunk[pos % n]), (pos < n).astype(np.float32),
               np.asarray([max(n, 1) / world], np.float32))


class StreamProgram:
    """The weighted training step over static device inputs, for the stream
    epoch: the counterpart of ``make_train_step(weighted=True)``.

    ``inputs`` (``x, y, factor, inv_psi`` of ``batch_size`` windows shaped
    as ``example``'s) and ``weights`` are the step's static buffers: ``step``
    fills them from a prefetched batch already on the device, one copy each
    on the current stream, then runs ``train_step`` on them with the masks
    drawn from ``generator`` and the rate in ``optimizer.lr``, adding its
    metric sums into ``sums``. With ``graphed`` (the card) the step is one
    CUDA graph, captured at the first step of the run and replayed for
    every later one, the padded tail included (its shape is the same). No
    step synchronises with the host. With ``mesh`` the step all-reduces
    its gradient; above one rank a step holds the rank's slice of the
    global batch, and its loss divides by the static ``wsum`` buffer
    (``sharded_weighted_batches``).
    """

    def __init__(self, module, optimizer, window_objective, example: Batch,
                 batch_size: int, generator: torch.Generator | None = None,
                 graphed: bool = False, mesh=None):
        self.module = module
        self.optimizer = optimizer
        self.mesh = mesh
        self.generator = generator
        self.loss_fn = batched_objective(window_objective)
        device = optimizer.params.device
        self.inputs = Batch(*(torch.zeros((batch_size, *a.shape[1:]),
                                          device=device) for a in example))
        self.weights = torch.zeros(batch_size, device=device)
        #: The loss's divisor above one rank (None: the weights' own sum).
        self.wsum = (torch.ones((), device=device)
                     if mesh is not None and mesh.world > 1 else None)
        #: The epoch's metric sums, made by the first step.
        self.sums: dict | None = None
        self.run = (GraphedCall(self._step, device=device, name="stream step",
                                generator=generator)
                    if graphed else self._step)

    def _step(self) -> None:
        sums = train_step(self.module, self.optimizer, self.loss_fn,
                          self.inputs, None, self.generator,
                          weights=self.weights, mesh=self.mesh,
                          wsum=self.wsum)
        self.sums = _add_into(self.sums, sums)

    def step(self, batch: Batch, weights: torch.Tensor,
             wsum: torch.Tensor | None = None) -> None:
        """One step on ``batch``, ``weights`` and (above one rank)
        ``wsum``, tensors on the device."""
        for dst, src in zip(self.inputs, batch):
            dst.copy_(src)
        self.weights.copy_(weights)
        if self.wsum is not None:
            self.wsum.copy_(wsum.reshape(()))
        self.run()

    def epoch(self, lr: float, batches: Iterable[tuple]
              ) -> tuple[dict | None, int]:
        """One epoch at ``lr`` over ``batches`` (``(batch, weights)``, or
        ``(batch, weights, wsum)`` above one rank, on the device, as the
        prefetcher yields them). Returns the epoch's metric sums, still on
        the device, and the number of steps."""
        self.optimizer.set_lr(lr)
        _zero(self.sums)
        self.module.train()
        n_steps = 0
        for item in batches:
            self.step(*item)
            n_steps += 1
        return _copies(self.sums), n_steps


class StackedTrainProgram:
    """The training step of R replicas over static buffers, for every epoch
    of a stacked run: the counterpart of ``make_stacked_train_epoch``.

    Replica r reads row ``cursor`` of ``order[r]`` (its own epoch shuffle,
    drawn from ``generators[r]``), gathers its windows from the shared
    device-resident ``data``, and runs the solo step's forward and loss
    with its dropout masks drawn from ``generators[r]``; one backward takes
    every replica's gradient (each loss enters with weight one, as a solo
    ``backward`` does), the ``StackedFlatAdam`` step updates every active
    row at its rate, and each replica's metric sums go into ``sums`` as
    ``[R]`` vectors. With ``graphed`` (the card) the step is one CUDA
    graph that registers all R generators. With ``mesh`` the ``[R, n]``
    gradient is all-reduced in one collective a step (TA207).
    """

    def __init__(self, module, optimizer, window_objective, data: Batch,
                 batch_size: int, generators, graphed: bool = False,
                 mesh=None):
        self.module = module
        self.optimizer = optimizer
        self.mesh = mesh
        self.data = data
        self.batch_size = batch_size
        self.generators = list(generators)
        self.loss_fn = batched_objective(window_objective)
        device = data.x.device
        self.n_steps = data.x.shape[0] // batch_size
        #: Each replica's epoch shuffle, one row of window indices a step.
        self.order = torch.zeros((module.num_replicas, self.n_steps,
                                  batch_size), dtype=torch.int64,
                                 device=device)
        self.cursor = torch.zeros(1, dtype=torch.int64, device=device)
        #: The epoch's metric sums, ``[R]`` each, made by the first step.
        self.sums: dict | None = None
        self.step = (GraphedCall(self._step, device=device,
                                 name="stacked train step",
                                 generator=self.generators)
                     if graphed else self._step)

    def _step(self) -> None:
        batches = []
        for table in self.order:
            idx = table.index_select(0, self.cursor).view(-1)
            batches.append(Batch(*(a.index_select(0, idx) for a in self.data)))
        self.cursor.add_(1)
        outs = forward_rows_replicas(
            self.module, torch.stack([b.x for b in batches]),
            deterministic=False, generators=self.generators)
        losses, step_sums = [], []
        for (alpha, beta), batch in zip(outs, batches):
            loss, sums = self.loss_fn(alpha, beta, batch.y, batch.factor,
                                      batch.inv_psi)
            losses.append(loss)
            step_sums.append(sums)
        self.optimizer.zero_grad()
        torch.stack(losses).sum().backward()
        if self.mesh is not None:
            self.mesh.all_reduce_mean_(self.optimizer.grad_storage)
        self.optimizer.step()
        self.sums = _add_into(self.sums, {
            k: (torch.stack([s[k][0].detach() for s in step_sums]),
                torch.stack([s[k][1].detach() for s in step_sums]))
            for k in step_sums[0]})

    def epoch(self, lrs) -> tuple[dict | None, int]:
        """One epoch, replica r at ``lrs[r]``: ``begin_epoch``, then
        ``n // batch_size`` steps. Returns the ``[R]`` metric sums, still on
        the device, and the number of steps."""
        self.begin_epoch(lrs)
        for _ in range(self.n_steps):
            self.step()
        return _copies(self.sums), self.n_steps

    def begin_epoch(self, lrs) -> None:
        """Set the rates; draw each replica's shuffle (``torch.randperm``
        from its generator, as the solo program draws it) into its row of
        ``order``; reset the cursor and the sums."""
        self.optimizer.set_lr(lrs)
        n = self.data.x.shape[0]
        for table, generator in zip(self.order, self.generators):
            perm = torch.randperm(n, generator=generator, device=table.device)
            table.copy_(perm[: self.n_steps * self.batch_size]
                        .view(-1, self.batch_size))
        self.cursor.zero_()
        _zero(self.sums)
        self.module.train()


def stacked_metric_means(sums: dict, replicas: int) -> list[dict]:
    """Host side: each replica's means from ``[R]`` (value, weight) sums.
    One device read."""
    host = {k: torch.stack([v, w]).double().cpu() for k, (v, w) in sums.items()}  # mtt: disable=TL104 -- host-side means of the sums after the epoch's one read; never in a graph
    return [{k: float(vw[0, r]) / max(float(vw[1, r]), 1e-30)
             for k, vw in host.items()} for r in range(replicas)]


def train_epoch(module, optimizer, window_objective, data: Batch,
                batch_size: int, lr: float,
                generator: torch.Generator | None = None, *,
                program: TrainProgram | None = None,
                dropout_seed: int | None = None) -> tuple[dict, int]:
    """One epoch over the device-resident train split.

    The counterpart of the scan epoch: ``program.epoch(lr, dropout_seed)``
    of the run's ``TrainProgram`` (built over these arguments), or of an
    eager one made for this epoch. Returns the epoch's metric sums, still
    on the device, and the number of steps.
    """
    if program is None:
        program = TrainProgram(module, optimizer, window_objective, data,
                               batch_size, generator)
    return program.epoch(lr, dropout_seed)


def window_eval_metrics(alpha, beta, y, factor, inv_psi) -> dict:
    """Per-window evaluation metrics: the objective components plus the
    MAE of ``alpha + beta · factors`` against realized returns."""
    r_target = y[..., 0]
    mse_loss, mse_metrics = mse_window(alpha, beta, y, factor, inv_psi)
    nll_loss, _ = nll_window(alpha, beta, y, factor, inv_psi)
    n = mse_metrics["mse"][1]
    mae = torch.mean(torch.abs(predicted_returns(alpha, beta, y) - r_target),
                     dim=(-2, -1))
    return {
        "mse": (mse_loss * n, n),
        "nll": (nll_loss, torch.ones_like(nll_loss)),
        "mae": (mae * n, n),
    }


class EvalProgram:
    """The evaluation pass over a split on the device, ``chunk`` windows a
    forward, deterministic, as programs over static buffers: one for the
    full chunks and one for the short tail (the JAX package pads the tail
    with zero-weight windows; the port runs it at its own length). Each
    reads its rows through a device cursor and adds its sums into ``sums``;
    with ``graphed`` (the card) each is one CUDA graph, captured at its
    first run."""

    def __init__(self, module, window_objective, data: Batch, chunk: int = 32,
                 graphed: bool = False):
        self.module = module
        self.window_objective = window_objective
        self.data = data
        self.sums: dict | None = None
        n = data.x.shape[0]
        device = data.x.device
        rows = torch.arange(n, dtype=torch.int64, device=device)
        n_full = n // chunk
        tables = [(n_full, rows[: n_full * chunk].view(n_full, chunk), "chunk"),
                  (1, rows[n_full * chunk:].view(1, -1), "tail")]
        #: (runs a pass, program, cursor) of the full chunks and the tail.
        self.parts = []
        for runs, table, name in tables:
            if runs == 0 or table.shape[1] == 0:
                continue
            cursor = torch.zeros(1, dtype=torch.int64, device=device)
            body = functools.partial(self._chunk, table, cursor)
            program = (GraphedCall(body, device=device, name=f"eval {name}")
                       if graphed else body)
            self.parts.append((runs, program, cursor))

    def _chunk(self, table: torch.Tensor, cursor: torch.Tensor) -> None:
        batch = _gather(self.data, table, cursor)
        alpha, beta = forward_rows(self.module, batch.x)
        args = (alpha, beta, batch.y, batch.factor, batch.inv_psi)
        metrics = window_eval_metrics(*args)
        loss, _ = self.window_objective(*args)
        metrics["total"] = (loss, torch.ones_like(loss))
        self.sums = _add_into(self.sums, {k: (v.sum(), w.sum())
                                          for k, (v, w) in metrics.items()})

    @torch.no_grad()
    def run(self) -> dict | None:
        """Metric sums (``mse``, ``nll``, ``mae``, ``total``) over the split,
        on the device; ``metric_means`` reads them."""
        self.module.eval()
        _zero(self.sums)
        for runs, program, cursor in self.parts:
            cursor.zero_()
            for _ in range(runs):
                program()
        return _copies(self.sums)


def evaluate(module, window_objective, data: Batch, chunk: int = 32) -> dict:
    """Metric sums (``mse``, ``nll``, ``mae``, ``total``) over a split on the
    device, ``chunk`` windows a forward, deterministic: an eager
    ``EvalProgram``. The sums stay on the device; ``metric_means`` reads
    them."""
    return EvalProgram(module, window_objective, data, chunk).run()
