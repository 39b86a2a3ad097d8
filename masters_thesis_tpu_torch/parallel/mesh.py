"""Process groups and window or asset shards for data-parallel training.

Counterpart of ``masters_thesis_tpu/parallel/mesh.py`` on
``torch.distributed``. The JAX package is single-controller: one process
owns every device of its mesh, and ``shard_map`` hands each device its
shard. The port runs one process a rank, as torch does: a rank owns one
device (``cuda:<local rank>`` on the card, the host with ``gloo`` on the
CPU), holds only its own shard of the train split, and meets the other
ranks in collectives:

- one all-reduce of the flat gradient a step (``all_reduce_mean_``: a SUM
  then ``div_(world)``, which is ``lax.pmean`` exactly; ``ReduceOp.AVG``
  is not used, since gloo has none and both backends must compute the
  same thing);
- one all-reduce of the metric sums an epoch (``all_reduce_sums``, the
  ``psum`` of the JAX epoch and eval programs);
- named barriers around a checkpoint's publish and recovery
  (``fleet_barrier``, behind the ``dist.barrier`` fault point), each
  chained into the collective schedule (``telemetry/schedule.py``).

``shard_map``, ``global_put`` and ``batch_sharding`` have no torch
meaning: a rank slices its own shard (``shard_bounds``, or the JAX
trainer's truncation in ``train/trainer.py``).

The backend is NCCL on the card and gloo on the CPU; nothing switches from
one to the other. ``trainer.distributed=true``, or a coordinator in the
environment (``MTT_COORDINATOR`` with ``JAX_PROCESS_INDEX`` and
``JAX_PROCESS_COUNT``, what the JAX ``join_fleet`` reads), makes the
process one rank of a launch, and then initialisation is required: a
failure raises, and such a rank never trains alone. ``parallel/launch.py``
starts the ranks of ``trainer.n_devices`` itself. At world size 1 under
``tpu_xla`` the process makes a group of one in-process, so the step still
runs its all-reduce and the card's step captures it in its graph (NCCL
answers an in-place SUM at one rank with no work on the card).

``COLLECTIVES`` counts the collectives a rank issued, by kind; a CUDA
graph's replay adds the counts of its capture, as for the kernels'
``LAUNCHES`` (``utils/cuda_graph.py``).
"""

from __future__ import annotations

import dataclasses
import datetime
import os

from masters_thesis_tpu_torch.utils.counts import CallCounts

#: The coordinator a rank of a launch rendezvouses at (a ``file://`` or
#: ``tcp://`` init method); the JAX package's fleet supervisor exports it.
COORDINATOR_ENV = "MTT_COORDINATOR"
#: This process's index and the launch's process count (the names the JAX
#: package's ``join_fleet`` reads).
INDEX_ENV = "JAX_PROCESS_INDEX"
COUNT_ENV = "JAX_PROCESS_COUNT"
#: The card a rank owns on its host (torchrun's name); the process index
#: when unset.
LOCAL_RANK_ENV = "LOCAL_RANK"
#: Seconds a collective or the rendezvous waits before it fails.
DEFAULT_TIMEOUT_S = 300.0

STRATEGIES = ("auto", "single_device", "tpu_xla")
SHARD_AXES = ("window", "asset")
#: The data axis's name, as the JAX mesh calls it (its collective-schedule
#: entries name it).
DATA_AXIS = "data"

#: All-reduces issued since the last ``reset_collective_counts()``:
#: ``all_reduce_grad`` the step's gradient, ``all_reduce_sums`` an epoch's
#: (or an evaluation's) metric sums.
COLLECTIVES = CallCounts(("all_reduce_grad", "all_reduce_sums"))


def reset_collective_counts() -> None:
    COLLECTIVES.reset()


def _dist():
    import torch.distributed as dist

    return dist


def distributed_initialize(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           required: bool = False,
                           device=None) -> bool:
    """Join the process group of ``num_processes`` ranks at
    ``coordinator_address`` as rank ``process_id`` (each read from the
    launch environment when None); True when this process is in a group
    afterwards.

    The backend is NCCL for a CUDA ``device`` (the rank's card becomes the
    current device, and the group's device) and gloo otherwise.
    ``required`` turns a failure into a ``RuntimeError`` naming the
    coordinator; without it a process with no coordinator stays single.
    Idempotent: a process already in a group returns True.
    """
    import torch

    dist = _dist()
    if dist.is_initialized():
        return True
    coordinator_address = (coordinator_address
                           or os.environ.get(COORDINATOR_ENV))
    if num_processes is None:
        num_processes = int(os.environ.get(COUNT_ENV, "1") or 1)
    if process_id is None:
        process_id = int(os.environ.get(INDEX_ENV, "0") or 0)
    if not coordinator_address:
        if required:
            raise RuntimeError(
                "distributed initialization was explicitly requested but no "
                f"coordinator is set ({COORDINATOR_ENV}, {INDEX_ENV}, "
                f"{COUNT_ENV}); launch the ranks with trainer.n_devices or "
                "export the launch's coordinator")
        return False
    from masters_thesis_tpu_torch.parallel.launch import die_with_launcher

    die_with_launcher()
    device = torch.device("cpu" if device is None else device)
    kwargs = {}
    if device.type == "cuda":
        local = local_rank(process_id)
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
        kwargs["device_id"] = device
    try:
        dist.init_process_group(
            backend=backend_for(device),
            init_method=coordinator_address,
            world_size=num_processes,
            rank=process_id,
            timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S),
            **kwargs)
    except Exception as exc:
        raise RuntimeError(
            f"distributed initialization at {coordinator_address!r} (rank "
            f"{process_id} of {num_processes}, {backend_for(device)}) failed: "
            f"{exc}; check the coordinator address and the process count "
            "and index") from exc
    return True


def join_fleet(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               device=None) -> tuple[int, int]:
    """Join this launch's group as a rank, reading the identity the
    launcher exported (``MTT_COORDINATOR``, ``JAX_PROCESS_INDEX``,
    ``JAX_PROCESS_COUNT``), and return ``(process_id, num_processes)``.

    Initialisation is required when a coordinator was exported: a rank
    that fell back to training alone would train on its shard only and
    publish a checkpoint the others never agreed on. Without a
    coordinator it is a no-op (``(0, 1)`` unless told otherwise)."""
    coordinator_address = (coordinator_address
                           or os.environ.get(COORDINATOR_ENV))
    if num_processes is None:
        num_processes = int(os.environ.get(COUNT_ENV, "1") or 1)
    if process_id is None:
        process_id = int(os.environ.get(INDEX_ENV, "0") or 0)
    if coordinator_address:
        distributed_initialize(coordinator_address, num_processes,
                               process_id, required=True, device=device)
    return process_id, num_processes


def backend_for(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    import torch

    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def local_rank(process_id: int | None = None) -> int:
    """The card index of this rank on its host: ``LOCAL_RANK``, else the
    process index."""
    value = os.environ.get(LOCAL_RANK_ENV)
    if value not in (None, ""):
        return int(value)
    if process_id is None:
        process_id = int(os.environ.get(INDEX_ENV, "0") or 0)
    return process_id


def launched_rank() -> bool:
    """True when the environment makes this process a rank of a launch
    (a coordinator is exported)."""
    return bool(os.environ.get(COORDINATOR_ENV))


def shard_bounds(n: int, world: int, rank: int) -> tuple[int, int]:
    """Balanced contiguous ``[lo, hi)`` bounds of ``rank``'s shard of
    ``n`` items across ``world`` processes.

    The remainder goes to the FIRST ``n % world`` ranks, so shard sizes
    differ by at most one and the assignment is a function of ``(n,
    world, rank)`` alone."""
    if world <= 0:
        raise ValueError(f"world must be positive, got {world}")
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside [0, {world})")
    base, extra = divmod(n, world)
    lo = rank * base + min(rank, extra)
    return lo, lo + base + (1 if rank < extra else 0)


def balanced_shard_sizes(n: int, world: int) -> list[int]:
    """Per-rank shard sizes under :func:`shard_bounds`."""
    return [hi - lo for lo, hi in
            (shard_bounds(n, world, r) for r in range(world))]


def fleet_barrier(name: str) -> None:
    """Named sync point of every rank; no wait at world size 1 or outside
    a group. The barrier is first chained into the collective schedule (at
    any world size, as in the JAX package), then the ``dist.barrier`` fault
    point fires, so a plan can wedge one rank inside the barrier, as a dead
    host does, and that rank's heartbeat already names the barrier it is
    stuck in."""
    from masters_thesis_tpu_torch.resilience import faults
    from masters_thesis_tpu_torch.telemetry.schedule import record_collective

    record_collective("barrier", name=name)
    faults.fire("dist.barrier", name=name)
    dist = _dist()
    if not dist.is_initialized() or dist.get_world_size() <= 1:
        return
    dist.barrier()


def distributed_run_context() -> dict:
    """The identity a run stamps into its ``run_started`` event:
    ``process_index`` and ``process_count`` (None outside a launch, as the
    JAX trainer writes them) and the coordinator."""
    from masters_thesis_tpu_torch.telemetry.run import process_identity

    proc, nproc = process_identity()
    return {"process_index": proc, "process_count": nproc,
            "coordinator": os.environ.get(COORDINATOR_ENV)}


def visible_devices(device) -> int:
    """Devices a run may take on ``device``'s type: the visible cards for
    CUDA; for the CPU one (its ranks are processes, as many as asked)."""
    import torch

    if torch.device(device).type == "cuda":
        return torch.cuda.device_count() if torch.cuda.is_available() else 0
    return 1


def resolve_world(strategy: str, n_devices: int | None, device) -> tuple[str, int]:
    """``(strategy, world size)`` of a run on ``device``'s type, as the
    entry point starts it.

    ``auto`` is ``tpu_xla`` when more than one device is asked for or
    visible, else ``single_device``; ``tpu_xla`` with ``n_devices`` None
    takes every visible card (one on the CPU). Asking for more cards than
    are visible raises, naming ``trainer.n_devices``, as ``make_data_mesh``
    refuses it; on the CPU ``n_devices`` is the number of gloo ranks.
    ``single_device`` with ``n_devices`` > 1 raises: the two disagree."""
    import torch

    if strategy not in STRATEGIES:
        raise ValueError(f"trainer.strategy={strategy}: expected one of "
                         f"{STRATEGIES}")
    if n_devices is not None and int(n_devices) < 1:
        raise ValueError(f"trainer.n_devices={n_devices}: must be >= 1")
    visible = visible_devices(device)
    if strategy == "auto":
        strategy = ("tpu_xla" if (n_devices or visible) > 1
                    else "single_device")
    if strategy == "single_device":
        if n_devices is not None and int(n_devices) > 1:
            raise ValueError(f"trainer.n_devices={n_devices}: "
                             "trainer.strategy=single_device runs on one "
                             "device")
        return strategy, 1
    world = int(n_devices) if n_devices is not None else max(1, visible)
    if torch.device(device).type == "cuda" and world > visible:
        raise ValueError(f"trainer.n_devices={world}: requested {world} "
                         f"devices, only {visible} visible")
    return strategy, world


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """The data axis of a run: ``world`` ranks, this one ``rank``, its
    ``device``, and the group's ``backend`` (None for ``single_device``:
    no group, no collective). The counterpart of ``make_data_mesh``'s 1-D
    mesh over its data axis."""

    world: int
    rank: int
    device: object
    backend: str | None
    strategy: str

    @property
    def distributed(self) -> bool:
        return self.backend is not None

    @property
    def is_main(self) -> bool:
        """Rank 0: the one that prints, logs and writes checkpoints."""
        return self.rank == 0

    def all_reduce_mean_(self, flat):
        """``flat`` averaged over the ranks in place: a SUM all-reduce
        then ``div_(world)`` (``lax.pmean``). Nothing without a group."""
        if not self.distributed:
            return flat
        COLLECTIVES.count("all_reduce_grad")
        _dist().all_reduce(flat, op=_dist().ReduceOp.SUM)
        flat.div_(self.world)
        return flat

    def all_reduce_sums(self, sums: dict | None, keys=None) -> dict | None:
        """Metric sums ``{key: (value, weight)}`` summed over the ranks in
        one all-reduce (of their values and weights stacked). A rank
        without sums (an empty shard) joins with zeros for ``keys``.
        Without a group the sums come back as they are."""
        if not self.distributed:
            return sums
        import torch

        if sums is None:
            zero = torch.zeros((), device=self.device)
            sums = {k: (zero, zero) for k in keys}
        names = sorted(sums)
        flat = torch.stack([t for k in names for t in sums[k]])
        COLLECTIVES.count("all_reduce_sums")
        _dist().all_reduce(flat, op=_dist().ReduceOp.SUM)
        return {k: (flat[2 * i], flat[2 * i + 1]) for i, k in enumerate(names)}

    def agree(self, flags) -> list[bool]:
        """Host flags made common to every rank: each is true only where
        it is true on every rank (a MIN all-reduce), so every rank takes
        the same branch."""
        flags = [bool(f) for f in flags]
        if not self.distributed or self.world == 1:
            return flags
        import torch

        t = torch.tensor([int(f) for f in flags], dtype=torch.int32,
                         device=self.device)
        _dist().all_reduce(t, op=_dist().ReduceOp.MIN)
        return [bool(v) for v in t.tolist()]

    def shutdown(self) -> None:
        """Leave the process group (when there is one)."""
        dist = _dist()
        if self.distributed and dist.is_initialized():
            dist.destroy_process_group()


def data_mesh(strategy: str = "auto", n_devices: int | None = None,
              device=None) -> DataMesh:
    """The run's ``DataMesh``.

    A process that is a rank of a launch (a group is initialised, or the
    launch environment exports a coordinator, which it then joins) takes
    the group: ``n_devices`` None means the whole group, another count
    than the group's raises, and so does ``single_device`` (a rank never
    trains alone). Otherwise ``auto`` without ``n_devices`` is
    ``single_device``: only the entry point, which starts the ranks, takes
    every visible card for it. Then ``resolve_world`` decides:
    ``single_device`` has no group; ``tpu_xla`` at world size 1 makes a
    group of one in-process (or takes the one an earlier run made); a
    larger world raises, since ``parallel/launch.py`` starts the ranks. On
    the card a rank takes ``cuda:<local rank>``, which must be visible."""
    import torch

    from masters_thesis_tpu_torch import resolve_device

    device = resolve_device(device)
    dist = _dist()
    if not dist.is_initialized() and launched_rank():
        join_fleet(device=device)
    if dist.is_initialized() and (launched_rank()
                                  or dist.get_world_size() > 1):
        world = dist.get_world_size()
        if strategy == "single_device":
            raise RuntimeError(
                "trainer.strategy=single_device: this process is a rank of a "
                f"group of {world}, which never trains alone")
        if n_devices is not None and int(n_devices) != world:
            raise RuntimeError(
                f"trainer.n_devices={n_devices}: this process is a rank of a "
                f"group of {world}")
        strategy = "tpu_xla"
    else:
        if strategy == "auto" and n_devices is None:
            strategy = "single_device"
        strategy, world = resolve_world(strategy, n_devices, device)
        if strategy == "single_device":
            return DataMesh(1, 0, device, None, strategy)
        if world != 1:
            raise RuntimeError(
                f"trainer.n_devices={world}: this process is not a rank of a "
                "launch; run the entry point (python -m "
                "masters_thesis_tpu_torch ...), which starts the ranks "
                "(parallel/launch.py), or export the launch's coordinator "
                f"({COORDINATOR_ENV})")
        if not dist.is_initialized():
            _init_world_of_one(device)
    backend = dist.get_backend()
    if backend != backend_for(device):
        raise RuntimeError(f"the process group runs {backend}, but a run on "
                           f"{device.type} needs {backend_for(device)}")
    rank = dist.get_rank()
    if device.type == "cuda":
        local = local_rank(rank)
        visible = visible_devices(device)
        if local >= visible:
            raise ValueError(f"trainer.n_devices={world}: rank {rank} needs "
                             f"cuda:{local}, only {visible} visible")
        device = torch.device("cuda", local)
    return DataMesh(world, rank, device, backend, strategy)


def _init_world_of_one(device) -> None:
    """A process group of this process alone (an in-process store)."""
    import torch

    dist = _dist()
    kwargs = {}
    if device.type == "cuda":
        device = torch.device("cuda", local_rank(0))
        torch.cuda.set_device(device)
        kwargs["device_id"] = device
    try:
        dist.init_process_group(
            backend=backend_for(device), store=dist.HashStore(),
            world_size=1, rank=0,
            timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S), **kwargs)
    except Exception as exc:
        raise RuntimeError(f"initialising a {backend_for(device)} process "
                           f"group of one failed: {exc}") from exc
