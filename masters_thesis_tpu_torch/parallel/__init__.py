"""Data-parallel training over ``torch.distributed``: the process group and
shards (``mesh``) and the rank launcher (``launch``)."""

from masters_thesis_tpu_torch.parallel.mesh import (  # noqa: F401
    COLLECTIVES,
    DataMesh,
    balanced_shard_sizes,
    data_mesh,
    distributed_initialize,
    distributed_run_context,
    fleet_barrier,
    join_fleet,
    resolve_world,
    shard_bounds,
)
