"""Row sharding of the SWIM simulation over a ring of shards: see
``ringpop_tpu_torch.parallel.mesh``."""

from ringpop_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    shard_cluster,
    shard_delta,
    sharded_delta_run,
    sharded_delta_step,
    sharded_run,
    sharded_serve,
    sharded_step,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "shard_cluster",
    "shard_delta",
    "sharded_delta_run",
    "sharded_delta_step",
    "sharded_run",
    "sharded_serve",
    "sharded_step",
]
