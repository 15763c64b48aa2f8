"""Row sharding of the SWIM simulation over a ring of shards: see
``ringpop_tpu_torch.parallel.mesh`` (one process a shard over a process
group, or every shard in one process) and ``parallel.ranks`` (the
launcher of the ranks)."""

from ringpop_tpu_torch.parallel.mesh import (
    Mesh,
    checksums,
    converged,
    gather_cluster,
    gather_delta,
    init_cluster,
    init_delta,
    make_mesh,
    rebase,
    revive,
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
    "checksums",
    "converged",
    "gather_cluster",
    "gather_delta",
    "init_cluster",
    "init_delta",
    "make_mesh",
    "rebase",
    "revive",
    "shard_cluster",
    "shard_delta",
    "sharded_delta_run",
    "sharded_delta_step",
    "sharded_run",
    "sharded_serve",
    "sharded_step",
]
