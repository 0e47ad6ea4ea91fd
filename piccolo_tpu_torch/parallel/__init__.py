"""One query sharded over a ('cand', 'point') mesh of devices, and a
multi-host process group for sweeps (port of piccolo_tpu.parallel)."""

from .fused import (
    ShardedGridPlan,
    ShardedHistPlan,
    localize_query_sharded,
    shard_cloud,
    shard_grid_plan,
    shard_hist_plan,
)
from .sharding import (
    Mesh,
    ShardedCloud,
    init_distributed,
    make_mesh,
    solve_sharded,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "solve_sharded",
    "localize_query_sharded",
    "init_distributed",
    "shard_cloud",
    "shard_grid_plan",
    "shard_hist_plan",
    "ShardedCloud",
    "ShardedGridPlan",
    "ShardedHistPlan",
]
