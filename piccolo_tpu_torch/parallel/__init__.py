"""One query sharded over a ('cand', 'point') mesh of devices (port of
piccolo_tpu.parallel; the multi-host ``init_distributed`` is not ported)."""

from .fused import (
    ShardedGridPlan,
    ShardedHistPlan,
    localize_query_sharded,
    shard_cloud,
    shard_grid_plan,
    shard_hist_plan,
)
from .sharding import Mesh, ShardedCloud, make_mesh, solve_sharded

__all__ = [
    "Mesh",
    "make_mesh",
    "solve_sharded",
    "localize_query_sharded",
    "shard_cloud",
    "shard_grid_plan",
    "shard_hist_plan",
    "ShardedCloud",
    "ShardedGridPlan",
    "ShardedHistPlan",
]
