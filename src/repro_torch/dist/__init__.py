"""Port of ``repro/dist``: logical-axes sharding rules over a mesh, and
the work partitioning of the reference's sharded reuse engines."""
from repro_torch.dist.sharding import (
    NamedSharding,
    ShardingRules,
    param_shardings,
    pspec_for,
    shard,
    use_sharding,
)

__all__ = [
    "NamedSharding",
    "ShardingRules",
    "param_shardings",
    "pspec_for",
    "shard",
    "use_sharding",
]
