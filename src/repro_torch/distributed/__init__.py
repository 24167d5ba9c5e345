"""Distribution layer: the sharding policy's specs for params, batches
and caches on a ``torch.distributed`` mesh (``launch.mesh``), this
rank's slices of them, and the collectives the per-rank model steps
meet at."""

from .sharding import (batch_sharding, cache_sharding, data_axes,
                       param_sharding, ShardingPolicy)

__all__ = ["batch_sharding", "cache_sharding", "data_axes",
           "param_sharding", "ShardingPolicy"]
