"""Sharded and multi-process profiles (counterpart of slimm_tpu.parallel)."""

from .mesh import device_grid, route_shard  # noqa: F401
from .multihost import MultiHostRunner, initialize, shard_paths  # noqa: F401
from .runner import ShardedRunner  # noqa: F401
