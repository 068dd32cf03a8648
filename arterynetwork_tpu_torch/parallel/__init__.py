"""The parallel path: a single-process spatial mesh with explicit halo
exchange (halo.py), the voxel stages on sharded volumes (sharded.py),
the dp axis across processes on torch.distributed (distributed.py) and
the sharded mini pipeline (pipeline_sharded.py)."""

from .distributed import (global_volume_mesh, initialize_distributed,
                          solve_batch_dp)
from .halo import (ShardedVolume, VolumeMesh, halo_exchange,
                   make_volume_mesh, shard_volume, sharded_dilate26)

__all__ = ["global_volume_mesh", "initialize_distributed",
           "solve_batch_dp", "ShardedVolume", "VolumeMesh",
           "halo_exchange", "make_volume_mesh", "shard_volume",
           "sharded_dilate26"]
