"""Voxel operators: vesselness, the Frangi-response kernel, native C++,
and variational region growing with its kernels (histograms, full-grid
sweep, frontier tiles)."""

from .region_grow import (RegionGrowResult, reconstruct_value_map,
                          region_grow, region_grow_value_map)
from .region_grow_frontier import region_grow_frontier

__all__ = ["RegionGrowResult", "reconstruct_value_map", "region_grow",
           "region_grow_frontier", "region_grow_value_map"]
