"""Voxel operators: vesselness, the Frangi-response kernel, the EDT,
connected components, thinning, native C++, and variational region
growing with its kernels (histograms, full-grid sweep, frontier tiles)."""

from .cc import connected_components, drop_small_components, label_volume
from .edt import edt, edt_squared
from .region_grow import (RegionGrowResult, reconstruct_value_map,
                          region_grow, region_grow_value_map)
from .region_grow_frontier import region_grow_frontier
from .thinning import simple_point_mask, skeletonize
from .vesselness import (frangi_vesselness, frangi_vesselness_chunked,
                         frangi_vesselness_streamed)
from .vesselness_fused import frangi_response_fused

__all__ = ["RegionGrowResult", "connected_components",
           "drop_small_components", "edt", "edt_squared",
           "frangi_response_fused", "frangi_vesselness", "frangi_vesselness_chunked",
           "frangi_vesselness_streamed", "label_volume",
           "reconstruct_value_map", "region_grow", "region_grow_frontier",
           "region_grow_value_map", "simple_point_mask", "skeletonize"]
