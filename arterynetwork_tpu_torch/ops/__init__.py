"""Voxel operators: vesselness, the Frangi-response kernel, native C++."""
