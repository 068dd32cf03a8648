"""Artifact store (graphml, segment lists, pickles), NIfTI volume I/O and
overlapping-scan stitching."""

from .artifacts import (ArtifactStore, combine_skeleton_segments,
                        read_tabb_segment_file)
from .nifti import load_volume, mask_volume, refine_brain_mask, save_volume
from .stitch import get_boundary, merge_volume, stitch_scans

__all__ = ["ArtifactStore", "read_tabb_segment_file",
           "combine_skeleton_segments", "load_volume", "save_volume",
           "mask_volume", "refine_brain_mask",
           "get_boundary", "merge_volume", "stitch_scans"]
