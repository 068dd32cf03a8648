"""Artifact store (graphml, segment lists, pickles) and NIfTI volume I/O."""

from .artifacts import (ArtifactStore, combine_skeleton_segments,
                        read_tabb_segment_file)
from .nifti import load_volume, mask_volume, refine_brain_mask, save_volume

__all__ = ["ArtifactStore", "read_tabb_segment_file",
           "combine_skeleton_segments", "load_volume", "save_volume",
           "mask_volume", "refine_brain_mask"]
