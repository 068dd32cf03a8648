# Copy of arterynetwork_tpu/io/stitch.py, unchanged.
"""Overlapping-scan stitching utilities.

The reference acquires the vessel volume as two overlapping scans
(``vessel150``/``vessel250``) and pastes one over the other inside a
per-column overlap window found from the first/last nonzero voxel along
an axis (getBoundary / mergeVolume, manualCorrectionGUI.py:31-66).
Same capability here, fully vectorized (the reference builds its index
volume with a Python list comprehension over slices).
"""

from __future__ import annotations

import numpy as np


def get_boundary(volume: np.ndarray, axis: int,
                 flip_axis: bool = False) -> np.ndarray:
    """Index of the first (or, with ``flip_axis``, last) nonzero element
    along ``axis`` for every line of the volume
    (getBoundary, manualCorrectionGUI.py:31-57).

    Matches the reference's argmax semantics: all-zero lines report 0
    (or ``shape[axis]-1`` when flipped).  Dimension of the result is one
    less than the volume's.
    """
    mask = volume != 0
    if flip_axis:
        n = volume.shape[axis]
        return n - np.flip(mask, axis=axis).argmax(axis=axis) - 1
    return mask.argmax(axis=axis)


def merge_volume(src: np.ndarray, dst: np.ndarray, lower_bound,
                 upper_bound, axis: int) -> np.ndarray:
    """Paste ``src`` into ``dst`` wherever the index along ``axis`` lies in
    ``[lower_bound, upper_bound]`` (mergeVolume,
    manualCorrectionGUI.py:59-66).  The bounds may be scalars or per-line
    arrays shaped like the volume with ``axis`` removed (the reference
    passes ``getBoundary`` outputs).  ``dst`` is modified in place; the
    boolean index volume is returned, as in the reference.

    The reference stacks its per-slice comparisons along dimension 0
    regardless of ``axis``, so its index volume only lines up with the
    data for ``axis == 0``; here the window is placed along the requested
    axis, so any axis works (identical to the reference at axis 0).
    """
    if src.shape != dst.shape:
        raise ValueError("src/dst shapes differ: {} vs {}".format(
            src.shape, dst.shape))
    idx = np.arange(src.shape[axis])
    idx = idx.reshape([-1 if a == axis else 1 for a in range(src.ndim)])
    lower = np.asarray(lower_bound)
    upper = np.asarray(upper_bound)
    if lower.ndim:
        lower = np.expand_dims(lower, axis)
    if upper.ndim:
        upper = np.expand_dims(upper, axis)
    index_volume = (idx >= lower) & (idx <= upper)
    # materialize (broadcast_to returns a read-only view, but the
    # reference returns a writable array callers may mutate, e.g. to
    # exclude voxels before a second paste)
    index_volume = np.broadcast_to(index_volume, src.shape).copy()
    dst[index_volume] = src[index_volume]
    return index_volume


def stitch_scans(scan_a: np.ndarray, scan_b: np.ndarray,
                 axis: int = 2) -> np.ndarray:
    """One-call two-scan stitch: paste ``scan_a`` over ``scan_b`` inside
    scan_a's own per-line nonzero extent [first, last nonzero of a] along
    ``axis`` — the composition the reference performs manually with
    getBoundary + mergeVolume.  Lines where scan_a is empty keep scan_b."""
    lower = get_boundary(scan_a, axis)
    upper = get_boundary(scan_a, axis, flip_axis=True)
    has_data = (scan_a != 0).any(axis=axis)
    # Collapse the window to an empty interval on data-free lines (the
    # raw argmax convention would otherwise span the whole line).
    lower = np.where(has_data, lower, 1)
    upper = np.where(has_data, upper, 0)
    merged = scan_b.copy()
    merge_volume(scan_a, merged, lower, upper, axis)
    return merged
