"""Port of arterynetwork_tpu/ops/stencil.py: 3D stencil primitives.

All neighbourhood ops use the 26-connected (3x3x3) structuring element,
the reference's ``get_neighbours`` neighbourhood
(variationalRegionGrowing.py:263-282).  The cube is separable into three
1-D passes of padded slices; out-of-volume neighbours contribute the
identity (False/0), matching the reference's bounds clipping.  Works on
tensors of any rank (the frontier grower dilates its 2-D tile grid).
"""

from __future__ import annotations

import torch


def _axis_fold3(x, axis, op):
    """``op`` over the 3-window along ``axis`` (zero/False padding)."""
    n = x.shape[axis]
    out = x.clone()
    if n > 1:
        lo, hi = x.narrow(axis, 0, n - 1), x.narrow(axis, 1, n - 1)
        op(out.narrow(axis, 1, n - 1), lo)
        op(out.narrow(axis, 0, n - 1), hi)
    return out


def dilate26(mask):
    """Binary dilation of a bool ``mask`` by the 3x3x3 cube (includes the
    centre)."""
    out = mask.to(torch.bool)
    for axis in range(mask.dim()):
        out = _axis_fold3(out, axis, torch.Tensor.logical_or_)
    return out


def has_neighbor26(mask):
    """True where a voxel has at least one 26-neighbour in ``mask``
    (excluding the voxel itself)."""
    return neighbor_count26(mask) > 0


def neighbor_count26(mask):
    """Number of 26-neighbours of each voxel that are in ``mask``
    (excluding the voxel itself), int32."""
    x = mask.to(torch.int32)
    s = x
    for axis in range(mask.dim()):
        s = _axis_fold3(s, axis, torch.Tensor.add_)
    return s - x


def neighbor_count6(mask):
    """Number of 6-neighbours (faces) of each voxel in ``mask``, int32."""
    x = mask.to(torch.int32)
    total = torch.zeros_like(x)
    for axis in range(mask.dim()):
        total += _axis_fold3(x, axis, torch.Tensor.add_) - x
    return total
