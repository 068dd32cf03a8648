# Copy of arterynetwork_tpu/utils/reference_region_grow.py, unchanged.
"""Faithful NumPy re-implementation of the reference region grower.

Reproduces the *algorithm* of ``variationalRegionGrowing``
(variationalRegionGrowing.py:10-282) — incremental boundary lists,
per-boundary-voxel Gaussian sums, xor flip rule with >= ties — for two
purposes only:

1. parity oracle: the TPU full-grid kernel must converge to the same
   fixed-point voxel set on phantoms;
2. baseline timing: bench.py measures this implementation's wall-clock as
   the "reference CPU protocol" number.

It is intentionally *not* optimized (the boundary loop is the reference's
own computational model), but unlike the reference it recomputes
probabilities per iteration instead of patching them incrementally — the
fixed points are identical, transient order may differ (SURVEY.md "hard
parts": parity is defined at convergence).
"""

from __future__ import annotations

import time

import numpy as np

A_NORM = (2.0 * np.pi) ** -0.5


def _neighbors(shape):
    offs = [(dz, dy, dx) for dz in (-1, 0, 1) for dy in (-1, 0, 1)
            for dx in (-1, 0, 1) if (dz, dy, dx) != (0, 0, 0)]
    return offs


def reference_region_grow(data, seed_mask, H=2.25, max_segment_size=5000,
                          iter_max=200, time_cap_s=None):
    """Boundary-list region growing with the reference's update math.

    Returns (segmented_map, iterations, boundary_evals).
    """
    data = np.asarray(data, dtype=np.float64)
    seg = np.asarray(seed_mask, dtype=bool).copy()
    shape = data.shape
    offs = _neighbors(shape)
    t0 = time.perf_counter()
    boundary_evals = 0

    def neighbors_of(idx_array):
        """Stack neighbor coords for an (n,3) coordinate array (clipped)."""
        out = []
        for off in offs:
            q = idx_array + np.asarray(off)
            ok = np.all((q >= 0) & (q < np.asarray(shape)), axis=1)
            out.append((q, ok))
        return out

    it = 0
    while it < iter_max:
        # boundary sets from the current segmentation
        inner = np.argwhere(seg)
        if inner.size == 0:
            break
        # inner boundary: segmented voxels with an unsegmented neighbor;
        # outer boundary: unsegmented voxels with a segmented neighbor
        inner_bnd_mask = np.zeros(shape, bool)
        outer_bnd_mask = np.zeros(shape, bool)
        for q, ok in neighbors_of(inner):
            qq = q[ok]
            not_seg = ~seg[tuple(qq.T)]
            outer_bnd_mask[tuple(qq[not_seg].T)] = True
            inner_bnd_mask[tuple(inner[ok][not_seg].T)] = True

        all_bnd = np.argwhere(inner_bnd_mask | outer_bnd_mask)
        if all_bnd.size == 0:
            break

        inner_vals = data[seg]
        outer_vals = data[~seg]
        n_in, n_out = max(len(inner_vals), 1), max(len(outer_vals), 1)

        flips = []
        for p in all_bnd:
            v = data[tuple(p)]
            ip = np.sum(A_NORM * np.exp(-0.5 * H * (inner_vals - v) ** 2))
            op = np.sum(A_NORM * np.exp(-0.5 * H * (outer_vals - v) ** 2))
            boundary_evals += 1
            if bool(seg[tuple(p)]) != bool(ip / n_in >= op / n_out):
                flips.append(p)

        if not flips:
            break
        if time_cap_s is not None and time.perf_counter() - t0 > time_cap_s:
            break
        if seg.sum() >= max_segment_size:
            break
        for p in flips:
            seg[tuple(p)] = not seg[tuple(p)]
        it += 1

    return seg, it, boundary_evals
