# Copy of arterynetwork_tpu/morpho/curvature.py; the graphs are graphs/voxel_graph's classes.
"""Per-branch curvature (reference C11: ``calculateCurvature``,
graphRelated.py:517-619).

Per compartment, for every terminating node: take the shortest root->leaf
path, fit a weighted B-spline through it (weight of a voxel = number of
root->leaf paths passing through it), resample each branch so consecutive
samples are <= 0.5 voxels apart, evaluate the circumscribed-triangle
curvature at every interior sample, and aggregate max/mean per branch
(averaged over all paths crossing the branch).  Output units: 1/mm via the
voxel->mm spacing factor.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from ..graphs import voxel_graph as vg
from .spline import curvature_by_triangle, spline_interpolation
from scipy import interpolate


def calculate_curvature(G: vg.Graph,
                        segment_info: Dict[int, dict],
                        partitions: Dict[str, dict],
                        spacing_factor_mm: float = 0.40):
    """Add maxCurvatureAveragedInmm / meanCurvatureAveragedInmm to
    segment_info.

    partitions: {name: {"initial_voxels": [...], "boundary_voxels": [...],
                        "visited_voxels": [...], "segment_index_list": [...]}}
    (the contents of the reference's chosenVoxels + partitionInfo pickles).
    """
    for name, part in partitions.items():
        roots = [tuple(v) for v in part["initial_voxels"]]
        visited = [tuple(v) for v in part["visited_voxels"]]
        sub = G.subgraph(visited)

        weight: Dict[tuple, int] = {v: 0 for v in visited}
        paths = {}
        terminating = [v for v in visited
                       if G.degree(v) == 1 and v not in roots]
        for leaf in terminating:
            for root in roots:
                if not vg.has_path(sub, root, leaf):
                    continue
                path = vg.shortest_path(sub, root, leaf)
                seg_ids = [sub[path[i]][path[i + 1]]["segmentIndex"]
                           for i in range(len(path) - 1)]
                uniq = list(dict.fromkeys(seg_ids))
                seg_lengths = [segment_info[s]["pathLength"] for s in uniq]
                cumsum = np.insert(np.cumsum(seg_lengths), 0, 0.0)
                paths[leaf] = (path, uniq, cumsum)
                for v in path:
                    weight[v] += 1
                break

        local: Dict[int, dict] = {}
        for leaf, (path, uniq, cumsum) in paths.items():
            coords = np.asarray(path, dtype=float) * spacing_factor_mm
            point_loc = cumsum / cumsum[-1] if cumsum[-1] > 0 else cumsum
            w = np.asarray([weight[v] for v in path], dtype=float)
            try:
                tck, _, _ = spline_interpolation(coords, point_loc, w=w)
            except Exception:
                continue
            for ii, seg_idx in enumerate(uniq):
                u0, u1 = point_loc[ii], point_loc[ii + 1]
                n_needed = int(np.ceil(
                    segment_info[seg_idx]["pathLength"] / 0.5)) + 1
                us = np.linspace(u0, u1, max(n_needed, 3))
                v1, v2, v3 = interpolate.splev(us, tck, der=0)
                pts = np.stack([v1, v2, v3], axis=1)
                curv = [curvature_by_triangle(pts[j:j + 3])
                        for j in range(len(pts) - 2)]
                if not curv:
                    continue
                entry = local.setdefault(
                    seg_idx, {"max": [], "mean": []})
                entry["max"].append(float(np.max(curv)))
                entry["mean"].append(float(np.mean(curv)))

        for seg_idx, entry in local.items():
            segment_info[seg_idx]["maxCurvatureAveragedInmm"] = float(
                np.mean(entry["max"]))
            segment_info[seg_idx]["meanCurvatureAveragedInmm"] = float(
                np.mean(entry["mean"]))

    return segment_info
