# Copy of arterynetwork_tpu/utils/fidelity.py (numpy and scipy only; unchanged).
"""Tree-recovery fidelity metrics against phantom ground truth.

The reference validates segmentation on exact-voxel phantom fixtures
(variationalRegionGrowing.py:284-314) and the solver on ground-truth
round trips (fluidSimulation.py:2533-2709) but never scores the
*extracted graph* against a known tree.  ``vascular_tree_phantom``
(utils/phantoms.py) returns its generating centerlines/radii, so the
pipeline bench can close that loop: branch-level centerline recall and
precision, radius error at matched points, terminal/bifurcation counts,
and the segment-count ratio.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def _endpoint_counts(segments: Sequence[Sequence]) -> Dict[tuple, int]:
    counts: Dict[tuple, int] = {}
    for seg in segments:
        for v in (tuple(seg[0]), tuple(seg[-1])):
            counts[v] = counts.get(v, 0) + 1
    return counts


def phantom_topology(phantom) -> Dict[str, int]:
    """Terminal/bifurcation counts of the generating tree: a branch end
    that spawns children is a bifurcation; one that spawns none is a
    terminal (children start exactly at the parent's last point)."""
    starts: Dict[tuple, int] = {}
    for c in phantom["centerlines"]:
        key = tuple(np.round(c[0]).astype(int))
        starts[key] = starts.get(key, 0) + 1
    ends = [tuple(np.round(c[-1]).astype(int))
            for c in phantom["centerlines"]]
    return {
        "terminals": sum(1 for e in ends if starts.get(e, 0) == 0),
        "bifurcations": sum(1 for e in set(ends) if starts.get(e, 0) >= 2),
    }


def tree_recovery_metrics(segments: Sequence[Sequence], attrs: List[Dict],
                          phantom, tol: float = 2.0) -> Dict[str, float]:
    """Score extracted segments against the phantom's generating tree.

    * ``centerline_recall``    — fraction of ground-truth centerline
      points within ``tol`` voxels of an extracted segment voxel
    * ``centerline_precision`` — fraction of extracted segment voxels
      within ``tol`` voxels of a ground-truth centerline point
    * ``radius_rmse``/``radius_bias`` — branch ``meanRadius`` vs the
      generating radius at matched points
    * ``terminals``/``bifurcations`` vs ``gt_*`` — endpoint-degree
      topology counts
    * ``segment_count_ratio``  — extracted segments / true branches
    """
    from scipy.spatial import cKDTree

    gt_pts = np.concatenate(phantom["centerlines"]).astype(np.float64)
    gt_rad = np.concatenate(
        [np.full(len(c), r) for c, r in zip(phantom["centerlines"],
                                            phantom["radii"])])
    out: Dict[str, float] = {
        "gt_branches": int(phantom["n_branches"]),
        **{f"gt_{k}": v for k, v in phantom_topology(phantom).items()},
        "segments": len(segments),
    }
    if not segments:
        out.update(centerline_recall=0.0, centerline_precision=0.0,
                   radius_rmse=float("nan"), radius_bias=float("nan"),
                   terminals=0, bifurcations=0,
                   segment_count_ratio=0.0)
        return out

    ex_pts = np.concatenate([np.asarray(s, np.float64) for s in segments])
    mean_r = np.asarray([a["meanRadius"] for a in attrs], np.float64)
    ex_rad = np.concatenate([np.full(len(s), mean_r[i])
                             for i, s in enumerate(segments)])

    d_gt, j = cKDTree(ex_pts).query(gt_pts, k=1)
    matched = d_gt <= tol
    out["centerline_recall"] = float(matched.mean())
    if matched.any():
        err = ex_rad[j][matched] - gt_rad[matched]
        out["radius_rmse"] = float(np.sqrt(np.mean(err ** 2)))
        out["radius_bias"] = float(np.mean(err))
    else:
        out["radius_rmse"] = float("nan")
        out["radius_bias"] = float("nan")
    d_ex, _ = cKDTree(gt_pts).query(ex_pts, k=1)
    out["centerline_precision"] = float((d_ex <= tol).mean())

    counts = _endpoint_counts(segments)
    out["terminals"] = sum(1 for c in counts.values() if c == 1)
    out["bifurcations"] = sum(1 for c in counts.values() if c >= 3)
    out["segment_count_ratio"] = len(segments) / max(
        int(phantom["n_branches"]), 1)
    return out
