# Copy of arterynetwork_tpu/morpho/metrics.py; the graphs are graphs/voxel_graph's classes.
"""Morphology metrics (reference C10: ``calculateProperty``,
graphRelated.py:35-431).

Per segment: length/radius/tortuosity attributes, type
(bifurcating|terminating), aspect ratio.  Per degree-3 node: parent/child
ordering (by depthVoxel when available, else by max tangent cosine),
local & remote bifurcation amplitude and tilt, Murray's cubic law and the
square law, radius and length ratios, branch-plane normal vector; per
segment whose both ends are degree-3: local bifurcation torque (angle
between end normal vectors, folded to <= 90 deg).

Returns plain dicts (``node_info``, ``segment_info``) keyed like the
reference's nodeInfoDict/segmentInfoDict so downstream consumers and
tests can compare 1:1.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
from numpy.linalg import norm

from ..graphs import voxel_graph as vg
from .spline import spline_interpolation


def _clamp_cos(c):
    return float(np.clip(c, -1.0, 1.0))


def _angle_deg(cosine):
    return float(np.arccos(_clamp_cos(cosine)) / np.pi * 180.0)


def calculate_property(G: vg.Graph, segment_list: Sequence[Sequence],
                       spacing: float = 0.00025,
                       skip_uncategorized: bool = False,
                       min_nodes: int = 50):
    """Compute morphology dictionaries for an attributed voxel graph.

    Mirrors graphRelated.py:35-400 (including the ordering rules and the
    spline end-weights of 20).  ``min_nodes`` aborts tiny components like
    the reference (graphRelated.py:93-95).
    """
    segment_info: Dict[int, dict] = {}
    node_info: Dict[tuple, dict] = {}
    used = vg.Graph()

    for idx, seg in enumerate(segment_list):
        seg = [tuple(v) for v in seg]
        if seg[0] == seg[-1]:
            continue
        e = G[seg[0]][seg[1]]
        info = {k: e[k] for k in
                ("pathLength", "eculideanLength", "tortuosity",
                 "voxelLength", "meanRadius") if k in e}
        for opt in ("partitionName", "segmentLevel", "sigma"):
            if opt in e:
                info[opt] = e[opt]
        if G.degree(seg[0]) == 1 or G.degree(seg[-1]) == 1:
            info["type"] = "terminating"
        elif G.degree(seg[0]) >= 3 or G.degree(seg[-1]) >= 3:
            info["type"] = "bifurcating"
        if info.get("meanRadius"):
            info["aspectRatio"] = info["pathLength"] / info["meanRadius"]
        segment_info[idx] = info
        vg.add_path(used, seg)

    if len(G.nodes()) <= min_nodes:
        return None, None

    for node in used.nodes():
        ninfo = node_info.setdefault(node, {})
        for key in ("depthVoxel", "depthLevel", "pathDistance",
                    "partitionName"):
            if key in G.nodes[node]:
                ninfo[key] = G.nodes[node][key]
        if G.degree(node) == 1:
            ninfo["type"] = "terminating"
        elif G.degree(node) >= 3:
            ninfo["type"] = "bifurcating"
        if "radius" in G.nodes[node]:
            ninfo["radius"] = G.nodes[node]["radius"]

        if G.degree(node) != 3:
            continue

        seg_infos = []
        for idx, seg in enumerate(segment_list):
            seg = [tuple(v) for v in seg]
            if seg[0] == node and len(seg) >= 3:
                seg_infos.append([idx, seg])
            elif seg[-1] == node and len(seg) >= 3:
                seg_infos.append([idx, seg[::-1]])
        if len(seg_infos) != 3:
            continue

        derivs, has_depth = [], []
        ok = True
        for idx, seg in seg_infos:
            coords = np.asarray(seg, dtype=float)
            w = np.ones(len(seg))
            w[[0, -1]] = 20.0
            try:
                _, _, _, der = spline_interpolation(
                    coords, np.linspace(0, 1, len(seg)),
                    return_derivative=True, w=w)
            except Exception:
                ok = False
                break
            derivs.append(der)
            has_depth.append("depthVoxel" in G.nodes[seg[1]])
        if not ok:
            continue

        # order [child1, child2, parent] (graphRelated.py:152-207).
        # depthVoxel rule: rank the three branches' second voxels together
        # with the node itself; the rule applies ONLY when the node ranks
        # second-shallowest (exactly one branch upstream of it) — then
        # parent = the shallower branch, children = the two deeper ones in
        # depth order (order = [sortedIndex[2], sortedIndex[3],
        # sortedIndex[0]], graphRelated.py:157-159).  Any other ranking
        # (node shallowest — a root junction; node deeper than two
        # branches — BFS wave overlap) falls back to the max-cosine
        # pairing of *unnormalized* spline tangents, exactly like the
        # reference (:186-207).
        order = None
        if "depthVoxel" in G.nodes[node] and all(has_depth):
            depth_list = [G.nodes[seg_infos[i][1][1]]["depthVoxel"]
                          for i in range(3)] + [G.nodes[node]["depthVoxel"]]
            sorted_idx = np.argsort(depth_list)
            node_loc = int(np.nonzero(sorted_idx == 3)[0][0])
            if node_loc == 1:
                # positions 2, 3, 0 hold branch indices (the node sits at
                # position 1), so no filtering is needed
                order = [int(sorted_idx[2]), int(sorted_idx[3]),
                         int(sorted_idx[0])]
        if order is None:
            if skip_uncategorized:
                continue
            best = -10.0
            for i in range(3):
                v1 = derivs[i][0]
                v2 = derivs[(i + 1) % 3][0]
                c = float(np.dot(v1, v2))
                if c > best:
                    best = c
                    order = [i, (i + 1) % 3, (i + 2) % 3]

        seg_infos = [seg_infos[i] for i in order]
        derivs = [derivs[i] for i in order]
        # (child1, child2, parent) segment indices — not a reference
        # field, but lets tests and downstream consumers pin the ordering
        ninfo["orderedSegments"] = [seg_infos[0][0], seg_infos[1][0],
                                    seg_infos[2][0]]

        v1l, v2l = derivs[0][0], derivs[1][0]
        n1, n2 = norm(v1l), norm(v2l)
        ninfo["localBifurcationAmplitude"] = _angle_deg(
            np.dot(v1l, v2l) / (n1 * n2))

        v1r = np.asarray(seg_infos[0][1][-1], float) - np.asarray(node, float)
        v2r = np.asarray(seg_infos[1][1][-1], float) - np.asarray(node, float)
        n1r, n2r = norm(v1r), norm(v2r)
        ninfo["remoteBifurcationAmplitude"] = _angle_deg(
            np.dot(v1r, v2r) / (n1r * n2r))

        vec_parent = -derivs[2][0]
        npar = norm(vec_parent)
        half = v1l / n1 + v2l / n2
        nh = norm(half)
        if nh > 1e-4:
            ninfo["localBifurcationTilt"] = _angle_deg(
                np.dot(half, vec_parent) / (nh * npar))
        half_r = v1r / n1r + v2r / n2r
        nhr = norm(half_r)
        if nhr > 1e-4:
            ninfo["remoteBifurcationTilt"] = _angle_deg(
                np.dot(half_r, vec_parent) / (nhr * npar))

        r1 = segment_info[seg_infos[0][0]]["meanRadius"]
        r2 = segment_info[seg_infos[1][0]]["meanRadius"]
        r3 = segment_info[seg_infos[2][0]]["meanRadius"]
        ninfo["cubicLawResult"] = (r1 ** 3 + r2 ** 3) / r3 ** 3
        ninfo["squareLawResult"] = (r1 ** 2 + r2 ** 2) / r3 ** 2
        ninfo["radiusList"] = [r1, r2, r3]
        ninfo["minRadius"] = min(r1, r2, r3)
        ninfo["minRadiusRatio"] = min(r1, r2) / r3
        ninfo["maxRadiusRatio"] = max(r1, r2) / r3
        l1 = segment_info[seg_infos[0][0]]["pathLength"]
        l2 = segment_info[seg_infos[1][0]]["pathLength"]
        l3 = segment_info[seg_infos[2][0]]["pathLength"]
        ninfo["lengthRatio"] = min(l1, l2) / l3

        nv = np.cross(v1l, v2l)
        nvn = norm(nv)
        if nvn > 0:
            ninfo["normalVector"] = nv / nvn

    # local bifurcation torque (graphRelated.py:307-325)
    for idx, seg in enumerate(segment_list):
        seg = [tuple(v) for v in seg]
        h, t = seg[0], seg[-1]
        if (G.degree(h) == 3 and G.degree(t) == 3
                and "normalVector" in node_info.get(h, {})
                and "normalVector" in node_info.get(t, {})):
            a = node_info[h]["normalVector"]
            b = node_info[t]["normalVector"]
            ang = _angle_deg(np.dot(a, b) / (norm(a) * norm(b)))
            if ang > 90.0:
                ang = 180.0 - ang
            segment_info[idx]["localBifurcationTorque"] = ang

    return node_info, segment_info


def summarize(node_info, segment_info, spacing=0.0004):
    """Summary statistics block (graphRelated.py:328-398) as a dict."""
    out = {}

    def stats(vals):
        v = np.asarray(vals, dtype=float)
        if v.size == 0:
            return None
        return dict(mean=float(v.mean()), std=float(v.std()),
                    min=float(v.min()), max=float(v.max()), n=int(v.size))

    for qty in ("meanRadius", "pathLength", "tortuosity",
                "localBifurcationTorque"):
        vals = [s[qty] for s in segment_info.values() if qty in s]
        out[qty] = stats(vals)
    for qty in ("localBifurcationAmplitude", "remoteBifurcationAmplitude",
                "localBifurcationTilt", "remoteBifurcationTilt",
                "cubicLawResult", "squareLawResult"):
        vals = [n[qty] for n in node_info.values() if qty in n]
        out[qty] = stats(vals)

    out["numBranches"] = len(segment_info)
    out["totalLength_mm"] = float(
        sum(s.get("pathLength", 0.0) for s in segment_info.values())
        * spacing * 1000)
    out["numBifurcating"] = sum(
        1 for n in node_info.values() if n.get("type") == "bifurcating")
    out["numTerminating"] = sum(
        1 for n in node_info.values() if n.get("type") == "terminating")
    return out
