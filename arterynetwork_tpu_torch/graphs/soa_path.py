# Copy of arterynetwork_tpu/graphs/soa_path.py, unchanged.
"""SoA fast path: segments + branch attrs -> FlowNetwork directly.

The compatibility path materializes a voxel-level networkx graph between
skeletonization and the flow solve (graph_stage -> partition_bfs ->
reduce_graph -> reduced_to_flow_network) purely to carry depth
annotations — ~1 s of dict churn at a realistic 2e4-voxel skeleton.
This module computes the same reduced network from arrays:

* nodes = segment endpoints (junctions/tips), int-indexed;
* ``depthLevel`` per endpoint from a Dijkstra over the segment graph
  with voxel-count weights — the same metric as the reference's
  voxel-wave BFS (``randomWalkBFS``: a node is first reached along the
  voxel-hop-shortest path, and depthLevel increments once per junction
  crossed, myFunctions.py:36-98);
* edges oriented from lower to higher depthLevel, carrying
  meanRadius/pathLength from ``compute_branch_attrs``.

The networkx path remains for artifact export (graphml), the editing
engine and morphology; both paths produce the same network on tree-like
skeletons (orientation on equal-depth loop edges is tie-dependent in
both).
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .network import FlowNetwork, orient_edges_by_depth


def segments_to_flow_network(segments: Sequence[Sequence],
                             attrs: Sequence[dict],
                             root_voxel,
                             spacing: float):
    """Build a FlowNetwork for the connected component containing
    ``root_voxel`` (an endpoint voxel tuple).  Returns
    (net, node_of_coord)."""
    root = tuple(int(v) for v in root_voxel)

    # endpoint ids
    ends: Dict[Tuple, int] = {}
    seg_ends: List[Tuple[int, int]] = []
    for seg in segments:
        h = tuple(int(x) for x in seg[0])
        t = tuple(int(x) for x in seg[-1])
        for v in (h, t):
            if v not in ends:
                ends[v] = len(ends)
        seg_ends.append((ends[h], ends[t]))
    if root not in ends:
        raise ValueError("root voxel is not a segment endpoint")

    n = len(ends)
    adj: List[List[Tuple[int, int, int]]] = [[] for _ in range(n)]
    for si, (a, b) in enumerate(seg_ends):
        w = len(segments[si]) - 1
        adj[a].append((b, si, w))
        adj[b].append((a, si, w))

    # Dijkstra by voxel distance; depthLevel increments per segment
    # traversed (the far endpoint of a branch is one junction deeper,
    # matching the voxel-wave rule where only the non-degree-2 endpoint
    # bumps the level)
    INF = float("inf")
    dist = np.full(n, INF)
    level = np.full(n, -1, np.int64)
    via_seg = np.full(n, -1, np.int64)
    r0 = ends[root]
    dist[r0] = 0.0
    level[r0] = 0
    heap = [(0.0, r0)]
    reached_segments = set()
    while heap:
        d, u = heapq.heappop(heap)
        if d > dist[u]:
            continue
        for (v, si, w) in adj[u]:
            reached_segments.add(si)
            nd = d + w
            if nd < dist[v]:
                dist[v] = nd
                level[v] = level[u] + 1
                via_seg[v] = si
                heapq.heappush(heap, (nd, v))

    # keep the root's component, compact node ids ordered by (level, id)
    # like the reference's depth-ordered indexing (convertNetowrk,
    # fluidSimulation.py:247-259)
    keep_nodes = np.nonzero(level >= 0)[0]
    order = keep_nodes[np.argsort(level[keep_nodes], kind="stable")]
    node_of_old = {int(o): i for i, o in enumerate(order.tolist())}
    coords = [None] * len(order)
    for v, old in ends.items():
        if old in node_of_old:
            coords[node_of_old[old]] = v

    kept_segs = [si for si in sorted(reached_segments)
                 if seg_ends[si][0] in node_of_old
                 and seg_ends[si][1] in node_of_old]

    heads, tails, radius, length, seg_idx, edge_depth = [], [], [], [], [], []
    for si in kept_segs:
        a, b = seg_ends[si]
        la, lb = level[a], level[b]
        if la > lb:
            a, b = b, a
            la, lb = lb, la
        heads.append(node_of_old[a])
        tails.append(node_of_old[b])
        radius.append(float(attrs[si].get("meanRadius", 1.0)))
        length.append(float(attrs[si].get("pathLength", 1.0)))
        seg_idx.append(si)
        edge_depth.append(int(min(la, lb)))

    # edge order by increasing depth (reference edge indexing,
    # fluidSimulation.py:263-268)
    eorder = np.argsort(np.asarray(edge_depth), kind="stable")
    heads = np.asarray(heads, np.int32)[eorder]
    tails = np.asarray(tails, np.int32)[eorder]
    radius = np.asarray(radius, float)[eorder]
    length = np.asarray(length, float)[eorder]
    seg_idx = np.asarray(seg_idx, np.int32)[eorder]

    node_depth = np.asarray(level[order], np.int32)
    h, t = orient_edges_by_depth(heads, tails, node_depth)
    E = len(h)
    net = FlowNetwork(
        heads=h, tails=t, node_depth=node_depth,
        radius=radius, length=length,
        c=np.ones(E), k=np.full(E, 1.852),
        entry_nodes=np.asarray([node_of_old[r0]], np.int32),
        spacing=spacing,
        edge_segment_index=seg_idx,
        node_coord=np.asarray([list(c) for c in coords], np.int32),
    )
    node_of = {c: i for i, c in enumerate(coords)}
    return net, node_of
