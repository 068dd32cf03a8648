# Copy of arterynetwork_tpu/graphs/traversal.py; the graphs are graphs/voxel_graph's classes.
"""Graph traversal: compartment BFS and graph reduction.

* ``partition_bfs`` — the reference's ``randomWalkBFS``
  (myFunctions.py:36-98): BFS from chosen initial voxels bounded by
  boundary voxels, annotating every reached voxel with ``depthVoxel``
  (BFS wave index), ``depthLevel`` (increments only when passing a
  bifurcation), and ``pathDistance`` (cumulative Euclidean step length),
  and collecting the traversed segment indices.
* ``reduce_graph`` — the reference's ``reduceGraph``
  (graphRelated.py:621-660 / fluidSimulation.py:194-231): collapse each
  simple branch to a single directed edge (direction = increasing
  depthLevel) copying all node and edge attributes.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from . import voxel_graph as vg


def partition_bfs(G: vg.Graph, initial_voxels, boundary_voxels):
    """Annotate G in place; returns (G, visited_voxels, segment_index_list).

    First discovery wins: a voxel reached by two same-wave parents keeps
    the first parent's depthLevel/pathDistance and enters the next pool
    once.  (The reference guards re-discovery with ``depthVoxel``, which
    is only set when a voxel is *processed*, so same-wave multi-parent
    hits duplicate pool entries that multiply at every junction cluster —
    harmless on its hand-cleaned graphs, exponential on raw 26-adjacency
    skeletons.  When no same-wave duplicate exists the two semantics are
    identical.)
    """
    initial = [tuple(v) for v in initial_voxels]
    boundary = set(tuple(v) for v in boundary_voxels)

    depth_level_of: Dict[Tuple, int] = {}
    path_dist_of: Dict[Tuple, float] = {}
    depth_voxel_of: Dict[Tuple, int] = {}
    for v in initial:
        depth_level_of[v] = 0
        path_dist_of[v] = 0.0

    visited: List[Tuple] = list(initial)
    seen = set(initial)
    pool = list(initial)
    segment_indices: List[int] = []
    depth_voxel = 0
    while pool:
        nxt = []
        for cur in pool:
            depth_voxel_of[cur] = depth_voxel
            cur_level = depth_level_of[cur]
            cur_dist = path_dist_of[cur]
            cz, cy, cx = cur
            for v in G.neighbors(cur):
                if v in boundary or v in seen:
                    continue
                seen.add(v)
                deg = G.degree(v)
                depth_level_of[v] = (cur_level if deg == 2
                                     else cur_level + 1)
                dz, dy, dx = v[0] - cz, v[1] - cy, v[2] - cx
                path_dist_of[v] = cur_dist + (dz * dz + dy * dy
                                              + dx * dx) ** 0.5
                if deg >= 3 or deg == 1:
                    seg = G[cur][v].get("segmentIndex")
                    if seg is not None:
                        segment_indices.append(seg)
                nxt.append(v)
                visited.append(v)
        pool = nxt
        depth_voxel += 1

    vg.set_node_attributes(G, depth_level_of, "depthLevel")
    vg.set_node_attributes(G, path_dist_of, "pathDistance")
    vg.set_node_attributes(G, depth_voxel_of, "depthVoxel")
    return G, visited, segment_indices


def random_walk_bfs2(G: vg.Graph, initial_voxels, boundary_voxels):
    """Non-mutating re-traversal over precomputed ``depthVoxel``
    (``randomWalkBFS2``, myFunctions.py:100-151).

    Unlike ``partition_bfs`` this never writes to ``G``: it walks from
    the initial voxels along neighbors whose stored ``depthVoxel`` is
    strictly increasing (i.e. re-plays a previous traversal's wavefront
    ordering), skipping boundary voxels and voxels the previous
    traversal never labeled, and collects the segment indices crossed
    when entering a bifurcation (degree >= 3) or segment end
    (degree == 1).  Returns ``(G, visited_voxels, segment_index_list)``
    with the same tuple contract as ``partition_bfs``.

    Multiplicity matches the reference: there is NO visited-set dedupe —
    a voxel reachable from several qualifying parents is appended (and
    its entering segment index recorded) once per parent edge, exactly
    as myFunctions.py:136-146 does.  Termination still holds because
    ``depthVoxel`` strictly increases along every walk.
    """
    initial = [tuple(v) for v in initial_voxels]
    boundary = set(tuple(v) for v in boundary_voxels)

    visited: List[Tuple] = list(initial)
    pool = list(initial)
    segment_indices: List[int] = []
    while pool:
        nxt = []
        for cur in pool:
            if "depthVoxel" not in G.nodes[cur]:
                continue
            cur_depth = G.nodes[cur]["depthVoxel"]
            for v in G.neighbors(cur):
                if (v in boundary
                        or "depthVoxel" not in G.nodes[v]
                        or G.nodes[v]["depthVoxel"] <= cur_depth):
                    continue
                deg = G.degree(v)
                if deg >= 3 or deg == 1:
                    seg = G[cur][v].get("segmentIndex")
                    if seg is not None:
                        segment_indices.append(seg)
                nxt.append(v)
                visited.append(v)
        pool = nxt
    return G, visited, segment_indices


def assign_segment_levels(G: vg.Graph, segments) -> None:
    """Per-segment ``segmentLevel`` = min node depthLevel over the segment
    (partitionCompartmentGUIDetail.py semantics); stored on each edge."""
    for seg in segments:
        levels = [G.nodes[v].get("depthLevel") for v in seg
                  if "depthLevel" in G.nodes[v]]
        if not levels:
            continue
        level = int(min(levels))
        for a, b in zip(seg[:-1], seg[1:]):
            if G.has_edge(a, b):
                G[a][b]["segmentLevel"] = level


def reduce_graph(G: vg.Graph, segment_list, segment_index_list) -> vg.DiGraph:
    """Collapse each listed segment to one directed edge.

    Direction: from the lower-depthLevel end to the higher (ties keep the
    stored order, like the reference's > comparison)."""
    DG = vg.DiGraph()
    for segment_index in segment_index_list:
        segment = [tuple(v) for v in segment_list[segment_index]]
        head, tail, second = segment[0], segment[-1], segment[1]
        head_level = G.nodes[head].get("depthLevel", 0)
        tail_level = G.nodes[tail].get("depthLevel", 0)
        if head_level > tail_level:
            head, tail, second = tail, head, segment[-2]

        DG.add_edge(head, tail)
        for key, value in G[head][second].items():
            DG[head][tail][key] = value
        for key, value in G.nodes[head].items():
            DG.nodes[head][key] = value
        for key, value in G.nodes[tail].items():
            DG.nodes[tail][key] = value
    return DG


def reduced_to_flow_network(DG: vg.DiGraph, root, spacing):
    """Int-index a reduced graph into a FlowNetwork (the reference's
    ``convertNetowrk``, fluidSimulation.py:233-309): nodes numbered in
    increasing depthLevel order, edges in increasing depth order.

    Requires node attr ``depthLevel`` and edge attrs ``meanRadius``,
    ``pathLength`` (voxels).  Returns (FlowNetwork, node_index_of_coord).
    """
    from .network import FlowNetwork, orient_edges_by_depth

    nodes = list(DG.nodes())
    depths = np.asarray([DG.nodes[n]["depthLevel"] for n in nodes])
    order = np.argsort(depths, kind="stable")  # node order kept within depth
    node_of: Dict = {nodes[i]: k for k, i in enumerate(order.tolist())}
    depth_arr = depths[order].tolist()
    N = len(nodes)

    # edge depth = min endpoint depth; index edges by increasing depth
    edges = list(DG.edges())
    edge_depth = [min(DG.nodes[a]["depthLevel"], DG.nodes[b]["depthLevel"])
                  for a, b in edges]
    order = np.argsort(np.asarray(edge_depth), kind="stable")
    heads, tails, radius, length, seg_idx = [], [], [], [], []
    for e in order:
        a, b = edges[e]
        heads.append(node_of[a])
        tails.append(node_of[b])
        radius.append(DG[a][b].get("meanRadius", 1.0))
        length.append(DG[a][b].get("pathLength",
                                   DG[a][b].get("length", 1.0)))
        seg_idx.append(DG[a][b].get("segmentIndex", -1))

    node_depth = np.asarray(depth_arr, dtype=np.int32)
    h, t = orient_edges_by_depth(np.asarray(heads, np.int32),
                                 np.asarray(tails, np.int32), node_depth)
    E = len(heads)
    net = FlowNetwork(
        heads=h, tails=t, node_depth=node_depth,
        radius=np.asarray(radius, float),
        length=np.asarray(length, float),
        c=np.ones(E), k=np.full(E, 1.852),
        entry_nodes=np.asarray([node_of[root]], np.int32),
        spacing=spacing,
        edge_segment_index=np.asarray(seg_idx, np.int32),
        node_coord=np.asarray([list(n) for n in node_of], dtype=np.int32)
        if all(isinstance(n, tuple) for n in node_of) else None,
    )
    return net, node_of
