# Copy of arterynetwork_tpu/graphs/partitioning.py; the graphs are graphs/voxel_graph's classes.
"""Compartment partitioning (headless C9).

The reference's partition GUI (partitionCompartmentGUI(Detail).py) lets the
user pick initial and boundary voxels per compartment ({LMCA, RMCA, ACA,
LPCA, RPCA}), BFS-labels every reached voxel with ``partitionName`` /
``depthVoxel`` / ``depthLevel`` / ``pathDistance``
(onRandomWalkBFSButtonClicked, partitionCompartmentGUIDetail.py:316-343 via
myFunctions.randomWalkBFS), derives per-segment ``segmentLevel`` and saves
``chosenVoxelsForPartition.pkl`` + ``partitionInfo.pkl`` + the advanced
graphml (:289-310).  This module is that workflow without Qt.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

from . import voxel_graph as vg
from .traversal import assign_segment_levels, partition_bfs


def partition_compartments(G: vg.Graph, segments: Sequence[Sequence],
                           chosen_voxels: Dict[str, dict]) -> Dict[str, dict]:
    """Label compartments on the voxel graph.

    chosen_voxels: {name: {"initial_voxels": [...], "boundary_voxels": [...]}}
    Returns partitionInfo: {name: {"visited_voxels": [...],
    "segment_index_list": [...]}} and annotates G in place
    (partitionName on nodes and edges, depth/path attributes).
    """
    partition_info: Dict[str, dict] = {}
    for name, chosen in chosen_voxels.items():
        initial = [tuple(v) for v in chosen["initial_voxels"]]
        boundary = [tuple(v) for v in chosen.get("boundary_voxels", [])]
        _, visited, segment_ids = partition_bfs(G, initial, boundary)
        for v in visited:
            G.nodes[v]["partitionName"] = name
        for seg_idx in segment_ids:
            seg = [tuple(x) for x in segments[seg_idx]]
            for a, b in zip(seg[:-1], seg[1:]):
                if G.has_edge(a, b):
                    G[a][b]["partitionName"] = name
        partition_info[name] = {
            "visited_voxels": visited,
            "segment_index_list": sorted(set(segment_ids)),
        }
    assign_segment_levels(G, segments)
    return partition_info


def save_partition(store, chosen_voxels, partition_info, G,
                   graph_name="graphRepresentationCleanedWithAdvancedInfo"
                              ".graphml"):
    """Persist the partition with the reference's artifact names
    (partitionCompartmentGUIDetail.py:289-310)."""
    store.save_pickle("chosenVoxelsForPartition.pkl", chosen_voxels)
    store.save_pickle("partitionInfo.pkl", partition_info)
    store.save_graphml(graph_name, G)


def load_partition(store):
    chosen = store.load_pickle("chosenVoxelsForPartition.pkl")
    info = store.load_pickle("partitionInfo.pkl")
    return chosen, info
