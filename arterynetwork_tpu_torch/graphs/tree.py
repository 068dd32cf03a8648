# Copy of arterynetwork_tpu/graphs/tree.py, unchanged.
"""Synthetic network generator.

Capability-equivalent of the reference's ``FluidNetwork.generateNetwork``
(fluidSimulation.py:77-159): a random binary tree, optionally with merge
events (30% chance per depth that two same-depth nodes merge into one child,
creating a Circle-of-Willis-like loop).  Seedable through a
``numpy.random.Generator``.
"""

from __future__ import annotations

import numpy as np

from .network import FlowNetwork, make_network
from ..constants import DEFAULT_SPACING


def generate_tree(
    max_depth: int = 10,
    allow_merge: bool = False,
    merge_probability: float = 0.3,
    rng: np.random.Generator | None = None,
    spacing: float = DEFAULT_SPACING,
) -> FlowNetwork:
    """Generate a random binary tree network.

    Nodes and edges are indexed in creation order, which matches the
    reference's depth-ordered indexing: node 0 is the root, children are
    appended depth by depth (fluidSimulation.py:90-132).
    """
    if rng is None:
        rng = np.random.default_rng(0)

    node_depth = [0]
    edges = []          # (parent, child)
    child_count = {0: 0}
    next_node = 1

    for depth in range(max_depth):
        nodes_here = [n for n, d in enumerate(node_depth) if d == depth]
        if allow_merge and len(nodes_here) > 2 and rng.random() <= merge_probability:
            a, b = rng.choice(np.asarray(nodes_here), size=2, replace=False)
            merged = next_node
            node_depth.append(depth + 1)
            child_count[merged] = 0
            edges.append((int(a), merged))
            edges.append((int(b), merged))
            child_count[int(a)] += 1
            child_count[int(b)] += 1
            next_node += 1

        for n in nodes_here:
            for _ in range(2 - child_count.get(n, 0)):
                child = next_node
                node_depth.append(depth + 1)
                child_count[child] = 0
                edges.append((n, child))
                child_count[n] += 1
                next_node += 1

    edges = np.asarray(edges, dtype=np.int32)
    node_depth = np.asarray(node_depth, dtype=np.int32)
    E = edges.shape[0]
    # Placeholder attributes; use set_network_radii / ADAN models to fill in
    # physical values (the reference fills them in setNetwork, option 1).
    radius = np.full(E, 1.0)
    length = np.full(E, 10.0)
    return make_network(edges, node_depth, radius, length, spacing=spacing)


def set_network_properties(
    net: FlowNetwork,
    radius_fit=(0.5569, 0.4199, 0.469),
    length_range_mm=(1.0, 70.0),
    c_value: float = 1.0,
    k_value: float = 1.852,
    rng: np.random.Generator | None = None,
) -> FlowNetwork:
    """Assign radii from a BraVa-style exponential fit and random lengths.

    Mirrors ``setNetwork`` option 1 (fluidSimulation.py:364-377):
    ``radius_mm = a * exp(-b * edge_depth) + c`` and uniformly random length
    in ``length_range_mm``; both converted mm -> voxel via spacing.
    """
    if rng is None:
        rng = np.random.default_rng(0)
    a, b, c_fit = radius_fit
    depth = net.edge_depth
    mm_per_voxel = net.spacing * 1000.0
    radius = (a * np.exp(-b * depth) + c_fit) / mm_per_voxel
    lo, hi = length_range_mm
    length = (rng.random(net.num_edges) * (hi - lo) + lo) / mm_per_voxel
    return net.replace(
        radius=radius,
        length=length,
        c=np.full(net.num_edges, float(c_value)),
        k=np.full(net.num_edges, float(k_value)),
    )
