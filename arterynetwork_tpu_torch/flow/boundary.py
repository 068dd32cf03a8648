# Copy of arterynetwork_tpu/flow/boundary.py, unchanged.
"""Boundary-condition models (reference C18).

* ``set_terminating_pressure`` — ADAN-style pressure-vs-path-length
  model: ``P = P_in + 0.8 * slope * pathLength`` per compartment
  (setTerminatingPressure, fluidSimulation.py:1392-1449);
* ``fit_terminating_pressure_to_path_length`` — inverse fit from an
  existing solution per compartment via linear regression
  (fitTerminatingPressureToPathLength, fluidSimulation.py:1451-1517).

Compartments are named node sets on the reduced graph; the reference's
hard-coded topology {LMCA:[4], RMCA:[5], LPCA:[6], RPCA:[7], ACA:[10]}
(fluidSimulation.py:822-823 and >=6 other sites) becomes an explicit
registry datum (``COW_PARTITIONS``).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
from scipy import stats

from ..constants import COMPARTMENT_INLET_PRESSURE
from ..graphs.network import FlowNetwork

# The reference's CoW compartment roots/boundaries on the int-indexed
# reduced graph (fluidSimulation.py:822-823).
COW_PARTITIONS = {
    "LMCA": {"start_nodes": [4], "boundary_nodes": [10]},
    "RMCA": {"start_nodes": [5], "boundary_nodes": [10]},
    "LPCA": {"start_nodes": [6], "boundary_nodes": []},
    "RPCA": {"start_nodes": [7], "boundary_nodes": []},
    "ACA": {"start_nodes": [10], "boundary_nodes": []},
}


def bfs_partition(net: FlowNetwork, start_nodes, boundary_nodes):
    """Depth-increasing BFS on the reduced network
    (FluidNetwork.BFS, fluidSimulation.py:1198-1233).

    Returns dict(visited_nodes, visited_edges)."""
    depth = net.node_depth
    adj = [[] for _ in range(net.num_nodes)]
    for e in range(net.num_edges):
        adj[net.heads[e]].append((net.tails[e], e))
        adj[net.tails[e]].append((net.heads[e], e))
    boundary = set(int(b) for b in boundary_nodes)
    visited_nodes, visited_edges = [], []
    seen = set()
    for start in start_nodes:
        frontier = [int(start)]
        while frontier:
            nxt = []
            for cur in frontier:
                if cur in seen:
                    continue
                seen.add(cur)
                visited_nodes.append(cur)
                for (nbr, e) in adj[cur]:
                    if (depth[cur] < depth[nbr] and nbr not in boundary
                            and nbr not in seen):
                        nxt.append(nbr)
                        visited_edges.append(e)
            frontier = nxt
    return {"visited_nodes": visited_nodes, "visited_edges": visited_edges}


def terminating_nodes_of_partition(net: FlowNetwork, part):
    res = bfs_partition(net, part["start_nodes"], part["boundary_nodes"])
    deg = net.degree
    return [n for n in res["visited_nodes"]
            if deg[n] == 1 and net.node_depth[n] != 0]


def path_lengths_from(net: FlowNetwork, start) -> np.ndarray:
    """Path length (meters) from ``start`` to every node along
    hop-shortest paths, in one BFS pass.  NaN where unreachable."""
    adj = [[] for _ in range(net.num_nodes)]
    for e in range(net.num_edges):
        h, t = int(net.heads[e]), int(net.tails[e])
        adj[h].append((t, e))
        adj[t].append((h, e))
    out = np.full(net.num_nodes, np.nan)
    out[int(start)] = 0.0
    lengths_m = np.asarray(net.length, float) * net.spacing
    frontier = [int(start)]
    seen = {int(start)}
    while frontier:
        nxt = []
        for cur in frontier:
            for (nbr, e) in adj[cur]:
                if nbr in seen:
                    continue
                seen.add(nbr)
                out[nbr] = out[cur] + lengths_m[e]
                nxt.append(nbr)
        frontier = nxt
    return out


def path_length_to_node(net: FlowNetwork, start, node):
    """Shortest-path length (meters) from start to node on the network."""
    return float(path_lengths_from(net, start)[int(node)])


def set_terminating_pressure(
    net: FlowNetwork,
    partitions: Dict[str, dict] = None,
    fit_per_partition: Optional[Dict[str, tuple]] = None,
    slope: float = -10000.0,
    intercept: float = 0.0,
    pressure_in: float = COMPARTMENT_INLET_PRESSURE,
) -> np.ndarray:
    """Terminating pressures from the path-length regression.

    option=1 semantics: one (slope, intercept) for all partitions;
    option=2: ``fit_per_partition[name] = (slope, intercept)``.
    Returns a full node-pressure vector with values set at terminating
    nodes (NaN elsewhere, entry nodes left to the caller).
    """
    if partitions is None:
        partitions = COW_PARTITIONS
    pressures = np.full(net.num_nodes, np.nan)
    for name, part in partitions.items():
        s, _i = (fit_per_partition[name] if fit_per_partition
                 else (slope, intercept))
        p_in = part.get("pressure_in", pressure_in)
        pls = path_lengths_from(net, part["start_nodes"][0])
        for node in terminating_nodes_of_partition(net, part):
            pressures[node] = p_in + pls[node] * s * 0.8
    return pressures


def fit_terminating_pressure_to_path_length(
        net: FlowNetwork, node_pressure, partitions=None):
    """Per-partition linregress of terminating pressure vs path length
    (fluidSimulation.py:1451-1517).  Returns {name: (slope, intercept)}."""
    if partitions is None:
        partitions = COW_PARTITIONS
    out = {}
    for name, part in partitions.items():
        nodes = terminating_nodes_of_partition(net, part)
        if len(nodes) < 2:
            out[name] = (0.0, float("nan"))
            continue
        all_pls = path_lengths_from(net, part["start_nodes"][0])
        pls = [float(all_pls[n]) for n in nodes]
        ps = [float(node_pressure[n]) for n in nodes]
        res = stats.linregress(pls, ps)
        out[name] = (float(res.slope), float(res.intercept))
    return out


def volume_per_partition(net: FlowNetwork, partitions=None):
    """Sum of pi r^2 L per compartment in mm^3
    (getVolumePerPartition, fluidSimulation.py:814-842)."""
    if partitions is None:
        partitions = COW_PARTITIONS
    out = {}
    mm = net.spacing * 1000.0
    for name, part in partitions.items():
        res = bfs_partition(net, part["start_nodes"], part["boundary_nodes"])
        total = 0.0
        for e in res["visited_edges"]:
            r = net.radius[e] * mm
            length = net.length[e] * mm
            total += float(np.pi * r * r * length)
        out[name] = total
    return out


def calculate_variable_bounds(net: FlowNetwork, node_pressure):
    """Monotonic pressure lower bounds per node: a parent's pressure
    cannot be below the max of its children's (lower bounds of) pressures
    (calculateVariableBounds, fluidSimulation.py:1235-1254).

    node_pressure supplies the fixed terminal values.  Returns
    min_pressure[N] (NaN where no bound applies)."""
    node_pressure = np.asarray(node_pressure, float)
    deg = net.degree
    depth = net.node_depth
    min_pressure = np.full(net.num_nodes, np.nan)

    children = [[] for _ in range(net.num_nodes)]
    for e in range(net.num_edges):
        h, t = int(net.heads[e]), int(net.tails[e])
        if depth[t] > depth[h]:
            children[h].append(t)
        else:
            children[t].append(h)

    max_depth = int(depth.max())
    for d in range(max_depth - 1, 0, -1):
        for n in np.nonzero((depth == d) & (deg != 1))[0]:
            vals = []
            for c in children[n]:
                v = (min_pressure[c] if not np.isnan(min_pressure[c])
                     else node_pressure[c])
                if not np.isnan(v):
                    vals.append(v)
            if vals:
                min_pressure[n] = max(vals)
    return min_pressure
