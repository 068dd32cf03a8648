# Copy of arterynetwork_tpu/flow/ground_truth.py, unchanged (physics accepts numpy).
"""Depth-ordered ground-truth flow generator.

Host-side re-creation of ``FluidNetwork.createGroundTruth``
(fluidSimulation.py:534-783): starting from the inlet pressure/flow, sweep
the network depth by depth, splitting flow at bifurcations and computing
downstream pressures with the forward Hazen-Williams relation.  Used to
(a) construct exact reference solutions for solver round-trip tests
(reference test strategy, SURVEY.md §4.2) and (b) produce terminating
pressures for the boundary-condition models.

Split policies (same numbered options as the reference):
  * option 1 — each child takes ~1/n of the available flow with a +-1/6
    random fluctuation (fluidSimulation.py:699-716);
  * option 2 — flow split proportional to child cross-sectional area
    (fluidSimulation.py:718-722).

Merge nodes (two parents joining, CoW loops) are handled as in the
reference (fluidSimulation.py:571-667): the first parent edge takes the
mean of its feasible flow range (all of it if the parent is a straight
pipe), fixing the junction pressure; the second edge's flow follows from
the pressure difference.

The reference hard-codes a flow split at node 10 and a 0.4/0.4/0.2
LICA/RICA/VA inlet split (fluidSimulation.py:637-646, 725-728); those become
the optional ``manual_splits`` / ``root_split`` arguments.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from ..constants import INLET_FLOW, INLET_PRESSURE
from ..graphs.network import FlowNetwork
from .physics import dp_from_flow, flow_from_dp


class GroundTruthResult:
    def __init__(self, success, pressure, flow, velocity, velocity_pressure):
        self.success = success
        self.pressure = pressure          # f64[N] Pa
        self.flow = flow                  # f64[E] m^3/s (head->tail)
        self.velocity = velocity          # f64[E] m/s
        self.velocity_pressure = velocity_pressure  # reference unknown layout


def create_ground_truth(
    net: FlowNetwork,
    option: int = 1,
    rng: Optional[np.random.Generator] = None,
    inlet_pressure: float = INLET_PRESSURE,
    inlet_flow: float = INLET_FLOW,
    manual_splits: Optional[Dict[int, Dict[int, float]]] = None,
    root_split: Optional[Sequence[float]] = None,
) -> GroundTruthResult:
    """Generate an exact (pressure, flow) solution by a depth sweep.

    manual_splits: {merge_node: {edge_index: fraction_of_max_flow}} override
    for the first-parent-edge flow at merge nodes.
    root_split: per-out-edge flow fractions at the root (in edge-index order).
    """
    if rng is None:
        rng = np.random.default_rng(0)

    radius_m = net.radius_m()
    length_m = net.length_m()
    heads, tails = net.heads, net.tails
    depth = net.node_depth
    N, E = net.num_nodes, net.num_edges

    def edge_dp(e, q):
        return dp_from_flow(q, radius_m[e], length_m[e], net.c[e], net.k[e])

    def edge_q_from_dp(e, dp):
        return flow_from_dp(dp, radius_m[e], length_m[e], net.c[e], net.k[e])

    pressure = np.full(N, np.nan)
    node_flow = np.full(N, np.nan)
    flow = np.full(E, np.nan)

    out_edges = [[] for _ in range(N)]   # edges with head == n
    in_edges = [[] for _ in range(N)]    # edges with tail == n
    for e in range(E):
        out_edges[heads[e]].append(e)
        in_edges[tails[e]].append(e)
    degree = net.degree

    max_depth = int(depth.max())
    entry = set(int(n) for n in net.entry_nodes)

    for current_depth in range(max_depth):
        # -- merge nodes at the next depth (two+ parents at current depth) --
        next_nodes = np.nonzero(depth == current_depth + 1)[0]
        for node in next_nodes:
            parents = [int(heads[e]) for e in in_edges[node]
                       if depth[heads[e]] == current_depth]
            if len(parents) <= 1:
                continue
            parent_edges = [e for e in in_edges[node]
                            if depth[heads[e]] == current_depth]
            p_parent = pressure[parents]
            q_parent = node_flow[parents]
            if np.any(np.isnan(p_parent)) or np.any(np.isnan(q_parent)):
                return _failure(N, E)
            dp_parent = [edge_dp(e, q) for e, q in zip(parent_edges, q_parent)]
            node_min_pressure = p_parent - np.asarray(dp_parent)
            deg_parent = [int(degree[p]) for p in parents]

            if deg_parent[0] == 2 and deg_parent[1] > 2:
                loc1, loc2 = 0, 1
                straight1 = True
            elif deg_parent[0] > 2 and deg_parent[1] == 2:
                loc1, loc2 = 1, 0
                straight1 = True
            elif deg_parent[0] == 2 and deg_parent[1] == 2:
                if node_min_pressure[0] != node_min_pressure[1]:
                    return _failure(N, E)
                loc1, loc2 = 0, 1
                straight1 = True
            else:
                loc1, loc2 = (0, 1) if node_min_pressure[0] > node_min_pressure[1] else (1, 0)
                straight1 = False

            e1, e2 = parent_edges[loc1], parent_edges[loc2]
            max_possible = q_parent[loc1]
            min_dp = max(0.0, p_parent[loc1] - p_parent[loc2])
            min_possible = edge_q_from_dp(e1, min_dp)
            if min_possible > max_possible:
                return _failure(N, E)

            if straight1:
                q1 = max_possible
            else:
                q1 = 0.5 * (max_possible + min_possible)
            if manual_splits and int(node) in manual_splits:
                override = manual_splits[int(node)]
                if int(e1) in override:
                    q1 = max_possible * override[int(e1)]

            flow[e1] = q1
            junction_p = p_parent[loc1] - edge_dp(e1, q1)
            pressure[node] = junction_p
            dp2 = p_parent[loc2] - junction_p
            if dp2 < 0:
                return _failure(N, E)
            q2 = edge_q_from_dp(e2, dp2)
            flow[e2] = q2
            node_flow[node] = q1 + q2

        # -- ordinary nodes at the current depth --
        for node in np.nonzero(depth == current_depth)[0]:
            if current_depth == 0 or int(node) in entry:
                pressure[node] = inlet_pressure
                node_flow[node] = inlet_flow
            if np.isnan(node_flow[node]):
                # Unreached (e.g. failure upstream)
                continue
            child_edges = [e for e in out_edges[node]
                           if depth[tails[e]] > current_depth]
            todo = [e for e in child_edges if np.isnan(flow[e])]
            done = [e for e in child_edges if not np.isnan(flow[e])]
            available = node_flow[node] - sum(flow[e] for e in done)
            if available < -np.finfo(float).eps:
                return _failure(N, E)

            amounts = []
            if option == 1:
                remaining = available
                n_left = len(todo)
                for _ in range(len(todo)):
                    if n_left > 1:
                        base = 100.0 / n_left
                        fluct = base / 3.0
                        pct = base - fluct / 2 + rng.random() * fluct
                        q = remaining * pct / 100.0
                        amounts.append(q)
                        remaining -= q
                    else:
                        amounts.append(remaining)
                    n_left -= 1
            elif option == 2:
                r2 = np.array([net.radius[e] ** 2 for e in todo])
                amounts = list(available * r2 / r2.sum()) if len(todo) else []
            else:
                raise ValueError(f"unknown option {option}")

            if root_split is not None and int(node) in entry:
                todo = list(child_edges)
                amounts = [node_flow[node] * f for f in root_split]

            for e, q in zip(todo, amounts):
                t = int(tails[e])
                dp = edge_dp(e, q)
                pressure[t] = pressure[node] - dp
                node_flow[t] = q
                flow[e] = q

    velocity = flow / (np.pi * radius_m ** 2)
    vp = _pack(net, pressure, velocity)
    return GroundTruthResult(True, pressure, flow, velocity, vp)


def _failure(N, E):
    nanN = np.full(N, np.nan)
    nanE = np.full(E, np.nan)
    return GroundTruthResult(False, nanN, nanE, nanE, None)


def _pack(net: FlowNetwork, pressure, velocity):
    idx = net.args_index()
    x = np.zeros(idx["num_unknowns"])
    x[: net.num_edges] = velocity
    node_args = idx["node_args"]
    for n in range(net.num_nodes):
        if node_args[n] >= 0:
            x[node_args[n]] = pressure[n]
    return x
