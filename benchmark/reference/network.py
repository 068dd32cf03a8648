"""The flow network that a volume's branches make, and its boundary
pressures, worked out again from the branches alone.

* ``inlet``: the terminal branch end with the lowest last coordinate,
  the first such in branch order.
* ``build``: nodes are the branches' end voxels, numbered in order of
  first appearance; each node's depth is the number of branches on its
  shortest path from the inlet, by voxel steps (Dijkstra); the network
  keeps the inlet's component, nodes in order of (depth, number), edges
  in order of (the smaller end depth, branch), each pointing from the
  shallower end.
* ``ground_truth``: the depth sweep that sets the boundary pressures
  (a plain copy of the pipeline's rule, after the upstream project's
  fluidSimulation.py:534-783, option 2): from the inlet's pressure and
  flow, depth by depth, a node's flow is split among its deeper branches
  in proportion to their radius squared and each child's pressure is its
  parent's less the Hazen-Williams drop; a node that two branches of
  the depth above reach takes the mean of the first branch's feasible
  flow (all of it behind a straight pipe) and the second follows from
  the pressure difference.
* ``path_length_pressures``: where the sweep fails (on loops), the
  pipeline's fallback: each terminal node that a walk to ever deeper
  nodes reaches from the inlet gets 0.95 x the inlet pressure less
  8000 Pa per meter of its path (first reached, breadth first) from the
  inlet; the inlet keeps its pressure; other terminals get 0.8 x it.
"""

from __future__ import annotations

import heapq

import numpy as np

from .hw_flow import HW_COEFF, HW_DIAMETER_EXPONENT


def _key(v):
    return tuple(int(x) for x in v)


def inlet(segments):
    counts = {}
    for seg in segments:
        for v in (_key(seg[0]), _key(seg[-1])):
            counts[v] = counts.get(v, 0) + 1
    tips = [v for v, c in counts.items() if c == 1]
    return min(tips, key=lambda v: v[2])


def build(segments, root):
    """dict: ``coord`` [N, 3], ``depth`` [N], ``heads``, ``tails``,
    ``segment`` (the branch of each edge) [E], ``entry`` (the inlet's
    node)."""
    ends, seg_ends = {}, []
    for seg in segments:
        h, t = _key(seg[0]), _key(seg[-1])
        for v in (h, t):
            ends.setdefault(v, len(ends))
        seg_ends.append((ends[h], ends[t]))
    n = len(ends)
    adj = [[] for _ in range(n)]
    for si, (a, b) in enumerate(seg_ends):
        w = len(segments[si]) - 1
        adj[a].append((b, si, w))
        adj[b].append((a, si, w))
    dist = np.full(n, np.inf)
    level = np.full(n, -1, np.int64)
    r0 = ends[root]
    dist[r0], level[r0] = 0.0, 0
    heap, reached = [(0.0, r0)], set()
    while heap:
        d, u = heapq.heappop(heap)
        if d > dist[u]:
            continue
        for v, si, w in adj[u]:
            reached.add(si)
            if d + w < dist[v]:
                dist[v] = d + w
                level[v] = level[u] + 1
                heapq.heappush(heap, (d + w, v))
    keep = np.nonzero(level >= 0)[0]
    order = keep[np.argsort(level[keep], kind="stable")]
    new = np.full(n, -1, np.int64)
    new[order] = np.arange(len(order))
    coord = np.zeros((len(order), 3), np.int64)
    for v, old in ends.items():
        if new[old] >= 0:
            coord[new[old]] = v
    segs = [si for si in sorted(reached)
            if new[seg_ends[si][0]] >= 0 and new[seg_ends[si][1]] >= 0]
    a = np.asarray([seg_ends[si][0] for si in segs], np.int64)
    b = np.asarray([seg_ends[si][1] for si in segs], np.int64)
    edge_depth = np.minimum(level[a], level[b])
    eo = np.argsort(edge_depth, kind="stable")
    a, b = a[eo], b[eo]
    swap = level[a] > level[b]
    heads = new[np.where(swap, b, a)]
    tails = new[np.where(swap, a, b)]
    return {"coord": coord, "depth": level[order], "heads": heads,
            "tails": tails, "segment": np.asarray(segs, np.int64)[eo],
            "entry": int(new[r0])}


def dp_from_flow(q, radius_m, length_m, c=1.0, k=1.852):
    return (HW_COEFF * q ** k * length_m / c ** k
            / (2.0 * radius_m) ** HW_DIAMETER_EXPONENT)


def flow_from_dp(dp, radius_m, length_m, c=1.0, k=1.852):
    a = c ** k * (2.0 * radius_m) ** HW_DIAMETER_EXPONENT / (
        HW_COEFF * length_m)
    return (dp * a) ** (1.0 / k)


def ground_truth(net, radius, radius_m, length_m, inlet_pressure,
                 inlet_flow):
    """Node pressures [N] of the depth sweep, or None where it fails.
    ``radius`` (voxels, the split's weights) and ``radius_m`` /
    ``length_m`` (meters) are per edge of ``net``."""
    heads, tails, depth = net["heads"], net["tails"], net["depth"]
    N, E = len(depth), len(heads)
    pressure = np.full(N, np.nan)
    node_flow = np.full(N, np.nan)
    flow = np.full(E, np.nan)
    out_e = [[] for _ in range(N)]
    in_e = [[] for _ in range(N)]
    for e in range(E):
        out_e[heads[e]].append(e)
        in_e[tails[e]].append(e)
    degree = np.bincount(np.concatenate([heads, tails]), minlength=N)

    def drop(e, q):
        return dp_from_flow(q, radius_m[e], length_m[e])

    for d in range(int(depth.max()) if N else 0):
        for node in np.nonzero(depth == d + 1)[0]:
            pe = [e for e in in_e[node] if depth[heads[e]] == d]
            if len(pe) <= 1:
                continue
            parents = [int(heads[e]) for e in pe]
            pp, qp = pressure[parents], node_flow[parents]
            if np.isnan(pp).any() or np.isnan(qp).any():
                return None
            low = pp - np.asarray([drop(e, q) for e, q in zip(pe, qp)])
            dg = [int(degree[p]) for p in parents]
            if dg[0] == 2 and dg[1] > 2:
                i1, i2, straight = 0, 1, True
            elif dg[0] > 2 and dg[1] == 2:
                i1, i2, straight = 1, 0, True
            elif dg[0] == 2 and dg[1] == 2:
                if low[0] != low[1]:
                    return None
                i1, i2, straight = 0, 1, True
            else:
                i1, i2 = (0, 1) if low[0] > low[1] else (1, 0)
                straight = False
            e1, e2 = pe[i1], pe[i2]
            q_max = qp[i1]
            q_min = flow_from_dp(max(0.0, pp[i1] - pp[i2]), radius_m[e1],
                                 length_m[e1])
            if q_min > q_max:
                return None
            q1 = q_max if straight else 0.5 * (q_max + q_min)
            flow[e1] = q1
            pj = pp[i1] - drop(e1, q1)
            pressure[node] = pj
            if pp[i2] - pj < 0:
                return None
            flow[e2] = flow_from_dp(pp[i2] - pj, radius_m[e2], length_m[e2])
            node_flow[node] = q1 + flow[e2]
        for node in np.nonzero(depth == d)[0]:
            if d == 0 or node == net["entry"]:
                pressure[node] = inlet_pressure
                node_flow[node] = inlet_flow
            if np.isnan(node_flow[node]):
                continue
            child = [e for e in out_e[node] if depth[tails[e]] > d]
            todo = [e for e in child if np.isnan(flow[e])]
            avail = node_flow[node] - sum(flow[e] for e in child
                                          if not np.isnan(flow[e]))
            if avail < -np.finfo(float).eps:
                return None
            if not todo:
                continue
            r2 = np.asarray([radius[e] ** 2 for e in todo])
            for e, q in zip(todo, avail * r2 / r2.sum()):
                pressure[tails[e]] = pressure[node] - drop(e, q)
                node_flow[tails[e]] = q
                flow[e] = q
    return pressure


def path_length_pressures(net, length_m, inlet_pressure):
    """Node pressures [N] at the inlet and the terminal nodes (NaN
    elsewhere) by the path-length fallback."""
    heads, tails, depth = net["heads"], net["tails"], net["depth"]
    N = len(depth)
    adj = [[] for _ in range(N)]
    for e in range(len(heads)):
        adj[heads[e]].append((int(tails[e]), e))
        adj[tails[e]].append((int(heads[e]), e))
    entry = net["entry"]
    path = np.full(N, np.nan)
    path[entry] = 0.0
    front, seen = [entry], {entry}
    while front:
        nxt = []
        for u in front:
            for v, e in adj[u]:
                if v not in seen:
                    seen.add(v)
                    path[v] = path[u] + length_m[e]
                    nxt.append(v)
        front = nxt
    reached, front = set(), [entry]
    while front:
        nxt = []
        for u in front:
            if u in reached:
                continue
            reached.add(u)
            nxt += [v for v, _ in adj[u]
                    if depth[u] < depth[v] and v not in reached]
        front = nxt
    degree = np.bincount(np.concatenate([heads, tails]), minlength=N)
    p = np.full(N, np.nan)
    for n in reached:
        if degree[n] == 1 and depth[n] != 0:
            p[n] = 0.95 * inlet_pressure - 10000.0 * 0.8 * path[n]
    p[entry] = inlet_pressure
    terminal = (degree == 1) | (np.arange(N) == entry)
    p[terminal & np.isnan(p)] = 0.8 * inlet_pressure
    return p
