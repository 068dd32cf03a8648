"""Direct graph-Laplacian solver by parallel tree elimination.

Port of the JAX package's flow/tree_solver.py.  Vascular networks are
trees plus a handful of Circle-of-Willis loops, so the Newton linear
systems (weighted Laplacians on the unknown-pressure nodes) admit a
perfect elimination order: repeatedly strip degree-1 unknowns (all strips
within a round are independent), dense-solve the tiny remaining 2-core
(the loop nodes; empty for pure trees), then back-substitute in reverse.
Zero fill-in, exact in one pass.

The elimination structure depends only on the graph, so it is planned
once on the host (`plan_elimination`) and reused for every Newton
iteration with different weights.  The rounds run as a Python loop of
gathers and ``index_add_`` on the system's device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .system import FlowSystem


@dataclasses.dataclass(frozen=True)
class EliminationPlan:
    """Static per-round elimination schedule (padded to max round size).

    Per eliminated unknown v (slot in round r): its unknown-graph parent
    p(v) and the index of the connecting edge (for the weight gather).
    Padded slots point at node M / edge E sentinels with valid=False.
    """
    elim_nodes: torch.Tensor   # i64[R, W] unknown-index of eliminated node
    parents: torch.Tensor      # i64[R, W] unknown-index of its parent
    edge_idx: torch.Tensor     # i64[R, W] edge connecting them
    valid: torch.Tensor        # bool[R, W]
    core_nodes: torch.Tensor   # i64[C] unknown-indices of the 2-core
    core_slot: torch.Tensor    # i64[M+1] position of each unknown in core, C if none
    num_rounds: int
    core_size: int


def plan_elimination(system: FlowSystem) -> Optional[EliminationPlan]:
    """Host-side planning.  Returns None for systems with no unknowns."""
    M = system.num_unknown_pressures
    if M == 0:
        return None
    slot = system.node_unknown_index.cpu().numpy()
    hu = slot[system.head.cpu().numpy()]
    tu = slot[system.tail.cpu().numpy()]
    E = hu.shape[0]

    # adjacency among unknowns only
    adj = [[] for _ in range(M)]
    for e in range(E):
        a, b = int(hu[e]), int(tu[e])
        if a < M and b < M:
            adj[a].append((b, e))
            adj[b].append((a, e))

    degree = np.array([len(a) for a in adj])
    removed = np.zeros(M, dtype=bool)
    rounds = []
    while True:
        leaves = [v for v in range(M)
                  if not removed[v] and degree[v] <= 1]
        if not leaves:
            break
        entries = []
        for v in leaves:
            nbrs = [(p, e) for (p, e) in adj[v] if not removed[p]]
            if not nbrs:
                # isolated unknown (only fixed neighbors): solve directly
                entries.append((v, M, E))
            else:
                p, e = nbrs[0]
                entries.append((v, p, e))
        for v, p, e in entries:
            removed[v] = True
            if p < M:
                degree[p] -= 1
        rounds.append(entries)

    core = [v for v in range(M) if not removed[v]]
    C = len(core)
    core_slot = np.full(M + 1, C, dtype=np.int64)
    for i, v in enumerate(core):
        core_slot[v] = i

    R = max(len(rounds), 1)
    W = max((len(r) for r in rounds), default=1)
    elim = np.full((R, W), M, dtype=np.int64)
    par = np.full((R, W), M, dtype=np.int64)
    eidx = np.full((R, W), E, dtype=np.int64)
    valid = np.zeros((R, W), dtype=bool)
    for r, entries in enumerate(rounds):
        for i, (v, p, e) in enumerate(entries):
            elim[r, i] = v
            par[r, i] = p
            eidx[r, i] = e
            valid[r, i] = True

    dev = system.device
    return EliminationPlan(
        elim_nodes=torch.as_tensor(elim, device=dev),
        parents=torch.as_tensor(par, device=dev),
        edge_idx=torch.as_tensor(eidx, device=dev),
        valid=torch.as_tensor(valid, device=dev),
        core_nodes=torch.as_tensor(np.asarray(core, np.int64), device=dev),
        core_slot=torch.as_tensor(core_slot, device=dev),
        num_rounds=R, core_size=C)


def solve_laplacian_tree(system: FlowSystem, plan: EliminationPlan,
                         w, rhs):
    """Solve Laplacian(w) x = rhs exactly via the elimination plan.

    w: f[E] edge weights; rhs: f[M].  The Laplacian diagonal includes
    edges to fixed-pressure nodes (their unknowns were substituted into
    the rhs by the caller)."""
    M = system.num_unknown_pressures
    E = w.shape[0]
    dtype = w.dtype
    slot = system.node_unknown_index
    hu = slot[system.head]
    tu = slot[system.tail]

    # initial diagonal: all incident edge weights (fixed neighbors too)
    d = w.new_zeros(M + 1).index_add_(0, hu, w).index_add_(0, tu, w)[:M]
    d = torch.cat([d, w.new_ones(1)])                    # sentinel
    b = torch.cat([rhs.to(dtype), w.new_zeros(1)])
    w_pad = torch.cat([w, w.new_zeros(1)])

    # ---- forward elimination ----
    # every gather of a round reads the values from before the round's
    # scatter-adds (two leaves of one round may be each other's parent)
    for r in range(plan.num_rounds):
        ev, pv = plan.elim_nodes[r], plan.parents[r]
        val = plan.valid[r]
        wv = w_pad[plan.edge_idx[r]]
        dv = torch.where(val, d[ev], 1.0)
        factor = torch.where(val, wv / dv, 0.0)
        bv = b[ev]
        d.index_add_(0, pv, -factor * wv)
        b.index_add_(0, pv, factor * bv)

    # ---- core solve (loops) ----
    x = w.new_zeros(M + 1)
    if plan.core_size > 0:
        C = plan.core_size
        cs = plan.core_slot
        chu = cs[hu]
        ctu = cs[tu]
        both = (chu < C) & (ctu < C)
        wc = torch.where(both, w_pad[:E], 0.0)
        L = w.new_zeros((C + 1, C + 1))
        ar = torch.arange(C, device=w.device)
        # diagonal comes from the eliminated d values at core nodes
        L.index_put_((ar, ar), d[plan.core_nodes], accumulate=True)
        L.index_put_((chu, ctu), -wc, accumulate=True)
        L.index_put_((ctu, chu), -wc, accumulate=True)
        A = L[:C, :C]
        ridge = 1e-12 * torch.max(w) + 1e-30
        xc = torch.linalg.solve(
            A + torch.eye(C, dtype=dtype, device=w.device) * ridge,
            b[plan.core_nodes])
        x[plan.core_nodes] = xc

    # ---- back substitution ----
    for r in reversed(range(plan.num_rounds)):
        ev, pv = plan.elim_nodes[r], plan.parents[r]
        val = plan.valid[r]
        wv = w_pad[plan.edge_idx[r]]
        dv = torch.where(val, d[ev], 1.0)
        xv = (b[ev] + wv * x[pv]) / dv
        x[ev] = torch.where(val, xv, x[ev])
    return x[:M]
