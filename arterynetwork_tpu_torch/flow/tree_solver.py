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
gathers and ``index_add_`` on the system's device; on a card the Newton
step that holds them is captured once as a CUDA graph and replayed
(flow/solvers.py), the counterpart of the JAX package's ``lax.scan``
over the rounds.

Two leaves of one round may share a parent, and ``index_add_`` with a
repeated index adds in no fixed order on a card.  So each round's
entries are reordered (``EliminationPlan.rounds``): the first leaf of
every parent, then the second, and so on, and each group goes in with
its own ``index_add_``, whose indices are distinct.  A parent then takes
its leaves' terms in the order of the round, as the CPU's ``index_add_``
of the whole round adds them, and the result is the same bits on every
device and run.  The other sums (the diagonal, the loop core's
Laplacian) use flow/segment_sum.py.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.grow_loop import run_eagerly
from .segment_sum import cached, edge_plan, plan_segment_sum, segment_sum
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
    # per round: (elim, parents, edge_idx, valid) in the order leaf rank
    # by parent, then per rank its range [a, z) and parents[a:z] (< M)
    rounds: tuple = dataclasses.field(init=False, compare=False,
                                      repr=False)
    plans: dict = dataclasses.field(init=False, compare=False, repr=False)

    def __post_init__(self):
        M = self.core_slot.shape[0] - 1
        par = self.parents.cpu().numpy()
        valid = self.valid.cpu().numpy()
        rounds = []
        for r in range(self.num_rounds):
            live = valid[r] & (par[r] < M)
            rank = np.zeros(par.shape[1], np.int64)
            seen = {}
            for i in np.nonzero(live)[0]:
                rank[i] = seen.get(par[r, i], 0)
                seen[par[r, i]] = rank[i] + 1
            # live entries by rank, then the rest (isolated leaves add
            # only zeros to the dropped slot M, padding likewise)
            key = np.where(live, rank, par.shape[1])
            order = torch.as_tensor(np.argsort(key, kind="stable"),
                                    device=self.parents.device)
            counts = np.bincount(rank[live], minlength=1)
            ends = np.cumsum(counts)
            fields = tuple(f[r].index_select(0, order) for f in (
                self.elim_nodes, self.parents, self.edge_idx, self.valid))
            parts = tuple((int(a), int(z), fields[1][a:z].contiguous())
                          for a, z in zip(ends - counts, ends) if z > a)
            rounds.append(fields + (parts,))
        object.__setattr__(self, "rounds", tuple(rounds))
        object.__setattr__(self, "plans", {})


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


def lu_steps(A, b, split=False):
    """A x = b by LU (``torch.linalg.solve_ex``: no host sync on an
    error), as part of a step that is a generator (ops/grow_loop.py):
    ``x = yield from lu_steps(A, b, split)``.

    ``split``: the LU is yielded, to run eagerly between the graphs of
    the step's parts before and after it.  A CUDA graph captures an
    unbatched LU (cuSOLVER's) but not the batched one that torch takes
    for a few hundred unknowns or more (MAGMA's; on an H100 with torch
    2.11, T = 3 and 8 rows of 513 unknowns were refused, of 100
    captured)."""
    if not split:
        return torch.linalg.solve_ex(A, b)[0]
    x = torch.empty_like(b)
    yield lambda: x.copy_(torch.linalg.solve_ex(A, b)[0])
    return x


def solve_laplacian_tree(system: FlowSystem, plan: EliminationPlan,
                         w, rhs):
    """Solve Laplacian(w) x = rhs exactly via the elimination plan.

    w: f[E] edge weights; rhs: f[M] — or f[T, E] / f[T, M] for T
    independent systems on one graph, solved together (each row as it
    would be alone).  Entries of w beyond the system's E edges are
    ignored.  The Laplacian diagonal includes edges to fixed-pressure
    nodes (their unknowns were substituted into the rhs by the caller)."""
    return run_eagerly(laplacian_tree_steps(system, plan, w, rhs))


def laplacian_tree_steps(system: FlowSystem, plan: EliminationPlan, w, rhs,
                         split=False):
    """``solve_laplacian_tree`` as part of a step that is a generator:
    ``x = yield from laplacian_tree_steps(...)``; ``split`` as for
    ``lu_steps`` (the loop core's LU)."""
    if w.dim() == 1:
        x = yield from laplacian_tree_steps(system, plan, w[None],
                                            rhs[None], split)
        return x[0]
    M = system.num_unknown_pressures
    E = system.num_edges
    T = w.shape[0]
    dtype = w.dtype
    w = w[:, :E]

    # initial diagonal: all incident edge weights (fixed neighbors too),
    # and the sentinel 1 at slot M; pivots and right-hand sides go
    # through the rounds together as the rows of db = [d; b] ([2T, M+1]:
    # one gather and one index_add_ serve both)
    d = F.pad(segment_sum(edge_plan(system, "diag"), w), (0, 1), value=1.0)
    db = torch.cat([d, F.pad(rhs.to(dtype), (0, 1))])
    w_pad = F.pad(w, (0, 1))

    # ---- forward elimination ----
    # every gather of a round reads the values from before the round's
    # scatter-adds (two leaves of one round may be each other's parent);
    # index_select costs the host half of what x[:, idx] does
    for ev, pv, eidx, val, parts in plan.rounds:
        wv = w_pad.index_select(1, eidx)
        dbv = db.index_select(1, ev)
        dv = torch.where(val, dbv[:T], 1.0)
        factor = torch.where(val, wv / dv, 0.0)
        upd = (factor * torch.stack([-wv, dbv[T:]])).view(2 * T, -1)
        for a, z, parents in parts:
            db.index_add_(1, parents, upd[:, a:z])

    # ---- core solve (loops) ----
    x = w.new_zeros(T, M + 1)
    if plan.core_size > 0:
        C = plan.core_size
        core = _core_plan(system, plan)
        # diagonal from the eliminated d values at core nodes, then the
        # loop edges, summed in edge order
        dcore = db[:T].index_select(1, plan.core_nodes)
        L = w.new_zeros(T, C * C).index_copy_(
            1, core.slots, segment_sum(core, torch.cat([dcore, w], dim=1)))
        ridge = 1e-12 * w.amax(dim=1) + 1e-30
        eye = torch.eye(C, dtype=dtype, device=w.device)
        xc = yield from lu_steps(L.view(T, C, C) + eye * ridge[:, None,
                                                               None],
                                 db[T:].index_select(1, plan.core_nodes),
                                 split)
        x[:, plan.core_nodes] = xc

    # ---- back substitution ----
    for ev, pv, eidx, val, _ in reversed(plan.rounds):
        wv = w_pad.index_select(1, eidx)
        dbv = db.index_select(1, ev)
        dv = torch.where(val, dbv[:T], 1.0)
        xv = (dbv[T:] + wv * x.index_select(1, pv)) / dv
        x.index_copy_(1, ev, torch.where(val, xv, x.index_select(1, ev)))
    return x[:, :M]


def _core_plan(system: FlowSystem, plan: EliminationPlan):
    """The loop core's Laplacian on the C x C grid as a sparse sum over
    [d at the core nodes (C), the edge weights (E)]: + d on the diagonal,
    then - w at (h, t) and at (t, h) for edges within the core."""
    C, E = plan.core_size, system.num_edges

    def build():
        cs = plan.core_slot.cpu().numpy()
        slot = system.node_unknown_index.cpu().numpy()
        ch = cs[slot[system.head.cpu().numpy()]]
        ct = cs[slot[system.tail.cpu().numpy()]]
        both = (ch < C) & (ct < C)
        ar = np.arange(C)
        edges = C + np.arange(E)
        return plan_segment_sum(
            np.concatenate([ar * (C + 1), np.where(both, ch * C + ct, -1),
                            np.where(both, ct * C + ch, -1)]),
            np.concatenate([ar, edges, edges]), C * C, C + E,
            sign=np.repeat([1, -1, -1], [C, E, E]), dense=False,
            device=system.device)

    return cached(plan.plans, ("core", str(system.device)),
                  (system.head, system.tail, system.node_unknown_index),
                  build)
