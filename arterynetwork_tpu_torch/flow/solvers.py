"""Network flow solver (port of the JAX package's flow/solvers.py).

The reference solves the Hazen-Williams network by scipy ``basinhopping``
over BFGS on a magnified residual (fluidSimulation.py:1876-1878, 2268).
Here the system is solved exactly by damped Newton on the pressure
formulation:

With boundary pressures prescribed at entry and terminal nodes, the unknown
interior pressures ``p`` satisfy flow conservation

    r_n(p) = sum_in Q_e - sum_out Q_e = 0,
    Q_e    = sign(dP_e) * (A_e |dP_e|)^(1/k_e),   dP_e = p_head - p_tail

which is a monotone nonlinear resistive network: the Jacobian is a weighted
graph Laplacian, so damped Newton converges globally and the solution is
unique.

Linear-solver backends: ``dense`` (the assembled Laplacian +
``torch.linalg.solve``), ``tree`` (exact tree elimination,
flow/tree_solver.py) and ``cg`` (matrix-free conjugate gradient on the
diagonally scaled Laplacian, gather SpMV).  Every sum over a node's
edges runs in a fixed order (flow/segment_sum.py), so a solve gives the
same bits on every run on the card too.

One Newton implementation serves one system and T systems on one graph
(``solve_pressure_newton_batch``: the longitudinal timesteps, the JAX
package's ``vmap``).  Every row keeps its own semantics — its own line
search, stall test, iteration count and stop test — and a finished row
is frozen by a select while the others go on.  The line search
evaluates all its candidate steps (1, 1/2, ..., 2^-20) at once and takes
the first that improves, which is the step the sequential search takes.
So the host reads one flag per Newton step for the whole batch, and CG
reads its flags every ``_CG_CHECK_EVERY`` steps (frozen rows make the
extra steps no-ops).

The JAX package runs the whole solve as one device program (``jit``,
the Newton and line-search ``while_loop``s, CG's, the ``scan``s of the
restarts and the refinement).  Here each Newton step, CG block (with
its set-up and its end, the Newton step's head and tail) and
refinement step is written once, as a step that updates state made
before the loop in place and sets an int32 ``stop`` on the device, and
runs through ops/grow_loop.py: on a card a step's first run is eager,
its second is captured as a CUDA graph and later ones are replays (a
batch's LU runs eagerly between two graphs: ``lu_steps``); on the CPU
the same steps run eagerly.  The host reads the same flags either way,
through a pinned word on the card.  Restarts draw their scales eagerly
and replay the same graphs; the final flows run once, eagerly.

As ``jax.jit`` compiles a solve once per shape and static arguments,
the port keeps a solve's graphs across calls: every tensor a step reads
or writes lies in a cached entry (``_Solve``), one per key, in a cache
per device and thread (``_CACHE_SIZE`` entries, least recently used
evicted).  The key holds what shapes the captured work: T, N, M, E and
the padded edge count, the fields' dtypes, the linear solver after
"auto", ``max_iter``, ``tol`` (the captured stop test takes both as
numbers), ``refine_steps``, ``restarts``, the sizes of the edge-sum
plans and, for the tree route, the elimination plan's structure (the
rounds' count, width and ranges of distinct parents, the loop core's
size); and the loop route, ``grow_loop.loop_for`` itself, held in the
key.  No key holds a system or a plan: a call copies its system's
index tensors, plans and values into the entry (``load``) before any
step runs, so a re-solve with new radii, new boundary pressures or
another graph of the same sizes, in a new FlowSystem, hits.  On a hit
every step is a replay; a miss makes an entry and captures as above,
and, at the end of its call, each step that ran once (``GraphLoop.
capture_pending``).  A capture, replay or copy-in that fails raises and
drops the entry.  The results are new tensors, never an entry's.
``clear_solve_cache()`` empties the cache; ``solve_cache_info()`` and a
``SolveStats``' ``hits`` / ``misses`` count what it did.  On the CPU
the same entries run their steps eagerly.

Comparisons against Python constants keep the system's dtype (a Python
float meets an f32 tensor as f32), as the JAX reference's weak typing
does, so an f32 solve takes the same decisions.

The edge axis is padded inside the solve to a multiple of 64 with
inert edges (zero admittance, left out of the node sums), so that
on the CPU every edge's ``pow`` runs in torch's vectorized loop whatever
the batch size: a row of a batch then equals its unbatched solve bit for
bit (with one thread; the scalar tail loop rounds ``pow`` differently).
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import threading
from typing import NamedTuple, Optional

import torch

from ..ops import grow_loop
from .physics import edge_admittance, velocity_from_flow
from .segment_sum import edge_plan, segment_sum
from .system import FlowSystem
from .tree_solver import _core_plan, laplacian_tree_steps, lu_steps

_DP_EPS = 1e-9  # Pa; regularizes dQ/d(dP) at dP = 0
_LS_STEPS = 20  # line-search candidates 1, 1/2, ..., 2^-19 (alpha > 1e-6)
_CG_CHECK_EVERY = 16  # CG steps between host reads of the row flags
_EDGE_ALIGN = 64  # edge-axis padding of the Newton residual


class FlowSolution(NamedTuple):
    pressure: torch.Tensor       # f[N] full node pressures (Pa)
    flow: torch.Tensor           # f[E] signed flow, positive head->tail (m^3/s)
    velocity: torch.Tensor       # f[E] signed velocity (m/s)
    residual_norm: torch.Tensor  # scalar, max |net nodal flow| (m^3/s)
    iterations: int              # i32[T] tensor for a batch


@dataclasses.dataclass
class SolveStats:
    """Counters a caller may pass to a solve (``stats=``).

    ``host_reads``: device-to-host reads the solve made (flags and the
    final iteration count); ``linear_solves``: linear solves that ran
    (one per Newton and refinement step); ``cg_steps``: per-row CG
    iterations, summed over the CG solves (None until a CG solve ran);
    on a card, ``captures``: CUDA graphs captured, ``replays``: graph
    replays, ``capture_s``: seconds spent capturing; ``runs``: steps
    run, by key (eager or replayed); ``hits`` / ``misses``: solves that
    found their key in the cache of solves, or made an entry for it."""
    host_reads: int = 0
    linear_solves: int = 0
    cg_steps: Optional[torch.Tensor] = None
    captures: int = 0
    replays: int = 0
    capture_s: float = 0.0
    runs: dict = dataclasses.field(default_factory=dict)
    hits: int = 0
    misses: int = 0


def _two_sum(a, b):
    """Knuth error-free transform: a + b == s + err exactly in IEEE RN."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _signed_flow_and_weight(dp, adm, k):
    """Q(dp) and the linearization weight, both well-defined at dp=0.

    The weight is the SECANT conductance Q/dP, not the tangent dQ/d(dP):
    Hazen-Williams balances contain k-th-root modes (|x|^(1/k) with
    infinite slope at the root) on which tangent Newton oscillates forever
    at ratio |1-k|^(1/k), while the secant fixed point is exact on those
    modes and contracts at ~(1-1/k) on smooth ones."""
    mag = torch.clamp(torch.abs(dp), min=_DP_EPS)
    q_over_dp = adm ** (1.0 / k) * mag ** (1.0 / k - 1.0)
    q = q_over_dp * dp
    return q, q_over_dp


def _dense_laplacian_steps(system: FlowSystem, w, rhs, split=False):
    """Laplacian(w) x = rhs by LU, as part of a step that is a generator
    (``x = yield from ...``; ``split`` as for ``lu_steps``); w f[E] and
    rhs f[M], or f[T, E] and f[T, M] for T systems on one graph (weights
    beyond E ignored)."""
    if w.dim() == 1:
        x = yield from _dense_laplacian_steps(system, w[None], rhs[None],
                                              split)
        return x[0]
    M, E, T = system.num_unknown_pressures, system.num_edges, w.shape[0]
    w = w[:, :E]
    # L's nonzeros summed in the reference's order, then placed
    plan = edge_plan(system, "laplacian")
    L = w.new_zeros(T, M * M).index_copy_(1, plan.slots,
                                          segment_sum(plan, w))
    eye = torch.eye(M, dtype=w.dtype, device=w.device)
    A = (L.view(T, M, M)
         + eye * (1e-12 * w.amax(dim=1))[:, None, None])
    return (yield from lu_steps(A, rhs, split))


class _CG:
    """Matrix-free CG on the symmetrically diagonal-scaled Laplacian, on
    state made once for T rows: ``begin(w, rhs)`` sets a solve up,
    ``run(loop)`` takes its steps, ``result()`` is its solution.

    Explicit D^-1/2 L D^-1/2 scaling (rather than Jacobi preconditioning
    alone) keeps the iteration well-behaved in f32: Hazen-Williams tangent
    conductances span ~7 orders of magnitude across a deep arterial tree.

    The iteration is JAX's ``jax.scipy.sparse.linalg.cg`` (x0 = 0, no
    preconditioner): a row stops when gamma = r.r <= tol^2 b.b or after
    ``maxiter`` steps, so it takes the same steps, and is frozen by a
    select while the others go on.  The steps run in blocks of
    ``_CG_CHECK_EVERY`` (a block past ``maxiter`` changes nothing: a row
    still active has taken every step), and the host reads ``stop``
    (-1 while a row is active) after ``begin`` and after each block
    that ends before ``maxiter``."""

    def __init__(self, system: FlowSystem, T, dtype, tol=None, maxiter=None):
        M, E = system.num_unknown_pressures, system.num_edges
        if tol is None:
            # inexact Newton: loose inner solves converge better in f32
            tol = 1e-4 if dtype == torch.float32 else 1e-12
        if maxiter is None:
            maxiter = min(8 * M + 64, 192 if dtype == torch.float32 else 2048)
        self.tol, self.maxiter = tol, maxiter
        self.ridge = 1e-7 if dtype == torch.float32 else 1e-13
        self.system = system
        slot = system.node_unknown_index
        self.hu, self.tu = slot[system.head], slot[system.tail]
        self.diag = edge_plan(system, "diag")
        self.div = edge_plan(system, "div")
        dev = system.device
        self.w = torch.zeros(T, E, dtype=dtype, device=dev)
        self.dinv_sqrt, self.x, self.r, self.p = (
            torch.zeros(T, M, dtype=dtype, device=dev) for _ in range(4))
        # D^-1/2 and a 0 for the fixed nodes' slot M
        self.ds_pad = torch.zeros(T, M + 1, dtype=dtype, device=dev)
        self.zero = torch.zeros(T, 1, dtype=dtype, device=dev)
        self.gamma, self.atol2 = (torch.zeros(T, dtype=dtype, device=dev)
                                  for _ in range(2))
        self.k = torch.zeros(T, dtype=torch.int32, device=dev)
        self.stop = torch.zeros((), dtype=torch.int32, device=dev)

    def load(self):
        """The edges' unknown slots again, from the system's index
        tensors (a cached solve's, just copied in)."""
        slot = self.system.node_unknown_index
        self.hu.copy_(slot[self.system.head])
        self.tu.copy_(slot[self.system.tail])

    def begin(self, w, rhs):
        self.w.copy_(w[:, :self.w.shape[1]])
        diag = segment_sum(self.diag, self.w)
        self.dinv_sqrt.copy_(torch.rsqrt(torch.clamp(diag, min=1e-38)))
        self.ds_pad[:, :-1].copy_(self.dinv_sqrt)
        b = self.dinv_sqrt * rhs
        self.x.zero_()
        self.r.copy_(b)
        self.p.copy_(b)
        self.gamma.copy_((b * b).sum(dim=1))
        self.atol2.copy_(torch.clamp(self.tol ** 2 * (b * b).sum(dim=1),
                                     min=0.0))
        self.k.zero_()
        self._set_stop()

    def _active(self):
        return (self.gamma > self.atol2) & (self.k < self.maxiter)

    def _set_stop(self):
        self.stop.copy_(torch.where(self._active().any(), -1, 0))

    def _matvec(self, y):
        # x = D^-1/2 y; compute D^-1/2 L x
        xp = self.ds_pad * torch.cat([y, self.zero], dim=1)
        dx = xp.index_select(1, self.hu) - xp.index_select(1, self.tu)
        return (self.dinv_sqrt * segment_sum(self.div, self.w * dx)
                + self.ridge * y)

    def _step(self):
        active = self._active()
        x, r, p, gamma = self.x, self.r, self.p, self.gamma
        Ap = self._matvec(p)
        alpha = gamma / (p * Ap).sum(dim=1)
        x_new = x + alpha[:, None] * p
        r_new = r - alpha[:, None] * Ap
        gamma_new = (r_new * r_new).sum(dim=1)
        beta = gamma_new / gamma
        p_new = r_new + beta[:, None] * p
        keep = active[:, None]
        torch.where(keep, x_new, x, out=x)
        torch.where(keep, r_new, r, out=r)
        torch.where(keep, p_new, p, out=p)
        torch.where(active, gamma_new, gamma, out=gamma)
        self.k.add_(active)

    def block(self):
        for _ in range(_CG_CHECK_EVERY):
            self._step()
        self._set_stop()

    def run(self, loop):
        n = 0
        while n < self.maxiter and loop.read(self.stop) < 0:
            loop.run("cg block", self.block)
            n += _CG_CHECK_EVERY

    def result(self, steps=None):
        """The solution; adds each row's steps to ``steps``, if given."""
        if steps is not None:
            steps.add_(self.k)
        return self.dinv_sqrt * self.x


def _cg_laplacian_solve(system: FlowSystem, w, rhs, tol=None, maxiter=None,
                        stats: Optional[SolveStats] = None):
    """Laplacian(w) x = rhs by ``_CG``, on its own: w f[E] and rhs f[M],
    or f[T, E] and f[T, M]."""
    if w.dim() == 1:
        return _cg_laplacian_solve(system, w[None], rhs[None], tol, maxiter,
                                   stats)[0]
    T = w.shape[0]
    cg = _CG(system, T, w.dtype, tol, maxiter)
    loop = grow_loop.loop_for(system.device)
    with loop.stream():
        cg.begin(w, rhs)
        cg.run(loop)
    steps = torch.zeros(T, dtype=torch.int32, device=w.device)
    x = cg.result(steps)
    if stats is not None:
        _add_loop_counts(stats, loop)
        stats.cg_steps = (steps if stats.cg_steps is None
                          else stats.cg_steps + steps)
    return x


def _add_loop_counts(stats: SolveStats, loop):
    stats.host_reads += loop.reads
    stats.captures += loop.captures
    stats.replays += loop.replays
    stats.capture_s += loop.capture_s
    for key, n in loop.runs.items():
        stats.runs[key] = stats.runs.get(key, 0) + n


def _cached_plans(system: FlowSystem, plan):
    """What the solve's plan caches hold: the system's and the
    elimination plan's plans, and each plan's signs by dtype."""
    plans = [p for s in ([system.plans] if plan is None
                         else [system.plans, plan.plans])
             for _, p in s.values()]
    return plans + [t for p in plans for t in p.signs.values()]


def _as_batch(system: FlowSystem) -> FlowSystem:
    """A one-row batch of an unbatched system."""
    return dataclasses.replace(
        system, node_fixed_pressure=system.node_fixed_pressure[None],
        **{f: getattr(system, f)[None]
           for f in ("radius_m", "length_m", "c", "k")})


def solve_pressure_newton(
    system: FlowSystem,
    p_init: torch.Tensor | None = None,
    max_iter: int = 60,
    tol: float = 1e-14,
    linear_solver: str = "dense",
    plan=None,
    refine_steps: int | None = None,
    restarts: int = 0,
    stats: Optional[SolveStats] = None,
) -> FlowSolution:
    """Damped Newton solve for interior pressures, then flows/velocities.

    ``tol`` is on the max nodal flow imbalance in m^3/s.

    ``restarts``: bounded multi-start escape (the reference's
    basinhopping slot): when the primary solve stalls above the dtype's
    stall floor, up to this many re-solves from randomly rescaled inits
    run and the best-residual basin wins.  The rescalings come from a
    ``torch.Generator`` seeded with ``restarts`` (the JAX reference seeds
    its key the same way; the two generators give different numbers).

    ``refine_steps`` appends compensated (double-single) Newton
    iterations after convergence: pressures are carried as an exact
    hi+lo pair and the edge pressure drops are formed with error-free
    two-sum transforms, so the residual — and therefore the correction —
    is resolved below the f32 rounding floor where plain f32 Newton
    stalls.  Default: 2 steps for f32 systems, 0 for f64.
    """
    sol = _newton(_as_batch(system), None if p_init is None else p_init[None],
                  max_iter, tol, linear_solver, plan, refine_steps, restarts,
                  stats)
    it = int(sol.iterations[0])
    if stats is not None:
        stats.host_reads += 1
    return FlowSolution(pressure=sol.pressure[0], flow=sol.flow[0],
                        velocity=sol.velocity[0],
                        residual_norm=sol.residual_norm[0], iterations=it)


def solve_pressure_newton_batch(
    system: FlowSystem,
    max_iter: int = 60,
    tol: float = 1e-14,
    linear_solver: str = "dense",
    plan=None,
    refine_steps: int | None = None,
    restarts: int = 0,
    stats: Optional[SolveStats] = None,
) -> FlowSolution:
    """``solve_pressure_newton`` for T systems on one graph at once.

    ``system.node_fixed_pressure`` is f[T, N]; ``radius_m``, ``length_m``,
    ``c`` and ``k`` are f[T, E] or f[E] (shared).  Each row ends where its
    own unbatched solve ends (the JAX package's ``vmap``).  Returns a
    FlowSolution of stacked rows, with ``iterations`` an i32[T] tensor.
    ``restarts`` must be 0, as for the JAX package's batched callers."""
    if restarts:
        raise ValueError("restarts must be 0 on the batched path")
    return _newton(system, None, max_iter, tol, linear_solver, plan,
                   refine_steps, 0, stats)


# the flow solves' cache: per device and thread, at most this many
# entries, the least recently used evicted.  A study alternates between
# at most two keys on one network (its unbatched solves and a T-row
# batch); a comparison of the graph-driven solve with the eager loop
# doubles that, and 8 leaves room for two networks.
_CACHE_SIZE = 8
_cache = threading.local()
_cache_counts = {"hits": 0, "misses": 0, "evictions": 0}

# the fields of a FlowSystem that the steps read, copied into an entry;
# those they never read, left empty there; the elimination plan's
# tensors, copied
_GRAPH_FIELDS = ("head", "tail", "node_unknown_index", "node_fixed")
_UNREAD_FIELDS = ("radius_m", "length_m", "c", "k", "node_fixed_pressure",
                  "node_arg", "conserve_nodes", "bc_edge", "bc_velocity",
                  "node_depth")
_VALUE_FIELDS = ("radius_m", "length_m", "c", "k", "node_fixed_pressure")
_PLAN_FIELDS = ("elim_nodes", "parents", "edge_idx", "valid", "core_nodes",
                "core_slot")
# the edge sums each linear solver's steps take, besides "net"
_SUM_KINDS = {"dense": ("laplacian",), "tree": ("diag",),
              "cg": ("diag", "div")}


def _entries(device):
    """This thread's cached solves on ``device``, least recent first."""
    by_device = _cache.__dict__.setdefault("by_device", {})
    return by_device.setdefault(str(device), collections.OrderedDict())


def _drop(entries, key):
    entry = entries.pop(key, None)
    if entry is not None:
        entry.loop.close()      # once its side stream has finished


def clear_solve_cache(device=None):
    """Drop this thread's cached flow solves on ``device`` (a
    torch.device or a string), or on every device: the next solve of
    each key captures its graphs anew."""
    by_device = _cache.__dict__.get("by_device", {})
    for name in list(by_device) if device is None else [str(device)]:
        entries = by_device.get(name, {})
        for key in list(entries):
            _drop(entries, key)


grow_loop.release_hooks.append(clear_solve_cache)


def solve_cache_info():
    """The flow solves' cache: hits, misses and evictions since the
    process started, and this thread's entries by device."""
    return {**_cache_counts,
            "entries": {d: len(e) for d, e in
                        _cache.__dict__.get("by_device", {}).items()}}


def _sum_key(plan):
    """What shapes a captured segment sum: the plan's sizes."""
    return (plan.num_sources, plan.depth, plan.width, plan.sign is None,
            plan.slots is None)


def _plan_key(system, plan):
    """What shapes the captured tree elimination: the rounds' count and
    width, each round's ranges of distinct parents and the loop core's
    size and sum."""
    return (tuple(plan.parents.shape), plan.core_size,
            tuple(tuple((a, z) for a, z, _ in r[4]) for r in plan.rounds),
            _sum_key(_core_plan(system, plan)) if plan.core_size else None)


def _clone_sum(plan):
    return dataclasses.replace(
        plan, table=plan.table.clone(), signs={},
        sign=None if plan.sign is None else plan.sign.clone(),
        slots=None if plan.slots is None else plan.slots.clone())


def _copy_sum(dst, src):
    """``src``'s entries into ``dst``, a plan of the same sizes, and into
    the signs ``dst`` keeps by dtype."""
    dst.table.copy_(src.table)
    if dst.sign is not None:
        dst.sign.copy_(src.sign)
        for sign in dst.signs.values():
            sign.copy_(src.sign)
    if dst.slots is not None:
        dst.slots.copy_(src.slots)


class _Solve:
    """A cached solve, the counterpart of one executable in the JAX
    jit's cache: every tensor its steps read or write, the steps, which
    read nothing else, and the loop that keeps their graphs.  ``load``
    copies a call's system in; ``run`` solves from an initial guess."""

    def __init__(self, key, system: FlowSystem, plan, T, dtype, max_iter,
                 tol, linear_solver, k, adm, fixed):
        dev = system.device
        M, E = system.num_unknown_pressures, system.num_edges
        self.key, self.T, self.M, self.E = key, T, M, E
        self.dtype, self.max_iter, self.tol = dtype, max_iter, tol
        # the system the steps see: its index tensors and plans copied,
        # the fields no step reads empty
        self.sys = dataclasses.replace(
            system, plans={},
            **{f: getattr(system, f).clone() for f in _GRAPH_FIELDS},
            **{f: getattr(system, f).new_empty(0) for f in _UNREAD_FIELDS})
        owners = (self.sys.head, self.sys.tail, self.sys.node_unknown_index)
        self.kinds = ("net",) + _SUM_KINDS[linear_solver]
        for kind in self.kinds:
            self.sys.plans[(kind, str(dev))] = (
                owners, _clone_sum(edge_plan(system, kind)))
        self.plan = None
        if plan is not None:
            self.plan = dataclasses.replace(
                plan, **{f: getattr(plan, f).clone() for f in _PLAN_FIELDS})
            if plan.core_size:
                self.plan.plans[("core", str(dev))] = (
                    owners, _clone_sum(_core_plan(system, plan)))
        self.net = edge_plan(self.sys, "net")   # inflow - outflow
        # edge fields as [T, Ep]; pad edges join node 0 to itself with
        # zero admittance, and the node sums read the first E edges only
        Ep = k.shape[1]
        self.head, self.tail = (torch.zeros(Ep, dtype=torch.int64,
                                            device=dev) for _ in range(2))
        self.k, self.adm, self.inv_k = (torch.zeros_like(k),
                                        torch.zeros_like(adm),
                                        torch.zeros_like(k))
        self.fixed = torch.zeros_like(fixed)
        # the line search's candidate steps, alpha = 2^-j, j = 0..20 (the
        # last is where the sequential search ends when nothing improves)
        self.alphas = torch.tensor([0.5 ** j for j in range(_LS_STEPS + 1)],
                                   dtype=dtype, device=dev)
        self.rows = torch.arange(T, device=dev)
        # the state one step hands to the next, written in place:
        # pressures (and their low part in the refinement), residual
        # norm, iterations, stalled rows, the residual norm before the
        # step and stop (-1 while a row is active); CG's steps per row
        self.p, self.p_lo = (torch.zeros(T, M, dtype=dtype, device=dev)
                             for _ in range(2))
        self.rn, self.rn0 = (torch.zeros(T, dtype=dtype, device=dev)
                             for _ in range(2))
        self.it = torch.zeros(T, dtype=torch.int32, device=dev)
        self.stalled = torch.zeros(T, dtype=torch.bool, device=dev)
        self.stop = torch.zeros((), dtype=torch.int32, device=dev)
        self.cg_steps = torch.zeros(T, dtype=torch.int32, device=dev)
        self.cg = (_CG(self.sys, T, dtype) if linear_solver == "cg"
                   else None)
        self.solves = 0             # linear solves run in the call
        self.done = None            # the last call's end, on a card
        # each step once: with CG a head and a tail (CG's blocks between)
        self.steps = {}
        for name, head, tail in (
                ("newton", self.newton_head, self.newton_tail),
                ("refine", self.refine_head, self.refine_tail)):
            if self.cg is None:
                self.steps[name] = self._linear_step(head, tail)
            else:
                self.steps[name + " head"] = functools.partial(
                    self._cg_head, head)
                self.steps[name + " tail"] = functools.partial(
                    self._cg_tail, tail)
        self.loop = grow_loop.loop_for(
            dev, [(self, "solves")],
            lambda: _cached_plans(self.sys, self.plan), keep=True)

    def load(self, system: FlowSystem, plan, k, adm, fixed):
        """Copy a call's system (of this entry's key) in, before any step
        of the call runs."""
        if self.done is not None:       # the last call's reads, on a card
            torch.cuda.current_stream(self.p.device).wait_event(self.done)
        for f in _GRAPH_FIELDS:
            getattr(self.sys, f).copy_(getattr(system, f))
        dev = str(self.p.device)
        for kind in self.kinds:
            _copy_sum(self.sys.plans[(kind, dev)][1], edge_plan(system, kind))
        if self.plan is not None:
            for f in _PLAN_FIELDS:
                getattr(self.plan, f).copy_(getattr(plan, f))
            for mine, theirs in zip(self.plan.rounds, plan.rounds):
                for a, b in zip(mine[:4], theirs[:4]):
                    a.copy_(b)
                for (_, _, a), (_, _, b) in zip(mine[4], theirs[4]):
                    a.copy_(b)
            if plan.core_size:
                _copy_sum(self.plan.plans[("core", dev)][1],
                          _core_plan(system, plan))
        self.head[:self.E].copy_(system.head)
        self.tail[:self.E].copy_(system.tail)
        self.k.copy_(k)
        self.adm.copy_(adm)
        self.inv_k.copy_(1.0 / k)
        self.fixed.copy_(fixed)
        if self.cg is not None:
            self.cg.load()
        self.cg_steps.zero_()

    def full(self, p, fixed):
        pad = p.new_zeros(p.shape[:-1] + (1,))
        return torch.where(self.sys.node_fixed, fixed, torch.cat(
            [p, pad], dim=-1).index_select(-1, self.sys.node_unknown_index))

    def full_lo(self, p_lo):
        return self.full(p_lo, torch.zeros((), dtype=self.dtype,
                                           device=p_lo.device))

    def node_residual(self, p, fixed, adm, k):
        """Net inflow at the unknown nodes of p [..., M], and the edges'
        flows and secant weights."""
        pf = self.full(p, fixed)
        dp = pf.index_select(-1, self.head) - pf.index_select(-1, self.tail)
        q, w = _signed_flow_and_weight(dp, adm, k)
        return segment_sum(self.net, q), q, w

    def ds_residual(self, p_hi, p_lo):
        """Residual with the pressure drop formed error-free."""
        head, tail, inv_k = self.head, self.tail, self.inv_k
        pf_hi = self.full(p_hi, self.fixed)
        pf_lo = self.full_lo(p_lo)
        s, e = _two_sum(pf_hi[:, head], -pf_hi[:, tail])
        e = e + (pf_lo[:, head] - pf_lo[:, tail])
        mag = torch.clamp(torch.abs(s), min=_DP_EPS)
        w = self.adm ** inv_k * mag ** (inv_k - 1.0)
        q_hi = w * s
        q_lo = (w * inv_k) * e   # first order: dq/d(dp) = w/k
        return (segment_sum(self.net, q_hi)
                + segment_sum(self.net, q_lo)), w

    def newton_active(self):
        return (self.rn > self.tol) & (self.it < self.max_iter) & ~self.stalled

    def set_stop(self):
        self.stop.copy_(torch.where(self.newton_active().any(), -1, 0))

    def newton_head(self):
        self.solves += 1
        r, _, w = self.node_residual(self.p, self.fixed, self.adm, self.k)
        self.rn0.copy_(r.abs().amax(dim=-1))
        # r = inflow - outflow, so dr/dp = -Laplacian(w); the update
        # direction solves Laplacian(w) step = +r.
        return w, r

    def newton_tail(self, step):
        p, rn, stalled, rows = self.p, self.rn, self.stalled, self.rows
        active = self.newton_active()
        cand = p[:, None, :] + self.alphas[None, :, None] * step[:, None, :]
        rn_c = self.node_residual(cand, self.fixed[:, None],
                                  self.adm[:, None],
                                  self.k[:, None])[0].abs().amax(dim=-1)
        good = rn_c[:, :_LS_STEPS] < self.rn0[:, None]
        improved = good.any(dim=1)
        first = torch.where(improved, good.to(torch.uint8).argmax(dim=1),
                            _LS_STEPS)
        rn_new = rn_c[rows, first]
        # stalled: the line search found no improving step (numerical
        # floor reached) — stop instead of burning iterations
        stalled_new = ~improved | (rn_new >= self.rn0 * (1.0 - 1e-6))
        torch.where(active[:, None], cand[rows, first], p, out=p)
        torch.where(active, rn_new, rn, out=rn)
        torch.where(active, stalled_new, stalled, out=stalled)
        self.it.add_(active)
        self.set_stop()

    def refine_head(self):
        self.solves += 1
        r, w = self.ds_residual(self.p, self.p_lo)
        # tangent weight dq/d(dp) = w/k: at the converged point no
        # k-th-root modes are active, so these steps contract
        # quadratically instead of at the secant ~(1-1/k) rate
        return w * self.inv_k, r

    def refine_tail(self, step):
        hi, err = _two_sum(self.p, step)
        lo = self.p_lo + err
        hi, lo = _two_sum(hi, lo)       # renormalize the pair
        self.p.copy_(hi)
        self.p_lo.copy_(lo)

    def _linear_step(self, head, tail):
        """A step with a direct linear solve: ``head()`` -> (w, rhs), the
        solve (a batch's LU between two graphs), ``tail(x)``."""
        split = self.T > 1

        def step():
            w, rhs = head()
            if self.plan is not None:
                x = yield from laplacian_tree_steps(self.sys, self.plan, w,
                                                    rhs, split)
            else:
                x = yield from _dense_laplacian_steps(self.sys, w, rhs,
                                                      split)
            tail(x)
        return step

    def _cg_head(self, head):
        self.cg.begin(*head())

    def _cg_tail(self, tail):
        tail(self.cg.result(self.cg_steps))

    def iterate(self, name):
        """One step with a linear solve; with CG its head, CG's blocks
        and its tail."""
        if self.cg is None:
            self.loop.run(name, self.steps[name])
        else:
            self.loop.run(name + " head", self.steps[name + " head"])
            self.cg.run(self.loop)
            self.loop.run(name + " tail", self.steps[name + " tail"])

    def solve_from(self, p0):
        """Newton with a backtracking line search on the residual norm,
        every row on its own, from p0 -> the state above."""
        self.p.copy_(p0)
        self.rn.copy_(self.node_residual(self.p, self.fixed, self.adm,
                                         self.k)[0].abs().amax(dim=-1))
        self.it.zero_()
        self.stalled.zero_()
        self.set_stop()
        while self.loop.read(self.stop) < 0:
            self.iterate("newton")

    def run(self, p_init, restarts, refine_steps):
        """The solve from ``p_init``, its restarts and its refinement
        steps, in the loop; the loop's counts are the call's."""
        p, rn, it, loop = self.p, self.rn, self.it, self.loop
        loop.reset_counts()
        self.solves = 0
        p.copy_(p_init)
        self.p_lo.zero_()
        rn.zero_()
        it.zero_()
        self.stalled.zero_()
        with loop.stream():
            if self.M > 0:
                self.solve_from(p_init)

            if restarts and self.M > 0:
                # Multi-start escape — the robustness slot the reference
                # fills with scipy basinhopping (fluidSimulation.py:
                # 1746-1752, 1876-1878).  The trigger sits above the
                # dtype's normal stall floor, so a healthy solve never
                # pays a restart.
                trigger = max(self.tol, 1e-8 if self.dtype == torch.float32
                              else 1e-12)
                gen = torch.Generator(device=p.device)
                gen.manual_seed(int(restarts))
                best_p, best_rn, best_it = p.clone(), rn.clone(), it.clone()
                for _ in range(restarts):
                    stuck = best_rn > trigger
                    if not loop.read(stuck.any().to(torch.int32)):
                        continue
                    scale = torch.rand(p_init.shape, generator=gen,
                                       dtype=self.dtype,
                                       device=p.device) + 0.5
                    self.solve_from(p_init * scale)
                    better = stuck & (rn < best_rn)
                    best_p = torch.where(better[:, None], p, best_p)
                    best_rn = torch.where(better, rn, best_rn)
                    best_it = best_it + torch.where(stuck, it, 0)
                p.copy_(best_p)
                rn.copy_(best_rn)
                it.copy_(best_it)

            for _ in range(refine_steps):
                self.iterate("refine")
            loop.capture_pending()


def _entry(system: FlowSystem, plan, T, dtype, max_iter, tol, linear_solver,
           refine_steps, restarts, k, adm, fixed, stats):
    """The cached solve of this call's key, made on a miss.  The key is
    what the JAX jit keys on: every shape and dtype of the entry's
    tensors, the plans' sizes, the elimination plan's structure and the
    static options, ``tol`` and ``max_iter`` too, as the captured
    kernels take them as numbers; and the loop route
    (``grow_loop.loop_for``, held in the key)."""
    kinds = ("net",) + _SUM_KINDS[linear_solver]
    key = (grow_loop.loop_for, T, system.num_nodes,
           system.num_unknown_pressures, system.num_edges, k.shape[1],
           tuple(getattr(system, f).dtype for f in _VALUE_FIELDS),
           linear_solver, max_iter, tol, refine_steps, restarts,
           tuple(_sum_key(edge_plan(system, kind)) for kind in kinds),
           None if plan is None else _plan_key(system, plan))
    entries = _entries(system.device)
    entry = entries.get(key)
    hit = entry is not None
    if hit:
        entries.move_to_end(key)
    else:
        entry = entries[key] = _Solve(key, system, plan, T, dtype, max_iter,
                                      tol, linear_solver, k, adm, fixed)
        while len(entries) > _CACHE_SIZE:
            _drop(entries, next(iter(entries)))
            _cache_counts["evictions"] += 1
    _cache_counts["hits" if hit else "misses"] += 1
    if stats is not None:
        stats.hits += hit
        stats.misses += not hit
    return entry


def _newton(system: FlowSystem, p_init, max_iter, tol, linear_solver, plan,
            refine_steps, restarts, stats) -> FlowSolution:
    fp = system.node_fixed_pressure
    T = fp.shape[0]
    dtype = system.radius_m.dtype
    device = system.device
    M = system.num_unknown_pressures
    E = system.num_edges
    Ep = -(-(E + 1) // _EDGE_ALIGN) * _EDGE_ALIGN
    fixed_mask = system.node_fixed
    slot = system.node_unknown_index

    # edge fields as [T, Ep]; pad edges join node 0 to itself with zero
    # admittance, and the node sums read the first E edges only
    def edges(x, value):
        x = x.expand(T, E) if x.dim() == 1 else x
        return torch.cat([x, x.new_full((T, Ep - E), value)], dim=1)

    radius = edges(system.radius_m, 1.0)
    k = edges(system.k, 1.0)
    adm = edge_admittance(radius, edges(system.length_m, 1.0),
                          edges(system.c, 0.0), k)

    # Shift pressures to drop-from-reference variables, per row: edge dP
    # values can be 1e6x smaller than absolute pressures, so subtracting
    # a reference before the solve removes most of the f32 cancellation
    # error.
    inf = float("inf")
    p_ref = 0.5 * (torch.where(fixed_mask, fp, -inf).amax(dim=1)
                   + torch.where(fixed_mask, fp, inf).amin(dim=1))
    fixed = torch.where(fixed_mask, fp - p_ref[:, None], 0.0).to(dtype)

    if p_init is None:
        # Depth-interpolated initial guess (reference init style,
        # fluidSimulation.py:1852): pressures fall linearly with depth from
        # the max to the min prescribed boundary pressure of the row.
        hi = torch.where(fixed_mask, fixed, -inf).amax(dim=1, keepdim=True)
        lo = torch.where(fixed_mask, fixed, inf).amin(dim=1, keepdim=True)
        depth = system.node_depth.to(dtype)
        frac = depth / torch.clamp(depth.max(), min=1.0)
        p_by_depth = hi + (lo - hi) * frac
        # unknowns in node order; fixed nodes land in the dropped slot M
        p_init = p_by_depth.new_zeros(T, M + 1)
        p_init[:, slot] = p_by_depth
        p_init = p_init[:, :M]
    else:
        p_init = p_init - p_ref[:, None]
    p_init = p_init.to(dtype)

    if linear_solver == "auto":
        # tree elimination is exact and O(depth) when a plan is given;
        # dense LU up to a few thousand unknowns; the matrix-free CG
        # scales beyond
        if plan is not None:
            linear_solver = "tree"
        else:
            linear_solver = "dense" if M <= 4096 else "cg"
    if linear_solver == "tree":
        if plan is None:
            raise ValueError("linear_solver='tree' needs an EliminationPlan "
                             "(flow.tree_solver.plan_elimination)")
    elif linear_solver not in ("dense", "cg"):
        raise ValueError(f"unknown linear_solver {linear_solver!r}")
    else:
        plan = None

    if refine_steps is None:
        refine_steps = 2 if dtype == torch.float32 else 0
    refine = bool(refine_steps) and M > 0

    entry = _entry(system, plan, T, dtype, max_iter, tol, linear_solver,
                      refine_steps, restarts, k, adm, fixed, stats)
    try:
        entry.load(system, plan, k, adm, fixed)
        entry.run(p_init, restarts, refine_steps if refine else 0)
    except BaseException:
        # a failed capture, replay or copy-in raises; the entry goes
        try:
            _drop(_entries(device), entry.key)
        except RuntimeError:            # the error above is the one
            pass                        # to report
        raise

    # the results are new tensors: a later solve writes the entry again
    if stats is not None:
        _add_loop_counts(stats, entry.loop)
        stats.linear_solves += entry.solves
        if entry.cg is not None and entry.solves:
            stats.cg_steps = (entry.cg_steps.clone()
                              if stats.cg_steps is None
                              else stats.cg_steps + entry.cg_steps)
    p, p_lo, head, tail = entry.p, entry.p_lo, entry.head, entry.tail
    rn = (entry.ds_residual(p, p_lo)[0].abs().amax(dim=1) if refine
          else entry.rn.clone())
    p_full = entry.full(p, entry.fixed)
    dp = p_full[:, head] - p_full[:, tail]
    if refine:
        pf_lo = entry.full_lo(p_lo)
        s, e = _two_sum(p_full[:, head], -p_full[:, tail])
        dp = s + (e + (pf_lo[:, head] - pf_lo[:, tail]))
    q, _ = _signed_flow_and_weight(dp, entry.adm, entry.k)
    v = velocity_from_flow(q, radius)
    it = entry.it.clone()
    if device.type == "cuda":
        entry.done = torch.cuda.Event()
        entry.done.record()
    return FlowSolution(pressure=p_full + p_ref[:, None], flow=q[:, :E],
                        velocity=v[:, :E], residual_norm=rn, iterations=it)


def solve_poiseuille(system: FlowSystem,
                     linear_solver: str = "dense") -> FlowSolution:
    """Exact linear solve for k=1 networks (one Newton step suffices)."""
    return solve_pressure_newton(system, max_iter=3,
                                 linear_solver=linear_solver)
