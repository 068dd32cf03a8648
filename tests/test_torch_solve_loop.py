"""The flow solver's loops (flow/solvers.py on ops/grow_loop.py) on the
CPU.

The solver writes each Newton step, CG block and refinement step once,
as steps that update buffers made before the loop in place, and runs
them through ``grow_loop.loop_for``: replayed from captured CUDA graphs
on a card, eagerly here.  Held here, on two merge-loop networks (depth 4,
15 unknowns, and depth 6, 61 unknowns; each with a 2-core of 4-6 nodes,
so the tree solve's LU runs), with the dense, tree and CG linear
solvers, f32 and f64, one system and a batch of T = 3 rows whose Newton
iterations differ, and 0 or 2 refinement steps:

  * bit for bit (one thread) equal to the solver the port ran before
    its steps wrote in place (a copy below, ``_old_*``: every iteration
    binds new tensors, CG reads its flags inside its own loop), with the
    same host reads, linear solves and CG steps; also with 2 restarts on
    a solve stopped far above its floor (max_iter = 1), and for CG on
    its own with a ``maxiter`` of 20, which is not a multiple of the
    16 steps between reads (and 184 for the depth-4 network);
  * within the tolerances of tests/test_torch_flow.py (f64 1e-9, f32
    1e-5, relative to the largest magnitude) of the JAX package's
    ``solve_pressure_newton``, a batch row by row;
  * driven by ``GraphLoop`` with a stand-in for torch.cuda's stream and
    graph calls that runs on the CPU: a captured step runs under a
    dispatch mode that records every aten op it makes (and raises on a
    host read, as capture does), the tensors that existed before the
    capture get their values back at its end (capture runs nothing), and
    a replay runs the recorded ops again into the same tensors.  The
    graph-driven solve equals the eager one bit for bit, with the same
    order of steps and reads (head, CG blocks, tail), each step's first
    run eager, its second captured, later ones replayed, a batch's LU
    between two graphs, counters added per replay; it raises when a step
    cannot be captured and when a plan cache changes during a capture.

The CUDA graphs themselves need a card: the ``gpu`` tests in
tests/test_torch_kernels.py hold the graph-driven solves to the eager
loop there.
"""

import contextlib
import dataclasses
import functools
import types
from typing import Optional

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

import arterynetwork_tpu.flow as J
from arterynetwork_tpu.flow.tree_solver import plan_elimination as j_plan
from arterynetwork_tpu.graphs import generate_tree, set_network_properties
from arterynetwork_tpu_torch.flow import solvers as tsolvers
from arterynetwork_tpu_torch.flow import tree_solver as ttree
from arterynetwork_tpu_torch.flow.physics import (edge_admittance,
                                                  velocity_from_flow)
from arterynetwork_tpu_torch.flow.segment_sum import edge_plan, segment_sum
from arterynetwork_tpu_torch.flow.solvers import (_CG_CHECK_EVERY, _DP_EPS,
                                                  _EDGE_ALIGN, _LS_STEPS,
                                                  FlowSolution, SolveStats,
                                                  _signed_flow_and_weight,
                                                  _two_sum)
from arterynetwork_tpu_torch.flow.system import FlowSystem, build_system
from arterynetwork_tpu_torch.flow.tree_solver import solve_laplacian_tree
from arterynetwork_tpu_torch.ops import grow_loop

torch.set_num_threads(1)

# (depth, seed) of generate_tree(allow_merge=True): 15 and 61 unknowns
NETS = {"d4": (4, 0), "d6": (6, 1)}
SOLVERS = ["dense", "tree", "cg"]
DTYPES = {"f32": torch.float32, "f64": torch.float64}
TOL = {"f32": 1e-5, "f64": 1e-9}        # tests/test_torch_flow.py's


@functools.lru_cache(maxsize=None)
def _rows(name):
    """Three rows on one merge-loop graph: the network, a Poiseuille
    (k = 1) copy and the network with other boundary pressures ->
    [(network, boundary pressures)]."""
    depth, seed = NETS[name]
    rng = np.random.default_rng(seed)
    net = generate_tree(max_depth=depth, allow_merge=True, rng=rng)
    net = set_network_properties(net, k_value=1.852, rng=rng)
    rng = np.random.default_rng(9)
    out = []
    for t in range(3):
        n = net
        if t == 1:
            n = net.replace(c=np.asarray(J.physics.poiseuille_equivalent_c(
                net.radius_m())), k=np.ones(net.num_edges))
        gt = J.create_ground_truth(n, option=2, rng=np.random.default_rng(7))
        assert gt.success
        bp = gt.pressure * (1.0 + 0.02 * t * rng.random(net.num_nodes))
        out.append((n, bp))
    return out


def _system(name, dtype, T):
    """The port's system of the first row (T = 1, unbatched) or of all
    three, stacked, and its elimination plan."""
    rows = [build_system(n, boundary_pressure=bp, dtype=DTYPES[dtype],
                         device="cpu") for n, bp in _rows(name)[:T]]
    plan = ttree.plan_elimination(rows[0])
    if T == 1:
        return rows[0], plan
    stack = {f: torch.stack([getattr(s, f) for s in rows])
             for f in ("radius_m", "c", "k", "node_fixed_pressure")}
    return dataclasses.replace(rows[0], **stack), plan


def _batch(system):
    return (system if system.node_fixed_pressure.dim() == 2
            else tsolvers._as_batch(system))


def _bits(sol):
    return [np.asarray(t).tobytes() for t in (
        sol.pressure, sol.flow, sol.velocity, sol.residual_norm,
        sol.iterations)]


def _counts(stats):
    return (stats.host_reads, stats.linear_solves,
            None if stats.cg_steps is None else stats.cg_steps.tolist())


# ----------------------------------------------------------------------
# the solver before its steps wrote in place: a copy
# ----------------------------------------------------------------------
def _old_read(flag, stats):
    """One device-to-host read of a flag, counted in ``stats``."""
    if stats is not None:
        stats.host_reads += 1
    return bool(flag)


def _old_dense(system: FlowSystem, w, rhs):
    """Laplacian(w) x = rhs by LU; w f[E] and rhs f[M], or f[T, E] and
    f[T, M] for T systems on one graph (weights beyond E ignored)."""
    if w.dim() == 1:
        return _old_dense(system, w[None], rhs[None])[0]
    M, E, T = system.num_unknown_pressures, system.num_edges, w.shape[0]
    w = w[:, :E]
    # L's nonzeros summed in the reference's order, then placed
    plan = edge_plan(system, "laplacian")
    L = w.new_zeros(T, M * M).index_copy_(1, plan.slots,
                                          segment_sum(plan, w))
    eye = torch.eye(M, dtype=w.dtype, device=w.device)
    A = (L.view(T, M, M)
         + eye * (1e-12 * w.amax(dim=1))[:, None, None])
    return torch.linalg.solve_ex(A, rhs)[0]     # no host sync on an error


def _old_cg(system: FlowSystem, w, rhs, tol=None, maxiter=None,
                        stats: Optional[SolveStats] = None):
    """Matrix-free CG on the symmetrically diagonal-scaled Laplacian.

    Explicit D^-1/2 L D^-1/2 scaling (rather than Jacobi preconditioning
    alone) keeps the iteration well-behaved in f32: Hazen-Williams tangent
    conductances span ~7 orders of magnitude across a deep arterial tree.

    The iteration is JAX's ``jax.scipy.sparse.linalg.cg`` (x0 = 0, no
    preconditioner): it stops when gamma = r.r <= tol^2 b.b or after
    ``maxiter`` steps, so it takes the same steps.  w f[E] and rhs f[M],
    or f[T, E] and f[T, M]: each row stops on its own and is frozen by a
    select; the host reads the flags every ``_CG_CHECK_EVERY`` steps.
    """
    if w.dim() == 1:
        return _old_cg(system, w[None], rhs[None], tol, maxiter,
                                   stats)[0]
    M, E, T = system.num_unknown_pressures, system.num_edges, w.shape[0]
    slot = system.node_unknown_index
    hu = slot[system.head]
    tu = slot[system.tail]
    w = w[:, :E]
    dtype = w.dtype
    div = edge_plan(system, "div")

    if tol is None:
        # inexact Newton: loose inner solves converge better in f32
        tol = 1e-4 if dtype == torch.float32 else 1e-12
    if maxiter is None:
        maxiter = min(8 * M + 64, 192 if dtype == torch.float32 else 2048)

    diag = segment_sum(edge_plan(system, "diag"), w)
    dinv_sqrt = torch.rsqrt(torch.clamp(diag, min=1e-38))
    zero = w.new_zeros(T, 1)
    ds_pad = torch.cat([dinv_sqrt, zero], dim=1)
    ridge = 1e-7 if dtype == torch.float32 else 1e-13

    def matvec(y):
        # x = D^-1/2 y; compute D^-1/2 L x
        xp = ds_pad * torch.cat([y, zero], dim=1)
        dx = xp.index_select(1, hu) - xp.index_select(1, tu)
        return dinv_sqrt * segment_sum(div, w * dx) + ridge * y

    b = dinv_sqrt * rhs
    x = torch.zeros_like(b)
    r = b
    p = r
    gamma = (r * r).sum(dim=1)
    atol2 = torch.clamp(tol ** 2 * (b * b).sum(dim=1), min=0.0)
    k = torch.zeros(T, dtype=torch.int32, device=w.device)
    active = (gamma > atol2) & (k < maxiter)
    for n in range(maxiter):
        if n % _CG_CHECK_EVERY == 0 and not _old_read(active.any(), stats):
            break
        Ap = matvec(p)
        alpha = gamma / (p * Ap).sum(dim=1)
        x_new = x + alpha[:, None] * p
        r_new = r - alpha[:, None] * Ap
        gamma_new = (r_new * r_new).sum(dim=1)
        beta = gamma_new / gamma
        p_new = r_new + beta[:, None] * p
        keep = active[:, None]
        x = torch.where(keep, x_new, x)
        r = torch.where(keep, r_new, r)
        p = torch.where(keep, p_new, p)
        gamma = torch.where(active, gamma_new, gamma)
        k = k + active
        active = (gamma > atol2) & (k < maxiter)
    if stats is not None:
        stats.cg_steps = k if stats.cg_steps is None else stats.cg_steps + k
    return dinv_sqrt * x


def _old_newton(system: FlowSystem, p_init, max_iter, tol, linear_solver, plan,
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
    net_plan = edge_plan(system, "net")   # inflow - outflow per unknown

    # edge fields as [T, Ep]; pad edges join node 0 to itself with zero
    # admittance, and the node sums read the first E edges only
    def edges(x, value):
        x = x.expand(T, E) if x.dim() == 1 else x
        return torch.cat([x, x.new_full((T, Ep - E), value)], dim=1)

    def index(ix, value):
        return torch.cat([ix, ix.new_full((Ep - E,), value)])

    head, tail = index(system.head, 0), index(system.tail, 0)
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

        def solve_fn(w, rhs):
            return solve_laplacian_tree(system, plan, w, rhs)
    elif linear_solver == "dense":
        def solve_fn(w, rhs):
            return _old_dense(system, w, rhs)
    elif linear_solver == "cg":
        def solve_fn(w, rhs):
            return _old_cg(system, w, rhs, stats=stats)
    else:
        raise ValueError(f"unknown linear_solver {linear_solver!r}")

    def linear_solve(w, rhs):
        if stats is not None:
            stats.linear_solves += 1
        return solve_fn(w, rhs)

    def full(p, fixed):
        pad = p.new_zeros(p.shape[:-1] + (1,))
        return torch.where(fixed_mask, fixed, torch.cat(
            [p, pad], dim=-1).index_select(-1, slot))

    def node_residual(p, fixed=fixed, adm=adm, k=k):
        """Net inflow at the unknown nodes of p [..., M], and the edges'
        flows and secant weights."""
        pf = full(p, fixed)
        dp = pf.index_select(-1, head) - pf.index_select(-1, tail)
        q, w = _signed_flow_and_weight(dp, adm, k)
        return segment_sum(net_plan, q), q, w

    # the line search's candidate steps, alpha = 2^-j, j = 0..20 (the last
    # is where the sequential search ends when nothing improves)
    alphas = torch.tensor([0.5 ** j for j in range(_LS_STEPS + 1)],
                          dtype=dtype, device=device)
    rows = torch.arange(T, device=device)

    def solve_from(p):
        """Newton with a backtracking line search on the residual norm,
        every row on its own; returns (p, residual norm, iterations)."""
        rn = node_residual(p)[0].abs().amax(dim=-1)
        it = torch.zeros(T, dtype=torch.int32, device=device)
        stalled = torch.zeros(T, dtype=torch.bool, device=device)
        while True:
            active = (rn > tol) & (it < max_iter) & ~stalled
            if not _old_read(active.any(), stats):
                return p, rn, it
            r, _, w = node_residual(p)
            # r = inflow - outflow, so dr/dp = -Laplacian(w); the update
            # direction solves Laplacian(w) step = +r.
            step = linear_solve(w, r)
            rn0 = r.abs().amax(dim=-1)
            cand = p[:, None, :] + alphas[None, :, None] * step[:, None, :]
            rn_c = node_residual(cand, fixed[:, None], adm[:, None],
                                 k[:, None])[0].abs().amax(dim=-1)
            good = rn_c[:, :_LS_STEPS] < rn0[:, None]
            improved = good.any(dim=1)
            first = torch.where(improved, good.to(torch.uint8).argmax(dim=1),
                                _LS_STEPS)
            rn_new = rn_c[rows, first]
            # stalled: the line search found no improving step (numerical
            # floor reached) — stop instead of burning iterations
            stalled_new = ~improved | (rn_new >= rn0 * (1.0 - 1e-6))
            p = torch.where(active[:, None], cand[rows, first], p)
            rn = torch.where(active, rn_new, rn)
            stalled = torch.where(active, stalled_new, stalled)
            it = it + active

    if M > 0:
        p_unknown, rn, it = solve_from(p_init)
    else:
        p_unknown = p_init
        rn = torch.zeros(T, dtype=dtype, device=device)
        it = torch.zeros(T, dtype=torch.int32, device=device)

    if restarts and M > 0:
        # Multi-start escape — the robustness slot the reference fills
        # with scipy basinhopping (fluidSimulation.py:1746-1752,
        # 1876-1878).  The trigger sits above the dtype's normal stall
        # floor, so a healthy solve never pays a restart.
        trigger = max(tol, 1e-8 if dtype == torch.float32 else 1e-12)
        gen = torch.Generator(device=device)
        gen.manual_seed(int(restarts))
        for _ in range(restarts):
            stuck = rn > trigger
            if not _old_read(stuck.any(), stats):
                continue
            scale = torch.rand(p_init.shape, generator=gen, dtype=dtype,
                               device=device) + 0.5
            p2, rn2, it2 = solve_from(p_init * scale)
            better = stuck & (rn2 < rn)
            p_unknown = torch.where(better[:, None], p2, p_unknown)
            rn = torch.where(better, rn2, rn)
            it = it + torch.where(stuck, it2, 0)

    if refine_steps is None:
        refine_steps = 2 if dtype == torch.float32 else 0

    p_lo = torch.zeros_like(p_unknown)
    refine = bool(refine_steps) and M > 0

    def full_lo(p_lo):
        return full(p_lo, torch.zeros((), dtype=dtype, device=device))

    if refine:
        inv_k = 1.0 / k

        def ds_residual(p_hi, p_lo):
            """Residual with the pressure drop formed error-free."""
            pf_hi = full(p_hi, fixed)
            pf_lo = full_lo(p_lo)
            s, e = _two_sum(pf_hi[:, head], -pf_hi[:, tail])
            e = e + (pf_lo[:, head] - pf_lo[:, tail])
            mag = torch.clamp(torch.abs(s), min=_DP_EPS)
            w = adm ** inv_k * mag ** (inv_k - 1.0)
            q_hi = w * s
            q_lo = (w * inv_k) * e   # first order: dq/d(dp) = w/k
            return (segment_sum(net_plan, q_hi)
                    + segment_sum(net_plan, q_lo)), w

        for _ in range(refine_steps):
            r, w = ds_residual(p_unknown, p_lo)
            # tangent weight dq/d(dp) = w/k: at the converged point no
            # k-th-root modes are active, so these steps contract
            # quadratically instead of at the secant ~(1-1/k) rate
            step = linear_solve(w * inv_k, r)
            hi, err = _two_sum(p_unknown, step)
            lo = p_lo + err
            p_unknown, p_lo = _two_sum(hi, lo)   # renormalize the pair
        rn = ds_residual(p_unknown, p_lo)[0].abs().amax(dim=1)

    p_full = full(p_unknown, fixed)
    dp = p_full[:, head] - p_full[:, tail]
    if refine:
        pf_lo = full_lo(p_lo)
        s, e = _two_sum(p_full[:, head], -p_full[:, tail])
        dp = s + (e + (pf_lo[:, head] - pf_lo[:, tail]))
    q, _ = _signed_flow_and_weight(dp, adm, k)
    v = velocity_from_flow(q, radius)
    return FlowSolution(pressure=p_full + p_ref[:, None], flow=q[:, :E],
                        velocity=v[:, :E], residual_norm=rn, iterations=it)


def _solve(new, system, plan, solver, refine, restarts=0, max_iter=60,
           tol=1e-14):
    """(solution, stats) of the new or the old ``_newton``."""
    stats = SolveStats()
    fn = tsolvers._newton if new else _old_newton
    sol = fn(_batch(system), None, max_iter, tol, solver,
             plan if solver == "tree" else None, refine, restarts, stats)
    return sol, stats


# ----------------------------------------------------------------------
# in place, in the host loop: the copy's bits and counts
# ----------------------------------------------------------------------
@pytest.mark.parametrize("refine", [0, 2])
@pytest.mark.parametrize("T", [1, 3])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("solver", SOLVERS)
@pytest.mark.parametrize("name", list(NETS))
def test_in_place_newton_matches_old_loop(name, solver, dtype, T, refine):
    system, plan = _system(name, dtype, T)
    new, s_new = _solve(True, system, plan, solver, refine)
    old, s_old = _solve(False, system, plan, solver, refine)
    assert _bits(new) == _bits(old)
    assert _counts(s_new) == _counts(s_old)
    assert s_new.captures == s_new.replays == 0      # no graph on the CPU
    if T == 3:
        assert len(set(new.iterations.tolist())) > 1


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("solver", SOLVERS)
def test_restarts_match_old_loop(solver, dtype):
    """max_iter = 1 stops the primary solve far above the trigger, so
    both restarts run (one host read each)."""
    system, plan = _system("d6", dtype, 1)
    new, s_new = _solve(True, system, plan, solver, None, restarts=2,
                        max_iter=1)
    old, s_old = _solve(False, system, plan, solver, None, restarts=2,
                        max_iter=1)
    assert _bits(new) == _bits(old)
    assert _counts(s_new) == _counts(s_old)
    assert int(new.iterations[0]) > 1


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cg_past_a_maxiter_off_the_block(dtype):
    """CG on its own with maxiter 20: its second block of 16 runs 12
    steps past maxiter, which change nothing; reads at steps 0 and 16."""
    system, _ = _system("d6", dtype, 3)
    rng = np.random.default_rng(6)
    E, M = system.num_edges, system.num_unknown_pressures
    w = torch.as_tensor(np.exp(rng.uniform(-8.0, 0.0, (3, E))) * 1e-9,
                        dtype=DTYPES[dtype])
    rhs = torch.as_tensor(rng.normal(0.0, 1e-6, (3, M)),
                          dtype=DTYPES[dtype])
    a, b = SolveStats(), SolveStats()
    new = tsolvers._cg_laplacian_solve(system, w, rhs, 1e-30, 20, a)
    old = _old_cg(system, w, rhs, 1e-30, 20, b)
    assert new.numpy().tobytes() == old.numpy().tobytes()
    assert _counts(a) == _counts(b) == (2, 0, [20, 20, 20])


# ----------------------------------------------------------------------
# against the JAX package
# ----------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _jax_row(name, t, dtype, solver, refine):
    n, bp = _rows(name)[t]
    sys_j = J.build_system(n, boundary_pressure=bp,
                           dtype={"f32": jnp.float32,
                                  "f64": jnp.float64}[dtype])
    plan = j_plan(sys_j) if solver == "tree" else None
    sol = J.solve_pressure_newton(sys_j, linear_solver=solver, plan=plan,
                                  refine_steps=refine)
    return {f: np.asarray(getattr(sol, f)) for f in
            ("pressure", "flow", "velocity", "iterations")}


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.mark.parametrize("refine", [0, 2])
@pytest.mark.parametrize("T", [1, 3])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("solver", SOLVERS)
def test_in_place_newton_matches_jax(solver, dtype, T, refine):
    system, plan = _system("d6", dtype, T)
    sol, _ = _solve(True, system, plan, solver, refine)
    for t in range(T):
        ref = _jax_row("d6", t, dtype, solver, refine)
        for f in ("pressure", "flow", "velocity"):
            assert _rel(getattr(sol, f)[t].numpy(), ref[f]) <= TOL[dtype]
        if dtype == "f64":
            assert int(sol.iterations[t]) == int(ref["iterations"])


# ----------------------------------------------------------------------
# GraphLoop with a stand-in for torch.cuda's graph calls
# ----------------------------------------------------------------------
_HOST_READS = {torch.ops.aten._local_scalar_dense.default}


def _ptr(t):
    """Where a tensor's storage lies, or None for a tensor with no
    storage (forward-mode AD's zero tangents, ``_efficientzerotensor``):
    a constant, never written."""
    return None if t._is_zerotensor() else t.untyped_storage().data_ptr()


class _Record(TorchDispatchMode):
    """What a capture records: every aten op, in order, with its
    arguments and outputs.  A host read raises, as capture refuses it."""

    def __init__(self, graph):
        super().__init__()
        self.graph = graph

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _HOST_READS:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        g = self.graph
        writes = False
        for i, a in enumerate(func._schema.arguments):
            if a.alias_info is None or not a.alias_info.is_write:
                continue
            writes = True
            t = args[i] if i < len(args) else kwargs.get(a.name)
            if (isinstance(t, torch.Tensor)
                    and _ptr(t) not in g.made):
                g.saved.append((t, t.clone()))
        out = func(*args, **kwargs)
        if not (writes or func.is_view):
            g.made.update(_ptr(o) for o in tree_flatten(out)[0]
                          if isinstance(o, torch.Tensor))
        g.ops.append((func, args, kwargs, out))
        return out


class _StandIn:
    """torch.cuda's stream and graph calls as GraphLoop makes them, on
    the CPU (see the module's docstring)."""

    class _Stream:
        cuda_stream = 0

        def wait_stream(self, other):
            pass

        def synchronize(self):
            pass

    class _Graph:
        def __init__(self, cuda):
            self.cuda, self.ops, self.saved, self.made = cuda, [], [], set()
            cuda.graphs[id(self)] = self

        def capture_begin(self, pool, capture_error_mode):
            self.cuda.modes.append((pool, capture_error_mode))
            self.mode = _Record(self)
            self.mode.__enter__()

        def capture_end(self):
            self.mode.__exit__(None, None, None)
            for t, v in reversed(self.saved):   # capture ran nothing
                t.copy_(v)

        def raw_cuda_graph(self):
            return id(self)

        def replay(self):
            for func, args, kwargs, out in self.ops:
                new = func(*args, **kwargs)
                for o, n in zip(tree_flatten(out)[0], tree_flatten(new)[0]):
                    if (isinstance(o, torch.Tensor) and _ptr(o) is not None
                            and _ptr(o) != _ptr(n)):
                        o.copy_(n)

    def __init__(self):
        self.modes, self.graphs = [], {}    # graphs: raw handle -> graph

    def Stream(self, device=None):
        return self._Stream()

    current_stream = Stream

    def device(self, device):
        return contextlib.nullcontext()

    def stream(self, stream):
        return contextlib.nullcontext()

    def graph_pool_handle(self):
        return "pool"

    def CUDAGraph(self, keep_graph=False):
        return self._Graph(self)


class _Logged(grow_loop.GraphLoop):
    """A GraphLoop that logs each step it runs (how), each read and how
    many graphs each capture made."""

    def __init__(self, device, counters=(), watch=None, log=None):
        super().__init__(device, counters, watch)
        self.log = [] if log is None else log

    def read(self, stop):
        v = super().read(stop)
        self.log.append(("read", v))
        return v

    def run(self, key, step):
        how = ("replay" if key in self.graphs else
               "capture" if key in self.seen else "eager")
        super().run(key, step)
        self.log.append((how, key, len(self.graphs.get(key, ()))))


class _HostLogged(grow_loop.HostLoop):
    def __init__(self, log):
        super().__init__()
        self.log = log

    def read(self, stop):
        v = super().read(stop)
        self.log.append(("read", v))
        return v

    def run(self, key, step):
        super().run(key, step)
        self.log.append(("eager", key, 0))


def _stand_in(monkeypatch, log, graphs=True):
    """Route the solver's loops through a logged GraphLoop on the
    stand-in (or a logged HostLoop)."""
    fake = _StandIn()
    monkeypatch.setattr(grow_loop, "torch", types.SimpleNamespace(
        cuda=fake, int32=torch.int32,
        empty=lambda *a, pin_memory=False, **k: torch.empty(*a, **k)))

    def loop_for(device, counters=(), watch=None):
        if graphs:
            return _Logged(device, counters, watch, log)
        return _HostLogged(log)

    monkeypatch.setattr(grow_loop, "loop_for", loop_for)
    return fake


def _check_order(log, maxiter):
    """Each CG head is followed by a read, each read < 0 by a block and
    each block by a read while fewer than maxiter steps ran, then the
    tail."""
    i = 0
    while i < len(log):
        if log[i][0] != "read" and log[i][1].endswith(" head"):
            name = log[i][1][:-5]
            i += 1
            n = 0
            while True:
                if n < maxiter:
                    assert log[i][0] == "read"
                    i += 1
                    if log[i - 1][1] >= 0:
                        break
                else:
                    break
                assert log[i][1] == "cg block"
                i += 1
                n += _CG_CHECK_EVERY
            assert log[i][1] == name + " tail"
        i += 1


@pytest.mark.parametrize("T", [1, 3])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("solver", SOLVERS)
def test_graph_driven_newton_matches_eager(monkeypatch, solver, dtype, T):
    system, plan = _system("d6", dtype, T)
    eager_log, graph_log = [], []
    with monkeypatch.context() as m:
        _stand_in(m, eager_log, graphs=False)
        eager, s_eager = _solve(True, system, plan, solver, 2)
    with monkeypatch.context() as m:
        fake = _stand_in(m, graph_log)
        graph, s_graph = _solve(True, system, plan, solver, 2)
    assert _bits(graph) == _bits(eager)
    assert _counts(s_graph) == _counts(s_eager)
    # the same steps and reads in the same order
    assert ([e[:2] for e in graph_log if e[0] == "read"]
            == [e[:2] for e in eager_log if e[0] == "read"])
    assert ([e[1] for e in graph_log if e[0] != "read"]
            == [e[1] for e in eager_log if e[0] != "read"])
    if solver == "cg":
        _check_order(graph_log, tsolvers._CG(system, T, DTYPES[dtype])
                     .maxiter)
    # per key: the first run eager, the second captured, then replays;
    # a batch's step with an LU (dense, or tree with its core) in two
    # graphs, the LU between them
    runs = {}
    for e in graph_log:
        if e[0] != "read":
            runs.setdefault(e[1], []).append(e)
    segments = 2 if T > 1 and solver != "cg" else 1
    captures = replays = 0
    for key, rs in runs.items():
        assert [r[0] for r in rs] == (["eager", "capture"]
                                      + ["replay"] * (len(rs) - 2))[:len(rs)]
        assert all(r[2] == segments for r in rs[1:])
        captures += segments * (len(rs) > 1)
        replays += segments * max(len(rs) - 1, 0)
    assert (s_graph.captures, s_graph.replays) == (captures, replays)
    assert replays > 0
    assert fake.modes == [("pool", "thread_local")] * captures


@pytest.mark.parametrize("solver", SOLVERS)
def test_graph_driven_restarts_match_eager(monkeypatch, solver):
    system, plan = _system("d6", "f32", 1)
    with monkeypatch.context() as m:
        _stand_in(m, [], graphs=False)
        eager, s_eager = _solve(True, system, plan, solver, None, 2, 1)
    with monkeypatch.context() as m:
        _stand_in(m, [])
        graph, s_graph = _solve(True, system, plan, solver, None, 2, 1)
    assert _bits(graph) == _bits(eager)
    assert _counts(s_graph) == _counts(s_eager)


def test_graph_loop_adds_counters_per_replay(monkeypatch):
    """A step in two parts (it yields once) counted in a caller's counter
    and in a kernel wrapper's: five runs, one eager, one captured (two
    graphs), three replayed, count five each."""
    from arterynetwork_tpu_torch.ops import region_grow_fused as rfu

    _stand_in(monkeypatch, [])
    box = types.SimpleNamespace(n=0)
    x = torch.zeros(3)
    ran = []

    def step():
        box.n += 1
        rfu.fused_sweep_counts.launches += 1
        y = x + 1.0
        yield lambda: ran.append(1)
        x.copy_(y * 2.0)

    n0 = rfu.fused_sweep_counts.launches
    loop = grow_loop.GraphLoop(torch.device("cpu"), [(box, "n")])
    with loop.stream():
        for _ in range(5):
            loop.run("step", step)
    assert box.n == 5 and rfu.fused_sweep_counts.launches - n0 == 5
    assert (loop.captures, loop.replays) == (2, 8)
    assert len(ran) == 5
    # x -> 2 (x + 1), five times from 0
    assert x.tolist() == [62.0] * 3
    assert loop.graphs == {}                    # dropped at the end


def test_graph_driven_solve_raises_when_a_step_reads_the_device(monkeypatch):
    """No fallback: a step that reads the device on the host cannot be
    captured, and the solve raises (the eager loop takes it)."""
    system, plan = _system("d4", "f64", 1)
    real = tsolvers._signed_flow_and_weight

    def reads(dp, adm, k):
        float(dp.abs().sum())
        return real(dp, adm, k)

    monkeypatch.setattr(tsolvers, "_signed_flow_and_weight", reads)
    with monkeypatch.context() as m:
        _stand_in(m, [], graphs=False)
        _solve(True, system, plan, "tree", 0)
    _stand_in(monkeypatch, [])
    with pytest.raises(RuntimeError, match="capturing"):
        _solve(True, system, plan, "tree", 0)


def test_graph_driven_solve_raises_when_a_plan_is_built_in_capture(
        monkeypatch):
    """A plan cached while a step is captured would hold memory that no
    kernel wrote: the tree solve's diagonal plan dropped from the cache
    after the eager step is built again in the capture, which raises."""
    system, plan = _system("d4", "f64", 1)
    real = ttree.edge_plan
    calls = []

    def dropped(system, kind):
        if calls:
            system.plans.pop((kind, str(system.device)), None)
        calls.append(kind)
        return real(system, kind)

    monkeypatch.setattr(ttree, "edge_plan", dropped)
    _stand_in(monkeypatch, [])
    with pytest.raises(RuntimeError, match="cache changed"):
        _solve(True, system, plan, "tree", 0)


def test_graph_loop_watches_signs_made_in_capture(monkeypatch):
    """A plan's signs for a new dtype made in a capture raise too."""
    system, plan = _system("d4", "f64", 1)
    div = edge_plan(system, "div")
    w = torch.ones(1, system.num_edges, dtype=torch.float64)
    dtypes = [torch.float64, torch.float32]
    _stand_in(monkeypatch, [])
    loop = grow_loop.GraphLoop(
        torch.device("cpu"),
        watch=lambda: tsolvers._cached_plans(system, plan))
    with loop.stream():
        loop.run("sum", lambda: segment_sum(div, w.to(dtypes.pop(0))))
        with pytest.raises(RuntimeError, match="cache changed"):
            loop.run("sum", lambda: segment_sum(div, w.to(dtypes.pop(0))))
