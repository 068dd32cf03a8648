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

import dataclasses
from typing import NamedTuple, Optional

import torch

from .physics import edge_admittance, velocity_from_flow
from .segment_sum import edge_plan, segment_sum
from .system import FlowSystem

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
    final iteration count); ``linear_solves``: linear solves (one per
    Newton and refinement step); ``cg_steps``: per-row CG iterations,
    summed over the CG solves (None until a CG solve ran)."""
    host_reads: int = 0
    linear_solves: int = 0
    cg_steps: Optional[torch.Tensor] = None


def _read(flag, stats):
    """One device-to-host read of a flag, counted in ``stats``."""
    if stats is not None:
        stats.host_reads += 1
    return bool(flag)


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


def _dense_laplacian_solve(system: FlowSystem, w, rhs):
    """Laplacian(w) x = rhs by LU; w f[E] and rhs f[M], or f[T, E] and
    f[T, M] for T systems on one graph (weights beyond E ignored)."""
    if w.dim() == 1:
        return _dense_laplacian_solve(system, w[None], rhs[None])[0]
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


def _cg_laplacian_solve(system: FlowSystem, w, rhs, tol=None, maxiter=None,
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
        return _cg_laplacian_solve(system, w[None], rhs[None], tol, maxiter,
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
        if n % _CG_CHECK_EVERY == 0 and not _read(active.any(), stats):
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
        from .tree_solver import solve_laplacian_tree

        if plan is None:
            raise ValueError("linear_solver='tree' needs an EliminationPlan "
                             "(flow.tree_solver.plan_elimination)")

        def solve_fn(w, rhs):
            return solve_laplacian_tree(system, plan, w, rhs)
    elif linear_solver == "dense":
        def solve_fn(w, rhs):
            return _dense_laplacian_solve(system, w, rhs)
    elif linear_solver == "cg":
        def solve_fn(w, rhs):
            return _cg_laplacian_solve(system, w, rhs, stats=stats)
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
            if not _read(active.any(), stats):
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
            if not _read(stuck.any(), stats):
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


def solve_poiseuille(system: FlowSystem,
                     linear_solver: str = "dense") -> FlowSolution:
    """Exact linear solve for k=1 networks (one Newton step suffices)."""
    return solve_pressure_newton(system, max_iter=3,
                                 linear_solver=linear_solver)
