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

Linear-solver backends: ``dense`` (scatter-assembled Laplacian +
``torch.linalg.solve``) and ``tree`` (exact tree elimination,
flow/tree_solver.py).  The matrix-free ``cg`` backend is not ported yet.

The iteration runs as Python loops on the system's device; each
convergence and line-search decision reads one scalar back to the host.
Comparisons against Python constants keep the system's dtype (a Python
float meets an f32 tensor as f32), as the JAX reference's weak typing
does, so an f32 solve takes the same decisions.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .physics import edge_admittance, velocity_from_flow
from .system import FlowSystem

_DP_EPS = 1e-9  # Pa; regularizes dQ/d(dP) at dP = 0


class FlowSolution(NamedTuple):
    pressure: torch.Tensor       # f[N] full node pressures (Pa)
    flow: torch.Tensor           # f[E] signed flow, positive head->tail (m^3/s)
    velocity: torch.Tensor       # f[E] signed velocity (m/s)
    residual_norm: torch.Tensor  # scalar, max |net nodal flow| (m^3/s)
    iterations: int


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


def _node_residual(p_unknown, system: FlowSystem, adm):
    """Net outflow at unknown-pressure nodes (conservation residual)."""
    p_full = system.full_pressure(p_unknown)
    dp = p_full[system.head] - p_full[system.tail]
    q, w = _signed_flow_and_weight(dp, adm, system.k)
    M = system.num_unknown_pressures
    slot = system.node_unknown_index  # M for fixed nodes
    net = q.new_zeros(M + 1)
    net.index_add_(0, slot[system.tail], q)      # inflow
    net.index_add_(0, slot[system.head], -q)     # outflow
    return net[:M], q, w


def _dense_laplacian_solve(system: FlowSystem, w, rhs):
    M = system.num_unknown_pressures
    slot = system.node_unknown_index
    hu = slot[system.head]
    tu = slot[system.tail]
    L = w.new_zeros((M + 1, M + 1))
    L.index_put_((hu, hu), w, accumulate=True)
    L.index_put_((tu, tu), w, accumulate=True)
    L.index_put_((hu, tu), -w, accumulate=True)
    L.index_put_((tu, hu), -w, accumulate=True)
    eye = torch.eye(M, dtype=w.dtype, device=w.device)
    A = L[:M, :M] + eye * (1e-12 * torch.max(w))
    return torch.linalg.solve(A, rhs)


def solve_pressure_newton(
    system: FlowSystem,
    p_init: torch.Tensor | None = None,
    max_iter: int = 60,
    tol: float = 1e-14,
    linear_solver: str = "dense",
    plan=None,
    refine_steps: int | None = None,
    restarts: int = 0,
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
    adm = edge_admittance(system.radius_m, system.length_m, system.c,
                          system.k)
    dtype = system.radius_m.dtype
    device = system.device
    M = system.num_unknown_pressures

    # Shift pressures to drop-from-reference variables: edge dP values can
    # be 1e6x smaller than absolute pressures, so subtracting a reference
    # before the solve removes most of the f32 cancellation error.
    fixed_vals = system.node_fixed_pressure[system.node_fixed]
    p_ref = 0.5 * (fixed_vals.max() + fixed_vals.min())
    system = dataclasses.replace(
        system,
        node_fixed_pressure=torch.where(
            system.node_fixed, system.node_fixed_pressure - p_ref,
            0.0).to(dtype))

    if p_init is None:
        # Depth-interpolated initial guess (reference init style,
        # fluidSimulation.py:1852): pressures fall linearly with depth from
        # the max to the min prescribed boundary pressure.
        fixed_vals = system.node_fixed_pressure[system.node_fixed]
        hi = fixed_vals.max()
        lo = fixed_vals.min()
        depth = system.node_depth.to(dtype)
        frac = depth / torch.clamp(depth.max(), min=1.0)
        p_by_depth = hi + (lo - hi) * frac
        # unknowns in node order (node_arg increases with node index)
        p_init = p_by_depth[~system.node_fixed]
    else:
        p_init = p_init - p_ref
    p_init = p_init.to(dtype)

    if linear_solver == "auto":
        # tree elimination is exact and O(depth) when a plan is given;
        # dense LU otherwise up to a few thousand unknowns
        if plan is not None:
            linear_solver = "tree"
        else:
            linear_solver = "dense" if M <= 4096 else "cg"
    if linear_solver == "tree":
        from .tree_solver import solve_laplacian_tree

        if plan is None:
            raise ValueError("linear_solver='tree' needs an EliminationPlan "
                             "(flow.tree_solver.plan_elimination)")

        def solve_fn(system, w, rhs):
            return solve_laplacian_tree(system, plan, w, rhs)
    elif linear_solver == "dense":
        solve_fn = _dense_laplacian_solve
    elif linear_solver == "cg":
        raise NotImplementedError(
            "linear_solver='cg' (matrix-free Jacobi CG) is not ported yet; "
            "use 'dense' or 'tree'")
    else:
        raise ValueError(f"unknown linear_solver {linear_solver!r}")

    def norm_r(p):
        r, _, _ = _node_residual(p, system, adm)
        return torch.max(torch.abs(r))

    def solve_from(p):
        """Newton with a backtracking line search on the residual norm;
        returns (p, residual norm, iterations)."""
        rn = norm_r(p)
        it = 0
        stalled = False
        while bool(rn > tol) and it < max_iter and not stalled:
            r, _, w = _node_residual(p, system, adm)
            # r = inflow - outflow, so dr/dp = -Laplacian(w); the update
            # direction solves Laplacian(w) step = +r.
            step = solve_fn(system, w, r)
            rn0 = torch.max(torch.abs(r))
            alpha = 1.0
            improved = False
            while alpha > 1e-6:
                if bool(norm_r(p + alpha * step) < rn0):
                    improved = True
                    break
                alpha *= 0.5
            p = p + alpha * step
            rn_new = norm_r(p)
            # stalled: the line search found no improving step (numerical
            # floor reached) — stop instead of burning iterations
            stalled = (not improved) or bool(rn_new >= rn0 * (1.0 - 1e-6))
            rn = rn_new
            it += 1
        return p, rn, it

    if M > 0:
        p_unknown, rn, it = solve_from(p_init)
    else:
        p_unknown, rn, it = p_init, torch.zeros((), dtype=dtype,
                                                device=device), 0

    if restarts and M > 0:
        # Multi-start escape — the robustness slot the reference fills
        # with scipy basinhopping (fluidSimulation.py:1746-1752,
        # 1876-1878).  The trigger sits above the dtype's normal stall
        # floor, so a healthy solve never pays a restart.
        trigger = max(tol, 1e-8 if dtype == torch.float32 else 1e-12)
        gen = torch.Generator(device=device)
        gen.manual_seed(int(restarts))
        for _ in range(restarts):
            if not bool(rn > trigger):
                continue
            scale = torch.rand(p_init.shape, generator=gen, dtype=dtype,
                               device=device) + 0.5
            p2, rn2, it2 = solve_from(p_init * scale)
            if bool(rn2 < rn):
                p_unknown, rn = p2, rn2
            it += it2

    if refine_steps is None:
        refine_steps = 2 if dtype == torch.float32 else 0

    p_lo = torch.zeros_like(p_unknown)
    refine = bool(refine_steps) and M > 0
    zero = torch.zeros((), dtype=dtype, device=device)

    def full_lo(p_lo):
        padded_lo = torch.cat([p_lo, p_lo.new_zeros(1)])
        return torch.where(system.node_fixed, zero,
                           padded_lo[system.node_unknown_index])

    if refine:
        slot = system.node_unknown_index
        hslot = slot[system.head]
        tslot = slot[system.tail]
        inv_k = 1.0 / system.k

        def ds_residual(p_hi, p_lo):
            """Residual with the pressure drop formed error-free."""
            pf_hi = system.full_pressure(p_hi)
            pf_lo = full_lo(p_lo)
            s, e = _two_sum(pf_hi[system.head], -pf_hi[system.tail])
            e = e + (pf_lo[system.head] - pf_lo[system.tail])
            mag = torch.clamp(torch.abs(s), min=_DP_EPS)
            w = adm ** inv_k * mag ** (inv_k - 1.0)
            q_hi = w * s
            q_lo = (w * inv_k) * e   # first order: dq/d(dp) = w/k
            netf = q_hi.new_zeros(M + 1)
            netf.index_add_(0, tslot, q_hi).index_add_(0, hslot, -q_hi)
            netc = q_lo.new_zeros(M + 1)
            netc.index_add_(0, tslot, q_lo).index_add_(0, hslot, -q_lo)
            return netf[:M] + netc[:M], w

        for _ in range(refine_steps):
            r, w = ds_residual(p_unknown, p_lo)
            # tangent weight dq/d(dp) = w/k: at the converged point no
            # k-th-root modes are active, so these steps contract
            # quadratically instead of at the secant ~(1-1/k) rate
            step = solve_fn(system, w * inv_k, r)
            hi, err = _two_sum(p_unknown, step)
            lo = p_lo + err
            p_unknown, p_lo = _two_sum(hi, lo)   # renormalize the pair
        rn = torch.max(torch.abs(ds_residual(p_unknown, p_lo)[0]))

    p_full = system.full_pressure(p_unknown)
    dp = p_full[system.head] - p_full[system.tail]
    if refine:
        pf_lo = full_lo(p_lo)
        s, e = _two_sum(p_full[system.head], -p_full[system.tail])
        dp = s + (e + (pf_lo[system.head] - pf_lo[system.tail]))
    q, _ = _signed_flow_and_weight(dp, adm, system.k)
    v = velocity_from_flow(q, system.radius_m)
    return FlowSolution(pressure=p_full + p_ref, flow=q, velocity=v,
                        residual_norm=rn, iterations=it)
