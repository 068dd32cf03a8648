"""Hazen-Williams network solve, written on node pressures.

For each edge e from head h to tail t, with A = c^k D^4.8704 / (10.67 L)
(D the diameter, L the length, both in meters),

    Q_e = sign(p_h - p_t) (A |p_h - p_t|)^(1/k)        [m^3/s]

and every node that is neither an entry node nor of degree 1 conserves
flow.  Newton's method on the free pressures with the sparse Jacobian
B^T diag(dQ/ddp) B, started from the linear (k = 1) solve, with a
backtracking line search.  ``dtype`` is the arithmetic's precision
(float64 for the reference, float32 for a control); ``round_state``, if
given, rounds the pressures and flows after every step (a bfloat16
control).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

HW_COEFF = 10.67
HW_DIAMETER_EXPONENT = 4.8704


def fixed_nodes(heads, tails, num_nodes, entry_nodes):
    deg = np.bincount(np.concatenate([heads, tails]), minlength=num_nodes)
    fixed = deg == 1
    fixed[np.asarray(entry_nodes, np.int64)] = True
    return fixed


def solve(heads, tails, radius_m, length_m, fixed, fixed_pressure, c=1.0,
          k=1.852, dtype=np.float64, round_state=None, max_iter=80):
    """(node pressures [N], edge flows [E]) in Pa and m^3/s, as float64
    arrays of the ``dtype`` solution."""
    heads = np.asarray(heads, np.int64)
    tails = np.asarray(tails, np.int64)
    N = len(fixed)
    E = len(heads)
    f = dtype
    k = np.broadcast_to(np.asarray(k, f), (E,)).astype(f)
    c = np.broadcast_to(np.asarray(c, f), (E,)).astype(f)
    d = 2.0 * np.asarray(radius_m, f)
    A = (c ** k * d ** f(HW_DIAMETER_EXPONENT)
         / (f(HW_COEFF) * np.asarray(length_m, f))).astype(f)
    loop = heads == tails                     # no drop, no flow
    free = np.nonzero(~fixed)[0]
    col = np.full(N, -1, np.int64)
    col[free] = np.arange(len(free))
    rows_e = np.arange(E)
    B = sp.csr_matrix(
        (np.concatenate([np.where(loop, 0, 1), np.where(loop, 0, -1)])
         .astype(f), (np.concatenate([rows_e, rows_e]),
                      np.concatenate([heads, tails]))), shape=(E, N))
    Bf = B[:, free].tocsc()
    p = np.where(fixed, np.asarray(fixed_pressure, f), f(0)).astype(f)
    p_fixed = p.copy()

    def flows(p):
        dp = p[heads] - p[tails]
        return np.sign(dp) * (A * np.abs(dp)) ** (1.0 / k), dp

    def resid(p):
        q, dp = flows(p)
        return (Bf.T @ q).astype(f), q, dp

    # linear start: conductance A^(1/k) at a 1 kPa drop
    g0 = (A ** (1.0 / k) * f(1000.0) ** (1.0 / k - 1.0)).astype(f)
    L0 = (Bf.T @ sp.diags(g0) @ Bf).tocsc()
    rhs = -(Bf.T @ (g0 * (B @ p_fixed))).astype(f)
    p[free] = spla.spsolve(L0, rhs).astype(f)
    if round_state is not None:
        p = round_state(p)
    r, q, dp = resid(p)
    scale = max(float(np.max(np.abs(q))), 1e-300)
    for _ in range(max_iter):
        norm = float(np.linalg.norm(r))
        if norm <= 1e-15 * scale * np.sqrt(len(r) + 1):
            break
        adp = np.maximum(np.abs(dp), f(1e-9))
        g = (A ** (1.0 / k) / k * adp ** (1.0 / k - 1.0)).astype(f)
        J = (Bf.T @ sp.diags(g) @ Bf).tocsc()
        step = spla.spsolve(J, -r).astype(f)
        t = 1.0
        for _ in range(30):
            trial = p.copy()
            trial[free] = p[free] + f(t) * step
            if round_state is not None:
                trial = round_state(trial)
            r2, q2, dp2 = resid(trial)
            if float(np.linalg.norm(r2)) < norm or t < 1e-6:
                break
            t *= 0.5
        if float(np.linalg.norm(r2)) >= norm:
            break
        p, r, q, dp = trial, r2, q2, dp2
    if round_state is not None:
        q = round_state(q)
    return p.astype(np.float64), q.astype(np.float64)


def gaps(p, q, p_ref, q_ref):
    """(pressure gap, flow gap): the largest pressure difference over the
    reference's pressure span, the largest flow difference over the
    reference's largest flow."""
    span = max(float(np.max(p_ref) - np.min(p_ref)), 1e-300)
    qmax = max(float(np.max(np.abs(q_ref))), 1e-300)
    gp = float(np.max(np.abs(np.asarray(p, np.float64) - p_ref))) / span
    gq = float(np.max(np.abs(np.asarray(q, np.float64) - q_ref))) / qmax
    # a non-finite output is as far off as can be
    return (gp if np.isfinite(gp) else float("inf"),
            gq if np.isfinite(gq) else float("inf"))
