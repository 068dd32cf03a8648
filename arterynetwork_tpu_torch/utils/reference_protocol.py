# Copy of arterynetwork_tpu/utils/reference_protocol.py, unchanged.
"""Reference-protocol network solve: the independent cross-check oracle.

Rebuilds the reference's equation-dict evaluation model
(``computeNetworkDetail``, fluidSimulation.py:4636-4728) verbatim — a
Python loop over per-equation dicts with the documented error
magnification — and drives it with scipy ``least_squares`` (the
reference's documented alternative driver, fluidSimulation.py:1729-1752).

Used two ways:
  * bench.py times it as the fair CPU baseline on config 1;
  * tests cross-check study solves (tp_fit_solve_study / gbm_test4)
    against it: the Newton solver and this oracle share no code beyond
    the physics constants, so pressure/flow agreement to ~1e-3 (the
    reference's own acceptance) pins the studies to reference protocol.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np

from ..constants import FLOW_ERROR_FACTOR, PRESSURE_ERROR_FACTOR


def build_equation_dicts(net, boundary_pressure):
    """The reference's eqnInfoDictList for a network: one flow-
    conservation dict per interior node, one H-W pressure dict per edge
    (setupFluidEquations, fluidSimulation.py:873-968)."""
    radius_m = net.radius_m()
    length_m = net.length_m()
    idx = net.args_index()
    node_args = idx["node_args"]
    E = net.num_edges
    deg = net.degree
    entry_mask = net.is_entry_node()
    fixed = (deg == 1) | entry_mask

    eqns = []
    in_edges = [[] for _ in range(net.num_nodes)]
    out_edges = [[] for _ in range(net.num_nodes)]
    for e in range(E):
        out_edges[net.heads[e]].append(e)
        in_edges[net.tails[e]].append(e)
    for n in range(net.num_nodes):
        if fixed[n] or not in_edges[n] or not out_edges[n]:
            continue
        eqns.append({"type": "flow",
                     "vin": [e for e in in_edges[n]],
                     "vout": [e for e in out_edges[n]],
                     "rin": [radius_m[e] for e in in_edges[n]],
                     "rout": [radius_m[e] for e in out_edges[n]]})
    bp = np.asarray(boundary_pressure, float)
    for e in range(E):
        h, t = net.heads[e], net.tails[e]
        eqns.append({
            "type": "pressure", "r": radius_m[e], "L": length_m[e],
            "c": net.c[e], "k": net.k[e], "v": e,
            "hp": bp[h] if fixed[h] else None,
            "hi": int(node_args[h]) if not fixed[h] else None,
            "tp": bp[t] if fixed[t] else None,
            "ti": int(node_args[t]) if not fixed[t] else None,
        })
    return eqns, fixed, idx


def reference_objective(eqns):
    """The reference residual as a closure over the equation dicts
    (per-evaluation Python interpretation, as the reference runs it)."""

    def objective(x):
        out = []
        for q in eqns:
            if q["type"] == "flow":
                qin = sum(abs(x[e]) * np.pi * r ** 2
                          for e, r in zip(q["vin"], q["rin"]))
                qout = sum(abs(x[e]) * np.pi * r ** 2
                           for e, r in zip(q["vout"], q["rout"]))
                out.append(abs(qin - qout) * FLOW_ERROR_FACTOR)
        for q in eqns:
            if q["type"] == "pressure":
                v = abs(x[q["v"]])
                hp = q["hp"] if q["hp"] is not None else x[q["hi"]]
                tp = q["tp"] if q["tp"] is not None else x[q["ti"]]
                dpn = hp - tp
                dph = (10.67 * (v * np.pi * q["r"] ** 2) ** q["k"] * q["L"]
                       / q["c"] ** q["k"] / (2 * q["r"]) ** 4.8704)
                e = (abs(dpn - dph) * 2 if dpn > 0
                     else 10 * abs(tp + dph - hp))
                out.append(e * PRESSURE_ERROR_FACTOR)
        return np.asarray(out)

    return objective


def reference_protocol_solve(net, boundary_pressure, x0=None,
                             xtol: float = 1e-12, ftol: float = 1e-12):
    """Solve with the reference protocol.  Returns a dict with the
    packed solution ``x`` ([v..., p_unknown...]), the recovered full
    ``pressure``/``flow`` arrays, the scipy result, and wall time."""
    from scipy.optimize import least_squares

    eqns, fixed, idx = build_equation_dicts(net, boundary_pressure)
    E = net.num_edges
    M = idx["num_unknowns"] - E
    bp = np.asarray(boundary_pressure, float)
    if x0 is None:
        # reference init: v = 0.4 m/s, P linear 0.8 -> 0.5 of inlet
        # (fluidSimulation.py:1852)
        p_in = bp[net.entry_nodes[0]] if len(net.entry_nodes) else bp.max()
        x0 = np.hstack([np.full(E, 0.4),
                        np.linspace(p_in * 0.8, p_in * 0.5, M)])
    t0 = time.perf_counter()
    res = least_squares(reference_objective(eqns), x0, method="trf",
                        xtol=xtol, ftol=ftol)
    elapsed = time.perf_counter() - t0

    node_args = idx["node_args"]
    pressure = bp.copy()
    unknown = ~fixed
    pressure[unknown] = res.x[node_args[unknown]]  # node_args include the E offset
    radius_m = net.radius_m()
    flow = np.abs(res.x[:E]) * np.pi * radius_m ** 2
    return {"x": res.x, "pressure": pressure, "flow": flow,
            "scipy_result": res, "elapsed_s": elapsed,
            "cost": float(res.cost)}


def orient_by_flow(net, pressure):
    """Flip edges whose head pressure is below the tail pressure so flow
    is positive along every edge's orientation — the state the reference
    guarantees by construction (it orients edges by increasing depth and
    bounds v >= 0, fluidSimulation.py:549-562, 1861).  Required before
    evaluating the reference objective on a solution with physically
    reversed edges."""
    p = np.asarray(pressure, float)
    rev = (p[net.heads] - p[net.tails]) < 0
    heads = np.where(rev, net.tails, net.heads).astype(net.heads.dtype)
    tails = np.where(rev, net.heads, net.tails).astype(net.tails.dtype)
    return net.replace(heads=heads, tails=tails), rev


def cross_check_solution(net, boundary_pressure, pressure, velocity,
                         warm_start: bool = True) -> Dict[str, float]:
    """Score a Newton solution under the reference protocol.

    Orients edges along the solved flow (see ``orient_by_flow``), packs
    the solution in the reference's unknown layout, and returns:
      * ``cost_at_solution`` — the reference objective's 0.5*||r||^2 at
        our solution (near zero == we satisfy their equations exactly);
      * ``cost_at_reference_init`` — the objective at the reference's
        own initialization, for scale;
      * with ``warm_start``: ``warm_cost`` and ``warm_drift`` — scipy
        least_squares started AT our solution; drift ~0 means the
        solution is a fixed point of the reference's own optimizer.
    """
    from scipy.optimize import least_squares

    oriented, _ = orient_by_flow(net, pressure)
    eqns, fixed, idx = build_equation_dicts(oriented, boundary_pressure)
    objective = reference_objective(eqns)

    E = net.num_edges
    node_args = idx["node_args"]
    unknown = ~fixed
    p = np.asarray(pressure, float)
    x = np.empty(idx["num_unknowns"])
    x[:E] = np.abs(np.asarray(velocity, float))
    x[node_args[unknown]] = p[unknown]

    bp = np.asarray(boundary_pressure, float)
    p_in = bp[net.entry_nodes[0]] if len(net.entry_nodes) else bp.max()
    M = idx["num_unknowns"] - E
    x0 = np.hstack([np.full(E, 0.4),
                    np.linspace(p_in * 0.8, p_in * 0.5, M)])

    out = {
        "cost_at_solution": float(0.5 * np.sum(objective(x) ** 2)),
        "cost_at_reference_init": float(0.5 * np.sum(objective(x0) ** 2)),
    }
    if warm_start:
        res = least_squares(objective, x, method="trf",
                            xtol=1e-12, ftol=1e-12)
        out["warm_cost"] = float(res.cost)
        out["warm_drift"] = float(np.abs(res.x - x).max())
        out["warm_pressure_drift_rel"] = float(
            np.abs(res.x[E:] - x[E:]).max() / max(np.abs(p).max(), 1.0))
    return out
