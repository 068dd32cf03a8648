# Copy of arterynetwork_tpu/flow/experiments.py; solves take a device, results read tensors through _np.
"""Experiment drivers (reference C21/C22, fluidSimulation.py:1622-3049).

Programmatic equivalents of the reference's GBMTest* scripts, returning
result dicts instead of printing/plotting.  The solves run on ``device``
(the card unless the caller asks for the CPU).  Each driver composes the same
building blocks the reference does: ground truth -> perturb -> solve ->
validate.

* ``compute_network_test``   — solver round trip on a synthetic tree with
  perturbed terminating pressures (computeNetworkTest, :2533-2709);
* ``solver_sanity_test``     — re-solve an unperturbed network and compare
  to ground truth (GBMTest3 semantics, :1923-2056);
* ``radius_perturbation_study``   — perturb radii, keep terminating
  pressures, re-solve (GBMTest semantics, :1622);
* ``pressure_perturbation_study`` — perturb terminating pressures,
  re-solve (GBMTest2 semantics, :1795);
* ``longitudinal_study``     — GBMTest5 (delegates to flow.longitudinal);
* ``update_edge_radius`` / ``apply_flow_to_network`` — forward-update
  utilities (C22, :2989-3049).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..graphs.network import FlowNetwork
from .adan import ADANModel, set_network_ck
from .ground_truth import create_ground_truth
from .perturb import (perturb_radius_random, perturb_terminating_pressure)
from .physics import dp_from_flow, velocity_from_flow
from .residual import pack_velocity_pressure, validate_equations
from .solvers import solve_pressure_newton
from .system import build_system


def _np(x):
    """A tensor (on any device) or array as a numpy array."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _solve_and_validate(net, boundary_pressure, dtype=None, device="cuda",
                        **solver_kwargs):
    system = build_system(net, boundary_pressure=boundary_pressure,
                          dtype=dtype or torch.float64, device=device)
    sol = solve_pressure_newton(system, **solver_kwargs)
    x = pack_velocity_pressure(system, _np(sol.pressure),
                               np.abs(_np(sol.velocity)))
    report = validate_equations(x, system)
    return system, sol, x, report


def compute_network_test(net: FlowNetwork, tp_scale: float = 0.05,
                         rng: Optional[np.random.Generator] = None,
                         ground_truth_option: int = 1,
                         device="cuda") -> Dict:
    """Perturb terminating pressures by +-tp_scale and re-solve
    (computeNetworkTest, fluidSimulation.py:2533-2709)."""
    if rng is None:
        rng = np.random.default_rng(0)
    gt = create_ground_truth(net, option=ground_truth_option, rng=rng)
    if not gt.success:
        return {"success": False}
    bp = gt.pressure.copy()
    term = net.terminal_nodes()
    bp[term] = bp[term] * (1 + tp_scale * (2 * rng.random(len(term)) - 1))

    system, sol, x, report = _solve_and_validate(net, bp, device=device)
    return {
        "success": True,
        "ground_truth": gt.velocity_pressure,
        "solution": x,
        "pressure": _np(sol.pressure),
        "flow": _np(sol.flow),
        "validation": report,
        "residual_norm": float(sol.residual_norm),
    }


def solver_sanity_test(net: FlowNetwork,
                       rng: Optional[np.random.Generator] = None,
                       ground_truth_option: int = 2,
                       device="cuda") -> Dict:
    """GBMTest3: solve with the *unperturbed* boundary pressures; the
    solution must reproduce the ground truth."""
    if rng is None:
        rng = np.random.default_rng(0)
    gt = create_ground_truth(net, option=ground_truth_option, rng=rng)
    if not gt.success:
        return {"success": False}
    system, sol, x, report = _solve_and_validate(net, gt.pressure,
                                                 device=device)
    err_p = np.nanmax(np.abs(_np(sol.pressure) - gt.pressure))
    err_q = np.nanmax(np.abs(_np(sol.flow) - gt.flow))
    return {"success": True, "max_pressure_error_pa": float(err_p),
            "max_flow_error_m3s": float(err_q), "validation": report}


def radius_perturbation_study(net: FlowNetwork, num_edges: int = 5,
                              reduce_percentage: float = 30.0,
                              adan: Optional[ADANModel] = None,
                              rng: Optional[np.random.Generator] = None,
                              device="cuda") -> Dict:
    """GBMTest: shrink random radii (stenosis), keep terminating
    pressures, re-solve, and report flow redistribution."""
    if rng is None:
        rng = np.random.default_rng(0)
    gt = create_ground_truth(net, option=2, rng=rng)
    if not gt.success:
        return {"success": False}
    perturbed = perturb_radius_random(net, num_edges, reduce_percentage,
                                      rng=rng)
    perturbed = set_network_ck(perturbed, adan)
    system, sol, x, report = _solve_and_validate(perturbed, gt.pressure,
                                                 device=device)
    return {
        "success": True,
        "baseline_flow": gt.flow,
        "perturbed_flow": _np(sol.flow),
        "flow_change": _np(sol.flow) - gt.flow,
        "validation": report,
    }


def pressure_perturbation_study(
        net: FlowNetwork,
        pressure_decrease_per_partition: Dict[str, float],
        partitions: Dict[str, dict],
        rng: Optional[np.random.Generator] = None,
        device="cuda") -> Dict:
    """GBMTest2: scale terminating pressures per compartment, re-solve."""
    if rng is None:
        rng = np.random.default_rng(0)
    gt = create_ground_truth(net, option=2, rng=rng)
    if not gt.success:
        return {"success": False}
    bp = perturb_terminating_pressure(
        net, gt.pressure,
        pressure_decrease_per_partition=pressure_decrease_per_partition,
        partitions=partitions)
    system, sol, x, report = _solve_and_validate(net, bp, device=device)
    return {
        "success": True,
        "baseline_flow": gt.flow,
        "perturbed_flow": _np(sol.flow),
        "pressure": _np(sol.pressure),
        "validation": report,
    }


# ----------------------------------------------------------------------
# Forward-update utilities (C22)
# ----------------------------------------------------------------------
def update_edge_radius(net: FlowNetwork, radius_list,
                       adan: Optional[ADANModel] = None) -> FlowNetwork:
    """Replace radii then re-derive c/k (updateEdgeRadius,
    fluidSimulation.py:2989-3005)."""
    net = net.replace(radius=np.asarray(radius_list, float))
    return set_network_ck(net, adan)


def apply_flow_to_network(net: FlowNetwork, edge_flow,
                          inlet_pressure: Optional[float] = None
                          ) -> FlowNetwork:
    """Given per-edge flows, sweep edges by depth computing pressures with
    the forward Hazen-Williams relation (applyFlowToNetwork,
    fluidSimulation.py:3007-3049)."""
    from ..constants import INLET_PRESSURE

    edge_flow = np.asarray(edge_flow, float)
    pressure = np.full(net.num_nodes, np.nan)
    for entry in net.entry_nodes:
        pressure[entry] = (INLET_PRESSURE if inlet_pressure is None
                           else inlet_pressure)
    radius_m = net.radius_m()
    length_m = net.length_m()
    order = np.argsort(net.edge_depth, kind="stable")
    for e in order:
        h, t = int(net.heads[e]), int(net.tails[e])
        if np.isnan(pressure[h]):
            continue
        dp = dp_from_flow(edge_flow[e], radius_m[e], length_m[e],
                          net.c[e], net.k[e])
        pressure[t] = pressure[h] - dp
    velocity = np.asarray(velocity_from_flow(edge_flow, radius_m))
    return net.replace(node_pressure=pressure, edge_flow=edge_flow,
                       edge_velocity=velocity)


def compare_network_properties(net_before: FlowNetwork,
                               net_after: FlowNetwork) -> Dict:
    """Radius/length ratio study between two timepoints
    (compareNetworkPropertyTest, fluidSimulation.py:2881-2987)."""
    ratio = np.where(net_before.radius > 0,
                     net_after.radius / np.maximum(net_before.radius, 1e-12),
                     np.nan)
    per_depth = {}
    for d in np.unique(net_before.edge_depth):
        sel = net_before.edge_depth == d
        vals = ratio[sel]
        vals = vals[np.isfinite(vals)]
        if vals.size:
            per_depth[int(d)] = {
                "mean": float(vals.mean()), "std": float(vals.std()),
                "n": int(vals.size)}
    finite = ratio[np.isfinite(ratio)]
    return {
        "radius_ratio": ratio,
        "radius_ratio_mean": float(finite.mean()) if finite.size else None,
        "radius_ratio_per_depth": per_depth,
    }


def examine_fluid_result(net: FlowNetwork, solution,
                         partitions: Optional[Dict[str, dict]] = None
                         ) -> Dict:
    """Result audit (examineFluidResult, fluidSimulation.py:4536-4634):
    per-compartment flow totals, terminating pressure stats, pressure
    drop along the tree."""
    from ..constants import PASCAL_PER_MMHG
    from .boundary import COW_PARTITIONS, terminating_nodes_of_partition

    if partitions is None:
        partitions = COW_PARTITIONS
    pressure = _np(solution.pressure)
    flow = _np(solution.flow)
    out = {"per_partition": {}}
    for name, part in partitions.items():
        term = terminating_nodes_of_partition(net, part)
        tp = pressure[term] / PASCAL_PER_MMHG
        inlet_edges = [e for e in range(net.num_edges)
                       if int(net.tails[e]) in set(part["start_nodes"])]
        out["per_partition"][name] = {
            "terminating_pressure_mmhg": {
                "mean": float(tp.mean()) if tp.size else None,
                "min": float(tp.min()) if tp.size else None,
                "max": float(tp.max()) if tp.size else None,
                "n": int(tp.size)},
            "inlet_flow_cm3s": float(
                np.sum(flow[inlet_edges]) * 1e6) if inlet_edges else 0.0,
        }
    out["inlet_pressure_mmhg"] = float(
        pressure[net.entry_nodes].mean() / PASCAL_PER_MMHG)
    out["total_terminal_flow_cm3s"] = float(
        np.sum(flow[[e for e in range(net.num_edges)
                     if net.tails[e] in set(net.terminal_nodes().tolist())]])
        * 1e6)
    return out


def show_flow_info(net: FlowNetwork, solution=None, num: int = 16) -> str:
    """Per-edge / per-node solution summary (showFlowInfo,
    fluidSimulation.py:446-479): flow in cm^3/s, radius/length in cm,
    Hazen-Williams c and k per edge, then pressure in mmHg per node.
    Returns the formatted text (and prints it, like the reference)."""
    from ..constants import PASCAL_PER_MMHG

    flow = None if solution is None else _np(solution.flow)
    pressure = None if solution is None else _np(solution.pressure)
    cm = net.spacing * 100.0
    lines = []
    for e in range(min(num, net.num_edges)):
        q = -1.0 if flow is None else float(flow[e]) * 1e6
        lines.append(
            "Edge {}: flow={:.3f} cm^3/s, radius={:.4f} cm, "
            "length={:.4f} cm, c={:.4f}, k={:.4f}".format(
                e, q, float(net.radius[e]) * cm, float(net.length[e]) * cm,
                float(net.c[e]), float(net.k[e])))
    lines.append("")
    for n in range(min(num, net.num_nodes)):
        p = -1.0 if pressure is None else float(pressure[n]) / PASCAL_PER_MMHG
        lines.append("Node {}: pressure={:.3f} mmHg".format(n, p))
    text = "\n".join(lines)
    print(text)
    return text


def print_terminating_pressure_per_partition(
        net: FlowNetwork, node_pressure, partitions=None) -> Dict[str, list]:
    """Sorted terminating pressures (mmHg) per compartment
    (printTerminatingPressurePerPartition, fluidSimulation.py:1365-1391).
    Returns ``{name: [mmHg, ...]}`` and prints one line per compartment."""
    from ..constants import PASCAL_PER_MMHG
    from .boundary import COW_PARTITIONS, terminating_nodes_of_partition

    if partitions is None:
        partitions = COW_PARTITIONS
    pressure = _np(node_pressure)
    out = {}
    for name, part in partitions.items():
        term = terminating_nodes_of_partition(net, part)
        tp = sorted(round(float(pressure[n]) / PASCAL_PER_MMHG, 2)
                    for n in term)
        out[name] = tp
        print("Terminating pressures in {} are {} mmHg".format(name, tp))
    return out


def load_fluid_result(store, name: str):
    """Load a saved fluid-simulation result pickle and recover the packed
    ``velocityPressure`` unknown vector (loadFluidResult/loadFluidResult2,
    fluidSimulation.py:1547-1620).

    Handles both this framework's result pickles (which carry
    ``velocityPressure`` directly, flow/studies.py) and the reference's
    legacy ``{'perturbedYear': {'nodeInfoDict', 'edgeInfoDict'}}`` layout,
    where the vector is rebuilt from the per-item ``argsIndex`` entries.
    Returns ``(velocity_pressure, result_dict)``."""
    result = store.load_pickle(name)
    if "velocityPressure" in result:
        return np.asarray(result["velocityPressure"], dtype=float), result
    year = result.get("perturbedYear") or result.get("solvedYear")
    if year is None or "nodeInfoDict" not in year:
        raise ValueError(
            "unrecognized fluid result layout in {!r}".format(name))
    node_info, edge_info = year["nodeInfoDict"], year["edgeInfoDict"]
    n_unknowns = (
        sum(1 for i in node_info.values() if "argsIndex" in i)
        + sum(1 for i in edge_info.values() if "argsIndex" in i))
    x = np.zeros(n_unknowns, dtype=float)
    for info in node_info.values():
        if "argsIndex" in info:
            x[info["argsIndex"]] = info["simulationData"]["pressure"]
    for info in edge_info.values():
        if "argsIndex" in info:
            x[info["argsIndex"]] = info["simulationData"]["velocity"]
    return x, result
