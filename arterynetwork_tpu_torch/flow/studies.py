# Copy of arterynetwork_tpu/flow/studies.py; solves take a device, results read tensors through _np.
"""Longitudinal flow-split / terminating-pressure studies — the
reference's test1-test6 drivers (fluidSimulation.py:3133-3837) plus
GBMTest4 (:2058-2148), the GBMTest5 per-timestep result persistence
(:2283-2291) and the GBMTest5b volume/pressure-drop diagnostic (:2303).  These are the scientific payload of the paper: how flows,
terminating pressures and root pressures evolve as vessel radii
interpolate between two imaging timepoints.

Design: each driver takes a FlowNetwork + end-timepoint radii (produced
by ``perturb_radius_from_timepoint`` or ``load_network``) and returns a
structured result dict; figures are composed separately in
``viz.study_plots``.  Where the reference runs a multi-minute
basinhopping per timestep serially, the solver-based studies (test6,
GBMTest4) run one exact Newton solve per timestep on ``device`` (the
card unless the caller asks for the CPU).  (GBMTest6, fluidSimulation.py:2388, is GBMTest5 with
retuned basinhopping temperature/stepsize — escape-from-bad-basin knobs
that have no analog in an exact Newton solve; flow.longitudinal covers
both.)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..constants import PASCAL_PER_MMHG
from ..graphs.network import FlowNetwork
from .adan import ADANModel
from .boundary import (COW_PARTITIONS, bfs_partition,
                       fit_terminating_pressure_to_path_length,
                       set_terminating_pressure,
                       terminating_nodes_of_partition,
                       volume_per_partition)
from .experiments import _np, apply_flow_to_network, update_edge_radius
from .ground_truth import create_ground_truth
from .perturb import (interpolate_radii, perturb_radius_from_timepoint,
                      perturb_radius_per_partition)
from .residual import pack_velocity_pressure, validate_equations
from .solvers import solve_pressure_newton
from .system import build_system


def _terminating_nodes(net: FlowNetwork) -> np.ndarray:
    """Degree-1, non-root nodes (the reference's terminatingNodes list,
    fluidSimulation.py:3160)."""
    deg = net.degree
    return np.nonzero((deg == 1) & (net.node_depth != 0))[0]


def radius_timesteps(net: FlowNetwork, radius_end, num_timesteps: int,
                     interpolation_option: int = 1) -> np.ndarray:
    """[T, E] radii interpolated between net.radius and radius_end
    (linear / tanh, fluidSimulation.py:3177-3190)."""
    return interpolate_radii(net.radius, np.asarray(radius_end, float),
                             num_timesteps, option=interpolation_option)


def flow_split_study(net: FlowNetwork, radius_end,
                     num_timesteps: int = 4,
                     interpolation_option: int = 1,
                     ground_truth_option: int = 2,
                     adan: Optional[ADANModel] = None,
                     rng: Optional[np.random.Generator] = None,
                     partitions: Optional[Dict[str, dict]] = None) -> Dict:
    """test1 / test5 (fluidSimulation.py:3133-3283, 3542-3670): per
    timestep, update radii + re-derive c/k, regenerate the depth-sweep
    ground truth (flow split by cross-sectional area for option 2) and
    record terminating pressures, node pressures, flows and c values."""
    if rng is None:
        rng = np.random.default_rng(0)
    if partitions is None:
        partitions = COW_PARTITIONS
    radii = radius_timesteps(net, radius_end, num_timesteps,
                             interpolation_option)
    term = _terminating_nodes(net)
    T, E, N = num_timesteps, net.num_edges, net.num_nodes
    tp = np.full((len(term), T), np.nan)
    node_p = np.full((N, T), np.nan)
    c_arr = np.full((E, T), np.nan)
    flow_arr = np.full((E, T), np.nan)
    failed: List[int] = []
    for t in range(T):
        net_t = update_edge_radius(net, radii[t], adan)
        gt = create_ground_truth(net_t, option=ground_truth_option,
                                 rng=np.random.default_rng(rng.integers(2**31)))
        if not gt.success:
            failed.append(t)
            continue
        tp[:, t] = gt.pressure[term] / PASCAL_PER_MMHG
        node_p[:, t] = gt.pressure / PASCAL_PER_MMHG
        c_arr[:, t] = net_t.c
        flow_arr[:, t] = gt.flow
    return {
        "terminating_nodes": term,
        "terminating_pressures_mmhg": tp,
        "node_pressures_mmhg": node_p,
        "c": c_arr,
        "flow": flow_arr,
        "radii": radii,
        "failed_timesteps": failed,
        "partitions": partitions,
    }


def same_flow_study(net: FlowNetwork, radius_end,
                    num_timesteps: int = 4,
                    interpolation_option: int = 1,
                    adan: Optional[ADANModel] = None,
                    baseline_flow=None,
                    rng: Optional[np.random.Generator] = None,
                    partitions: Optional[Dict[str, dict]] = None) -> Dict:
    """test2 / test3 (fluidSimulation.py:3285-3470): freeze the baseline
    (BraVa) flow pattern and push it through the radius-interpolated
    networks with the forward Hazen-Williams sweep; terminating pressures
    respond to the geometry change alone."""
    if rng is None:
        rng = np.random.default_rng(0)
    if partitions is None:
        partitions = COW_PARTITIONS
    if baseline_flow is None:
        gt0 = create_ground_truth(net, option=2, rng=rng)
        if not gt0.success:
            return {"success": False}
        baseline_flow = gt0.flow
    baseline_flow = np.asarray(baseline_flow, float)
    radii = radius_timesteps(net, radius_end, num_timesteps,
                             interpolation_option)
    term = _terminating_nodes(net)
    T, E, N = num_timesteps, net.num_edges, net.num_nodes
    tp = np.full((len(term), T), np.nan)
    node_p = np.full((N, T), np.nan)
    c_arr = np.full((E, T), np.nan)
    flow_arr = np.tile(baseline_flow[:, None], (1, T))
    for t in range(T):
        net_t = update_edge_radius(net, radii[t], adan)
        net_t = apply_flow_to_network(net_t, baseline_flow)
        tp[:, t] = net_t.node_pressure[term] / PASCAL_PER_MMHG
        node_p[:, t] = net_t.node_pressure / PASCAL_PER_MMHG
        c_arr[:, t] = net_t.c
    return {
        "success": True,
        "terminating_nodes": term,
        "terminating_pressures_mmhg": tp,
        "node_pressures_mmhg": node_p,
        "c": c_arr,
        "flow": flow_arr,
        "radii": radii,
        "partitions": partitions,
    }


def two_timepoint_comparison(net: FlowNetwork, radius_end,
                             adan: Optional[ADANModel] = None,
                             rng: Optional[np.random.Generator] = None
                             ) -> Dict:
    """test4 (fluidSimulation.py:3473-3540): solve the ground truth at
    both timepoints and tabulate per-edge radii (mm) before/after plus
    the two pressure/flow fields."""
    if rng is None:
        rng = np.random.default_rng(0)
    mm = net.spacing * 1000.0
    gt0 = create_ground_truth(net, option=2,
                              rng=np.random.default_rng(rng.integers(2**31)))
    net1 = update_edge_radius(net, np.asarray(radius_end, float), adan)
    gt1 = create_ground_truth(net1, option=2,
                              rng=np.random.default_rng(rng.integers(2**31)))
    return {
        "success": bool(gt0.success and gt1.success),
        "radius_mm_before": net.radius * mm,
        "radius_mm_after": net1.radius * mm,
        "pressure_before": gt0.pressure if gt0.success else None,
        "pressure_after": gt1.pressure if gt1.success else None,
        "flow_before": gt0.flow if gt0.success else None,
        "flow_after": gt1.flow if gt1.success else None,
    }


def _solve_with_tp(net_t: FlowNetwork, boundary_pressure, dtype,
                   max_iter: int, linear_solver: str, device):
    system = build_system(net_t, boundary_pressure=boundary_pressure,
                          dtype=dtype or torch.float64, device=device)
    sol = solve_pressure_newton(system, max_iter=max_iter,
                                linear_solver=linear_solver)
    x = pack_velocity_pressure(system, _np(sol.pressure),
                               np.abs(_np(sol.velocity)))
    report = validate_equations(x, system,
                                signed_velocity=_np(sol.velocity))
    return system, sol, x, report


def tp_fit_solve_study(net: FlowNetwork, radius_end,
                       num_timesteps: int = 4,
                       interpolation_option: int = 1,
                       slope_scale: float = 1.0,
                       adan: Optional[ADANModel] = None,
                       partitions: Optional[Dict[str, dict]] = None,
                       rng: Optional[np.random.Generator] = None,
                       dtype=None, max_iter: int = 60,
                       linear_solver: str = "auto",
                       store=None, version: int = 5,
                       device="cuda") -> Dict:
    """test6 (fluidSimulation.py:3671-3837): fit terminating pressure vs
    path length per compartment from the baseline ground truth, then per
    interpolated timestep set terminating pressures from the (optionally
    slope-scaled) fit and run the full network solve; validate each
    solution and persist the reference's per-timestep result pickles
    ``fluidSimulationResultTest6_Timestep={t}_v{version}.pkl`` when a
    store is given (v2/v3/v4 = slope reduced 30/40/20%, v5 = fit from
    ground truth — the reference's saved-result contract)."""
    if rng is None:
        rng = np.random.default_rng(0)
    if partitions is None:
        partitions = COW_PARTITIONS
    gt0 = create_ground_truth(net, option=2,
                              rng=np.random.default_rng(rng.integers(2**31)))
    if not gt0.success:
        return {"success": False}
    fit = fit_terminating_pressure_to_path_length(net, gt0.pressure,
                                                  partitions)
    fit = {name: (s * slope_scale, i) for name, (s, i) in fit.items()}
    radii = radius_timesteps(net, radius_end, num_timesteps,
                             interpolation_option)
    term = _terminating_nodes(net)
    results = []
    tp = np.full((len(term), num_timesteps), np.nan)
    for t in range(num_timesteps):
        net_t = update_edge_radius(net, radii[t], adan)
        bp = set_terminating_pressure(net_t, partitions,
                                      fit_per_partition=fit)
        entry = net_t.entry_nodes
        bp[entry] = gt0.pressure[entry]
        unset = np.isnan(bp)
        bp[unset] = 0.0  # non-fixed slots ignored by build_system
        system, sol, x, report = _solve_with_tp(
            net_t, bp, dtype, max_iter, linear_solver, device)
        pressure = _np(sol.pressure)
        tp[:, t] = pressure[term] / PASCAL_PER_MMHG
        row = {
            "timestep": t,
            "velocityPressure": x,
            "pressure": pressure,
            "flow": _np(sol.flow),
            "validation": report,
            "residual_norm": float(sol.residual_norm),
        }
        results.append(row)
        if store is not None:
            store.save_pickle(
                "fluidSimulationResultTest6_Timestep={}_v{}.pkl".format(
                    t, version),
                {"velocityPressure": x, "pressure": pressure,
                 "flow": _np(sol.flow),
                 "radius": np.asarray(net_t.radius),
                 "fitResultPerPartition": fit,
                 "validation": {k: v for k, v in report.items()
                                if not isinstance(v, np.ndarray)}})
    return {
        "success": True,
        "fit_per_partition": fit,
        "terminating_nodes": term,
        "terminating_pressures_mmhg": tp,
        "timesteps": results,
        "radii": radii,
    }


def gbm_test4(net: FlowNetwork,
              partitions: Optional[Dict[str, dict]] = None,
              partition_to_perturb: Sequence[str] = ("LMCA",),
              reduce_percentage: float = 10.0,
              adan: Optional[ADANModel] = None,
              rng: Optional[np.random.Generator] = None,
              dtype=None, max_iter: int = 60,
              linear_solver: str = "auto", store=None,
              device="cuda") -> Dict:
    """GBMTest4 (fluidSimulation.py:2058-2148): shrink all radii of the
    named compartments (default LMCA -10%), re-derive c/k, set
    terminating pressures from the ADAN path-length relationship
    (setTerminatingPressure option 1) and solve the network.  Persists
    the reference's result pickle when a store is given."""
    if rng is None:
        rng = np.random.default_rng(0)
    if partitions is None:
        partitions = COW_PARTITIONS
    perturbed = perturb_radius_per_partition(
        net, list(partition_to_perturb), reduce_percentage,
        partitions=partitions)
    perturbed = update_edge_radius(perturbed, perturbed.radius, adan)
    gt = create_ground_truth(perturbed, option=2,
                             rng=np.random.default_rng(rng.integers(2**31)))
    bp = set_terminating_pressure(perturbed, partitions)
    entry = perturbed.entry_nodes
    bp[entry] = (gt.pressure[entry] if gt.success
                 else np.nanmax(bp) * 1.05)
    bp[np.isnan(bp)] = 0.0
    system, sol, x, report = _solve_with_tp(perturbed, bp, dtype,
                                            max_iter, linear_solver, device)
    result = {
        "success": True,
        "velocityPressure": x,
        "pressure": _np(sol.pressure),
        "flow": _np(sol.flow),
        "validation": report,
        "residual_norm": float(sol.residual_norm),
        "perturbed_radius": perturbed.radius,
    }
    if store is not None:
        store.save_pickle(
            "fluidSimulationResultGBMTest4(solvedYear=BraVa, "
            "perturbNetworkOption=1).pkl",
            {"solvedYear": {"year": "BraVa",
                            "velocityPressure": x,
                            "pressure": result["pressure"],
                            "flow": result["flow"]}})
    return result


def gbm_test5b(net: FlowNetwork, radius_end,
               num_timesteps: int = 4,
               interpolation_option: int = 1,
               excluded_edges: Sequence[int] = (0, 1, 2, 3, 7),
               partitions: Optional[Dict[str, dict]] = None,
               rng: Optional[np.random.Generator] = None) -> Dict:
    """GBMTest5b (fluidSimulation.py:2303-2388): the diagnostic
    load-variant of GBMTest5.  Take the far-end radii from the second
    imaging timepoint (perturbNetwork option 2, keeping the excluded
    large inlet edges at their baseline radii), interpolate per-edge
    radii across timesteps, and per timestep report each compartment's
    relative volume change against the baseline — negated, this is the
    per-partition terminating-pressure-drop adjustment GBMTest5 feeds to
    ``perturb_terminating_pressure`` (pressureDropChangePerPartition =
    -(V_t - V_0)/V_0).  No network solve runs; the reference's loop
    stops at printing the adjustments, and this returns them.

    Also fits terminating pressure vs path length on the baseline ground
    truth (the reference computes fitResultPerPartition before the loop;
    NaN slopes if the depth-sweep fails on this topology)."""
    if rng is None:
        rng = np.random.default_rng(0)
    if partitions is None:
        partitions = COW_PARTITIONS
    volume0 = volume_per_partition(net, partitions)
    net_end = perturb_radius_from_timepoint(net, np.asarray(radius_end, float),
                                            excluded_edges)
    radii = radius_timesteps(net, net_end.radius, num_timesteps,
                             interpolation_option)
    gt0 = create_ground_truth(net, option=2,
                              rng=np.random.default_rng(rng.integers(2**31)))
    fit = (fit_terminating_pressure_to_path_length(net, gt0.pressure,
                                                   partitions)
           if gt0.success else None)
    volume_t: List[Dict[str, float]] = []
    drop_change: List[Dict[str, float]] = []
    for t in range(num_timesteps):
        net_t = net.replace(radius=radii[t])
        vols = volume_per_partition(net_t, partitions)
        volume_t.append(vols)
        drop_change.append({
            name: -((vols[name] - volume0[name]) / volume0[name])
            if volume0[name] > 0 else 0.0
            for name in vols})
    return {
        "success": True,
        "radii": radii,
        "volume_per_partition_baseline": volume0,
        "volume_per_partition": volume_t,
        "pressure_drop_change_per_partition": drop_change,
        "fit_per_partition": fit,
    }


def save_gbm_test5_results(store, net: FlowNetwork, batch, solution,
                           version: int = 1) -> List[str]:
    """Persist per-timestep GBMTest5 result pickles with the reference's
    names (``fluidSimulationResult_GBMTest5_Timestep={t}_v{v}.pkl``,
    fluidSimulation.py:2283-2291).  ``batch``/``solution`` come from
    flow.longitudinal; each pickle carries the packed velocityPressure
    vector plus the per-timestep inputs (the assembly runs on the CPU)."""
    pressures = _np(solution.pressure)
    velocities = _np(solution.velocity)
    flows = _np(solution.flow)
    names = []
    T = pressures.shape[0]
    for t in range(T):
        net_t = net.replace(
            radius=np.asarray(batch["radius_m"][t]) / net.spacing,
            c=np.asarray(batch["c"][t]), k=np.asarray(batch["k"][t]))
        system = build_system(
            net_t, boundary_pressure=batch["boundary_pressure"][t],
            device="cpu")
        x = pack_velocity_pressure(system, pressures[t],
                                   np.abs(velocities[t]))
        name = "fluidSimulationResult_GBMTest5_Timestep={}_v{}.pkl".format(
            t, version)
        store.save_pickle(name, {
            "velocityPressure": x,
            "pressure": pressures[t],
            "flow": flows[t],
            "radius_m": np.asarray(batch["radius_m"][t]),
            "c": np.asarray(batch["c"][t]),
            "k": np.asarray(batch["k"][t]),
            "boundaryPressure": np.asarray(batch["boundary_pressure"][t]),
        })
        names.append(name)
    return names


def flow_proportions_per_partition(net: FlowNetwork, flow_timesteps,
                                   partitions: Optional[Dict] = None
                                   ) -> Dict[str, np.ndarray]:
    """Per-compartment share of total inlet flow per timestep
    (plotFlowProportion input, fluidSimulation.py:4401-4473)."""
    if partitions is None:
        partitions = COW_PARTITIONS
    flow_timesteps = np.asarray(flow_timesteps, float)  # [E, T]
    out = {}
    total = None
    for name, part in partitions.items():
        starts = set(int(s) for s in part["start_nodes"])
        inlet_edges = [e for e in range(net.num_edges)
                       if int(net.tails[e]) in starts]
        flows = np.abs(flow_timesteps[inlet_edges]).sum(axis=0)
        out[name] = flows
        total = flows if total is None else total + flows
    if total is not None:
        for name in out:
            with np.errstate(invalid="ignore", divide="ignore"):
                out[name] = np.where(total > 0, out[name] / total, np.nan)
    return out
