# Copy of arterynetwork_tpu/flow/longitudinal.py; the vmapped solve is solve_pressure_newton_batch on a device.
"""Longitudinal tumor-progression engine (reference C21: GBMTest5,
fluidSimulation.py:2150-2301) — batched on-device.

Protocol per timestep t (identical to the reference):
  1. per-edge radii interpolated between the two imaging timepoints
     (linear or tanh, :2192-2205);
  2. Hazen-Williams c/k re-derived from the ADAN model (:2225,
     updateEdgeRadius + setNetwork);
  3. per-compartment volume change vs the ground-truth network drives the
     terminating-pressure drop scaling
     (pressureDropChange = -volumeChange, :2226-2234);
  4. the network is re-solved.

Where the reference runs a multi-minute basinhopping per timestep
*serially*, here every timestep is one row of one batched Newton solve
(``solve_pressure_newton_batch``): all timesteps solve together on the
card, each row exactly as its own solve would, with one host read per
Newton step for the whole batch.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..graphs.network import FlowNetwork
from .adan import ADANModel, set_network_ck
from .boundary import COW_PARTITIONS, volume_per_partition
from .perturb import interpolate_radii, perturb_terminating_pressure
from .solvers import FlowSolution, SolveStats, solve_pressure_newton_batch
from .system import build_system


def build_timestep_batch(
    net: FlowNetwork,
    ground_truth_pressure: np.ndarray,
    radius_end: np.ndarray,
    num_timesteps: int = 5,
    interpolation_option: int = 1,
    adan_model: Optional[ADANModel] = None,
    partitions: Dict[str, dict] = None,
):
    """Prepare per-timestep (radius, c, k, boundary-pressure) arrays.

    ``ground_truth_pressure`` is the reference solution at timestep 0
    (used both for the baseline volumes and the unperturbed terminating
    pressures).  Returns dict of stacked arrays [T, ...].
    """
    if adan_model is None:
        adan_model = ADANModel()
    if partitions is None:
        partitions = COW_PARTITIONS

    radii = interpolate_radii(net.radius, radius_end, num_timesteps,
                              option=interpolation_option)
    vol0 = volume_per_partition(net, partitions)

    radius_rows, c_rows, k_rows, bp_rows = [], [], [], []
    for t in range(num_timesteps):
        net_t = net.replace(radius=radii[t])
        net_t = set_network_ck(net_t, adan_model)
        vol_t = volume_per_partition(net_t, partitions)
        drop_change = {name: -(vol_t[name] - vol0[name]) / vol0[name]
                       for name in vol0}
        bp = perturb_terminating_pressure(
            net_t, ground_truth_pressure,
            pressure_drop_change_per_partition=drop_change,
            partitions=partitions)
        radius_rows.append(net_t.radius_m())
        c_rows.append(net_t.c)
        k_rows.append(net_t.k)
        bp_rows.append(bp)

    return {
        "radius_m": np.stack(radius_rows),
        "c": np.stack(c_rows),
        "k": np.stack(k_rows),
        "boundary_pressure": np.stack(bp_rows),
        "pressure_drop_change": drop_change,
    }


def solve_timestep_batch(net: FlowNetwork, batch, dtype=torch.float64,
                         max_iter: int = 60,
                         linear_solver: str = "auto", device="cuda",
                         stats: Optional[SolveStats] = None) -> FlowSolution:
    """Solve all timesteps at once, on ``device``.  Returns stacked
    FlowSolution with leading timestep axis (``iterations`` i32[T]).  The
    elimination plan is structural, so one plan serves every timestep."""
    base = build_system(net, boundary_pressure=batch["boundary_pressure"][0],
                        dtype=dtype, device=device)
    fixed = base.node_fixed.cpu().numpy()

    plan = None
    if linear_solver in ("auto", "tree"):
        from .tree_solver import plan_elimination
        plan = plan_elimination(base)

    bp = np.where(fixed[None, :], batch["boundary_pressure"], 0.0)

    def rows(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device,
                               dtype=dtype)

    system = dataclasses.replace(
        base, radius_m=rows(batch["radius_m"]), c=rows(batch["c"]),
        k=rows(batch["k"]), node_fixed_pressure=rows(bp))
    return solve_pressure_newton_batch(system, max_iter=max_iter,
                                       linear_solver=linear_solver,
                                       plan=plan, stats=stats)


def run_longitudinal(net: FlowNetwork, ground_truth_pressure, radius_end,
                     num_timesteps: int = 5, interpolation_option: int = 1,
                     adan_model: Optional[ADANModel] = None,
                     partitions: Dict[str, dict] = None,
                     dtype=torch.float64, linear_solver: str = "auto",
                     device="cuda"):
    """End-to-end GBMTest5: interpolate radii, adjust terminating
    pressures by compartment volume change, batch-solve all timesteps.

    Returns (batch_inputs, FlowSolution[T])."""
    batch = build_timestep_batch(
        net, ground_truth_pressure, radius_end, num_timesteps,
        interpolation_option, adan_model, partitions)
    sol = solve_timestep_batch(net, batch, dtype=dtype,
                               linear_solver=linear_solver, device=device)
    return batch, sol
