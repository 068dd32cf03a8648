# Copy of arterynetwork_tpu/flow/perturb.py, unchanged.
"""Perturbation operators — the reference's scientific fault injection
(C19: perturbNetwork / perturbTerminatingPressure,
fluidSimulation.py:1256-1363).

Radius perturbations:
  * option 1 — k random edges shrunk by a percentage (stenosis draw);
  * option 2 — radii replaced from another timepoint, excluding listed
    edges (longitudinal update);
  * option 3 — all edges of named compartments shrunk by a percentage.

Terminating-pressure perturbations:
  * options 1-3 — per-partition multiplicative pressure change;
  * options 4-5 — per-partition *pressure-drop* scaling:
    new = root - (root - old) * (1 + change).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from ..constants import INLET_PRESSURE
from ..graphs.network import FlowNetwork
from .boundary import COW_PARTITIONS, bfs_partition, terminating_nodes_of_partition


def perturb_radius_random(net: FlowNetwork, num_edges: int = 5,
                          reduce_percentage: float = 30.0,
                          rng: Optional[np.random.Generator] = None
                          ) -> FlowNetwork:
    """perturbNetwork option 1 (fluidSimulation.py:1271-1280)."""
    if rng is None:
        rng = np.random.default_rng(0)
    radius = net.radius.copy()
    chosen = rng.choice(net.num_edges, num_edges)
    radius[chosen] = radius[chosen] * (1 - reduce_percentage / 100.0)
    return net.replace(radius=radius)


def perturb_radius_from_timepoint(net: FlowNetwork, new_radius,
                                  excluded_edges: Sequence[int] = ()
                                  ) -> FlowNetwork:
    """perturbNetwork option 2 (fluidSimulation.py:1282-1292): take radii
    from another timepoint except for the excluded (large inlet) edges."""
    radius = net.radius.copy()
    excluded = set(int(e) for e in excluded_edges)
    for e in range(net.num_edges):
        if e not in excluded:
            radius[e] = new_radius[e]
    return net.replace(radius=radius)


def perturb_radius_per_partition(net: FlowNetwork,
                                 partitions_to_perturb: Sequence[str],
                                 reduce_percentage: float,
                                 partitions: Dict[str, dict] = None
                                 ) -> FlowNetwork:
    """perturbNetwork option 3 (fluidSimulation.py:1294-1306)."""
    if partitions is None:
        partitions = COW_PARTITIONS
    radius = net.radius.copy()
    for name in partitions_to_perturb:
        part = partitions[name]
        res = bfs_partition(net, part["start_nodes"], part["boundary_nodes"])
        for e in res["visited_edges"]:
            radius[e] = radius[e] * (1 - reduce_percentage / 100.0)
    return net.replace(radius=radius)


def perturb_terminating_pressure(
        net: FlowNetwork, node_pressure,
        pressure_decrease_per_partition: Optional[Dict[str, float]] = None,
        pressure_drop_change_per_partition: Optional[Dict[str, float]] = None,
        partitions: Dict[str, dict] = None,
        root_pressure: float = INLET_PRESSURE) -> np.ndarray:
    """perturbTerminatingPressure (fluidSimulation.py:1312-1363).

    Exactly one of the two perturbation dicts must be given:
      * ``pressure_decrease_per_partition`` (options 1-3):
        p *= (1 - decrease)
      * ``pressure_drop_change_per_partition`` (options 4-5):
        p = root - (root - p) * (1 + change)
    """
    if (pressure_decrease_per_partition is None) == (
            pressure_drop_change_per_partition is None):
        raise ValueError("give exactly one perturbation dict")
    if partitions is None:
        partitions = COW_PARTITIONS
    pressure = np.asarray(node_pressure, dtype=float).copy()
    for name, part in partitions.items():
        for node in terminating_nodes_of_partition(net, part):
            if pressure_decrease_per_partition is not None:
                dec = pressure_decrease_per_partition.get(name, 0.0)
                pressure[node] = pressure[node] * (1 - dec)
            else:
                ch = pressure_drop_change_per_partition.get(name, 0.0)
                pressure[node] = (root_pressure
                                  - (root_pressure - pressure[node])
                                  * (1 + ch))
    return pressure


def interpolate_radii(radius_start, radius_end, num_timesteps: int,
                      option: int = 1) -> np.ndarray:
    """Per-edge radius interpolation across timesteps (GBMTest5,
    fluidSimulation.py:2192-2205).

    option 1: linear; option 2: tanh-bent (the reference's 'logistic').
    Returns f64[T, E].  Timestep 0 is always the start radii and the
    last timestep the end radii, so ``num_timesteps`` must be >= 2
    (the reference's GBMTest5 contract) — T=1 would silently return
    only the END radii in the slot labeled baseline."""
    if num_timesteps < 2:
        raise ValueError(
            f"num_timesteps must be >= 2, got {num_timesteps}: timestep "
            "0 is the start radii and the last timestep the end radii")
    r0 = np.asarray(radius_start, float)
    r1 = np.asarray(radius_end, float)
    T = num_timesteps
    out = np.zeros((T, r0.shape[0]))
    out[0] = r0
    out[-1] = r1
    for t in range(1, T - 1):
        if option == 1:
            out[t] = (r1 - r0) / (T - 1) * t + r0
        elif option == 2:
            out[t] = (r1 - r0) * np.tanh(t / (T - 1) * 2) + r0
        else:
            raise ValueError(f"unknown interpolation option {option}")
    return out
