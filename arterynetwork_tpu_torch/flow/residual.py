"""Reference-parity residual and validation oracle (port of the JAX
package's flow/residual.py).

``residual_reference`` reproduces ``computeNetworkDetail``
(fluidSimulation.py:4636-4728) exactly — including the asymmetric x10
penalty for head<=tail pressure inversions and the error magnification
factors — as tensor operations over index arrays on the system's device.

``validate_equations`` is the counterpart of ``validateFluidEquations``
(fluidSimulation.py:1105-1196): it returns per-equation physical errors
(mmHg / cm^3 s^-1) and summary statistics instead of printing them.  The
audit runs in numpy on the host, from the system's fields.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..constants import (
    BOUNDARY_ERROR_FACTOR,
    FLOW_ERROR_FACTOR,
    PASCAL_PER_MMHG,
    PRESSURE_ERROR_FACTOR,
)
from .physics import dp_from_flow, flow_from_velocity
from .segment_sum import cached, plan_segment_sum, segment_sum
from .system import FlowSystem


def _host(system: FlowSystem) -> dict:
    """The system's fields as numpy arrays."""
    names = ("head", "tail", "radius_m", "length_m", "c", "k", "node_fixed",
             "node_fixed_pressure", "node_unknown_index", "conserve_nodes")
    return {n: getattr(system, n).cpu().numpy() for n in names}


def _full_pressure_np(h, p_unknown):
    padded = np.concatenate([p_unknown, np.zeros(1, p_unknown.dtype)])
    return np.where(h["node_fixed"], h["node_fixed_pressure"],
                    padded[h["node_unknown_index"]])


def _node_net_flow(flow, system: FlowSystem):
    """Net inflow minus outflow per node (flow is positive head->tail),
    each summed in edge order (flow/segment_sum.py)."""
    N, E = system.num_nodes, system.num_edges

    def build():
        return plan_segment_sum(
            np.concatenate([system.tail.cpu().numpy(),
                            system.head.cpu().numpy() + N]),
            np.tile(np.arange(E), 2), 2 * N, E, device=system.device)

    plan = cached(system.plans, ("in_out", str(system.device)),
                  (system.head, system.tail), build)
    inflow, outflow = segment_sum(plan, flow).split(N, dim=-1)
    return inflow - outflow


def residual_reference(x, system: FlowSystem, error_norm: int = 0):
    """Magnified residual vector in the reference's equation order.

    error_norm = 0 returns the vector (flow eqns, pressure eqns, boundary
    eqns); otherwise returns the L-`error_norm` norm, matching
    computeNetworkDetail's ``errorNorm`` argument.
    """
    x = torch.as_tensor(x, device=system.device)
    E = system.num_edges
    velocity = x[:E]
    p_full = system.full_pressure(x[E:])
    v_abs = torch.abs(velocity)

    # Flow-conservation equations (fluidSimulation.py:4650-4658).
    flow = flow_from_velocity(v_abs, system.radius_m)
    net = _node_net_flow(flow, system)
    eqn_flow = torch.abs(net[system.conserve_nodes]) * FLOW_ERROR_FACTOR

    # Pressure equations (fluidSimulation.py:4659-4691).
    dp_node = p_full[system.head] - p_full[system.tail]
    dp_hw = dp_from_flow(flow, system.radius_m, system.length_m, system.c,
                         system.k)
    eqn_forward = torch.abs(dp_node - dp_hw) * 2.0
    eqn_reversed = 10.0 * torch.abs(dp_hw - dp_node)
    eqn_pressure = torch.where(dp_node > 0, eqn_forward, eqn_reversed)
    eqn_pressure = eqn_pressure * PRESSURE_ERROR_FACTOR

    # Inlet-velocity boundary equations (fluidSimulation.py:4694-4697).
    eqn_boundary = ((velocity[system.bc_edge] - system.bc_velocity)
                    * BOUNDARY_ERROR_FACTOR)

    eqns = torch.cat([eqn_flow, eqn_pressure, eqn_boundary])
    if error_norm == 0:
        return eqns
    return torch.linalg.vector_norm(eqns, ord=error_norm)


def validate_equations(x, system: FlowSystem,
                       signed_velocity=None) -> Dict[str, np.ndarray]:
    """Physical residual audit (validateFluidEquations parity).

    Returns a dict with per-equation true errors and summary statistics:
      * ``pressure_error_mmhg``: |dP_node - dP_HW| per edge, in mmHg
      * ``flow_error_cm3s``: |Q_in - Q_out| per conservation node, cm^3/s
      * ``n_pressure_inversions``: edges where head pressure <= tail pressure
      * summary mean/std/min/max for both error families.

    CAVEAT (surfaced as ``flow_audit_note``): the reference packs
    nonnegative velocities (bounds v in [0, 5] m/s with direction
    encoded by edge orientation), so this audit takes |v| and an edge
    whose flow physically reverses shows up as conservation "error"
    even in an exactly-converged solution.  Pass the solver's
    ``signed_velocity`` to additionally get ``flow_error_signed_cm3s``
    (the physical conservation residual) and ``n_reversed_edges``.
    """
    h = _host(system)
    x = np.asarray(x.cpu().numpy() if isinstance(x, torch.Tensor) else x)
    E = system.num_edges
    N = system.num_nodes
    velocity = x[:E]
    p_full = _full_pressure_np(h, x[E:])
    v_abs = np.abs(velocity)

    def net_flow(flow):
        inflow = np.zeros(N, flow.dtype)
        outflow = np.zeros(N, flow.dtype)
        np.add.at(inflow, h["tail"], flow)
        np.add.at(outflow, h["head"], flow)
        return inflow - outflow

    flow = flow_from_velocity(v_abs, h["radius_m"])
    net = net_flow(flow)
    flow_error = np.abs(net[h["conserve_nodes"]]) * 1e6  # cm^3/s

    dp_node = p_full[h["head"]] - p_full[h["tail"]]
    dp_hw = dp_from_flow(flow, h["radius_m"], h["length_m"], h["c"], h["k"])
    pressure_error = np.abs(np.abs(dp_node) - dp_hw) / PASCAL_PER_MMHG
    inversions = int(np.sum(dp_node <= 0))

    def _summary(a):
        if a.size == 0:
            return dict(mean=0.0, std=0.0, min=0.0, max=0.0)
        return dict(mean=float(a.mean()), std=float(a.std()),
                    min=float(a.min()), max=float(a.max()))

    # Magnified combined error, same scaling as the reference
    # (fluidSimulation.py:1157, 1181, 1191-1192).
    total = np.concatenate([pressure_error * 500.0, flow_error * 20000.0])

    out = {
        "pressure_error_mmhg": pressure_error,
        "flow_error_cm3s": flow_error,
        "n_pressure_inversions": inversions,
        "pressure_summary": _summary(pressure_error),
        "flow_summary": _summary(flow_error),
        "combined_magnified_error": float(np.linalg.norm(total)),
        "flow_audit_note": (
            "flow_error_cm3s uses |v| (the reference's packing); edges "
            "whose flow physically reverses appear as conservation error "
            "here — flow_error_signed_cm3s is the physical residual"),
    }
    if signed_velocity is not None:
        sv = signed_velocity
        sv = np.asarray(sv.cpu().numpy() if isinstance(sv, torch.Tensor)
                        else sv)
        flow_s = flow_from_velocity(sv, h["radius_m"])
        err_s = np.abs(net_flow(flow_s)[h["conserve_nodes"]]) * 1e6
        out["flow_error_signed_cm3s"] = err_s
        out["flow_signed_summary"] = _summary(err_s)
        out["n_reversed_edges"] = int(np.sum(sv < 0))
    return out


def pack_velocity_pressure(system: FlowSystem, p_full, velocity) -> np.ndarray:
    """Pack (p, v) into the reference unknown layout [v..., p_unknown...]
    (getVelocityPressure, fluidSimulation.py:785-812)."""
    p_full = np.asarray(p_full.cpu().numpy()
                        if isinstance(p_full, torch.Tensor) else p_full)
    velocity = np.asarray(velocity.cpu().numpy()
                          if isinstance(velocity, torch.Tensor) else velocity)
    node_arg = system.node_arg.cpu().numpy()
    unknown_nodes = np.nonzero(node_arg >= 0)[0]
    order = np.argsort(node_arg[unknown_nodes])
    p_unknown = p_full[unknown_nodes[order]]
    return np.concatenate([velocity, p_unknown])
