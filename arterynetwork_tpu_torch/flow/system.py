"""Fluid-equation assembly as index tensors on one device.

Port of the JAX package's flow/system.py.  Equivalent of the reference's
``setupFluidEquations`` (fluidSimulation.py:873-968): the equation
inventory is packed once into flat arrays so the residual is a handful of
gathers and scatter-adds:

  * one flow-conservation equation per interior bifurcating node that has
    both incoming and outgoing branches (fluidSimulation.py:903-919);
  * one Hazen-Williams pressure equation per edge, with head/tail pressure
    either a fixed boundary value (entry node or degree-1 node) or an
    unknown (fluidSimulation.py:921-954);
  * optional inlet-velocity boundary equations (fluidSimulation.py:956-964).

Unknown layout: ``x = [v_0 .. v_{E-1}, p_{u0} .. p_{uM-1}]`` — edge
velocities in edge order followed by unknown node pressures in node order
(fluidSimulation.py:549-562).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..graphs.network import FlowNetwork


@dataclasses.dataclass(frozen=True)
class FlowSystem:
    """Static-shape description of the fluid equations for one network.

    Every tensor lives on the same device; integer index tensors are
    int64 (torch's index type)."""

    # Edge geometry/physics (SI units).
    head: torch.Tensor             # i64[E] node index of the head (lower depth)
    tail: torch.Tensor             # i64[E]
    radius_m: torch.Tensor         # f[E]
    length_m: torch.Tensor         # f[E]
    c: torch.Tensor                # f[E]
    k: torch.Tensor                # f[E]

    # Pressure bookkeeping.
    node_fixed: torch.Tensor           # bool[N] True where pressure is prescribed
    node_fixed_pressure: torch.Tensor  # f[N] prescribed pressure (0 elsewhere)
    node_arg: torch.Tensor             # i64[N] index into x, -1 if fixed
    node_unknown_index: torch.Tensor   # i64[N] 0..M-1 for unknowns, M if fixed

    # Flow-conservation equation selection.
    conserve_nodes: torch.Tensor   # i64[F]

    # Optional inlet-velocity boundary equations.
    bc_edge: torch.Tensor          # i64[B] edge indices (may be empty)
    bc_velocity: torch.Tensor      # f[B]

    # Node depth (for the depth-interpolated initial guess,
    # fluidSimulation.py:1852).
    node_depth: torch.Tensor       # i64[N]

    num_unknown_pressures: int
    num_nodes: int

    @property
    def num_edges(self) -> int:
        return self.head.shape[0]

    @property
    def num_unknowns(self) -> int:
        return self.num_edges + self.num_unknown_pressures

    @property
    def device(self) -> torch.device:
        return self.radius_m.device

    def full_pressure(self, p_unknown: torch.Tensor) -> torch.Tensor:
        """Scatter unknown pressures ``[..., M]`` into full node-pressure
        vectors ``[..., N]`` (leading axes broadcast against
        ``node_fixed_pressure``'s, for batched systems)."""
        pad = p_unknown.new_zeros(p_unknown.shape[:-1] + (1,))
        padded = torch.cat([p_unknown, pad], dim=-1)
        return torch.where(self.node_fixed, self.node_fixed_pressure,
                           padded[..., self.node_unknown_index])

    def unknown_pressure_of(self, p_full: torch.Tensor) -> torch.Tensor:
        """The unknown pressures (in unknown order) of full node-pressure
        vectors ``[..., N]``."""
        node_arg = self.node_arg.cpu().numpy()
        order = np.argsort(node_arg)
        unknown_nodes = order[node_arg[order] >= 0]
        return p_full[..., torch.as_tensor(unknown_nodes,
                                           device=p_full.device)]


def apply_velocity_pressure(net: FlowNetwork, system: FlowSystem,
                            x) -> FlowNetwork:
    """Unpack the unknown vector into a network carrying the solution
    (updateNetworkWithSimulationResult, fluidSimulation.py:1519-1546):
    node pressures from the unknown slots (fixed nodes keep their
    prescribed values), per-edge velocity, and flow = v*pi*r^2."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = np.asarray(x, dtype=np.float64)
    E = system.num_edges
    if x.shape[0] != system.num_unknowns:
        raise ValueError("solution length != num_unknowns")
    velocity = x[:E]
    p_unknown = torch.as_tensor(x[E:], device=system.device)
    p_full = np.asarray(system.full_pressure(p_unknown).cpu().numpy(),
                        dtype=np.float64)
    radius = system.radius_m.cpu().numpy()
    flow = velocity * np.pi * radius ** 2
    return net.replace(node_pressure=p_full, edge_velocity=velocity,
                       edge_flow=flow)


def build_system(
    net: FlowNetwork,
    boundary_pressure: Optional[np.ndarray] = None,
    inlet_velocity_bc: Optional[dict] = None,
    dtype: torch.dtype = torch.float64,
    device="cuda",
) -> FlowSystem:
    """Assemble a FlowSystem from a network, on ``device``.

    Parameters
    ----------
    net : FlowNetwork
        The network; ``net.node_pressure`` must hold the prescribed pressures
        at entry and terminal nodes unless ``boundary_pressure`` is given.
    boundary_pressure : array, optional
        Full node-pressure vector to read boundary values from (overrides
        ``net.node_pressure``).
    inlet_velocity_bc : dict, optional
        ``{edge_index: velocity_m_per_s}`` inlet-velocity boundary equations
        (reference ``boundaryCondition`` argument).
    dtype : floating dtype of the physical fields.
    device : where every tensor of the system lives.
    """
    deg = net.degree
    N = net.num_nodes
    is_entry = net.is_entry_node()

    fixed = (deg == 1) | is_entry
    if boundary_pressure is None:
        boundary_pressure = net.node_pressure
    if boundary_pressure is None:
        raise ValueError("boundary pressures unset: provide boundary_pressure "
                         "or set net.node_pressure at entry/terminal nodes")
    boundary_pressure = np.asarray(boundary_pressure, dtype=np.float64)
    fixed_pressure = np.where(fixed, boundary_pressure, 0.0)
    if np.any(~np.isfinite(fixed_pressure[fixed])):
        raise ValueError("non-finite boundary pressure at a fixed node")

    # Unknown pressures in node order (reference argsIndex order).
    E = net.num_edges
    unknown_nodes = np.nonzero(~fixed)[0]
    M = unknown_nodes.shape[0]
    node_arg = np.full(N, -1, dtype=np.int64)
    node_arg[unknown_nodes] = E + np.arange(M)
    node_unknown_index = np.full(N, M, dtype=np.int64)
    node_unknown_index[unknown_nodes] = np.arange(M)

    # Conservation equations: unknown-pressure nodes having at least one
    # in-edge (node is tail) and one out-edge (node is head)
    # (fluidSimulation.py:903-919).
    n_in = np.zeros(N, dtype=np.int64)
    n_out = np.zeros(N, dtype=np.int64)
    np.add.at(n_in, net.tails, 1)
    np.add.at(n_out, net.heads, 1)
    conserve = np.nonzero((~fixed) & (n_in > 0) & (n_out > 0))[0]

    if inlet_velocity_bc:
        bc_edge = np.asarray(sorted(inlet_velocity_bc.keys()), dtype=np.int64)
        bc_velocity = np.asarray([inlet_velocity_bc[int(e)] for e in bc_edge])
    else:
        bc_edge = np.zeros((0,), dtype=np.int64)
        bc_velocity = np.zeros((0,))

    def idx(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    def real(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device,
                               dtype=dtype)

    return FlowSystem(
        head=idx(net.heads),
        tail=idx(net.tails),
        radius_m=real(net.radius_m()),
        length_m=real(net.length_m()),
        c=real(net.c),
        k=real(net.k),
        node_fixed=torch.as_tensor(np.asarray(fixed, bool), device=device),
        node_fixed_pressure=real(fixed_pressure),
        node_arg=idx(node_arg),
        node_unknown_index=idx(node_unknown_index),
        conserve_nodes=idx(conserve),
        bc_edge=idx(bc_edge),
        bc_velocity=real(bc_velocity),
        node_depth=idx(net.node_depth),
        num_unknown_pressures=int(M),
        num_nodes=int(N),
    )
