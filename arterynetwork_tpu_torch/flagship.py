"""The flagship entry: the Hazen-Williams network pressure solve.

Port of ``__graft_entry__.py``'s ``_flagship_system`` and ``entry``:
``entry()`` returns a forward step on the flagship system (a depth-9
random tree, f32, solved by Newton with the matrix-free CG backend)
and its example arguments, on ``device``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .flow import build_system, create_ground_truth
from .flow.solvers import solve_pressure_newton
from .graphs import generate_tree, set_network_properties


def flagship_system(max_depth=11, dtype=torch.float32, device="cuda"):
    """(FlowSystem, ground truth) of the seeded flagship tree."""
    rng = np.random.default_rng(0)
    net = generate_tree(max_depth=max_depth, rng=rng)
    net = set_network_properties(net, k_value=1.852, rng=rng)
    gt = create_ground_truth(net, option=2, rng=np.random.default_rng(1))
    system = build_system(net, boundary_pressure=gt.pressure, dtype=dtype,
                          device=device)
    return system, gt


def entry(device="cuda"):
    """(forward, example_args): ``forward(fixed_pressure)`` solves the
    depth-9 flagship system with CG (30 Newton iterations at most) and
    returns (node pressures, edge flows)."""
    system, _ = flagship_system(max_depth=9, device=device)

    def forward(fixed_pressure):
        sys2 = dataclasses.replace(system, node_fixed_pressure=fixed_pressure)
        sol = solve_pressure_newton(sys2, max_iter=30, linear_solver="cg")
        return sol.pressure, sol.flow

    return forward, (system.node_fixed_pressure.clone(),)


def dryrun_multichip(n_devices: int) -> None:
    """The multi-device dry run (``__graft_entry__.dryrun_multichip``)
    waits for the port's parallel slice (sharded volumes and batches on
    ``torch.distributed``)."""
    raise NotImplementedError(
        "dryrun_multichip waits for the port's parallel slice")
