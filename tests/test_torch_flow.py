"""Flow solve in the PyTorch port against the JAX reference, on the CPU.

The same system — assembled by the JAX package and carried across by
``arterynetwork_tpu_torch.convert`` — goes through both Newton solvers,
with the dense, the tree-elimination and the matrix-free CG linear
solvers, on a tree and on a tree with merge loops (a non-empty 2-core).  Tolerances, relative to
the largest magnitude (values measured on a CPU in brackets):

  * f64: pressures and flows <= 1e-9 [pressures 0, flows 7e-16];
  * f32 with the compensated refinement (2 steps, the f32 default):
    <= 1e-5 [pressures 0, flows 7e-8].
Both solvers take the same number of Newton iterations.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from arterynetwork_tpu.flow import (build_system, create_ground_truth,
                                    solve_pressure_newton)
from arterynetwork_tpu.flow.tree_solver import plan_elimination
from arterynetwork_tpu.graphs import generate_tree, set_network_properties
from arterynetwork_tpu_torch import convert
from arterynetwork_tpu_torch.flow import solvers as tsolvers
from arterynetwork_tpu_torch.flow import system as tsystem
from arterynetwork_tpu_torch.flow import tree_solver as ttree

torch.set_num_threads(1)


def _network(allow_merge):
    # seed 0 with merges: a feasible ground truth and a 6-node 2-core
    rng = np.random.default_rng(0 if allow_merge else 42)
    net = generate_tree(max_depth=7, allow_merge=allow_merge, rng=rng)
    net = set_network_properties(net, k_value=1.852, rng=rng)
    gt = create_ground_truth(net, option=2, rng=np.random.default_rng(7))
    assert gt.success
    return net, gt


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.mark.parametrize("allow_merge", [False, True])
@pytest.mark.parametrize("linear_solver", ["dense", "tree", "cg"])
@pytest.mark.parametrize("dtype,tol", [("float64", 1e-9), ("float32", 1e-5)])
def test_newton_matches_jax(allow_merge, linear_solver, dtype, tol):
    net, gt = _network(allow_merge)
    sys_j = build_system(net, boundary_pressure=gt.pressure,
                         dtype=getattr(jnp, dtype))
    plan_j = plan_elimination(sys_j) if linear_solver == "tree" else None
    ref = solve_pressure_newton(sys_j, linear_solver=linear_solver,
                                plan=plan_j)

    sys_t = convert.flow_system(sys_j, device="cpu")
    plan_t = (convert.elimination_plan(plan_j, device="cpu")
              if plan_j is not None else None)
    if allow_merge and plan_t is not None:
        assert plan_t.core_size > 0   # the loop solve is exercised
    out = tsolvers.solve_pressure_newton(sys_t, linear_solver=linear_solver,
                                         plan=plan_t)
    assert out.pressure.dtype == getattr(torch, dtype)
    assert _rel(out.pressure.numpy(), np.asarray(ref.pressure)) <= tol
    assert _rel(out.flow.numpy(), np.asarray(ref.flow)) <= tol
    assert _rel(out.velocity.numpy(), np.asarray(ref.velocity)) <= tol


@pytest.mark.parametrize("allow_merge", [False, True])
def test_port_assembly_and_plan_equal_converted(allow_merge):
    """The port's own build_system / plan_elimination give exactly the
    converted JAX objects."""
    net, gt = _network(allow_merge)
    sys_j = build_system(net, boundary_pressure=gt.pressure)
    ref = convert.flow_system(sys_j, device="cpu")
    out = tsystem.build_system(net, boundary_pressure=gt.pressure,
                               device="cpu")
    for f in ("head", "tail", "radius_m", "length_m", "c", "k",
              "node_fixed", "node_fixed_pressure", "node_arg",
              "node_unknown_index", "conserve_nodes", "node_depth"):
        assert torch.equal(getattr(out, f), getattr(ref, f)), f
    assert out.num_unknown_pressures == ref.num_unknown_pressures
    plan_ref = convert.elimination_plan(plan_elimination(sys_j), "cpu")
    plan = ttree.plan_elimination(out)
    for f in ("elim_nodes", "parents", "edge_idx", "valid", "core_nodes",
              "core_slot"):
        assert torch.equal(getattr(plan, f), getattr(plan_ref, f)), f
    assert (plan.num_rounds, plan.core_size) == (plan_ref.num_rounds,
                                                 plan_ref.core_size)


def test_f32_refinement_beats_plain_f32():
    """The compensated refinement is what closes f32 parity: without it
    the f32 pressures sit further from the f64 solution."""
    net, gt = _network(allow_merge=True)
    sys32 = tsystem.build_system(net, boundary_pressure=gt.pressure,
                                 dtype=torch.float32, device="cpu")
    plan = ttree.plan_elimination(sys32)

    def err(steps):
        sol = tsolvers.solve_pressure_newton(sys32, linear_solver="tree",
                                             plan=plan, refine_steps=steps)
        return _rel(sol.pressure.numpy().astype(np.float64), gt.pressure)

    assert err(2) < err(0)
    assert err(2) <= 1e-6


def test_restarts_and_cg():
    """Restarts run from a seeded torch.Generator when the primary solve
    stalls above the trigger; the matrix-free CG backend matches the JAX
    package's (f64, at the f64 tolerance, the same Newton iterations)."""
    net, gt = _network(allow_merge=False)
    sys_t = tsystem.build_system(net, boundary_pressure=gt.pressure,
                                 device="cpu")
    # max_iter=1 stops the primary solve far above the trigger
    one = tsolvers.solve_pressure_newton(sys_t, max_iter=1)
    sol = tsolvers.solve_pressure_newton(sys_t, max_iter=1, restarts=2)
    assert sol.iterations > one.iterations
    assert float(sol.residual_norm) <= float(one.residual_norm)
    sys_j = build_system(net, boundary_pressure=gt.pressure)
    ref = solve_pressure_newton(sys_j, linear_solver="cg")
    cg = tsolvers.solve_pressure_newton(convert.flow_system(sys_j, "cpu"),
                                        linear_solver="cg")
    assert cg.iterations == int(ref.iterations)
    assert _rel(cg.pressure.numpy(), np.asarray(ref.pressure)) <= 1e-9
    assert _rel(cg.flow.numpy(), np.asarray(ref.flow)) <= 1e-9
