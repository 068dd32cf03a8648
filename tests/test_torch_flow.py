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

The fixed-order sums (flow/segment_sum.py, the tree plan's rounds) equal
the ``index_add_`` chains they replace bit for bit on the CPU (two calls
on a card give the same bits: tests/test_torch_kernels.py, which runs on
a machine without JAX).

    JAX_PLATFORMS=cpu python tests/test_torch_flow.py NETWORK.npz

solves a network saved by chip_smoke.py's sharded_512 phase
(build/sharded_512_network.npz) with both packages, f32 and f64, CG and
dense LU, 30 Newton steps at most, and prints iterations, residuals and
pressure differences.
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


# ------------------------------------------------------- fixed-order sums
from arterynetwork_tpu_torch.flow import segment_sum as tseg  # noqa: E402


def _bits(t):
    return t.cpu().numpy().tobytes()


def _wide(rng, shape):
    """Values over 16 decades with both signs, zeros and negative
    zeros: sums whose order shows in the last bits."""
    v = rng.standard_normal(shape) * 10.0 ** rng.integers(-8, 8, shape)
    v[rng.random(shape) < 0.05] = 0.0
    v[rng.random(shape) < 0.05] = -0.0
    return v


@pytest.mark.parametrize("lead", [(), (1,), (3,), (2, 21)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_segment_sum_equals_index_add(lead, dtype):
    """Repeated indices (slot 0 takes a third of the entries), a slot with
    no entry (3), entries into the dropped slot S, signs, T > 1 rows."""
    rng = np.random.default_rng(len(lead))
    S, K = 9, 60
    a = rng.integers(0, S + 1, K)
    b = rng.integers(0, S + 1, K)
    a[: K // 3] = 0
    a[a == 3], b[b == 3] = 0, S
    src = torch.as_tensor(_wide(rng, lead + (K,)), dtype=dtype)
    ref = src.new_zeros(lead + (S + 1,))
    ref.index_add_(-1, torch.as_tensor(a), src)
    ref.index_add_(-1, torch.as_tensor(b), -src)
    plan = tseg.plan_segment_sum(np.concatenate([a, b]),
                                 np.tile(np.arange(K), 2), S, K,
                                 sign=np.repeat([1, -1], K))
    out = tseg.segment_sum(plan, src)
    assert plan.depth > 10 and out.shape == lead + (S,)
    assert _bits(out) == _bits(ref[..., :S])
    assert not out[..., 3].any()
    # sparse: only the slots some entry reaches, in ascending order
    sp = tseg.plan_segment_sum(np.concatenate([a, b]),
                               np.tile(np.arange(K), 2), S, K,
                               sign=np.repeat([1, -1], K), dense=False)
    assert sp.slots.tolist() == sorted(set(a.tolist() + b.tolist()) - {S})
    assert _bits(tseg.segment_sum(sp, src)) == _bits(ref[..., sp.slots])


def _old_assembly(system, w, kind):
    """The index_add_ chains the edge plans replace."""
    M = system.num_unknown_pressures
    slot = system.node_unknown_index
    hu, tu = slot[system.head], slot[system.tail]
    T = w.shape[0]
    if kind == "laplacian":
        L = w.new_zeros(T, (M + 1) * (M + 1))
        L.index_add_(1, hu * (M + 1) + hu, w)
        L.index_add_(1, tu * (M + 1) + tu, w)
        L.index_add_(1, hu * (M + 1) + tu, -w)
        L.index_add_(1, tu * (M + 1) + hu, -w)
        return L.view(T, M + 1, M + 1)[:, :M, :M].reshape(T, M * M)
    first, second, sign = {"diag": (hu, tu, 1), "div": (hu, tu, -1),
                           "net": (tu, hu, -1)}[kind]
    out = w.new_zeros(T, M + 1)
    out.index_add_(1, first, w).index_add_(1, second, sign * w)
    return out[:, :M]


@pytest.mark.parametrize("allow_merge", [False, True])
@pytest.mark.parametrize("kind", ["diag", "div", "net", "laplacian"])
def test_edge_plans_equal_index_add(kind, allow_merge):
    net, gt = _network(allow_merge)
    system = tsystem.build_system(net, boundary_pressure=gt.pressure,
                                  dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(1)
    w = torch.as_tensor(_wide(rng, (3, system.num_edges)),
                        dtype=torch.float32)
    plan = tseg.edge_plan(system, kind)
    assert tseg.edge_plan(system, kind) is plan          # cached
    out = tseg.segment_sum(plan, w)
    if kind == "laplacian":
        M = system.num_unknown_pressures
        out = w.new_zeros(3, M * M).index_copy_(1, plan.slots, out)
    assert _bits(out) == _bits(_old_assembly(system, w, kind))


def _old_tree(system, plan, w, rhs):
    """solve_laplacian_tree as it was with index_add_ over whole rounds."""
    M, E, T = system.num_unknown_pressures, system.num_edges, w.shape[0]
    slot = system.node_unknown_index
    hu, tu = slot[system.head], slot[system.tail]
    d = w.new_zeros(T, M + 1).index_add_(1, hu, w).index_add_(1, tu, w)
    d[:, M] = 1.0
    b = torch.cat([rhs, w.new_zeros(T, 1)], dim=1)
    w_pad = torch.cat([w, w.new_zeros(T, 1)], dim=1)
    for r in range(plan.num_rounds):
        ev, pv, val = plan.elim_nodes[r], plan.parents[r], plan.valid[r]
        wv = w_pad[:, plan.edge_idx[r]]
        dv = torch.where(val, d[:, ev], 1.0)
        factor = torch.where(val, wv / dv, 0.0)
        bv = b[:, ev]
        d.index_add_(1, pv, -factor * wv)
        b.index_add_(1, pv, factor * bv)
    x = w.new_zeros(T, M + 1)
    if plan.core_size:
        C, cs = plan.core_size, plan.core_slot
        chu, ctu = cs[hu], cs[tu]
        wc = torch.where((chu < C) & (ctu < C), w, 0.0)
        L = w.new_zeros(T, (C + 1) * (C + 1))
        L.index_add_(1, torch.arange(C) * (C + 2), d[:, plan.core_nodes])
        L.index_add_(1, chu * (C + 1) + ctu, -wc)
        L.index_add_(1, ctu * (C + 1) + chu, -wc)
        A = L.view(T, C + 1, C + 1)[:, :C, :C]
        ridge = 1e-12 * w.amax(dim=1) + 1e-30
        x[:, plan.core_nodes] = torch.linalg.solve_ex(
            A + torch.eye(C, dtype=w.dtype) * ridge[:, None, None],
            b[:, plan.core_nodes])[0]
    for r in reversed(range(plan.num_rounds)):
        ev, pv, val = plan.elim_nodes[r], plan.parents[r], plan.valid[r]
        wv = w_pad[:, plan.edge_idx[r]]
        dv = torch.where(val, d[:, ev], 1.0)
        xv = (b[:, ev] + wv * x[:, pv]) / dv
        x[:, ev] = torch.where(val, xv, x[:, ev])
    return x[:, :M]


@pytest.mark.parametrize("allow_merge", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tree_rounds_equal_index_add(allow_merge, dtype):
    """Each round's leaves go in by parent rank, one index_add_ per rank
    with distinct parents: the solve equals the whole-round index_add_
    bit for bit, T = 4 rows at once."""
    net, gt = _network(allow_merge)
    system = tsystem.build_system(net, boundary_pressure=gt.pressure,
                                  dtype=dtype, device="cpu")
    plan = ttree.plan_elimination(system)
    M = system.num_unknown_pressures
    shared = 0
    for ev, pv, eidx, val, parts in plan.rounds:
        for a, z, parents in parts:
            assert torch.equal(parents, pv[a:z])
            assert len(set(pv[a:z].tolist())) == z - a
            assert (pv[a:z] < M).all()
        shared += len(parts) > 1
    assert shared >= 3                  # leaves sharing a parent
    rng = np.random.default_rng(2)
    w = torch.as_tensor(rng.random((4, system.num_edges)) * 10.0
                        ** rng.integers(-6, 3, (4, system.num_edges)),
                        dtype=dtype)
    rhs = torch.as_tensor(rng.standard_normal((4, M)), dtype=dtype)
    out = ttree.solve_laplacian_tree(system, plan, w, rhs)
    assert _bits(out) == _bits(_old_tree(system, plan, w, rhs))


def test_cg_f32_with_a_node_of_zero_radius_edges():
    """A node whose edges all have radius 0 has a zero Laplacian
    diagonal.  The port's f32 CG clamps it to 1e-38 (kept: torch does not
    flush subnormals) and converges as dense LU does; the JAX package's
    f32 CG returns NaN there (XLA on the CPU flushes its 1e-38 to 0, and
    rsqrt(0) is inf), a divergence of the reference."""
    rng = np.random.default_rng(0)
    net = set_network_properties(generate_tree(max_depth=5, rng=rng),
                                 k_value=1.852, rng=rng)
    gt = create_ground_truth(net, option=2, rng=np.random.default_rng(7))
    v = int(np.nonzero((net.degree == 3) & (net.node_depth == 2))[0][0])
    radius = net.radius.copy()
    radius[(net.heads == v) | (net.tails == v)] = 0.0
    sys_j = build_system(net.replace(radius=radius),
                         boundary_pressure=gt.pressure, dtype=jnp.float32)
    ref = solve_pressure_newton(sys_j, max_iter=30, linear_solver="cg")
    assert np.isnan(float(ref.residual_norm))
    system = convert.flow_system(sys_j, "cpu")
    cg = tsolvers.solve_pressure_newton(system, max_iter=30,
                                        linear_solver="cg")
    lu = tsolvers.solve_pressure_newton(system, max_iter=30)
    assert bool(torch.isfinite(cg.pressure).all())
    assert cg.iterations == lu.iterations
    assert float(cg.residual_norm) <= 1e-12
    assert _rel(cg.pressure.numpy(), lu.pressure.numpy()) <= 1e-5


def compare_packages(path):
    """Solve a saved network with both packages (see the docstring)."""
    z = np.load(path)
    from arterynetwork_tpu.graphs import FlowNetwork as JNet
    from arterynetwork_tpu_torch.graphs import FlowNetwork as TNet

    fields = {k: z[k] for k in z.files if k != "boundary_pressure"}
    bp = z["boundary_pressure"]
    jn, tn = JNet(**fields), TNet(**fields)
    print(f"{path}: {tn.num_nodes} nodes, {tn.num_edges} edges, "
          f"{int((tn.radius == 0).sum())} of radius 0, max degree "
          f"{int(tn.degree.max())}")
    res = {}
    for ls in ("cg", "dense"):
        for name, jdt, tdt in (("f32", jnp.float32, torch.float32),
                               ("f64", jnp.float64, torch.float64)):
            j = solve_pressure_newton(build_system(
                jn, boundary_pressure=bp, dtype=jdt), max_iter=30,
                linear_solver=ls)
            t = tsolvers.solve_pressure_newton(tsystem.build_system(
                tn, boundary_pressure=bp, dtype=tdt, device="cpu"),
                max_iter=30, linear_solver=ls)
            res[ls, name] = (np.asarray(j.pressure, np.float64),
                             int(j.iterations), float(j.residual_norm),
                             t.pressure.double().numpy(), t.iterations,
                             float(t.residual_norm))
    ref = res["dense", "f64"][0]
    for (ls, name), (jp, ji, jr, tp, ti, tr) in res.items():
        print(f"{ls} {name}: JAX {ji} iterations, residual {jr:.4e} m^3/s, "
              f"max|p - p_f64 LU| {np.abs(jp - ref).max():.4e} Pa; port "
              f"{ti} iterations, residual {tr:.4e}, max|p - p_f64 LU| "
              f"{np.abs(tp - ref).max():.4e} Pa; max|p_port - p_JAX| "
              f"{np.abs(tp - jp).max():.4e} Pa")


if __name__ == "__main__":
    import sys

    compare_packages(sys.argv[1])
