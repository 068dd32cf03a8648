"""The longitudinal flow-study path of the PyTorch port against the JAX
package, on the CPU.

Inputs come from numpy seeds and go through the JAX function and its port
at small sizes (depth 4-6 trees, T <= 4 timesteps).  Tolerances, with the
values measured on a CPU in brackets:

  * exact (``np.array_equal``): ``generate_tree``,
    ``set_network_properties``, the ``perturb_*`` operators,
    ``interpolate_radii``, ``set_network``, ``adjust_network``,
    ``edge_partition_names``; ``apply_darcy_weisbach``'s k, and its c
    within 4.5e-16 relative [2.2e-16: XLA's and numpy's ``pow`` differ in
    the last bit of about 5% of the edges];
  * physics: <= 1e-14 relative;
  * ``_cg_laplacian_solve`` (f64, same w and rhs): <= 1e-9 relative, the
    same CG iteration count;
  * ``validate_equations`` on a perturbed state: the same keys, values
    within 1e-9 relative;
  * ``run_longitudinal``: f64 within 1e-9 relative [0 / 3e-16], f32 (with
    the compensated refinement) within 1e-6 [6e-8 / 7e-8: 1e-9 is below
    f32's rounding of the pressures], the same iterations in every row;
    the batch equals the port's own per-row solves bit for bit, also
    with rows whose iteration counts differ;
  * the study drivers: solution fields within 1e-9 relative; residual
    audits (which sit at the rounding floor of a converged solve) within
    1e-9 of the solution's scale (pressures in mmHg, flows in cm^3/s);
    the same ``failed_timesteps`` and pickle keys;
  * ``flagship.entry()`` against ``__graft_entry__.entry()``: f32 CG,
    <= 1e-5 relative.

A last test holds the port and chip_smoke.py free of imports of JAX and
of the JAX package.
"""

import ast
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import arterynetwork_tpu.flow as J
from arterynetwork_tpu.constants import PASCAL_PER_MMHG
from arterynetwork_tpu.flow import experiments as jexp
from arterynetwork_tpu.flow import perturb as jperturb
from arterynetwork_tpu.flow import solvers as jsolvers
from arterynetwork_tpu.flow.boundary import bfs_partition
from arterynetwork_tpu.flow.longitudinal import run_longitudinal as jrun
from arterynetwork_tpu.graphs import tree as jtree
from arterynetwork_tpu.io.artifacts import ArtifactStore as JStore

import arterynetwork_tpu_torch.flow as P
from arterynetwork_tpu_torch import convert
from arterynetwork_tpu_torch.flow import experiments as pexp
from arterynetwork_tpu_torch.flow import perturb as pperturb
from arterynetwork_tpu_torch.flow import physics as pphys
from arterynetwork_tpu_torch.flow import solvers as psolvers
from arterynetwork_tpu_torch.flow.longitudinal import run_longitudinal as prun
from arterynetwork_tpu_torch.flow.tree_solver import plan_elimination
from arterynetwork_tpu_torch.graphs import tree as ptree
from arterynetwork_tpu_torch.io.artifacts import ArtifactStore as PStore

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parents[1]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _study_net(depth=6, physics="hw"):
    """The CLI study set-up (``__main__._cmd_study``): a seeded tree, one
    compartment per depth-1 node, the first shrunk to 0.85."""
    rng = np.random.default_rng(0)
    net = jtree.set_network_properties(
        jtree.generate_tree(max_depth=depth, rng=rng), rng=rng)
    if physics == "dw":
        net = J.apply_darcy_weisbach(net)
    roots = np.nonzero(net.node_depth == 1)[0]
    parts = {f"P{i}": {"start_nodes": [int(r)], "boundary_nodes": []}
             for i, r in enumerate(roots)}
    radius_end = net.radius.copy()
    radius_end[bfs_partition(net, [int(roots[0])], [])["visited_edges"]] \
        *= 0.85
    return net, parts, radius_end


# ---------------------------------------------------------------- copies
@pytest.mark.parametrize("depth,allow_merge,seed",
                         [(5, False, 0), (6, True, 0), (6, True, 3)])
def test_tree_generation_exact(depth, allow_merge, seed):
    a = jtree.generate_tree(depth, allow_merge, rng=np.random.default_rng(
        seed))
    b = ptree.generate_tree(depth, allow_merge, rng=np.random.default_rng(
        seed))
    a = jtree.set_network_properties(a, rng=np.random.default_rng(seed + 1))
    b = ptree.set_network_properties(b, rng=np.random.default_rng(seed + 1))
    for f in ("heads", "tails", "node_depth", "radius", "length", "c", "k",
              "entry_nodes"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f


def test_perturbations_exact():
    net, parts, radius_end = _study_net(5)
    a = jperturb.perturb_radius_random(net, 7, 30.0,
                                       rng=np.random.default_rng(2))
    b = pperturb.perturb_radius_random(net, 7, 30.0,
                                       rng=np.random.default_rng(2))
    assert np.array_equal(a.radius, b.radius)
    a = jperturb.perturb_radius_from_timepoint(net, radius_end, (0, 3))
    b = pperturb.perturb_radius_from_timepoint(net, radius_end, (0, 3))
    assert np.array_equal(a.radius, b.radius)
    a = jperturb.perturb_radius_per_partition(net, ["P1"], 12.5, parts)
    b = pperturb.perturb_radius_per_partition(net, ["P1"], 12.5, parts)
    assert np.array_equal(a.radius, b.radius)
    gt = J.create_ground_truth(net, option=2, rng=np.random.default_rng(1))
    for kw in ({"pressure_decrease_per_partition": {"P0": 0.1}},
               {"pressure_drop_change_per_partition": {"P1": -0.2}}):
        assert np.array_equal(
            jperturb.perturb_terminating_pressure(net, gt.pressure,
                                                  partitions=parts, **kw),
            pperturb.perturb_terminating_pressure(net, gt.pressure,
                                                  partitions=parts, **kw))
    for option in (1, 2):
        assert np.array_equal(
            jperturb.interpolate_radii(net.radius, radius_end, 4, option),
            pperturb.interpolate_radii(net.radius, radius_end, 4, option))


def test_network_setup_exact(tmp_path):
    from arterynetwork_tpu.flow import network_setup as jns
    from arterynetwork_tpu_torch.flow import network_setup as pns

    net, parts, _ = _study_net(5)
    for kw in ({"option": 1, "partitions": parts},
               {"option": 1, "partitions": parts, "per_compartment": False},
               {"option": 2}):
        a = jns.set_network(net, rng=np.random.default_rng(4), **kw)
        b = pns.set_network(net, rng=np.random.default_rng(4), **kw)
        for f in ("radius", "length", "c", "k"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), (kw, f)
    a, b = jns.adjust_network(net), pns.adjust_network(net)
    assert np.array_equal(a.radius, b.radius)
    assert np.array_equal(a.length, b.length)
    assert np.array_equal(jns.edge_partition_names(net, parts),
                          pns.edge_partition_names(net, parts))
    a, b = jns.apply_darcy_weisbach(net), pns.apply_darcy_weisbach(net)
    assert a.physics == b.physics == "dw"
    assert np.array_equal(a.k, b.k)
    assert _rel(b.c, a.c) <= 4.5e-16
    # a radius update keeps a DW network DW (set_network_ck dispatches)
    a2 = J.set_network_ck(a.replace(radius=a.radius * 0.9))
    b2 = P.set_network_ck(b.replace(radius=b.radius * 0.9))
    assert np.array_equal(a2.k, b2.k) and _rel(b2.c, a2.c) <= 4.5e-16
    # load_network / convert_network (once unported, they raised): a
    # legacy bundle whose voxel graph networkx pickled gives the JAX
    # package's network, with the bundle's ADAN dict applied
    import pickle

    import networkx as nx

    G = nx.Graph()
    segs = [[(0, 0, z) for z in range(4)],
            [(0, 0, 3), (0, 1, 4), (0, 2, 5)],
            [(0, 0, 3), (1, 0, 4), (2, 0, 5)]]
    for i, seg in enumerate(segs):
        for u, v in zip(seg[:-1], seg[1:]):
            G.add_edge(u, v, segmentIndex=i, meanRadius=2.0 - 0.5 * i,
                       pathLength=float(len(seg) - 1))
    for v in G.nodes():
        G.nodes[v]["depthLevel"] = 0 if v[2] <= 3 and v[:2] == (0, 0) \
            else 1
    with open(tmp_path / "basicFilesForStructureWithCoW(year=BraVa).pkl",
              "wb") as f:
        pickle.dump({"G": G, "segmentList": segs}, f)
    with open(tmp_path / "resultADANDict.pkl", "wb") as f:
        pickle.dump({"slopeCRadius": -100.0, "interceptCRadius": 1.2,
                     "CKCandidates": np.array([0.9, 1.852]),
                     "radiusThresholds": np.array([0.5e-3, 3e-3])}, f)
    a, oa = jns.convert_network(jns.load_network(str(tmp_path), version=1))
    b, ob = pns.convert_network(pns.load_network(str(tmp_path), version=1))
    assert oa == ob and b.num_edges == 3
    for f in ("heads", "tails", "node_depth", "radius", "length", "c", "k"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f


def test_physics_matches_jax():
    rng = np.random.default_rng(5)
    r = rng.uniform(2e-4, 3e-3, 64)
    L = rng.uniform(1e-3, 7e-2, 64)
    c = rng.uniform(0.5, 1.5, 64)
    k = np.where(rng.random(64) < 0.5, 1.0, 1.852)
    dp = rng.uniform(-500.0, 500.0, 64)
    q = rng.uniform(1e-9, 1e-5, 64)
    v = rng.uniform(-1.0, 1.0, 64)
    cases = {
        "edge_admittance": (r, L, c, k),
        "dp_from_flow": (q, r, L, c, k),
        "flow_from_dp": (np.abs(dp), r, L, c, k),
        "signed_flow_from_dp": (dp, r, L, c, k),
        "poiseuille_equivalent_c": (r,),
        "velocity_from_flow": (q, r),
        "flow_from_velocity": (v, r),
    }
    jphys = J.physics
    for name, args in cases.items():
        ref = np.asarray(getattr(jphys, name)(*map(jnp.asarray, args)))
        out_np = getattr(pphys, name)(*args)
        out_t = getattr(pphys, name)(*map(torch.tensor, args)).numpy()
        assert _rel(out_np, ref) <= 1e-14, name
        assert _rel(out_t, ref) <= 1e-14, name
    cj, kj = jphys.darcy_weisbach_ck(jnp.asarray(r))
    for arg in (r, torch.tensor(r)):
        cp, kp = pphys.darcy_weisbach_ck(arg)
        assert _rel(np.asarray(cp), cj) <= 1e-14
        assert np.array_equal(np.asarray(kp), np.asarray(kj))


# ------------------------------------------------------- solvers, audits
def _system(depth=6, dtype="float64", seed=0):
    rng = np.random.default_rng(seed)
    net = jtree.set_network_properties(
        jtree.generate_tree(max_depth=depth, rng=rng), rng=rng)
    gt = J.create_ground_truth(net, option=2, rng=np.random.default_rng(1))
    return net, gt, J.build_system(net, boundary_pressure=gt.pressure,
                                   dtype=getattr(jnp, dtype))


def test_cg_laplacian_solve_matches_jax(monkeypatch):
    """The same (w, rhs) through both CG solves: the same iterates, so the
    same count (JAX's counted by a host callback in its matvec)."""
    net, gt, sys_j = _system(6)
    rng = np.random.default_rng(6)
    w = np.exp(rng.uniform(-8.0, 0.0, net.num_edges)) * 1e-9
    rhs = rng.normal(0.0, 1e-6, sys_j.num_unknown_pressures)
    calls = []
    cg = jax.scipy.sparse.linalg.cg

    def counted(matvec, b, **kw):
        def mv(y):
            jax.debug.callback(lambda: calls.append(1))
            return matvec(y)
        return cg(mv, b, **kw)

    monkeypatch.setattr(jax.scipy.sparse.linalg, "cg", counted)
    ref = np.asarray(jsolvers._cg_laplacian_solve(sys_j, jnp.asarray(w),
                                                  jnp.asarray(rhs)))
    n_jax = len(calls) - 1          # one matvec forms r0 = b - A x0
    stats = psolvers.SolveStats()
    sys_t = convert.flow_system(sys_j, "cpu")
    out = psolvers._cg_laplacian_solve(sys_t, torch.tensor(w),
                                       torch.tensor(rhs), stats=stats)
    assert int(stats.cg_steps[0]) == n_jax > 10
    assert _rel(out.numpy(), ref) <= 1e-9
    # batched rows equal their own solves
    w2 = np.stack([w, w * 3.0])
    rhs2 = np.stack([rhs, -rhs * 0.5])
    both = psolvers._cg_laplacian_solve(sys_t, torch.tensor(w2),
                                        torch.tensor(rhs2))
    for i in range(2):
        one = psolvers._cg_laplacian_solve(sys_t, torch.tensor(w2[i]),
                                           torch.tensor(rhs2[i]))
        assert _rel(both[i].numpy(), one.numpy()) <= 1e-12


def test_validate_and_residual_match_jax():
    """The audit and the magnified residual on a perturbed state (errors
    well above the rounding floor), and the unknown-vector helpers."""
    net, gt, sys_j = _system(5)
    sys_t = convert.flow_system(sys_j, "cpu")
    rng = np.random.default_rng(8)
    x = gt.velocity_pressure * (1.0 + 0.01 * rng.normal(size=sys_j.num_unknowns))
    sv = gt.velocity * np.where(rng.random(net.num_edges) < 0.2, -1.0, 1.0)
    ref = J.validate_equations(x, sys_j, signed_velocity=sv)
    out = P.validate_equations(x, sys_t, signed_velocity=sv)
    assert set(out) == set(ref)
    for key, val in ref.items():
        if isinstance(val, dict):
            for s, v in val.items():
                assert abs(out[key][s] - v) <= 1e-9 * abs(v), (key, s)
        elif isinstance(val, str):
            assert out[key] == val
        else:
            assert _rel(out[key], val) <= 1e-9, key
    for norm in (0, 1, 2):
        r_j = np.asarray(J.residual_reference(jnp.asarray(x), sys_j, norm))
        r_t = P.residual_reference(x, sys_t, norm).numpy()
        assert _rel(r_t, r_j) <= 1e-9
    assert sys_t.num_unknowns == sys_j.num_unknowns
    p_full = torch.tensor(gt.pressure)
    assert np.array_equal(sys_t.unknown_pressure_of(p_full).numpy(),
                          np.asarray(sys_j.unknown_pressure_of(gt.pressure)))
    assert np.array_equal(
        P.pack_velocity_pressure(sys_t, p_full, torch.tensor(gt.velocity)),
        J.pack_velocity_pressure(sys_j, gt.pressure, gt.velocity))
    a = J.apply_velocity_pressure(net, sys_j, x)
    b = P.apply_velocity_pressure(net, sys_t, x)
    for f in ("node_pressure", "edge_velocity", "edge_flow"):
        assert _rel(getattr(b, f), getattr(a, f)) <= 1e-15, f


def test_solve_poiseuille_matches_jax():
    net, _, _ = _system(5)
    net = net.replace(c=np.asarray(J.physics.poiseuille_equivalent_c(
        net.radius_m())), k=np.ones(net.num_edges))
    gt = J.create_ground_truth(net, option=2, rng=np.random.default_rng(1))
    sys_j = J.build_system(net, boundary_pressure=gt.pressure)
    for solver in ("dense", "cg"):
        ref = J.solve_poiseuille(sys_j, linear_solver=solver)
        out = P.solve_poiseuille(convert.flow_system(sys_j, "cpu"),
                                 linear_solver=solver)
        assert out.iterations == int(ref.iterations)
        assert _rel(out.pressure.numpy(), ref.pressure) <= 1e-9
        assert _rel(out.flow.numpy(), ref.flow) <= 1e-9


# ---------------------------------------------------------- longitudinal
@pytest.mark.parametrize("dtype,tol", [("float64", 1e-9), ("float32", 1e-6)])
def test_run_longitudinal_matches_jax(dtype, tol):
    net, parts, radius_end = _study_net(6)
    gt = J.create_ground_truth(net, option=2, rng=np.random.default_rng(1))
    bj, sj = jrun(net, gt.pressure, radius_end, num_timesteps=4,
                  partitions=parts, dtype=getattr(jnp, dtype))
    bt, st = prun(net, gt.pressure, radius_end, num_timesteps=4,
                  partitions=parts, dtype=getattr(torch, dtype),
                  device="cpu")
    for key in ("radius_m", "c", "k", "boundary_pressure"):
        assert np.array_equal(bt[key], bj[key]), key
    assert bt["pressure_drop_change"] == bj["pressure_drop_change"]
    assert st.iterations.tolist() == np.asarray(sj.iterations).tolist()
    assert _rel(st.pressure.numpy(), sj.pressure) <= tol
    assert _rel(st.flow.numpy(), sj.flow) <= tol
    if dtype == "float64":
        assert float(st.residual_norm.max()) < 1e-10


def test_batch_rows_equal_their_own_solves():
    """Rows with different physics (k = 1.852 and a Poiseuille k = 1) and
    boundaries stop after different numbers of Newton steps; each row of
    the batch equals its unbatched solve bit for bit, and the host reads
    one flag per Newton step of the batch."""
    net, _, _ = _system(5)
    rng = np.random.default_rng(9)
    rows = []
    for t in range(3):
        n = net
        if t == 1:
            n = net.replace(c=np.asarray(J.physics.poiseuille_equivalent_c(
                net.radius_m())), k=np.ones(net.num_edges))
        gt = J.create_ground_truth(n, option=2, rng=np.random.default_rng(t))
        bp = gt.pressure * (1.0 + 0.02 * t * rng.random(net.num_nodes))
        rows.append(P.build_system(n, boundary_pressure=bp, device="cpu"))
    stack = {f: torch.stack([getattr(s, f) for s in rows])
             for f in ("radius_m", "c", "k", "node_fixed_pressure")}
    batch = dataclasses.replace(rows[0], **stack)
    for solver in ("tree", "dense", "cg"):
        plan = plan_elimination(rows[0]) if solver == "tree" else None
        stats = psolvers.SolveStats()
        sol = psolvers.solve_pressure_newton_batch(
            batch, linear_solver=solver, plan=plan, stats=stats)
        its = sol.iterations.tolist()
        assert len(set(its)) > 1, its
        if solver != "cg":
            assert stats.host_reads == max(its) + 1
        for t, s in enumerate(rows):
            one = psolvers.solve_pressure_newton(s, linear_solver=solver,
                                                 plan=plan)
            assert one.iterations == its[t]
            assert torch.equal(one.pressure, sol.pressure[t]), (solver, t)
            assert torch.equal(one.flow, sol.flow[t]), (solver, t)
    with pytest.raises(ValueError):
        psolvers.solve_pressure_newton_batch(batch, restarts=1)


# --------------------------------------------------------------- drivers
def _close(a, b, path, scale):
    """Nested results equal: arrays within 1e-9 relative (of ``scale``'s
    entry for residual audits), strings and counts exactly."""
    if isinstance(b, dict):
        assert set(a) == set(b), path
        for k in b:
            _close(a[k], b[k], f"{path}/{k}", scale)
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]", scale)
    elif b is None or isinstance(b, (str, bool, int)):
        assert a == b, path
    else:
        x, y = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert x.shape == y.shape, path
        assert np.array_equal(np.isnan(x), np.isnan(y)), path
        x, y = x[~np.isnan(y)], y[~np.isnan(y)]
        if y.size == 0:
            return
        audit = next((s for k, s in scale.items() if k in path), None)
        ref = audit if audit is not None else np.max(np.abs(y))
        assert np.max(np.abs(x - y)) <= 1e-9 * ref, path


DRIVERS = ["flow_split", "same_flow", "two_timepoint", "tp_fit", "gbm4",
           "gbm5", "gbm5b", "proportions", "compute_network_test",
           "solver_sanity", "radius_perturbation", "pressure_perturbation"]


def _drive(pkg, name, net, parts, radius_end, tmp, dev):
    common = dict(num_timesteps=4, interpolation_option=1, partitions=parts)
    rng = np.random.default_rng(3)
    exp = jexp if pkg is J else pexp
    store = (JStore if pkg is J else PStore)(str(tmp))
    if name == "flow_split":
        return pkg.flow_split_study(net, radius_end, rng=rng, **common)
    if name == "same_flow":
        return pkg.same_flow_study(net, radius_end, rng=rng, **common)
    if name == "two_timepoint":
        return pkg.two_timepoint_comparison(net, radius_end, rng=rng)
    if name == "tp_fit":
        out = pkg.tp_fit_solve_study(net, radius_end, rng=rng, store=store,
                                     **common, **dev)
        return out, {n: store.load_pickle(n)
                     for n in sorted(p.name for p in tmp.iterdir())}
    if name == "gbm4":
        out = pkg.gbm_test4(net, partitions=parts, partition_to_perturb=(
            "P0",), rng=rng, store=store, **dev)
        return out, {n: store.load_pickle(n)
                     for n in sorted(p.name for p in tmp.iterdir())}
    if name == "gbm5":
        gt = pkg.create_ground_truth(net, option=2, rng=rng)
        run = jrun if pkg is J else prun
        kw = {"dtype": jnp.float64} if pkg is J else {"device": "cpu"}
        batch, sol = run(net, gt.pressure, radius_end, num_timesteps=4,
                         partitions=parts, **kw)
        names = pkg.save_gbm_test5_results(store, net, batch, sol)
        return names, {n: store.load_pickle(n) for n in names}
    if name == "gbm5b":
        return pkg.gbm_test5b(net, radius_end, excluded_edges=(), rng=rng,
                              **common)
    if name == "proportions":
        flows = np.random.default_rng(4).normal(0, 1e-6, (net.num_edges, 4))
        return pkg.flow_proportions_per_partition(net, flows, parts)
    if name == "compute_network_test":
        return exp.compute_network_test(net, rng=rng, **dev)
    if name == "solver_sanity":
        return exp.solver_sanity_test(net, rng=rng, **dev)
    if name == "radius_perturbation":
        return exp.radius_perturbation_study(net, rng=rng, **dev)
    return exp.pressure_perturbation_study(net, {"P0": 0.1}, parts, rng=rng,
                                           **dev)


@pytest.mark.parametrize("name,physics", [(n, "hw") for n in DRIVERS] + [
    (n, "dw") for n in ("tp_fit", "gbm4", "gbm5")])
def test_study_driver_matches_jax(name, physics, tmp_path):
    net, parts, radius_end = _study_net(5, physics)
    (tmp_path / "j").mkdir()
    (tmp_path / "p").mkdir()
    ref = _drive(J, name, net, parts, radius_end, tmp_path / "j", {})
    out = _drive(P, name, net, parts, radius_end, tmp_path / "p",
                 {"device": "cpu"})
    # the residual audits' scales: the solution's pressures and flows
    gt = J.create_ground_truth(net, option=2, rng=np.random.default_rng(3))
    p_max, q_max = float(np.max(gt.pressure)), float(np.max(np.abs(gt.flow)))
    mmhg, cm3s = p_max / PASCAL_PER_MMHG, q_max * 1e6
    scale = {"pressure_error": mmhg, "pressure_summary": mmhg,
             "combined_magnified_error": 500.0 * mmhg,
             "flow_error": cm3s, "flow_summary": cm3s,
             "flow_signed_summary": cm3s, "residual_norm": q_max,
             "max_flow_error": q_max, "max_pressure_error": p_max}
    _close(out, ref, name, scale)


def test_flagship_entry_matches_graft_entry():
    import __graft_entry__ as graft
    from arterynetwork_tpu_torch import flagship

    fwd_j, args_j = graft.entry()
    fwd_t, args_t = flagship.entry(device="cpu")
    assert np.array_equal(args_t[0].numpy(), np.asarray(args_j[0]))
    p_j, q_j = fwd_j(*args_j)
    p_t, q_t = fwd_t(*args_t)
    assert p_t.dtype == torch.float32
    assert _rel(p_t.numpy(), p_j) <= 1e-5
    assert _rel(q_t.numpy(), q_j) <= 1e-5
    if not torch.cuda.is_available():
        # an entry point runs on the card unless asked for the CPU
        # (tests/test_torch_parallel.py runs it on CPU slots)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            flagship.dryrun_multichip(4)


# --------------------------------------------------------------- imports
def _forbidden(name):
    top = name.split(".")[0]
    return top in ("jax", "arterynetwork_tpu")


def _optional(name):
    """Packages the port must not need: networkx (allowed only in the
    interop method ``FlowNetwork.to_networkx``) and matplotlib with its
    mpl_toolkits (allowed only inside viz's figure functions)."""
    return name.split(".")[0] in ("networkx", "matplotlib", "mpl_toolkits")


def _imports(tree):
    """(lineno, module name, enclosing function name or None) of every
    absolute import in a module's AST."""
    out = []

    def walk(node, fn):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                walk(child, child.name)
                continue
            if isinstance(child, ast.Import):
                out.extend((child.lineno, a.name, fn) for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                out.append((child.lineno, child.module or "", fn))
            walk(child, fn)

    walk(tree, None)
    return out


def test_port_imports_no_jax():
    """No module of the port, and not chip_smoke.py, imports JAX or the
    JAX package (by the import statements' AST, so comments and strings
    naming the source do not count; ``arterynetwork_tpu_torch`` is not
    ``arterynetwork_tpu``); none imports networkx or matplotlib, except
    networkx inside ``FlowNetwork.to_networkx`` (graphs/network.py) and
    matplotlib inside the figure functions of viz/ (never at a module's
    top level, so ``import arterynetwork_tpu_torch.viz`` needs none)."""
    files = sorted((REPO / "arterynetwork_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 30
    assert {"edt.py", "cc.py", "thinning.py", "simple_point.py",
            "fidelity.py", "voxel_graph.py", "traversal.py", "editing.py",
            "curvature.py", "__main__.py"} <= {p.name for p in files}
    # the parallel slice and the utilities
    new = {"parallel/halo.py", "parallel/sharded.py",
           "parallel/distributed.py", "parallel/pipeline_sharded.py",
           "parallel/dcn_smoke.py", "parallel/__init__.py",
           "utils/hostmem.py", "utils/profiling.py", "utils/debug.py",
           "utils/reference_protocol.py", "utils/reference_region_grow.py",
           "io/stitch.py",
           # the viz slice and the fixed-order flow sums
           "viz/_mpl.py", "viz/helpers.py", "viz/network_plot.py",
           "viz/study_plots.py", "viz/__init__.py", "flow/segment_sum.py"}
    assert new <= {p.relative_to(REPO / "arterynetwork_tpu_torch")
                   .as_posix() for p in files[:-1]}
    bad, optional = [], []
    for path in files:
        for line, name, fn in _imports(ast.parse(path.read_text(),
                                                 str(path))):
            where = f"{path.relative_to(REPO)}:{line} {name}"
            if _forbidden(name):
                bad.append(where)
            elif _optional(name):
                optional.append((where, fn))
    assert not bad, bad
    allowed = [w for w, fn in optional
               if fn == "to_networkx" and "graphs/network.py" in w]
    assert len(allowed) == 1, optional
    figures = [w for w, fn in optional if fn is not None
               and "arterynetwork_tpu_torch/viz/" in w
               and w.split()[-1].split(".")[0] in ("matplotlib",
                                                   "mpl_toolkits")]
    assert any("viz/_mpl.py" in w and w.endswith(" matplotlib.pyplot")
               for w in figures), figures
    allowed += figures
    assert [o for o in optional if o[0] not in allowed] == []
    assert _forbidden("arterynetwork_tpu.flow") and _forbidden("jax.numpy")
    assert not _forbidden("arterynetwork_tpu_torch.flow")
    assert _optional("networkx.readwrite") and _optional("matplotlib.pyplot")
    assert _optional("mpl_toolkits.mplot3d")
