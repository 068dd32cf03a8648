"""The flow solves' cache (flow/solvers.py): graphs kept across calls of
the same shapes, the counterpart of ``jax.jit``'s cache.

Every tensor a solve's steps read lies in a cached entry, and a call
copies its system into it before any step runs.  Held here on the CPU,
where the entries run their steps eagerly, on seeded trees of depth 6
(the dense, tree and CG routes, one system and a batch of T = 4 rows,
f32 with its 2 refinement steps and f64):

  * the sequences A, B, A and A, A: each solve bit-equal to the same
    solve with the cache cleared before it, the warm ones hits.  B has
    A's shapes with other radii and boundary pressures (x 0.9), and for
    the dense and CG routes another tree of A's sizes (two leaves moved
    from one parent to a leaf one level down);
  * an earlier solution and its CG steps unchanged by later solves;
  * a different T, E, dtype, linear solver or refine_steps takes a new
    entry, a different ``tol`` gives a fresh solve's bits at that tol,
    an evicted key solves again from a new entry;
  * ``tp_fit_solve_study`` (4 timesteps) and two calls of
    ``radius_perturbation_study``: the same bits with the cache and with
    it cleared before every solve;
  * one warm solve within tests/test_torch_flow.py's tolerances of the
    JAX package's ``solve_pressure_newton``;
  * through GraphLoop with tests/test_torch_solve_loop.py's stand-in for
    torch.cuda's graph calls (a capture records the aten ops, a replay
    runs them again on the tensors they were recorded with): the warm
    solves capture nothing and replay every step, and still give a
    fresh solve's bits, so no graph reads a tensor of the call that
    captured it; a step that cannot be captured raises and drops the
    entry.

The ``gpu`` tests run A, B, A on the card, graph-driven against the
eager loop.
"""

import dataclasses

import numpy as np
import pytest
import torch

from arterynetwork_tpu_torch.flow import experiments as pexp
from arterynetwork_tpu_torch.flow import solvers as tsolvers
from arterynetwork_tpu_torch.flow import studies as pstudies
from arterynetwork_tpu_torch.flow.boundary import bfs_partition
from arterynetwork_tpu_torch.flow.ground_truth import create_ground_truth
from arterynetwork_tpu_torch.flow.system import build_system
from arterynetwork_tpu_torch.flow.tree_solver import plan_elimination
from arterynetwork_tpu_torch.graphs import (generate_tree,
                                            set_network_properties)
from arterynetwork_tpu_torch.graphs.network import make_network
from arterynetwork_tpu_torch.ops import grow_loop

torch.set_num_threads(1)

DTYPES = {"f32": torch.float32, "f64": torch.float64}
TOL = {"f32": 1e-5, "f64": 1e-9}        # tests/test_torch_flow.py's
# (linear solver, T); B of the dense and CG routes is another tree
ROUTES = [("dense", 1), ("tree", 1), ("cg", 1), ("dense", 4), ("tree", 4)]
MOVED = {"dense", "cg"}


def _tree(depth=6, seed=0):
    rng = np.random.default_rng(seed)
    return set_network_properties(generate_tree(max_depth=depth, rng=rng),
                                  k_value=1.852, rng=rng)


def _moved(net):
    """``net`` with the two leaves of its last edge pair moved to a leaf
    one level down: the same nodes, edges and unknowns, another tree."""
    heads, tails = net.heads.copy(), net.tails.copy()
    depth = net.node_depth.copy()
    x = heads[-1]
    y = next(int(n) for n in np.nonzero(net.degree == 1)[0]
             if n != x and n not in tails[heads == x] and n != 0)
    moved = heads == x
    heads[moved] = y
    depth[tails[moved]] = depth[y] + 1
    out = make_network(np.stack([heads, tails], 1), depth, net.radius,
                       net.length, spacing=net.spacing)
    return out.replace(c=net.c, k=net.k)


def _rows(net, T, seed, scale):
    """T rows on ``net``: radii x (1 + 0.1 u) and the ground truth's
    boundary pressures x scale (a row t > 0 also x (1 + 0.02 t u))."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(T):
        n = net.replace(radius=net.radius * (1.0 + 0.1 * rng.random(
            net.num_edges)))
        gt = create_ground_truth(n, option=2, rng=np.random.default_rng(7))
        assert gt.success
        out.append((n, gt.pressure * scale
                    * (1.0 + 0.02 * t * rng.random(net.num_nodes))))
    return out


def _system(net, T, dtype, seed=0, scale=1.0, device="cpu"):
    """The port's system of one row (T = 1) or T rows, stacked, and its
    elimination plan."""
    rows = [build_system(n, boundary_pressure=bp, dtype=DTYPES[dtype],
                         device=device) for n, bp in _rows(net, T, seed,
                                                           scale)]
    plan = plan_elimination(rows[0])
    if T == 1:
        return rows[0], plan
    stack = {f: torch.stack([getattr(s, f) for s in rows])
             for f in ("radius_m", "c", "k", "node_fixed_pressure")}
    return dataclasses.replace(rows[0], **stack), plan


def _pair(solver, T, dtype, device="cpu"):
    """Systems A and B of one key."""
    net = _tree()
    a = _system(net, T, dtype, device=device)
    b = _system(_moved(net) if solver in MOVED else net, T, dtype, seed=1,
                scale=0.9, device=device)
    return {"A": a, "B": b}


def _solve(sp, solver, **kw):
    """(solution, stats) of the unbatched or batched entry."""
    system, plan = sp
    stats = tsolvers.SolveStats()
    kw = {"tol": 1e-14, "linear_solver": solver,
          "plan": plan if solver == "tree" else None, "stats": stats, **kw}
    if system.node_fixed_pressure.dim() == 2:
        return tsolvers.solve_pressure_newton_batch(system, **kw), stats
    return tsolvers.solve_pressure_newton(system, **kw), stats


def _fresh(sp, solver, **kw):
    tsolvers.clear_solve_cache()
    return _solve(sp, solver, **kw)


def _bits(sol, stats=None):
    parts = [np.asarray(x).tobytes() for x in sol]
    if stats is not None and stats.cg_steps is not None:
        parts.append(stats.cg_steps.numpy().tobytes())
    return b"".join(parts)


def _counts(stats):
    return (stats.host_reads, stats.linear_solves, stats.runs,
            None if stats.cg_steps is None else stats.cg_steps.tolist())


@pytest.fixture(autouse=True)
def _empty_cache():
    tsolvers.clear_solve_cache()
    yield
    tsolvers.clear_solve_cache()


# ----------------------------------------------------------------------
# A, B, A and A, A against fresh solves
# ----------------------------------------------------------------------
@pytest.mark.parametrize("order", ["ABA", "AA"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("solver,T", ROUTES)
def test_sequence_matches_fresh_solves(solver, T, dtype, order):
    systems = _pair(solver, T, dtype)
    if solver in MOVED:     # B is another tree of A's sizes
        assert not torch.equal(systems["A"][0].head, systems["B"][0].head)
    fresh = {n: _fresh(systems[n], solver) for n in set(order)}
    tsolvers.clear_solve_cache()
    for i, name in enumerate(order):
        sol, stats = _solve(systems[name], solver)
        assert _bits(sol, stats) == _bits(*fresh[name])
        assert _counts(stats) == _counts(fresh[name][1])
        assert (stats.hits, stats.misses) == ((0, 1) if i == 0 else (1, 0))
        assert stats.captures == stats.replays == 0     # no graph here
    info = tsolvers.solve_cache_info()
    assert info["entries"] == {"cpu": 1}


@pytest.mark.parametrize("solver,T", [("cg", 1), ("dense", 4)])
def test_earlier_results_unchanged(solver, T):
    """A solution (and its CG steps) is not a view of the entry: solves
    of B and A after it leave its bytes as they were."""
    systems = _pair(solver, T, "f32")
    first, stats = _solve(systems["A"], solver)
    before = _bits(first, stats)
    for name in "BA":
        _solve(systems[name], solver)
    assert _bits(first, stats) == before


def test_new_keys_take_new_entries():
    """T, E, dtype, linear solver and refine_steps are in the key; a
    different tol gives the bits of a fresh solve at that tol."""
    net = _tree()
    base = _system(net, 1, "f64")
    variants = {
        "T": (_system(net, 4, "f64"), "dense", {}),
        "E": (_system(_tree(5), 1, "f64"), "dense", {}),
        "dtype": (_system(net, 1, "f32"), "dense", {}),
        "solver": (base, "cg", {}),
        "refine_steps": (base, "dense", {"refine_steps": 1}),
        "tol": (base, "dense", {"tol": 1e-9}),
    }
    _solve(base, "dense")
    for name, (sp, solver, kw) in variants.items():
        ref, _ = _fresh(sp, solver, **kw)
        tsolvers.clear_solve_cache()
        _solve(base, "dense")
        sol, stats = _solve(sp, solver, **kw)
        assert (stats.hits, stats.misses) == (0, 1), name
        assert _bits(sol) == _bits(ref), name
        assert tsolvers.solve_cache_info()["entries"] == {"cpu": 2}, name
        _, again = _solve(base, "dense")
        assert again.hits == 1, name


def test_eviction_takes_the_least_recent_entry():
    net = _tree()
    sp = _system(net, 1, "f64")
    tols = [10.0 ** -(6 + i) for i in range(tsolvers._CACHE_SIZE + 1)]
    ref = _fresh(sp, "dense", tol=tols[0])[0]
    tsolvers.clear_solve_cache()
    before = tsolvers.solve_cache_info()
    for tol in tols:
        _solve(sp, "dense", tol=tol)
    info = tsolvers.solve_cache_info()
    assert info["entries"] == {"cpu": tsolvers._CACHE_SIZE}
    assert info["evictions"] - before["evictions"] == 1
    sol, stats = _solve(sp, "dense", tol=tols[0])     # the evicted key
    assert stats.misses == 1 and _bits(sol) == _bits(ref)
    sol, stats = _solve(sp, "dense", tol=tols[-1])
    assert stats.hits == 1


# ----------------------------------------------------------------------
# the studies that re-solve one network
# ----------------------------------------------------------------------
def _study_net(depth=6):
    rng = np.random.default_rng(0)
    net = set_network_properties(generate_tree(max_depth=depth, rng=rng),
                                 rng=rng)
    roots = np.nonzero(net.node_depth == 1)[0]
    parts = {f"P{i}": {"start_nodes": [int(r)], "boundary_nodes": []}
             for i, r in enumerate(roots)}
    radius_end = net.radius.copy()
    radius_end[bfs_partition(net, [int(roots[0])], [])["visited_edges"]] \
        *= 0.85
    return net, parts, radius_end


def _studies():
    net, parts, radius_end = _study_net()
    tp = pstudies.tp_fit_solve_study(
        net, radius_end, num_timesteps=4, interpolation_option=1,
        partitions=parts, rng=np.random.default_rng(3), device="cpu")
    runs = [pexp.radius_perturbation_study(
        net, rng=np.random.default_rng(3 + i), device="cpu")
        for i in range(2)]
    out = [r[f] for r in tp["timesteps"] for f in ("pressure", "flow")]
    out += [r[f] for r in runs for f in ("perturbed_flow", "flow_change")]
    return b"".join(np.asarray(x).tobytes() for x in out)


def test_studies_match_with_the_cache_cleared(monkeypatch):
    newton, calls = tsolvers._newton, []

    def counted(*args):
        stats = tsolvers.SolveStats()
        sol = newton(*args[:-1], stats)
        calls.append((stats.hits, stats.misses))
        return sol

    monkeypatch.setattr(tsolvers, "_newton", counted)
    cached = _studies()
    # 4 timesteps of one network and two copies with perturbed radii:
    # one graph, f64, the dense route ("auto" below 4097 unknowns), one key
    assert calls == [(0, 1)] + [(1, 0)] * 5

    def cleared(*args):
        tsolvers.clear_solve_cache()
        return newton(*args)

    monkeypatch.setattr(tsolvers, "_newton", cleared)
    assert _studies() == cached


# ----------------------------------------------------------------------
# against the JAX package
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_warm_solve_matches_jax(dtype):
    import arterynetwork_tpu.flow as J
    from arterynetwork_tpu.flow.tree_solver import plan_elimination as j_plan

    systems = _pair("tree", 1, dtype)
    for name in "BAB":
        sol, stats = _solve(systems[name], "tree")
    assert stats.hits == 1
    n, bp = _rows(_tree(), 1, 1, 0.9)[0]
    sys_j = J.build_system(n, boundary_pressure=bp, dtype={
        "f32": np.float32, "f64": np.float64}[dtype])
    ref = J.solve_pressure_newton(sys_j, tol=1e-14, linear_solver="tree",
                                  plan=j_plan(sys_j))
    for f in ("pressure", "flow", "velocity"):
        a = getattr(sol, f).numpy()
        b = np.asarray(getattr(ref, f))
        assert np.max(np.abs(a - b)) / np.max(np.abs(b)) <= TOL[dtype], f


# ----------------------------------------------------------------------
# GraphLoop with the stand-in for torch.cuda's graph calls
# ----------------------------------------------------------------------
def _stand_in(monkeypatch, log):
    # imported here: that module imports JAX, which the card's machine
    # lacks, and the gpu tests below run there
    from .test_torch_solve_loop import _stand_in as stand_in

    return stand_in(monkeypatch, log)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("solver,T", ROUTES)
def test_warm_graphs_replay_every_step(monkeypatch, solver, T, dtype):
    systems = _pair(solver, T, dtype)
    fresh = {n: _fresh(systems[n], solver) for n in "AB"}
    tsolvers.clear_solve_cache()
    _stand_in(monkeypatch, [])
    # a batch's dense LU runs between two graphs (the trees have no
    # loop core, so the tree route has no LU)
    segments = 2 if T > 1 and solver == "dense" else 1
    for i, name in enumerate("ABA"):
        sol, stats = _solve(systems[name], solver)
        assert _bits(sol, stats) == _bits(*fresh[name])
        assert _counts(stats) == _counts(fresh[name][1])
        steps = sum(stats.runs.values())
        if i == 0:
            assert stats.misses == 1 and stats.captures > 0
        else:
            assert (stats.hits, stats.captures) == (1, 0)
            assert stats.replays == segments * steps


def test_steps_run_once_are_captured_at_the_end(monkeypatch):
    """A key that ran once in the cold call (here every key: one Newton
    step, one refinement step) is captured at the call's end, so the
    warm call replays it."""
    systems = _pair("dense", 1, "f32")
    ref, _ = _fresh(systems["B"], "dense", max_iter=1, refine_steps=1)
    tsolvers.clear_solve_cache()
    _stand_in(monkeypatch, [])
    _, cold = _solve(systems["A"], "dense", max_iter=1, refine_steps=1)
    assert cold.runs == {"newton": 1, "refine": 1}
    assert (cold.captures, cold.replays) == (2, 0)
    sol, warm = _solve(systems["B"], "dense", max_iter=1, refine_steps=1)
    assert (warm.hits, warm.captures, warm.replays) == (1, 0, 2)
    assert _bits(sol) == _bits(ref)


def test_failed_capture_drops_the_entry(monkeypatch):
    systems = _pair("tree", 1, "f64")
    real = tsolvers._signed_flow_and_weight

    def reads(dp, adm, k):
        float(dp.abs().sum())
        return real(dp, adm, k)

    _stand_in(monkeypatch, [])
    monkeypatch.setattr(tsolvers, "_signed_flow_and_weight", reads)
    with pytest.raises(RuntimeError, match="capturing"):
        _solve(systems["A"], "tree")
    assert tsolvers.solve_cache_info()["entries"] == {"cpu": 0}


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    return torch.device("cuda")


def _card_bits(sol, stats):
    torch.cuda.synchronize()
    parts = [(x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x))
             .tobytes() for x in sol]
    if stats.cg_steps is not None:
        parts.append(stats.cg_steps.cpu().numpy().tobytes())
    return b"".join(parts)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("solver,T", ROUTES)
def test_warm_graphs_on_card_match_eager_loop(cuda, monkeypatch, solver, T,
                                              dtype):
    systems = _pair(solver, T, dtype, device=cuda)
    with monkeypatch.context() as m:
        m.setattr(grow_loop, "loop_for",
                  lambda *args, **kw: grow_loop.HostLoop())
        eager = {n: _card_bits(*_solve(systems[n], solver)) for n in "AB"}
    tsolvers.clear_solve_cache()
    first = None
    for i, name in enumerate("ABA"):
        sol, stats = _solve(systems[name], solver)
        if first is None:
            first, first_bits = (sol, stats), _card_bits(sol, stats)
        assert _card_bits(sol, stats) == eager[name]
        if i == 0:
            assert stats.misses == 1 and stats.captures > 0
        else:
            assert (stats.hits, stats.captures) == (1, 0)
            assert stats.replays >= sum(stats.runs.values()) > 0
    assert _card_bits(*first) == first_bits
