"""The voxel-graph path of the PyTorch port against the JAX package, on
the CPU: branch attributes, traversal, partitioning, morphology,
curvature, editing, the legacy bundle, ``run_pipeline`` with
``flow.graph_path="nx"`` and an artifact store, and the CLI.

Inputs are those of the JAX tests tests/test_morpho.py,
tests/test_editing.py, tests/test_network_setup.py (the legacy bundle),
tests/test_io.py and tests/test_pipeline.py::test_soa_flow_path_matches_
nx_path, plus a loopy fixture (a diamond of two equal-length arcs and a
closed loop at a junction) on which path ties and cycle bases matter.

Tolerances: graphs, dicts, segment lists, events, networks and JSON are
equal exactly (graphs in node and neighbour order, with attribute
types); curvature within 1e-12 absolute (the spline fit is the same
scipy call on the same points); pressures and flows within 1e-9
relative at f64 (tests/test_torch_pipeline.py's bound); the stored
vesselness equals the port's own exactly and the JAX package's within
1e-3 absolute: the f32 closed-form eigenvalues are ill-conditioned at
near-degenerate eigenpairs, where tests/test_torch_vesselness.py
measures up to 3.4e-5 on its volume and this test 1.2e-4 at one voxel of
the tube's 89,600 [values in [0, 1]].
"""

import json
import os
import pickle

import networkx as nx
import numpy as np
import pytest
import torch

from arterynetwork_tpu.config import PipelineConfig
from arterynetwork_tpu.graphs import branch_attrs as j_branch
from arterynetwork_tpu.graphs import editing as j_edit
from arterynetwork_tpu.graphs import partitioning as j_part
from arterynetwork_tpu.graphs import segments as j_seg
from arterynetwork_tpu.graphs import traversal as j_trav
from arterynetwork_tpu.io.artifacts import ArtifactStore as JStore
from arterynetwork_tpu.morpho import curvature as j_curv
from arterynetwork_tpu.morpho import metrics as j_met
from arterynetwork_tpu_torch import convert
from arterynetwork_tpu_torch.graphs import branch_attrs as t_branch
from arterynetwork_tpu_torch.graphs import editing as t_edit
from arterynetwork_tpu_torch.graphs import partitioning as t_part
from arterynetwork_tpu_torch.graphs import segments as t_seg
from arterynetwork_tpu_torch.graphs import traversal as t_trav
from arterynetwork_tpu_torch.graphs import voxel_graph as vg
from arterynetwork_tpu_torch.io.artifacts import ArtifactStore as TStore
from arterynetwork_tpu_torch.morpho import curvature as t_curv
from arterynetwork_tpu_torch.morpho import metrics as t_met

torch.set_num_threads(1)

CURV_TOL = 1e-12
F64_REL = 1e-9
VESSELNESS_ATOL = 1e-3


def _same_graph(a, b):
    """Equal nodes, attributes (and their types), neighbour order."""
    assert type(a).__name__ == type(b).__name__
    na = [(n, d, [type(x) for x in d.values()]) for n, d in
          a.nodes(data=True)]
    nb = [(n, d, [type(x) for x in d.values()]) for n, d in
          b.nodes(data=True)]
    assert na == nb
    assert [(n, list(a.adj[n].items())) for n in a.nodes()] == \
        [(n, list(b.adj[n].items())) for n in b.nodes()]
    for _, _, d in a.edges(data=True):
        assert all(type(x) in (int, float, str, bool) for x in d.values())


def _same_net(a, b):
    for f in ("heads", "tails", "node_depth", "radius", "length",
              "entry_nodes", "edge_segment_index", "node_coord", "c", "k"):
        x, y = getattr(a, f), getattr(b, f)
        if y is None:
            assert x is None, f
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                          err_msg=f)


# ----------------------------------------------------------------- fixtures
def _y_segments(n=14):
    """tests/test_morpho.py: three branches meeting at (30, 30, 30)."""
    j = (30, 30, 30)
    trunk = [(30, 30, 30 - i) for i in range(n)][::-1]
    a = [(30 + i, 30 + i, 30 + i) for i in range(n)]
    b = [(30 + i, 30 - i, 30 + i) for i in range(n)]
    a[0] = j
    b[0] = j
    return [trunk, a, b]


def _loopy_segments():
    """A trunk into a diamond (two equal-length arcs between the same
    junctions: tied shortest paths), a closed loop hanging off a junction,
    and two leaves, one a long gently curved branch."""
    trunk = [(20, 20, z) for z in range(0, 12)]
    j1, j2 = (20, 20, 11), (20, 20, 21)
    up = [j1] + [(20, 21 + min(i, 2) - max(0, i - 6), 12 + i)
                 for i in range(9)] + [j2]
    down = [j1] + [(20, 19 - min(i, 2) + max(0, i - 6), 12 + i)
                   for i in range(9)] + [j2]
    leaf = [j2] + [(20 + i // 4, 20, 22 + i) for i in range(16)]
    j3 = leaf[8]
    leaf_a, leaf_b = leaf[:9], leaf[8:]
    loop = [j3, (23, 21, 30), (24, 22, 30), (24, 23, 31), (23, 23, 32),
            (22, 22, 31), j3]
    side = [j1, (21, 21, 10), (22, 22, 9), (23, 23, 9), (24, 24, 8)]
    return [trunk, up, down, leaf_a, leaf_b, loop, side]


FIXTURES = {"y": _y_segments, "loopy": _loopy_segments}


def _dt(segments, shape=(48, 48, 48)):
    rng = np.random.default_rng(3)
    dt = np.zeros(shape, np.float32)
    for seg in segments:
        for v in seg:
            dt[v] = 1.0 + float(rng.integers(0, 4)) / 2
    return dt


def _branch_graphs(name):
    segs = FIXTURES[name]()
    dt = _dt(segs)
    return (segs, t_branch.calculate_branch_info(segs, segs,
                                                 distance_transform=dt),
            j_branch.calculate_branch_info(segs, segs,
                                           distance_transform=dt))


# -------------------------------------------------------------- graph stage
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_calculate_branch_info_matches_jax(name):
    segs, a, b = _branch_graphs(name)
    _same_graph(a, b)
    assert all(type(d["radius"]) is float for _, d in a.nodes(data=True))
    # from a vessel mask: the box-cropped EDT runs here on the CPU
    mask = np.zeros((48, 48, 48), np.uint8)
    for seg in segs:
        for z, y, x in seg:
            mask[max(z - 2, 0):z + 3, max(y - 2, 0):y + 3,
                 max(x - 2, 0):x + 3] = 1
    _same_graph(t_branch.calculate_branch_info(segs, segs,
                                               vessel_volume=mask,
                                               device="cpu"),
                j_branch.calculate_branch_info(segs, segs,
                                               vessel_volume=mask))


def test_segment_graphs_match_jax():
    """skeleton_to_voxel_graph, extract_segments, segments_to_graph,
    validate_segment and the Python junction-bridge audit."""
    skel = np.zeros((48, 48, 48), bool)
    for seg in _loopy_segments():
        for v in seg:
            skel[v] = True
    a, b = t_seg.skeleton_to_voxel_graph(skel), \
        j_seg.skeleton_to_voxel_graph(skel)
    _same_graph(a, b)
    sa, sb = t_seg.extract_segments(a), j_seg.extract_segments(b)
    assert sa == sb and len(sa) >= 3
    _same_graph(t_seg.segments_to_graph(sa), j_seg.segments_to_graph(sb))
    assert [t_seg.validate_segment(a, s) for s in sa] == \
        [j_seg.validate_segment(b, s) for s in sb]

    # the Python prune_junction_bridges (the native extractor's fallback):
    # tests/test_segments.py's twin arc, then a graph with a closed loop
    # at a junction and a 2-voxel bridge on a cycle
    twin = [(i, i + 1) for i in range(30)] + [(10, 31), (31, 32), (32, 33),
                                              (33, 14)]
    twin_xyz = [(i, 0, 0) for i in range(31)] + [(11, 1, 0), (12, 1, 0),
                                                 (13, 1, 0)]
    loops = [(0, 1), (1, 2), (2, 3), (3, 4), (4, 1), (4, 5), (5, 6),
             (5, 7), (7, 8), (8, 5)]
    loops_xyz = [(0, 0, 0), (1, 0, 0), (2, 1, 0), (2, 2, 0), (1, 1, 0),
                 (1, 2, 1), (1, 3, 1), (2, 2, 2), (1, 2, 2)]
    for edges, xyz, kw in ((twin, twin_xyz, {}),
                           (loops, loops_xyz, {"cover_tol": 2.0})):
        n = len(xyz)
        ea, eb = (np.asarray(x, np.int64) for x in zip(*edges))
        chains = t_seg._chains_from_edge_indices(ea, eb, n)
        radius = np.linspace(0.5, 2.0, n).astype(np.float32)
        coords = np.asarray(xyz, np.float64)
        for extra in ({}, {"coords": coords}):
            out = t_seg.prune_junction_bridges(chains, n, radius, **kw,
                                               **extra)
            assert out == j_seg.prune_junction_bridges(chains, n, radius,
                                                       **kw, **extra)
            assert len(out) < len(chains)


# ---------------------------------------------------------------- traversal
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_traversal_matches_jax(name):
    segs, a, b = _branch_graphs(name)
    root = segs[0][0]
    ra, rb = t_trav.partition_bfs(a, [root], []), \
        j_trav.partition_bfs(b, [root], [])
    assert ra[1:] == rb[1:]
    _same_graph(a, b)
    bound = [segs[1][3]]
    assert t_trav.random_walk_bfs2(a, [root], bound)[1:] == \
        j_trav.random_walk_bfs2(b, [root], bound)[1:]
    t_trav.assign_segment_levels(a, segs)
    j_trav.assign_segment_levels(b, segs)
    _same_graph(a, b)
    reached = sorted(set(ra[2]) | {0})
    da, db = t_trav.reduce_graph(a, segs, reached), \
        j_trav.reduce_graph(b, segs, reached)
    _same_graph(da, db)
    (na, oa), (nb, ob) = (t_trav.reduced_to_flow_network(da, root, 4e-4),
                          j_trav.reduced_to_flow_network(db, root, 4e-4))
    assert oa == ob
    _same_net(na, nb)


def test_nx_route_collapses_parallel_arcs_like_jax():
    """flow_stage reduces the voxel graph to a DiGraph, so two segments
    joining one pair of junctions (the loopy fixture's diamond) become one
    edge, in the JAX package as in the port; flow_stage_soa keeps both.
    On the segments the nx route keeps, the routes agree (chip_smoke.py's
    gate (a) on pipeline_512)."""
    from arterynetwork_tpu import pipeline as jp
    from arterynetwork_tpu_torch import pipeline as tp
    from arterynetwork_tpu_torch.graphs.branch_attrs import \
        compute_branch_attrs

    segs, a, b = _branch_graphs("loopy")
    dt = _dt(segs)
    attrs = compute_branch_attrs(segs, segs, dt)
    root = segs[0][0]
    jcfg = PipelineConfig()
    jcfg.flow.dtype = "float64"
    tcfg = convert.pipeline_config(jcfg)
    tn, ts, to = tp.flow_stage(a, segs, root, tcfg, device="cpu")
    jn, js, jo = jp.flow_stage(b, segs, root, jcfg)
    _same_net(tn, jn)
    assert to == jo
    assert _rel(ts.pressure.numpy(), np.asarray(js.pressure)) <= F64_REL
    sn, _, _ = tp.flow_stage_soa(segs, attrs, root, tcfg, device="cpu")
    jsn, _, _ = jp.flow_stage_soa(segs, attrs, root, jcfg)
    _same_net(sn, jsn)
    kept = sorted(int(i) for i in tn.edge_segment_index)
    extra = sorted(set(int(i) for i in sn.edge_segment_index) - set(kept))
    assert len(extra) == 1 and {1, 2} == set(extra) | ({1, 2} & set(kept))
    kn, ks, ko = tp.flow_stage_soa([segs[i] for i in kept],
                                   [attrs[i] for i in kept], root, tcfg,
                                   device="cpu")
    assert ko == to and kn.num_edges == tn.num_edges
    assert _rel(ks.pressure.numpy(), ts.pressure.numpy()) <= F64_REL


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_partition_morpho_curvature_match_jax(name, tmp_path):
    from arterynetwork_tpu.viz.study_plots import (
        statistics_per_partition as j_stats,
        statistics_per_partition2 as j_stats2)
    from arterynetwork_tpu_torch.viz import (statistics_per_partition,
                                             statistics_per_partition2)

    segs, a, b = _branch_graphs(name)
    chosen = {"LMCA": {"initial_voxels": [segs[0][0]],
                       "boundary_voxels": [segs[-1][2]]},
              "ACA": {"initial_voxels": [segs[-1][-1]],
                      "boundary_voxels": []}}
    t_trav.partition_bfs(a, [segs[0][0]], [])
    j_trav.partition_bfs(b, [segs[0][0]], [])
    pa = t_part.partition_compartments(a, segs, chosen)
    pb = j_part.partition_compartments(b, segs, chosen)
    assert pa == pb
    _same_graph(a, b)
    t_part.save_partition(TStore(str(tmp_path / "t")), chosen, pa, a)
    j_part.save_partition(JStore(str(tmp_path / "j")), chosen, pb, b)
    assert t_part.load_partition(TStore(str(tmp_path / "t"))) == \
        j_part.load_partition(JStore(str(tmp_path / "j")))
    _same_graph(TStore(str(tmp_path / "t")).load_graphml(
        "graphRepresentationCleanedWithAdvancedInfo.graphml"),
        JStore(str(tmp_path / "j")).load_graphml(
            "graphRepresentationCleanedWithAdvancedInfo.graphml"))

    for kw in ({"min_nodes": 5}, {"min_nodes": 0,
                                   "skip_uncategorized": True}):
        ma, mb = t_met.calculate_property(a, segs, **kw), \
            j_met.calculate_property(b, segs, **kw)
        np.testing.assert_equal(ma, mb)
        assert t_met.summarize(*ma) == j_met.summarize(*mb)
    parts = {k: {**chosen[k], **pa[k]} for k in pa}
    np.testing.assert_equal(statistics_per_partition(a, segs, parts),
                            j_stats(b, segs, parts))
    np.testing.assert_equal(statistics_per_partition2(a, segs, parts),
                            j_stats2(b, segs, parts))

    seg_info = ma[1]
    ca = t_curv.calculate_curvature(a, {k: dict(v) for k, v in
                                        seg_info.items()}, parts)
    cb = j_curv.calculate_curvature(b, {k: dict(v) for k, v in
                                        mb[1].items()}, parts)
    assert ca.keys() == cb.keys()
    n_curved = 0
    for k in ca:
        assert ca[k].keys() == cb[k].keys()
        for f in ("maxCurvatureAveragedInmm", "meanCurvatureAveragedInmm"):
            if f in ca[k]:
                n_curved += 1
                assert abs(ca[k][f] - cb[k][f]) <= CURV_TOL
    assert n_curved >= 2


def test_curvature_tied_paths_choose_networkx_path():
    """On the diamond both arcs are shortest root->leaf paths: the
    curvature follows the one networkx's bidirectional BFS picks."""
    segs, a, b = _branch_graphs("loopy")
    root, leaf = segs[0][0], segs[4][-1]
    visited = sorted({v for s in segs for v in s})
    pa = vg.shortest_path(a.subgraph(visited), root, leaf)
    pb = nx.shortest_path(b.subgraph(visited), root, leaf)
    assert pa == pb
    assert len({v for v in pa} & set(segs[1])) > 2 or \
        len({v for v in pa} & set(segs[2])) > 2


# ------------------------------------------------------------------ editing
def _x_segments():
    """tests/test_editing.py: four branches meeting at one junction."""
    j = (10, 10, 10)
    return [[j] + [(10 + d[0] * i, 10 + d[1] * i, 10 + d[2] * i)
                   for i in range(1, 7)]
            for d in ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0))]


def _twin_arc_segments():
    trunk = [(i, 0, 0) for i in range(31)]
    twin = [(10, 0, 0), (11, 1, 0), (12, 1, 0), (13, 1, 0), (14, 0, 0)]
    return [trunk[:11], trunk[10:15], trunk[14:], twin]


def _edit_script(mod, segs, store, capsys):
    s = mod.CorrectionSession(segs)
    out = [s.remove_segment(1), s.cut(2, (10, 13, 10)),
           s.reconnect((16, 10, 10), (10, 16, 10),
                       context_a=[(14, 10, 10), (15, 10, 10)],
                       context_b=[(10, 15, 10), (10, 14, 10)]),
           s.reconnect((4, 10, 10), (10, 4, 10))]
    tip = s.segments[0][-1]
    out.append(s.grow(0, [tip, (17, 10, 10), (18, 10, 10)]))
    out.append(s.check_cycles())
    out.append(s.report_cycle_info())
    out.append(capsys.readouterr().out)
    out.append(s.undo())
    out.append(dict(s.segments))
    out.append(s.save(store))
    s2 = mod.CorrectionSession(segs)
    s2.replay(store.load_pickle("eventList.pkl"))
    out.append(s2.remove_segment(0))
    out.append(dict(s2.segments))
    out.append(s2.check_cycles())
    return out


def test_editing_session_matches_jax(tmp_path, capsys):
    ts, js = TStore(str(tmp_path / "t")), JStore(str(tmp_path / "j"))
    assert _edit_script(t_edit, _x_segments(), ts, capsys) == \
        _edit_script(j_edit, _x_segments(), js, capsys)
    _same_graph(ts.load_graphml("graphRepresentationCleaned.graphml"),
                js.load_graphml("graphRepresentationCleaned.graphml"))
    assert ts.load_segment_list("segmentListCleaned.npz") == \
        js.load_segment_list("segmentListCleaned.npz")
    # cycles on the loopy fixture (tied arcs and a closed loop)
    assert t_edit.CorrectionSession(_loopy_segments()).check_cycles() == \
        j_edit.CorrectionSession(_loopy_segments()).check_cycles()


@pytest.mark.parametrize("case", ["twin", "uncovered", "loopy"])
def test_audit_junction_bridges_matches_jax(case):
    if case == "twin":
        segs = _twin_arc_segments()
        dt = np.ones((31, 8, 4), np.float32)
        for v in segs[3]:
            dt[v] = 0.5
    elif case == "uncovered":
        bottom = [(i, 0, 0) for i in range(11)]
        right = [(10, j, 0) for j in range(11)]
        top = [(i, 10, 0) for i in range(10, -1, -1)]
        left = [(0, j, 0) for j in range(10, -1, -1)]
        segs = [bottom, right, top, left,
                [(0, 0, 0), (0, 0, 1), (0, 0, 2), (0, 0, 3)],
                [(10, 0, 0), (10, 0, 1), (10, 0, 2), (10, 0, 3)]]
        dt = None
    else:
        segs = _loopy_segments()
        dt = _dt(segs)
    out = []
    for mod in (t_edit, j_edit):
        s = mod.CorrectionSession(segs)
        ev = mod.audit_junction_bridges(s, distance_transform=dt,
                                        cover_tol=6.0)
        out.append((ev, dict(s.segments), s.events))
    assert out[0] == out[1]
    if case == "twin":
        assert len(out[0][0]) >= 1


# ----------------------------------------------------------- legacy bundle
def _legacy_bundle(directory):
    """tests/test_network_setup.py's bundle, pickled by networkx."""
    segs = [[(0, 0, z) for z in range(4)],
            [(0, 0, 3), (0, 1, 4), (0, 2, 5)],
            [(0, 0, 3), (1, 0, 4), (2, 0, 5)]]
    G = nx.Graph()
    for i, seg in enumerate(segs):
        for a, b in zip(seg[:-1], seg[1:]):
            G.add_edge(a, b, segmentIndex=i, meanRadius=2.0 - 0.5 * i,
                       pathLength=float(len(seg) - 1))
    for v in G.nodes():
        G.nodes[v]["depthLevel"] = 0 if v[2] <= 3 and v[:2] == (0, 0) \
            else 1
    G.nodes, G.adj, G.edges      # cached views in the pickle
    bundle = {"G": G, "segmentList": segs,
              "segmentInfoDict": {0: {}, 1: {}, 2: {}}, "nodeInfoDict": {}}
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "basicFilesForStructureWithCoW4"
                           "(year=BraVa).pkl"), "wb") as f:
        pickle.dump(bundle, f)
    with open(os.path.join(directory, "partitionInfo.pkl"), "wb") as f:
        pickle.dump({"LMCA": {"visitedVoxels": [], "segmentIndexList": []}},
                    f)


def test_legacy_bundle_matches_jax(tmp_path):
    from arterynetwork_tpu.flow.network_setup import (
        convert_network as j_convert, load_network as j_load)
    from arterynetwork_tpu_torch.flow.network_setup import (
        convert_network, load_network)

    _legacy_bundle(str(tmp_path))
    la, lb = load_network(str(tmp_path)), j_load(str(tmp_path))
    assert type(la["G"]) is vg.Graph and la.keys() == lb.keys()
    _same_graph(la["G"], lb["G"])
    assert la["partitionInfo"] == lb["partitionInfo"]
    for root in ((0, 0, 0), None):
        (na, oa), (nb, ob) = (convert_network(la, root_coord=root),
                              j_convert(lb, root_coord=root))
        assert oa == ob and na.num_edges == 3
        _same_net(na, nb)


# ----------------------------------------------------------------- pipeline
def _raw(kind):
    from tests.test_torch_pipeline import _raw as raw
    return raw(kind)


def _nx_config():
    from tests.test_torch_pipeline import _bench_config
    cfg = _bench_config("float64")
    cfg.flow.graph_path = "nx"
    return cfg


STORE_FILES = ["fluidSimulationResult.pkl",
               "graphRepresentationCleanedWithEdgeInfo.graphml",
               "segmentList.npz", "skeleton.nii.gz",
               "vesselVolumeMask.nii.gz", "vesselnessFiltered.nii.gz"]


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.mark.parametrize("kind", ["tube", "tree"])
def test_run_pipeline_nx_store_matches_jax(kind, tmp_path):
    from arterynetwork_tpu.pipeline import run_pipeline as j_run
    from arterynetwork_tpu_torch.io.nifti import load_volume
    from arterynetwork_tpu_torch.pipeline import (run_pipeline,
                                                  vesselness_stage)

    raw = _raw(kind)
    cfg = _nx_config()
    affine = np.diag([0.5, 0.5, 0.25, 1.0])   # exact in the f32 header
    ts, js = TStore(str(tmp_path / "t")), JStore(str(tmp_path / "j"))
    ref = j_run(raw_volume=raw, config=cfg, store=js, affine=affine)
    ref_mask = ref["mask"].copy()
    out = run_pipeline(raw_volume=raw, config=convert.pipeline_config(cfg),
                       store=ts, affine=affine, device="cpu")
    assert sorted(os.listdir(ts.base_dir)) == \
        sorted(os.listdir(js.base_dir)) == STORE_FILES
    np.testing.assert_array_equal(out["mask"], ref_mask)
    assert out["segments"] == [list(map(tuple, s)) for s in ref["segments"]]
    _same_graph(out["graph"], ref["graph"])
    assert out["node_of"] == ref["node_of"]
    _same_net(out["network"], ref["network"])
    sol, rsol = out["solution"], ref["solution"]
    assert _rel(sol.pressure.numpy(), np.asarray(rsol.pressure)) <= F64_REL
    assert _rel(sol.flow.numpy(), np.asarray(rsol.flow)) <= F64_REL

    # every file reads back equal: to the run and to the JAX package's
    for name, arr in (("vesselVolumeMask.nii.gz", out["mask"]),
                      ("skeleton.nii.gz", out["skeleton"])):
        v, aff = load_volume(ts.path(name))
        np.testing.assert_array_equal(v, arr.astype(np.uint8))
        np.testing.assert_array_equal(v, js.load_nifti(name)[0])
        np.testing.assert_array_equal(aff, affine)
    v, _ = ts.load_nifti("vesselnessFiltered.nii.gz")
    assert v.dtype == np.float32
    np.testing.assert_array_equal(v, vesselness_stage(
        raw, convert.pipeline_config(cfg), device="cpu").numpy())
    np.testing.assert_allclose(v, js.load_nifti(
        "vesselnessFiltered.nii.gz")[0], rtol=0, atol=VESSELNESS_ATOL)
    assert ts.load_segment_list("segmentList.npz") == out["segments"] == \
        js.load_segment_list("segmentList.npz")
    name = "graphRepresentationCleanedWithEdgeInfo.graphml"
    for load in (ts.load_graphml, js.load_graphml):
        _same_graph(load(name), TStore(js.base_dir).load_graphml(name))
        _same_graph(load(name), JStore(ts.base_dir).load_graphml(name))
    pa, pb = ts.load_pickle("fluidSimulationResult.pkl"), \
        js.load_pickle("fluidSimulationResult.pkl")
    assert pa.keys() == pb.keys() and pa["node_of"] == pb["node_of"]
    np.testing.assert_array_equal(pa["pressure"], sol.pressure.numpy())
    for k in ("pressure", "flow", "velocity"):
        assert _rel(pa[k], pb[k]) <= F64_REL

    # the soa route on the same input, and graph_stage's build_nx switch
    from arterynetwork_tpu_torch.pipeline import graph_stage
    soa = convert.pipeline_config(cfg)
    soa.flow.graph_path = "soa"
    s = run_pipeline(raw_volume=raw, config=soa, device="cpu")
    assert s["graph"] is None and s["segments"] == out["segments"]
    assert _rel(s["solution"].pressure.numpy(), sol.pressure.numpy()) \
        <= F64_REL
    G, _, _ = graph_stage(out["skeleton"], out["mask"], soa,
                          build_nx=False)
    assert G is None


# ---------------------------------------------------------------------- CLI
def _phantom_file(tmp_path):
    """tests/test_cli.py's phantom."""
    from arterynetwork_tpu.io.nifti import save_volume

    shape = (36, 36, 48)
    rng = np.random.default_rng(2)
    raw = rng.normal(100.0, 3.0, shape).astype(np.float32)
    x, y = np.mgrid[: shape[0], : shape[1]]
    tube = (x - 18) ** 2 + (y - 18) ** 2 <= 9
    for z in range(6, 42):
        raw[:, :, z] += 120.0 * tube
    p = str(tmp_path / "raw.nii.gz")
    save_volume(raw, np.eye(4), p, astype=np.float32)
    return p


def _run_cli(main, argv, capsys):
    main(argv)
    return json.loads(capsys.readouterr().out)


def test_cli_matches_jax(tmp_path, capsys):
    from arterynetwork_tpu.__main__ import main as j_main
    from arterynetwork_tpu_torch.__main__ import main

    raw = _phantom_file(tmp_path)
    outs = {}
    for lib, fn, extra in (("t", main, ["--device", "cpu"]),
                           ("j", j_main, [])):
        d = str(tmp_path / lib)
        pipe = _run_cli(fn, ["pipeline", raw, "--out", d, "--raw",
                             "--threshold", "0.3", "--skeleton-backend",
                             "native"] + extra, capsys)
        pipe.pop("timings_s")
        morpho = _run_cli(fn, ["morpho", d, "--no-figures"] + extra, capsys)
        study = _run_cli(fn, ["study", "flow_split", "--out", d,
                              "--timesteps", "3", "--depth", "5"] + extra,
                         capsys)
        outs[lib] = (pipe, morpho, study, sorted(os.listdir(d)))
    assert outs["t"] == outs["j"]
    assert outs["t"][1]["statisticsPerPartition"]["Overall"][
        "numBranches"] >= 1
    bundle = TStore(str(tmp_path / "t"))
    seg_info = bundle.load_pickle("segmentInfoDict.pkl")
    assert any("maxCurvatureAveragedInmm" in v for v in seg_info.values())
    np.testing.assert_equal(seg_info, JStore(str(tmp_path / "j"))
                            .load_pickle("segmentInfoDict.pkl"))

    # the figure paths in both packages: morpho with its figures, then
    # study gbm5 and gbm5b; the same files, the same figure keys (none
    # FAILED) and the same summaries
    figs = {}
    for lib, fn, extra in (("t", main, ["--device", "cpu"]),
                           ("j", j_main, [])):
        d = str(tmp_path / lib)
        morpho = _run_cli(fn, ["morpho", d] + extra, capsys)
        studies = []
        for name in ("gbm5", "gbm5b"):
            sd = str(tmp_path / f"{lib}_{name}")
            studies.append(_run_cli(fn, ["study", name, "--out", sd,
                                         "--timesteps", "3", "--depth",
                                         "5"] + extra, capsys))
            studies.append(sorted(os.listdir(sd)))
        figs[lib] = (morpho, studies, sorted(os.listdir(d)))
    (mt, st, ft), (mj, sj, fj) = figs["t"], figs["j"]
    assert mt["figures"].keys() == mj["figures"].keys()
    assert len(mt["figures"]) == 13 and not any(
        str(v).startswith("FAILED")
        for v in list(mt["figures"].values()) + list(mj["figures"].values()))
    assert {k: v for k, v in mt.items() if k != "figures"} == \
        {k: v for k, v in mj.items() if k != "figures"}
    assert ft == fj and all(k + ".png" in ft for k in mt["figures"])
    assert st == sj
    assert "gbm5_network_t0.png" in st[1] and "gbm5b_volumes.png" in st[3]
    info = _run_cli(main, ["info"], capsys)
    assert info["torch"] == torch.__version__ and \
        info["cuda_available"] is torch.cuda.is_available()


def test_cli_study_network_dir_and_vesselness(tmp_path, capsys):
    """``study --network-dir`` loads a legacy bundle (networkx pickle);
    ``vesselness`` writes the port's frangi_vesselness."""
    from arterynetwork_tpu.__main__ import main as j_main
    from arterynetwork_tpu_torch.__main__ import main
    from arterynetwork_tpu_torch.io.nifti import load_volume
    from arterynetwork_tpu_torch.ops.vesselness import frangi_vesselness

    net_dir = str(tmp_path / "bundle")
    _legacy_bundle(net_dir)
    res = []
    for fn, extra in ((main, ["--device", "cpu"]), (j_main, [])):
        res.append(_run_cli(fn, ["study", "two_timepoint", "--out",
                                 str(tmp_path / "s"), "--network-dir",
                                 net_dir] + extra, capsys))
    assert res[0] == res[1]
    raw = _phantom_file(tmp_path)
    out = str(tmp_path / "v.nii.gz")
    main(["vesselness", raw, out, "--sigmas", "2.0,3.0", "--device", "cpu"])
    v, _ = load_volume(out)
    ref = frangi_vesselness(load_volume(raw)[0].astype(np.float32),
                            sigmas=(2.0, 3.0), device="cpu").numpy()
    np.testing.assert_array_equal(v, ref)
    assert v.max() > 0.3
