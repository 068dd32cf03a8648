"""viz in the PyTorch port against the JAX package, on the CPU.

Every test of tests/test_viz.py has a counterpart here.  The same inputs,
made from numpy seeds, go to both packages (each builds its own tree or
voxel graph from them), and the data compared is what the figures plot,
not pixels:

  * ``generate_colormap``, the ``line_plot_binned`` statistics,
    ``_tree_layout`` positions, ``draw_segments`` colour codes,
    ``pressure_velocity_arrays`` / ``pressure_velocity_volumes``,
    ``_values_per_partition`` and the per-partition statistics: equal;
  * the arrays ``show_result_gbm_test5`` returns (f64 solves of the
    longitudinal batch): within 1e-12 relative [measured on a CPU:
    terminating pressures 0, flows 2.7e-16];
  * every figure function writes a file of more than 1000 bytes under the
    JAX test's file name.

matplotlib is imported by the figure functions only: importing
``arterynetwork_tpu_torch.viz`` does not import it, and where it cannot
import, the numpy functions still run and a figure raises ImportError.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import arterynetwork_tpu.viz as jviz
import arterynetwork_tpu_torch.viz as tviz
from arterynetwork_tpu import flow as jflow
from arterynetwork_tpu import graphs as jgraphs
from arterynetwork_tpu.flow.adan import set_network_ck as j_set_ck
from arterynetwork_tpu.viz import network_plot as j_np
from arterynetwork_tpu.viz import study_plots as j_sp
from arterynetwork_tpu_torch import flow as tflow
from arterynetwork_tpu_torch import graphs as tgraphs
from arterynetwork_tpu_torch.flow.adan import set_network_ck as t_set_ck
from arterynetwork_tpu_torch.viz import network_plot as t_np
from arterynetwork_tpu_torch.viz import study_plots as t_sp

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
GBM_REL = 1e-12


def _solved_net(pkg, seed=0):
    """tests/test_viz.py::_solved_net, built by ``pkg``'s own modules."""
    graphs, flow, set_ck = ((jgraphs, jflow, j_set_ck) if pkg == "j"
                            else (tgraphs, tflow, t_set_ck))
    rng = np.random.default_rng(seed)
    net = set_ck(graphs.set_network_properties(
        graphs.generate_tree(max_depth=5, rng=rng), rng=rng))
    gt = flow.create_ground_truth(net, option=2, rng=rng)
    return net, gt


def _partitions(net):
    roots = np.nonzero(net.node_depth == 1)[0]
    return {f"P{i}": {"start_nodes": [int(r)], "boundary_nodes": []}
            for i, r in enumerate(roots)}


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    from arterynetwork_tpu_torch.viz._mpl import pyplot

    pyplot().close("all")


def _big(path):
    assert os.path.exists(path) and os.path.getsize(path) > 1000, path


def test_all_equals_jax_and_import_needs_no_matplotlib():
    assert tviz.__all__ == jviz.__all__
    code = ("import sys\n"
            "sys.modules['matplotlib'] = None\n"
            "import numpy as np\n"
            "import arterynetwork_tpu_torch.viz as v\n"
            "from arterynetwork_tpu_torch.viz import study_plots as sp\n"
            "assert v.generate_colormap(np.arange(4.0)).shape == (4, 4)\n"
            "p, q = v.pressure_velocity_volumes((2, 2, 2),\n"
            "    np.array([[0, 0, 1, 5.0]]), np.zeros((0, 4)))\n"
            "assert p[0, 0, 1] == 5.0\n"
            "assert sp._values_per_partition({0: {'partitionName': 'ACA',\n"
            "    'x': 2.0}}, 'x')[2] == [2.0]\n"
            "calls = 0\n"
            "for fn in (lambda: v.plot_root_pressure_over_time(\n"
            "               np.ones((2, 3)), [0]),\n"
            "           lambda: v.fig3({}, {}),\n"
            "           lambda: v.draw_segments([[(0, 0, 0), (1, 1, 1)]])):\n"
            "    try:\n"
            "        fn()\n"
            "    except ImportError as exc:\n"
            "        assert 'matplotlib' in str(exc)\n"
            "        calls += 1\n"
            "assert calls == 3\n"
            "assert not [m for m in sys.modules if m.startswith('matplotlib')\n"
            "            and sys.modules[m] is not None]\n"
            "print('viz without matplotlib')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=str(REPO)),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "viz without matplotlib" in proc.stdout


def test_plot_network_writes_png(tmp_path):
    (jn, jgt), (tn, tgt) = _solved_net("j"), _solved_net("t")
    for a, b in zip(j_np._tree_layout(jn), t_np._tree_layout(tn)):
        np.testing.assert_array_equal(b, a)
    p = str(tmp_path / "net.png")
    fig = t_np.plot_network(tn, node_values=torch.as_tensor(tgt.pressure),
                            edge_values=tgt.flow, title="test", path=p)
    _big(p)
    assert len(fig.axes) >= 1


def test_result_dashboards(tmp_path):
    net, gt = _solved_net("t", 1)
    parts = _partitions(net)
    tviz.plot_terminating_pressure_distribution(
        net, gt.pressure, parts, path=str(tmp_path / "tp.png"))
    tviz.plot_flow_per_compartment(net, gt.flow, parts,
                                   path=str(tmp_path / "flow.png"))
    tviz.plot_tp_vs_path_length(net, gt.pressure, parts,
                                path=str(tmp_path / "tppl.png"))
    tviz.plot_root_pressure_over_time(
        torch.as_tensor(np.stack([gt.pressure, gt.pressure * 0.98])), [0],
        path=str(tmp_path / "root.png"))
    for name in ("tp.png", "flow.png", "tppl.png", "root.png"):
        _big(str(tmp_path / name))


def test_helpers():
    from arterynetwork_tpu_torch.viz._mpl import pyplot

    plt = pyplot()
    data = np.random.default_rng(0).random(40) * 7.0 - 2.0
    for kw in ({}, {"max_value": 3.0}):
        np.testing.assert_array_equal(tviz.generate_colormap(data, **kw),
                                      jviz.generate_colormap(data, **kw))
    cm = tviz.generate_colormap(np.linspace(0, 1, 16))
    assert cm.shape == (16, 4) and (cm >= 0).all() and (cm <= 1).all()
    x, y = np.arange(100), np.arange(100) ** 2
    stats = []
    for mod in (tviz, jviz):
        fig, ax = plt.subplots()
        stats.append(mod.line_plot_binned(x, y, ax, bins=8,
                                          statistic="median"))
        plt.close(fig)
    np.testing.assert_array_equal(stats[0], stats[1])
    assert np.isfinite(stats[0]).all()
    fig, ax = plt.subplots()
    tviz.box_plot_whiskers([np.random.default_rng(0).random(20)
                            for _ in range(3)], ax, xlabel="a", ylabel="b")
    assert len(ax.get_lines()) > 0 and ax.get_xlabel() == "a"
    plt.close("all")


def test_skeleton_overlay(tmp_path):
    segs = [[(i, 10, 10) for i in range(12)],
            [(11, 10, 10), (12, 11, 11), (13, 12, 12)]]
    values = {v: float(v[0]) for s in segs for v in s}
    p = str(tmp_path / "overlay.png")
    t_np.plot_skeleton_overlay(segs, values, value_name="pressure", path=p)
    _big(p)


# ----------------------------------------------------------------------
# study-plot suite
# ----------------------------------------------------------------------
def _partitioned_voxel_net(pkg):
    """tests/test_viz.py::_partitioned_voxel_net, built by ``pkg``'s own
    modules (networkx graphs for the JAX package, graphs/voxel_graph's
    for the port)."""
    if pkg == "j":
        from arterynetwork_tpu.graphs.branch_attrs import \
            calculate_branch_info
        from arterynetwork_tpu.graphs.partitioning import \
            partition_compartments
        from arterynetwork_tpu.graphs.traversal import partition_bfs
        from arterynetwork_tpu.morpho.curvature import calculate_curvature
        from arterynetwork_tpu.morpho.metrics import calculate_property
    else:
        from arterynetwork_tpu_torch.graphs.branch_attrs import \
            calculate_branch_info
        from arterynetwork_tpu_torch.graphs.partitioning import \
            partition_compartments
        from arterynetwork_tpu_torch.graphs.traversal import partition_bfs
        from arterynetwork_tpu_torch.morpho.curvature import \
            calculate_curvature
        from arterynetwork_tpu_torch.morpho.metrics import \
            calculate_property

    def chain(start, step, n):
        return [(start[0] + step[0] * i, start[1] + step[1] * i,
                 start[2] + step[2] * i) for i in range(n)]

    trunk = chain((10, 20, 4), (0, 0, 1), 8)
    j1 = trunk[-1]
    left = [j1] + chain((10, 21, 12), (0, 1, 1), 7)
    right = [j1] + chain((10, 19, 12), (0, -1, 1), 7)
    j2 = left[-1]
    l1 = [j2] + chain((10, 28, 20), (1, 1, 1), 6)
    l2 = [j2] + chain((10, 28, 20), (-1, 1, 1), 6)
    segments = [trunk, left, right, l1, l2]
    dt = np.full((40, 40, 40), 2.0, np.float32)
    G = calculate_branch_info(segments, segments, distance_transform=dt)
    chosen = {"LMCA": {"initial_voxels": [left[1]]},
              "RMCA": {"initial_voxels": [right[1]]}}
    partition_bfs(G, [trunk[0]], [])
    partition_info = partition_compartments(G, segments, chosen)
    node_info, seg_info = calculate_property(G, segments, min_nodes=3)
    parts_curv = {
        name: {"initial_voxels": chosen[name]["initial_voxels"],
               "boundary_voxels": [],
               "visited_voxels": info["visited_voxels"],
               "segment_index_list": info["segment_index_list"]}
        for name, info in partition_info.items()}
    seg_info = calculate_curvature(G, seg_info, parts_curv,
                                   spacing_factor_mm=0.4)
    return G, segments, partition_info, node_info, seg_info


@pytest.fixture(scope="module")
def voxel_nets():
    return _partitioned_voxel_net("t"), _partitioned_voxel_net("j")


def test_statistics_per_partition(voxel_nets):
    (G, segs, pinfo, _, _), (Gj, segsj, pinfoj, _, _) = voxel_nets
    stats = tviz.statistics_per_partition(G, segs, pinfo)
    assert set(stats) == {"Overall", "LMCA", "RMCA"}
    assert stats["Overall"]["numBranches"] >= 4
    assert stats["LMCA"]["meanRadius"]["n"] > 0
    np.testing.assert_equal(stats, jviz.statistics_per_partition(
        Gj, segsj, pinfoj))
    stats2 = tviz.statistics_per_partition2(G, segs, pinfo)
    assert set(stats2) == {"PCA", "MCA", "ACA"}
    assert stats2["MCA"]["numBranches"] > 0
    np.testing.assert_equal(stats2, jviz.statistics_per_partition2(
        Gj, segsj, pinfoj))


def test_figure_suite_renders(tmp_path, voxel_nets):
    (_, _, _, node_info, seg_info), (_, _, _, node_j, seg_j) = voxel_nets
    for info, ref in ((seg_info, seg_j), (node_info, node_j)):
        for attr in ("pathLength", "depthLevel", "meanRadius", "depthVoxel",
                     "tortuosity", "cubicLawResult",
                     "meanCurvatureAveragedInmm"):
            for names in (None, t_sp.LEFT_RIGHT):
                assert t_sp._values_per_partition(info, attr, 0.25, names) \
                    == j_sp._values_per_partition(ref, attr, 0.25, names)
    for name in ("fig1", "fig2", "fig3", "fig4", "fig5", "fig6",
                 "fig11", "fig11b", "fig12", "fig13", "fig18"):
        p = str(tmp_path / f"{name}.png")
        getattr(tviz, name)(seg_info, node_info, path=p)
        _big(p)


def _gbm5_store(pkg, tmp_path, net, gt, parts):
    """run_longitudinal (f64, T = 3) and the saved GBMTest5 pickles."""
    if pkg == "j":
        from arterynetwork_tpu.flow.longitudinal import run_longitudinal
        from arterynetwork_tpu.io.artifacts import ArtifactStore
        kw = {"dtype": jnp.float64}
        save = jflow.save_gbm_test5_results
    else:
        from arterynetwork_tpu_torch.flow.longitudinal import \
            run_longitudinal
        from arterynetwork_tpu_torch.io.artifacts import ArtifactStore
        kw = {"dtype": torch.float64, "device": "cpu"}
        save = tflow.save_gbm_test5_results
    batch, sol = run_longitudinal(net, gt.pressure, net.radius * 0.9,
                                  num_timesteps=3, partitions=parts, **kw)
    store = ArtifactStore(str(tmp_path / pkg))
    save(store, net, batch, sol)
    return store


@pytest.fixture(scope="module")
def gbm5_stores(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gbm5")
    out = {}
    for pkg in ("t", "j"):
        net, gt = _solved_net(pkg, 2)
        out[pkg] = (net, _partitions(net),
                    _gbm5_store(pkg, tmp, net, gt, _partitions(net)))
    return out


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def test_show_result_gbm_test5(tmp_path, gbm5_stores):
    (net, parts, store), (jnet, jparts, jstore) = (gbm5_stores["t"],
                                                   gbm5_stores["j"])
    out = tviz.show_result_gbm_test5(store, net, num_timesteps=3,
                                     partitions=parts, out_dir=str(tmp_path))
    ref = jviz.show_result_gbm_test5(jstore, jnet, num_timesteps=3,
                                     partitions=jparts)
    assert out.keys() == ref.keys()
    np.testing.assert_array_equal(out["terminating_nodes"],
                                  ref["terminating_nodes"])
    for k in ("terminating_pressures_mmhg", "flow"):
        assert out[k].shape == ref[k].shape
        assert _rel(out[k], ref[k]) <= GBM_REL
    assert out["terminating_pressures_mmhg"].shape[1] == 3
    assert np.isfinite(out["terminating_pressures_mmhg"]).all()
    assert len(out["figures"]) == len(ref["figures"]) == 5
    for t in range(3):
        _big(str(tmp_path / f"gbm5_network_t{t}.png"))
    for o in (1, 2):
        _big(str(tmp_path / f"gbm5_tp_option{o}.png"))


def test_show_result2_gbm_test5(tmp_path, gbm5_stores):
    (net, _, store), (jnet, _, jstore) = (gbm5_stores["t"],
                                          gbm5_stores["j"])
    out = tviz.show_result2_gbm_test5(store, net, timesteps=(0, 2),
                                      out_dir=str(tmp_path))
    ref = jviz.show_result2_gbm_test5(jstore, jnet, timesteps=(0, 2))
    assert out["timesteps"] == ref["timesteps"] == [0, 2]
    for k in ("node_range_mmhg", "edge_range_cm3s"):
        np.testing.assert_allclose(out[k], ref[k], rtol=GBM_REL, atol=0)
    lo, hi = out["node_range_mmhg"]
    assert np.isfinite([lo, hi]).all() and lo <= hi
    for t in (0, 2):
        _big(str(tmp_path / f"gbm5_compare_t{t}.png"))
    _big(str(tmp_path / "gbm5_compare_legend.png"))
    assert all(len(f.axes) == 1 for f in out["figures"][:2])


def test_graph_plot_per_partition_variants(tmp_path, voxel_nets):
    G, segs, pinfo, node_info, seg_info = voxel_nets[0]
    p1 = str(tmp_path / "per_part.png")
    f1 = tviz.graph_plot_per_partition(G, segs, seg_info, node_info, pinfo,
                                       path=p1)
    _big(p1)
    assert len(f1.axes) == len(pinfo)
    p2 = str(tmp_path / "per_part_shared.png")
    f2 = tviz.graph_plot_per_partition(G, segs, seg_info, node_info, pinfo,
                                       shared_colorbar=True, path=p2)
    _big(p2)
    assert len(f2.axes) == len(pinfo) + 2
    p3 = str(tmp_path / "per_part2.png")
    f3 = tviz.graph_plot_per_partition2(G, segs, seg_info, node_info, pinfo,
                                        path=p3)
    _big(p3)
    assert len(f3.axes) == len(pinfo) + 2


def test_load_basic_files_bundle(tmp_path, voxel_nets):
    """The bundle the morphology figures read, written and loaded by the
    port as by the JAX package: the same keys and contents."""
    from arterynetwork_tpu.graphs.partitioning import save_partition as j_sp_
    from arterynetwork_tpu.io.artifacts import ArtifactStore as JStore
    from arterynetwork_tpu.io.artifacts import load_basic_files as j_load
    from arterynetwork_tpu_torch.graphs.partitioning import save_partition
    from arterynetwork_tpu_torch.io.artifacts import (ArtifactStore,
                                                      load_basic_files)

    outs = []
    chosen = {"LMCA": {"initial_voxels": [(10, 21, 13)]},
              "RMCA": {"initial_voxels": [(10, 19, 13)]}}
    for (G, segs, pinfo, node_info, seg_info), Store, save, load, d in (
            (voxel_nets[0], ArtifactStore, save_partition, load_basic_files,
             "t"),
            (voxel_nets[1], JStore, j_sp_, j_load, "j")):
        store = Store(str(tmp_path / d))
        with pytest.raises(FileNotFoundError):
            load(store)
        save(store, chosen, pinfo, G)
        store.save_segment_list("segmentListCleaned.npz", segs)
        store.save_pickle("segmentInfoDict.pkl", seg_info)
        store.save_pickle("nodeInfoDict.pkl", node_info)
        outs.append(load(store))
    out, ref = outs
    assert set(out) == set(ref) == {
        "G", "segmentList", "segmentInfoDict", "nodeInfoDict",
        "chosenVoxels", "partitionInfo", "resultADANDict"}
    assert out["resultADANDict"] == {}
    assert list(out["G"].nodes()) == list(ref["G"].nodes())
    assert out["segmentList"] == ref["segmentList"]
    for k in ("segmentInfoDict", "nodeInfoDict", "chosenVoxels",
              "partitionInfo"):
        np.testing.assert_equal(out[k], ref[k])


def test_show_volume_per_partition(tmp_path):
    res = []
    for pkg, flow in (("t", tflow), ("j", jflow)):
        net, _ = _solved_net(pkg, seed=4)
        radius_end = net.radius.copy()
        radius_end[:4] *= 0.8
        res.append(flow.gbm_test5b(net, radius_end, excluded_edges=(),
                                   num_timesteps=3,
                                   partitions=_partitions(net)))
    np.testing.assert_equal(res[0]["volume_per_partition"],
                            res[1]["volume_per_partition"])
    p = str(tmp_path / "vols.png")
    fig = tviz.show_volume_per_partition(res[0], path=p)
    _big(p)
    named = {"LMCA": 1.0, "LPCA": 2.0, "RMCA": 1.5, "RPCA": 2.5}
    res_cow = {"volume_per_partition": [
        {k: v * (1.0 + 0.1 * t) for k, v in named.items()}
        for t in range(3)]}
    figs = [mod.show_volume_per_partition(res_cow) for mod in (tviz, jviz)]
    lines = [[(ln.get_label(), ln.get_ydata().tolist())
              for ln in f.axes[0].get_lines()] for f in figs]
    assert lines[0] == lines[1]
    assert {"Left", "Right"} <= {label for label, _ in lines[0]}


def test_draw_segments_greedy_coloring(tmp_path):
    j = (5, 5, 5)
    segs = [[(5, 5, 0), (5, 5, 2), j],
            [j, (3, 7, 7), (2, 8, 8)],
            [j, (7, 7, 7), (8, 8, 8)],
            [(8, 8, 8), (9, 9, 9)],
            [(2, 8, 8), (1, 9, 9), (8, 8, 8)]]
    p = str(tmp_path / "segs.png")
    fig, codes = t_np.draw_segments(segs, shape=(10, 10, 10), path=p)
    assert os.path.exists(p)
    assert len(set(codes[:3])) == 3
    assert codes == j_np.draw_segments(segs, shape=(10, 10, 10))[1]


def test_show_terminating_pressure_and_path_length(tmp_path):
    net, gt = _solved_net("t")
    p = str(tmp_path / "tp_pl.png")
    fig = t_np.show_terminating_pressure_and_path_length(
        net, torch.as_tensor(gt.pressure), path=p)
    _big(p)
    ref = j_np.show_terminating_pressure_and_path_length(
        *_solved_net("j")[0:1], _solved_net("j")[1].pressure)
    a, b = fig.axes[0].get_lines()[0], ref.axes[0].get_lines()[0]
    np.testing.assert_array_equal(a.get_xdata(), b.get_xdata())
    np.testing.assert_array_equal(a.get_ydata(), b.get_ydata())


def test_plot_terminating_pressures_timesteps_all_options(tmp_path):
    from arterynetwork_tpu_torch.constants import PASCAL_PER_MMHG

    net, gt = _solved_net("t", 2)
    parts = _partitions(net)
    term = [int(n) for n in net.terminal_nodes()]
    T = 4
    base = np.asarray(gt.pressure)[term] / PASCAL_PER_MMHG
    tp_array = base[:, None] * np.linspace(1.0, 0.95, T)[None, :]
    for option in (1, 2, 3):
        p = str(tmp_path / f"tp2_opt{option}.png")
        tviz.plot_terminating_pressures_timesteps(
            net, term, torch.as_tensor(tp_array), parts, option=option,
            path=p)
        _big(p)


def _chain_net(pkg):
    FlowNetwork = (jgraphs if pkg == "j" else tgraphs).FlowNetwork
    coords = np.array([[0, 0, 0], [0, 0, 4], [0, 4, 4]], np.int32)
    return FlowNetwork(
        heads=np.array([0, 1], np.int32), tails=np.array([1, 2], np.int32),
        node_depth=np.array([0, 1, 2], np.int32),
        radius=np.ones(2), length=np.array([4.0, 4.0]),
        c=np.ones(2), k=np.full(2, 1.852),
        entry_nodes=np.array([0], np.int32), node_coord=coords,
        edge_segment_index=np.array([0, 1], np.int32))


def test_pressure_velocity_arrays_interpolation_and_orientation():
    segments = [
        [(0, 0, 0), (0, 0, 1), (0, 0, 2), (0, 0, 3), (0, 0, 4)],
        [(0, 4, 4), (0, 3, 4), (0, 2, 4), (0, 1, 4), (0, 0, 4)],  # reversed
        [(1, 0, 0), (1, 0, 2), (1, 3, 4)],   # first voxel on neither node
    ]
    pressure = np.array([100.0, 80.0, 60.0])
    velocity = np.array([0.5, -0.25])
    parr, varr = tviz.pressure_velocity_arrays(
        segments, [0, 1, 2], _chain_net("t"), torch.as_tensor(pressure),
        torch.as_tensor(velocity))
    rp, rv = jviz.pressure_velocity_arrays(segments, [0, 1, 2],
                                           _chain_net("j"), pressure,
                                           velocity)
    np.testing.assert_array_equal(parr, rp)
    np.testing.assert_array_equal(varr, rv)
    assert parr.shape == (10, 4) and varr.shape == (10, 4)
    np.testing.assert_allclose(parr[:5, 3], np.linspace(100, 80, 5))
    np.testing.assert_allclose(parr[5:, 3], np.linspace(60, 80, 5))
    np.testing.assert_allclose(varr[:5, 3], 0.5)
    np.testing.assert_allclose(varr[5:, 3], 0.25)
    np.testing.assert_array_equal(parr[5, :3], [0, 4, 4])
    # a segment whose first voxel sits on neither endpoint node: oriented
    # by the nearer endpoint
    net = _chain_net("t")
    net.edge_segment_index = np.array([2, 1], np.int32)
    net_j = _chain_net("j")
    net_j.edge_segment_index = np.array([2, 1], np.int32)
    out = tviz.pressure_velocity_arrays(segments, [2], net, pressure,
                                        velocity)
    ref = jviz.pressure_velocity_arrays(segments, [2], net_j, pressure,
                                        velocity)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)


def test_pressure_velocity_volumes_scatter_and_accumulate():
    parr = np.array([[0, 0, 0, 10.0], [1, 2, 3, 20.0]])
    varr = np.array([[0, 0, 0, 0.5], [1, 2, 3, 0.25]])
    pv, vv = tviz.pressure_velocity_volumes((4, 4, 4), torch.as_tensor(parr),
                                            varr)
    rp, rv = jviz.pressure_velocity_volumes((4, 4, 4), parr, varr)
    np.testing.assert_array_equal(pv, rp)
    np.testing.assert_array_equal(vv, rv)
    assert pv.dtype == rp.dtype == np.float32
    assert pv[0, 0, 0] == 10.0 and pv[1, 2, 3] == 20.0
    assert pv.sum() == 30.0
    pv2, _ = tviz.pressure_velocity_volumes(
        (4, 4, 4), np.array([[0, 0, 0, 99.0]]), np.zeros((0, 4)),
        out=(pv, vv))
    assert pv2[0, 0, 0] == 99.0 and pv2[1, 2, 3] == 20.0
    with pytest.raises(ValueError):
        tviz.pressure_velocity_volumes((3, 4, 4), parr, varr, out=(pv, vv))


def test_plot_radius_vs_graph_level(tmp_path):
    net, _ = _solved_net("t", 4)
    p = str(tmp_path / "bfstest.png")
    tviz.plot_radius_vs_graph_level(net, _partitions(net), path=p)
    _big(p)
