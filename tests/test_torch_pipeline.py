"""End-to-end parity of the PyTorch port's ``run_pipeline`` with the JAX
package's, on the CPU, with the pipeline_512 (bench) configuration.

Raw phantoms: the tube of tests/test_pipeline.py and a small branching
tree.  Tolerances (values measured on a CPU in brackets):

  * masks agree on >= 99.9% of their union [identical];
  * where the masks are equal: identical segments, and pressures and
    flows within 1e-9 relative at f64 [0] and 1e-5 at f32 [flows 1.4e-7].

The seeded entry (``seed_mask``: variational region growing in place of
the threshold mask) is held to the JAX package on tests/test_pipeline.py's
Y phantom: the same mask and segments, pressures and flows to 1e-9 at
f64.  ``flow.graph_path="nx"`` equals the soa route.  A last test runs
the port in a fresh interpreter in which ``jax``, ``networkx`` and
``matplotlib`` cannot be imported, as on a machine without them.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from arterynetwork_tpu.config import PipelineConfig
from arterynetwork_tpu.pipeline import run_pipeline as jax_run_pipeline
from arterynetwork_tpu.utils.phantoms import (phantom_raw_volume,
                                              vascular_tree_phantom)
from arterynetwork_tpu_torch import convert
from arterynetwork_tpu_torch.pipeline import run_pipeline
from arterynetwork_tpu_torch.utils.profiling import PORT_SPANS

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _raw(kind):
    if kind == "tube":   # tests/test_pipeline.py::test_pipeline_from_raw_volume
        shape = (40, 40, 56)
        rng = np.random.default_rng(2)
        raw = rng.normal(100.0, 3.0, shape).astype(np.float32)
        x, y = np.mgrid[: shape[0], : shape[1]]
        tube = ((x - 20) ** 2 + (y - 20) ** 2 <= 3 ** 2)
        for z in range(6, 50):
            raw[:, :, z] += 120.0 * tube
        return raw
    ph = vascular_tree_phantom((48, 64, 64), n_branches=12, root_radius=3.0,
                               branch_length=(12, 25), seed=1)
    return phantom_raw_volume(ph)


def _bench_config(dtype, upload_format="bq4"):
    """bench.py::bench_pipeline_512's configuration (with "bq3",
    bench_speck_pipeline's)."""
    cfg = PipelineConfig()
    cfg.vesselness.sigmas = (0.75, 1.0, 2.0, 3.0)
    cfg.vesselness.upload_format = upload_format
    cfg.segmentation.global_threshold_fraction = 0.3
    cfg.segmentation.weak_threshold_fraction = 0.03
    cfg.segmentation.border_margin_voxels = 6
    cfg.segmentation.min_component_size = 50
    cfg.skeleton.backend = "native"
    cfg.skeleton.prune_min_length = 4
    cfg.flow.dtype = dtype
    cfg.flow.linear_solver = "auto"
    return cfg


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.mark.parametrize("kind,dtype,tol,wire", [
    pytest.param("tube", "float64", 1e-9, "bq4", id="tube-float64-1e-09"),
    pytest.param("tree", "float64", 1e-9, "bq4", id="tree-float64-1e-09"),
    pytest.param("tree", "float32", 1e-5, "bq4", id="tree-float32-1e-05"),
    # the Speck configuration's wire: x = 64 is 8-aligned, so bq3 runs
    pytest.param("tree", "float64", 1e-9, "bq3", id="tree-float64-1e-09-bq3"),
    pytest.param("tree", "float32", 1e-5, "bq3", id="tree-float32-1e-05-bq3")])
def test_run_pipeline_matches_jax(kind, dtype, tol, wire):
    raw = _raw(kind)
    if wire == "bq3":
        assert raw.shape[2] % 8 == 0
    cfg = _bench_config(dtype, wire)
    ref = jax_run_pipeline(raw_volume=raw, config=cfg)
    ref_mask = ref["mask"].copy()   # the JAX mask lives in reused scratch
    out = run_pipeline(raw_volume=raw, config=convert.pipeline_config(cfg),
                       device="cpu")

    assert set(out) == set(ref)
    # every JAX key, and besides only the port's documented spans
    assert set(ref["timings"]) <= set(out["timings"])
    assert set(out["timings"]) - set(ref["timings"]) <= PORT_SPANS
    union = np.count_nonzero(out["mask"] | ref_mask)
    agree = union - np.count_nonzero(out["mask"] != ref_mask)
    assert union > 500 and agree >= 0.999 * union
    if not np.array_equal(out["mask"], ref_mask):
        return
    assert [list(map(tuple, s)) for s in out["segments"]] == \
        [list(map(tuple, s)) for s in ref["segments"]]
    assert out["attrs"] == ref["attrs"]
    assert out["network"].num_edges == ref["network"].num_edges
    sol, rsol = out["solution"], ref["solution"]
    assert _rel(sol.pressure.numpy(), np.asarray(rsol.pressure)) <= tol
    assert _rel(sol.flow.numpy(), np.asarray(rsol.flow)) <= tol
    np.testing.assert_array_equal(out["network"].node_pressure,
                                  sol.pressure.numpy())


def test_graph_stage_full_frame_matches_jax():
    """graph_stage without a given distance transform computes the EDT
    itself (full frame, origin 0); with ``build_nx`` (the default) it
    also builds the JAX package's voxel graph."""
    from arterynetwork_tpu.pipeline import graph_stage as jax_graph_stage
    from arterynetwork_tpu.pipeline import compute_mask_edt, \
        skeletonize_stage
    from arterynetwork_tpu_torch.pipeline import graph_stage

    ph = vascular_tree_phantom((48, 64, 64), n_branches=12, root_radius=3.0,
                               branch_length=(12, 25), seed=1)
    mask = ph["mask"].astype(np.uint8)
    cfg = _bench_config("float64")
    skel = skeletonize_stage(mask, cfg,
                             distance_transform=compute_mask_edt(mask))
    _, ref_segs, ref_attrs = jax_graph_stage(skel, mask, cfg,
                                             build_nx=False)
    G, segs, attrs = graph_stage(skel, mask, convert.pipeline_config(cfg),
                                 build_nx=False)
    assert G is None and len(segs) >= 5
    assert [list(map(tuple, s)) for s in segs] == \
        [list(map(tuple, s)) for s in ref_segs]
    assert attrs == ref_attrs
    # build_nx defaults to True, as in the JAX package: the voxel graph
    ref_G = jax_graph_stage(skel, mask, cfg)[0]
    G = graph_stage(skel, mask, convert.pipeline_config(cfg))[0]
    assert list(G.nodes(data=True)) == list(ref_G.nodes(data=True))
    assert [(v, list(G.adj[v].items())) for v in G.nodes()] == \
        [(v, list(ref_G.adj[v].items())) for v in ref_G.nodes()]


def _y_phantom(shape=(48, 48, 64), noise=0.02, seed=0):
    """tests/test_pipeline.py's Y-shaped bright vessel."""
    rng = np.random.default_rng(seed)
    vol = rng.normal(0.05, noise, shape).astype(np.float32)
    tube = np.zeros(shape, bool)
    for z in range(8, 34):
        tube[21:28, 21:28, z] = True
    for i in range(20):
        a, b, z = 24 + i // 2, 24 - i // 2, 33 + i
        tube[a - 2:a + 3, a - 2:a + 3, z] = True
        tube[b - 2:b + 3, b - 2:b + 3, z] = True
    vol[tube] = 0.9 + 0.05 * rng.random(tube.sum()).astype(np.float32)
    return vol


def test_seeded_run_pipeline_matches_jax():
    """tests/test_pipeline.py::test_full_pipeline_on_phantom's setup."""
    vol = _y_phantom()
    seed = np.zeros(vol.shape, bool)
    seed[23:26, 23:26, 18:21] = True
    cfg = PipelineConfig()
    cfg.segmentation.max_segment_size = 50000
    cfg.skeleton.backend = "native"
    cfg.skeleton.prune_min_length = 4
    ref = jax_run_pipeline(vol, seed_mask=seed, config=cfg)
    ref_mask = np.array(ref["mask"])
    out = run_pipeline(vol, seed_mask=seed,
                       config=convert.pipeline_config(cfg), device="cpu")
    # every JAX key, and besides only the port's documented spans
    assert set(ref["timings"]) <= set(out["timings"])
    assert set(out["timings"]) - set(ref["timings"]) <= PORT_SPANS
    np.testing.assert_array_equal(out["mask"], ref_mask)
    assert out["mask"].sum() > 500
    assert [list(map(tuple, s)) for s in out["segments"]] == \
        [list(map(tuple, s)) for s in ref["segments"]]
    assert len(out["segments"]) >= 3
    sol, rsol = out["solution"], ref["solution"]
    assert _rel(sol.pressure.numpy(), np.asarray(rsol.pressure)) <= 1e-9
    assert _rel(sol.flow.numpy(), np.asarray(rsol.flow)) <= 1e-9


def test_unported_paths_raise():
    """``flow.graph_path="nx"`` (once unported, it raised) runs through
    the voxel graph and gives the soa route's network and solution."""
    raw = _raw("tube")
    cfg = convert.pipeline_config(_bench_config("float64"))
    soa = run_pipeline(raw_volume=raw, config=cfg, device="cpu")
    cfg.flow.graph_path = "nx"
    out = run_pipeline(raw_volume=raw, config=cfg, device="cpu")
    assert soa["graph"] is None and out["graph"] is not None
    assert out["segments"] == soa["segments"]
    assert out["network"].num_edges == soa["network"].num_edges >= 1
    assert _rel(out["solution"].pressure.numpy(),
                soa["solution"].pressure.numpy()) <= 1e-9


_WITHOUT_JAX = """
import sys
bundle_dir, out_dir = sys.argv[1], sys.argv[2]
for name in ("jax", "networkx", "matplotlib"):
    sys.modules[name] = None     # any import of these now fails
import numpy as np
import torch
torch.set_num_threads(1)
from arterynetwork_tpu_torch.config import PipelineConfig
from arterynetwork_tpu_torch.pipeline import run_pipeline

rng = np.random.default_rng(2)
raw = rng.normal(100.0, 3.0, (40, 40, 56)).astype(np.float32)
x, y = np.mgrid[:40, :40]
raw[:, :, 6:50] += 120.0 * ((x - 20) ** 2 + (y - 20) ** 2 <= 9)[..., None]
cfg = PipelineConfig()
cfg.vesselness.sigmas = (0.75, 1.0, 2.0, 3.0)
cfg.vesselness.upload_format = "bq4"
cfg.segmentation.global_threshold_fraction = 0.3
cfg.segmentation.weak_threshold_fraction = 0.03
cfg.segmentation.border_margin_voxels = 6
cfg.segmentation.min_component_size = 50
cfg.flow.dtype = "float32"
cfg.flow.linear_solver = "auto"
r = run_pipeline(raw_volume=raw, config=cfg, device="cpu")
assert r["mask"].sum() > 500 and len(r["segments"]) >= 1
assert torch.isfinite(r["solution"].pressure).all()

from arterynetwork_tpu_torch.ops import region_grow, region_grow_frontier
seed = np.zeros(raw.shape, bool)
seed[19:22, 19:22, 26:29] = True
cfg.segmentation.max_segment_size = 50000
s = run_pipeline(raw_volume=raw, seed_mask=seed, config=cfg, device="cpu")
assert s["mask"].sum() > 500 and len(s["segments"]) >= 1
assert torch.isfinite(s["solution"].pressure).all()
v = (raw - raw.min()) / np.ptp(raw)
grown = [region_grow(v, seed, backend=b, max_segment_size=50000,
                     device="cpu") for b in ("xla", "fused")]
grown.append(region_grow_frontier(v, seed, max_segment_size=50000,
                                  device="cpu"))
assert all(torch.equal(g.segmented_map, grown[0].segmented_map)
           for g in grown) and int(grown[0].segmented_count) > 500

# the voxel-graph route with the artifact store, its graphml read back
from arterynetwork_tpu_torch.io.artifacts import ArtifactStore
cfg.flow.graph_path = "nx"
store = ArtifactStore(out_dir)
n = run_pipeline(raw_volume=raw, config=cfg, store=store, device="cpu")
assert n["segments"] == r["segments"]
G = store.load_graphml("graphRepresentationCleanedWithEdgeInfo.graphml")
assert list(G.nodes()) == list(n["graph"].nodes())
assert [list(G.neighbors(v)) for v in G.nodes()] == \
    [list(n["graph"].neighbors(v)) for v in G.nodes()]

# a legacy bundle pickled by networkx, loaded and converted
from arterynetwork_tpu_torch.flow.network_setup import (convert_network,
                                                        load_network)
loaded = load_network(bundle_dir)
net, node_of = convert_network(loaded, root_coord=(0, 0, 0))
assert type(loaded["G"]).__module__.startswith("arterynetwork_tpu_torch")
assert net.num_edges == 3 and net.num_nodes == 4

# the morphology driver on the store
from arterynetwork_tpu_torch.__main__ import main
main(["morpho", out_dir, "--no-figures", "--device", "cpu"])
assert store.exists("segmentInfoDict.pkl")

assert not [m for m in sys.modules
            if m.split(".")[0] in ("jax", "networkx", "matplotlib",
                                   "arterynetwork_tpu")
            and sys.modules[m] is not None]
print("ran without jax")
"""


def test_port_runs_without_jax_or_networkx(tmp_path):
    """A fresh interpreter in which jax, networkx and matplotlib cannot be
    imported runs the port: both masks' pipelines, the growers, the
    voxel-graph route with the store, a legacy bundle that networkx
    pickled (here, in this process) and ``morpho --no-figures``."""
    import pickle

    import networkx as nx

    G = nx.Graph()
    segs = [[(0, 0, z) for z in range(4)],
            [(0, 0, 3), (0, 1, 4), (0, 2, 5)],
            [(0, 0, 3), (1, 0, 4), (2, 0, 5)]]
    for i, seg in enumerate(segs):
        for a, b in zip(seg[:-1], seg[1:]):
            G.add_edge(a, b, segmentIndex=i, meanRadius=2.0 - 0.5 * i,
                       pathLength=float(len(seg) - 1))
    for v in G.nodes():
        G.nodes[v]["depthLevel"] = 0 if v[2] <= 3 and v[:2] == (0, 0) \
            else 1
    G.nodes, G.adj                 # cached views in the pickle
    with open(tmp_path / "basicFilesForStructureWithCoW4(year=BraVa).pkl",
              "wb") as f:
        pickle.dump({"G": G, "segmentList": segs,
                     "segmentInfoDict": {0: {}, 1: {}, 2: {}}}, f)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _WITHOUT_JAX,
                           str(tmp_path), str(tmp_path / "store")],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "ran without jax" in proc.stdout
