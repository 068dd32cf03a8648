"""Device thinning of the PyTorch port against the JAX reference, on the
CPU, and the pipeline's ``skeleton.backend="jax"`` path.

Every comparison is exact.  The JAX package's ``skeletonize`` costs about
a minute to trace and compile per (shape, static arguments), so its test
shapes (tests/test_thinning.py: a straight tube, a narrower tube, a bent
tube, a bifurcation, a torus) and one random blob are packed into one
(40, 64, 96) volume, each shape's box at offsets of its own parity and
at least four background voxels from the next.  Thinning is local to a
voxel's 3x3x3 neighborhood and its distance to the background, so each
shape thins in the packed volume exactly as alone; the port thins each
shape alone and must equal JAX's packed result on that shape's box.  The
pipeline test uses the same shape, so JAX reuses the compiled program.

The LUT route (a 26-bit code per voxel and a table gather, the route on
a CUDA device) is held to the label-propagation route here with the
native library's table, and on the card (``gpu``) with the table built
there.  The JAX package is imported inside the tests that compare with
it, so the ``gpu`` tests also run on a machine without JAX:

    python -m pytest --noconftest -q tests/test_torch_thinning.py -m gpu
"""

import os

import numpy as np
import pytest
import torch

from arterynetwork_tpu_torch.ops import native
from arterynetwork_tpu_torch.ops import simple_point as tsp
from arterynetwork_tpu_torch.ops import thinning as tt
from arterynetwork_tpu_torch.utils.profiling import PORT_SPANS

torch.set_num_threads(1)

SHAPE = (40, 64, 96)


def _tube(radius, shape, z_range):
    x, y, z = np.mgrid[: shape[0], : shape[1], : shape[2]]
    c = shape[0] // 2
    return (((x - c) ** 2 + (y - c) ** 2 <= radius ** 2)
            & (z >= z_range[0]) & (z < z_range[1])).astype(np.uint8)


def _bent():
    vol = np.zeros((40, 40, 40), np.uint8)
    vol[18:23, 18:23, 5:22] = 1
    vol[18:23, 18:35, 17:22] = 1
    return vol


def _bifurcation():
    vol = np.zeros((40, 48, 48), np.uint8)
    vol[18:23, 22:27, 4:24] = 1
    vol[18:23, 10:15, 28:44] = 1
    vol[18:23, 34:39, 28:44] = 1
    for t in np.linspace(0, 1, 24):
        y = int(round(24 - 12 * t))
        z = int(round(22 + 8 * t))
        vol[18:23, y - 2:y + 3, z - 2:z + 3] = 1
        y = int(round(24 + 12 * t))
        vol[18:23, y - 2:y + 3, z - 2:z + 3] = 1
    return vol


def _torus():
    x, y, z = np.mgrid[:40, :40, :16]
    r = np.sqrt((x - 20) ** 2 + (y - 20) ** 2)
    return (((r - 10) ** 2 + (z - 8) ** 2) <= 3 ** 2).astype(np.uint8)


def _blob():
    rng = np.random.default_rng(7)
    vol = np.zeros((16, 16, 16), np.uint8)
    vol[2:14, 2:14, 2:14] = rng.random((12, 12, 12)) < 0.6
    return vol


# name -> (volume, its box, where the box goes in the packed volume)
SHAPES = {
    "tube": (_tube(4, (24, 24, 48), (4, 44)), (6, 6, 2), (0, 0, 0)),
    "tube_r3": (_tube(3, (24, 24, 40), (4, 36)), (7, 7, 2), (25, 17, 0)),
    "bent": (_bent(), (16, 16, 3), (0, 16, 47)),
    "bifurcation": (_bifurcation(), (16, 8, 2), (14, 0, 0)),
    "torus": (_torus(), (5, 5, 3), (9, 33, 71)),
    "blob": (_blob(), (0, 0, 0), (24, 0, 48)),
}


def _box(vol, start):
    """The shape's box: from ``start`` to 2 past its last voxel."""
    nz = np.argwhere(vol)
    stop = np.minimum(nz.max(axis=0) + 3, vol.shape)
    assert (nz.min(axis=0) - np.array(start) >= 2).all()
    return tuple(slice(a, b) for a, b in zip(start, stop))


def _packed():
    out = np.zeros(SHAPE, np.uint8)
    where = {}
    for name, (vol, start, dst) in SHAPES.items():
        box = _box(vol, start)
        assert all((d - s.start) % 2 == 0 for d, s in zip(dst, box))
        dbox = tuple(slice(d, d + s.stop - s.start) for d, s in zip(dst, box))
        assert not out[tuple(slice(max(s.start - 2, 0), s.stop + 2)
                             for s in dbox)].any()
        out[dbox] = vol[box]
        where[name] = (box, dbox)
    return out, where


@pytest.fixture(scope="module")
def packed():
    return _packed()


@pytest.fixture(scope="module", params=[True, False],
                ids=["endpoints", "no_endpoints"])
def jax_skeleton(request, packed):
    from arterynetwork_tpu.ops import thinning as jt

    vol, _ = packed
    pe = request.param
    ref = np.asarray(jt.skeletonize(vol, max_waves=64,
                                    preserve_endpoints=pe))
    return pe, ref


def test_packed_volume_matches_jax(packed, jax_skeleton):
    vol, _ = packed
    pe, ref = jax_skeleton
    out = tt.skeletonize(vol, preserve_endpoints=pe, device="cpu")
    assert out.dtype == torch.bool and tuple(out.shape) == SHAPE
    assert ref.sum() > 100
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("name", list(SHAPES))
def test_each_shape_alone_matches_jax(name, packed, jax_skeleton):
    _, where = packed
    pe, ref = jax_skeleton
    vol = SHAPES[name][0]
    box, dbox = where[name]
    out = tt.skeletonize(torch.from_numpy(vol), preserve_endpoints=pe)
    assert out.device.type == "cpu"
    np.testing.assert_array_equal(out.numpy()[box], ref[dbox])
    rest = out.numpy().copy()
    rest[box] = False
    assert not rest.any()


def test_simple_point_mask_and_neighbor_count_match_jax(packed):
    from arterynetwork_tpu.ops import thinning as jt

    rng = np.random.default_rng(3)
    vols = [packed[0][:24, :32, :40].astype(bool),
            rng.random((20, 22, 24)) < 0.6]
    for vol in vols:
        np.testing.assert_array_equal(
            tt.simple_point_mask(torch.from_numpy(vol)).numpy(),
            np.asarray(jt.simple_point_mask(vol)))
        np.testing.assert_array_equal(
            tt._fg_neighbor_count(torch.from_numpy(vol)).numpy(),
            np.asarray(jt._fg_neighbor_count(vol)))
    np.testing.assert_array_equal(tt._subfield_index((3, 4, 5)),
                                  jt._subfield_index((3, 4, 5)))


def _native_table():
    """The native library's simple-point table (its cache file: an 8-byte
    header, then the same 2^23 packed bytes)."""
    native.get_lib()
    with open(os.path.join(native._BUILD_DIR, "simple26.lut"), "rb") as f:
        return np.frombuffer(f.read()[8:], np.uint8)


@pytest.mark.parametrize("pe", [True, False])
def test_lut_route_matches_label_route(pe, packed, tmp_path, monkeypatch):
    """The LUT route on the CPU, with the native table in the cache."""
    np.save(tmp_path / tsp._CACHE_NAME, _native_table())
    monkeypatch.setattr(tsp, "_CACHE_DIR", str(tmp_path))
    tt._device_lut.cache_clear()
    vol = torch.from_numpy(packed[0])
    try:
        lut = tt.skeletonize(vol, preserve_endpoints=pe, predicate="lut")
    finally:
        tt._device_lut.cache_clear()
    labels = tt.skeletonize(vol, preserve_endpoints=pe, predicate="labels")
    assert labels.sum() > 100
    assert torch.equal(lut, labels)


def _pipeline_inputs():
    from arterynetwork_tpu_torch.utils.phantoms import (
        phantom_raw_volume, vascular_tree_phantom)

    ph = vascular_tree_phantom(SHAPE, n_branches=12, root_radius=3.0,
                               branch_length=(12, 25), seed=1)
    c = (np.array(SHAPE) - 1) / 2.0
    z, y, x = np.ogrid[:SHAPE[0], :SHAPE[1], :SHAPE[2]]
    brain = (((z - c[0]) / 19) ** 2 + ((y - c[1]) / 30) ** 2
             + ((x - c[2]) / 46) ** 2) <= 1.0
    return phantom_raw_volume(ph), brain


def test_run_pipeline_brain_tip_device_thinning_matches_jax():
    """run_pipeline with a brain mask, the tip extension and
    ``skeleton.backend="jax"``: the same mask, skeleton and segments as
    the JAX package, pressures and flows within 1e-9 (f64)."""
    from arterynetwork_tpu.config import PipelineConfig
    from arterynetwork_tpu.pipeline import run_pipeline as jax_run_pipeline
    from arterynetwork_tpu_torch import convert
    from arterynetwork_tpu_torch.pipeline import run_pipeline

    raw, brain = _pipeline_inputs()
    cfg = PipelineConfig()
    cfg.vesselness.sigmas = (0.75, 1.0, 2.0, 3.0)
    cfg.vesselness.upload_format = "bq4"
    cfg.segmentation.global_threshold_fraction = 0.3
    cfg.segmentation.weak_threshold_fraction = 0.03
    cfg.segmentation.border_margin_voxels = 2
    cfg.segmentation.min_component_size = 50
    cfg.segmentation.near_boundary_fraction = 0.2
    cfg.segmentation.boundary_distance_voxels = 4.0
    cfg.segmentation.tip_fraction = 0.01
    cfg.segmentation.tip_neighbor_max = 8
    cfg.skeleton.backend = "jax"
    cfg.skeleton.prune_min_length = 4
    cfg.flow.dtype = "float64"
    ref = jax_run_pipeline(raw_volume=raw, brain_mask=brain, config=cfg)
    ref_mask = np.array(ref["mask"])
    out = run_pipeline(raw_volume=raw, brain_mask=brain,
                       config=convert.pipeline_config(cfg), device="cpu")
    # every JAX key, and besides only the port's documented spans
    assert set(ref["timings"]) <= set(out["timings"])
    assert set(out["timings"]) - set(ref["timings"]) <= PORT_SPANS
    np.testing.assert_array_equal(out["mask"], ref_mask)
    assert out["mask"].sum() > 500
    np.testing.assert_array_equal(out["skeleton"],
                                  np.asarray(ref["skeleton"]))
    assert [list(map(tuple, s)) for s in out["segments"]] == \
        [list(map(tuple, s)) for s in ref["segments"]]
    assert len(out["segments"]) >= 3
    assert out["attrs"] == ref["attrs"]
    sol, rsol = out["solution"], ref["solution"]
    # the brain mask takes voxels out, the tip extension puts others in
    from arterynetwork_tpu_torch.pipeline import (generate_vessel_mask,
                                                  vesselness_stage)
    tcfg = convert.pipeline_config(cfg)
    v = vesselness_stage(raw, tcfg, device="cpu")
    with_tip = generate_vessel_mask(v, config=tcfg, device="cpu")
    tcfg.segmentation.tip_fraction = None
    neither = generate_vessel_mask(v, config=tcfg, device="cpu")
    brain_only = generate_vessel_mask(v, brain_mask=brain, config=tcfg,
                                      device="cpu")
    assert (neither & ~brain_only).any() and (out["mask"] & ~brain_only).any()
    assert (with_tip & ~neither).any()
    for a, b in ((sol.pressure, rsol.pressure), (sol.flow, rsol.flow)):
        b = np.asarray(b)
        assert np.max(np.abs(a.numpy() - b)) <= 1e-9 * np.max(np.abs(b))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the LUT route runs on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("pe", [True, False])
def test_lut_thinning_equals_plain_on_card(pe, packed, cuda):
    """On the card: the LUT route (the table built there) against the
    label-propagation route, on the packed shapes and the pipeline
    phantom's mask."""
    from arterynetwork_tpu_torch.utils.phantoms import vascular_tree_phantom

    ph = vascular_tree_phantom(SHAPE, n_branches=12, root_radius=3.0,
                               branch_length=(12, 25), seed=1)
    for vol in (packed[0], ph["mask"]):
        v = torch.from_numpy(np.asarray(vol)).to(cuda)
        lut = tt.skeletonize(v, preserve_endpoints=pe)
        plain = tt.skeletonize(v, preserve_endpoints=pe,
                               predicate="labels")
        assert lut.is_cuda and int(plain.sum()) > 20
        assert torch.equal(lut, plain)


@pytest.mark.gpu
def test_lut_built_on_card_equals_native(tmp_path, cuda):
    lut = tsp.build_simple_point_lut(cache_dir=str(tmp_path), device=cuda)
    np.testing.assert_array_equal(lut, _native_table())
