"""The port's EDT-and-thinning layer (csrc/skeleton_layer.cpp through
ops/native) against its oracles, on the CPU.

The oracles are the passes the pipeline ran before the layer: the numpy
bounding box (``_numpy_box``, its code), a numpy crop, ``edt3d_sq_masked``
and ``thin_volume`` (built from native/ into the same library),
``np.sqrt`` and a full-frame ``np.zeros`` with the box scattered in.
Every array the layer hands on (``box``, ``dt``, the box skeleton and
the full-frame skeleton) is held to them bit for bit, on the threaded
and the serial route, for masks made by the benchmark's phantom
(``benchmark/frozen/phantom``): whole trees, trees with a rough surface
like the hysteresis's, a tree cut by the frame (the margin clipped, so
foreground lies on the box's faces), an empty mask, one voxel, and a
blob deeper than ``r_max`` (the EDT falls back to the full transform).
The layer's counters are read against them too.  Then ``run_pipeline``:
its spans, and the fault of ``benchmark/faults.thinning_stops_early``
planted under it.
"""

import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import scipy.ndimage as ndi
from torch.profiler import ProfilerActivity, profile

from arterynetwork_tpu_torch.config import PipelineConfig
from arterynetwork_tpu_torch.ops import native
from arterynetwork_tpu_torch.pipeline import run_pipeline
from arterynetwork_tpu_torch.utils.phantoms import (phantom_raw_volume,
                                                    vascular_tree_phantom)
from arterynetwork_tpu_torch.utils.profiling import PREFIX

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

import faults  # noqa: E402
import harness  # noqa: E402
from frozen.phantom import grow_tree, rasterise  # noqa: E402

U8 = ctypes.POINTER(ctypes.c_uint8)
F32 = ctypes.POINTER(ctypes.c_float)


def _numpy_box(mask, margin=2):
    """The bounding box as the pipeline took it before the layer."""
    def _sl(profile, axis):
        nz = np.nonzero(profile)[0]
        return slice(max(int(nz[0]) - margin, 0),
                     min(int(nz[-1]) + margin + 1, mask.shape[axis]))

    proj_zy = mask.any(axis=2)
    if not proj_zy.any():
        return tuple(slice(0, 1) for _ in mask.shape)
    return (_sl(proj_zy.any(axis=1), 0), _sl(proj_zy.any(axis=0), 1),
            _sl(mask.any(axis=(0, 1)), 2))


def _oracle(mask, preserve_endpoints, r_max=16):
    """box, squared distances, dt, box skeleton, full-frame skeleton and
    thin_volume's deletions, by the passes before the layer."""
    lib = native.get_lib()
    box = _numpy_box(mask)
    mb = np.array(mask[box], dtype=np.uint8, order="C")
    d2 = np.empty(mb.shape, np.float32)
    if lib.edt3d_sq_masked(mb.ctypes.data_as(U8), *mb.shape, r_max,
                           d2.ctypes.data_as(F32)):
        d2 = native.edt_native(mb, squared=True)
    d2_in = d2.copy()
    deleted = lib.thin_volume(mb.ctypes.data_as(U8), *mb.shape,
                              d2.ctypes.data_as(F32),
                              int(preserve_endpoints))
    dt = np.sqrt(d2, out=d2)
    full = np.zeros(mask.shape, bool)
    full[box] = mb
    return box, d2_in, dt, mb, full, deleted


def _layer(mask, preserve_endpoints, r_max=16):
    """The same arrays by the layer, as run_pipeline runs it."""
    box = native.bounding_box(mask, margin=2)
    mb = native.crop_box(mask, box)
    rows = np.empty(mb.shape[:2], np.uint8)
    d2 = native.edt_masked_native(mb, r_max=r_max, squared=True, rows=rows)
    d2_in = d2.copy()
    sk = native.skeletonize_native_cropped(
        mb, d2, preserve_endpoints=preserve_endpoints, clobber=True)
    assert sk is mb
    dt = native.sqrt_rows(d2, rows)
    return box, d2_in, dt, sk, native.skeleton_frame(sk, box, mask.shape)


def _tree(shape, n_branches, seed, root_radius=4.0,
          branch_length=(12, 30)):
    rng = np.random.default_rng([seed])
    lines, radii, _ = grow_tree(shape, n_branches=n_branches,
                                root_radius=root_radius,
                                branch_length=branch_length, rng=rng)
    return rasterise(shape, lines, radii, "cpu").numpy()


def _rough(mask, seed):
    """A noisy surface as the hysteresis leaves one: a random part of
    the one-voxel shell around the mask added, a random part of its own
    surface taken away."""
    rng = np.random.default_rng([seed, 9])
    shell = ndi.binary_dilation(mask) & ~mask
    surface = mask & ~ndi.binary_erosion(mask)
    return ((mask & ~(surface & (rng.random(mask.shape) < 0.15)))
            | (shell & (rng.random(mask.shape) < 0.35)))


def _masks():
    small = (56, 64, 48)
    tree = _tree(small, 30, 1)
    # rolled round the frame: foreground on every face of the frame, so
    # on the box's too
    cut = np.ascontiguousarray(np.roll(_tree(small, 30, 2), (20, -24, 17),
                                       (0, 1, 2)))
    one = np.zeros(small, bool)
    one[30, 20, 11] = True
    zz, yy, xx = np.ogrid[:64, :64, :64]
    blob = (zz - 32) ** 2 + (yy - 30) ** 2 + (xx - 33) ** 2 <= 21 ** 2
    # its box (1.4 M voxels) is past the threaded route's threshold
    big = _tree((168, 168, 80), 80, 3, root_radius=5.0,
                branch_length=(25, 70))
    return {
        "tree": tree.astype(np.uint8),
        "rough_tree": _rough(tree, 1).astype(np.uint8),
        "cut_by_the_frame": cut,
        "empty": np.zeros(small, np.uint8),
        "one_voxel": one,
        "deep_blob": blob.astype(np.uint8),
        "rough_big_tree": _rough(big, 3).astype(np.uint8),
    }


MASKS = _masks()


@pytest.fixture(params=["threaded", "serial"])
def route(request, monkeypatch):
    monkeypatch.setattr(native, "_THREADED_VOXELS",
                        0 if request.param == "threaded" else 1 << 62)
    return request.param


@pytest.mark.parametrize("preserve_endpoints", [True, False])
@pytest.mark.parametrize("name", list(MASKS))
def test_layer_equals_its_oracles(name, preserve_endpoints, route):
    mask = MASKS[name]
    box, d2, dt, sk, full, deleted = _oracle(mask, preserve_endpoints)
    native.reset_layer_counts()
    got = _layer(mask, preserve_endpoints)
    assert got[0] == box
    for want, have in zip((d2, dt, sk, full), got[1:]):
        assert have.dtype == want.dtype and have.shape == want.shape
        assert have.flags["C_CONTIGUOUS"]
        assert np.array_equal(have, want)
    counts = dict(native.LAYER_COUNTS)
    assert counts["deletions"] == deleted
    assert counts["simple_tests"] >= deleted
    assert counts["edt_fallbacks"] == (name == "deep_blob")
    # box, crop, EDT, thinning, sqrt, frame
    assert counts["calls"] == 6
    assert counts["threaded"] == (6 if route == "threaded" else 0)


def test_the_cut_mask_puts_foreground_on_the_box_faces():
    mask = MASKS["cut_by_the_frame"]
    box = native.bounding_box(mask)
    assert box == tuple(slice(0, n) for n in mask.shape)
    for axis in range(3):
        assert np.take(mask, 0, axis).any() and np.take(mask, -1, axis).any()


def test_the_route_follows_the_voxel_count():
    """No patch: each pass takes the threaded route from
    ``_THREADED_VOXELS`` voxels of what it scans, the frame for the box
    search and the frame skeleton, the box for the crop, the EDT, the
    thinning and the roots; the masks reach both sides."""
    limit = native._THREADED_VOXELS
    seen = set()
    for name, mask in MASKS.items():
        box_voxels = native.crop_box(mask, native.bounding_box(
            mask, margin=2)).size
        native.reset_layer_counts()
        _layer(mask, True)
        want = 2 * (mask.size >= limit) + 4 * (box_voxels >= limit)
        assert native.LAYER_COUNTS["threaded"] == want, name
        seen.add(want)
    assert {0, 6} <= seen


def test_deeper_than_the_level_byte():
    """A ball of radius 40 (the EDT's full transform): admission levels
    past the voxel byte's cap are read from the distances, as
    thin_volume reads them."""
    zz, yy, xx = np.ogrid[:90, :90, :90]
    ball = ((zz - 45) ** 2 + (yy - 44) ** 2 + (xx - 46) ** 2
            <= 40 ** 2).astype(np.uint8)
    for pe in (True, False):
        want = _oracle(ball, pe)
        got = _layer(ball, pe)
        assert float(got[1].max()) > 32 ** 2
        assert np.array_equal(got[4], want[4])


def test_distance_orders_of_other_callers():
    """skeletonize_native: squares of a shared float EDT (not whole
    numbers), and no distance order at all."""
    lib = native.get_lib()
    mask = MASKS["rough_tree"] != 0
    dt = ndi.distance_transform_edt(mask).astype(np.float32)
    box = _numpy_box(mask)
    for d2 in (np.ascontiguousarray(dt[box] ** 2, dtype=np.float32), None):
        for pe in (True, False):
            vol = np.ascontiguousarray(mask[box], dtype=np.uint8)
            lib.thin_volume(vol.ctypes.data_as(U8), *vol.shape,
                            F32() if d2 is None else
                            d2.ctypes.data_as(F32), int(pe))
            want = np.zeros(mask.shape, bool)
            want[box] = vol
            got = native.skeletonize_native(
                mask, distance_ordered=d2 is not None,
                preserve_endpoints=pe,
                distance_transform=dt if d2 is not None else None)
            assert np.array_equal(got, want)


def test_nonzero_bytes_are_foreground():
    mask = MASKS["rough_tree"]
    box = native.bounding_box(mask)
    d2 = native.edt_masked_native(native.crop_box(mask, box), squared=True)
    ones = native.crop_box(mask, box)
    high = ones * np.uint8(255)
    native.skeletonize_native_cropped(ones, d2, clobber=True)
    native.skeletonize_native_cropped(high, d2, clobber=True)
    assert np.array_equal(ones, high)


def test_other_dtypes_and_views_are_searched_as_nonzero():
    mask = MASKS["rough_tree"]
    box = native.bounding_box(mask)
    assert box == _numpy_box(mask, margin=1)
    wide = np.zeros(mask.shape[:2] + (2 * mask.shape[2],), np.uint8)
    wide[..., ::2] = mask
    for other in (mask.astype(np.float32) * 0.5, wide[..., ::2],
                  np.asfortranarray(mask), mask.astype(np.int64)):
        assert native.bounding_box(other) == box
        assert np.array_equal(native.crop_box(other, box),
                              np.array(mask[box], np.uint8))
    assert native.bounding_box(np.zeros((4, 5, 6), bool)) == (
        slice(0, 1),) * 3
    with pytest.raises(ValueError):
        native.bounding_box(np.ones((4, 5), bool))


def test_the_layer_table_is_the_oracles():
    """The layer's own simple-point generator (skeleton_layer.cpp) makes,
    byte for byte, the table native/thinning.cpp makes: each generated
    afresh into a file of its own, in a process that loaded neither."""
    native.get_lib()
    with tempfile.TemporaryDirectory() as tmp:
        code = (
            "import ctypes, sys\n"
            "lib = ctypes.CDLL(sys.argv[1])\n"
            "for name, path in (('ensure_simple_lut', sys.argv[2]),\n"
            "                   ('sl_ensure_simple_lut', sys.argv[3])):\n"
            "    fn = getattr(lib, name)\n"
            "    fn.argtypes = [ctypes.c_char_p]\n"
            "    assert fn(path.encode()) == 2, name\n")
        paths = [os.path.join(tmp, n) for n in ("oracle.lut", "layer.lut")]
        subprocess.run([sys.executable, "-c", code, native._SO, *paths],
                       check=True, timeout=300)
        with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
            oracle, layer = a.read(), b.read()
    assert len(oracle) == (1 << 23) + 8
    assert layer == oracle


def test_a_frame_too_small_for_the_box_is_refused():
    skel = np.ones((4, 4, 4), np.uint8)
    box = (slice(2, 6), slice(0, 4), slice(0, 4))
    with pytest.raises(ValueError):
        native.skeleton_frame(skel, box, (5, 4, 4))
    assert native.skeleton_frame(skel, box, (6, 4, 4))[2:].all()


# --- run_pipeline ---------------------------------------------------------

def _config():
    cfg = PipelineConfig()
    cfg.vesselness.sigmas = (0.75, 1.0, 2.0, 3.0)
    cfg.vesselness.upload_format = "bq4"
    cfg.segmentation.global_threshold_fraction = 0.3
    cfg.segmentation.weak_threshold_fraction = 0.03
    cfg.segmentation.border_margin_voxels = 6
    cfg.segmentation.min_component_size = 50
    cfg.skeleton.backend = "native"
    cfg.skeleton.prune_min_length = 4
    cfg.flow.dtype = "float32"
    return cfg


@pytest.fixture(scope="module")
def raw():
    ph = vascular_tree_phantom((48, 64, 64), n_branches=12,
                               root_radius=3.0, branch_length=(12, 25),
                               seed=1)
    return phantom_raw_volume(ph)


def test_pipeline_spans_and_arrays(raw):
    cfg = _config()
    native.reset_layer_counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = run_pipeline(raw_volume=raw, config=cfg, device="cpu")
    assert native.LAYER_COUNTS["calls"] == 6
    spans = {n[len(PREFIX):]: (s, s + d)
             for n, dev, s, d in harness.profiler_events(prof)
             if not dev and n.startswith(PREFIX)}
    edt, skel, thin = spans["edt"], spans["skeletonization"], spans["thinning"]
    assert edt[1] <= skel[0]
    assert skel[0] <= thin[0] and thin[1] <= skel[1]
    t = out["timings"]
    assert t["thinning"] <= t["skeletonization"]
    # the skeleton the layer hands on is the oracle's
    want = _oracle(out["mask"], cfg.skeleton.preserve_endpoints)[4]
    assert np.array_equal(out["skeleton"], want)


def test_the_early_thinning_fault_still_reaches_the_skeleton(raw,
                                                              monkeypatch):
    cfg = _config()
    sound = run_pipeline(raw_volume=raw, config=cfg, device="cpu")
    faults.thinning_stops_early(monkeypatch.setattr)
    broken = run_pipeline(raw_volume=raw, config=cfg, device="cpu")
    assert np.array_equal(broken["mask"], sound["mask"])
    assert not np.array_equal(broken["skeleton"], sound["skeleton"])
    assert (broken["skeleton"] & ~sound["skeleton"]).any()
