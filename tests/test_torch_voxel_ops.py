"""Voxel operators of the PyTorch port against the JAX reference, on the
CPU: the EDT, the brain and tip masks, simple points, connected
components, the whole-volume and chunked vesselness drivers, and the
distance-ordered native thinning without a given transform.

Tolerances (values measured on a CPU in brackets):

  * EDT (banded and exact, with and without sampling), masks, simple
    points, components, native thinning: exact (bit-equal);
  * the Hessian at one scale: |d| <= 5e-6 [2.1e-6], and one scale's
    response |d| <= 2e-4 [1.2e-5];
  * ``frangi_vesselness`` and ``frangi_vesselness_chunked`` against the
    JAX package's: |d| <= 2e-4 on interior z rows [7.6e-5] and on the two
    face rows [4.7e-7].  The smoothing sums taps in another order than
    JAX's banded matmuls, and voxels with a near-degenerate eigenpair
    amplify that through the f32 arccos;
  * the port's chunked driver against its whole-volume filter: interior z
    rows within K1's bound, |d| <= 1e-5 + 1e-4 |ref| [9e-8; the same
    bound the card's K1 is held to], face rows |d| <= 0.05 [0.032; the
    JAX package's two drivers differ by the same 0.032 there: the whole
    volume edge-replicates its smoothed field at a face, a slab sees the
    zero-padded tail].
"""

import importlib
import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from arterynetwork_tpu.config import PipelineConfig
from arterynetwork_tpu.ops import cc as jc
from arterynetwork_tpu.ops import simple_point as jsp
from arterynetwork_tpu.ops import stencil as jst
from arterynetwork_tpu.ops import vesselness as jv
from arterynetwork_tpu.pipeline import generate_vessel_mask as jax_mask
from arterynetwork_tpu_torch import convert
from arterynetwork_tpu_torch.ops import cc as tc
from arterynetwork_tpu_torch.ops import simple_point as tsp
from arterynetwork_tpu_torch.ops import stencil as tst
from arterynetwork_tpu_torch.ops import vesselness as tv
from arterynetwork_tpu_torch.ops.vesselness_fused import frangi_response_max_
from arterynetwork_tpu_torch.pipeline import generate_vessel_mask

# the packages' ops/__init__ export a function named edt
je = importlib.import_module("arterynetwork_tpu.ops.edt")
te = importlib.import_module("arterynetwork_tpu_torch.ops.edt")

torch.set_num_threads(1)


def _random_mask(shape, p, seed):
    rng = np.random.default_rng(seed)
    m = (rng.random(shape) < p).astype(np.uint8)
    m[4:-4, 5:-5, 3:-3] |= rng.random((shape[0] - 8, shape[1] - 10,
                                       shape[2] - 6)) < 0.97
    return m


# ---------------------------------------------------------------- EDT


@pytest.mark.parametrize("sampling", [None, (1.0, 0.7, 0.7)],
                         ids=["unit", "anisotropic"])
@pytest.mark.parametrize("band", [3, 12, None], ids=["b3", "b12", "exact"])
@pytest.mark.parametrize("shape,seed", [((24, 30, 36), 0), ((40, 33, 28), 1)])
def test_edt_bit_equal_to_jax(shape, seed, band, sampling):
    m = _random_mask(shape, 0.9, seed)
    ref = np.asarray(je.edt_squared(m, band=band, sampling=sampling))
    out = te.edt_squared(m, band=band, sampling=sampling, device="cpu")
    assert out.dtype == torch.float32 and ref.dtype == np.float32
    np.testing.assert_array_equal(out.numpy().view(np.uint32),
                                  ref.view(np.uint32))
    dist = te.edt(torch.from_numpy(m), band=band, sampling=sampling)
    np.testing.assert_array_equal(
        dist.numpy(), np.asarray(je.edt(m, band=band, sampling=sampling)))


def test_edt_exact_chunks_rows(monkeypatch):
    """Rows chunked into many small temporaries change no value."""
    m = _random_mask((20, 22, 70), 0.95, 2)
    ref = np.asarray(je.edt_squared(m, band=None))
    monkeypatch.setattr(te, "_TEMP_BYTES", 64 * 70 * 4 * 5)
    np.testing.assert_array_equal(
        te.edt_squared(m, band=None, device="cpu").numpy(), ref)


def test_has_neighbor26_matches_jax():
    m = np.random.default_rng(4).random((9, 10, 11)) < 0.1
    np.testing.assert_array_equal(
        tst.has_neighbor26(torch.from_numpy(m)).numpy(),
        np.asarray(jst.has_neighbor26(jnp.asarray(m))))


# -------------------------------------------------------------- masks


def _tip_fixture():
    """tests/test_pipeline.py::test_tip_extension_recovers_axial_tips_only."""
    rng = np.random.default_rng(1)
    v = rng.random((32, 32, 48)).astype(np.float32) * 0.004
    v[16, 16, 8:30] = 1.0
    v[16, 16, 30:33] = 0.02
    v[4:11, 4:11, 8:30] = 1.0
    v[4:11, 12, 18] = 0.02
    v[28, 28, 40] = 0.02
    brain = np.zeros(v.shape, np.uint8)
    brain[1:31, 1:31, 2:44] = 1
    return v, brain


def _brain_fixture():
    """tests/test_pipeline.py::test_hysteresis_mask_with_brain_boundary_
    suppression."""
    rng = np.random.default_rng(0)
    v = rng.random((40, 40, 48)).astype(np.float32) * 0.02
    v[18:22, 18:22, 8:40] = 1.0
    v[2:5, 18:22, 8:40] = 0.5
    brain = np.zeros(v.shape, np.uint8)
    brain[2:38, 2:38, 2:46] = 1
    return v, brain


def _random_fixture(seed):
    """Smoothed noise with bright random segments, and an ellipsoid brain
    at a random centre."""
    from scipy import ndimage

    rng = np.random.default_rng(seed)
    shape = (36, 40, 44)
    v = ndimage.gaussian_filter(rng.random(shape), 1.0).astype(np.float32)
    for _ in range(6):
        a = rng.integers(4, np.array(shape) - 4)
        b = rng.integers(4, np.array(shape) - 4)
        for t in np.linspace(0, 1, 60):
            p = np.round(a + t * (b - a)).astype(int)
            v[tuple(p)] = rng.uniform(0.6, 1.0)
    c = rng.uniform(0.4, 0.6, 3) * np.array(shape)
    ax = rng.uniform(0.35, 0.5, 3) * np.array(shape)
    z, y, x = np.ogrid[:shape[0], :shape[1], :shape[2]]
    brain = (((z - c[0]) / ax[0]) ** 2 + ((y - c[1]) / ax[1]) ** 2
             + ((x - c[2]) / ax[2]) ** 2) <= 1.0
    return v, brain


FIXTURES = {"tip": _tip_fixture, "brain": _brain_fixture,
            "random0": lambda: _random_fixture(10),
            "random1": lambda: _random_fixture(11)}


def _mask_config(fixture, hysteresis, tip):
    cfg = PipelineConfig()
    seg = cfg.segmentation
    seg.min_component_size = 5
    seg.global_threshold_fraction = 0.5
    if fixture == "brain":   # tests/test_pipeline.py's two configurations
        seg.global_threshold_fraction = 0.7 if hysteresis else 0.4
    seg.weak_threshold_fraction = 0.05 if hysteresis else None
    seg.near_boundary_fraction = 0.8 if fixture == "brain" else 0.6
    seg.boundary_distance_voxels = 6.0 if fixture == "brain" else 4.0
    if fixture.startswith("random"):
        seg.global_threshold_fraction = 0.6
        seg.weak_threshold_fraction = 0.45 if hysteresis else None
        seg.border_margin_voxels = 2
    if tip:
        seg.tip_fraction = 0.01 if not fixture.startswith("random") \
            else 0.42
        seg.tip_neighbor_max = 4
    return cfg


@pytest.mark.parametrize("mode,brain", [
    ("hysteresis", True), ("hysteresis_tip", True), ("plain", True),
    ("hysteresis_tip", False)])
@pytest.mark.parametrize("fixture", list(FIXTURES))
def test_masks_match_jax(fixture, mode, brain):
    v, b = FIXTURES[fixture]()
    b = b if brain else None
    cfg = _mask_config(fixture, mode != "plain", mode == "hysteresis_tip")
    ref = np.array(jax_mask(v, brain_mask=b, config=cfg))
    out = generate_vessel_mask(v, brain_mask=b,
                               config=convert.pipeline_config(cfg),
                               device="cpu")
    assert out.dtype == np.uint8 and ref.sum() > 20
    np.testing.assert_array_equal(out, ref)


def test_brain_and_tip_change_the_masks():
    """The fixtures exercise both options: the brain mask removes voxels
    (on the "brain" fixture's plain path, as in tests/test_pipeline.py,
    and on the random fixtures' hysteresis path), the tip extension adds
    some."""
    for name in FIXTURES:
        v, b = FIXTURES[name]()
        if name != "tip":
            cfg = convert.pipeline_config(
                _mask_config(name, name != "brain", False))
            without = generate_vessel_mask(v, config=cfg, device="cpu")
            with_brain = generate_vessel_mask(v, brain_mask=b, config=cfg,
                                              device="cpu")
            assert (without & ~with_brain).any(), name
        cfg = convert.pipeline_config(_mask_config(name, True, False))
        without = generate_vessel_mask(v, config=cfg, device="cpu")
        cfg = convert.pipeline_config(_mask_config(name, True, True))
        with_tip = generate_vessel_mask(v, config=cfg, device="cpu")
        assert (with_tip & ~without).any(), name


# ------------------------------------------------------- simple points


@pytest.fixture(scope="module")
def codes():
    """2^16 seeded random 26-bit codes and every code with at most 3 set
    bits."""
    rng = np.random.default_rng(0)
    small = [sum(1 << b for b in c) for r in range(4)
             for c in itertools.combinations(range(26), r)]
    return np.concatenate([rng.integers(0, 1 << 26, 1 << 16),
                           np.array(small)]).astype(np.int64)


@pytest.fixture(scope="module")
def port_predicate(codes):
    bits = tsp.code_bits(torch.from_numpy(codes))
    return tsp.simple_point_batch(bits).numpy()


def test_simple_point_batch_matches_jax(codes, port_predicate):
    bits = ((codes[:, None] >> np.arange(26)) & 1).astype(bool)
    np.testing.assert_array_equal(port_predicate,
                                  np.asarray(jsp.simple_point_batch(bits)))
    assert 0.2 < port_predicate.mean() < 0.6


def test_simple_point_batch_matches_native(codes, port_predicate):
    from arterynetwork_tpu_torch.ops.native import simple_point_native

    native = np.array([simple_point_native(int(c)) for c in codes], bool)
    np.testing.assert_array_equal(port_predicate, native)


def test_count_components_and_codes_match_jax():
    rng = np.random.default_rng(1)
    masks = rng.random((500, 26)) < 0.5
    for seeds in (None, [0, 4, 12, 25]):
        np.testing.assert_array_equal(
            tsp._count_components(torch.from_numpy(masks), tsp._ADJ26,
                                  seeds).numpy(),
            np.asarray(jsp._count_components(jnp.asarray(masks),
                                             jsp._ADJ26, seeds)))
    vol = rng.random((7, 8, 9)) < 0.5
    np.testing.assert_array_equal(
        tsp.neighborhood_codes(torch.from_numpy(vol)).numpy(),
        np.asarray(jsp.neighborhood_codes(vol)))


def test_lut_packing_and_cache(tmp_path, port_predicate, codes):
    """The packed table's bit order is lut_lookup's (the JAX package's
    and the native library's); a cached table is loaded, not rebuilt."""
    bits = np.random.default_rng(2).random(1 << 12) < 0.5
    packed = tsp._pack_bits(bits)
    np.testing.assert_array_equal(
        tsp.lut_lookup(packed, np.arange(1 << 12)), bits)
    np.testing.assert_array_equal(
        packed, np.packbits(bits.reshape(-1, 8)[:, ::-1]))
    from arterynetwork_tpu_torch.ops import native

    native.get_lib()
    with open(f"{native._BUILD_DIR}/simple26.lut", "rb") as f:
        table = np.frombuffer(f.read()[8:], np.uint8)
    np.save(tmp_path / tsp._CACHE_NAME, table)
    lut = tsp.build_simple_point_lut(cache_dir=str(tmp_path), device="cpu")
    np.testing.assert_array_equal(tsp.lut_lookup(lut, codes),
                                  port_predicate)


# ---------------------------------------------------------- components


@pytest.mark.parametrize("max_rounds", [64, 2])
@pytest.mark.parametrize("connectivity", [1, 3])
def test_connected_components_match_jax(connectivity, max_rounds):
    m = (np.random.default_rng(connectivity).random((24, 30, 36))
         < 0.3).astype(np.uint8)
    ref = np.asarray(jc.connected_components(m, connectivity=connectivity,
                                             max_rounds=max_rounds))
    out = tc.connected_components(m, connectivity=connectivity,
                                  max_rounds=max_rounds, device="cpu")
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)
    if max_rounds == 2:   # not converged: more labels than components
        full = np.asarray(jc.connected_components(
            m, connectivity=connectivity))
        assert len(np.unique(ref)) > len(np.unique(full))


@pytest.mark.parametrize("volume", ["numpy_2^31", "numpy_2^31-1",
                                    "torch_2^31"])
def test_connected_components_refuses_int32_overflow(volume, monkeypatch):
    """A volume whose flat index or background sentinel would wrap in
    int32 raises ValueError naming the limit and the shape, before
    anything is allocated (the inputs are zero-memory broadcast views)."""
    shape = {"numpy_2^31": (1024, 1024, 2048), "numpy_2^31-1":
             (1, 1, 2 ** 31 - 1), "torch_2^31": (2048, 1024, 1024)}[volume]
    mask = (torch.ones(1, dtype=torch.uint8).expand(shape)
            if volume.startswith("torch") else
            np.broadcast_to(np.ones(1, np.uint8), shape))

    def no_allocation(*args, **kwargs):
        raise AssertionError("allocated before the size check")

    monkeypatch.setattr(tc, "_as_device", no_allocation)
    monkeypatch.setattr(torch, "arange", no_allocation)
    with pytest.raises(ValueError, match=r"2\^31 - 2") as err:
        tc.connected_components(mask, device="cpu")
    assert str(shape) in str(err.value)


def test_connected_components_size_limit():
    """The largest volume that int32 labels index, and the Speck volume,
    pass the check; one voxel more does not."""
    tc.check_voxel_count((2 ** 31 - 2,))
    tc.check_voxel_count((880, 880, 640))
    with pytest.raises(ValueError):
        tc.check_voxel_count((2 ** 31 - 1,))
    assert tc.MAX_VOXELS == 2 ** 31 - 2


@pytest.mark.parametrize("connectivity", [1, 3])
def test_label_volume_and_drop_small_match_jax(connectivity):
    rng = np.random.default_rng(5)
    m = (rng.random((20, 24, 28)) < 0.3).astype(np.uint8)
    ref = jc.label_volume(m, min_size=3, connectivity=connectivity)
    out = tc.label_volume(m, min_size=3, connectivity=connectivity,
                          device="cpu")
    np.testing.assert_array_equal(out[0], ref[0])
    assert out[1] == ref[1]
    host = tc.label_volume(m, min_size=3, connectivity=connectivity,
                           backend="host")
    np.testing.assert_array_equal(host[0] > 0, ref[0] > 0)
    assert sorted(s for _, s in host[1]) == sorted(s for _, s in ref[1])
    labels = m * rng.integers(1, 4, m.shape).astype(np.uint8)  # not binary
    np.testing.assert_array_equal(
        tc.drop_small_components(labels, 4, connectivity, device="cpu"),
        jc.drop_small_components(labels, 4, connectivity))
    np.testing.assert_array_equal(tc.drop_small_components(m, 4),
                                  jc.drop_small_components(m, 4))


# ----------------------------------------------------------- vesselness

SIGMAS = (0.75, 1.0, 2.0, 3.0)


def _volume():
    rng = np.random.default_rng(0)
    vol = rng.normal(0.1, 0.05, (44, 24, 33)).astype(np.float32)
    vol[18:22, 10:13, 4:29] += 1.0
    vol[5:40, 4:7, 20:23] += 0.8
    return vol


def _rows(d):
    """(max |d| on interior z rows, on the two face rows)."""
    return float(np.abs(d[1:-1]).max()), float(np.abs(d[[0, -1]]).max())


@pytest.mark.parametrize("gamma", [None, 0.3])
def test_frangi_vesselness_matches_jax(gamma):
    vol = _volume()
    ref = np.asarray(jv.frangi_vesselness(vol, sigmas=SIGMAS, gamma=gamma))
    out = tv.frangi_vesselness(vol, sigmas=SIGMAS, gamma=gamma,
                               device="cpu")
    assert ref.max() > 0.4
    inner, face = _rows(out.numpy() - ref)
    assert inner <= 2e-4 and face <= 2e-4
    for sigma in (1.0, 3.0):
        hs = tv.hessian_at_scale(torch.from_numpy(vol), sigma)
        hj = jv.hessian_at_scale(jnp.asarray(vol), sigma)
        for a, b in zip(hs, hj):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=5e-6)
        r = tv._scale_response(torch.from_numpy(vol), sigma, 0.5, 0.5, 0.2,
                               True)
        rj = jv._scale_response(jnp.asarray(vol), sigma, 0.5, 0.5, 0.2, True)
        np.testing.assert_allclose(r.numpy(), np.asarray(rj), rtol=0,
                                   atol=2e-4)


@pytest.mark.parametrize("chunk_z", [16, 96])
@pytest.mark.parametrize("gamma", [None, 0.3])
def test_frangi_vesselness_chunked_matches_jax(gamma, chunk_z):
    vol = _volume()
    ref = np.asarray(jv.frangi_vesselness_chunked(
        vol, sigmas=SIGMAS, gamma=gamma, chunk_z=chunk_z))
    frangi_response_max_.launches = 0
    out = tv.frangi_vesselness_chunked(torch.from_numpy(vol), sigmas=SIGMAS,
                                       gamma=gamma, chunk_z=chunk_z)
    assert frangi_response_max_.launches == 0      # the twin on the CPU
    inner, face = _rows(out.numpy() - ref)
    assert inner <= 2e-4 and face <= 2e-4
    whole = tv.frangi_vesselness(vol, sigmas=SIGMAS, gamma=gamma,
                                 device="cpu").numpy()
    d = np.abs(out.numpy() - whole)
    assert (d[1:-1] <= 1e-5 + 1e-4 * np.abs(whole[1:-1])).all()
    assert d[[0, -1]].max() <= 0.05


# ------------------------------------------------------ native thinning


def test_skeletonize_native_without_transform_matches_jax():
    from arterynetwork_tpu.ops.native import skeletonize_native as jax_sk
    from arterynetwork_tpu_torch.ops.native import skeletonize_native

    m = np.zeros((30, 34, 40), np.uint8)
    m[6:24, 8:26, 5:35] = _random_mask((18, 18, 30), 0.3, 6)
    ref = jax_sk(m)
    out = skeletonize_native(m, device="cpu")
    assert ref.sum() > 20
    np.testing.assert_array_equal(out, ref)
