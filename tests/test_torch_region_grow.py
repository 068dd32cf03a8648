"""Region growing in the PyTorch port against the JAX package, on the CPU.

Inputs are made with numpy from seeds and fed to both packages.  Where the
JAX function reaches a Pallas kernel it runs in interpret mode, as the
JAX package's own tests run it.  The port runs its kernels' plain
versions here (CPU tensors).  Tolerances:

  * histograms, sweeps (seg and +/- deltas), frontier trajectories,
    grower masks, iteration counts and stop reasons: exact;
  * decision tables: the two packages sum the ``K @ hist`` matvec in
    different orders, so a sign may differ only where
    |diff| <= 1e-6 max|diff| (measured on the 48^3 tube: none differ).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arterynetwork_tpu.ops import region_grow_fused as jfused
from arterynetwork_tpu.ops import stencil as jstencil
from arterynetwork_tpu.ops.histogram import _masked_histograms_scatter
from arterynetwork_tpu.ops.region_grow import A_NORM as J_A_NORM
from arterynetwork_tpu.ops.region_grow import _quantize as j_quantize
from arterynetwork_tpu.ops.region_grow import _region_grow_xla
from arterynetwork_tpu.ops.region_grow import \
    region_grow_value_map as j_value_map
from arterynetwork_tpu.ops.region_grow_frontier import \
    region_grow_frontier as j_frontier
from arterynetwork_tpu_torch import convert
from arterynetwork_tpu_torch.ops import region_grow_fused as tfused
from arterynetwork_tpu_torch.ops import stencil as tstencil
from arterynetwork_tpu_torch.ops.histogram import (masked_histogram_one,
                                                   masked_histograms)
from arterynetwork_tpu_torch.ops.region_grow import (
    A_NORM, _decision_table, _gaussian_kernel, _quantize,
    reconstruct_value_map, region_grow, region_grow_value_map)
from arterynetwork_tpu_torch.ops.region_grow_frontier import \
    region_grow_frontier
from arterynetwork_tpu_torch.utils.phantoms import tube_phantom
from arterynetwork_tpu_torch.utils.reference_region_grow import \
    reference_region_grow

torch.set_num_threads(1)

_x32 = functools.partial(jax.enable_x64, False)


def _t(a):
    return torch.from_numpy(np.array(a))


def _same_result(port, ref):
    np.testing.assert_array_equal(port.segmented_map.numpy(),
                                  np.asarray(ref.segmented_map))
    np.testing.assert_array_equal(port.active_map.numpy(),
                                  np.asarray(ref.active_map))
    for f in ("iterations", "segmented_count", "stop_reason"):
        assert int(getattr(port, f)) == int(getattr(ref, f)), f


# ----------------------------------------------------------------------
# stencil and histograms
# ----------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(5, 7, 9), (1, 4, 3), (6, 6)])
@pytest.mark.parametrize("fn", ["dilate26", "neighbor_count26",
                                "neighbor_count6"])
def test_stencil_matches_jax(shape, fn):
    m = np.random.default_rng(0).random(shape) < 0.2
    ref = np.asarray(getattr(jstencil, fn)(jnp.asarray(m)))
    out = getattr(tstencil, fn)(_t(m)).numpy()
    assert out.dtype == ref.dtype
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("n_masks,num_bins", [(1, 256), (2, 256), (3, 64)])
def test_histograms_match_jax_scatter(n_masks, num_bins):
    rng = np.random.default_rng(n_masks)
    n = 20_000
    bins = rng.integers(0, num_bins, n)
    bins[: n // 2] = 3                      # one heavy background bin
    masks = rng.random((n_masks, n)) < 0.4
    ref = np.asarray(_masked_histograms_scatter(jnp.asarray(bins),
                                                jnp.asarray(masks),
                                                num_bins))
    out = masked_histograms(_t(bins.astype(np.uint8)), _t(masks), num_bins)
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(
        masked_histogram_one(_t(bins.astype(np.uint8)), _t(masks[0]),
                             num_bins).numpy(), ref[0])


# ----------------------------------------------------------------------
# sweeps (K2, and K3/K4 through their entries) vs the interpret kernels
# ----------------------------------------------------------------------
def _quantized(data):
    with _x32():
        return j_quantize(jnp.asarray(data), 256)


def _jax_diff(bin_idx, bin_values, seg):
    """The JAX decision table of ``seg`` (tests/test_region_grow_fused.py's
    formulation)."""
    dv = bin_values[:, None] - bin_values[None, :]
    K = (J_A_NORM * jnp.exp(-0.5 * 2.25 * dv * dv)).astype(jnp.float32)
    flat = bin_idx.reshape(-1)
    hist_all = _masked_histograms_scatter(flat, jnp.ones((1, flat.size),
                                                         bool), 256)[0]
    inner = _masked_histograms_scatter(flat, seg.reshape(1, -1), 256)[0]
    outer = hist_all - inner
    return ((K @ inner) / jnp.maximum(jnp.sum(inner), 1.0)
            - (K @ outer) / jnp.maximum(jnp.sum(outer), 1.0))


def _port_sweep(fn, seg, idx, words, **kw):
    s, hp, hn = fn(_t(np.asarray(seg).astype(np.uint8)),
                   _t(np.asarray(idx).astype(np.uint8)),
                   _t(np.asarray(words)), **kw)
    return s.numpy(), hp.numpy(), hn.numpy()


def _assert_same_sweep(port, ref):
    np.testing.assert_array_equal(port[0] != 0, np.asarray(ref[0]) != 0)
    np.testing.assert_array_equal(port[1], np.asarray(ref[1]))
    np.testing.assert_array_equal(port[2], np.asarray(ref[2]))


def test_fused_sweep_matches_interpret_iterations():
    """tests/test_region_grow_fused.py::test_fused_sweep_matches_xla_
    iterations: three sweeps from the JAX kernel's own state and words."""
    rng = np.random.default_rng(0)
    Z, Y, X = 12, 16, 128
    data = rng.normal(0.1, 0.05, (Z, Y, X)).astype(np.float32)
    data[5:8, 6:10, 30:90] += 0.8
    seed = np.zeros((Z, Y, X), bool)
    seed[6, 7, 50:60] = True
    with _x32():
        bin_idx, bin_values = _quantized(data)
        seg = jnp.asarray(seed)
        for _ in range(3):
            words = jfused.pack_sign_words(_jax_diff(bin_idx, bin_values,
                                                     seg))
            ref = jfused.fused_sweep(seg.astype(jnp.bfloat16),
                                     bin_idx.astype(jnp.bfloat16), words,
                                     interpret=True)
            out = _port_sweep(tfused.fused_sweep, seg, bin_idx, words)
            _assert_same_sweep(out, ref)
            seg = jnp.asarray(np.asarray(ref[0]) != 0)
    assert int(jnp.sum(seg)) > int(seed.sum())


def test_fused_sweep_padded_lanes_match_interpret():
    """A table that flips every boundary voxel inward: pad lanes beyond
    valid_yx never enter the region."""
    rng = np.random.default_rng(1)
    Z, Y, X = 6, 16, 128
    data = rng.normal(0.1, 0.02, (Z, Y, X)).astype(np.float32)
    data[2:4, 4:12, 80:128] += 0.9
    seed = np.zeros((Z, Y, X), bool)
    seed[3, 8, 90:98] = True
    with _x32():
        bin_idx, _ = _quantized(data)
        words = jfused.pack_sign_words(jnp.ones((256,), jnp.float32))
        ref = jfused.fused_sweep(jnp.asarray(seed).astype(jnp.bfloat16),
                                 bin_idx.astype(jnp.bfloat16), words,
                                 valid_yx=(Y, 100), interpret=True)
    out = _port_sweep(tfused.fused_sweep, seed, bin_idx, words,
                      valid_yx=(Y, 100))
    _assert_same_sweep(out, ref)
    assert not out[0][:, :, 100:].any()


def _padded_face_case(Y0, X0, Y, X, seed_rows):
    rng = np.random.default_rng(7)
    Z = 6
    data = rng.normal(0.1, 0.05, (Z, Y0, X0)).astype(np.float32)
    data[2:5, Y0 // 2:, 60:100] += 0.8
    seed = np.zeros((Z, Y0, X0), bool)
    seed[3, seed_rows, 80:100] = True
    bin_idx, bin_values = _quantized(data)
    pad = ((0, 0), (0, Y - Y0), (0, X - X0))
    return seed, bin_idx, bin_values, pad


@pytest.mark.parametrize("entry,Y0,Y,band", [
    ("fused_sweep", 12, 16, None),
    ("fused_sweep_banded", 28, 32, 16),
    ("fused_sweep_banded_dma", 28, 32, 16)])
def test_padded_face_sweeps_match_interpret(entry, Y0, Y, band):
    """Real voxels on the high Y/X faces next to pad rows/lanes: pads are
    neither seg nor ~seg.  An all-out table (erosion of the true boundary
    only), then three sweeps with the real decision table."""
    seed, bin_idx, bin_values, pad = _padded_face_case(
        Y0, 100, Y, 128, slice(Y0 - 8 if band else 8, Y0))
    kw = {"valid_yx": (Y0, 100)}
    if band:
        kw["band"] = band
    with _x32():
        idx_p = jnp.pad(bin_idx, pad).astype(jnp.bfloat16)
        seg = jnp.asarray(seed)
        tables = [-jnp.ones((256,), jnp.float32)] + [None] * 3
        for table in tables:
            if table is None:
                table = _jax_diff(bin_idx, bin_values, seg)
            words = jfused.pack_sign_words(table)
            seg_p = jnp.pad(seg, pad)
            ref = getattr(jfused, entry)(seg_p.astype(jnp.bfloat16), idx_p,
                                         words, interpret=True, **kw)
            out = _port_sweep(getattr(tfused, entry), seg_p, idx_p, words,
                              **kw)
            _assert_same_sweep(out, ref)
            assert not out[0][:, Y0:].any() and not out[0][:, :, 100:].any()
            seg = jnp.asarray(np.asarray(ref[0])[:, :Y0, :100] != 0)


@pytest.mark.parametrize("entry", ["fused_sweep_banded",
                                   "fused_sweep_banded_dma"])
def test_banded_sweeps_match_interpret(entry):
    """tests/test_region_grow_fused.py::test_banded_sweep_matches_simple_
    sweep: two sweeps over bands of 16 rows."""
    rng = np.random.default_rng(3)
    Z, Y, X = 8, 48, 128
    data = rng.normal(0.1, 0.05, (Z, Y, X)).astype(np.float32)
    data[3:6, 8:40, 30:90] += 0.8
    seed = np.zeros((Z, Y, X), bool)
    seed[4, 20, 50:60] = True
    with _x32():
        bin_idx, bin_values = _quantized(data)
        seg = jnp.asarray(seed)
        for _ in range(2):
            words = jfused.pack_sign_words(_jax_diff(bin_idx, bin_values,
                                                     seg))
            ref = getattr(jfused, entry)(seg.astype(jnp.bfloat16),
                                         bin_idx.astype(jnp.bfloat16),
                                         words, band=16, interpret=True)
            out = _port_sweep(getattr(tfused, entry), seg, bin_idx, words,
                              band=16)
            _assert_same_sweep(out, ref)
            seg = jnp.asarray(np.asarray(ref[0]) != 0)


@pytest.mark.parametrize("entry", ["fused_sweep", "fused_sweep_banded",
                                   "fused_sweep_banded_dma"])
@pytest.mark.parametrize("X0", [1, 33, 100])
def test_dense_random_sweeps_match_interpret(entry, X0):
    """A Bernoulli(0.5) state with random decision words, so that almost
    every voxel lies on the boundary, many flip and all 256 bins occur;
    the valid region (29, X0) sits inside a (32, 128) pad."""
    rng = np.random.default_rng(X0)
    Z, Y, X, Y0 = 4, 32, 128, 29
    seg = np.zeros((Z, Y, X), bool)
    seg[:, :Y0, :X0] = rng.random((Z, Y0, X0)) < 0.5
    idx = np.zeros((Z, Y, X), np.float32)
    idx[:, :Y0, :X0] = rng.integers(0, 256, (Z, Y0, X0))
    words = rng.integers(-2 ** 31, 2 ** 31, 8).astype(np.int32)
    kw = {"valid_yx": (Y0, X0)}
    if entry != "fused_sweep":
        kw["band"] = 16
    with _x32():
        ref = getattr(jfused, entry)(jnp.asarray(seg).astype(jnp.bfloat16),
                                     jnp.asarray(idx).astype(jnp.bfloat16),
                                     jnp.asarray(words), interpret=True, **kw)
    out = _port_sweep(getattr(tfused, entry), seg, idx, words, **kw)
    _assert_same_sweep(out, ref)
    assert out[1].sum() + out[2].sum() > Z * Y0 * X0 // 8
    assert not out[0][:, Y0:].any() and not out[0][:, :, X0:].any()


def test_banded_entries_keep_their_contracts():
    seg = torch.zeros((2, 24, 8), dtype=torch.uint8)
    words = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        tfused.fused_sweep_banded(seg, seg, words, band=16)    # 24 % 16
    with pytest.raises(ValueError):
        tfused.fused_sweep_banded_dma(seg[:, :16], seg[:, :16], words,
                                      band=16)                 # 16 < 32


# ----------------------------------------------------------------------
# frontier (K5) vs the interpret kernel, iteration by iteration
# ----------------------------------------------------------------------
def _bar_phantom(shape=(24, 40, 48), seed=0):
    """tests/test_region_grow_frontier.py's phantom."""
    rng = np.random.default_rng(seed)
    vol = rng.normal(0.1, 0.03, shape).astype(np.float32)
    vol[10:14, 10:14, 8:40] += 0.8
    seed_mask = np.zeros(shape, bool)
    seed_mask[11:13, 11:13, 20:24] = True
    return vol, seed_mask


@pytest.mark.parametrize("iters,k_max,shape,nb", [
    (1, 16, (24, 40, 48), 1),
    (3, 16, (24, 40, 48), 1),
    (3, 2, (24, 40, 48), 1),        # k_max overflow: tiles carried over
    (3, 16, (21, 37, 45), 1),       # tiles past the volume's faces
    (3, 16, (24, 40, 48), 3)])      # nb not dividing the active count
def test_frontier_trajectory_matches_interpret(iters, k_max, shape, nb):
    vol, seed = _bar_phantom(shape, seed=3)
    kw = dict(max_segment_size=100000, iter_max=iters, tile=(8, 16),
              k_max=k_max, nb=nb)
    ref = j_frontier(jnp.asarray(vol), jnp.asarray(seed), interpret=True,
                     **kw)
    out = region_grow_frontier(vol, seed, device="cpu", **kw)
    _same_result(out, ref)


@pytest.mark.parametrize("iters,k_max,shape,nb", [
    (1, 16, (24, 40, 48), 1),
    (3, 16, (24, 40, 48), 1),
    (3, 4, (21, 37, 45), 1),        # most tiles carried over
    (2, 16, (21, 37, 45), 3)])
def test_frontier_dense_seed_matches_interpret(iters, k_max, shape, nb):
    """A Bernoulli(0.5) seed in noise: every tile active and on the
    boundary from the first iteration, many flips both ways."""
    rng = np.random.default_rng(sum(shape) + iters)
    vol = rng.normal(0.1, 0.05, shape).astype(np.float32)
    seed = rng.random(shape) < 0.5
    kw = dict(max_segment_size=10 ** 6, iter_max=iters, tile=(8, 16),
              k_max=k_max, nb=nb)
    ref = j_frontier(jnp.asarray(vol), jnp.asarray(seed), interpret=True,
                     **kw)
    out = region_grow_frontier(vol, seed, device="cpu", **kw)
    _same_result(out, ref)
    assert int(out.iterations) == iters


def test_frontier_size_cap_matches_interpret():
    vol, seed = _bar_phantom(seed=1)
    kw = dict(max_segment_size=64, iter_max=100, tile=(8, 16), k_max=16)
    ref = j_frontier(jnp.asarray(vol), jnp.asarray(seed), interpret=True,
                     **kw)
    out = region_grow_frontier(vol, seed, device="cpu", **kw)
    assert int(out.stop_reason) == 1
    _same_result(out, ref)


# ----------------------------------------------------------------------
# growers on tests/test_region_grow.py's fixtures vs the JAX XLA path
# ----------------------------------------------------------------------
def _fixture(name):
    if name == "line":
        vol = np.zeros((50, 50, 150), np.float32)
        vol[20:22, 20:22, 20:40] = 1
        seed = np.zeros(vol.shape, bool)
        seed[20:22, 20:22, 22:25] = True
        return vol, seed, {}
    if name == "sphere":
        x, y, z = np.mgrid[:50, :50, :50]
        vol = ((x - 25) ** 2 + (y - 25) ** 2
               + (z - 25) ** 2 <= 100).astype(np.float32)
        seed = np.zeros(vol.shape, bool)
        seed[25:27, 25:27, 25:27] = True
        return vol, seed, {}
    if name == "size_cap":
        vol = np.zeros((30, 30, 60), np.float32)
        vol[10:14, 10:14, 5:55] = 1
        seed = np.zeros(vol.shape, bool)
        seed[10:14, 10:14, 28:31] = True
        return vol, seed, {"max_segment_size": 100}
    if name == "excluded":
        vol = np.zeros((20, 20, 20), np.float32)
        vol[8:12, 8:12, 4:16] = 1
        seed = np.zeros(vol.shape, bool)
        seed[9:11, 9:11, 9:11] = True
        excluded = np.zeros(vol.shape, bool)
        excluded[:2] = True
        return vol, seed, {"excluded_mask": excluded}
    rng = np.random.default_rng(0)                     # the H fixture
    vol = rng.normal(0.2, 0.05, size=(24, 24, 24)).astype(np.float32)
    vol[8:16, 8:16, 8:16] += 0.6
    seed = np.zeros(vol.shape, bool)
    seed[11:13, 11:13, 11:13] = True
    return vol, seed, {"H": float(name.split("_")[1]),
                       "num_bins": int(name.split("_")[2])}


def _jax_xla(vol, seed, kw):
    kw = dict(kw)
    exc = kw.pop("excluded_mask", None)
    return _region_grow_xla(jnp.asarray(vol), jnp.asarray(seed),
                            None if exc is None else jnp.asarray(exc), **kw)


@pytest.mark.parametrize("name", ["line", "sphere", "size_cap", "excluded",
                                  "H_0.5_512", "H_50.0_512", "H_2.25_256"])
@pytest.mark.parametrize("backend", ["xla", "fused"])
def test_growers_match_jax_xla(name, backend):
    vol, seed, kw = _fixture(name)
    ref = _jax_xla(vol, seed, kw)
    if backend == "fused" and ("excluded_mask" in kw
                               or kw.get("num_bins", 256) != 256):
        with pytest.raises(ValueError):
            region_grow(vol, seed, backend="fused", device="cpu", **kw)
        return
    out = region_grow(vol, seed, backend=backend, device="cpu", **kw)
    _same_result(out, ref)
    if name == "excluded":
        assert not out.active_map[:2].any()


def test_f64_data_stays_f64_and_matches_jax():
    vol, seed, kw = _fixture("H_2.25_256")
    vol = vol.astype(np.float64)
    ref = _jax_xla(vol, seed, kw)
    _same_result(region_grow(vol, seed, backend="xla", device="cpu", **kw),
                 ref)


def test_auto_takes_xla_on_cpu():
    vol, seed, _ = _fixture("line")
    n0 = tfused.fused_sweep_counts.launches
    out = region_grow(vol, seed, device="cpu")
    assert tfused.fused_sweep_counts.launches == n0
    _same_result(out, _jax_xla(vol, seed, {}))


def test_growers_match_reference_oracle():
    """The faithful boundary-list implementation reaches the same fixed
    point (tests/test_region_grow.py's oracle fixture; 1024 bins on the
    full-grid path, 256 bins on the fused and frontier growers)."""
    rng = np.random.default_rng(5)
    vol = np.zeros((16, 16, 32), np.float32)
    vol[6:9, 6:9, 4:28] = 1.0
    vol += rng.normal(0, 0.01, vol.shape).astype(np.float32)
    seed = np.zeros(vol.shape, bool)
    seed[7, 7, 14:18] = True
    ref_seg, _, _ = reference_region_grow(vol, seed)
    outs = [region_grow(vol, seed, num_bins=1024, backend="xla",
                        device="cpu"),
            region_grow(vol, seed, backend="fused", device="cpu"),
            region_grow_frontier(vol, seed, tile=(8, 16), k_max=4,
                                 device="cpu")]
    for out in outs:
        np.testing.assert_array_equal(out.segmented_map.numpy(), ref_seg)


def test_tube_phantom_signs_and_fixed_point():
    """bench.py's tube phantom at 48^3: the port's decision table agrees
    in sign with JAX's wherever |diff| > 1e-6 max|diff|, at the seed and
    at the fixed point, and all growers reach JAX's fixed point."""
    vol, seed = tube_phantom((48, 48, 48))
    ref = _region_grow_xla(jnp.asarray(vol), jnp.asarray(seed),
                           max_segment_size=10 ** 6, iter_max=300)
    kw = dict(max_segment_size=10 ** 6, iter_max=300, device="cpu")
    for out in (region_grow(vol, seed, backend="xla", **kw),
                region_grow(vol, seed, backend="fused", **kw),
                region_grow_frontier(vol, seed, **kw)):
        _same_result(out, ref)

    with _x32():
        bin_idx, bin_values = _quantized(vol)
    dt = torch.from_numpy(vol)
    idx, values = _quantize(dt, 256)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(bin_idx))
    np.testing.assert_array_equal(values.numpy(), np.asarray(bin_values))
    K = _gaussian_kernel(values, 2.25, torch.float32)
    bins = idx.to(torch.uint8).reshape(-1)
    hist_all = masked_histogram_one(bins, torch.ones_like(bins,
                                                          dtype=torch.bool))
    for state in (seed, np.asarray(ref.segmented_map)):
        with _x32():
            jd = np.asarray(_jax_diff(bin_idx, bin_values,
                                      jnp.asarray(state)))
        inner = masked_histogram_one(bins, _t(state).reshape(-1))
        td = _decision_table(K, inner, hist_all - inner).numpy()
        sure = np.abs(jd) > 1e-6 * np.abs(jd).max()
        np.testing.assert_array_equal((td >= 0)[sure], (jd >= 0)[sure])
        np.testing.assert_allclose(td, jd, rtol=0, atol=1e-6 * np.abs(
            jd).max())
    assert A_NORM == J_A_NORM


def test_continue_from_jax_mid_trajectory():
    """convert.region_grow_result: the port picks up a JAX state after 6
    iterations and ends where JAX's uninterrupted run ends."""
    vol, seed = tube_phantom((32, 32, 40), seed=1)
    kw = dict(max_segment_size=10 ** 6, iter_max=300)
    full = _region_grow_xla(jnp.asarray(vol), jnp.asarray(seed), **kw)
    mid = convert.region_grow_result(
        _region_grow_xla(jnp.asarray(vol), jnp.asarray(seed),
                         max_segment_size=10 ** 6, iter_max=6),
        device="cpu")
    assert int(mid.iterations) == 6 and int(mid.stop_reason) == 2
    for backend in ("xla", "fused"):
        out = region_grow(vol, mid.segmented_map, backend=backend,
                          device="cpu", **kw)
        np.testing.assert_array_equal(out.segmented_map.numpy(),
                                      np.asarray(full.segmented_map))
        assert int(out.iterations) + 6 == int(full.iterations)
        assert int(out.stop_reason) == int(full.stop_reason)


# ----------------------------------------------------------------------
# reference-style value map API
# ----------------------------------------------------------------------
def test_value_map_round_trip_matches_jax():
    volume = np.zeros((20, 20, 40), dtype=np.int32)
    volume[8:10, 8:10, 5:35] = 1
    value_map = np.full(volume.shape, 3)
    value_map[8:10, 8:10, 15:18] = 0
    value_map[:, :, :2] = 4                   # excluded slab
    ref = j_value_map(volume, value_map)
    out = region_grow_value_map(volume, value_map, device="cpu")
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, np.asarray(b))
    coords, seg_map, vm = out
    assert seg_map.sum() == np.count_nonzero(volume)
    assert np.all(vm[volume.astype(bool)] == 1)
    # the map rebuilt from its own masks is the map
    np.testing.assert_array_equal(
        reconstruct_value_map(seg_map.astype(bool), vm != 4, device="cpu"),
        vm)
