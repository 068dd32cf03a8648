"""Vesselness in the PyTorch port against the JAX reference, on the CPU.

The port's Frangi-response entry (``frangi_response_max_``) runs its
plain PyTorch twin on CPU tensors; here it is held to the JAX XLA apply
path and to the JAX Pallas kernel in interpret mode on the same smoothed
field.  Tolerances (values measured on a CPU in brackets):

  * twin vs XLA ``_apply_chunk_sm`` and vs the Pallas kernel:
    |d| <= 1e-5 + 1e-4 |ref| — the Pallas kernel's own parity bound in
    tests/test_vesselness_fused.py.  Max |d| 1.2e-5 vs XLA and 1.5e-5 vs
    Pallas, at voxels with a near-degenerate eigenpair, where the f32
    arccos is ill-conditioned (jit-fused XLA code itself moves those
    eigenvalues by 4e-6 against eager XLA); everywhere else <= 4e-6.
  * streamed multiscale vesselness, bq4 with the occupancy skip and u12:
    |d| <= 1e-4 everywhere [max 3.4e-5 for bq4, 2.8e-5 for u12];
  * device-side dequantization: bit-exact;
  * ``frangi_response_fused`` (the functional form over K1's twin)
    against the JAX function in interpret mode on all rows, a window
    with real halos and one-row windows: K1's bound above.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from arterynetwork_tpu.ops import vesselness as jv
from arterynetwork_tpu.ops.vesselness_fused import frangi_response_fused
from arterynetwork_tpu_torch.ops import vesselness as tv
from arterynetwork_tpu_torch.ops.vesselness_fused import frangi_response_max_

torch.set_num_threads(1)

SIGMAS = (0.75, 1.0, 2.0, 3.0)   # the pipeline_512 scales


def _volume(shape=(44, 24, 33), seed=0):
    rng = np.random.default_rng(seed)
    vol = rng.normal(0.1, 0.05, shape).astype(np.float32)
    vol[18:22, 10:13, 4:29] += 1.0
    vol[5:40, 4:7, 20:23] += 0.8
    return vol


def _smoothed(sigma):
    """Smoothed field from the JAX reference, and its S-max weight g."""
    smj = jv._smooth(jnp.asarray(_volume()), sigma)
    hs = jv._hessian_from_smoothed(smj, sigma)
    g = np.float32(0.5 * np.sqrt(np.max(sum(np.asarray(h) ** 2
                                            for h in hs))))
    return smj, g


@pytest.mark.parametrize("bright", [True, False])
@pytest.mark.parametrize("sigma", SIGMAS)
def test_twin_matches_xla_apply_chunk(sigma, bright):
    smj, g = _smoothed(sigma)
    sm = torch.from_numpy(np.array(smj))
    halo, chunk_z = 6, 16
    for start in (0, 8, 16):
        ref = np.asarray(jv._apply_chunk_sm(
            jnp.zeros((32, 24, 33), jnp.float32), smj, start,
            jnp.float32(g), sigma, 0.5, 0.5, bright, halo, chunk_z))
        best = torch.zeros((32, 24, 33))
        frangi_response_max_(best, start, sm, start + halo, chunk_z, sigma,
                             torch.tensor(g), 0.5, 0.5, bright)
        np.testing.assert_allclose(best.numpy(), ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("z_lo,z_hi", [(3, 43), (0, 44)])
@pytest.mark.parametrize("sigma", [1.0, 3.0])
def test_twin_matches_pallas_interpret(sigma, z_lo, z_hi):
    """Real z halos inside the field; edge replication at its ends."""
    smj, g = _smoothed(sigma)
    ref = np.asarray(frangi_response_fused(smj, sigma, jnp.float32(g),
                                           z_lo=z_lo, z_hi=z_hi,
                                           tile=(4, 8), interpret=True))
    best = torch.zeros((z_hi - z_lo, 24, 33))
    frangi_response_max_(best, 0, torch.from_numpy(np.array(smj)), z_lo,
                         z_hi - z_lo, sigma, torch.tensor(g))
    np.testing.assert_allclose(best.numpy(), ref, rtol=1e-4, atol=1e-5)


def _raw_tube(shape=(40, 40, 56), seed=2):
    """The raw-volume phantom of tests/test_pipeline.py."""
    rng = np.random.default_rng(seed)
    raw = rng.normal(100.0, 3.0, shape).astype(np.float32)
    x, y = np.mgrid[: shape[0], : shape[1]]
    tube = ((x - 20) ** 2 + (y - 20) ** 2 <= 3 ** 2)
    for z in range(6, 50):
        raw[:, :, z] += 120.0 * tube
    return raw


# (3, True): the Speck wire; the tube's 40 rows end in a ragged chunk of 8
@pytest.mark.parametrize("bits,skip", [(4, True), (12, False), (3, True)])
def test_streamed_vesselness_matches_jax(bits, skip):
    raw = _raw_tube()
    kw = dict(sigmas=SIGMAS, bits=bits, skip_background=skip, chunk_z=16)
    ref, _, _ = jv.frangi_vesselness_streamed(raw, fused_response=False,
                                              **kw)
    out, _, _ = tv.frangi_vesselness_streamed(raw, device="cpu", **kw)
    assert out.shape == raw.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("fmt", ["u8", "u12", "f16", "bq4", "bq3", "bq2",
                                 "bq4_sparse"])
def test_dequant_bit_exact(fmt):
    rng = np.random.default_rng(5)
    rows, ny, nx = 6, 8, 48
    slab = rng.normal(100.0, 20.0, (rows, ny, nx)).astype(np.float32)
    zj = jnp.zeros((rows + 4, ny, nx), jnp.float32)
    zt = torch.zeros((rows + 4, ny, nx))
    start = 2
    if fmt == "u8":
        q = rng.integers(0, 256, (rows, ny, nx), dtype=np.uint8)
        ref = jv._upload_slab_u8(zj, jnp.asarray(q), start, 0.37 / 255.0,
                                 12.5)
        tv._upload_slab_u8(zt, torch.from_numpy(q), start, 0.37 / 255.0,
                           12.5)
    elif fmt == "u12":
        packed = rng.integers(0, 256, (rows * ny * nx // 2, 3),
                              dtype=np.uint8)
        sc, off = np.float32(411.3 / 4095.0), np.float32(-3.25)
        ref = jv._upload_slab_u12(zj, jnp.asarray(packed), start,
                                  jnp.float32(sc), jnp.float32(off), rows,
                                  (ny, nx))
        tv._upload_slab_u12(zt, torch.from_numpy(packed), start,
                            torch.tensor(sc), torch.tensor(off), rows,
                            (ny, nx))
    elif fmt == "f16":
        h = slab.astype(np.float16)
        ref = jv._upload_slab_f16(zj, jnp.asarray(h), start)
        tv._upload_slab_f16(zt, torch.from_numpy(h), start)
    elif fmt == "bq4_sparse":
        from arterynetwork_tpu_torch.ops.native import bq_pack_native
        # two of six row-chunks carry a vessel; the noise rows skip
        slab = rng.normal(100.0, 1.0, (rows, ny, nx)).astype(np.float32)
        slab[1:3, 2:5, 10:20] += 300.0
        packed, rsc, rmn = bq_pack_native(slab, 4)
        pay, idx, rsc2, rmn2, nch = tv._compact_bq_slab(packed, rsc, rmn, 4)
        kw = dict(bits=4, cs=tv._SKIP_CHUNK_ROWS, n_chunks=nch, rows=rows,
                  ny=ny)
        ref = jv._upload_slab_bq_sparse(
            zj, jnp.asarray(pay), jnp.asarray(idx), jnp.asarray(rsc2),
            jnp.asarray(rmn2), start, **kw)
        tv._upload_slab_bq_sparse(
            zt, torch.from_numpy(pay), torch.from_numpy(idx.astype(np.int64)),
            torch.from_numpy(rsc2), torch.from_numpy(rmn2), start, **kw)
    else:
        from arterynetwork_tpu_torch.ops.native import bq_pack_native
        bits = int(fmt[2])
        packed, rsc, rmn = bq_pack_native(slab, bits)
        up = {4: jv._upload_slab_bq4, 3: jv._upload_slab_bq3,
              2: jv._upload_slab_bq2}[bits]
        ref = up(zj, jnp.asarray(packed), jnp.asarray(rsc),
                 jnp.asarray(rmn), start)
        tv._upload_slab_bq(zt, torch.from_numpy(packed),
                           torch.from_numpy(rsc), torch.from_numpy(rmn),
                           start, bits)
    np.testing.assert_array_equal(zt.numpy(), np.asarray(ref))


# ----------------------------------------------------------------------
# frangi_response_fused: the JAX package's functional form of K1
# ----------------------------------------------------------------------
def _k1_bound(out, ref):
    """K1's bound against the JAX kernel: |d| <= 1e-5 + 1e-4 |ref|."""
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("bright", [True, False])
@pytest.mark.parametrize("z_lo,z_hi", [(0, None), (3, 43), (17, 18),
                                       (0, 1), (43, 44)])
@pytest.mark.parametrize("sigma", [1.0, 3.0])
def test_response_fused_matches_pallas_interpret(sigma, z_lo, z_hi, bright):
    """All rows, a [z_lo, z_hi) window with real halos, one-row windows
    inside and at both ends (edge replication), bright and dark."""
    from arterynetwork_tpu_torch.ops import frangi_response_fused as fused_t

    smj, g = _smoothed(sigma)
    ref = np.asarray(frangi_response_fused(smj, sigma, jnp.float32(g),
                                           bright=bright, z_lo=z_lo,
                                           z_hi=z_hi, tile=(4, 8),
                                           interpret=True))
    out = fused_t(torch.from_numpy(np.array(smj)), sigma, float(g),
                  bright=bright, z_lo=z_lo, z_hi=z_hi)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    _k1_bound(out.numpy(), ref)


def test_response_fused_is_the_twins_running_max():
    """The functional form equals frangi_response_max_ into a zeroed
    best (the response is >= 0), with g as a number or a tensor; a
    device with no K1 raises."""
    from arterynetwork_tpu_torch.ops.vesselness_fused import \
        frangi_response_fused as fused_t

    smj, g = _smoothed(2.0)
    sm = torch.from_numpy(np.array(smj))
    best = torch.zeros((12,) + tuple(sm.shape[1:]))
    frangi_response_max_(best, 0, sm, 5, 12, 2.0, torch.tensor(g))
    for gg in (float(g), torch.tensor(g), torch.tensor([g])):
        out = fused_t(sm, 2.0, gg, z_lo=5, z_hi=17)
        assert torch.equal(out, best)
    with pytest.raises(ValueError):
        fused_t(sm.to("meta"), 2.0, g)


def test_graphs_exports_are_the_network_module_objects():
    import arterynetwork_tpu.graphs as jgraphs
    import arterynetwork_tpu_torch.graphs as tgraphs
    from arterynetwork_tpu_torch.graphs import network

    assert tgraphs.__all__ == jgraphs.__all__
    for name in ("FlowNetwork", "make_network", "orient_edges_by_depth",
                 "validate_network"):
        assert getattr(tgraphs, name) is getattr(network, name)
