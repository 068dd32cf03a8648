"""The Speck-scale (880x880x640) configurations of chip_smoke.py, held to
the JAX package on the CPU at small sizes.

  * the three growers chip_smoke's speck_region_grow runs (the fused
    grower, the full grid, the frontier) on bench.py's tube phantom at
    (88, 88, 64), radius 3, 60 iterations at most, 10^7 voxels: each
    equal to the JAX package's region_grow on its XLA path (iterations,
    count, stop reason, mask; exact);
  * frangi_vesselness_chunked with the Speck driver's arguments (sigmas
    1, 2, 3; 110-row slabs) on a volume whose Z is not a multiple of 110,
    against the JAX function: |d| <= 1e-5 + 1e-4 |ref|, K1's bound, but
    at voxels where exactly one package's sign gate gives 0 (1 of 62,400
    here, |d| 1.6e-4 at sigma 2 where JAX gives 0): there |d| <= 2e-4,
    the bound tests/test_torch_voxel_ops.py holds the two drivers to;
  * chip_smoke.speck_config() equal field by field to the JAX
    configuration bench.py::bench_speck_pipeline builds (bench.py:508-523);
  * the K1 launch counts the Speck phases gate on (76 per pipeline run,
    24 per chunked call), from the slab arithmetic the drivers use, and
    that arithmetic equal to the twin's calls on small volumes;
  * the whole-volume frangi_vesselness: its per-voxel passes run slab by
    slab, so that its peak memory stays a small multiple of the volume
    (with the whole volume as one slab, 53.7 input-sized f32 tensors at
    once on the CPU here), with the whole volume's bits.  On the card,
    chip_smoke's speck_sharded reads both peaks at Speck scale.
"""

import dataclasses
import functools
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arterynetwork_tpu.config import PipelineConfig as JaxPipelineConfig
from arterynetwork_tpu.ops import vesselness as jv
from arterynetwork_tpu.ops.region_grow import region_grow as j_region_grow
from arterynetwork_tpu_torch import convert
from arterynetwork_tpu_torch.ops import vesselness as tv
from arterynetwork_tpu_torch.ops import vesselness_fused
from arterynetwork_tpu_torch.ops.region_grow import region_grow
from arterynetwork_tpu_torch.ops.region_grow_frontier import \
    region_grow_frontier
from arterynetwork_tpu_torch.utils.phantoms import tube_phantom

import chip_smoke

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RG_KW = {"max_segment_size": 10 ** 7, "iter_max": 60}   # bench.py:453-466


@functools.lru_cache(maxsize=None)
def _tube_and_jax():
    vol, seed = tube_phantom((88, 88, 64), radius=3)
    ref = j_region_grow(jnp.asarray(vol), jnp.asarray(seed), backend="xla",
                        **RG_KW)
    return vol, seed, ref


@pytest.mark.parametrize("grower", ["fused", "xla", "frontier"])
def test_speck_growers_match_jax_xla(grower):
    vol, seed, ref = _tube_and_jax()
    if grower == "frontier":
        out = region_grow_frontier(vol, seed, device="cpu", **RG_KW)
    else:
        out = region_grow(vol, seed, backend=grower, device="cpu", **RG_KW)
    np.testing.assert_array_equal(out.segmented_map.numpy(),
                                  np.asarray(ref.segmented_map))
    for f in ("iterations", "segmented_count", "stop_reason"):
        assert int(getattr(out, f)) == int(getattr(ref, f)), f


def test_speck_chunked_vesselness_matches_jax():
    rng = np.random.default_rng(0)
    vol = rng.normal(0.1, 0.05, (130, 20, 24)).astype(np.float32)
    vol[20:110, 8:12, 10:14] += 1.0
    vol[60:64, 2:18, 4:8] += 0.7
    kw = {"sigmas": chip_smoke.SPECK_CHUNK_SIGMAS,
          "chunk_z": chip_smoke.SPECK_CHUNK_Z}
    assert vol.shape[0] % kw["chunk_z"]
    ref = np.asarray(jv.frangi_vesselness_chunked(jnp.asarray(vol), **kw))
    out = tv.frangi_vesselness_chunked(torch.from_numpy(vol), **kw).numpy()
    assert out.shape == vol.shape
    # where one package's sign gate gives exactly 0 and the other's does
    # not (two eigenvalues of near-equal magnitude and opposite sign swap
    # their |lambda| order), the response jumps: there the drivers are
    # held to tests/test_torch_voxel_ops.py's 2e-4, everywhere else to
    # K1's bound
    jump = (out == 0) != (ref == 0)
    np.testing.assert_allclose(out[~jump], ref[~jump], rtol=1e-4, atol=1e-5)
    assert np.abs(out - ref)[jump].max(initial=0) <= 2e-4
    assert jump.sum() <= 1e-4 * jump.size


def test_speck_config_is_bench_speck_pipelines():
    """bench.py:508-523, field by field through convert.pipeline_config."""
    cfg = JaxPipelineConfig()
    cfg.vesselness.sigmas = (0.75, 1.0, 2.0, 3.0)
    cfg.vesselness.upload_format = "bq3"
    cfg.segmentation.global_threshold_fraction = 0.3
    cfg.segmentation.weak_threshold_fraction = 0.03
    cfg.segmentation.border_margin_voxels = 6
    cfg.segmentation.min_component_size = 50
    cfg.skeleton.backend = "native"
    cfg.skeleton.prune_min_length = 4
    cfg.flow.dtype = "float32"
    cfg.flow.linear_solver = "auto"
    assert dataclasses.asdict(chip_smoke.speck_config()) == \
        dataclasses.asdict(convert.pipeline_config(cfg))


def test_speck_k1_launch_counts():
    """The gates' counts: 4 scales x ceil(880 / 48) slabs per pipeline
    run, 3 scales x ceil(880 / 110) per chunked call."""
    sigmas = chip_smoke.speck_config().vesselness.sigmas
    Z = chip_smoke.SPECK_SHAPE[0]
    assert tv.k1_launches(Z, sigmas, tv.STREAMED_CHUNK_Z,
                          streamed=True) == 76
    assert tv.k1_launches(Z, chip_smoke.SPECK_CHUNK_SIGMAS,
                          chip_smoke.SPECK_CHUNK_Z) == 24
    assert tv.k1_launches(512, sigmas, tv.STREAMED_CHUNK_Z,
                          streamed=True) == 44


@pytest.mark.parametrize("driver,Z,sigmas,chunk_z", [
    ("streamed", 50, (0.75, 1.0, 2.0, 3.0), 48),
    ("streamed", 30, (4.0,), 8),            # a slab grown to its halo
    ("chunked", 25, (1.0, 2.0, 3.0), 11),
    ("chunked", 22, (1.0, 2.0, 3.0), 11)])
def test_k1_launches_count_the_twins_calls(monkeypatch, driver, Z, sigmas,
                                           chunk_z):
    calls = []
    twin = vesselness_fused.frangi_response_max_

    def counted(*args, **kwargs):
        calls.append(args[1])
        return twin(*args, **kwargs)

    monkeypatch.setattr(vesselness_fused, "frangi_response_max_", counted)
    vol = np.random.default_rng(1).normal(100.0, 4.0, (Z, 12, 16)).astype(
        np.float32)
    if driver == "streamed":
        tv.frangi_vesselness_streamed(vol, sigmas=sigmas, chunk_z=chunk_z,
                                      bits=12, device="cpu")
    else:
        tv.frangi_vesselness_chunked(torch.from_numpy(vol), sigmas=sigmas,
                                     chunk_z=chunk_z)
    assert len(calls) == tv.k1_launches(Z, sigmas, chunk_z,
                                        streamed=driver == "streamed")


_PEAK = """
import resource, sys
import numpy as np, torch
torch.set_num_threads(1)
from arterynetwork_tpu_torch.ops import vesselness as v
v.SLAB_VOXELS = 1 << 18
vol = torch.from_numpy(np.random.default_rng(0).normal(
    0, 1, (64, 256, 256)).astype(np.float32))
base = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
v.frangi_vesselness(vol, sigmas=(1.0, 2.0))
peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
print((peak - base) * 1024 / (4 * vol.numel()))
"""


def test_whole_volume_vesselness_peak_memory():
    """Input-sized f32 tensors held at once by frangi_vesselness (the
    process's peak resident memory over the volume's bytes) with 16
    slabs: the Hessian, the eigenvalues and norm, the volume and the
    running max (12), plus the slab temporaries."""
    out = subprocess.run([sys.executable, "-c", _PEAK], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert float(out.stdout) < 25


@pytest.mark.parametrize("shape", [(40, 24, 33), (37, 29, 31)])
def test_whole_volume_vesselness_slabs_are_bit_equal(monkeypatch, shape):
    vol = torch.from_numpy(np.random.default_rng(0).normal(
        0, 1, shape).astype(np.float32))
    whole = tv.frangi_vesselness(vol, sigmas=(1.0, 2.0))
    monkeypatch.setattr(tv, "SLAB_VOXELS", 3 * shape[1] * shape[2])
    assert torch.equal(tv.frangi_vesselness(vol, sigmas=(1.0, 2.0)), whole)
