"""Vessel-mask stage of the PyTorch port against the JAX reference.

Both ``generate_vessel_mask`` functions get the same vesselness volume,
computed by the JAX package, and must return voxel-identical masks —
hysteresis (thresholds, border margin and 2x any-pooled seeds on the
device, then the native seeded flood fill) and the plain single
threshold (then the native small-component drop).  Tolerance: exact.
"""

import numpy as np
import pytest
import torch

from arterynetwork_tpu.config import PipelineConfig
from arterynetwork_tpu.pipeline import generate_vessel_mask as jax_mask
from arterynetwork_tpu.pipeline import vesselness_stage
from arterynetwork_tpu.utils.phantoms import (phantom_raw_volume,
                                              vascular_tree_phantom)
from arterynetwork_tpu_torch import convert
from arterynetwork_tpu_torch.pipeline import generate_vessel_mask

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def vesselness():
    """JAX vesselness of a small branching phantom (bench scales)."""
    ph = vascular_tree_phantom((48, 64, 64), n_branches=12, root_radius=3.0,
                               branch_length=(12, 25), seed=1)
    cfg = PipelineConfig()
    cfg.vesselness.sigmas = (0.75, 1.0, 2.0, 3.0)
    cfg.vesselness.upload_format = "bq4"
    return np.array(vesselness_stage(phantom_raw_volume(ph), cfg))


def _config(kind):
    cfg = PipelineConfig()
    cfg.segmentation.global_threshold_fraction = 0.3
    cfg.segmentation.min_component_size = 20
    if kind == "hysteresis":   # the pipeline_512 segmentation
        cfg.segmentation.weak_threshold_fraction = 0.03
        cfg.segmentation.border_margin_voxels = 6
        cfg.segmentation.min_component_size = 50
    elif kind == "plain_margin":
        cfg.segmentation.border_margin_voxels = 3
    return cfg


@pytest.mark.parametrize("crop", [None, (39, 61, 57)])
@pytest.mark.parametrize("kind", ["hysteresis", "plain", "plain_margin"])
def test_mask_matches_jax(vesselness, kind, crop):
    """``crop`` makes every extent odd, so the 2x pooling has ragged
    edges."""
    v = vesselness if crop is None else np.ascontiguousarray(
        vesselness[:crop[0], :crop[1], :crop[2]])
    cfg = _config(kind)
    ref = np.array(jax_mask(v, config=cfg))   # the JAX result is scratch
    out = generate_vessel_mask(v, config=convert.pipeline_config(cfg),
                               device="cpu")
    assert out.dtype == np.uint8 and out.shape == v.shape
    assert ref.sum() > 500
    np.testing.assert_array_equal(out, ref)


def test_unported_options_raise(vesselness):
    cfg = convert.pipeline_config(_config("hysteresis"))
    with pytest.raises(NotImplementedError):
        generate_vessel_mask(vesselness, brain_mask=np.ones_like(vesselness),
                             config=cfg, device="cpu")
    cfg.segmentation.tip_fraction = 0.01
    with pytest.raises(NotImplementedError):
        generate_vessel_mask(vesselness, config=cfg, device="cpu")
