"""Port of arterynetwork_tpu/ops/histogram.py: masked intensity histograms
and per-voxel table reads for the region grower.

The JAX package picks a strategy per backend (one-hot matmuls and packed
sign words on the TPU, where scatters and gathers are slow; scatter-add
elsewhere).  Those TPU workarounds give exact results, so the port drops
them: histograms go to the K6 kernels on CUDA tensors and to
``torch.bincount`` on CPU tensors (ops/histogram_kernels.py), and the
lookups to the K7 kernel on CUDA tensors and to a gather on CPU tensors
(ops/lookup_kernels.py).  Counts are exact int32 cast to f32 once; the
JAX CPU path and the TPU kernels count in f32 and so stop counting
exactly at 2^24 per bin (ROADMAP.md, queue 3).
"""

from __future__ import annotations

import torch

from .histogram_kernels import masked_histogram1, masked_histograms2
from .lookup_kernels import sign_lookup, table_lookup  # noqa: F401


def masked_histograms(bin_idx_flat, masks_flat, num_bins: int = 256):
    """Histograms of ``bin_idx`` under K boolean masks -> f32[K, num_bins]
    (one kernel pass per pair of masks)."""
    parts = []
    for k in range(0, masks_flat.shape[0], 2):
        if k + 1 < masks_flat.shape[0]:
            parts.append(masked_histograms2(bin_idx_flat,
                                            masks_flat[k:k + 2], num_bins))
        else:
            parts.append(masked_histogram1(bin_idx_flat, masks_flat[k],
                                           num_bins)[None])
    return torch.cat(parts)


# the JAX package routes two masks to the TPU kernel here; the port's
# masked_histograms already does
masked_histograms_best = masked_histograms


def masked_histogram_one(bin_idx_flat, mask_flat, num_bins: int = 256):
    """Single-mask histogram -> f32[num_bins]."""
    return masked_histogram1(bin_idx_flat, mask_flat, num_bins)
