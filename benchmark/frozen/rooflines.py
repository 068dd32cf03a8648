"""Frozen peaks and the work of a kernel launch, for roofline shares.

Peaks: NVIDIA H100 SXM data sheet at 700 W (HBM 3.35 TB/s, float32
outside the tensor cores 67 TFLOP/s), as chip_smoke.py:311-312 states
them.

K1 (csrc/frangi_response.cu, one launch per slab and scale of the
streamed vesselness driver): chip_smoke.py:591-627 (``_k1_slab``) counts
per launch the smoothed rows it reads (the chunk and one row beyond each
end, within a slab of chunk + 2 halo rows) and the running maximum read
and written, 4 bytes each, and 125 float32 operations per output voxel
(chip_smoke.py:313-315).  The slab geometry is the streamed driver's
(ops/vesselness.py:183-191, ``slab_plan``): halo = ceil(3 max sigma) + 1,
chunk = max(48, halo).
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
K1_OPS_PER_VOXEL = 125
K1_KERNEL = "frangi_response_max_kernel"


def k1_launch(shape, sigmas, chunk_z=48):
    """(bytes, float32 operations) of one K1 launch on a volume of
    ``shape`` (z, y, x)."""
    halo = int(math.ceil(3.0 * max(sigmas))) + 1
    chunk = max(chunk_z, halo)
    plane = int(shape[1]) * int(shape[2])
    zs = chunk + 2 * halo
    rows = min(halo + chunk + 1, zs) - max(halo - 1, 0)
    return 4 * plane * (rows + 2 * chunk), K1_OPS_PER_VOXEL * plane * chunk


def bound_s(nbytes, ops):
    """The least time the card could take: bytes or operations."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)
