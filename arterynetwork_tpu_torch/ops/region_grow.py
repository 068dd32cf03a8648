"""Port of arterynetwork_tpu/ops/region_grow.py: variational region growing
over the full grid.

The reference ``variationalRegionGrowing`` (variationalRegionGrowing.py:
10-282) is a Parzen/Gaussian two-region competition; the JAX package
recasts each iteration as full-grid array work, and the port keeps its
math and its operation order:

1. region statistics by histogram: intensities quantised to B bins, the
   per-bin Gaussian sums one BxB matvec, ``K @ hist``;
2. boundary = the mixed 27-neighbourhood (``dilate26``), or, with an
   excluded mask, the inner/outer boundaries of the reference's states;
3. flip where ``xor(seg, diff[bin] >= 0)`` on the boundary, with
   diff = innerProbNorm - outerProbNorm (the reference's >= tie rule);
4. excluded voxels (reference state 4) join the outer region when the
   front comes within two hops.

Termination as in the reference (:91-104): no flips, the size cap, or the
iteration cap.  The JAX ``while_loop`` becomes one step function that
updates the state in place, run by ops/grow_loop.py: on a card captured
once as a CUDA graph and run, with the loop's condition, by one launch
of a graph with a conditional WHILE node (the stop code read
min(passes, 2) + 1 times); on the CPU a host loop that reads it once per
iteration.

``backend``: "auto" takes the fused sweep (ops/region_grow_fused.py, the
K2 kernel, in f32) for f32 data on a CUDA device with no excluded mask
and 256 bins, at any shape; otherwise (f64 data too, which stays f64),
and always on the CPU, the full-grid path
``_region_grow_xla`` (on CUDA its histograms go to the K6 kernels and its
sign lookup to K7).  "xla" and "fused" force one or the other.

Every entry runs on the card by default: host arrays go to "cuda" unless
``device`` says otherwise, and a tensor stays on its own device (a CPU
tensor is the caller asking for the CPU).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import grow_loop
from .histogram import (masked_histogram_one, masked_histograms_best,
                        sign_lookup)
from .stencil import dilate26

# Gaussian normalization constant (variationalRegionGrowing.py:7).
A_NORM = float((2.0 * np.pi) ** -0.5)

DEFAULT_H = 2.25
DEFAULT_MAX_SEGMENT_SIZE = 5000
DEFAULT_ITER_MAX = 200


@dataclasses.dataclass(frozen=True)
class RegionGrowResult:
    segmented_map: torch.Tensor    # bool[shape]
    active_map: torch.Tensor       # bool[shape]; ~active == reference state 4
    iterations: torch.Tensor       # int32 scalar: number of applied updates
    segmented_count: torch.Tensor  # int32 scalar
    stop_reason: torch.Tensor      # int32: 0=converged, 1=size cap, 2=iter cap


def _quantize(data, num_bins, vmin=None, vmax=None):
    """(bin ids int32, bin values) of ``data``, in the JAX package's
    operation order (round half to even).  ``vmin``/``vmax`` default to
    the data's own; a shard of a volume passes the volume's."""
    vmin = torch.min(data) if vmin is None else vmin
    vmax = torch.max(data) if vmax is None else vmax
    span = torch.clamp(vmax - vmin, min=1e-30)
    last = torch.tensor(num_bins - 1, dtype=data.dtype, device=data.device)
    idx = torch.clamp(torch.round((data - vmin) / span * last),
                      0, num_bins - 1).to(torch.int32)
    values = vmin + torch.arange(num_bins, dtype=data.dtype,
                                 device=data.device) * span / last
    return idx, values


def _bin_ids(bin_idx, num_bins):
    """The kernels' bin format: uint8 when the bins fit a byte."""
    return bin_idx.to(torch.uint8) if num_bins <= 256 else bin_idx


def _gaussian_kernel(bin_values, H, dtype):
    """BxB Gaussian kernel between bin values, A * exp(-H/2 d^2), with the
    factor -H/2 rounded to ``dtype`` as JAX's weak-typed scalar is."""
    diff = bin_values[:, None] - bin_values[None, :]
    c = torch.tensor(-0.5 * H, dtype=dtype, device=diff.device)
    return (A_NORM * torch.exp(c * diff * diff)).to(dtype)


def _decision_table(K, inner_hist, outer_hist):
    """diff(b) = innerProbNorm(b) - outerProbNorm(b) (reference :79-88)."""
    one = torch.ones((), dtype=inner_hist.dtype, device=inner_hist.device)
    inner_size = torch.maximum(torch.sum(inner_hist), one)
    outer_size = torch.maximum(torch.sum(outer_hist), one)
    return (K @ inner_hist) / inner_size - (K @ outer_hist) / outer_size


def _stop_code(converged, size_capped, it_new, iter_max):
    """0 converged, 1 size cap, 2 iteration cap, -1 go on (device ops)."""
    return torch.where(converged & ~size_capped, 0,
                       torch.where(size_capped, 1,
                                   torch.where(it_new >= iter_max, 2, -1))
                       ).to(torch.int32)


def _as_device(x, device, dtype=None):
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                           dtype=dtype, device=device)


def _resolve_device(data, device):
    """``device`` if given, else the device of a tensor, else the card."""
    if device is not None:
        return torch.device(device)
    return data.device if torch.is_tensor(data) else torch.device("cuda")


def _use_fused(backend, data, excluded_mask, num_bins, device) -> bool:
    """Whether ``region_grow`` takes the fused grower, which computes in
    f32: always for ``backend="fused"``; for "auto" only on a CUDA device,
    with f32 3-D data, no excluded mask and 256 bins.  f64 data stays on
    the full-grid path in f64, as the JAX package runs it off a TPU."""
    if backend == "fused":
        return True
    return (backend == "auto" and excluded_mask is None and data.dim() == 3
            and num_bins == 256 and device.type == "cuda"
            and data.dtype != torch.float64)


def region_grow(data, seed_mask, excluded_mask=None, H: float = DEFAULT_H,
                max_segment_size: int = DEFAULT_MAX_SEGMENT_SIZE,
                iter_max: int = DEFAULT_ITER_MAX, num_bins: int = 256,
                backend: str = "auto", device=None) -> RegionGrowResult:
    """Grow a region from ``seed_mask`` over ``data`` on ``device`` (by
    default the device of a ``data`` tensor; host arrays go to the card).

    Parameters mirror the reference: ``H`` controls segmentation size
    (larger H -> smaller segmentation), ``max_segment_size`` and
    ``iter_max`` cap the growth (variationalRegionGrowing.py:10, 56).
    ``excluded_mask`` marks reference state-4 voxels."""
    device = _resolve_device(data, device)
    data = _as_device(data, device)
    if data.dtype != torch.float64:
        data = data.to(torch.float32)
    seed_mask = _as_device(seed_mask, device, torch.bool)
    if excluded_mask is not None:
        excluded_mask = _as_device(excluded_mask, device, torch.bool)
    if _use_fused(backend, data, excluded_mask, num_bins, device):
        if excluded_mask is not None or num_bins != 256:
            raise ValueError(
                "backend='fused' supports neither excluded_mask nor "
                "num_bins != 256 — use backend='xla' (or 'auto', which "
                "only picks the fused kernel when both are default)")
        from .region_grow_fused import region_grow_fused
        return region_grow_fused(data, seed_mask, H=H,
                                 max_segment_size=max_segment_size,
                                 iter_max=iter_max, device=device)
    return _region_grow_xla(data, seed_mask, excluded_mask, H,
                            max_segment_size, iter_max, num_bins)


def _region_grow_xla(data, seed_mask, excluded_mask=None,
                     H: float = DEFAULT_H,
                     max_segment_size: int = DEFAULT_MAX_SEGMENT_SIZE,
                     iter_max: int = DEFAULT_ITER_MAX,
                     num_bins: int = 256) -> RegionGrowResult:
    """Full-grid path (the JAX package's XLA path), in the data's dtype
    (f64 stays f64, anything else is f32)."""
    dtype = torch.float64 if data.dtype == torch.float64 else torch.float32
    data = data.to(dtype)
    seg = seed_mask.to(torch.bool, copy=True)   # the loop's, in place
    track_active = excluded_mask is not None
    if track_active:
        active = ~excluded_mask.to(torch.bool)
    else:
        active = torch.ones_like(seg)
    # Initial update: the front activates excluded voxels it touches
    # (reference :137 runs during the initial boundary build).
    active = active | dilate26(seg)

    bin_idx, bin_values = _quantize(data, num_bins)
    bins = _bin_ids(bin_idx, num_bins)
    bins_flat = bins.reshape(-1)
    K = _gaussian_kernel(bin_values, H, dtype)

    # With no excluded voxels the active mask is identically True: skip
    # its dilations, and outer_hist = total_hist - inner_hist.
    if not track_active:
        hist_all = masked_histogram_one(
            bins_flat, torch.ones_like(bins_flat, dtype=torch.bool),
            num_bins).to(dtype)

    def compute_flips(seg, active):
        if track_active:
            inner_bnd = seg & dilate26(~seg)
            outer_bnd = (~seg) & active & dilate26(seg)
            all_bnd = inner_bnd | outer_bnd
            hists = masked_histograms_best(
                bins_flat, torch.stack([seg.reshape(-1),
                                        ((~seg) & active).reshape(-1)]),
                num_bins)
            inner_hist = hists[0].to(dtype)
            outer_hist = hists[1].to(dtype)
        else:
            # boundary = mixed 27-neighbourhood
            all_bnd = dilate26(seg) & dilate26(~seg)
            inner_hist = masked_histogram_one(
                bins_flat, seg.reshape(-1), num_bins).to(dtype)
            outer_hist = hist_all - inner_hist
        diff = _decision_table(K, inner_hist, outer_hist)
        return all_bnd & torch.logical_xor(seg, sign_lookup(bins, diff))

    count = torch.sum(seg, dtype=torch.int32)
    it = torch.zeros((), dtype=torch.int32, device=data.device)
    # a seed already at/over the size cap never updates (reference
    # semantics: the capped state is returned unmodified)
    stop = torch.where(count >= max_segment_size, 1, -1).to(torch.int32)

    def step():                 # seg, active, count, it, stop in place
        # unconditional apply + post-checked size cap: the state that
        # first reaches the cap is final (reference :101-104)
        flips = compute_flips(seg, active)
        n_pos = torch.sum(flips & ~seg, dtype=torch.int32)
        n_neg = torch.sum(flips & seg, dtype=torch.int32)
        converged = (n_pos + n_neg) == 0
        seg.logical_xor_(flips)                   # no-op when converged
        if track_active:                          # flips are empty then too
            active.logical_or_(dilate26(dilate26(flips)))
        count.add_(n_pos).sub_(n_neg)
        it.add_((~converged).to(torch.int32))
        stop.copy_(_stop_code(converged, count >= max_segment_size, it,
                              iter_max))

    grow_loop.drive([step], stop)
    return RegionGrowResult(segmented_map=seg, active_map=active,
                            iterations=it, segmented_count=count,
                            stop_reason=stop)


# ----------------------------------------------------------------------
# Reference-style API (valueMap in, valueMap out)
# ----------------------------------------------------------------------
def region_grow_value_map(data, value_map, H=DEFAULT_H,
                          max_segment_size=DEFAULT_MAX_SEGMENT_SIZE,
                          iter_max=DEFAULT_ITER_MAX, num_bins=256,
                          device="cuda"):
    """Drop-in equivalent of ``variationalRegionGrowing(dataArray,
    valueMap)``, on ``device`` (the card unless the caller asks for the
    CPU).

    ``value_map`` uses the reference encoding — 0: inside, 1: inner
    boundary, 2: outer boundary, 3: outside, 4: excluded — and the
    function returns ``(segmented_coords, segmented_map, value_map)``
    like the reference (variationalRegionGrowing.py:27-36), as numpy."""
    vm_in = _as_device(value_map, device)
    res = region_grow(data, (vm_in == 0) | (vm_in == 1), vm_in == 4, H=H,
                      max_segment_size=max_segment_size, iter_max=iter_max,
                      num_bins=num_bins, device=device)
    vm = reconstruct_value_map(res.segmented_map, res.active_map, device)
    seg = res.segmented_map.cpu().numpy()
    return np.argwhere(seg), seg.astype(np.int64), vm


def reconstruct_value_map(seg, active, device=None):
    """Rebuild the reference's 5-state valueMap from the two masks, on
    ``device`` (by default the device of a ``seg`` tensor, else the
    card) -> numpy int64."""
    device = _resolve_device(seg, device)
    seg_t = _as_device(seg, device, torch.bool)
    active_t = _as_device(active, device, torch.bool)
    inner_bnd = seg_t & dilate26(~seg_t)
    outer_bnd = (~seg_t) & active_t & dilate26(seg_t)
    # built in uint8 on the device (4 - active: 3 where active, else 4),
    # widened to int64 on the host
    vm = torch.where(seg_t, inner_bnd.to(torch.uint8),
                     torch.where(outer_bnd, 2,
                                 4 - active_t.to(torch.uint8)))
    return vm.cpu().numpy().astype(np.int64)
