"""Port of arterynetwork_tpu/ops/region_grow_fused.py: the fused full-grid
region-grow sweep (K2) and the grower around it.

One kernel launch per iteration computes, in a single pass over the
volume, what the full-grid path spreads over separate passes:

  boundary mask -> flip decision -> new segmentation -> +/- histogram
  DELTAS of the flipped voxels

The region histograms change only at flipped voxels, so the grower
carries ``inner_hist`` across iterations and adds the sweep's deltas in
place of a full-volume histogram pass.  The decision math is the
full-grid path's: the same quantisation, the same ``K @ hist`` table
between sweeps, the same >= tie rule, with the table's sign bits packed
into 8 words.

``fused_sweep_counts`` is the kernel's wrapper: CUDA tensors launch
``csrc/region_grow_sweep.cu`` (or raise), CPU tensors run
``fused_sweep_plain``; ``fused_sweep_counts.launches`` counts launches.
The JAX package's TPU layout (transposes, 8/128 padding, bf16 wire) is
dropped: seg and bins are uint8 in the natural (Z, Y, X) order.
``fused_sweep_banded`` and ``fused_sweep_banded_dma`` keep their JAX
contracts, a padded (Z, Yp, Xp) volume with ``valid_yx`` and ``band``,
and run the same kernel over the valid region.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .histogram import masked_histogram_one
from .region_grow import (DEFAULT_H, DEFAULT_ITER_MAX,
                          DEFAULT_MAX_SEGMENT_SIZE, RegionGrowResult,
                          _as_device, _bin_ids, _decision_table,
                          _gaussian_kernel, _quantize, _resolve_device,
                          _stop_code)
from .stencil import dilate26

NUM_BINS = 256
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _kernel_lib():
    return cuda_build.load("region_grow_sweep", region_grow_sweep=[
        _P, _P, _P, _P, _I, _I, _I, _LL, _LL, _P, _P])


def pack_sign_words(table):
    """f32[32 W] decision table -> int32[W] packed (table >= 0) bits, bit
    j of word w for bin 32 w + j (LSB first)."""
    bits = (table >= 0).to(torch.int64).reshape(-1, 32)
    words = torch.sum(bits << torch.arange(32, device=table.device), dim=1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32,
                       words).to(torch.int32)


def _unpack_bits(words, bins):
    """Decision bit of each voxel's bin from the packed words."""
    b = bins.to(torch.int64)
    return ((words.to(torch.int64)[b >> 5] >> (b & 31)) & 1).to(torch.bool)


def _region(t, valid_yx):
    if valid_yx is None:
        return t
    return t[:, :valid_yx[0], :valid_yx[1]]


def fused_sweep_plain(seg, idx, sign_words, valid_yx=None):
    """Plain PyTorch version of the K2 launch (same signature): dilate26
    of the valid region + decision bits + xor + bincount deltas.  Returns
    (seg_new uint8 of ``seg``'s shape, pads zero; int32[2, 256] counts of
    flips of unsegmented / segmented voxels by bin)."""
    s = _region(seg, valid_yx) != 0
    b = _region(idx, valid_yx)
    flips = dilate26(s) & dilate26(~s) & (s ^ _unpack_bits(sign_words, b))
    out = torch.zeros_like(seg)
    _region(out, valid_yx).copy_(s ^ flips)
    bl = b.to(torch.int64)
    dh = torch.stack([
        torch.bincount(bl[flips & ~s], minlength=NUM_BINS),
        torch.bincount(bl[flips & s], minlength=NUM_BINS)])
    return out, dh.to(torch.int32)


def _check(seg, idx, sign_words, valid_yx):
    if seg.dim() != 3 or tuple(seg.shape) != tuple(idx.shape):
        raise ValueError(f"seg and idx must be one (Z, Y, X) shape, got "
                         f"{tuple(seg.shape)} and {tuple(idx.shape)}")
    if seg.dtype != torch.uint8 or idx.dtype != torch.uint8:
        raise ValueError(f"seg and idx must be uint8, got {seg.dtype}, "
                         f"{idx.dtype}")
    if sign_words.numel() != NUM_BINS // 32:
        raise ValueError("sign_words must hold 8 words (256 bins)")
    if valid_yx is not None and not (0 <= valid_yx[0] <= seg.shape[1]
                                     and 0 <= valid_yx[1] <= seg.shape[2]):
        raise ValueError(f"valid_yx {valid_yx} beyond {tuple(seg.shape)}")
    if not (seg.device == idx.device == sign_words.device):
        raise ValueError("seg, idx and sign_words on different devices")
    if seg.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no sweep kernel for {seg.device}")
    if not (seg.is_contiguous() and idx.is_contiguous()):
        raise ValueError("seg and idx must be contiguous")


def fused_sweep_counts(seg, idx, sign_words, valid_yx=None):
    """One region-grow sweep over the valid region (Z, Y0, X0) of a
    (Z, Y, X) uint8 volume -> (seg_new uint8, pads zero; dh int32[2, 256]:
    flips of unsegmented voxels (+) and of segmented voxels (-) by bin).
    CPU tensors take ``fused_sweep_plain``; CUDA tensors launch K2."""
    _check(seg, idx, sign_words, valid_yx)
    if seg.device.type == "cpu":
        return fused_sweep_plain(seg, idx, sign_words, valid_yx)
    lib = _kernel_lib()
    Z, Y, X = seg.shape
    Y0, X0 = valid_yx if valid_yx is not None else (Y, X)
    padded = (Y0, X0) != (Y, X)
    out = torch.zeros_like(seg) if padded else torch.empty_like(seg)
    dh = torch.zeros((2, NUM_BINS), dtype=torch.int32, device=seg.device)
    words = sign_words.to(torch.int32).contiguous()
    with torch.cuda.device(seg.device):
        rc = lib.region_grow_sweep(
            seg.data_ptr(), idx.data_ptr(), out.data_ptr(),
            words.data_ptr(), Z, int(Y0), int(X0), Y * X, X, dh.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    cuda_build.check(rc, "region_grow_sweep")
    fused_sweep_counts.launches += 1
    return out, dh


fused_sweep_counts.launches = 0


def _hist16(dh):
    """int32[2, 256] counts -> the JAX contract's (hp, hn) f32[16, 16]
    (bin = 16 * row + column)."""
    h = dh.to(torch.float32).reshape(2, 16, 16)
    return h[0], h[1]


def fused_sweep(seg_t, idx_t, sign_words, valid_yx=None):
    """One region-grow sweep over a (Z, Y, X) uint8 volume -> (seg_new
    uint8, hist_pos f32[16, 16], hist_neg f32[16, 16]), bin = 16*hi + lo
    row-major.  ``valid_yx`` = (Y0, X0) true extents when Y/X are
    padded; pad voxels never flip and come back zero."""
    seg_new, dh = fused_sweep_counts(seg_t, idx_t, sign_words, valid_yx)
    return (seg_new, *_hist16(dh))


def fused_sweep_banded(seg_t, idx_t, sign_words, valid_yx=None,
                       band: int = 128):
    """The JAX package's large-tile sweep contract (z-slices x y-bands, a
    VMEM workaround): ``seg_t`` is (Z, Yp, Xp) with Yp % band == 0.  The
    port runs K2 over the valid region; the result equals
    ``fused_sweep``'s."""
    Z, Y, X = seg_t.shape
    if Y % band or band % 8:
        raise ValueError(f"banded sweep needs Y % band == 0 and band % 8 "
                         f"== 0, got Y={Y}, band={band}")
    return fused_sweep(seg_t, idx_t, sign_words, valid_yx)


def fused_sweep_banded_dma(seg_t, idx_t, sign_words, valid_yx=None,
                           band: int = 128):
    """The JAX package's manual-DMA banded sweep contract: as
    ``fused_sweep_banded``, and Yp >= band + 16 (two or more bands)."""
    if seg_t.shape[1] < band + 16:
        raise ValueError(f"banded DMA sweep needs Y >= band + 16, got "
                         f"Y={seg_t.shape[1]}, band={band}")
    return fused_sweep_banded(seg_t, idx_t, sign_words, valid_yx, band)


def region_grow_fused(data, seed_mask, H: float = DEFAULT_H,
                      max_segment_size: int = DEFAULT_MAX_SEGMENT_SIZE,
                      iter_max: int = DEFAULT_ITER_MAX,
                      device=None) -> RegionGrowResult:
    """Full-grid region growing with the fused sweep (same fixed point as
    the full-grid path with ``excluded_mask=None``, 256 bins), on
    ``device`` (by default the device of a ``data`` tensor; host arrays go
    to the card).  Always f32, as the JAX grower traces under x32."""
    device = _resolve_device(data, device)
    data = _as_device(data, device).to(torch.float32)
    seg0 = _as_device(seed_mask, device, torch.bool)

    bin_idx, bin_values = _quantize(data, NUM_BINS)
    bins = _bin_ids(bin_idx, NUM_BINS).contiguous()
    bins_flat = bins.reshape(-1)
    K = _gaussian_kernel(bin_values, H, torch.float32)
    hist_all = masked_histogram_one(
        bins_flat, torch.ones_like(bins_flat, dtype=torch.bool), NUM_BINS)
    inner = masked_histogram_one(bins_flat, seg0.reshape(-1),
                                 NUM_BINS).to(torch.int32)

    seg = seg0.to(torch.uint8).contiguous()
    count = torch.sum(seg0, dtype=torch.int32)
    it = torch.zeros((), dtype=torch.int32, device=data.device)
    stop = torch.where(count >= max_segment_size, 1, -1).to(torch.int32)
    while int(stop) < 0:
        inner_f = inner.to(torch.float32)
        diff = _decision_table(K, inner_f, hist_all - inner_f)
        seg, dh = fused_sweep_counts(seg, bins, pack_sign_words(diff))
        n_pos, n_neg = dh.sum(dim=1, dtype=torch.int32)
        converged = (n_pos + n_neg) == 0
        inner = inner + dh[0] - dh[1]
        count = count + n_pos - n_neg
        it = it + (~converged).to(torch.int32)
        stop = _stop_code(converged, count >= max_segment_size, it,
                          iter_max)
    seg = seg != 0
    return RegionGrowResult(segmented_map=seg,
                            active_map=torch.ones_like(seg),
                            iterations=it, segmented_count=count,
                            stop_reason=stop)
