"""Masked-histogram kernels (K6a, K6b): 256-bin histograms of uint8 bin
ids under one or two masks.

Counterparts of the JAX package's Pallas kernels in ops/pallas_kernels.py:
``_hist1_kernel`` (``masked_histogram1_pallas``, K6b) and
``_hist2_kernel`` (``masked_histograms_pallas``, K6a).  Both entries
share one CUDA source, ``csrc/histogram.cu``:

  * for CUDA tensors they launch the hand-written kernel (built with nvcc
    for sm_90a at first use, into ``build/kernels/``) on the current
    stream, or raise;
  * for CPU tensors they run ``masked_histograms_plain``, the plain
    PyTorch version (``torch.bincount`` of the masked bins).

Counts are exact integers (64-bit in the kernel's global histogram: a
bin may hold 2^31 voxels or more), cast to f32 once: the TPU kernels and
the JAX CPU path (f32 scatter-add) stop counting exactly at 2^24 per
bin.  ``masked_histogram1.launches`` and ``masked_histograms2.launches``
count kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

MAX_BINS = 256
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _kernel_lib():
    return cuda_build.load("histogram", masked_histograms_u8=[
        _P, _P, _P, _LL, _I, _I, _P, _I, _P])


def masked_histograms_plain(bins, masks, num_bins=256,
                            dtype=torch.float32):
    """[K, num_bins] histograms of the flat ``bins`` under the K rows of
    the bool ``masks`` (K, N): ``torch.bincount`` of the masked bins,
    counted exactly, cast to ``dtype`` once."""
    bins = bins.reshape(-1).long()
    return torch.stack([
        torch.bincount(bins[m.reshape(-1)], minlength=num_bins)[:num_bins]
        for m in masks]).to(dtype)


def _check(bins, masks, num_bins):
    if bins.dim() != 1 or masks.dim() != 2 \
            or masks.shape[1] != bins.shape[0]:
        raise ValueError(f"bins must be (N,) and masks (K, N), got "
                         f"{tuple(bins.shape)} and {tuple(masks.shape)}")
    if masks.dtype != torch.bool:
        raise ValueError(f"masks must be bool, got {masks.dtype}")
    if bins.device != masks.device:
        raise ValueError(f"bins on {bins.device}, masks on {masks.device}")
    if bins.device.type == "cpu":
        return
    if bins.device.type != "cuda":
        raise ValueError(f"no histogram kernel for {bins.device}")
    if bins.dtype != torch.uint8 or not 0 < num_bins <= MAX_BINS:
        raise ValueError(f"the kernel takes uint8 bins and at most "
                         f"{MAX_BINS} bins, got {bins.dtype}, {num_bins}")
    if not (bins.is_contiguous() and masks.is_contiguous()):
        raise ValueError("bins and masks must be contiguous")


def _launch(bins, masks, num_bins, dtype=torch.float32):
    """The kernel's counts as ``dtype`` (no launch for an empty volume)."""
    k = masks.shape[0]
    out = torch.zeros((k, num_bins), dtype=torch.int64, device=bins.device)
    n = bins.shape[0]
    if not n:
        return out.to(dtype)
    lib = _kernel_lib()
    with torch.cuda.device(bins.device):
        n_sm = torch.cuda.get_device_properties(
            bins.device).multi_processor_count
        rc = lib.masked_histograms_u8(
            bins.data_ptr(), masks.data_ptr(),
            masks.data_ptr() + n * (k - 1), n, k, int(num_bins),
            out.data_ptr(), n_sm, torch.cuda.current_stream().cuda_stream)
    cuda_build.check(rc, "masked_histograms_u8")
    return out.to(dtype)


def masked_histogram1(bins, mask, num_bins=256, dtype=torch.float32):
    """K6b: [num_bins] histogram of the flat ``bins`` under one bool
    ``mask`` (N,), as ``dtype`` (f32; int32 or int64 keep the exact
    counts, which a sum over shards needs)."""
    masks = mask.reshape(1, -1)
    _check(bins, masks, num_bins)
    if bins.device.type == "cpu":
        return masked_histograms_plain(bins, masks, num_bins, dtype)[0]
    out = _launch(bins, masks, num_bins, dtype)[0]
    masked_histogram1.launches += bool(bins.shape[0])
    return out


def masked_histograms2(bins, masks, num_bins=256):
    """K6a: f32[2, num_bins] histograms of the flat ``bins`` under the two
    rows of the bool ``masks`` (2, N), in one pass."""
    _check(bins, masks, num_bins)
    if masks.shape[0] != 2:
        raise ValueError(f"masked_histograms2 takes two masks, got "
                         f"{masks.shape[0]}")
    if bins.device.type == "cpu":
        return masked_histograms_plain(bins, masks, num_bins)
    out = _launch(bins, masks, num_bins)
    masked_histograms2.launches += bool(bins.shape[0])
    return out


masked_histogram1.launches = 0
masked_histograms2.launches = 0
