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
Both take an interior ``window`` of the region: the rule reads the whole
region, but only window voxels may flip and be counted; and ``out=`` /
``dh=``, buffers the caller owns, so that a call allocates nothing.  The
sharded grower (parallel/sharded.py) sweeps each halo-padded shard over
the voxels it owns so, into a second padded buffer.
The JAX package's TPU layout (transposes, 8/128 padding, bf16 wire) is
dropped: seg and bins are uint8 in the natural (Z, Y, X) order.
``fused_sweep_banded`` and ``fused_sweep_banded_dma`` keep their JAX
contracts, a padded (Z, Yp, Xp) volume with ``valid_yx`` and ``band``,
and run the same kernel over the valid region.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build, grow_loop
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
        _P, _P, _P, _P, _I, _I, _I, _LL, _LL, _I, _I, _I, _I, _I, _I, _P,
        _P])


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


def _window_mask(shape, window, device):
    """bool ``shape``, True on the window ((z0, z1), (y0, y1), (x0, x1))."""
    m = torch.zeros(shape, dtype=torch.bool, device=device)
    m[tuple(slice(lo, hi) for lo, hi in window)] = True
    return m


def fused_sweep_plain(seg, idx, sign_words, valid_yx=None, window=None,
                      *, out=None, dh=None):
    """Plain PyTorch version of the K2 launch (same signature): dilate26
    of the valid region + decision bits + xor + bincount deltas, flips
    only inside ``window`` (default: the whole region).  Returns (seg_new
    uint8 of ``seg``'s shape: ``seg != 0`` with the flips applied, pads
    zero; int32[2, 256] counts of flips of unsegmented / segmented voxels
    by bin).  Of a windowed sweep only the window's voxels are the
    kernel's contract; elsewhere this returns ``seg != 0``.  With
    ``out``, seg_new is written there as the kernel writes it: the
    window's rows of its planes (over the valid x), nothing else; with
    ``dh``, the counts are added into it."""
    s = _region(seg, valid_yx) != 0
    b = _region(idx, valid_yx)
    flips = dilate26(s) & dilate26(~s) & (s ^ _unpack_bits(sign_words, b))
    if window is not None:
        flips &= _window_mask(s.shape, window, s.device)
    new = torch.zeros_like(seg)
    _region(new, valid_yx).copy_(s ^ flips)
    bl = b.to(torch.int64)
    counts = torch.stack([
        torch.bincount(bl[flips & ~s], minlength=NUM_BINS),
        torch.bincount(bl[flips & s], minlength=NUM_BINS)]).to(torch.int32)
    if out is not None:
        (z0, z1), (y0, y1) = (window or ((0, s.shape[0]),
                                         (0, s.shape[1])))[:2]
        rows = (slice(z0, z1), slice(y0, y1), slice(0, s.shape[2]))
        out[rows] = new[rows]
        new = out
    if dh is not None:
        dh += counts
        counts = dh
    return new, counts


def _check(seg, idx, sign_words, valid_yx, window):
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
    if window is not None:
        extent = (seg.shape[0], *(valid_yx or seg.shape[1:]))
        if len(window) != 3 or not all(
                0 <= lo <= hi <= n for (lo, hi), n in zip(window, extent)):
            raise ValueError(f"window {window} is not ((z0, z1), (y0, y1), "
                             f"(x0, x1)) inside the region {extent}")
    if not (seg.device == idx.device == sign_words.device):
        raise ValueError("seg, idx and sign_words on different devices")
    if seg.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no sweep kernel for {seg.device}")
    if not (seg.is_contiguous() and idx.is_contiguous()):
        raise ValueError("seg and idx must be contiguous")


def _check_into(seg, out, dh):
    if out is not None and not (
            out.shape == seg.shape and out.dtype == torch.uint8
            and out.device == seg.device and out.is_contiguous()):
        raise ValueError("out must be a contiguous uint8 tensor of seg's "
                         "shape on seg's device")
    if out is not None and out.data_ptr() == seg.data_ptr():
        raise ValueError("out must not be seg: a sweep reads the old state "
                         "while it writes the new one")
    if dh is not None and not (
            tuple(dh.shape) == (2, NUM_BINS) and dh.dtype == torch.int32
            and dh.device == seg.device and dh.is_contiguous()):
        raise ValueError(f"dh must be a contiguous int32 (2, {NUM_BINS}) "
                         f"tensor on seg's device")


def _launch_args(seg, idx, words, valid_yx, window, out, dh):
    """``region_grow_sweep``'s arguments for checked CUDA tensors, the
    window given in full and ``words`` int32."""
    Z, Y, X = seg.shape
    (z0, z1), (y0, y1), (x0, x1) = window
    return (seg.data_ptr(), idx.data_ptr(), out.data_ptr(),
            words.data_ptr(), Z, int(valid_yx[0]), int(valid_yx[1]), Y * X,
            X, int(z0), int(z1), int(y0), int(y1), int(x0), int(x1),
            dh.data_ptr(),
            torch.cuda.current_stream(seg.device).cuda_stream)


def fused_sweep_counts(seg, idx, sign_words, valid_yx=None, window=None,
                       *, out=None, dh=None):
    """One region-grow sweep over the valid region (Z, Y0, X0) of a
    (Z, Y, X) uint8 volume -> (seg_new uint8, pads zero; dh int32[2, 256]:
    flips of unsegmented voxels (+) and of segmented voxels (-) by bin).
    With ``window`` = ((z0, z1), (y0, y1), (x0, x1)) inside the region,
    only window voxels flip and are counted; the rule still reads the
    whole region, and the bytes of seg_new outside the window are
    unspecified (the caller keeps the window).
    ``out`` (uint8, seg's shape, not seg) takes seg_new in place of a new
    buffer: the window's rows of its planes are written, over the valid
    x, and nothing else but, where rows are padded, zeros in the padding
    between two of them; ``dh`` (int32[2, 256]) has the counts added
    into it.  Both are returned.
    CPU tensors take ``fused_sweep_plain``; CUDA tensors launch K2."""
    _check(seg, idx, sign_words, valid_yx, window)
    _check_into(seg, out, dh)
    if seg.device.type == "cpu":
        return fused_sweep_plain(seg, idx, sign_words, valid_yx, window,
                                 out=out, dh=dh)
    lib = _kernel_lib()
    Z, Y, X = seg.shape
    Y0, X0 = valid_yx if valid_yx is not None else (Y, X)
    full = ((0, Z), (0, Y0), (0, X0))
    if window is None or tuple(map(tuple, window)) == full:
        window = full
        if out is None:
            padded = (Y0, X0) != (Y, X)
            out = torch.zeros_like(seg) if padded else torch.empty_like(seg)
    elif out is None:               # the kernel writes the window's rows
        out = torch.empty_like(seg)
    if dh is None:
        dh = torch.zeros((2, NUM_BINS), dtype=torch.int32,
                         device=seg.device)
    words = sign_words.to(torch.int32).contiguous()
    with torch.cuda.device(seg.device):
        rc = lib.region_grow_sweep(*_launch_args(
            seg, idx, words, (Y0, X0), window, out, dh))
    cuda_build.check(rc, "region_grow_sweep")
    fused_sweep_counts.launches += all(hi > lo for lo, hi in window)
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
    to the card).  Always f32, as the JAX grower traces under x32.  Its
    two steps (A -> B, B -> A) go to ``grow_loop.drive``: on a card every
    pass after the first runs in one while-graph launch and ``stop`` is
    read min(passes, 2) + 1 times; on the CPU once per pass plus once."""
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

    # the loop's state, written in place: K2 sweeps one seg buffer into
    # the other (ping-pong), dh takes its counts
    segs = (seg0.to(torch.uint8).contiguous(),
            torch.empty(seg0.shape, dtype=torch.uint8, device=device))
    dh = torch.zeros((2, NUM_BINS), dtype=torch.int32, device=device)
    count = torch.sum(seg0, dtype=torch.int32)
    it = torch.zeros((), dtype=torch.int32, device=data.device)
    stop = torch.where(count >= max_segment_size, 1, -1).to(torch.int32)

    def step(src, dst):
        inner_f = inner.to(torch.float32)
        diff = _decision_table(K, inner_f, hist_all - inner_f)
        dh.zero_()
        fused_sweep_counts(src, bins, pack_sign_words(diff), out=dst, dh=dh)
        n_pos, n_neg = dh.sum(dim=1, dtype=torch.int32)
        converged = (n_pos + n_neg) == 0
        inner.add_(dh[0]).sub_(dh[1])
        count.add_(n_pos).sub_(n_neg)
        it.add_((~converged).to(torch.int32))
        stop.copy_(_stop_code(converged, count >= max_segment_size, it,
                              iter_max))

    n = grow_loop.drive([lambda: step(*segs), lambda: step(*segs[::-1])],
                        stop)
    seg = segs[n % 2] != 0
    return RegionGrowResult(segmented_map=seg,
                            active_map=torch.ones_like(seg),
                            iterations=it, segmented_count=count,
                            stop_reason=stop)
