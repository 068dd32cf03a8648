"""Port of arterynetwork_tpu/ops/region_grow_frontier.py: frontier-tile
(block-sparse) variational region growing (K5).

The same fixed point, and the same per-iteration trajectory, as the
full-grid grower with no excluded mask, but each iteration visits only
the tiles that can change:

* the volume is cut into (TZ, TY, full-X) tiles; a tile is active while
  it holds boundary voxels, and a flip re-activates its tile and the
  tile's 8 neighbours on the (z, y) tile grid;
* each iteration compacts the active tile ids into a list of static
  length ``k_max`` (more active tiles than that are carried over, and
  the grower does not count as converged while any are) and sweeps them
  with one kernel call, ``frontier_step``;
* ``inner_hist`` is updated from the sweep's histogram deltas, and the
  size cap is read from its sum.

``frontier_step`` is the kernel's wrapper: CUDA tensors launch
``csrc/region_grow_frontier.cu`` (a snapshot of the active tiles' halo
boxes as bit words, then the sweep, so tiles never see each other's
writes of the same iteration), CPU tensors run ``frontier_step_plain``;
``frontier_step.launches`` counts launches.  The JAX package's packed
geometry word and 8/128 padding are TPU layout workarounds; the port
keeps seg and bins as uint8 (Z, Y, X) volumes and masks the volume's
faces by coordinates.  A CUDA block sweeps one plane of ``nb`` tiles in
turn (the JAX package batches ``nb`` tiles per grid step); it does not
change results.
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
from .region_grow_fused import _unpack_bits, pack_sign_words
from .stencil import dilate26

_P, _I = ctypes.c_void_p, ctypes.c_int


def _kernel_lib():
    return cuda_build.load("region_grow_frontier", region_grow_frontier=[
        _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P])


def _tile_grid(shape, tile):
    Z, Y, _ = shape
    TZ, TY = tile
    return -(-Z // TZ), -(-Y // TY)


def _per_tile(x, tile):
    """Per-tile sums of a (Z, Y, X) volume -> (ntz * nty,) int64."""
    Z, Y, X = x.shape
    TZ, TY = tile
    ntz, nty = _tile_grid(x.shape, tile)
    p = torch.zeros((ntz * TZ, nty * TY, X), dtype=torch.int64,
                    device=x.device)
    p[:Z, :Y] = x
    return p.reshape(ntz, TZ, nty, TY, X).sum(dim=(1, 3, 4)).reshape(-1)


def frontier_step_plain(seg, bins, ids, nact, words, tile, nb=1):
    """Plain PyTorch version of the K5 launch (same signature): one
    Jacobi sweep of the first ``nact`` tiles of ``ids``, in place in
    ``seg``.  Returns (dhist int32[32 W]: +1 per voxel newly segmented,
    -1 per voxel newly unsegmented, by bin; flags int32[len(ids), 2]:
    per slot the tile's flip count and whether it holds a boundary
    voxel, zero for the slots past ``nact``)."""
    del nb
    k_pad = ids.shape[0]
    n = int(nact.reshape(()))
    ntz, nty = _tile_grid(seg.shape, tile)
    sel = torch.zeros(ntz * nty, dtype=torch.bool, device=seg.device)
    sel[ids[:n].long()] = True
    Z, Y, X = seg.shape
    TZ, TY = tile
    interior = sel.reshape(ntz, 1, nty, 1, 1).expand(
        ntz, TZ, nty, TY, X).reshape(ntz * TZ, nty * TY, X)[:Z, :Y]

    s = seg != 0
    bnd = dilate26(s) & dilate26(~s) & interior
    flips = bnd & (s ^ _unpack_bits(words, bins))
    seg.copy_(s ^ flips)
    b = bins.long()
    num_bins = 32 * words.numel()
    dhist = (torch.bincount(b[flips & ~s], minlength=num_bins)
             - torch.bincount(b[flips & s], minlength=num_bins))
    tid = ids.long()
    valid = torch.arange(k_pad, device=seg.device) < n
    flags = torch.stack([_per_tile(flips, tile)[tid],
                         (_per_tile(bnd, tile)[tid] > 0).long()], dim=1)
    flags = flags * valid[:, None]
    return dhist.to(torch.int32), flags.to(torch.int32)


def _check(seg, bins, ids, nact, words, tile):
    if seg.dim() != 3 or tuple(seg.shape) != tuple(bins.shape):
        raise ValueError(f"seg and bins must be one (Z, Y, X) shape, got "
                         f"{tuple(seg.shape)} and {tuple(bins.shape)}")
    if seg.dtype != torch.uint8 or bins.dtype != torch.uint8:
        raise ValueError("seg and bins must be uint8")
    if ids.dtype != torch.int32 or nact.dtype != torch.int32 \
            or nact.numel() != 1 or words.dtype != torch.int32:
        raise ValueError("ids, nact and words must be int32 (nact one "
                         "element)")
    if not 1 <= words.numel() <= 8:
        raise ValueError("words must hold 1 to 8 words (at most 256 bins)")
    if len(tile) != 2 or min(tile) < 1:
        raise ValueError(f"bad tile {tile}")
    devs = {t.device for t in (seg, bins, ids, nact, words)}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {devs}")
    if seg.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no frontier kernel for {seg.device}")
    if not all(t.is_contiguous() for t in (seg, bins, ids, words)):
        raise ValueError("seg, bins, ids and words must be contiguous")


def frontier_step(seg, bins, ids, nact, words, tile, nb=1):
    """One frontier iteration (see ``frontier_step_plain``): CPU tensors
    take the plain version, CUDA tensors launch K5 (the active-tile count
    ``nact`` is read on the device)."""
    _check(seg, bins, ids, nact, words, tile)
    if seg.device.type == "cpu":
        return frontier_step_plain(seg, bins, ids, nact, words, tile, nb)
    lib = _kernel_lib()
    Z, Y, X = seg.shape
    TZ, TY = tile
    k_pad = ids.shape[0]
    dev = seg.device
    snap = torch.empty((k_pad, (TZ + 2) * 2 * (TY + 2) * -(-X // 32)),
                       dtype=torch.int32, device=dev)
    dhist = torch.zeros(256, dtype=torch.int32, device=dev)
    flags = torch.zeros((k_pad, 2), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.region_grow_frontier(
            seg.data_ptr(), bins.data_ptr(), ids.data_ptr(),
            nact.data_ptr(), words.data_ptr(), words.numel(), Z, Y, X, TZ,
            TY, k_pad, max(1, int(nb)), snap.data_ptr(), dhist.data_ptr(),
            flags.data_ptr(), torch.cuda.current_stream().cuda_stream)
    cuda_build.check(rc, "region_grow_frontier")
    frontier_step.launches += 1
    return dhist[:32 * words.numel()], flags


frontier_step.launches = 0


def _compact(active_flat, k_pad):
    """The first ``k_pad`` active tile ids (zero-filled), without a host
    synchronisation (and capturable: the ids past ``k_pad`` land in the
    spare slot ``k_pad``, which is dropped)."""
    pos = torch.cumsum(active_flat, 0) - 1
    keep = active_flat & (pos < k_pad)
    slot = torch.where(keep, pos, torch.full_like(pos, k_pad))
    ids = torch.zeros(k_pad + 1, dtype=torch.int32,
                      device=active_flat.device)
    ids.scatter_(0, slot, torch.arange(active_flat.shape[0],
                                       dtype=torch.int32,
                                       device=active_flat.device))
    return ids[:k_pad].contiguous()


def region_grow_frontier(data, seed_mask, H: float = DEFAULT_H,
                         max_segment_size: int = DEFAULT_MAX_SEGMENT_SIZE,
                         iter_max: int = DEFAULT_ITER_MAX,
                         num_bins: int = 256, tile=(8, 16),
                         k_max: int = 256, nb: int = 1,
                         device=None) -> RegionGrowResult:
    """Frontier-tile region growing (same fixed point and trajectory as
    ``region_grow`` with ``excluded_mask=None``) on ``device`` (by
    default the device of a ``data`` tensor; host arrays go to the
    card).  Always f32, as the JAX grower traces under x32."""
    if num_bins % 32 or not 32 <= num_bins <= 256:
        raise ValueError("num_bins must be a multiple of 32, at most 256")
    device = _resolve_device(data, device)
    data = _as_device(data, device).to(torch.float32)
    seg0 = _as_device(seed_mask, device, torch.bool)
    Z, Y, X = data.shape
    ntz, nty = _tile_grid(data.shape, tile)
    NT = ntz * nty
    k_max = min(int(k_max), NT)

    bin_idx, bin_values = _quantize(data, num_bins)
    bins = _bin_ids(bin_idx, num_bins).contiguous()
    bins_flat = bins.reshape(-1)
    hist_all = masked_histogram_one(
        bins_flat, torch.ones_like(bins_flat, dtype=torch.bool), num_bins)
    inner = masked_histogram_one(bins_flat, seg0.reshape(-1),
                                 num_bins).to(torch.int32)
    K = _gaussian_kernel(bin_values, H, torch.float32)

    bnd0 = dilate26(seg0) & dilate26(~seg0)
    active = _per_tile(bnd0, tile) > 0
    seg = seg0.to(torch.uint8).contiguous()
    nact_cap = torch.tensor(k_max, dtype=torch.int64, device=device)
    slots = torch.arange(k_max, device=device)
    it = torch.zeros((), dtype=torch.int32, device=device)
    stop = torch.where(torch.sum(inner) >= max_segment_size, 1,
                       -1).to(torch.int32)

    def step():                 # seg, active, inner, it, stop in place
        inner_f = inner.to(torch.float32)
        diff = _decision_table(K, inner_f, hist_all - inner_f)
        n_active = torch.sum(active)
        ids = _compact(active, k_max)
        nact = torch.minimum(n_active, nact_cap)
        dhist, flags = frontier_step(seg, bins, ids,
                                     nact.to(torch.int32).reshape(1),
                                     pack_sign_words(diff), tile, nb)
        valid = slots < nact
        nf = flags[:, 0] * valid
        hb = flags[:, 1] * valid
        tid = ids.long()
        zeros = torch.zeros(NT, dtype=torch.int32, device=device)
        flipped = zeros.scatter_reduce(0, tid, nf, "amax") > 0
        keep = zeros.scatter_reduce(0, tid, hb, "amax") > 0
        proc = zeros.scatter_reduce(0, tid, valid.to(torch.int32),
                                    "amax") > 0
        active.copy_((active & ~proc) | keep
                     | dilate26(flipped.reshape(ntz, nty)).reshape(-1))
        inner.add_(dhist)
        converged = (torch.sum(nf) == 0) & (n_active <= k_max)
        it.add_((~converged).to(torch.int32))
        stop.copy_(_stop_code(converged,
                              torch.sum(inner) >= max_segment_size, it,
                              iter_max))

    grow_loop.drive([step], stop)
    seg = seg != 0
    return RegionGrowResult(
        segmented_map=seg, active_map=torch.ones_like(seg), iterations=it,
        segmented_count=torch.sum(seg, dtype=torch.int32),
        stop_reason=stop)
