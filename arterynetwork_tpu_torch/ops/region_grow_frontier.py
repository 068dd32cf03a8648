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


# the frontier grows' cache: per device and thread, at most this many
# entries; an entry holds the volume's bins and segmentation between
# calls, so one
_CACHE_SIZE = 1
_cache = grow_loop.LoopCache(_CACHE_SIZE)


def clear_frontier_cache(device=None):
    """Drop this thread's cached frontier grows on ``device`` (or on
    every device)."""
    _cache.clear(device)


def frontier_cache_info():
    """The frontier grows' cache: hits, misses, evictions, entries by
    device."""
    return _cache.info()


class _FrontierGrow(grow_loop.CachedGrow):
    """A cached frontier grow, the counterpart of one executable in the
    JAX jit's cache: the bins, the Gaussian kernel ``K``, the volume's
    and the region's histograms, the segmentation, the active tiles,
    ``k_max`` as a tensor, the slot indices, the iteration count,
    ``stop`` and the step, which reads nothing else.  Its key: the
    shape, ``num_bins``, ``tile``, ``k_max``, ``nb``,
    ``max_segment_size`` and ``iter_max`` (the step takes them as
    constants)."""

    def __init__(self, shape, num_bins, tile, k_max, nb, max_segment_size,
                 iter_max, device):
        super().__init__(device)
        self.ntz, self.nty = _tile_grid(shape, tile)
        self.NT = self.ntz * self.nty
        self.bins = torch.empty(shape, dtype=torch.uint8, device=device)
        self.K = torch.empty((num_bins, num_bins), dtype=torch.float32,
                             device=device)
        self.hist_all = torch.empty(num_bins, dtype=torch.float32,
                                    device=device)
        self.inner = torch.empty(num_bins, dtype=torch.int32, device=device)
        self.seg = torch.empty(shape, dtype=torch.uint8, device=device)
        self.active = torch.empty(self.NT, dtype=torch.bool, device=device)
        self.nact_cap = torch.tensor(k_max, dtype=torch.int64, device=device)
        self.slots = torch.arange(k_max, device=device)
        self.it, self.stop = (torch.zeros((), dtype=torch.int32,
                                          device=device) for _ in range(2))
        self.num_bins, self.tile, self.k_max, self.nb = (num_bins, tile,
                                                         k_max, nb)
        self.max_segment_size, self.iter_max = max_segment_size, iter_max
        self.steps = [self.step]

    def load(self, seed, bins, K):
        """Copy a call's seed, bins and kernel in; the histograms, the
        active tiles and ``stop`` from them."""
        self.seg.copy_(seed)
        self.bins.copy_(bins)
        self.K.copy_(K)
        flat = self.bins.reshape(-1)
        self.hist_all.copy_(masked_histogram_one(
            flat, torch.ones_like(flat, dtype=torch.bool), self.num_bins))
        self.inner.copy_(masked_histogram_one(flat, seed.reshape(-1),
                                              self.num_bins))
        bnd0 = dilate26(seed) & dilate26(~seed)
        self.active.copy_(_per_tile(bnd0, self.tile) > 0)
        self.it.zero_()
        self.stop.copy_(torch.where(torch.sum(self.inner)
                                    >= self.max_segment_size, 1, -1))

    def step(self):             # seg, active, inner, it, stop in place
        active, inner, it, k_max = self.active, self.inner, self.it, self.k_max
        NT, device = self.NT, self.seg.device
        inner_f = inner.to(torch.float32)
        diff = _decision_table(self.K, inner_f, self.hist_all - inner_f)
        n_active = torch.sum(active)
        ids = _compact(active, k_max)
        nact = torch.minimum(n_active, self.nact_cap)
        dhist, flags = frontier_step(self.seg, self.bins, ids,
                                     nact.to(torch.int32).reshape(1),
                                     pack_sign_words(diff), self.tile,
                                     self.nb)
        valid = self.slots < nact
        nf = flags[:, 0] * valid
        hb = flags[:, 1] * valid
        tid = ids.long()
        zeros = torch.zeros(NT, dtype=torch.int32, device=device)
        flipped = zeros.scatter_reduce(0, tid, nf, "amax") > 0
        keep = zeros.scatter_reduce(0, tid, hb, "amax") > 0
        proc = zeros.scatter_reduce(0, tid, valid.to(torch.int32),
                                    "amax") > 0
        active.copy_((active & ~proc) | keep
                     | dilate26(flipped.reshape(self.ntz,
                                                self.nty)).reshape(-1))
        inner.add_(dhist)
        converged = (torch.sum(nf) == 0) & (n_active <= k_max)
        it.add_((~converged).to(torch.int32))
        self.stop.copy_(_stop_code(converged,
                                   torch.sum(inner) >= self.max_segment_size,
                                   it, self.iter_max))


@grow_loop.frees_loop_caches
def region_grow_frontier(data, seed_mask, H: float = DEFAULT_H,
                         max_segment_size: int = DEFAULT_MAX_SEGMENT_SIZE,
                         iter_max: int = DEFAULT_ITER_MAX,
                         num_bins: int = 256, tile=(8, 16),
                         k_max: int = 256, nb: int = 1,
                         device=None) -> RegionGrowResult:
    """Frontier-tile region growing (same fixed point and trajectory as
    ``region_grow`` with ``excluded_mask=None``) on ``device`` (by
    default the device of a ``data`` tensor; host arrays go to the
    card).  Always f32, as the JAX grower traces under x32.  Its step
    goes to ``grow_loop.drive``: on a card every pass after the first
    runs in one while-graph launch and ``stop`` is read min(passes, 2) +
    1 times; on the CPU once per pass plus once.

    As ``jax.jit`` compiles the grower once per shape and static
    arguments, the step and every tensor it reads lie in a cached entry
    (``_FrontierGrow``; its docstring lists what it holds and its key;
    the loop route, ``grow_loop.drive``, is in the key too).  A call
    copies its seed, bins and kernel in; on a card a grow after the
    entry's first graph-driven one of two passes or more runs pass 1
    eagerly and launches the entry's while graph, capturing nothing.
    The result's tensors are new."""
    if num_bins % 32 or not 32 <= num_bins <= 256:
        raise ValueError("num_bins must be a multiple of 32, at most 256")
    device = _resolve_device(data, device)
    data = _as_device(data, device).to(torch.float32)
    seg0 = _as_device(seed_mask, device, torch.bool)
    ntz, nty = _tile_grid(data.shape, tile)
    k_max = min(int(k_max), ntz * nty)
    tile = tuple(tile)

    bin_idx, bin_values = _quantize(data, num_bins)
    bins = _bin_ids(bin_idx, num_bins)
    K = _gaussian_kernel(bin_values, H, torch.float32)
    shape = tuple(seg0.shape)
    key = (grow_loop.drive, shape, num_bins, tile, k_max, nb,
           max_segment_size, iter_max)
    with _cache.use(device, key, lambda: _FrontierGrow(
            shape, num_bins, tile, k_max, nb, max_segment_size, iter_max,
            device)) as (grow, _):
        grow.load(seg0, bins, K)
        grow_loop.drive(grow.steps, grow.stop, grow)
        seg = grow.seg != 0
        return RegionGrowResult(
            segmented_map=seg, active_map=torch.ones_like(seg),
            iterations=grow.it.clone(),
            segmented_count=torch.sum(seg, dtype=torch.int32),
            stop_reason=grow.stop.clone())
