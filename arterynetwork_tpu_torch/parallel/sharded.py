"""The voxel stages on a ``ShardedVolume``, with every halo explicit.

This module has no counterpart in the JAX package.  There,
``frangi_vesselness``, ``edt``, ``region_grow`` and ``skeletonize`` run on
sharded arrays unchanged: GSPMD partitions each program over the mesh
and inserts the halo collectives its shifts need
(tests/test_parallel.py).  PyTorch has no partitioner, so each stage is
written out here as per-block calls of the single-device code on blocks
padded with their neighbours' halos (parallel/halo.py), with every
quantity that spans the volume reduced across blocks before it is used:

* ``frangi_vesselness``: halo ceil(3 max sigma) + 1 (the smoothing radius
  plus the central difference), none at the volume's faces, whose
  edge-replicated differences then see the volume's own face; the scale
  weight gamma = 0.5 max(S) is a max over the blocks.  Each voxel's
  shifted-slice sums are the whole volume's, in the same order, so the
  result is bit-equal to ``ops/vesselness.frangi_vesselness``.
* ``edt_squared``: halo ``band`` with corners; bit-equal to
  ``ops/edt.edt_squared``.
* ``region_grow``: the fused grower of ops/region_grow_fused.py on two
  halo-padded copies of the segmentation, made once: per iteration K2
  sweeps each block of one copy over its interior window (the halo is
  read, never flipped or counted) into the other copy, whose halo faces
  alone are then refreshed from its neighbours (``refresh_halos``), and
  the two swap; the blocks' +/- histograms go into one preallocated
  buffer per device, summed on the first block's device, and the host
  reads the stop code once.  The quantisation's min/max and the region
  histograms (K6b per block, exact int32 counts) are taken over all
  blocks.  Equal to the single-device grower: mask, iterations, count,
  stop reason.
* ``skeletonize``: the EDT above, then per pass a halo-1 exchange of the
  foreground before each of the 8 subfields, whose parities are global
  (``ops/thinning._subfield_index`` at the block's offset), and one host
  read of (anything deleted, max d2) reduced over the blocks.  The
  single-device thinning's crop to the mask's box is dropped (it changes
  nothing but the work); the skeleton is bit-equal.

The sharded pipeline (parallel/pipeline_sharded.py) calls these directly;
the single-device functions do not dispatch here.  On a mesh whose slots
repeat one card the blocks run one after another.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.edt import edt_squared as _edt_squared
from ..ops.histogram_kernels import masked_histogram1
from ..ops.region_grow import (DEFAULT_H, DEFAULT_ITER_MAX,
                               DEFAULT_MAX_SEGMENT_SIZE, RegionGrowResult,
                               _bin_ids, _decision_table, _gaussian_kernel,
                               _quantize, _stop_code)
from ..ops.region_grow_fused import (NUM_BINS, fused_sweep_counts,
                                     pack_sign_words)
from ..ops.simple_point import neighborhood_codes
from ..ops.thinning import (_device_lut, _subfield_deletions,
                            _subfield_index)
from ..ops.vesselness import (_norm, _sorted_eigvals, _tubularity,
                              hessian_at_scale)
from .halo import (Padded, ShardedVolume, halo_faces, pad_halos,
                   refresh_halos)


def _first(vol: ShardedVolume):
    return vol.blocks[(0,) * len(vol.grid)]


def _reduce(parts, op, device):
    """``op`` (torch.max, torch.sum, ...) over per-block tensors, on
    ``device``."""
    return op(torch.stack([p.to(device) for p in parts]), dim=0)


def frangi_vesselness(vol: ShardedVolume, sigmas=(1.0, 2.0, 3.0)):
    """``ops/vesselness.frangi_vesselness`` of a sharded volume (its
    defaults: alpha = beta = 0.5, gamma from the data, bright vessels),
    as a sharded f32 volume, bit-equal to the whole volume's."""
    vol = vol.map(lambda b: b.to(torch.float32))
    pad = pad_halos(vol, int(np.ceil(3.0 * max(sigmas))) + 1)
    idxs = vol.indices()
    dev0 = _first(vol).device
    best = vol.map(torch.zeros_like)
    for sigma in sigmas:
        lam, s = {}, {}
        for i in idxs:
            box = pad.box(i)
            lam[i] = tuple(x[box] for x in _sorted_eigvals(
                hessian_at_scale(pad.blocks[i], float(sigma))))
            s[i] = _norm(lam[i])
        g = 0.5 * _reduce([torch.max(s[i]) for i in idxs], torch.max,
                          dev0).values
        for i in idxs:
            b = best.blocks[i]
            best.blocks[i] = torch.maximum(b, _tubularity(
                lam[i], s[i], 0.5, 0.5, g.to(b.device), True))
        del lam, s
    return best


def edt_squared(mask: ShardedVolume, band: int = 32):
    """``ops/edt.edt_squared`` (banded, unit sampling) of a sharded mask,
    bit-equal to the whole volume's: each block padded with ``band``
    voxels of its neighbours, corners included."""
    pad = pad_halos(mask.map(lambda b: b != 0), band)
    out = np.empty(mask.grid, dtype=object)
    for i in mask.indices():
        out[i] = _edt_squared(pad.blocks[i],
                              band=band)[pad.box(i)].contiguous()
    return ShardedVolume(out, mask.shape, mask.mesh, mask.axes)


def quantized_bins(data: ShardedVolume):
    """(each f32 block's uint8 bins over the volume's min/max, padded
    with a halo of 1 as the sweeps read them; the bin values)."""
    idxs = data.indices()
    dev0 = _first(data).device
    vmin = _reduce([torch.min(data.blocks[i]) for i in idxs], torch.min,
                   dev0).values
    vmax = _reduce([torch.max(data.blocks[i]) for i in idxs], torch.max,
                   dev0).values
    bins_pad = pad_halos(data.map(lambda b: _bin_ids(_quantize(
        b, NUM_BINS, vmin.to(b.device), vmax.to(b.device))[0], NUM_BINS)),
        1)
    return bins_pad, _quantize(_first(data), NUM_BINS, vmin, vmax)[1]


def histogram_inputs(bins_pad, seg: ShardedVolume):
    """K6b's inputs per padded block: {idx: (flat bins, own mask, inner
    mask)}, the masks false on the halo (own: the block's voxels; inner:
    its segmented ones)."""
    out = {}
    for i in seg.indices():
        t = bins_pad.blocks[i]
        own = torch.zeros(t.shape, dtype=torch.bool, device=t.device)
        own[bins_pad.box(i)] = True
        inner = torch.zeros_like(own)
        inner[bins_pad.box(i)] = seg.blocks[i] != 0
        out[i] = (t.reshape(-1), own.reshape(-1), inner.reshape(-1))
    return out


def region_grow(data: ShardedVolume, seed_mask: ShardedVolume,
                max_segment_size: int = DEFAULT_MAX_SEGMENT_SIZE,
                iter_max: int = DEFAULT_ITER_MAX):
    """The fused grower (``ops/region_grow_fused.region_grow_fused``, f32,
    256 bins, no excluded mask, bandwidth ``DEFAULT_H``) on a sharded
    volume.  Returns a
    ``RegionGrowResult`` whose ``segmented_map`` is a sharded bool volume
    and whose ``active_map`` is None (no voxel is excluded); the scalars
    lie on the first block's device."""
    data = data.map(lambda b: b.to(torch.float32))
    idxs = data.indices()
    dev0 = _first(data).device
    bins_pad, values = quantized_bins(data)
    K = _gaussian_kernel(values, DEFAULT_H, torch.float32)
    seg = seed_mask.map(lambda b: (b != 0).to(torch.uint8))

    # the region histograms over the blocks' own voxels, exact, summed
    all_parts, inner_parts = [], []
    for flat, own, inner in histogram_inputs(bins_pad, seg).values():
        all_parts.append(masked_histogram1(flat, own, NUM_BINS,
                                           torch.int32))
        inner_parts.append(masked_histogram1(flat, inner, NUM_BINS,
                                             torch.int32))
    hist_all = _reduce(all_parts, torch.sum, dev0).to(torch.float32)
    inner = _reduce(inner_parts, torch.sum, dev0).to(torch.int32)
    count = _reduce([torch.sum(seg.blocks[i], dtype=torch.int32)
                     for i in idxs], torch.sum, dev0).to(torch.int32)

    # two padded copies, made once: each sweep reads one and writes the
    # other's windows; the dh slots of the blocks on each device are
    # rows of one buffer, zeroed once per sweep
    src = pad_halos(seg, 1)
    dst = Padded(np.empty(seg.grid, dtype=object), src.lo, src.hi,
                 src.source)
    by_dev = {}
    for i in idxs:
        dst.blocks[i] = src.blocks[i].clone()
        by_dev.setdefault(src.blocks[i].device, []).append(i)
    dh_buf = {d: torch.zeros((len(ix), 2, NUM_BINS), dtype=torch.int32,
                             device=d) for d, ix in by_dev.items()}
    dh_of = {i: dh_buf[d][k] for d, ix in by_dev.items()
             for k, i in enumerate(ix)}
    windows = {i: src.window(i) for i in idxs}
    src_faces, dst_faces = halo_faces(src), halo_faces(dst)

    it = torch.zeros((), dtype=torch.int32, device=dev0)
    stop = torch.where(count >= max_segment_size, 1, -1).to(torch.int32)
    while int(stop) < 0:
        inner_f = inner.to(torch.float32)
        words = pack_sign_words(_decision_table(K, inner_f,
                                                hist_all - inner_f))
        words_on = {d: words.to(d) for d in dh_buf}
        for buf in dh_buf.values():
            buf.zero_()
        for i in idxs:
            t = src.blocks[i]
            fused_sweep_counts(t, bins_pad.blocks[i], words_on[t.device],
                               window=windows[i], out=dst.blocks[i],
                               dh=dh_of[i])
        refresh_halos(dst, dst_faces)
        src, dst = dst, src
        src_faces, dst_faces = dst_faces, src_faces
        parts = [buf.sum(dim=0) for buf in dh_buf.values()]
        dh = parts[0] if len(parts) == 1 else _reduce(parts, torch.sum,
                                                      dev0)
        n_pos, n_neg = dh.sum(dim=1, dtype=torch.int32)
        converged = (n_pos + n_neg) == 0
        inner = inner + dh[0] - dh[1]
        count = count + n_pos - n_neg
        it = it + (~converged).to(torch.int32)
        stop = _stop_code(converged, count >= max_segment_size, it,
                          iter_max)
    return RegionGrowResult(segmented_map=src.crop().map(lambda b: b != 0),
                            active_map=None, iterations=it,
                            segmented_count=count, stop_reason=stop)


def skeletonize(mask: ShardedVolume, max_waves: int = 64):
    """``ops/thinning.skeletonize`` of a sharded mask (endpoints kept), as
    a sharded bool volume, bit-equal to the whole volume's skeleton.  The
    simple-point test is the table on CUDA blocks and label propagation
    on CPU blocks.  The host reads one pair per pass, reduced over the
    blocks."""
    fg = mask.map(lambda b: b != 0)
    idxs = fg.indices()
    dev0 = _first(fg).device
    d2 = edt_squared(fg, band=32)
    sub_masks, luts = {}, {}
    for i in idxs:
        dev = fg.blocks[i].device
        sub = _subfield_index(fg.blocks[i].shape, fg.offset(i), dev)
        sub_masks[i] = [sub == sf for sf in range(8)]
        luts[i] = _device_lut(dev) if dev.type == "cuda" else None

    def delete_pass(level2):
        at_level = {i: d2.blocks[i] <= level2 for i in idxs}
        deleted = []
        for sf in range(8):
            pad = pad_halos(fg, 1)
            for i in idxs:
                own = fg.blocks[i]
                cand = _subfield_deletions(
                    own, neighborhood_codes(pad.blocks[i])[pad.box(i)],
                    at_level[i] & sub_masks[i][sf], True, luts[i])
                fg.blocks[i] = own & ~cand
                deleted.append(cand.any())
        return _reduce(deleted, torch.any, dev0)

    def read(deleted):
        """(deleted, max d2 over fg) in one host read."""
        max_d2 = _reduce([torch.where(fg.blocks[i], d2.blocks[i],
                                      0.0).max() for i in idxs],
                         torch.max, dev0).values
        pair = torch.stack([deleted.to(torch.float32), max_d2]).cpu()
        return bool(pair[0]), np.float32(pair[1])

    _, max_d2 = read(torch.zeros((), dtype=torch.bool, device=dev0))
    if max_d2 == 0:                 # no foreground voxel
        return fg
    level, stalled = 1, 0
    while (np.float32(level) ** 2 <= max_d2 + np.float32(2.0)
           and stalled < max_waves):
        level2 = float(np.float32(level) ** 2 + np.float32(0.5))
        deleted, max_d2 = read(delete_pass(level2))
        level, stalled = (level, 0) if deleted else (level + 1, stalled + 1)

    deleted, it = True, 0
    while deleted and it < max_waves:
        deleted, _ = read(delete_pass(1e12))
        it += 1
    return fg
