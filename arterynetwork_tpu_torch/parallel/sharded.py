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
  alone are then refreshed from its neighbours (``refresh_halos``); the
  blocks' +/- histograms go into one preallocated buffer per device,
  summed on the first block's device.  The quantisation's min/max and
  the region histograms (K6b per block, exact int32 counts) are taken
  over all blocks.  Equal to the single-device grower: mask, iterations,
  count, stop reason.
* ``skeletonize``: the EDT above, then per pass a halo-1 exchange of the
  foreground before each of the 8 subfields, whose parities are global
  (``ops/thinning._subfield_index`` at the block's offset), with
  (anything deleted, max d2) reduced over the blocks.  The single-device
  thinning's crop to the mask's box is dropped (it changes nothing but
  the work); the skeleton is bit-equal.

The two loops are the JAX package's ``lax.while_loop``s, which GSPMD
runs over the mesh as one program
(arterynetwork_tpu/parallel/pipeline_sharded.py:63,67 ->
ops/region_grow.py:250, ops/thinning.py:173,187).  Here each iteration
(the grower's sweep: two steps, A -> B and B -> A; a thinning pass) is
a step over state made before the loop and updated in place, run by
``ops/grow_loop`` as on one device.  ``loop_route`` picks how: when
every block is on one CUDA device each step is captured once as a CUDA
graph ("graph": the grower's sweeps after the first then run in one
launch of a graph with a conditional WHILE node, and the host reads
``stop`` min(sweeps, 2) + 1 times; the thinning's passes are replayed,
one read each after one before the loop); on CPU blocks, and on blocks
spread over several cards, which one graph cannot span, the steps run
eagerly ("host": ``stop`` read once before the loop and once per
iteration).

The sharded pipeline (parallel/pipeline_sharded.py) calls these directly;
the single-device functions do not dispatch here.  On a mesh whose slots
repeat one card the blocks run one after another.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import grow_loop
from ..ops.edt import edt_squared as _edt_squared
from ..ops.histogram_kernels import masked_histogram1
from ..ops.region_grow import (DEFAULT_H, DEFAULT_ITER_MAX,
                               DEFAULT_MAX_SEGMENT_SIZE, RegionGrowResult,
                               _bin_ids, _decision_table, _gaussian_kernel,
                               _quantize, _stop_code)
from ..ops.region_grow_fused import (NUM_BINS, fused_sweep_counts,
                                     pack_sign_words)
from ..ops.simple_point import neighborhood_codes
from ..ops.thinning import (_LUTS, _device_lut, _level2,
                            _subfield_deletions, _subfield_index)
from ..ops.vesselness import (_norm, _sorted_eigvals, _tubularity,
                              hessian_at_scale)
from .halo import (Padded, ShardedVolume, halo_faces, pad_halos,
                   refresh_halos)


def _first(vol: ShardedVolume):
    return vol.blocks[(0,) * len(vol.grid)]


def loop_route(devices):
    """How a sharded stage runs its loop over blocks on ``devices``:
    "graph" when they are all one CUDA device (every mesh whose slots
    repeat one card), where ``ops/grow_loop`` captures each step as one
    CUDA graph and replays it; else "host", the eager loop (CPU blocks,
    or blocks on several cards, which one graph cannot span)."""
    devs = list(dict.fromkeys(torch.device(d) for d in devices))
    return "graph" if len(devs) == 1 and devs[0].type == "cuda" else "host"


def _lut_for(device):
    """The simple-point route of the blocks on ``device``: the table on a
    CUDA device, label propagation (None) elsewhere."""
    return _device_lut(device) if device.type == "cuda" else None


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
    lie on the first block's device.

    The sweeps go to ``grow_loop.drive`` on the "graph" route
    (``loop_route``: on a card, sweep 1 eager, then both steps captured
    and run by one while-graph launch; ``stop`` read min(sweeps, 2) + 1
    times) and to ``grow_loop.host_loop`` on the "host" route (``stop``
    read once before the loop and once per sweep); the reads are counted
    in ``grow_loop.read_stop.reads``.  The last call's route is
    ``region_grow.route``."""
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

    # the loop's state, on the first block's device, written in place
    it = torch.zeros((), dtype=torch.int32, device=dev0)
    stop = torch.where(count >= max_segment_size, 1, -1).to(torch.int32)

    def step(a, b, b_faces):
        """One sweep: K2 on every block of ``a`` into ``b``'s windows,
        ``b``'s halo faces refreshed, the counts summed on ``dev0``."""
        inner_f = inner.to(torch.float32)
        words = pack_sign_words(_decision_table(K, inner_f,
                                                hist_all - inner_f))
        words_on = {d: words.to(d) for d in dh_buf}
        for buf in dh_buf.values():
            buf.zero_()
        for i in idxs:
            t = a.blocks[i]
            fused_sweep_counts(t, bins_pad.blocks[i], words_on[t.device],
                               window=windows[i], out=b.blocks[i],
                               dh=dh_of[i])
        refresh_halos(b, b_faces)
        parts = [buf.sum(dim=0) for buf in dh_buf.values()]
        dh = parts[0] if len(parts) == 1 else _reduce(parts, torch.sum,
                                                      dev0)
        n_pos, n_neg = dh.sum(dim=1, dtype=torch.int32)
        converged = (n_pos + n_neg) == 0
        inner.add_(dh[0]).sub_(dh[1])
        count.add_(n_pos).sub_(n_neg)
        it.add_((~converged).to(torch.int32))
        stop.copy_(_stop_code(converged, count >= max_segment_size, it,
                              iter_max))

    steps = [lambda: step(src, dst, dst_faces),
             lambda: step(dst, src, src_faces)]
    region_grow.route = loop_route(data.mesh.distinct_devices())
    if region_grow.route == "graph":
        n = grow_loop.drive(steps, stop)
    else:
        n = grow_loop.host_loop(steps, stop)
    grown = (src, dst)[n % 2].crop().map(lambda b: b != 0)
    return RegionGrowResult(segmented_map=grown, active_map=None,
                            iterations=it, segmented_count=count,
                            stop_reason=stop)


region_grow.route = None


def skeletonize(mask: ShardedVolume, max_waves: int = 64):
    """``ops/thinning.skeletonize`` of a sharded mask (endpoints kept), as
    a sharded bool volume, bit-equal to the whole volume's skeleton.  The
    simple-point test is the table on CUDA blocks and label propagation
    on CPU blocks.

    As on one device, each pass (8 subfields, each after a halo-1
    exchange of the foreground) updates the blocks' masks, the level,
    stall count, pass count, ``deleted``, the max d2 and ``stop`` in
    place, on the first block's device, and runs in a loop of
    ``ops/grow_loop`` under the keys "wave" and "final": on the "graph"
    route (``loop_route``) ``grow_loop.loop_for``'s, which on a card
    replays each key's pass from a captured CUDA graph, else a
    ``HostLoop`` (CPU blocks, whose label propagation calls
    ``torch.nonzero``, or blocks on several cards).  The host reads
    ``stop`` once before the wave loop and once after each pass: 1 +
    wave passes + final passes reads (an empty mask returns after the
    first).  The last call's counts are ``skeletonize.route``,
    ``.wave_passes``, ``.final_passes``, ``.reads``, ``.captures``,
    ``.replays`` and ``.capture_s``."""
    fg = mask.map(lambda b: b != 0)
    idxs = fg.indices()
    dev0 = _first(fg).device
    route = loop_route(mask.mesh.distinct_devices())
    _count(grow_loop.HostLoop(), route)
    d2 = edt_squared(fg, band=32)
    sub_masks, luts = {}, {}
    for i in idxs:
        dev = fg.blocks[i].device
        sub = _subfield_index(fg.blocks[i].shape, fg.offset(i), dev)
        sub_masks[i] = [sub == sf for sf in range(8)]
        luts[i] = _lut_for(dev)
    level = torch.ones((), dtype=torch.int32, device=dev0)
    stalled, it, stop = (torch.zeros_like(level) for _ in range(3))
    deleted = torch.zeros((), dtype=torch.bool, device=dev0)
    max_d2 = torch.zeros((), dtype=torch.float32, device=dev0)
    far = torch.full((), 1e12, dtype=torch.float32, device=dev0)

    def delete_pass(level2):
        """One peel attempt at the distance bound ``level2``; 8
        subfields.  Sets ``deleted``: anything deleted."""
        at_level = {i: d2.blocks[i] <= level2.to(d2.blocks[i].device)
                    for i in idxs}
        deleted.zero_()
        for sf in range(8):
            pad = pad_halos(fg, 1)
            for i in idxs:
                own = fg.blocks[i]
                cand = _subfield_deletions(
                    own, neighborhood_codes(pad.blocks[i])[pad.box(i)],
                    at_level[i] & sub_masks[i][sf], True, luts[i])
                own.logical_and_(~cand)
                deleted.logical_or_(cand.any().to(dev0))

    def wave_stop():
        """Go on while f32(level)^2 <= max fg d2 + 2 and stalled < max."""
        max_d2.copy_(_reduce([torch.where(fg.blocks[i], d2.blocks[i],
                                          0.0).max() for i in idxs],
                             torch.max, dev0).values)
        lf = level.to(torch.float32)
        stop.copy_(torch.where((lf * lf <= max_d2 + 2.0)
                               & (stalled < max_waves), -1, 0))

    def wave_step():
        delete_pass(_level2(level))
        # stay at this level until stable, then move outward
        torch.where(deleted, level, level + 1, out=level)
        stalled.copy_(torch.where(deleted, 0, stalled + 1))
        wave_stop()

    def final_step():
        """A cleanup pass at unlimited level; go on while it deleted."""
        delete_pass(far)
        it.add_(1)
        stop.copy_(torch.where(deleted & (it < max_waves), -1, 0))

    loop = (grow_loop.loop_for(dev0, watch=lambda: list(_LUTS.values()))
            if route == "graph" else grow_loop.HostLoop())
    with loop.stream():
        wave_stop()
        stop.copy_(torch.where(max_d2 == 0, 1, stop))  # 1: no foreground
        go = loop.read(stop)
        if go != 1:
            while go < 0:
                loop.run("wave", wave_step)
                go = loop.read(stop)
            if max_waves > 0:
                loop.run("final", final_step)
                while loop.read(stop) < 0:
                    loop.run("final", final_step)
    _count(loop, route)
    return fg


def _count(loop, route):
    """``skeletonize``'s counts from the loop its passes ran in."""
    skeletonize.route = route
    skeletonize.wave_passes = loop.runs.get("wave", 0)
    skeletonize.final_passes = loop.runs.get("final", 0)
    skeletonize.reads = loop.reads
    skeletonize.captures = loop.captures
    skeletonize.replays = loop.replays
    skeletonize.capture_s = loop.capture_s


_count(grow_loop.HostLoop(), None)
