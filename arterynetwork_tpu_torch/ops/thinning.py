"""Curve skeletonization by distance-ordered parallel thinning.

Port of the JAX package's ops/thinning.py (the reference's Tabb
curve-skeletonization binary, skeletonization.py:150-162): binary vessel
mask in, 1-voxel-wide 26-connected centerline out, as iterated full-grid
sweeps:

* voxels are peeled in waves of increasing Euclidean distance;
* within a wave, deletions run in the 8 parity subfields of the 2x2x2
  lattice decomposition, so no two simultaneously deleted voxels are
  26-adjacent;
* a voxel may be deleted only if it is *simple* (Bertrand's T26/T6
  characterization, ops/simple_point.py) and not a curve endpoint
  (exactly one foreground 26-neighbor).

The simple-point test has two routes with the same answers:

* ``"labels"``: the JAX package's label propagation over the 26
  neighbor bitplanes (8 rounds for T26, 10 for T6), evaluated at the
  subfield's candidates; the route on the CPU;
* ``"lut"``: one 26-bit neighborhood code per voxel and a gather into the
  2^26-entry table of ops/simple_point.py, resident on the device; the
  route on a CUDA device.  The JAX package avoids per-voxel table
  gathers only because they are slow on its TPU.

The volume is cropped to the mask's bounding box with a margin of one
voxel first; everything outside is background for both, so the result
is unchanged.

The two loops (distance waves, then cleanup passes) are the JAX
package's two ``lax.while_loop``s (arterynetwork_tpu/ops/thinning.py:173,
187): each pass updates state made before the loop in place and runs
through ``ops/grow_loop``, replayed from a captured CUDA graph on a card
with the "lut" route.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import grow_loop
from .edt import edt_squared
from .region_grow import _as_device, _resolve_device
from .simple_point import (_ADJ26, _ADJ6_18, _FACE_IN_18, _N18_IDX,
                           _OFFSETS, build_simple_point_lut, code_bits,
                           neighborhood_codes)

def _neighbor_planes(mask):
    """bool[26, *vol]: plane k = occupancy of neighbor at _OFFSETS[k]
    (zero outside the volume)."""
    Z, Y, X = mask.shape
    mp = F.pad(mask.to(torch.uint8), (1, 1, 1, 1, 1, 1)).to(torch.bool)
    return torch.stack([mp[1 + dz:1 + dz + Z, 1 + dy:1 + dy + Y,
                           1 + dx:1 + dx + X] for dz, dy, dx in _OFFSETS])


def _count_components_planes(occ, adj, n_rounds=8):
    """Component count per voxel of the occupied cube cells.

    occ: bool[C, *vol].  Returns (count int8[*vol], labels int8[C, *vol]).
    """
    C = occ.shape[0]
    shape = (C,) + (1,) * (occ.dim() - 1)
    big = torch.tensor(C, dtype=torch.int8, device=occ.device)
    cell_ids = torch.arange(C, dtype=torch.int8,
                            device=occ.device).reshape(shape)
    labels = torch.where(occ, cell_ids, big)
    nbrs = [torch.tensor(n, device=occ.device) for n in adj]
    for _ in range(n_rounds):
        new_planes = []
        for j, nb in enumerate(adj):
            if nb:
                nmin = labels[nbrs[j]].amin(dim=0)
                new_planes.append(torch.where(
                    occ[j], torch.minimum(labels[j], nmin), big))
            else:
                new_planes.append(labels[j])
        labels = torch.stack(new_planes)
    is_rep = occ & (labels == cell_ids)
    return is_rep.sum(dim=0).to(torch.int8), labels


def _simple_from_planes(planes):
    """T26 == 1 and T6 == 1 per voxel from its neighbor planes
    (bool[26, ...])."""
    # T26 == 1: one 26-component of foreground in N26.  n_rounds=8 is the
    # exact worst case for min-label propagation on the 26-cell
    # 26-adjacency graph.
    n_fg, _ = _count_components_planes(planes, _ADJ26)
    t26_ok = n_fg == 1

    # T6 == 1: one 6-component of background in N18 touching a face cell.
    # The worst case for the 18-cell 6-adjacency graph is 10 rounds.
    bg18 = ~planes[torch.tensor(_N18_IDX, device=planes.device)]
    _, labels = _count_components_planes(bg18, _ADJ6_18, n_rounds=10)
    C18 = len(_N18_IDX)
    cell_ids = torch.arange(C18, dtype=torch.int8, device=planes.device
                            ).reshape((C18,) + (1,) * (planes.dim() - 1))
    is_rep = bg18 & (labels == cell_ids)
    rep_in_face = torch.zeros_like(is_rep)
    big = torch.tensor(C18, dtype=torch.int8, device=planes.device)
    for k in _FACE_IN_18:
        fl = torch.where(bg18[k], labels[k], big)
        rep_in_face |= cell_ids == fl[None]
    n_bg_face = (is_rep & rep_in_face).sum(dim=0).to(torch.int8)
    return t26_ok & (n_bg_face == 1)


def simple_point_mask(mask):
    """Full-grid simple-point predicate (26, 6 topology). bool[*vol]."""
    mask = mask.to(torch.bool)
    return mask & _simple_from_planes(_neighbor_planes(mask))


def _fg_neighbor_count(mask):
    return _neighbor_planes(mask.to(torch.bool)).sum(dim=0,
                                                     dtype=torch.int8)


def _subfield_index(shape, origin=(0, 0, 0), device="cpu"):
    """Parity subfield (0-7) of each voxel, int8, made on ``device``;
    ``origin`` is the volume's offset in the frame whose parities
    count."""
    z, y, x = ((torch.arange(n, device=device) + o).remainder_(2).to(
        torch.int8) for n, o in zip(shape, origin))
    return z[:, None, None] * 4 + y[None, :, None] * 2 + x[None, None, :]


class _Tables(dict):
    """device -> the unpacked table on it; ``clear()`` also drops the
    cached thinnings (``_clear_hooks``), whose graphs read the tables."""

    def clear(self):
        super().clear()
        for hook in _clear_hooks:
            hook()


_clear_hooks = []
_LUTS = _Tables()


def _device_lut(device):
    """The 2^26 simple-point table unpacked to one bool per code (64 MiB),
    kept on ``device`` in ``_LUTS`` (``_device_lut.cache_clear()``
    empties it)."""
    lut = _LUTS.get(device)
    if lut is None:
        bits = np.unpackbits(build_simple_point_lut(device=device),
                             bitorder="little")
        lut = _LUTS[device] = torch.from_numpy(bits).to(device).to(
            torch.bool)
    return lut


_device_lut.cache_clear = _LUTS.clear


def _crop_box(fg):
    """Bounding box of ``fg`` with a margin of one voxel, clipped, as
    slices (None when ``fg`` is empty); one host read."""
    nz = [fg.any(dim=tuple(b for b in range(3) if b != a)) for a in range(3)]
    idx = torch.nonzero(torch.cat(nz)).reshape(-1).cpu().numpy()
    if idx.size == 0:
        return None
    out, off = [], 0
    for a, n in enumerate(fg.shape):
        sel = idx[(idx >= off) & (idx < off + n)] - off
        out.append(slice(max(int(sel[0]) - 1, 0), min(int(sel[-1]) + 2, n)))
        off += n
    return tuple(out)


def _subfield_deletions(fg, code, eligible, preserve_endpoints, lut):
    """The voxels of one subfield deleted at once: ``fg`` voxels with
    ``eligible`` set (at the level, in the subfield) that are simple by
    their 26-bit ``code`` (through ``lut``, or label propagation when it
    is None) and, with ``preserve_endpoints``, not curve endpoints."""
    # ncnt > 0: any fg neighbor; ncnt > 1: at least two
    gate = (code & (code - 1)) != 0 if preserve_endpoints else code != 0
    cand = fg & eligible & gate
    if lut is not None:
        return cand & lut[code]
    idx = torch.nonzero(cand.reshape(-1)).reshape(-1)
    planes = code_bits(code.reshape(-1)[idx]).T
    keep = idx[_simple_from_planes(planes)]
    cand = torch.zeros_like(cand).reshape(-1)
    cand[keep] = True
    return cand.reshape(fg.shape)


def _level2(level):
    """The wave's distance bound, f32(level)^2 + 0.5 in f32, from an int32
    ``level`` on the device."""
    lf = level.to(torch.float32)
    return lf * lf + 0.5


# the device thinnings' cache: per device and thread, at most this many
# entries.  An entry holds the mask's box (fg, an f32 d2 and eight bool
# sub-masks: at Speck scale several GB) between calls, and the pipeline
# repeats a thinning of one mask, so one.
_CACHE_SIZE = 1
_cache = grow_loop.LoopCache(_CACHE_SIZE)


def clear_skeletonize_cache(device=None):
    """Drop this thread's cached device thinnings on ``device`` (or on
    every device)."""
    _cache.clear(device)


def skeletonize_cache_info():
    """The device thinnings' cache: hits, misses, evictions, entries by
    device."""
    return _cache.info()


_clear_hooks.append(_cache.clear)


def _tables():
    """The tables built so far (a loop's ``watch``: none may be built
    while a pass is captured)."""
    return list(_LUTS.values())


class _Thinning(grow_loop.CachedLoop):
    """A cached device thinning, the counterpart of one executable in
    the JAX jit's cache: the box's foreground and band-32 d2, its eight
    parity sub-masks (from the parity of the box's origin), the table
    (or None: label propagation), the loop's scalars (level, stall
    count, pass count, ``deleted``, max d2, ``stop``, the final passes'
    unlimited level) and the two passes, "wave" and "final", which read
    nothing else.  Its key: the box's shape, its origin's parity,
    ``max_waves`` and ``preserve_endpoints`` (the passes take both as
    constants)."""

    def __init__(self, shape, parity, device, max_waves, preserve_endpoints,
                 lut, loop=None):
        super().__init__(device, watch=_tables, loop=loop)
        self.scalars(device, max_waves, preserve_endpoints)
        self.fg = torch.empty(shape, dtype=torch.bool, device=device)
        self.d2 = torch.empty(shape, dtype=torch.float32, device=device)
        subfield = _subfield_index(shape, parity, device)
        self.sub_masks = [subfield == sf for sf in range(8)]
        self.lut = lut

    def scalars(self, device, max_waves, preserve_endpoints):
        """The loop's scalars on ``device`` and its two constants."""
        self.level = torch.ones((), dtype=torch.int32, device=device)
        self.stalled, self.it, self.stop = (torch.zeros_like(self.level)
                                            for _ in range(3))
        self.deleted = torch.zeros((), dtype=torch.bool, device=device)
        self.max_d2 = torch.zeros((), dtype=torch.float32, device=device)
        self.far = torch.full((), 1e12, dtype=torch.float32, device=device)
        self.max_waves = max_waves
        self.preserve_endpoints = preserve_endpoints

    def reset(self):
        self.level.fill_(1)
        for t in (self.stalled, self.it, self.stop, self.deleted,
                  self.max_d2):
            t.zero_()

    def load(self, fg, d2):
        """Copy a call's box and d2 in; reset the scalars."""
        self.fg.copy_(fg)
        self.d2.copy_(d2)
        self.reset()

    def delete_pass(self, level2):
        """One peel attempt at the distance bound ``level2``; 8
        subfields.  Sets ``deleted``: anything deleted."""
        fg, deleted = self.fg, self.deleted
        at_level = self.d2 <= level2
        deleted.zero_()
        for sf in range(8):
            cand = _subfield_deletions(fg, neighborhood_codes(fg),
                                       at_level & self.sub_masks[sf],
                                       self.preserve_endpoints, self.lut)
            fg.logical_and_(~cand)
            deleted.logical_or_(cand.any())

    def fg_max_d2(self):
        """The largest d2 of a foreground voxel (0 with none)."""
        return torch.where(self.fg, self.d2, 0.0).max()

    def wave_stop(self):
        """Go on while f32(level)^2 <= max fg d2 + 2 and stalled < max."""
        self.max_d2.copy_(self.fg_max_d2())
        lf = self.level.to(torch.float32)
        self.stop.copy_(torch.where((lf * lf <= self.max_d2 + 2.0)
                                    & (self.stalled < self.max_waves),
                                    -1, 0))

    def wave_step(self):
        level, deleted = self.level, self.deleted
        self.delete_pass(_level2(level))
        # stay at this level until stable, then move outward
        torch.where(deleted, level, level + 1, out=level)
        self.stalled.copy_(torch.where(deleted, 0, self.stalled + 1))
        self.wave_stop()

    def final_step(self):
        """A cleanup pass at unlimited level; go on while it deleted."""
        self.delete_pass(self.far)
        self.it.add_(1)
        self.stop.copy_(torch.where(self.deleted
                                    & (self.it < self.max_waves), -1, 0))

    def run(self):
        """The wave loop and the final loop, in the entry's loop (inside
        its ``stream()``): 1 + wave passes + final passes reads, or one
        read and no pass with no foreground."""
        loop = self.loop
        self.wave_stop()
        self.stop.copy_(torch.where(self.max_d2 == 0, 1,
                                    self.stop))     # 1: no foreground
        go = loop.read(self.stop)
        if go == 1:
            return
        while go < 0:
            loop.run("wave", self.wave_step)
            go = loop.read(self.stop)
        if self.max_waves > 0:
            loop.run("final", self.final_step)
            while loop.read(self.stop) < 0:
                loop.run("final", self.final_step)


@grow_loop.frees_loop_caches
def skeletonize(mask, max_waves: int = 64, preserve_endpoints: bool = True,
                device=None, predicate: str = "auto"):
    """Thin a binary volume to its curve skeleton, on ``device`` (by
    default the device of a ``mask`` tensor; host arrays go to the card).

    Returns a bool tensor of centerline voxels.  Topology (26-fg / 6-bg)
    is preserved; curve endpoints are kept so terminal branches survive.
    ``predicate`` picks the simple-point route: "lut", "labels" or
    "auto" (the table on a CUDA device, label propagation elsewhere).

    Each pass (8 subfields) updates the box's mask, level, stall count,
    pass count and ``stop`` in place.  The "lut" route runs its passes
    in ``grow_loop.loop_for(device)``: on a CUDA device a ``GraphLoop``
    whose two keys, "wave" and "final", each run eagerly once, are
    captured as a CUDA graph on their second pass and replayed after
    (a capture that fails raises).  The "labels" route finds its
    candidates with ``torch.nonzero``, a host sync that capture refuses,
    so it runs in a ``HostLoop`` on any device.  The host reads ``stop``
    once before the wave loop and once after each pass of either loop
    (the final loop's first condition is known on the host): 1 + wave
    passes + final passes reads, besides the crop box's one read before
    the loops.

    On the "lut" route, as ``jax.jit`` compiles the thinning once per
    shape and static arguments, the passes and every tensor they read
    lie in a cached entry (``_Thinning``; its docstring lists what it
    holds and its key).  The box comes from a host read, so its shape
    and origin's parity are in the key: calls on one mask (the
    pipeline's repeats) hit, a mask with another box misses.  A call
    copies its box and d2 in; on a hit every pass is a replay and
    nothing is captured; a miss captures as above and, at the call's
    end, each key that ran once.  ``_LUTS.clear()`` drops the entries.
    The last call's counts are ``skeletonize.wave_passes``,
    ``.final_passes``, ``.reads``, ``.captures``, ``.replays``,
    ``.capture_s`` and ``.hit``.
    """
    device = _resolve_device(mask, device)
    full = _as_device(mask, device) != 0
    if predicate == "auto":
        predicate = "lut" if device.type == "cuda" else "labels"
    if predicate not in ("lut", "labels"):
        raise ValueError(f"unknown predicate {predicate!r}")
    _count(grow_loop.HostLoop())
    box = _crop_box(full)
    if box is None:
        return full
    fg = full[box]
    shape = tuple(fg.shape)
    parity = tuple(s.start % 2 for s in box)
    d2 = edt_squared(fg, band=32)
    out = torch.zeros_like(full)
    if predicate == "labels":   # the call's own buffers, no entry
        thin = _Thinning(shape, parity, device, max_waves,
                         preserve_endpoints, None, grow_loop.HostLoop())
        thin.load(fg, d2)
        thin.run()
        _count(thin.loop)
        out[box] = thin.fg
        return out
    lut = _device_lut(device)
    with _cache.use(device, (shape, parity, max_waves, preserve_endpoints),
                    lambda: _Thinning(shape, parity, device, max_waves,
                                      preserve_endpoints, lut)
                    ) as (thin, hit):
        thin.load(fg, d2)
        fg = d2 = None          # the call's copies, no longer read
        with thin.loop.stream():
            thin.run()
            thin.loop.capture_pending()
        out[box] = thin.fg
    _count(thin.loop, hit)
    return out


def _count(loop, hit=False):
    """``skeletonize``'s counts from the loop its passes ran in."""
    skeletonize.hit = hit
    skeletonize.wave_passes = loop.runs.get("wave", 0)
    skeletonize.final_passes = loop.runs.get("final", 0)
    skeletonize.reads = loop.reads
    skeletonize.captures = loop.captures
    skeletonize.replays = loop.replays
    skeletonize.capture_s = loop.capture_s


_count(grow_loop.HostLoop())
