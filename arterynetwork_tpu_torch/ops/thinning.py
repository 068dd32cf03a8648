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


_LUTS = {}          # device -> the unpacked table on it


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
    the loops.  The last call's counts are ``skeletonize.wave_passes``,
    ``.final_passes``, ``.reads``, ``.captures``, ``.replays`` and
    ``.capture_s``.
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
    fg = full[box].contiguous()
    origin = tuple(s.start for s in box)
    d2 = edt_squared(fg, band=32)
    subfield = _subfield_index(fg.shape, origin, device)
    sub_masks = [subfield == sf for sf in range(8)]
    lut = _device_lut(device) if predicate == "lut" else None
    level = torch.ones((), dtype=torch.int32, device=device)
    stalled, it, stop = (torch.zeros_like(level) for _ in range(3))
    deleted = torch.zeros((), dtype=torch.bool, device=device)
    max_d2 = torch.zeros((), dtype=torch.float32, device=device)
    far = torch.full((), 1e12, dtype=torch.float32, device=device)

    def delete_pass(level2):
        """One peel attempt at the distance bound ``level2``; 8
        subfields.  Sets ``deleted``: anything deleted."""
        at_level = d2 <= level2
        deleted.zero_()
        for sf in range(8):
            cand = _subfield_deletions(fg, neighborhood_codes(fg),
                                       at_level & sub_masks[sf],
                                       preserve_endpoints, lut)
            fg.logical_and_(~cand)
            deleted.logical_or_(cand.any())

    def wave_stop():
        """Go on while f32(level)^2 <= max fg d2 + 2 and stalled < max."""
        max_d2.copy_(torch.where(fg, d2, 0.0).max())
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

    loop = (grow_loop.loop_for(device, watch=lambda: list(_LUTS.values()))
            if lut is not None else grow_loop.HostLoop())
    with loop.stream():
        wave_stop()
        while loop.read(stop) < 0:
            loop.run("wave", wave_step)
        if max_waves > 0:
            loop.run("final", final_step)
            while loop.read(stop) < 0:
                loop.run("final", final_step)
    _count(loop)
    out = torch.zeros_like(full)
    out[box] = fg
    return out


def _count(loop):
    """``skeletonize``'s counts from the loop its passes ran in."""
    skeletonize.wave_passes = loop.runs.get("wave", 0)
    skeletonize.final_passes = loop.runs.get("final", 0)
    skeletonize.reads = loop.reads
    skeletonize.captures = loop.captures
    skeletonize.replays = loop.replays
    skeletonize.capture_s = loop.capture_s


_count(grow_loop.HostLoop())
