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
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

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


def _subfield_index(shape, origin=(0, 0, 0)):
    """Parity subfield (0-7) of each voxel; ``origin`` is the volume's
    offset in the frame whose parities count."""
    z = (np.arange(shape[0]) + origin[0]) % 2
    y = (np.arange(shape[1]) + origin[1]) % 2
    x = (np.arange(shape[2]) + origin[2]) % 2
    return (z[:, None, None] * 4 + y[None, :, None] * 2
            + x[None, None, :]).astype(np.int8)


@functools.lru_cache(maxsize=None)
def _device_lut(device):
    """The 2^26 simple-point table unpacked to one bool per code (64 MiB),
    kept on ``device``."""
    bits = np.unpackbits(build_simple_point_lut(device=device),
                         bitorder="little")
    return torch.from_numpy(bits).to(device).to(torch.bool)


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


def skeletonize(mask, max_waves: int = 64, preserve_endpoints: bool = True,
                device=None, predicate: str = "auto"):
    """Thin a binary volume to its curve skeleton, on ``device`` (by
    default the device of a ``mask`` tensor; host arrays go to the card).

    Returns a bool tensor of centerline voxels.  Topology (26-fg / 6-bg)
    is preserved; curve endpoints are kept so terminal branches survive.
    ``predicate`` picks the simple-point route: "lut", "labels" or
    "auto" (the table on a CUDA device, label propagation elsewhere).
    The host reads one pair (any deletion, max foreground d2) per pass.
    """
    device = _resolve_device(mask, device)
    full = _as_device(mask, device) != 0
    if predicate == "auto":
        predicate = "lut" if device.type == "cuda" else "labels"
    if predicate not in ("lut", "labels"):
        raise ValueError(f"unknown predicate {predicate!r}")
    box = _crop_box(full)
    if box is None:
        return full
    fg = full[box].contiguous()
    origin = tuple(s.start for s in box)
    d2 = edt_squared(fg, band=32)
    subfield = torch.from_numpy(_subfield_index(fg.shape, origin)).to(device)
    sub_masks = [subfield == sf for sf in range(8)]
    lut = _device_lut(device) if predicate == "lut" else None

    def delete_pass(fg, level2):
        """One peel attempt at the current distance level; 8 subfields.
        Returns the new fg and a device flag: anything deleted."""
        at_level = d2 <= level2
        deleted = torch.zeros((), dtype=torch.bool, device=device)
        for sf in range(8):
            cand = _subfield_deletions(fg, neighborhood_codes(fg),
                                       at_level & sub_masks[sf],
                                       preserve_endpoints, lut)
            fg = fg & ~cand
            deleted |= cand.any()
        return fg, deleted

    def read(deleted, fg):
        """(deleted, max d2 over fg) in one host read."""
        max_d2 = torch.where(fg, d2, 0.0).max()
        pair = torch.stack([deleted.to(torch.float32), max_d2]).cpu()
        return bool(pair[0]), np.float32(pair[1])

    _, max_d2 = read(torch.zeros((), dtype=torch.bool, device=device), fg)
    level, stalled = 1, 0
    while (np.float32(level) ** 2 <= max_d2 + np.float32(2.0)
           and stalled < max_waves):
        level2 = float(np.float32(level) ** 2 + np.float32(0.5))
        fg, deleted = delete_pass(fg, level2)
        deleted, max_d2 = read(deleted, fg)
        # stay at this level until stable, then move outward
        level, stalled = (level, 0) if deleted else (level + 1, stalled + 1)

    # final cleanup passes at unlimited level until fixed point
    deleted, it = True, 0
    while deleted and it < max_waves:
        fg, deleted = delete_pass(fg, 1e12)
        deleted, _ = read(deleted, fg)
        it += 1
    out = torch.zeros_like(full)
    out[box] = fg
    return out
