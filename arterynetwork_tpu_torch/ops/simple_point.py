"""Simple-point predicate for 3D thinning, derived from first principles.

Port of the JAX package's ops/simple_point.py.  A foreground voxel p is
*simple* (deletable without changing topology) iff

  T26(p) = 1:  the foreground restricted to the 26-neighborhood of p forms
               exactly one 26-connected component, and
  T6(p)  = 1:  the background restricted to the 18-neighborhood forms
               exactly one 6-connected component containing a face
               neighbor of p

(Bertrand & Malandain's local characterization of simple points for
(26, 6) digital topology).  Both counts are tiny graph component counts
over the 3x3x3 cube, so the predicate over all 2^26 neighborhood
configurations is *computed* here by vectorized label propagation on a
device and cached as a bit-packed lookup table (8 MiB) under the
repository's ``build/`` directory.
"""

from __future__ import annotations

import os

import numpy as np
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_CACHE_DIR = os.path.join(_REPO, "build", "simple_point")
_CACHE_NAME = "simple_point_lut_v1.npy"

# ---------------------------------------------------------------------
# Neighborhood geometry (fixed, tiny)
# ---------------------------------------------------------------------
# Order the 26 neighbors by their offset index in the 3x3x3 cube scan
# (dz, dy, dx) lexicographic, skipping (0,0,0).  Bit k of a neighborhood
# code is the occupancy of _OFFSETS[k].
_OFFSETS = [(dz, dy, dx)
            for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
            if not (dz == 0 and dy == 0 and dx == 0)]
N_NEIGHBORS = len(_OFFSETS)  # 26


def _adjacency(conn: int, cells):
    """Adjacency lists between cube cells under a connectivity rule.

    conn=26: cells adjacent if Chebyshev distance 1.
    conn=6: cells adjacent if Manhattan distance 1.
    """
    adj = []
    for i, a in enumerate(cells):
        row = []
        for j, b in enumerate(cells):
            if i == j:
                continue
            d = [abs(a[k] - b[k]) for k in range(3)]
            if conn == 26 and max(d) == 1:
                row.append(j)
            elif conn == 6 and sum(d) == 1:
                row.append(j)
        adj.append(row)
    return adj


_ADJ26 = _adjacency(26, _OFFSETS)
# 18-neighborhood = offsets with Manhattan distance <= 2 and Chebyshev 1
_N18_IDX = [i for i, o in enumerate(_OFFSETS) if sum(map(abs, o)) <= 2]
_N18_OFFSETS = [_OFFSETS[i] for i in _N18_IDX]
_ADJ6_18 = _adjacency(6, _N18_OFFSETS)
_FACE_IN_18 = [k for k, o in enumerate(_N18_OFFSETS) if sum(map(abs, o)) == 1]


def _propagate(masks, adj, rounds):
    """Jacobi min-label propagation over the cube cells: each round every
    True cell takes the min of its own and its neighbours' labels of the
    previous round.  masks: bool[batch, C] -> int32 labels (C = empty)."""
    batch, C = masks.shape
    ids = torch.arange(C, dtype=torch.int32, device=masks.device)[None, :]
    big = torch.tensor(C, dtype=torch.int32, device=masks.device)
    labels = torch.where(masks, ids, big)
    nbrs = [torch.tensor(n, device=masks.device) for n in adj]
    for _ in range(rounds):
        new = labels.clone()
        for j, nb in enumerate(adj):
            if not nb:
                continue
            neighbor_min = labels[:, nbrs[j]].amin(dim=1)
            new[:, j] = torch.where(masks[:, j],
                                    torch.minimum(new[:, j], neighbor_min),
                                    big)
        labels = new
    return labels


def _count_components(masks, adj, seed_cells=None):
    """#components of True cells (restricted to ``seed_cells`` roots) via
    min-label propagation.  masks: bool[batch, C]."""
    labels = _propagate(masks, adj, 8)
    if seed_cells is None:
        roots, lab = masks, labels
        rep = list(range(lab.shape[1]))
    else:
        sc = torch.tensor(seed_cells, device=masks.device)
        roots, lab = masks[:, sc], labels[:, sc]
        rep = list(seed_cells)
    # a label is counted where it equals the cell's own index (component
    # representative)
    is_rep = roots & (lab == torch.tensor(rep, dtype=torch.int32,
                                          device=masks.device)[None, :])
    return is_rep.sum(dim=1, dtype=torch.int32)


def _component_count_all(masks, adj):
    """#components over all True cells. masks: bool[batch, C]."""
    C = masks.shape[1]
    labels = _propagate(masks, adj, 10)
    ids = torch.arange(C, dtype=torch.int32, device=masks.device)[None, :]
    is_rep = masks & (labels == ids)
    return is_rep.sum(dim=1, dtype=torch.int32), labels


def simple_point_batch(neighborhoods, device=None):
    """Evaluate the simple-point predicate for bool[batch, 26] configs
    (a tensor stays on its device; host arrays go to ``device``, by
    default the card)."""
    from .region_grow import _as_device, _resolve_device

    fg = _as_device(neighborhoods, _resolve_device(neighborhoods, device),
                    torch.bool)
    # T26: one 26-connected fg component in N26
    n_fg, _ = _component_count_all(fg, _ADJ26)
    t26_ok = n_fg == 1

    # T6: one 6-connected bg component in N18 touching a face neighbor
    C18 = len(_N18_IDX)
    bg18 = ~fg[:, torch.tensor(_N18_IDX, device=fg.device)]
    _, labels = _component_count_all(bg18, _ADJ6_18)
    face = torch.tensor(_FACE_IN_18, device=fg.device)
    face_labels = torch.where(bg18[:, face], labels[:, face],
                              torch.tensor(C18, dtype=torch.int32,
                                           device=fg.device))
    ids = torch.arange(C18, dtype=torch.int32, device=fg.device)[None, :]
    # count distinct representatives among all bg cells that are the min
    # label of some face-adjacent component
    is_rep = bg18 & (labels == ids)
    rep_in_face = torch.zeros_like(is_rep)
    for k in range(len(_FACE_IN_18)):
        rep_in_face |= ids == face_labels[:, k:k + 1]
    n_bg_face = (is_rep & rep_in_face).sum(dim=1, dtype=torch.int32)
    t6_ok = n_bg_face == 1
    return t26_ok & t6_ok


def code_bits(codes):
    """int tensor of 26-bit codes -> bool[len, 26] (bit k = _OFFSETS[k])."""
    k = torch.arange(N_NEIGHBORS, dtype=codes.dtype, device=codes.device)
    return ((codes[:, None] >> k[None, :]) & 1).to(torch.bool)


def build_simple_point_lut(cache_dir: str | None = None,
                           chunk_bits: int = 20,
                           device="cuda") -> np.ndarray:
    """Compute on ``device`` (or load) the bit-packed 2^26 simple-point
    LUT.

    Returns uint8[2^23]: bit i of byte i>>3 is the predicate for
    neighborhood code i (bit k of the code = occupancy of _OFFSETS[k]).
    The table is cached under ``cache_dir`` (by default the repository's
    ``build/simple_point/``).
    """
    cache_dir = _CACHE_DIR if cache_dir is None else cache_dir
    path = os.path.join(cache_dir, _CACHE_NAME)
    if os.path.exists(path):
        return np.load(path)
    n_total = 1 << N_NEIGHBORS
    chunk = 1 << chunk_bits
    out_bits = torch.empty(n_total, dtype=torch.bool, device=device)
    for start in range(0, n_total, chunk):
        codes = torch.arange(start, start + chunk, dtype=torch.int32,
                             device=device)
        out_bits[start:start + chunk] = simple_point_batch(code_bits(codes))
    lut = _pack_bits(out_bits.cpu().numpy())
    os.makedirs(cache_dir, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npy"
    np.save(tmp, lut)
    os.replace(tmp, path)
    return lut


def _pack_bits(bits: np.ndarray) -> np.ndarray:
    """bool[8n] -> uint8[n], bit i of byte i>>3 = bits[i] (LSB first, the
    JAX package's and the native library's table order)."""
    return np.packbits(bits.reshape(-1, 8)[:, ::-1])


def lut_lookup(lut: np.ndarray, codes: np.ndarray) -> np.ndarray:
    """Evaluate the packed LUT at integer neighborhood codes."""
    codes = np.asarray(codes)
    return (lut[codes >> 3] >> (codes & 7)) & 1


def neighborhood_codes(mask):
    """26-bit neighborhood occupancy code per voxel (int32, zero outside
    the volume; bit k = _OFFSETS[k]), on the device of a ``mask`` tensor.
    Built separably: 3-bit x runs, 9-bit planes, then the 27-bit cube
    with the centre bit (13) squeezed out."""
    m = torch.as_tensor(np.asarray(mask) if not torch.is_tensor(mask)
                        else mask).to(torch.int32)
    Z, Y, X = m.shape
    f = torch.nn.functional.pad(m, (1, 1, 1, 1, 1, 1))
    r = f[:, :, 0:X] | (f[:, :, 1:X + 1] << 1) | (f[:, :, 2:X + 2] << 2)
    p = r[:, 0:Y] | (r[:, 1:Y + 1] << 3) | (r[:, 2:Y + 2] << 6)
    c = p[0:Z] | (p[1:Z + 1] << 9) | (p[2:Z + 2] << 18)
    return (c & 0x1FFF) | ((c >> 14) << 13)
