"""Plain checks of a thinning's result and of the branches cut from it.

The sequential thinning visits voxels in an order that its result
depends on, so a plain copy would cost minutes a volume.  The reference
instead holds the skeleton to what defines the end of a thinning by
simple points that keeps its curve ends, and the branches to what the
pruning rules may take away:

* ``removable``: skeleton voxels that are simple points, by the (26, 6)
  test of Bertrand and Malandain, and have two or more skeleton
  neighbours.  A finished thinning leaves none.
* ``euler``: the Euler characteristic of the closed cubes of a voxel
  set; deleting simple points keeps it, so the skeleton's equals the
  mask's.
* ``coverage``: each skeleton voxel's distance, in steps along the
  skeleton, to the nearest branch voxel, over what pruning may take at
  that point: max(prune_min_length, prune_radius_factor x the radius
  there).  A dropped branch reads its length over that.
* ``branch_components``: connected pieces of the branches, joined where
  they share a voxel, against the skeleton's components that hold one.
"""

from __future__ import annotations

import itertools

import numpy as np
import scipy.ndimage as ndi
import scipy.sparse as sp
import scipy.sparse.csgraph as csg
import torch

OFFS = np.asarray(list(itertools.product((-1, 0, 1), repeat=3)), np.int64)
CENTRE = 13
FULL = np.ones((3, 3, 3), bool)
PAD = 27        # a column that is never active


def _adjacency(nodes, near):
    """[27, width] neighbour table over ``nodes`` (others padded)."""
    rows = []
    for i in range(27):
        rows.append([j for j in nodes if j != i and i in nodes
                     and near(OFFS[i], OFFS[j])])
    width = max(len(r) for r in rows)
    return np.asarray([r + [PAD] * (width - len(r)) for r in rows], np.int64)


N26 = [i for i in range(27) if i != CENTRE]
N18 = [i for i in N26 if np.abs(OFFS[i]).sum() <= 2]
FACES = [i for i in N26 if np.abs(OFFS[i]).sum() == 1]
ADJ26 = _adjacency(N26, lambda a, b: np.abs(a - b).max() == 1)
ADJ6 = _adjacency(N18, lambda a, b: np.abs(a - b).sum() == 1)


def _components(active, adj):
    """Per row, the smallest position of each position's component
    among the active positions of [n, 27] ``active`` (others PAD)."""
    n = active.shape[0]
    lab = np.where(active, np.arange(27)[None, :], PAD)
    lab = np.concatenate([lab, np.full((n, 1), PAD)], 1)
    while True:
        new = np.minimum(lab[:, :27], lab[:, adj].min(2))
        new = np.where(active, new, PAD)
        if np.array_equal(new, lab[:, :27]):
            return new
        lab[:, :27] = new


def simple(nbhd):
    """Whether each centre of [n, 27] bool neighbourhoods is a simple
    point for 26-connected foreground and 6-connected background."""
    nbhd = np.asarray(nbhd, bool)
    fg = nbhd.copy()
    fg[:, CENTRE] = False
    lab = _components(fg, ADJ26)
    c26 = (lab == np.arange(27)[None, :]).sum(1)
    bg = np.zeros_like(nbhd)
    bg[:, N18] = ~nbhd[:, N18]
    lab = np.sort(_components(bg, ADJ6)[:, FACES], 1)
    c6 = ((lab != PAD) & np.concatenate(
        [np.ones((len(lab), 1), bool), lab[:, 1:] != lab[:, :-1]], 1)).sum(1)
    return (c26 == 1) & (c6 == 1)


def _crop(*vols):
    """The volumes cut to the first's foreground box, padded by one."""
    m = np.asarray(vols[0]) != 0
    idx = np.nonzero(m.any((1, 2)))[0], np.nonzero(m.any((0, 2)))[0], \
        np.nonzero(m.any((0, 1)))[0]
    if not len(idx[0]):
        return [np.zeros((3, 3, 3), bool) for _ in vols], np.zeros(3, int)
    box = tuple(slice(i[0], i[-1] + 1) for i in idx)
    return ([np.pad(np.asarray(v)[box] != 0, 1) for v in vols],
            np.asarray([i[0] - 1 for i in idx]))


def neighbourhoods(vol, coords):
    """[n, 27] values of ``vol`` around ``coords`` [n, 3] (inside the
    volume, at least one voxel off each face)."""
    c = np.asarray(coords, np.int64)[:, None, :] + OFFS[None]
    return np.asarray(vol)[c[..., 0], c[..., 1], c[..., 2]]


def removable(skeleton):
    """Skeleton voxels that a thinning keeping curve ends would still
    delete."""
    (skel,), _ = _crop(skeleton)
    pts = np.argwhere(skel)
    if not len(pts):
        return 0
    nb = neighbourhoods(skel, pts)
    ends = nb.sum(1) - 1 <= 1
    return int(np.count_nonzero(simple(nb) & ~ends))


def euler(vol, device="cpu"):
    """Euler characteristic of the union of the closed unit cubes of the
    foreground voxels: vertices - edges + faces - cubes."""
    (v,), _ = _crop(vol)
    v = torch.as_tensor(v, device=device)

    def any_of(axes):
        out = v
        for a in axes:
            n = out.shape[a]
            out = out.narrow(a, 0, n - 1) | out.narrow(a, 1, n - 1)
        return int(out.sum())

    cubes = int(v.sum())
    faces = sum(any_of((a,)) for a in range(3))
    edges = sum(any_of(ax) for ax in ((1, 2), (0, 2), (0, 1)))
    verts = any_of((0, 1, 2))
    return verts - edges + faces - cubes


class Skeleton:
    """The skeleton's voxels with their 26-neighbours, components and
    distances to the mask's edge."""

    def __init__(self, skeleton, dist_of):
        (skel,), self.origin = _crop(skeleton)
        self.shape = skel.shape
        pts = np.argwhere(skel)
        self.coords = pts + self.origin
        self.flat = np.ravel_multi_index(pts.T, skel.shape)
        nb = (pts[:, None, :] + OFFS[None, N26]).reshape(-1, 3)
        nflat = np.ravel_multi_index(nb.T, skel.shape).reshape(len(pts), 26)
        pos = np.searchsorted(self.flat, nflat)
        pos = np.minimum(pos, max(len(self.flat) - 1, 0))
        hit = (self.flat[pos] == nflat) if len(pts) else pos.astype(bool)
        self.nbr = np.where(hit, pos, -1)
        lab, _ = ndi.label(skel, structure=FULL)
        self.component = lab[tuple(pts.T)]
        self.radius = np.asarray([dist_of[tuple(c)] for c in
                                  self.coords.tolist()], np.float64)

    def index(self, coords):
        """Positions of voxel ``coords`` [n, 3] in ``self.coords``
        (-1 where a voxel is not on the skeleton)."""
        c = np.asarray(coords, np.int64).reshape(-1, 3) - self.origin
        if not len(self.flat):
            return np.full(len(c), -1, np.int64)
        inside = ((c >= 0) & (c < np.asarray(self.shape))).all(1)
        flat = np.ravel_multi_index(c.T, self.shape, mode="clip")
        pos = np.minimum(np.searchsorted(self.flat, flat), len(self.flat) - 1)
        return np.where(inside & (self.flat[pos] == flat), pos, -1)


def coverage(skel, on_branch, min_length, radius_factor):
    """The largest reach, over the skeleton's voxels, of the nearest
    branch voxel along the skeleton, as a share of what pruning may take
    there.  ``on_branch``: positions in ``skel`` of the branch voxels."""
    n = len(skel.coords)
    if not n:
        return 0.0
    dist = np.full(n, -1, np.int64)
    src = np.full(n, -1, np.int64)
    front = np.unique(np.asarray(on_branch, np.int64))
    dist[front] = 0
    src[front] = front
    step = 0
    while len(front):
        step += 1
        nb = skel.nbr[front]
        par = np.repeat(front, 26)
        nb = nb.reshape(-1)
        ok = nb >= 0
        nb, par = nb[ok], par[ok]
        ok = dist[nb] < 0
        nb, first = np.unique(nb[ok], return_index=True)
        dist[nb] = step
        src[nb] = src[par[ok][first]]
        front = nb
    allow = np.maximum(float(min_length),
                       radius_factor * skel.radius[np.maximum(src, 0)])
    reach = np.where(dist >= 0, dist / allow, 0.0)
    lost = dist < 0
    if lost.any():
        # whole components without a branch: their size over what
        # pruning may take at their widest
        comp = skel.component[lost]
        size = np.bincount(comp)
        widest = np.zeros(len(size))
        np.maximum.at(widest, comp, skel.radius[lost])
        allow = np.maximum(float(min_length), radius_factor * widest)
        keep = size > 0
        reach = np.concatenate([reach, size[keep] / allow[keep]])
    return float(reach.max())


def branch_components(skel, segments_pos):
    """|components of the branches joined where they share a voxel -
    skeleton components that hold a branch voxel|.  ``segments_pos``:
    per branch, its voxels' positions in ``skel`` (all on it)."""
    a = np.concatenate([p[:-1] for p in segments_pos] + [np.zeros(0, int)])
    b = np.concatenate([p[1:] for p in segments_pos] + [np.zeros(0, int)])
    used = np.unique(np.concatenate([p for p in segments_pos]
                                    + [np.zeros(0, int)]))
    if not len(used):
        return 0
    n = len(skel.coords)
    g = sp.coo_matrix((np.ones(len(a)), (a, b)), shape=(n, n))
    _, lab = csg.connected_components(g, directed=False)
    pieces = len(np.unique(lab[used]))
    comps = len(np.unique(skel.component[used]))
    return abs(pieces - comps)
