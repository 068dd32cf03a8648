"""Plain references of the volume pipeline's later stages.

* ``hysteresis_mask``: thresholds at fractions of the vesselness range,
  the 26-connected components of the weak mask that hold a strong voxel
  and have more than ``min_size`` voxels (scipy.ndimage.label), none
  within ``margin`` voxels of a face.
* ``edt_at``: the Euclidean distance from chosen voxels of a mask to the
  nearest voxel outside it, by a search over offsets in order of distance.
* ``branch_radius`` / ``branch_length``: a branch's mean distance over
  the interior voxels that it alone covers (a two-voxel branch, or one
  with no such voxel, takes the mean of its measured neighbours at each
  end), and its path length.
"""

from __future__ import annotations

import numpy as np
import scipy.ndimage as ndi
import torch

FULL = np.ones((3, 3, 3), bool)


def hysteresis_mask(v, weak_frac, strong_frac, margin, min_size):
    vmin = v.min()
    rng = v.max() - vmin
    weak = v > vmin + weak_frac * rng
    strong = v > vmin + strong_frac * rng
    if margin:
        core = torch.zeros_like(weak)
        core[margin:-margin, margin:-margin, margin:-margin] = True
        weak &= core
        strong &= core
    weak = weak.cpu().numpy()
    strong = strong.cpu().numpy()
    labels, n = ndi.label(weak, structure=FULL)
    sizes = np.bincount(labels.reshape(-1), minlength=n + 1)
    hit = np.zeros(n + 1, bool)
    hit[np.unique(labels[strong])] = True
    keep = hit & (sizes > min_size)
    keep[0] = False
    return keep[labels].astype(np.uint8)


def components(mask):
    return int(ndi.label(np.asarray(mask) != 0, structure=FULL)[1])


def edt_at(mask, points, device, reach=10, chunk=1024):
    """Distances [P] from ``points`` [P, 3] (voxels of ``mask``) to the
    nearest zero of ``mask``; voxels outside the volume do not count."""
    m = torch.as_tensor(np.asarray(mask) != 0, device=device)
    shape = torch.tensor(m.shape, device=device)
    g = torch.arange(-reach, reach + 1, device=device)
    offs = torch.stack(torch.meshgrid(g, g, g, indexing="ij"),
                       -1).reshape(-1, 3)
    d2 = (offs * offs).sum(1)
    order = torch.argsort(d2, stable=True)
    offs, d2 = offs[order], d2[order]
    pts = torch.as_tensor(np.asarray(points, np.int64), device=device)
    out = torch.empty(len(pts), dtype=torch.float64, device=device)
    for s in range(0, len(pts), chunk):
        c = pts[s:s + chunk, None, :] + offs[None]
        inside = ((c >= 0) & (c < shape)).all(-1)
        c = torch.minimum(torch.clamp(c, min=0), shape - 1)
        bg = inside & ~m[c[..., 0], c[..., 1], c[..., 2]]
        first = torch.argmax(bg.to(torch.uint8), dim=1)
        if not bool(bg.any(1).all()):
            raise RuntimeError("edt_at: no background within reach")
        out[s:s + chunk] = torch.sqrt(d2[first].to(torch.float64))
    return out.cpu().numpy()


def branch_radius(segments, dist_of):
    """Mean radius per branch; ``dist_of`` maps a voxel tuple to its
    distance."""
    count = {}
    for seg in segments:
        for i, v in enumerate(seg):
            v = tuple(int(x) for x in v)
            count[v] = count.get(v, 0) + (1 if i in (0, len(seg) - 1) else 2)
    radius = [None] * len(segments)
    for i, seg in enumerate(segments):
        inner = [tuple(int(x) for x in v) for v in seg[1:-1]]
        inner = [v for v in inner if count[v] == 2]
        if len(seg) > 2 and inner:
            radius[i] = float(np.mean([dist_of[v] for v in inner]))
    ends = {}
    for i, seg in enumerate(segments):
        for v in (seg[0], seg[-1]):
            ends.setdefault(tuple(int(x) for x in v), []).append(i)

    out = list(radius)

    def end_radius(v, i):
        rs = [out[j] for j in ends[tuple(int(x) for x in v)]
              if j != i and out[j] is not None]
        return float(np.mean(rs)) if rs else 0.0

    for i, seg in enumerate(segments):
        if out[i] is None:
            h, t = end_radius(seg[0], i), end_radius(seg[-1], i)
            out[i] = (h + t) / 2.0 if (h and t) else (h or t or 0.0)
    return np.asarray(out, np.float64)


def branch_length(seg):
    c = np.asarray(seg, np.float64)
    if len(c) < 2:
        return 0.0
    return float(np.sqrt((np.diff(c, axis=0) ** 2).sum(1)).sum())


def inner_points(segments):
    """Every voxel of every branch, once: [P, 3]."""
    pts = {tuple(int(x) for x in v) for seg in segments for v in seg}
    return np.asarray(sorted(pts), np.int64).reshape(-1, 3)
