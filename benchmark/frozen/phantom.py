"""Frozen copy of the vascular-tree phantom, the volume cells' traffic.

Tree growth: arterynetwork_tpu_torch/utils/phantoms.py:45-123
(``vascular_tree_phantom``, the random walk and Murray splits, unchanged).
Rasterisation (:125-135) and the raw intensities (``phantom_raw_volume``,
:146-155) are rewritten to run on a torch device: the balls are stamped
with one scatter per radius, and the background noise comes from a
``torch.Generator`` on that device.  The volume therefore differs from the
original's numpy noise in its draws, not in its distribution.

This file is part of the benchmark's yardstick: later changes to the
program do not edit it.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _unit(v):
    n = float(np.linalg.norm(v))
    return v / n if n > 0 else np.array([0.0, 0.0, 1.0])


def _ball_offsets(radius: float):
    r = int(math.ceil(radius))
    g = np.mgrid[-r:r + 1, -r:r + 1, -r:r + 1]
    d2 = (g ** 2).sum(axis=0)
    return np.argwhere(d2 <= radius * radius + 1e-9) - r


def grow_tree(shape, n_branches=400, root_radius=6.0, min_radius=1.0,
              branch_length=(25, 70), curvature=0.12, rng=None):
    """Centerlines and radii of a random arterial tree (phantoms.py:45-123).
    Returns (centerlines, radii, root voxel)."""
    shape = tuple(int(s) for s in shape)
    lo = np.asarray([root_radius + 2] * 3)
    hi = np.asarray(shape, float) - root_radius - 3
    extent = hi - lo
    root = np.asarray(shape, float) * 0.5
    axes = np.argsort(extent)[::-1]
    d0 = np.zeros(3)
    d0[axes[0]] = 1.0
    d1 = np.zeros(3)
    d1[axes[1]] = 1.0
    stack = [(root.copy(), d, root_radius, 0) for d in (d0, -d0, d1, -d1)]
    centerlines, radii = [], []
    while stack and len(centerlines) < n_branches:
        pos, direction, radius, depth = stack.pop(0)
        length = int(rng.integers(branch_length[0], branch_length[1]))
        pts = [pos.copy()]
        d = direction.copy()
        for _ in range(length):
            d = _unit(d + curvature * rng.normal(size=3))
            nxt = pts[-1] + d
            push = np.where(nxt < lo + 8, 1.0, 0.0) - np.where(
                nxt > hi - 8, 1.0, 0.0)
            if np.any(push != 0):
                d = _unit(d + 0.6 * push)
                nxt = pts[-1] + d
            if np.any(nxt < lo) or np.any(nxt > hi):
                break
            pts.append(nxt)
        if len(pts) < 4:
            continue
        centerlines.append(np.asarray(pts))
        radii.append(float(radius))
        if radius <= min_radius:
            continue
        a = rng.uniform(0.35, 0.65)
        r1 = radius * a ** (1.0 / 3.0)
        r2 = radius * (1.0 - a) ** (1.0 / 3.0)
        end = pts[-1]
        for rr in (max(r1, min_radius * 0.9), max(r2, min_radius * 0.9)):
            ang = rng.uniform(0.35, 0.9)
            perp = _unit(np.cross(d, rng.normal(size=3)))
            nd = _unit(math.cos(ang) * d + math.sin(ang) * perp)
            stack.append((end.copy(), nd, rr, depth + 1))
    return centerlines, radii, tuple(int(v) for v in np.round(root))


def rasterise(shape, centerlines, radii, device):
    """Bool mask of the tree: a ball (radius quantised to a quarter voxel)
    at every other centerline point and at each branch's last point
    (phantoms.py:125-135), one scatter per distinct radius."""
    by_key = {}
    for pts, r in zip(centerlines, radii):
        key = int(round(r * 4))
        c = np.round(np.concatenate([pts[::2], pts[-1:]])).astype(np.int64)
        by_key.setdefault(key, []).append(c)
    mask = torch.zeros(int(np.prod(shape)), dtype=torch.bool, device=device)
    strides = torch.tensor([shape[1] * shape[2], shape[2], 1],
                           dtype=torch.int64, device=device)
    for key, cs in by_key.items():
        offs = torch.from_numpy(_ball_offsets(key / 4.0)).to(device)
        pts = torch.from_numpy(np.concatenate(cs)).to(device)
        lin = ((pts[:, None, :] + offs[None]) * strides).sum(-1)
        mask[lin.reshape(-1)] = True
    return mask.reshape(shape)


def phantom_volume(shape, tree_words, noise_words, device, n_branches=400,
                   root_radius=6.0, background=100.0, noise=4.0,
                   vessel_intensity=140.0):
    """One raw volume: (float32 host volume, bool host mask of the tree,
    root voxel).  The tree is grown on the host from the seed words
    ``tree_words``; the mask and the intensities are made on ``device``,
    the noise from ``noise_words``."""
    rng = np.random.default_rng(list(tree_words))
    lines, radii, root = grow_tree(shape, n_branches=n_branches,
                                   root_radius=root_radius, rng=rng)
    mask = rasterise(tuple(shape), lines, radii, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence(list(noise_words))
                        .generate_state(1, np.uint64)[0]) >> 1)
    raw = torch.randn(tuple(shape), generator=gen, device=device,
                      dtype=torch.float32)
    raw.mul_(noise).add_(background)
    raw.add_(mask.to(torch.float32), alpha=vessel_intensity)
    return raw.cpu().numpy(), mask.cpu().numpy(), root
