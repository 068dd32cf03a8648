# Copy of arterynetwork_tpu/utils/phantoms.py, plus tube_phantom (bench.py).
"""Synthetic vascular phantoms.

The reference validates its voxel kernels on simple phantoms (a bar and a
sphere, variationalRegionGrowing.py:284-314).  For pipeline-scale
benchmarking those are far too easy — a realistic MRA yields hundreds of
branches and ~0.5-1% vessel fraction — so this module grows a random
branching arterial tree (Murray's-law radius splits, curving centerlines)
and rasterizes it into a volume.

Used by bench.py (north-star pipeline config) and the scale tests.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np


def _unit(v):
    n = float(np.linalg.norm(v))
    return v / n if n > 0 else np.array([0.0, 0.0, 1.0])


def _ball_offsets(radius: float):
    r = int(math.ceil(radius))
    g = np.mgrid[-r:r + 1, -r:r + 1, -r:r + 1]
    d2 = (g ** 2).sum(axis=0)
    return np.argwhere(d2 <= radius * radius + 1e-9) - r


class _BallCache:
    def __init__(self):
        self._c: Dict[int, np.ndarray] = {}

    def get(self, radius: float) -> np.ndarray:
        key = int(round(radius * 4))  # quarter-voxel quantization
        if key not in self._c:
            self._c[key] = _ball_offsets(key / 4.0)
        return self._c[key]


def vascular_tree_phantom(shape=(512, 512, 170),
                          n_branches: int = 400,
                          root_radius: float = 6.0,
                          min_radius: float = 1.0,
                          branch_length=(25, 70),
                          curvature: float = 0.12,
                          seed: int = 0):
    """Grow a random arterial tree and rasterize it.

    Returns a dict with:
      * ``mask``        — bool[shape] ground-truth vessel mask
      * ``centerlines`` — list of float[N,3] per-branch centerline points
      * ``radii``       — list of per-branch radii (voxels)
      * ``root``        — (z, y, x) root voxel
      * ``n_branches``  — number of branches actually grown

    Branch radii follow Murray's law at bifurcations
    (r0^3 = r1^3 + r2^3 with a random asymmetry), branch directions
    deviate from the parent and curve with a random-walk perturbation —
    the geometry regime of the reference's BraVa/GBM networks
    (fluidSimulation.py:364-377 radius-vs-level fit).
    """
    rng = np.random.default_rng(seed)
    shape = tuple(int(s) for s in shape)
    lo = np.asarray([root_radius + 2] * 3)
    hi = np.asarray(shape, float) - root_radius - 3
    extent = hi - lo

    # root at the volume center; 4 initial trunks spread into the two
    # largest dimensions (a 512x512x170 MRA is a slab — trees that grow
    # along the short axis die at the boundary immediately)
    root = np.asarray(shape, float) * 0.5
    axes = np.argsort(extent)[::-1]
    d0 = np.zeros(3)
    d0[axes[0]] = 1.0
    d1 = np.zeros(3)
    d1[axes[1]] = 1.0
    stack: List[Tuple[np.ndarray, np.ndarray, float, int]] = [
        (root.copy(), d, root_radius, 0)
        for d in (d0, -d0, d1, -d1)]

    centerlines: List[np.ndarray] = []
    radii: List[float] = []

    while stack and len(centerlines) < n_branches:
        # breadth-first gives a balanced tree within the branch budget
        pos, direction, radius, depth = stack.pop(0)
        length = int(rng.integers(branch_length[0], branch_length[1]))
        pts = [pos.copy()]
        d = direction.copy()
        for _ in range(length):
            d = _unit(d + curvature * rng.normal(size=3))
            # soft wall: steer back toward the interior near the boundary
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
        # Murray split with random asymmetry
        a = rng.uniform(0.35, 0.65)
        r1 = radius * a ** (1.0 / 3.0)
        r2 = radius * (1.0 - a) ** (1.0 / 3.0)
        end = pts[-1]
        for rr in (max(r1, min_radius * 0.9), max(r2, min_radius * 0.9)):
            ang = rng.uniform(0.35, 0.9)
            perp = _unit(np.cross(d, rng.normal(size=3)))
            nd = _unit(math.cos(ang) * d + math.sin(ang) * perp)
            stack.append((end.copy(), nd, rr, depth + 1))

    mask = np.zeros(shape, bool)
    cache = _BallCache()
    for pts, r in zip(centerlines, radii):
        offs = cache.get(r)
        # stamp every other point: balls of radius >= 1 at unit spacing
        # overlap heavily, halving the stamps keeps connectivity
        for p in pts[::2]:
            c = np.round(p).astype(np.int64) + offs
            mask[c[:, 0], c[:, 1], c[:, 2]] = True
        c = np.round(pts[-1]).astype(np.int64) + offs
        mask[c[:, 0], c[:, 1], c[:, 2]] = True

    return {
        "mask": mask,
        "centerlines": centerlines,
        "radii": radii,
        "root": tuple(int(v) for v in np.round(root)),
        "n_branches": len(centerlines),
    }


def phantom_raw_volume(phantom, background=100.0, noise=4.0,
                       vessel_intensity=140.0, seed: int = 1):
    """Raw-MRA-like intensity volume from a phantom mask: Gaussian
    background plus bright vessels scaled by local radius (partial-volume
    falloff at the thinnest vessels, like real TOF-MRA)."""
    rng = np.random.default_rng(seed)
    mask = phantom["mask"]
    raw = rng.normal(background, noise, size=mask.shape).astype(np.float32)
    raw[mask] += vessel_intensity
    return raw


def tube_phantom(shape, radius=2, amplitude=0.8, seed=0):
    """Copy of bench.py's ``_tube_phantom`` (the region-grow bench
    workload): a noisy volume with a bright square tube winding along the
    last axis, and a 3x3x3 seed cube on the tube at its middle.  Returns
    (float32 volume, bool seed mask)."""
    rng = np.random.default_rng(seed)
    vol = rng.normal(0.1, 0.03, size=shape).astype(np.float32)
    z = np.arange(shape[2])
    cx = (shape[0] // 2 + (shape[0] // 6) * np.sin(z / 18)).astype(int)
    cy = (shape[1] // 2 + (shape[1] // 6) * np.cos(z / 23)).astype(int)
    for zz in z:
        vol[cx[zz] - radius:cx[zz] + radius + 1,
            cy[zz] - radius:cy[zz] + radius + 1, zz] += amplitude
    seed_mask = np.zeros(shape, bool)
    mid = shape[2] // 2
    seed_mask[cx[mid] - 1:cx[mid] + 2, cy[mid] - 1:cy[mid] + 2,
              mid - 1:mid + 2] = True
    return vol, seed_mask
