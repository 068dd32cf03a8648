# Copy of arterynetwork_tpu/graphs/branch_attrs.py: compute_branch_attrs and its helpers only.
"""Branch attribute computation (reference C7: ``calculateBranchInfo``,
manualCorrectionGUI.py:215-415).

Given the cleaned segment list, the original (pre-cleaning) segment list,
and the vessel volume, compute per-branch attributes and per-node radii:

* per-centerpoint radius from the Euclidean distance transform of the
  vessel mask (cached by the caller if desired) —
  manualCorrectionGUI.py:243-249;
* per-branch ``meanRadius``/``sigma`` from the *interior* (degree-2)
  voxels that existed in the original skeleton
  (manualCorrectionGUI.py:268-311), with fallbacks:
  - zero-radius branches average the nonzero radii along the branch;
  - 2-voxel and brand-new branches average the neighbor branches' radii
    (manualCorrectionGUI.py:315-374);
* ``pathLength`` (sum of step lengths), ``eculideanLength`` (endpoint
  distance — the reference's attribute spelling is kept for artifact
  compatibility), ``tortuosity`` = path/euclidean, ``voxelLength``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
from numpy.linalg import norm


def _path_metrics(segment):
    arr = np.asarray(segment, dtype=float)
    steps = norm(arr[1:] - arr[:-1], axis=1)
    path_length = float(steps.sum())
    euclidean = float(norm(arr[-1] - arr[0]))
    tortuosity = path_length / euclidean if euclidean > 0 else 1.0
    return path_length, euclidean, tortuosity


def compute_branch_attrs(segments_old: Sequence[Sequence],
                         segments_new: Sequence[Sequence],
                         distance_transform, origin=(0, 0, 0)) -> List[Dict]:
    """Per-branch attribute dicts for ``segments_new`` (vectorized).

    Same semantics as the reference's ``calculateBranchInfo``
    (manualCorrectionGUI.py:215-415) but computed with array ops: radii
    are fancy-indexed from the EDT in one shot, interior/link membership
    comes from end-count degrees instead of per-voxel graph probes, and
    per-segment means/sigmas reduce over a segment-id vector.

    Returns ``attrs[idx]`` = dict with pathLength / eculideanLength /
    tortuosity / voxelLength / meanRadius / segmentIndex (+ sigma when
    measured from interior voxels).
    """
    dt = np.asarray(distance_transform)
    # segments are full-frame; a box-cropped transform passes its box
    # start as `origin` (keys use the full-frame bound so they stay
    # unique, dt is indexed in box coordinates)
    org = np.asarray(origin, np.int64)
    shape = tuple(int(o) + int(s) for o, s in zip(org, dt.shape))

    segs = [np.asarray(seg, dtype=np.int64) for seg in segments_new]
    n_seg = len(segs)

    # original-skeleton membership (the reference's indexVolume,
    # manualCorrectionGUI.py:252-256) as a sorted key set
    if segments_old is segments_new:
        old_keys = None  # membership is trivially true
    else:
        olds = [np.asarray(s, np.int64) for s in segments_old if len(s)]
        old_keys = (np.unique(_keys(np.concatenate(olds), shape))
                    if olds else np.zeros(0, np.int64))

    # voxel degree = number of incident (prev,next) slots across chains:
    # interiors contribute 2, chain ends 1 each
    all_coords = (np.concatenate(segs) if segs
                  else np.zeros((0, 3), np.int64))
    keys_all = _keys(all_coords, shape)
    uniq, inv = np.unique(keys_all, return_inverse=True)
    slot = np.ones(len(keys_all), np.int64) * 2
    ofs = 0
    for c in segs:
        slot[ofs] = 1
        slot[ofs + len(c) - 1] = 1
        ofs += len(c)
    degree = np.bincount(inv, weights=slot, minlength=len(uniq))

    radii_all = (dt[tuple((all_coords - org).T)] if len(all_coords)
                 else np.zeros(0))
    deg_all = degree[inv]
    if old_keys is None:
        in_old = np.ones(len(keys_all), bool)
    else:
        pos = np.searchsorted(old_keys, keys_all)
        pos = np.minimum(pos, max(len(old_keys) - 1, 0))
        in_old = (old_keys[pos] == keys_all) if len(old_keys) else \
            np.zeros(len(keys_all), bool)

    # all per-segment reductions run as bincounts over a segment-id
    # vector (one pass each) instead of ~10 small numpy calls per
    # segment — the loop was the graph stage's last Python hot spot
    lens = np.fromiter((len(c) for c in segs), np.int64, n_seg)
    ofs_of = np.concatenate([[0], np.cumsum(lens)])
    seg_id = np.repeat(np.arange(n_seg), lens)

    link = (deg_all == 2) & in_old
    if len(link):
        link[ofs_of[:-1]] = False       # ends are junction/tip slots
        link[ofs_of[1:] - 1] = False
    lid = seg_id[link]
    cnt = np.bincount(lid, minlength=n_seg)
    safe = np.maximum(cnt, 1)
    mean_l = np.bincount(lid, weights=radii_all[link],
                         minlength=n_seg) / safe
    dev2 = (radii_all[link] - mean_l[lid]) ** 2
    sigma_l = np.sqrt(np.bincount(lid, weights=dev2,
                                  minlength=n_seg) / safe)

    # zero-mean fallback: average the branch's nonzero radii
    nzm = radii_all != 0
    nid = seg_id[nzm]
    cnt_nz = np.bincount(nid, minlength=n_seg)
    safe_nz = np.maximum(cnt_nz, 1)
    mean_nz = np.bincount(nid, weights=radii_all[nzm],
                          minlength=n_seg) / safe_nz
    dev2_nz = (radii_all[nzm] - mean_nz[nid]) ** 2
    sigma_nz = np.sqrt(np.bincount(nid, weights=dev2_nz,
                                   minlength=n_seg) / safe_nz)
    use_nz = (mean_l == 0) & (cnt_nz > 0)
    mean_seg = np.where(use_nz, mean_nz, mean_l)
    sigma_seg = np.where(use_nz, sigma_nz, sigma_l)

    # path metrics: one diff over the concatenation, segment-boundary
    # steps masked out
    cf = all_coords.astype(float)
    if len(cf) > 1:
        steps = np.sqrt(((cf[1:] - cf[:-1]) ** 2).sum(axis=1))
        same = seg_id[1:] == seg_id[:-1]
        pl_seg = np.bincount(seg_id[1:][same], weights=steps[same],
                             minlength=n_seg)
    else:
        pl_seg = np.zeros(n_seg)
    if n_seg:
        el_seg = norm(cf[ofs_of[1:] - 1] - cf[ofs_of[:-1]], axis=1)
    else:
        el_seg = np.zeros(0)

    attrs: List[Dict] = [None] * n_seg
    short_or_new: List[int] = []
    for idx in range(n_seg):
        if lens[idx] == 2 or cnt[idx] == 0:
            short_or_new.append(idx)
            continue
        pl = float(pl_seg[idx])
        el = float(el_seg[idx])
        attrs[idx] = dict(pathLength=pl, eculideanLength=el,
                          tortuosity=pl / el if el > 0 else 1.0,
                          voxelLength=int(lens[idx]),
                          meanRadius=float(mean_seg[idx]),
                          sigma=float(sigma_seg[idx]),
                          segmentIndex=int(idx))

    # 2-voxel / brand-new branches: average the neighbor branches' radii
    # (manualCorrectionGUI.py:315-374).  Endpoint -> incident measured
    # branches via the chain-end map.
    if short_or_new:
        end_map: Dict[int, List[int]] = {}
        ofs = 0
        for idx, c in enumerate(segs):
            for j in (ofs, ofs + len(c) - 1):
                end_map.setdefault(int(inv[j]), []).append(idx)
            ofs += len(c)

        def _end_radius(end_key, self_idx):
            rs = [attrs[k]["meanRadius"] for k in end_map.get(end_key, [])
                  if k != self_idx and attrs[k] is not None]
            return float(np.mean(rs)) if rs else 0.0

        ofs_of = np.cumsum([0] + [len(c) for c in segs])
        for idx in short_or_new:
            c = segs[idx]
            h = _end_radius(int(inv[ofs_of[idx]]), idx)
            t = _end_radius(int(inv[ofs_of[idx] + len(c) - 1]), idx)
            mean_radius = (h + t) / 2.0 if (h and t) else (h or t or 0.0)
            el = float(norm(c[-1].astype(float) - c[0].astype(float)))
            if len(c) > 2:
                d = np.diff(c.astype(float), axis=0)
                pl = float(np.sqrt((d * d).sum(axis=1)).sum())
            else:
                pl = el
            attrs[idx] = dict(pathLength=pl, eculideanLength=el,
                              tortuosity=pl / el if el > 0 else 1.0,
                              voxelLength=int(len(c)),
                              meanRadius=mean_radius, segmentIndex=int(idx))
    return attrs


def _keys(coords, shape):
    c = np.asarray(coords, np.int64)
    return (c[:, 0] * shape[1] + c[:, 1]) * shape[2] + c[:, 2]
