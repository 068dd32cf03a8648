"""Judge one volume's outputs against the plain references.

The reference makes the mask from the raw volume by itself.  The
skeleton is held to what a finished thinning of the program's mask must
be (``structure``): inside the mask, no simple point left but its curve
ends, as many components and the same Euler characteristic.  The
branches are held to the skeleton: on it, covering it but for what the
pruning rules may take, in as many connected pieces.  From the branches
on, the reference works everything out again (``network``): the inlet,
the network and its depths, each branch's radius (its own exact EDT)
and length, the boundary pressures by the depth sweep, and the flow
solve on node pressures (``hw_flow``).
"""

from __future__ import annotations

import numpy as np
import torch

from . import frangi, hw_flow, network, structure, volume_ref


def reference_mask(raw, settings, device, dtype=torch.float64):
    v = frangi.vesselness(raw, settings["sigmas"], bits=settings["bits"],
                          skip=settings["upload_skip"],
                          chunk_z=settings["chunk_z"], dtype=dtype,
                          device=device)
    mask = volume_ref.hysteresis_mask(
        v, settings["weak_threshold_fraction"],
        settings["global_threshold_fraction"],
        settings["border_margin_voxels"], settings["min_component_size"])
    del v
    return mask


def distances(out, device):
    """The reference's distance to the mask's edge at every skeleton and
    branch voxel: {voxel: distance}."""
    skel = np.argwhere(np.asarray(out["skeleton"]) != 0)
    pts = np.unique(np.concatenate(
        [skel.reshape(-1, 3), volume_ref.inner_points(out["segments"])]),
        axis=0)
    dist = volume_ref.edt_at(out["mask"], pts, device)
    return {tuple(p): float(x) for p, x in zip(pts.tolist(), dist)}


def structure_numbers(out, settings, dist_of, device):
    """Counts that are 0 for sound outputs, and the branches' reach."""
    mask = np.asarray(out["mask"]) != 0
    skel = np.asarray(out["skeleton"]) != 0
    segs = out["segments"]
    nums = {"skeleton_outside_mask": int(np.count_nonzero(skel & ~mask)),
            "skeleton_component_gap": abs(volume_ref.components(skel)
                                          - volume_ref.components(mask)),
            "skeleton_euler_gap": abs(structure.euler(skel, device)
                                      - structure.euler(mask, device)),
            "skeleton_removable": structure.removable(skel)}
    sk = structure.Skeleton(skel, dist_of)
    pos = [sk.index(np.asarray(s, np.int64)) for s in segs]
    off = sum(int(np.count_nonzero(p < 0)) for p in pos)
    pos = [p[p >= 0] for p in pos]
    nums["branch_off_skeleton"] = off
    nums["branch_components_gap"] = structure.branch_components(sk, pos)
    nums["uncovered_reach"] = structure.coverage(
        sk, np.concatenate(pos + [np.zeros(0, np.int64)]),
        settings["prune_min_length"], settings["prune_radius_factor"])
    return nums


def reference_branches(segments, dist_of, edt_round=None):
    """Per branch: radius and length in voxels."""
    if edt_round is not None:
        keys = list(dist_of)
        vals = edt_round(np.asarray([dist_of[k] for k in keys]))
        dist_of = dict(zip(keys, vals.tolist()))
    radius = volume_ref.branch_radius(segments, dist_of)
    length = np.asarray([volume_ref.branch_length(s) for s in segments])
    return radius, length


def reference_flow(net, radius, length, settings, dtype=np.float64,
                   round_state=None):
    """Node pressures and edge flows of the reference's network ``net``
    from per-branch ``radius`` and ``length`` (voxels)."""
    si = net["segment"]
    sp = float(settings["spacing"])
    r, length = radius[si], length[si]
    N = len(net["depth"])
    bp = network.ground_truth(net, r, r * sp, length * sp,
                              settings["inlet_pressure"],
                              settings["inlet_flow"])
    if bp is None:
        bp = network.path_length_pressures(net, length * sp,
                                           settings["inlet_pressure"])
    fixed = hw_flow.fixed_nodes(net["heads"], net["tails"], N,
                                [net["entry"]])
    return hw_flow.solve(net["heads"], net["tails"], r * sp, length * sp,
                         fixed, np.where(fixed, bp, 0.0), dtype=dtype,
                         round_state=round_state)


def match(out, net):
    """The program's network against the reference's: (defects, node
    order, edge order, edge signs) that map the program's nodes and edges
    onto the reference's."""
    pn = out["network"]
    coord = np.asarray(pn["node_coord"], np.int64).reshape(-1, 3)
    where = {tuple(c): i for i, c in enumerate(net["coord"].tolist())}
    nodes = np.asarray([where.get(tuple(c), -1) for c in coord.tolist()],
                       np.int64)
    defects = int(np.count_nonzero(nodes < 0)) + abs(len(coord)
                                                     - len(where))
    edge_of = {int(s): e for e, s in enumerate(net["segment"])}
    seg = np.asarray(pn["edge_segment_index"], np.int64)
    edges = np.asarray([edge_of.get(int(s), -1) for s in seg], np.int64)
    defects += int(np.count_nonzero(edges < 0)) + abs(len(seg)
                                                      - len(edge_of))
    heads = np.asarray(pn["heads"], np.int64)
    tails = np.asarray(pn["tails"], np.int64)
    sign = np.ones(len(seg))
    for e, re in enumerate(edges):
        if re < 0 or nodes[heads[e]] < 0 or nodes[tails[e]] < 0:
            continue
        got = (nodes[heads[e]], nodes[tails[e]])
        want = (net["heads"][re], net["tails"][re])
        if got == want[::-1]:
            sign[e] = -1.0
        elif got != want:
            defects += 1
    entry = int(np.asarray(pn["entry_nodes"])[0])
    defects += int(nodes[entry] != net["entry"])
    return defects, nodes, edges, sign


def rel_gap(a, ref):
    a = np.asarray(a, np.float64)
    ref = np.asarray(ref, np.float64)
    if not len(ref):
        return 0.0
    g = float(np.max(np.abs(a - ref) / np.maximum(np.abs(ref), 1e-300)))
    return g if np.isfinite(g) else float("inf")


def reference(raw, out, settings, device):
    """The reference's side of one volume."""
    ref = {"mask": reference_mask(raw, settings, device),
           "dist_of": distances(out, device)}
    ref["radius"], ref["length"] = reference_branches(out["segments"],
                                                      ref["dist_of"])
    ref["net"] = network.build(out["segments"],
                               network.inlet(out["segments"]))
    ref["pressure"], ref["flow"] = reference_flow(
        ref["net"], ref["radius"], ref["length"], settings)
    return ref


def judge(raw, out, settings, device, ref=None):
    """Every number compared for one volume (``structure_numbers``, the
    network's defects, and the mask's, radii's, lengths', pressures' and
    flows' gaps).  ``ref`` caches the reference's side for a second
    judge of the same volume."""
    if ref is None:
        ref = reference(raw, out, settings, device)
    mask = np.asarray(out["mask"]) != 0
    n_ref = max(int(np.count_nonzero(ref["mask"])), 1)
    nums = {"mask_mismatch": int(np.count_nonzero(mask != (ref["mask"] != 0)))
            / n_ref}
    nums.update(structure_numbers(out, settings, ref["dist_of"], device))
    net = out["network"]
    defects, nodes, edges, sign = match(out, ref["net"])
    nums["network_defects"] = defects
    if defects:
        for k in ("radius_gap", "length_gap", "pressure_gap", "flow_gap"):
            nums[k] = float("inf")
        return nums, ref
    si = ref["net"]["segment"][edges]
    nums["radius_gap"] = rel_gap(net["radius"], ref["radius"][si])
    nums["length_gap"] = rel_gap(net["length"], ref["length"][si])
    p = np.empty(len(nodes))
    p[nodes] = np.asarray(net["node_pressure"], np.float64)
    q = np.empty(len(edges))
    q[edges] = np.asarray(net["edge_flow"], np.float64) * sign
    nums["pressure_gap"], nums["flow_gap"] = hw_flow.gaps(
        p, q, ref["pressure"], ref["flow"])
    return nums, ref
