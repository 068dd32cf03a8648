"""End-to-end pipeline: raw MRA volume in -> vessel mask, centerline
segments and a solved Hazen-Williams flow network out.

Port of the JAX package's pipeline.py:

  raw volume -> vesselness      (ops/vesselness, on ``device``; the
                                 Frangi response is the CUDA kernel K1)
             -> vessel mask     (thresholds, the brain mask's boundary
                                 suppression on a device EDT, the tip
                                 extension and 2x any-pooled seeds on
                                 ``device``, then the native seeded flood
                                 fill on the host; or, given a seed mask,
                                 variational region growing on ``device``
                                 with the kernels K2 and K6)
             -> EDT + thinning  (native C++, box-cropped; or, with
                                 ``skeleton.backend="jax"``, the parallel
                                 thinning of ops/thinning on ``device``)
             -> segments + branch attributes (numpy + native)
             -> voxel graph     (graphs/voxel_graph's classes, host; with
                                 ``flow.graph_path="nx"`` or a store)
             -> FlowNetwork + Newton solve   (flow/, on ``device``; from
                                 the segments, or with "nx" through the
                                 voxel graph's BFS and reduction)

Every function takes an explicit ``device`` that its tensors live on.
Each stage optionally writes its artifact through an ArtifactStore under
the reference's file names, as the JAX package's does.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .config import PipelineConfig
from .utils.hostmem import configure_host_allocator
from .utils.profiling import StageTimer, span

# volume stages churn 100-200 MB numpy temporaries per call; keep them
# heap-resident so steady-state runs do not re-fault every page
configure_host_allocator()


def _border_core(shape, margin: int, device):
    """Mask that is False within ``margin`` voxels of any volume face
    (the filter's boundary band is unreliable; analog of the reference's
    near-boundary suppression, generateVesselVolume.py:186-191)."""
    core = torch.zeros(shape, dtype=torch.bool, device=device)
    core[margin:-margin, margin:-margin, margin:-margin] = True
    return core


def _threshold_plain(v, global_frac, margin=0):
    vmin = torch.min(v)
    rng = torch.max(v) - vmin
    keep = v > vmin + global_frac * rng
    if margin:
        keep &= _border_core(v.shape, margin, v.device)
    return keep


def _near_boundary(v, brain, vmin, rng, near_frac, boundary_dist):
    """Low-response voxels within ``boundary_dist`` of the brain mask's
    boundary (generateVesselVolume.py:186-191), on ``v``'s device.

    ``dist <= boundary_dist`` compares an f32 square root of an integer
    squared distance, as the JAX package does.  At the default 10.0 this
    is exact: the integer d2 nearest 100 are 99 and 101, whose roots
    (9.9499, 10.0499) lie thousands of ulps from 10.0, so no rounding of
    the root can move a voxel across the threshold."""
    from .ops.edt import edt

    dist = edt(brain, band=int(boundary_dist) + 2, device=v.device)
    return (v <= vmin + near_frac * rng) & (dist <= boundary_dist)


def _threshold_with_brain(v, brain, global_frac, near_frac, boundary_dist,
                          margin=0):
    vmin = torch.min(v)
    rng = torch.max(v) - vmin
    keep = v > vmin + global_frac * rng
    keep &= ~_near_boundary(v, brain, vmin, rng, near_frac, boundary_dist)
    if margin:
        keep &= _border_core(v.shape, margin, v.device)
    return keep


def _any_pool2(m):
    """2x any-pooled mask, shape = ceil(shape / 2) (the format of the
    hysteresis strong seeds: exact component selection at 1/8 the bits,
    ops/native.hysteresis_components_ds2_packed_native)."""
    pooled = F.max_pool3d(m[None].to(torch.float32), kernel_size=2,
                          stride=2, ceil_mode=True)
    return pooled[0] > 0


def _threshold_hysteresis(v, vmin, rng, weak_frac, strong_frac, margin=0):
    """(weak mask, 2x-pooled strong mask) for hysteresis selection."""
    weak = v > vmin + weak_frac * rng
    strong = v > vmin + strong_frac * rng
    if margin:
        core = _border_core(v.shape, margin, v.device)
        weak &= core
        strong &= core
    return weak, _any_pool2(strong)


def _threshold_hysteresis_brain(v, brain, vmin, rng, weak_frac,
                                strong_frac, near_frac, boundary_dist,
                                margin=0):
    """Brain variant; also returns the near-boundary suppression mask so
    downstream growth (tip extension) honors it."""
    near = _near_boundary(v, brain, vmin, rng, near_frac, boundary_dist)
    weak = (v > vmin + weak_frac * rng) & ~near
    strong = (v > vmin + strong_frac * rng) & ~near
    if margin:
        core = _border_core(v.shape, margin, v.device)
        weak &= core
        strong &= core
    return weak, _any_pool2(strong), near


def _tip_extended_weak(v, weak, vmin, rng, tip_frac, iters, nbr_max,
                       margin=0, exclude=None):
    """Axial tip extension of the weak mask (thin-tip recall recovery).

    The Frangi response decays at a vessel end, so the last voxels of a
    thin branch fall below the weak floor while still carrying a ridge
    response.  This grows the weak mask into the lower ``tip_frac``
    floor only where the candidate touches between 1 and ``nbr_max``
    mask voxels (an axial continuation beyond a tube end, not a lateral
    halo), ``iters`` times.  ``exclude`` masks candidates out (the brain
    path's near-boundary suppression binds the tip floor too)."""
    from .ops.stencil import neighbor_count26

    tip = v > vmin + tip_frac * rng
    if exclude is not None:
        tip &= ~exclude
    if margin:
        tip &= _border_core(v.shape, margin, v.device)
    m = weak
    for _ in range(iters):
        nc = neighbor_count26(m)
        m = m | (tip & (nc >= 1) & (nc <= nbr_max))
    return m


def vesselness_stage(raw_volume, config: Optional[PipelineConfig] = None,
                     store=None, affine=None, device="cuda"):
    """Raw MRA volume (host) -> Frangi vesselness (tensor on ``device``).

    The upload-bound and compute-bound phases are the spans
    ``vesselness_upload`` / ``vesselness_compute`` of
    ``frangi_vesselness_streamed``.  A ``store`` gets
    vesselnessFiltered.nii.gz (float32)."""
    from .ops.vesselness import frangi_vesselness_streamed

    cfg = (config or PipelineConfig()).vesselness
    bits = {"bq2": 2, "bq3": 3, "bq4": 4, "u8": 8, "u12": 12,
            "f16": 16}[cfg.upload_format]
    v, _, _ = frangi_vesselness_streamed(
        raw_volume, sigmas=tuple(cfg.sigmas),
        alpha=cfg.alpha, beta=cfg.beta, gamma=cfg.gamma,
        bright=cfg.bright, bits=bits,
        skip_background=bool(cfg.upload_skip) and bits <= 4,
        device=device)
    if store is not None:
        store.save_nifti("vesselnessFiltered.nii.gz", v.cpu().numpy(),
                         affine=affine, astype=np.float32)
    return v


def generate_vessel_mask(vesselness, brain_mask=None,
                         config: Optional[PipelineConfig] = None,
                         store=None, affine=None, device="cuda"):
    """Vesselness-filtered volume -> binary uint8 vessel mask (host).

    Reference semantics (generateVesselVolume.py:186-199): with a
    ``brain_mask``, zero voxels within ``boundary_distance_voxels`` of its
    boundary whose vesselness is below ``near_boundary_fraction`` of the
    range; global threshold at ``global_threshold_fraction``, then drop
    components of at most ``min_component_size`` voxels; or, with
    ``weak_threshold_fraction`` set, keep the weak-threshold components
    that hold a strong voxel (hysteresis), the weak mask first extended
    at vessel tips when ``tip_fraction`` is set.  ``vesselness`` and
    ``brain_mask`` may be host arrays or tensors; the thresholds, the
    brain mask's EDT and the tip extension run on ``device``.  A ``store``
    gets vesselVolumeMask.nii.gz (uint8)."""
    from .ops.native import (drop_small_components_native,
                             hysteresis_components_ds2_packed_native)
    from .utils.transfer import pack_mask

    cfg = (config or PipelineConfig()).segmentation
    v = torch.as_tensor(vesselness, dtype=torch.float32, device=device)
    margin = int(cfg.border_margin_voxels)
    if cfg.weak_threshold_fraction is not None:
        # the ds2 pooled-seed selection is exact only when the strong
        # mask is a subset of the weak mask
        if cfg.weak_threshold_fraction > cfg.global_threshold_fraction:
            raise ValueError(
                "weak_threshold_fraction must be <= "
                "global_threshold_fraction (strong mask must be a "
                "subset of the weak mask for hysteresis selection)")
        vmin = torch.min(v)
        rng = torch.max(v) - vmin
        near = None
        if brain_mask is not None:
            weak, strong_ds, near = _threshold_hysteresis_brain(
                v, brain_mask, vmin, rng, cfg.weak_threshold_fraction,
                cfg.global_threshold_fraction, cfg.near_boundary_fraction,
                int(cfg.boundary_distance_voxels), margin)
        else:
            weak, strong_ds = _threshold_hysteresis(
                v, vmin, rng, cfg.weak_threshold_fraction,
                cfg.global_threshold_fraction, margin)
        if cfg.tip_fraction is not None:
            weak = _tip_extended_weak(
                v, weak, vmin, rng, cfg.tip_fraction, int(cfg.tip_iters),
                int(cfg.tip_neighbor_max), margin, exclude=near)
        # both masks cross to the host as packed bits, in one download
        # (the span also waits for the threshold compute)
        with span("segmentation_download"):
            wp_d, sp_d = pack_mask(weak), pack_mask(strong_ds)
            both = torch.cat([wp_d, sp_d]).cpu().numpy()
            wp, sp = both[:wp_d.shape[0]], both[wp_d.shape[0]:]
        with span("segmentation_flood"):
            mask = hysteresis_components_ds2_packed_native(
                wp, tuple(weak.shape), sp, min_size=cfg.min_component_size)
    else:
        if brain_mask is not None:
            keep = _threshold_with_brain(
                v, brain_mask, cfg.global_threshold_fraction,
                cfg.near_boundary_fraction,
                int(cfg.boundary_distance_voxels), margin)
        else:
            keep = _threshold_plain(v, cfg.global_threshold_fraction,
                                    margin)
        n = keep.numel()
        bits = np.unpackbits(pack_mask(keep).cpu().numpy())[:n]
        mask = drop_small_components_native(
            bits.reshape(tuple(keep.shape)), cfg.min_component_size)
    if store is not None:
        store.save_nifti("vesselVolumeMask.nii.gz", mask, affine=affine,
                         astype=np.uint8)
    return mask


def refine_mask_region_grow(vesselness, seed_mask, config=None,
                            device="cuda"):
    """Variational refinement of the mask from seeds (C3), on ``device``
    -> (uint8 mask on the host, RegionGrowResult)."""
    from .ops.region_grow import region_grow

    cfg = (config or PipelineConfig()).segmentation
    res = region_grow(torch.as_tensor(vesselness, dtype=torch.float32,
                                      device=device),
                      torch.as_tensor(np.asarray(seed_mask, bool),
                                      device=device),
                      H=cfg.H, max_segment_size=cfg.max_segment_size,
                      iter_max=cfg.iter_max, num_bins=cfg.num_bins)
    return res.segmented_map.cpu().numpy().astype(np.uint8), res


def compute_mask_edt(mask):
    """Bounding-box-cropped EDT of the vessel mask (native, host)."""
    from .ops.native import bounding_box, edt_masked_native

    vv = np.asarray(mask) != 0
    box = bounding_box(vv, margin=2)
    dt = np.zeros(vv.shape, np.float32)
    dt[box] = edt_masked_native(vv[box])
    return dt


def skeletonize_stage(mask, config=None, store=None, affine=None,
                      distance_transform=None, device="cuda"):
    """Vessel mask (host) -> bool centerline skeleton (host) (C4).

    ``skeleton.backend`` "native" (and "auto") thins on the host in C++;
    "jax" runs the parallel subfield thinning of ops/thinning on
    ``device``.  A ``store`` gets skeleton.nii.gz (uint8)."""
    cfg = (config or PipelineConfig()).skeleton
    if cfg.backend in ("auto", "native"):
        from .ops.native import skeletonize_native
        skel = skeletonize_native(mask,
                                  preserve_endpoints=cfg.preserve_endpoints,
                                  distance_transform=distance_transform,
                                  device=device)
    else:
        from .ops.thinning import skeletonize
        skel = skeletonize(np.asarray(mask), max_waves=cfg.max_waves,
                           preserve_endpoints=cfg.preserve_endpoints,
                           device=device).cpu().numpy()
    if store is not None:
        store.save_nifti("skeleton.nii.gz", skel.astype(np.uint8),
                         affine=affine, astype=np.uint8)
    return skel


def graph_stage(skeleton, mask, config=None, store=None,
                distance_transform=None, build_nx: bool = True,
                origin=(0, 0, 0)):
    """Skeleton -> simple-branch segments + branch attributes (C5/C6/C7).

    Returns (G, segments, attrs).  ``build_nx=False`` skips the voxel-
    level graph (G is None) unless a ``store`` is given: the SoA flow
    path reads ``segments`` and ``attrs`` only; the voxel graph
    (graphs/voxel_graph.Graph, built by ``calculate_branch_info``) serves
    the "nx" flow path, the graphml artifact, the editing engine and the
    morphology.  A ``store`` gets segmentList.npz and
    graphRepresentationCleanedWithEdgeInfo.graphml.

    ``skeleton`` and ``distance_transform`` may be box-cropped with
    ``origin`` = box start; emitted segments carry full-frame
    coordinates."""
    from .graphs.branch_attrs import (calculate_branch_info,
                                      compute_branch_attrs)
    from .graphs.segments import skeleton_to_segments

    cfg = (config or PipelineConfig()).skeleton
    if distance_transform is None:
        if tuple(skeleton.shape) != tuple(np.asarray(mask).shape):
            raise ValueError(
                "graph_stage: cropped skeleton requires the matching "
                f"cropped distance_transform (skeleton {skeleton.shape} "
                f"vs mask {np.asarray(mask).shape})")
        distance_transform = compute_mask_edt(mask)
        origin = (0, 0, 0)
    with span("graph_segments"):
        _, segments = skeleton_to_segments(
            skeleton, prune_min_length=cfg.prune_min_length,
            build_graph=False, origin=origin,
            distance_transform=distance_transform, simplify=cfg.simplify,
            collapse=cfg.collapse_junctions,
            radius_factor=cfg.prune_radius_factor,
            cycle_tight_ratio=cfg.cycle_tight_ratio,
            simplify_rounds=cfg.simplify_rounds,
            bridge_max_len=cfg.bridge_max_len)
    with span("graph_attrs"):
        attrs = compute_branch_attrs(segments, segments, distance_transform,
                                     origin=origin)
    G = None
    if build_nx or store is not None:
        dt_full = np.asarray(distance_transform)
        if any(origin):
            full = np.zeros(np.asarray(mask).shape, np.float32)
            sl = tuple(slice(int(o), int(o) + s)
                       for o, s in zip(origin, dt_full.shape))
            full[sl] = dt_full
            dt_full = full
        G = calculate_branch_info(segments, segments,
                                  distance_transform=dt_full)
    if store is not None:
        store.save_segment_list("segmentList.npz", segments)
        store.save_graphml("graphRepresentationCleanedWithEdgeInfo.graphml",
                           G)
    return G, segments, attrs


def flow_stage_soa(segments, attrs, root, config=None, store=None,
                   boundary_pressure=None, ground_truth_option=2, rng=None,
                   device="cuda"):
    """Segments + branch attrs -> FlowNetwork -> solved flows, without
    the voxel graph (graphs/soa_path.py)."""
    from .graphs.soa_path import segments_to_flow_network

    cfg = (config or PipelineConfig()).flow
    with span("flow_network"):
        net, node_of = segments_to_flow_network(segments, attrs, root,
                                                spacing=cfg.spacing)
    return _solve_network(net, node_of, cfg, store=store,
                          boundary_pressure=boundary_pressure,
                          ground_truth_option=ground_truth_option, rng=rng,
                          device=device)


def flow_stage(G, segments, root, config=None, store=None,
               boundary_pressure=None, ground_truth_option=2, rng=None,
               device="cuda"):
    """Attributed voxel graph -> reduced FlowNetwork -> solved flows
    (C12-C17): BFS from ``root`` over G (annotating it in place), the
    reached segments collapsed to one directed edge each."""
    from .graphs.traversal import (partition_bfs, reduce_graph,
                                   reduced_to_flow_network)

    cfg = (config or PipelineConfig()).flow
    with span("flow_network"):
        partition_bfs(G, [root], [])
        # solve the connected component containing the root: drop
        # segments the BFS never reached (the reference also works per
        # component, graphRelated.py:93-95)
        reached = [i for i, seg in enumerate(segments)
                   if all("depthLevel" in G.nodes[tuple(v)] for v in
                          (seg[0], seg[-1]))]
        DG = reduce_graph(G, segments, reached)
        net, node_of = reduced_to_flow_network(DG, root,
                                               spacing=cfg.spacing)
    return _solve_network(net, node_of, cfg, store=store,
                          boundary_pressure=boundary_pressure,
                          ground_truth_option=ground_truth_option, rng=rng,
                          device=device)


def _boundary_pressure(net, cfg, ground_truth_option, rng):
    """The network's boundary pressures: the ground truth's depth sweep,
    or where it is infeasible the terminating-pressure model."""
    from .flow.ground_truth import create_ground_truth

    gt = create_ground_truth(
        net, option=ground_truth_option,
        rng=rng or np.random.default_rng(0),
        inlet_pressure=cfg.inlet_pressure, inlet_flow=cfg.inlet_flow)
    if gt.success:
        return gt.pressure
    # the depth sweep can be infeasible on loopy graphs (the reference's
    # documented failure mode, fluidSimulation.py:48-54, 594-596); fall
    # back to the ADAN path-length terminating-pressure model, which is
    # always well-defined — the Newton solver handles loops exactly.
    from .flow.boundary import set_terminating_pressure

    term = net.terminal_nodes()
    parts = {"ALL": {"start_nodes": [int(n) for n in net.entry_nodes],
                     "boundary_nodes": []}}
    bp = set_terminating_pressure(
        net, parts, pressure_in=cfg.inlet_pressure * 0.95)
    bp[net.entry_nodes] = cfg.inlet_pressure
    # any unreached terminal: flat default
    bad = np.isnan(bp) & np.isin(np.arange(net.num_nodes),
                                 np.concatenate([term, net.entry_nodes]))
    bp[bad & np.isnan(bp)] = cfg.inlet_pressure * 0.8
    return bp


def _solve_network(net, node_of, cfg, store=None, boundary_pressure=None,
                   ground_truth_option=2, rng=None, device="cuda"):
    from .flow.adan import set_network_ck
    from .flow.solvers import solve_pressure_newton
    from .flow.system import build_system

    with span("flow_network"):
        net = set_network_ck(net)

    if boundary_pressure is None:
        with span("flow_boundary"):
            boundary_pressure = _boundary_pressure(net, cfg,
                                                   ground_truth_option, rng)

    dtype = torch.float64 if cfg.dtype == "float64" else torch.float32
    with span("flow_system"):
        system = build_system(net, boundary_pressure=boundary_pressure,
                              dtype=dtype, device=device)
        plan = None
        if cfg.linear_solver in ("auto", "tree"):
            from .flow.tree_solver import plan_elimination
            plan = plan_elimination(system)
    with span("flow_solve"):
        sol = solve_pressure_newton(system, max_iter=cfg.max_iter,
                                    tol=cfg.tol,
                                    linear_solver=cfg.linear_solver,
                                    plan=plan, restarts=cfg.restarts)
    with span("flow_download"):
        pressure, flow, velocity = (sol.pressure.cpu().numpy(),
                                    sol.flow.cpu().numpy(),
                                    sol.velocity.cpu().numpy())
    net = net.replace(node_pressure=pressure, edge_flow=flow,
                      edge_velocity=velocity)
    if store is not None:
        store.save_pickle("fluidSimulationResult.pkl", {
            "pressure": pressure,
            "flow": flow,
            "velocity": velocity,
            "node_of": {str(k): int(v) for k, v in node_of.items()},
        })
    return net, sol, node_of


def _inlet(segments):
    """The inlet: the lowest-x terminal endpoint (endpoint degree = its
    chain-end count; 1 = tip)."""
    counts: Dict = {}
    for seg in segments:
        for v in (tuple(seg[0]), tuple(seg[-1])):
            counts[v] = counts.get(v, 0) + 1
    tips = [v for v, c in counts.items() if c == 1]
    if not tips:
        raise RuntimeError("no terminal voxels found for the inlet")
    return min(tips, key=lambda v: v[2])


def run_pipeline(vesselness=None, brain_mask=None, seed_mask=None,
                 root=None, config: Optional[PipelineConfig] = None,
                 store=None, affine=None, raw_volume=None, device="cuda"):
    """Full volume -> flow pipeline on ``device``.  Returns a result dict
    with the intermediate artifacts (host arrays) and ``timings``.

    Entry points: a raw MRA volume (``raw_volume``; vesselness computed
    on ``device``) or a pre-filtered vesselness volume (``vesselness``).
    With a ``seed_mask`` the mask is grown from the seeds
    (``refine_mask_region_grow``) in place of the threshold mask; a
    ``brain_mask`` suppresses low responses near its boundary.  With
    ``skeleton.backend="jax"`` the skeleton comes from the parallel
    thinning on ``device`` (``skeletonize_stage``) on the full frame.
    ``flow.graph_path="nx"`` solves through the voxel graph
    (``flow_stage``), "soa" from the segments (``flow_stage_soa``).  A
    ``store`` (io.artifacts.ArtifactStore) gets every stage's artifact
    under the reference's names, ``affine`` in the NIfTI headers.

    ``timings`` is ``{key: seconds}`` of one ``utils/profiling.StageTimer``,
    made active for the call: every stage and sub-stage, here and deep
    in the stack, is a ``span(key)`` that adds its seconds to it and,
    under an active ``torch.profiler``, opens the range ``an.<key>``.
    Keys, nested as the spans are (a key whose code does not run on a
    path is absent):

      vesselness           vesselness_upload (vesselness_pack and
                           vesselness_h2d per slab), vesselness_compute
      segmentation         segmentation_download, segmentation_flood
                           (hysteresis)
      edt
      skeletonization      thinning (the native route)
      graph                graph_segments, graph_attrs
      inlet                (no ``root`` given)
      flow                 flow_network, flow_boundary, flow_system,
                           flow_solve, flow_download
      graph_capture        wherever a CUDA graph is captured or a while
                           graph built (``ops/grow_loop``)

    A span is opened around a capture, never inside a captured step."""
    from .ops.native import (bounding_box, edt_masked_native,
                             skeletonize_native_cropped)

    config = config or PipelineConfig()
    timer = StageTimer()
    with timer.active():
        if vesselness is None:
            if raw_volume is None:
                raise ValueError("provide raw_volume or vesselness")
            with span("vesselness"):
                vesselness = vesselness_stage(raw_volume, config,
                                              store=store, affine=affine,
                                              device=device)

        with span("segmentation"):
            if seed_mask is not None:
                mask, _ = refine_mask_region_grow(vesselness, seed_mask,
                                                  config, device=device)
            else:
                mask = generate_vessel_mask(vesselness, brain_mask, config,
                                            store=store, affine=affine,
                                            device=device)

        if config.skeleton.backend in ("auto", "native"):
            # box-coordinate fast path: crop once after the mask, run EDT
            # + thinning + chain extraction on the cropped frame (squared
            # EDT end to end), and emit full-frame coordinates only at the
            # segment / skeleton boundaries
            with span("edt"):
                box = bounding_box(mask, margin=2)
                origin = tuple(int(s.start) for s in box)
                # a fresh copy: the thinning below clobbers it in place
                mask_box = np.array(mask[box], dtype=np.uint8, order="C")
                d2_box = edt_masked_native(mask_box, squared=True)

            with span("skeletonization"):
                with span("thinning"):
                    skel_work = skeletonize_native_cropped(
                        mask_box, d2_box,
                        preserve_endpoints=config.skeleton
                        .preserve_endpoints, clobber=True)
                # the thinning consumed the squares
                dt = np.sqrt(d2_box, out=d2_box)
                skeleton = np.zeros(mask.shape, bool)
                skeleton[box] = skel_work
                if store is not None:
                    store.save_nifti("skeleton.nii.gz",
                                     skeleton.astype(np.uint8),
                                     affine=affine, astype=np.uint8)
        else:
            with span("edt"):
                dt = compute_mask_edt(mask)
                origin = (0, 0, 0)

            with span("skeletonization"):
                skeleton = skeletonize_stage(mask, config, store=store,
                                             affine=affine,
                                             distance_transform=dt,
                                             device=device)
                skel_work = skeleton

        with span("graph"):
            G, segments, attrs = graph_stage(
                skel_work, mask, config, store=store, distance_transform=dt,
                build_nx=(config.flow.graph_path == "nx"), origin=origin)

        if root is None:
            with span("inlet"):
                root = _inlet(segments)

        with span("flow"):
            if G is not None and config.flow.graph_path == "nx":
                net, sol, node_of = flow_stage(G, segments, root, config,
                                               store=store, device=device)
            else:
                net, sol, node_of = flow_stage_soa(segments, attrs, root,
                                                   config, store=store,
                                                   device=device)

    return {
        "mask": mask,
        "skeleton": skeleton,
        "graph": G,
        "attrs": attrs,
        "segments": segments,
        "network": net,
        "solution": sol,
        "node_of": node_of,
        "timings": timer.seconds,
    }
