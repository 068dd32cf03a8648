"""End-to-end pipeline: raw MRA volume in -> vessel mask, centerline
segments and a solved Hazen-Williams flow network out.

Port of the JAX package's pipeline.py along its main path:

  raw volume -> vesselness      (ops/vesselness, on ``device``; the
                                 Frangi response is the CUDA kernel K1)
             -> vessel mask     (thresholds and 2x any-pooled seeds on
                                 ``device``, then the native seeded flood
                                 fill on the host)
             -> EDT + thinning  (native C++, box-cropped)
             -> segments + branch attributes (numpy + native)
             -> FlowNetwork + Newton solve   (flow/, on ``device``)

Every function takes an explicit ``device`` that its tensors live on.
Not ported yet (they raise ``NotImplementedError``): brain masks, the
tip extension, seeded region growing, the networkx graph path, the JAX
thinning backend, and the artifact store.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .config import PipelineConfig


@dataclasses.dataclass
class StageTimings:
    seconds: Dict[str, float] = dataclasses.field(default_factory=dict)

    def add(self, name, t):
        self.seconds[name] = self.seconds.get(name, 0.0) + t


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


def vesselness_stage(raw_volume, config: Optional[PipelineConfig] = None,
                     timings=None, device="cuda"):
    """Raw MRA volume (host) -> Frangi vesselness (tensor on ``device``).

    With a ``timings`` struct, the upload-bound and compute-bound phases
    are attributed separately (``vesselness_upload`` /
    ``vesselness_compute``)."""
    from .ops.vesselness import frangi_vesselness_streamed

    cfg = (config or PipelineConfig()).vesselness
    bits = {"bq2": 2, "bq3": 3, "bq4": 4, "u8": 8, "u12": 12,
            "f16": 16}[cfg.upload_format]
    v, t_up, t_comp = frangi_vesselness_streamed(
        raw_volume, sigmas=tuple(cfg.sigmas),
        alpha=cfg.alpha, beta=cfg.beta, gamma=cfg.gamma,
        bright=cfg.bright, bits=bits,
        skip_background=bool(cfg.upload_skip) and bits <= 4,
        device=device)
    if timings is not None:
        timings.add("vesselness_upload", t_up)
        timings.add("vesselness_compute", t_comp)
    return v


def generate_vessel_mask(vesselness, brain_mask=None,
                         config: Optional[PipelineConfig] = None,
                         timings=None, device="cuda"):
    """Vesselness-filtered volume -> binary uint8 vessel mask (host).

    Reference semantics (generateVesselVolume.py:186-199): global
    threshold at ``global_threshold_fraction``, then drop components of
    at most ``min_component_size`` voxels; or, with
    ``weak_threshold_fraction`` set, keep the weak-threshold components
    that hold a strong voxel (hysteresis).  ``vesselness`` may be a host
    array or a tensor; the thresholds run on ``device``."""
    from .ops.native import (drop_small_components_native,
                             hysteresis_components_ds2_packed_native)
    from .utils.transfer import pack_mask

    cfg = (config or PipelineConfig()).segmentation
    if brain_mask is not None:
        raise NotImplementedError(
            "brain masks need the device EDT (ops/edt), not ported yet")
    if cfg.tip_fraction is not None:
        raise NotImplementedError(
            "tip extension needs ops/stencil, not ported yet")

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
        weak, strong_ds = _threshold_hysteresis(
            v, vmin, rng, cfg.weak_threshold_fraction,
            cfg.global_threshold_fraction, margin)
        # both masks cross to the host as packed bits, in one download
        t0 = time.perf_counter()
        wp_d, sp_d = pack_mask(weak), pack_mask(strong_ds)
        both = torch.cat([wp_d, sp_d]).cpu().numpy()
        wp, sp = both[:wp_d.shape[0]], both[wp_d.shape[0]:]
        if timings is not None:  # threshold compute + packed-mask download
            timings.add("segmentation_download", time.perf_counter() - t0)
        t0 = time.perf_counter()
        mask = hysteresis_components_ds2_packed_native(
            wp, tuple(weak.shape), sp, min_size=cfg.min_component_size)
        if timings is not None:
            timings.add("segmentation_flood", time.perf_counter() - t0)
        return mask
    keep = _threshold_plain(v, cfg.global_threshold_fraction, margin)
    n = keep.numel()
    bits = np.unpackbits(pack_mask(keep).cpu().numpy())[:n]
    mask = bits.reshape(tuple(keep.shape))
    return drop_small_components_native(mask, cfg.min_component_size)


def compute_mask_edt(mask):
    """Bounding-box-cropped EDT of the vessel mask (native, host)."""
    from .ops.native import bounding_box, edt_masked_native

    vv = np.asarray(mask) != 0
    box = bounding_box(vv, margin=2)
    dt = np.zeros(vv.shape, np.float32)
    dt[box] = edt_masked_native(vv[box])
    return dt


def graph_stage(skeleton, mask, config=None, distance_transform=None,
                origin=(0, 0, 0)):
    """Skeleton -> simple-branch segments + branch attributes (C5/C6/C7).

    Returns (None, segments, attrs): the voxel-level networkx graph of the
    JAX package's ``build_nx=True`` is not built (the flow path reads
    ``segments`` and ``attrs`` only).  ``skeleton`` and
    ``distance_transform`` may be box-cropped with ``origin`` = box start;
    emitted segments carry full-frame coordinates."""
    from .graphs.branch_attrs import compute_branch_attrs
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
    _, segments = skeleton_to_segments(
        skeleton, prune_min_length=cfg.prune_min_length, build_graph=False,
        origin=origin, distance_transform=distance_transform,
        simplify=cfg.simplify,
        collapse=cfg.collapse_junctions,
        radius_factor=cfg.prune_radius_factor,
        cycle_tight_ratio=cfg.cycle_tight_ratio,
        simplify_rounds=cfg.simplify_rounds,
        bridge_max_len=cfg.bridge_max_len)
    attrs = compute_branch_attrs(segments, segments, distance_transform,
                                 origin=origin)
    return None, segments, attrs


def flow_stage_soa(segments, attrs, root, config=None,
                   boundary_pressure=None, ground_truth_option=2, rng=None,
                   device="cuda"):
    """Segments + branch attrs -> FlowNetwork -> solved flows, without a
    networkx graph (graphs/soa_path.py)."""
    from .graphs.soa_path import segments_to_flow_network

    cfg = (config or PipelineConfig()).flow
    net, node_of = segments_to_flow_network(segments, attrs, root,
                                            spacing=cfg.spacing)
    return _solve_network(net, node_of, cfg,
                          boundary_pressure=boundary_pressure,
                          ground_truth_option=ground_truth_option, rng=rng,
                          device=device)


def _solve_network(net, node_of, cfg, boundary_pressure=None,
                   ground_truth_option=2, rng=None, device="cuda"):
    from .flow.adan import set_network_ck
    from .flow.ground_truth import create_ground_truth
    from .flow.solvers import solve_pressure_newton
    from .flow.system import build_system

    net = set_network_ck(net)

    if boundary_pressure is None:
        gt = create_ground_truth(
            net, option=ground_truth_option,
            rng=rng or np.random.default_rng(0),
            inlet_pressure=cfg.inlet_pressure, inlet_flow=cfg.inlet_flow)
        if gt.success:
            boundary_pressure = gt.pressure
        else:
            # the depth sweep can be infeasible on loopy graphs (the
            # reference's documented failure mode, fluidSimulation.py:48-54,
            # 594-596); fall back to the ADAN path-length terminating-
            # pressure model, which is always well-defined — the Newton
            # solver handles loops exactly.
            from .flow.boundary import set_terminating_pressure

            term = net.terminal_nodes()
            parts = {"ALL": {"start_nodes": [int(n) for n in
                             net.entry_nodes], "boundary_nodes": []}}
            bp = set_terminating_pressure(
                net, parts, pressure_in=cfg.inlet_pressure * 0.95)
            bp[net.entry_nodes] = cfg.inlet_pressure
            # any unreached terminal: flat default
            bad = np.isnan(bp) & np.isin(np.arange(net.num_nodes),
                                         np.concatenate([term,
                                                         net.entry_nodes]))
            bp[bad & np.isnan(bp)] = cfg.inlet_pressure * 0.8
            boundary_pressure = bp

    dtype = torch.float64 if cfg.dtype == "float64" else torch.float32
    system = build_system(net, boundary_pressure=boundary_pressure,
                          dtype=dtype, device=device)
    plan = None
    if cfg.linear_solver in ("auto", "tree"):
        from .flow.tree_solver import plan_elimination
        plan = plan_elimination(system)
    sol = solve_pressure_newton(system, max_iter=cfg.max_iter, tol=cfg.tol,
                                linear_solver=cfg.linear_solver, plan=plan,
                                restarts=cfg.restarts)
    net = net.replace(node_pressure=sol.pressure.cpu().numpy(),
                      edge_flow=sol.flow.cpu().numpy(),
                      edge_velocity=sol.velocity.cpu().numpy())
    return net, sol, node_of


def run_pipeline(vesselness=None, brain_mask=None, seed_mask=None,
                 root=None, config: Optional[PipelineConfig] = None,
                 raw_volume=None, device="cuda"):
    """Full volume -> flow pipeline on ``device``.  Returns a result dict
    with the intermediate artifacts (host arrays) and per-stage timings.

    Entry points: a raw MRA volume (``raw_volume``; vesselness computed
    on ``device``) or a pre-filtered vesselness volume (``vesselness``)."""
    from .ops.native import (bounding_box, edt_masked_native,
                             skeletonize_native_cropped)

    config = config or PipelineConfig()
    if seed_mask is not None:
        raise NotImplementedError(
            "seeded region growing (kernels K2-K6) is not ported yet")
    if config.skeleton.backend == "jax":
        raise NotImplementedError(
            "skeleton.backend='jax' (device thinning) is not ported yet; "
            "use 'native' or 'auto'")
    if config.flow.graph_path == "nx":
        raise NotImplementedError(
            "flow.graph_path='nx' is not ported yet; use 'soa'")
    timings = StageTimings()

    if vesselness is None:
        if raw_volume is None:
            raise ValueError("provide raw_volume or vesselness")
        t0 = time.perf_counter()
        vesselness = vesselness_stage(raw_volume, config, timings=timings,
                                      device=device)
        timings.add("vesselness", time.perf_counter() - t0)

    t0 = time.perf_counter()
    mask = generate_vessel_mask(vesselness, brain_mask, config,
                                timings=timings, device=device)
    timings.add("segmentation", time.perf_counter() - t0)

    # box-coordinate fast path: crop once after the mask, run EDT +
    # thinning + chain extraction on the cropped frame (squared EDT end
    # to end), and emit full-frame coordinates only at the segment /
    # skeleton boundaries
    t0 = time.perf_counter()
    box = bounding_box(mask, margin=2)
    origin = tuple(int(s.start) for s in box)
    # a fresh copy: the thinning below clobbers it in place
    mask_box = np.array(mask[box], dtype=np.uint8, order="C")
    d2_box = edt_masked_native(mask_box, squared=True)
    timings.add("edt", time.perf_counter() - t0)

    t0 = time.perf_counter()
    skel_work = skeletonize_native_cropped(
        mask_box, d2_box,
        preserve_endpoints=config.skeleton.preserve_endpoints,
        clobber=True)
    dt = np.sqrt(d2_box, out=d2_box)  # thinning consumed the squares
    skeleton = np.zeros(mask.shape, bool)
    skeleton[box] = skel_work
    timings.add("skeletonization", time.perf_counter() - t0)

    t0 = time.perf_counter()
    G, segments, attrs = graph_stage(skel_work, mask, config,
                                     distance_transform=dt, origin=origin)
    timings.add("graph", time.perf_counter() - t0)

    if root is None:
        # inlet = the lowest-x terminal endpoint (endpoint degree = its
        # chain-end count; 1 = tip)
        counts: Dict = {}
        for seg in segments:
            for v in (tuple(seg[0]), tuple(seg[-1])):
                counts[v] = counts.get(v, 0) + 1
        tips = [v for v, c in counts.items() if c == 1]
        if not tips:
            raise RuntimeError("no terminal voxels found for the inlet")
        root = min(tips, key=lambda v: v[2])

    t0 = time.perf_counter()
    net, sol, node_of = flow_stage_soa(segments, attrs, root, config,
                                       device=device)
    timings.add("flow", time.perf_counter() - t0)

    return {
        "mask": mask,
        "skeleton": skeleton,
        "graph": G,
        "attrs": attrs,
        "segments": segments,
        "network": net,
        "solution": sol,
        "node_of": node_of,
        "timings": timings.seconds,
    }
