"""Sharded end-to-end mini pipeline.

Port of the JAX package's parallel/pipeline_sharded.py: the volume stages
over a spatial mesh (vesselness, strong seeds, variational region
growing, subfield thinning), then the host graph, then the longitudinal
batch of flow solves split over the mesh's slots.  Where the JAX package
lets GSPMD partition the single-device programs, the stages here are the
explicit halo'd ones of parallel/sharded.py, each equal to the
single-device result on the whole volume.
"""

from __future__ import annotations

import numpy as np
import torch


def mini_pipeline_sharded(raw, mesh=None, axes=("sx", "sy"),
                          sigmas=(1.0, 2.0),
                          strong_fraction: float = 0.5,
                          n_timesteps: int = 8,
                          max_waves: int = 16,
                          region_grow_iters: int = 60,
                          run_thinning: bool = True):
    """Raw volume -> sharded vesselness/mask/grow/skeleton -> host graph
    -> dp-batched longitudinal solves.

    ``mesh``: a ``VolumeMesh`` with the ``axes`` (default: the visible
    cards, 2-d).  Returns a dict with the device artifacts (as numpy: the
    vesselness, mask and skeleton), the segments, the flow network, the
    per-timestep pressure matrix (f32 CG, boundary pressures scaled by
    linspace(1.0, 0.9, T)) and ``timings``, each stage's seconds (host
    clock, ended by a synchronization on the stage's result)."""
    from ..utils.profiling import StageTimer, device_sync
    from . import sharded
    from .distributed import solve_batch_dp
    from .halo import make_volume_mesh, shard_volume

    if mesh is None:
        mesh = make_volume_mesh(axis_names=axes)
    timer = StageTimer()

    # --- device stages, spatially sharded -----------------------------
    with timer.stage("upload"):
        raw_sh = shard_volume(np.asarray(raw, np.float32), mesh, axes)
    with timer.stage("vesselness"):
        v = sharded.frangi_vesselness(raw_sh, sigmas=tuple(sigmas))
        device_sync(list(v.blocks.reshape(-1)))
    with timer.stage("seeds"):
        dev0 = v.blocks[(0,) * len(v.grid)].device
        vmin = torch.min(torch.stack([torch.min(b).to(dev0)
                                      for b in v.blocks.reshape(-1)]))
        vmax = torch.max(torch.stack([torch.max(b).to(dev0)
                                      for b in v.blocks.reshape(-1)]))
        thr = vmin + strong_fraction * (vmax - vmin)
        seeds = v.map(lambda b: b > thr.to(b.device))
    with timer.stage("region_grow"):
        grown = sharded.region_grow(v, seeds, max_segment_size=10 ** 7,
                                    iter_max=region_grow_iters)
    mask_sh = grown.segmented_map
    with timer.stage("thinning"):
        skel_sh = sharded.skeletonize(mask_sh, max_waves=max_waves) \
            if run_thinning else mask_sh
    with timer.stage("gather"):
        mask = mask_sh.gather().cpu().numpy()
        skel = skel_sh.gather().cpu().numpy()
        vess = v.gather().cpu().numpy()

    # --- host graph stage ---------------------------------------------
    from ..graphs.segments import skeleton_to_segments

    result = {"vesselness": vess, "mask": mask, "skeleton": skel,
              "segments": None, "pressure_batch": None, "network": None,
              "region_grow": {"iterations": int(grown.iterations),
                              "segmented_count":
                                  int(grown.segmented_count),
                              "stop_reason": int(grown.stop_reason)},
              "timings": timer.seconds}
    with timer.stage("graph"):
        _, segments = skeleton_to_segments(skel, prune_min_length=2,
                                           build_graph=False)
        result["segments"] = segments
        if not segments:
            return result
        net = flow_network(segments, mask)

    # --- flow: dp-batched longitudinal solve over timesteps ------------
    from ..flow import build_system, create_ground_truth

    with timer.stage("flow"):
        gt = create_ground_truth(net, option=2,
                                 rng=np.random.default_rng(0))
        if not gt.success:
            return result
        system = build_system(net, boundary_pressure=gt.pressure,
                              dtype=torch.float32, device=dev0)
        # the timestep axis: boundary pressures scaled per timestep (the
        # longitudinal TP adjustment axis), split over all of the mesh's
        # slots as dp
        scales = torch.linspace(1.0, 0.9, n_timesteps, dtype=torch.float64)
        batch = torch.as_tensor(gt.pressure, dtype=torch.float32)[None] \
            * scales[:, None]
        fixed = torch.where(system.node_fixed.cpu(), batch, 0.0)
        sol = solve_batch_dp(system, fixed.to(dev0), slots=mesh,
                             max_iter=30, linear_solver="cg")
        result["network"] = net
        result["pressure_batch"] = sol.pressure.cpu().numpy()
    return result


def flow_network(segments, mask):
    """The host graph's FlowNetwork (with the ADAN c and k) of the
    segments: branch attributes on the native EDT of ``mask``, the soa
    path rooted at the smallest tip (the first segment's start when no
    segment end is a tip)."""
    from ..constants import DEFAULT_SPACING
    from ..flow.adan import set_network_ck
    from ..graphs.branch_attrs import compute_branch_attrs
    from ..graphs.soa_path import segments_to_flow_network
    from ..ops.native import edt_masked_native

    dt = edt_masked_native(mask) if mask.any() else np.zeros(
        mask.shape, np.float32)
    attrs = compute_branch_attrs(segments, segments, dt)
    counts = {}
    for seg in segments:
        for vx in (tuple(seg[0]), tuple(seg[-1])):
            counts[vx] = counts.get(vx, 0) + 1
    tips = [vx for vx, c in counts.items() if c == 1]
    root = min(tips) if tips else tuple(segments[0][0])
    net, _ = segments_to_flow_network(segments, attrs, root,
                                      spacing=DEFAULT_SPACING)
    return set_network_ck(net)

