# Port of arterynetwork_tpu/__main__.py; every command takes --device (default cuda).
"""Command-line interface.

    python -m arterynetwork_tpu_torch pipeline INPUT.nii.gz --out DIR [options]
    python -m arterynetwork_tpu_torch vesselness INPUT.nii.gz OUTPUT.nii.gz
    python -m arterynetwork_tpu_torch study NAME --out DIR [options]
    python -m arterynetwork_tpu_torch morpho DIR [--no-figures]
    python -m arterynetwork_tpu_torch info

The reference's pipeline is a set of scripts edited by hand per run
(README.md:111-199); this CLI runs the same stages end-to-end from one
command with artifacts written in the reference's file layout.  The
tensors live on ``--device`` (default ``cuda``; ``cpu`` for a machine
without a card).  The figures (``study gbm5``/``gbm5b``, ``morpho``
without ``--no-figures``) need matplotlib.
"""

from __future__ import annotations

import argparse
import json


def _cmd_pipeline(args):
    import numpy as np

    from .config import PipelineConfig
    from .io.artifacts import ArtifactStore
    from .io.nifti import load_volume
    from .pipeline import run_pipeline

    volume, affine = load_volume(args.input)
    cfg = PipelineConfig()
    if args.threshold is not None:
        cfg.segmentation.global_threshold_fraction = args.threshold
    if args.weak_threshold is not None:
        cfg.segmentation.weak_threshold_fraction = args.weak_threshold
    cfg.segmentation.border_margin_voxels = args.border_margin
    if args.sigmas:
        cfg.vesselness.sigmas = tuple(float(x)
                                      for x in args.sigmas.split(","))
    cfg.vesselness.upload_format = args.upload_format
    cfg.skeleton.backend = args.skeleton_backend
    store = ArtifactStore(args.out)
    kwargs = {}
    if args.raw:
        kwargs["raw_volume"] = np.asarray(volume, np.float32)
    else:
        kwargs["vesselness"] = np.asarray(volume, np.float32)
    if args.brain_mask:
        kwargs["brain_mask"] = load_volume(args.brain_mask)[0] != 0
    result = run_pipeline(config=cfg, store=store, affine=affine,
                          device=args.device, **kwargs)
    summary = {
        "mask_voxels": int(result["mask"].sum()),
        "skeleton_voxels": int(result["skeleton"].sum()),
        "segments": len(result["segments"]),
        "network_nodes": result["network"].num_nodes,
        "network_edges": result["network"].num_edges,
        "timings_s": result["timings"],
    }
    print(json.dumps(summary, indent=2))


def _cmd_vesselness(args):
    import numpy as np

    from .io.nifti import load_volume, save_volume
    from .ops.vesselness import frangi_vesselness

    volume, affine = load_volume(args.input)
    v = frangi_vesselness(
        np.asarray(volume, np.float32),
        sigmas=tuple(float(s) for s in args.sigmas.split(",")),
        device=args.device).cpu().numpy()
    save_volume(v, affine, args.output, astype=np.float32)
    print(f"wrote {args.output}")


def _cmd_study(args):
    """Run a longitudinal flow study (reference test1-6 / GBMTest4/5
    drivers) on a synthetic partitioned tree or a legacy network dir."""
    import numpy as np

    from .flow import (create_ground_truth, flow_split_study, gbm_test4,
                       same_flow_study, save_gbm_test5_results,
                       tp_fit_solve_study, two_timepoint_comparison)
    from .flow.boundary import bfs_partition
    from .graphs import generate_tree, set_network_properties
    from .io.artifacts import ArtifactStore

    rng = np.random.default_rng(args.seed)
    if args.network_dir:
        from .flow.network_setup import convert_network, load_network
        loaded = load_network(args.network_dir, version=args.version)
        net, _ = convert_network(loaded)
        roots = np.nonzero(net.node_depth == 1)[0][:2]
    else:
        net = set_network_properties(
            generate_tree(max_depth=args.depth, rng=rng), rng=rng)
        roots = np.nonzero(net.node_depth == 1)[0]
    if getattr(args, "physics", "hw") == "dw":
        from .flow import apply_darcy_weisbach
        net = apply_darcy_weisbach(net)
    partitions = {f"P{i}": {"start_nodes": [int(r)], "boundary_nodes": []}
                  for i, r in enumerate(roots)}

    radius_end = net.radius.copy()
    shrink_edges = bfs_partition(
        net, partitions[next(iter(partitions))]["start_nodes"],
        [])["visited_edges"]
    radius_end[shrink_edges] *= args.shrink

    store = ArtifactStore(args.out)
    common = dict(num_timesteps=args.timesteps,
                  interpolation_option=args.interpolation,
                  partitions=partitions)
    if args.name == "flow_split":
        out = flow_split_study(net, radius_end, **common)
    elif args.name == "same_flow":
        out = same_flow_study(net, radius_end, **common)
    elif args.name == "two_timepoint":
        out = two_timepoint_comparison(net, radius_end)
    elif args.name == "tp_fit":
        out = tp_fit_solve_study(net, radius_end, store=store,
                                 device=args.device, **common)
    elif args.name == "gbm4":
        out = gbm_test4(net, partitions=partitions,
                        partition_to_perturb=(next(iter(partitions)),),
                        store=store, device=args.device)
    elif args.name == "gbm5":
        import torch

        from .flow.longitudinal import run_longitudinal
        from .viz import show_result_gbm_test5

        gt = create_ground_truth(net, option=2, rng=rng)
        batch, sol = run_longitudinal(
            net, gt.pressure, radius_end, num_timesteps=args.timesteps,
            interpolation_option=args.interpolation,
            partitions=partitions, dtype=torch.float64, device=args.device)
        save_gbm_test5_results(store, net, batch, sol)
        out = show_result_gbm_test5(store, net,
                                    num_timesteps=args.timesteps,
                                    partitions=partitions,
                                    out_dir=args.out)
    elif args.name == "gbm5b":
        import os

        from .flow import gbm_test5b
        from .viz import show_volume_per_partition
        out = gbm_test5b(net, radius_end, excluded_edges=(), **common)
        show_volume_per_partition(
            out, path=os.path.join(args.out, "gbm5b_volumes.png"))
    elif args.name == "distribute":
        from .flow import distribute_flow_study
        out = distribute_flow_study(net, device=args.device)
        out = {k: v for k, v in out.items()
               if k not in ("result", "system")}
    else:
        raise SystemExit(f"unknown study {args.name}")

    def _clean(v):
        if isinstance(v, dict):
            return {k: _clean(x) for k, x in v.items()}
        if isinstance(v, np.ndarray):
            return {"shape": list(v.shape),
                    "mean": float(np.nanmean(v)) if v.size else None}
        if isinstance(v, (list, tuple)):
            if len(v) > 12:
                return f"[{len(v)} items]"
            return [_clean(x) for x in v]
        if isinstance(v, (np.integer, np.floating)):
            return float(v)
        return v if isinstance(v, (int, float, str, bool, type(None))) \
            else str(type(v).__name__)

    print(json.dumps(_clean(dict(out)), indent=2, default=str))


def _normalized_partitions(chosen, partition_info):
    """Merge chosenVoxels + partitionInfo into curvature-style partition
    dicts, accepting both this package's snake_case keys and the
    reference pickles' camelCase (loadBasicFiles consumers,
    graphRelated.py:526-529)."""
    out = {}
    for name, info in partition_info.items():
        ch = chosen.get(name, {})
        out[name] = {
            "initial_voxels": [tuple(v) for v in
                               ch.get("initial_voxels",
                                      ch.get("initialVoxels", []))],
            "boundary_voxels": [tuple(v) for v in
                                ch.get("boundary_voxels",
                                       ch.get("boundaryVoxels", []))],
            "visited_voxels": [tuple(v) for v in
                               info.get("visited_voxels",
                                        info.get("visitedVoxels", []))],
            "segment_index_list": list(
                info.get("segment_index_list",
                         info.get("segmentIndexList", []))),
        }
    return out


def _build_morpho_bundle(store, partitions_json, spacing):
    """Build the morphology bundle from pipeline outputs when the
    interactive partition step hasn't produced one: auto- (or JSON-)
    seeded compartments + generateInfoDict (graphRelated.py:402-432,
    partitionCompartmentGUIDetail.py:289-343, headless)."""
    from .graphs.partitioning import partition_compartments, save_partition
    from .graphs.traversal import partition_bfs
    from .graphs.voxel_graph import connected_components
    from .morpho.metrics import calculate_property

    graph_name = None
    for cand in ("graphRepresentationCleanedWithAdvancedInfo.graphml",
                 "graphRepresentationCleanedWithEdgeInfo.graphml"):
        if store.exists(cand):
            graph_name = cand
            break
    if graph_name is None:
        raise SystemExit("no graphml in {}: run the pipeline first"
                         .format(store.base_dir))
    seg_name = ("segmentListCleaned.npz"
                if store.exists("segmentListCleaned.npz")
                else "segmentList.npz")
    G = store.load_graphml(graph_name)
    segments = store.load_segment_list(seg_name)

    if partitions_json:
        with open(partitions_json) as f:
            chosen = {name: {"initial_voxels":
                             [tuple(v) for v in spec["initial_voxels"]],
                             "boundary_voxels":
                             [tuple(v) for v in
                              spec.get("boundary_voxels", [])]}
                      for name, spec in json.load(f).items()}
    else:
        # Headless auto-seeding: one compartment per connected component,
        # rooted at its lowest-z endpoint (the reference picks seeds in a
        # GUI; component roots give full coverage without one).
        names = ("ACA", "LMCA", "RMCA", "LPCA", "RPCA")
        chosen = {}
        comps = sorted(connected_components(G), key=len, reverse=True)
        for i, comp in enumerate(comps):
            ends = [v for v in comp if G.degree(v) == 1] or list(comp)
            seed = min(ends, key=lambda v: (v[2], v[0], v[1]))
            name = (names[i] if i < len(names)
                    else "P{}".format(i - len(names)))
            chosen[name] = {"initial_voxels": [seed],
                            "boundary_voxels": []}

    roots = [c["initial_voxels"][0] for c in chosen.values()]
    partition_bfs(G, roots, [])  # graph-wide depth attrs first
    partition_info = partition_compartments(G, segments, chosen)
    node_info, seg_info = calculate_property(
        G, segments, spacing=spacing, skip_uncategorized=True, min_nodes=0)
    save_partition(store, chosen, partition_info, G)
    store.save_segment_list("segmentListCleaned.npz", segments)
    store.save_pickle("segmentInfoDict.pkl", seg_info)
    store.save_pickle("nodeInfoDict.pkl", node_info)


def _cmd_morpho(args):
    """The reference's morphology analysis driver in one command
    (graphRelated.py __main__, :1745-1752): generateInfoDict ->
    calculateCurvature -> statisticsPerPartition(2) -> createPlots ->
    graphPlotPerPartition(2)."""
    import os

    from .io.artifacts import ArtifactStore, load_basic_files
    from .morpho.curvature import calculate_curvature
    from .viz import (fig1, fig2, fig3, fig4, fig5, fig6, fig11, fig11b,
                      fig12, fig13, fig18, graph_plot_per_partition,
                      statistics_per_partition, statistics_per_partition2)

    store = ArtifactStore(args.dir)
    out_dir = args.out or args.dir
    os.makedirs(out_dir, exist_ok=True)
    if args.spacing_mm is None:
        args.spacing_mm = args.spacing * 1000.0

    if args.rebuild or not store.exists("segmentInfoDict.pkl"):
        _build_morpho_bundle(store, args.partitions, args.spacing)
    bundle = load_basic_files(store)
    G, segments = bundle["G"], bundle["segmentList"]
    seg_info = bundle["segmentInfoDict"]
    node_info = bundle["nodeInfoDict"]
    partition_info = bundle["partitionInfo"]

    parts = _normalized_partitions(bundle["chosenVoxels"], partition_info)
    seg_info = calculate_curvature(G, seg_info, parts,
                                   spacing_factor_mm=args.spacing_mm)
    store.save_pickle("segmentInfoDict.pkl", seg_info)

    # the normalized dicts, not the raw pickle: reference-style bundles
    # use camelCase keys that statistics_per_partition does not accept
    stats = statistics_per_partition(G, segments, parts,
                                     spacing=args.spacing)
    stats2 = statistics_per_partition2(G, segments, parts,
                                       spacing=args.spacing)

    spacing_mm = args.spacing_mm  # defaulted to spacing*1000 when unset
    figures = {}
    if not args.no_figures:
        from .viz._mpl import pyplot

        plt = pyplot()
        renders = {"fig1": lambda p: fig1(seg_info, node_info,
                                          spacing_mm=spacing_mm, path=p),
                   "fig2": lambda p: fig2(seg_info, node_info,
                                          spacing_mm=spacing_mm, path=p),
                   "fig3": lambda p: fig3(seg_info, node_info, path=p),
                   "fig4": lambda p: fig4(seg_info, node_info, path=p),
                   "fig5": lambda p: fig5(seg_info, node_info, path=p),
                   "fig6": lambda p: fig6(seg_info, node_info, path=p),
                   "fig11": lambda p: fig11(seg_info, node_info,
                                            spacing_mm=spacing_mm, path=p),
                   "fig11b": lambda p: fig11b(seg_info, node_info,
                                              spacing_mm=spacing_mm,
                                              path=p),
                   "fig12": lambda p: fig12(seg_info, node_info, path=p),
                   "fig13": lambda p: fig13(seg_info, node_info, path=p),
                   "fig18": lambda p: fig18(seg_info, node_info,
                                            spacing_mm=spacing_mm,
                                            path=p),
                   "graphPerPartition": lambda p: graph_plot_per_partition(
                       G, segments, seg_info, node_info, partition_info,
                       spacing_mm=spacing_mm, path=p),
                   "graphPerPartition2": lambda p: graph_plot_per_partition(
                       G, segments, seg_info, node_info, partition_info,
                       spacing_mm=spacing_mm, shared_colorbar=True,
                       path=p)}
        for name, render in renders.items():
            p = os.path.join(out_dir, name + ".png")
            try:
                render(p)
                figures[name] = p
            except Exception as exc:  # one bad panel shouldn't kill the run
                figures[name] = "FAILED: {}".format(exc)
            plt.close("all")

    print(json.dumps({"statisticsPerPartition": stats,
                      "statisticsPerPartition2": stats2,
                      "figures": figures}, indent=2, default=str))


def _cmd_info(args):
    import torch

    from . import __version__

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    print(json.dumps({
        "version": __version__,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "cuda_available": torch.cuda.is_available(),
        "devices": [torch.cuda.get_device_name(i) for i in range(n)],
    }, indent=2))


def main(argv=None):
    p = argparse.ArgumentParser(prog="arterynetwork_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def device_flag(parser):
        parser.add_argument("--device", default="cuda",
                            help="torch device the tensors live on "
                                 "(cuda, cuda:N or cpu)")

    pp = sub.add_parser("pipeline", help="volume -> graph -> flow")
    pp.add_argument("input")
    pp.add_argument("--out", required=True)
    pp.add_argument("--raw", action="store_true",
                    help="input is a raw MRA volume (compute vesselness)")
    pp.add_argument("--threshold", type=float, default=None,
                    help="strong threshold fraction "
                         "(generateVesselVolume.py:190 default 0.7)")
    pp.add_argument("--weak-threshold", type=float, default=None,
                    help="enable hysteresis segmentation: weak floor "
                         "fraction (components must contain a voxel "
                         "above --threshold)")
    pp.add_argument("--border-margin", type=int, default=0,
                    help="zero the response within N voxels of the "
                         "volume faces")
    pp.add_argument("--brain-mask", default=None,
                    help="brain mask NIfTI for near-boundary "
                         "suppression (generateVesselVolume.py:186-191)")
    pp.add_argument("--sigmas", default=None,
                    help="vesselness scales, e.g. 1.0,2.0,3.0 "
                         "(with --raw)")
    pp.add_argument("--upload-format", default="u12",
                    choices=("u12", "u8", "bq4", "bq3", "bq2", "f16"),
                    help="raw-volume upload format (--raw mode): u12 keeps "
                         "full MRA acquisition precision; bq4/bq3/bq2 are "
                         "row-adaptive low-bit formats "
                         "(verify fidelity on your data below bq4)")
    pp.add_argument("--skeleton-backend", default="auto",
                    choices=("auto", "jax", "native"))
    device_flag(pp)
    pp.set_defaults(fn=_cmd_pipeline)

    pv = sub.add_parser("vesselness", help="Frangi filter a volume")
    pv.add_argument("input")
    pv.add_argument("output")
    pv.add_argument("--sigmas", default="1.0,2.0,3.0")
    device_flag(pv)
    pv.set_defaults(fn=_cmd_vesselness)

    ps = sub.add_parser("study", help="longitudinal flow studies "
                        "(test1-6 / GBMTest4/5 drivers)")
    ps.add_argument("name", choices=("flow_split", "same_flow",
                                     "two_timepoint", "tp_fit", "gbm4",
                                     "gbm5", "gbm5b", "distribute"))
    ps.add_argument("--out", required=True)
    ps.add_argument("--timesteps", type=int, default=4)
    ps.add_argument("--interpolation", type=int, default=1,
                    help="1=linear, 2=tanh (fluidSimulation.py:3177-3190)")
    ps.add_argument("--shrink", type=float, default=0.85,
                    help="end-timepoint radius factor on one compartment")
    ps.add_argument("--depth", type=int, default=6,
                    help="synthetic tree depth when no --network-dir")
    ps.add_argument("--seed", type=int, default=0)
    ps.add_argument("--physics", choices=("hw", "dw"), default="hw",
                    help="edge pressure-drop law: Hazen-Williams (ADAN "
                    "c/k) or laminar Darcy-Weisbach (the reference's "
                    "unfinished method='DW', fluidSimulation.py:4692)")
    ps.add_argument("--network-dir", default=None,
                    help="legacy pickle bundle directory (loadNetwork)")
    ps.add_argument("--version", type=int, default=4)
    device_flag(ps)
    ps.set_defaults(fn=_cmd_study)

    pm = sub.add_parser("morpho", help="morphology analysis driver "
                        "(graphRelated __main__: info dicts, curvature, "
                        "statistics)")
    pm.add_argument("dir", help="artifact directory (pipeline output or "
                    "reference-style bundle)")
    pm.add_argument("--out", default=None,
                    help="figure output directory (default: dir)")
    pm.add_argument("--partitions", default=None,
                    help="JSON file {name: {initial_voxels: [[x,y,z],..], "
                         "boundary_voxels: [...]}} replacing the "
                         "reference's GUI seed picking")
    pm.add_argument("--spacing", type=float, default=0.0004,
                    help="meters/voxel (graphRelated.py:418)")
    pm.add_argument("--spacing-mm", type=float, default=None,
                    help="voxel->mm factor for curvature "
                         "(graphRelated.py:524); defaults to "
                         "spacing * 1000")
    pm.add_argument("--rebuild", action="store_true",
                    help="rebuild info dicts/partition even if present")
    pm.add_argument("--no-figures", action="store_true",
                    help="statistics only, no figures")
    device_flag(pm)
    pm.set_defaults(fn=_cmd_morpho)

    pi = sub.add_parser("info", help="torch, CUDA and device info")
    pi.set_defaults(fn=_cmd_info)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
