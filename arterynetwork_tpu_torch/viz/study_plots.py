# Copy of arterynetwork_tpu/viz/study_plots.py; matplotlib is imported inside the figure functions, the graphs are graphs/voxel_graph's.
"""Paper figure suite + per-partition statistics (reference C23 tail):

* ``statistics_per_partition`` / ``statistics_per_partition2`` —
  graphRelated.py:662-722 (morphology summaries per compartment and for
  the merged MCA/PCA/ACA groups);
* ``fig1`` .. ``fig18`` — the paper-figure family
  (graphRelated.py:752-1565): per-compartment distribution panels,
  per-graph-level whisker boxes, radius-vs-level, curvature plots;
* ``plot_terminating_pressures_timesteps`` — plotTerminatingPressures2
  (fluidSimulation.py:4070-4250);
* ``show_result_gbm_test5`` — the composite dashboard over the saved
  per-timestep GBMTest5 result pickles (fluidSimulation.py:3838-4004).

All functions are headless (Agg): pass ``path`` to save; the Figure is
returned for further composition.  matplotlib is imported by the figure
functions (viz/_mpl.py), not by this module: the statistics and
``_values_per_partition`` run without it.  The graphs are
graphs/voxel_graph's classes.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..morpho.metrics import calculate_property, summarize
from ._mpl import as_numpy, pyplot

PARTITION_NAMES = ["LMCA", "RMCA", "ACA", "LPCA", "RPCA"]
LEFT_RIGHT = [["LMCA", "LPCA"], ["RMCA", "RPCA"]]


# ----------------------------------------------------------------------
# statistics per partition (graphRelated.py:662-722)
# ----------------------------------------------------------------------
def statistics_per_partition(G, segment_list, partition_info,
                             spacing: float = 0.0004) -> Dict[str, dict]:
    """Morphology summary per compartment plus 'Overall'
    (statisticsPerPartition, graphRelated.py:662-689)."""
    out = {}
    overall = []
    for name, info in partition_info.items():
        overall += [segment_list[i] for i in info["segment_index_list"]]
    node_info, seg_info = calculate_property(
        G, overall, spacing=spacing, skip_uncategorized=True, min_nodes=0)
    out["Overall"] = summarize(node_info, seg_info, spacing=spacing)
    for name, info in partition_info.items():
        segs = [segment_list[i] for i in info["segment_index_list"]]
        node_info, seg_info = calculate_property(
            G, segs, spacing=spacing, skip_uncategorized=True, min_nodes=0)
        out[name] = summarize(node_info, seg_info, spacing=spacing)
    return out


def statistics_per_partition2(G, segment_list, partition_info,
                              spacing: float = 0.0004) -> Dict[str, dict]:
    """Merged-group summaries: PCA = LPCA+RPCA, MCA = LMCA+RMCA, ACA
    (statisticsPerPartition2, graphRelated.py:691-722)."""
    groups = {"PCA": ["LPCA", "RPCA"], "MCA": ["LMCA", "RMCA"],
              "ACA": ["ACA"]}
    out = {}
    for gname, members in groups.items():
        ids: List[int] = []
        for m in members:
            if m in partition_info:
                ids += list(partition_info[m]["segment_index_list"])
        segs = [segment_list[i] for i in ids]
        node_info, seg_info = calculate_property(
            G, segs, spacing=spacing, skip_uncategorized=True, min_nodes=0)
        out[gname] = summarize(node_info, seg_info, spacing=spacing)
    return out


# ----------------------------------------------------------------------
# shared panel helpers
# ----------------------------------------------------------------------
def _values_per_partition(info_dict, attr, scale=1.0, names=None,
                          extra=None):
    names = names or PARTITION_NAMES
    groups = []
    for name in names:
        member = name if isinstance(name, (list, tuple)) else [name]
        vals = [info[attr] * scale for info in info_dict.values()
                if info.get("partitionName") in member and attr in info
                and (extra is None or extra(info))]
        groups.append(vals)
    return groups


def _hist_lines(ax, groups, labels, xlabel):
    """Frequency-normalized histogram rendered as o- lines
    (the reference's fig1 panel idiom, graphRelated.py:763-780)."""
    for vals, label in zip(groups, labels):
        if not vals:
            continue
        weights = np.full(len(vals), 1.0 / len(vals))
        y, edges = np.histogram(vals, weights=weights)
        centers = 0.5 * (edges[1:] + edges[:-1])
        ax.plot(centers, y, "o-", label=label, markersize=3)
    ax.legend(loc="upper right", prop={"size": 5})
    ax.set_xlabel(xlabel, fontsize=7)
    ax.set_ylabel("Frequency", fontsize=7)


def _level_box(ax, info_dict, value_attr, scale=1.0, level_attr=None,
               ylabel="", type_filter=None):
    """Whisker box plot of value_attr grouped by graph level
    (the reference's fig2-fig6 panel idiom, via mf.boxPlotWithWhiskers)."""
    from .helpers import box_plot_whiskers

    levels, vals = [], []
    for info in info_dict.values():
        la = level_attr or ("segmentLevel" if "segmentLevel" in info
                            else "depthLevel")
        if la not in info or value_attr not in info:
            continue
        if type_filter and info.get("type") != type_filter:
            continue
        levels.append(info[la])
        vals.append(info[value_attr] * scale)
    if not levels:
        ax.set_ylabel(ylabel, fontsize=7)
        return
    levels = np.asarray(levels)
    vals = np.asarray(vals)
    positions = np.sort(np.unique(levels))
    values = [vals[levels == p].tolist() for p in positions]
    box_plot_whiskers(values, ax, positions=positions.tolist(),
                      xlabel="Graph level", ylabel=ylabel)


def _new_fig(n_rows, n_cols, height=3.0):
    plt = pyplot()
    fig, axes = plt.subplots(n_rows, n_cols,
                             figsize=(3.2 * n_cols, height * n_rows))
    axes = np.atleast_1d(axes).reshape(n_rows, n_cols)
    fig.subplots_adjust(left=0.05, right=0.96, top=0.90, bottom=0.15,
                        wspace=0.3, hspace=0.4)
    return fig, axes


def _save(fig, path):
    if path:
        fig.savefig(path, dpi=110)
        pyplot().close(fig)
    return fig


# ----------------------------------------------------------------------
# fig1-fig6 (graphRelated.py:752-1308)
# ----------------------------------------------------------------------
def fig1(segment_info, node_info, spacing_mm: float = 0.25, path=None):
    """Figure S1 subplots 1-8 (graphRelated.py:752-917)."""
    fig, axes = _new_fig(2, 4, height=3.2)
    _hist_lines(axes[0, 0], _values_per_partition(
        segment_info, "pathLength", spacing_mm), PARTITION_NAMES,
        "Branch Length (mm)")
    _hist_lines(axes[0, 1], _values_per_partition(
        node_info, "depthLevel"), PARTITION_NAMES, "Graph Level")
    for name in PARTITION_NAMES:
        lv = [i["depthLevel"] for i in node_info.values()
              if i.get("partitionName") == name and "depthLevel" in i
              and "type" in i]
        if lv:
            p = np.sort(np.unique(lv))
            axes[0, 2].plot(p, [lv.count(x) for x in p], "o-",
                            label=name, markersize=3)
    axes[0, 2].set_xlabel("Graph Level", fontsize=7)
    axes[0, 2].set_ylabel("# of nodes", fontsize=7)
    axes[0, 2].legend(prop={"size": 5})
    for side, label in zip(LEFT_RIGHT, ["Left", "Right"]):
        lv = [i["depthLevel"] for i in node_info.values()
              if i.get("partitionName") in side and "depthLevel" in i
              and "type" in i]
        if lv:
            p = np.sort(np.unique(lv))
            axes[0, 3].plot(p, [lv.count(x) for x in p], "o-",
                            label=label, markersize=3)
    axes[0, 3].set_xlabel("Graph Level", fontsize=7)
    axes[0, 3].set_ylabel("# of nodes", fontsize=7)
    axes[0, 3].legend(prop={"size": 5})
    _hist_lines(axes[1, 0], _values_per_partition(
        node_info, "depthVoxel"), PARTITION_NAMES, "Voxel Level")
    for tname, label in (("terminating", "Terminating"),
                         ("bifurcating", "Bifurcating")):
        lv = [i["depthLevel"] for i in node_info.values()
              if i.get("type") == tname and "depthLevel" in i]
        if lv:
            p = np.sort(np.unique(lv))
            axes[1, 1].plot(p, [lv.count(x) for x in p], "o-",
                            label=label, markersize=3)
    axes[1, 1].set_xlabel("Graph Level", fontsize=7)
    axes[1, 1].set_ylabel("# of nodes", fontsize=7)
    axes[1, 1].legend(prop={"size": 5})
    _hist_lines(axes[1, 2], _values_per_partition(
        segment_info, "meanRadius", spacing_mm), PARTITION_NAMES,
        "Mean radius (mm)")
    groups = _values_per_partition(segment_info, "meanRadius", spacing_mm,
                                   names=LEFT_RIGHT)
    weights = [np.full(len(g), 1.0 / len(g)) if g else [] for g in groups]
    axes[1, 3].hist([g for g in groups if len(g)],
                    weights=[w for w in weights if len(w)],
                    label=["Left", "Right"])
    axes[1, 3].legend(prop={"size": 5})
    axes[1, 3].set_xlabel("Mean radius (mm)", fontsize=7)
    axes[1, 3].set_ylabel("Frequency", fontsize=7)
    return _save(fig, path)


def fig2(segment_info, node_info, spacing_mm: float = 0.25, path=None):
    """Branch length / terminating / bifurcating length and voxel level
    vs graph level (graphRelated.py:919-996)."""
    fig, axes = _new_fig(1, 4)
    _level_box(axes[0, 0], segment_info, "pathLength", spacing_mm,
               ylabel="Branch length (mm)")
    _level_box(axes[0, 1], segment_info, "pathLength", spacing_mm,
               ylabel="Terminating branch length (mm)",
               type_filter="terminating")
    _level_box(axes[0, 2], segment_info, "pathLength", spacing_mm,
               ylabel="Bifurcating branch length (mm)",
               type_filter="bifurcating")
    _level_box(axes[0, 3], node_info, "depthVoxel",
               level_attr="depthLevel", ylabel="Voxel level")
    return _save(fig, path)


def fig3(segment_info, node_info, path=None):
    """Tortuosity panels (graphRelated.py:998-1075)."""
    fig, axes = _new_fig(1, 4)
    _level_box(axes[0, 0], segment_info, "tortuosity",
               ylabel="Tortuosity", type_filter=None)
    _level_box(axes[0, 1], segment_info, "tortuosity",
               ylabel="Terminating tortuosity", type_filter="terminating")
    _level_box(axes[0, 2], segment_info, "tortuosity",
               ylabel="Bifurcating tortuosity", type_filter="bifurcating")
    _level_box(axes[0, 3], segment_info, "aspectRatio",
               ylabel="Aspect ratio")
    return _save(fig, path)


def fig4(segment_info, node_info, path=None):
    """Bifurcation amplitude panels (graphRelated.py:1077-1154)."""
    fig, axes = _new_fig(1, 4)
    _level_box(axes[0, 0], node_info, "localBifurcationAmplitude",
               level_attr="depthLevel",
               ylabel="Local bifurcation amplitude (deg)")
    _level_box(axes[0, 1], node_info, "remoteBifurcationAmplitude",
               level_attr="depthLevel",
               ylabel="Remote bifurcation amplitude (deg)")
    _level_box(axes[0, 2], node_info, "localBifurcationTilt",
               level_attr="depthLevel",
               ylabel="Local bifurcation tilt (deg)")
    _level_box(axes[0, 3], node_info, "remoteBifurcationTilt",
               level_attr="depthLevel",
               ylabel="Remote bifurcation tilt (deg)")
    return _save(fig, path)


def fig5(segment_info, node_info, path=None):
    """Torque / law panels (graphRelated.py:1156-1223)."""
    fig, axes = _new_fig(1, 4)
    _level_box(axes[0, 0], segment_info, "localBifurcationTorque",
               ylabel="Local bifurcation torque (deg)")
    _level_box(axes[0, 1], node_info, "cubicLawResult",
               level_attr="depthLevel", ylabel="Cubic law ratio")
    _level_box(axes[0, 2], node_info, "squareLawResult",
               level_attr="depthLevel", ylabel="Square law ratio")
    _level_box(axes[0, 3], node_info, "lengthRatio",
               level_attr="depthLevel", ylabel="Length ratio")
    return _save(fig, path)


def fig6(segment_info, node_info, path=None):
    """Radius-ratio panels (graphRelated.py:1225-1308)."""
    fig, axes = _new_fig(1, 4)
    _level_box(axes[0, 0], node_info, "maxRadiusRatio",
               level_attr="depthLevel", ylabel="Max radius ratio")
    _level_box(axes[0, 1], node_info, "minRadiusRatio",
               level_attr="depthLevel", ylabel="Min radius ratio")
    _level_box(axes[0, 2], node_info, "minRadius",
               level_attr="depthLevel", ylabel="Min branch radius (voxel)")
    _level_box(axes[0, 3], segment_info, "meanRadius",
               ylabel="Mean radius (voxel)")
    return _save(fig, path)


# ----------------------------------------------------------------------
# fig11/11b radius vs level, fig12/13/18 curvature (graphRelated.py:1310-1565)
# ----------------------------------------------------------------------
def fig11(segment_info, node_info, spacing_mm: float = 0.25, path=None,
          names=("LMCA", "RMCA", "LPCA", "RPCA")):
    """Radius vs graph level per compartment, 2x2
    (graphRelated.py:1310-1383)."""
    fig, axes = _new_fig(2, 2, height=3.0)
    for ax, name in zip(axes.ravel(), names):
        lv = [i["segmentLevel"] for i in segment_info.values()
              if i.get("partitionName") == name and "segmentLevel" in i
              and "meanRadius" in i]
        r = [i["meanRadius"] * spacing_mm for i in segment_info.values()
             if i.get("partitionName") == name and "segmentLevel" in i
             and "meanRadius" in i]
        ax.plot(lv, r, "bo", markersize=3)
        ax.set_title(name, fontsize=8)
        ax.set_xlabel("Graph level", fontsize=7)
        ax.set_ylabel("Radius (mm)", fontsize=7)
    return _save(fig, path)


def fig11b(segment_info, node_info, spacing_mm: float = 0.25, path=None):
    """Radius vs graph level, 1x5 all compartments
    (graphRelated.py:1385-1474)."""
    fig, axes = _new_fig(1, 5)
    for ax, name in zip(axes.ravel(), PARTITION_NAMES):
        pairs = [(i["segmentLevel"], i["meanRadius"] * spacing_mm)
                 for i in segment_info.values()
                 if i.get("partitionName") == name and "segmentLevel" in i
                 and "meanRadius" in i]
        if pairs:
            lv, r = zip(*pairs)
            ax.plot(lv, r, "bo", markersize=3)
        ax.set_title(name, fontsize=8)
        ax.set_xlabel("Graph level", fontsize=7)
        ax.set_ylabel("Radius (mm)", fontsize=7)
    return _save(fig, path)


def _curvature_panels(segment_info, attr, render, path):
    fig, axes = _new_fig(2, 3, height=3.0)
    panels = PARTITION_NAMES + ["All"]
    for ax, name in zip(axes.ravel(), panels):
        vals = [(i.get("segmentLevel"), i[attr],
                 i.get("pathLength", np.nan))
                for i in segment_info.values() if attr in i
                and (name == "All" or i.get("partitionName") == name)]
        render(ax, vals)
        ax.set_title(name, fontsize=8)
    return _save(fig, path)


def fig12(segment_info, node_info, path=None):
    """Curvature distribution per compartment (graphRelated.py:1476-1502)."""
    def render(ax, vals):
        if vals:
            ax.hist([v[1] for v in vals])
        ax.set_xlabel("Mean curvature (mm^-1)", fontsize=7)
        ax.set_ylabel("Count", fontsize=7)
    return _curvature_panels(segment_info, "meanCurvatureAveragedInmm",
                             render, path)


def fig13(segment_info, node_info, path=None):
    """Max curvature vs graph level (graphRelated.py:1504-1535)."""
    def render(ax, vals):
        pts = [(l, c) for (l, c, _) in vals if l is not None]
        if pts:
            lv, c = zip(*pts)
            ax.plot(lv, c, "bo", markersize=3)
        ax.set_xlabel("Graph level", fontsize=7)
        ax.set_ylabel("Max curvature (mm^-1)", fontsize=7)
    return _curvature_panels(segment_info, "maxCurvatureAveragedInmm",
                             render, path)


def fig18(segment_info, node_info, spacing_mm: float = 0.25, path=None):
    """Mean curvature vs branch length (graphRelated.py:1537-1565)."""
    def render(ax, vals):
        pts = [(pl * spacing_mm, c) for (_, c, pl) in vals
               if np.isfinite(pl)]
        if pts:
            x, y = zip(*pts)
            ax.plot(x, y, "bo", markersize=3)
        ax.set_xlabel("Branch length (mm)", fontsize=7)
        ax.set_ylabel("Mean curvature (mm^-1)", fontsize=7)
    return _curvature_panels(segment_info, "meanCurvatureAveragedInmm",
                             render, path)


# ----------------------------------------------------------------------
# flow-study time-step plots (fluidSimulation.py:4070-4250, 3838-4004)
# ----------------------------------------------------------------------
def plot_terminating_pressures_timesteps(net, terminating_nodes, tp_array,
                                         partitions, option: int = 1,
                                         path=None):
    """plotTerminatingPressures2 (fluidSimulation.py:4070-4250):
    option 1 — one line per terminating node over timesteps, one panel
    per compartment (plus the compartment means overlaid in the last
    panel); option 2 — box plot of the per-compartment TP distribution
    per timestep; option 3 — 3D bar histogram of the TP distribution,
    one z-layer per compartment, one color per timestep (:4210-4248)."""
    from ..flow.boundary import terminating_nodes_of_partition

    tp_array = as_numpy(tp_array)
    T = tp_array.shape[1]
    row_of = {int(n): i for i, n in enumerate(terminating_nodes)}
    if option == 3:
        plt = pyplot()
        from mpl_toolkits.mplot3d import Axes3D  # noqa: F401

        colors = ["r", "g", "b", "y", "c", "m"]
        fig = plt.figure(figsize=(9, 8))
        ax = fig.add_subplot(projection="3d")
        for k, (name, part) in enumerate(partitions.items()):
            nodes = [n for n in terminating_nodes_of_partition(net, part)
                     if int(n) in row_of]
            rows = np.asarray([row_of[int(n)] for n in nodes], int)
            if not len(rows):
                continue
            for t in range(T):
                hist, bins = np.histogram(tp_array[rows, t], bins=10)
                xs = (bins[:-1] + bins[1:]) / 2
                color = colors[t % len(colors)]
                ax.bar(xs, hist, zs=k * 10, zdir="y", color=color,
                       ec=color, alpha=0.8)
        ax.set_xlabel("Terminating Pressure (mmHg)")
        ax.set_ylabel("Compartment")
        ax.set_zlabel("Count")
        ax.set_yticks([k * 10 for k in range(len(partitions))])
        ax.set_yticklabels(list(partitions))
        return _save(fig, path)
    n_panels = len(partitions) + (1 if option == 1 else 0)
    fig, axes = _new_fig(1, n_panels)
    for k, (name, part) in enumerate(partitions.items()):
        ax = axes[0, k]
        nodes = [n for n in terminating_nodes_of_partition(net, part)
                 if int(n) in row_of]
        rows = np.asarray([row_of[int(n)] for n in nodes], int)
        if option == 1:
            for r in rows:
                ax.plot(range(T), tp_array[r], "o-", markersize=2)
            if len(rows):
                axes[0, -1].plot(range(T), tp_array[rows].mean(axis=0),
                                 "o-", label=name, markersize=3)
        else:
            if len(rows):
                ax.boxplot([tp_array[rows, t] for t in range(T)],
                           positions=list(range(T)))
        ax.set_title(name, fontsize=8)
        ax.set_xlabel("Time step", fontsize=7)
        ax.set_ylabel("Terminating pressure (mmHg)", fontsize=7)
    if option == 1:
        axes[0, -1].set_title("Compartment means", fontsize=8)
        axes[0, -1].legend(prop={"size": 5})
    return _save(fig, path)


def show_volume_per_partition(result: Dict, path: Optional[str] = None,
                              left_right: bool = True):
    """Per-compartment volume vs time step (showVolumePerPartition,
    fluidSimulation.py:3051-3131).

    ``result`` is a ``flow.gbm_test5b`` output (its
    ``volume_per_partition`` list holds the per-timestep mm^3 volumes).
    When ``left_right`` and the CoW names are present, the reference's
    'Left' (LMCA+LPCA) and 'Right' (RMCA+RPCA) aggregate series are
    added (fluidSimulation.py:3113-3114).  Headless; returns the Figure.
    """
    plt = pyplot()
    volume_t = result["volume_per_partition"]
    T = len(volume_t)
    series = {name: np.array([v[name] for v in volume_t])
              for name in volume_t[0]}
    if left_right:
        for label, parts in (("Left", LEFT_RIGHT[0]),
                             ("Right", LEFT_RIGHT[1])):
            if all(p in series for p in parts):
                series[label] = sum(series[p] for p in parts)
    fig = plt.figure(figsize=(7, 3))
    fig.subplots_adjust(left=0.1, right=0.9, top=0.90, bottom=0.15)
    ax = fig.add_subplot(1, 1, 1)
    x = list(range(T))
    for name, y in series.items():
        ax.plot(x, y, "o-", label=name)
    ax.set_xlabel("Time step")
    ax.set_xticks(x)
    ax.set_xticklabels(["T{}".format(t) for t in x])
    ax.set_ylabel(r"Volume ($\mathrm{mm}^3$)")
    ax.legend(bbox_to_anchor=(0, 1.02, 1, 0.2), loc="lower left",
              mode="expand", borderaxespad=0, ncol=7, prop={"size": 8})
    return _save(fig, path)


def show_result_gbm_test5(store, net, num_timesteps: int = 5,
                          partitions=None, out_dir: Optional[str] = None,
                          version: int = 1):
    """Composite dashboard over the saved per-timestep GBMTest5 pickles
    (showResult_GBMTest5, fluidSimulation.py:3838-4004): one
    pressure/flow network plot per timestep plus both terminating-
    pressure time-step figures.  Returns the collected arrays."""
    import os

    pyplot()      # ImportError before any work where matplotlib is missing

    from ..constants import PASCAL_PER_MMHG
    from ..flow.boundary import COW_PARTITIONS
    from .network_plot import plot_network

    if partitions is None:
        partitions = COW_PARTITIONS
    deg = net.degree
    terminating = np.nonzero((deg == 1) & (net.node_depth != 0))[0]
    tp = np.zeros((len(terminating), num_timesteps))
    flows = np.zeros((net.num_edges, num_timesteps))
    figs = []
    for t in range(num_timesteps):
        blob = store.load_pickle(
            "fluidSimulationResult_GBMTest5_Timestep={}_v{}.pkl".format(
                t, version))
        pressure = np.asarray(blob["pressure"])
        flow = np.asarray(blob["flow"])
        tp[:, t] = pressure[terminating] / PASCAL_PER_MMHG
        flows[:, t] = flow
        p = (os.path.join(out_dir, "gbm5_network_t{}.png".format(t))
             if out_dir else None)
        figs.append(plot_network(
            net, node_values=np.round(pressure / PASCAL_PER_MMHG, 1),
            edge_values=np.round(flow * 1e6, 2),
            node_colorbar_label="Pressure (mmHg)",
            edge_colorbar_label="Flow (cm^3/s)",
            title="GBM_Time step={}".format(t), path=p))
    for option in (1, 2):
        p = (os.path.join(out_dir,
                          "gbm5_tp_option{}.png".format(option))
             if out_dir else None)
        figs.append(plot_terminating_pressures_timesteps(
            net, terminating, tp, partitions, option=option, path=p))
    return {"terminating_nodes": terminating,
            "terminating_pressures_mmhg": tp,
            "flow": flows, "figures": figs}


def show_result2_gbm_test5(store, net, timesteps=(0, 4),
                           out_dir: Optional[str] = None,
                           version: int = 1):
    """Two-timestep pressure/flow comparison with ONE shared legend
    (``showResult2_GBMTest5``, fluidSimulation.py:3926-4004): both
    network plots are drawn with common vmin/vmax (node = pressure in
    mmHg, edge = flow in cm^3/s) and hidden in-figure colorbars, and a
    third standalone-legend figure carries the shared scales."""
    import os

    pyplot()      # ImportError before any work where matplotlib is missing

    from ..constants import PASCAL_PER_MMHG
    from .network_plot import graph_plot_standalone_legend, plot_network

    records = []
    for t in timesteps:
        blob = store.load_pickle(
            "fluidSimulationResult_GBMTest5_Timestep={}_v{}.pkl".format(
                t, version))
        pressure_mmhg = np.round(
            np.asarray(blob["pressure"]) / PASCAL_PER_MMHG, 1)
        flow_cm3s = np.round(np.asarray(blob["flow"]) * 1e6, 2)
        records.append((t, pressure_mmhg, flow_cm3s))

    all_p = np.concatenate([p for _, p, _ in records])
    all_q = np.concatenate([q for _, _, q in records])
    vmin, vmax = float(all_p.min()), float(all_p.max())
    edge_vmin, edge_vmax = float(all_q.min()), float(all_q.max())

    figs = []
    for t, p, q in records:
        path = (os.path.join(out_dir, "gbm5_compare_t{}.png".format(t))
                if out_dir else None)
        figs.append(plot_network(
            net, node_values=p, edge_values=q,
            vmin=vmin, vmax=vmax, edge_vmin=edge_vmin,
            edge_vmax=edge_vmax, hide_colorbar=True,
            title="GBM_Time step={}".format(t), path=path))
    legend_path = (os.path.join(out_dir, "gbm5_compare_legend.png")
                   if out_dir else None)
    figs.append(graph_plot_standalone_legend(
        vmin, vmax, edge_vmin, edge_vmax,
        node_label="Pressure (mmHg)",
        edge_label="Flow rate (cm^3/s)", path=legend_path))
    return {"timesteps": list(timesteps),
            "node_range_mmhg": (vmin, vmax),
            "edge_range_cm3s": (edge_vmin, edge_vmax),
            "figures": figs}


def _draw_reduced_graph(ax, DG, node_values, edge_values, nnorm, enorm,
                        ncmap, ecmap, title):
    """Draw one compartment's reduced graph using voxel-coordinate
    projection (the headless analog of the reference's graphviz layout)."""
    for (a, b), val in zip(DG.edges(), edge_values):
        ax.plot([a[2], b[2]], [a[1], b[1]], "-",
                color=ecmap(enorm(val)), lw=1.8, zorder=1)
    xs = [n[2] for n in DG.nodes()]
    ys = [n[1] for n in DG.nodes()]
    ax.scatter(xs, ys, c=[ncmap(nnorm(v)) for v in node_values],
               s=28, zorder=2)
    ax.set_title(title, fontsize=9)
    ax.set_aspect("equal")
    ax.invert_yaxis()
    ax.set_axis_off()


def graph_plot_per_partition(G, segment_list, segment_info, node_info,
                             partition_info, spacing_mm: float = 0.4,
                             shared_colorbar: bool = False,
                             dataset_name: str = "GBM", path=None):
    """Per-compartment reduced-graph plots: nodes colored by Murray's-law
    ratio (``cubicLawResult``), edges by radius in mm.

    ``shared_colorbar=False`` gives each compartment its own figure panel
    with independent scales (``graphPlotPerPartition``,
    graphRelated.py:1635-1670); ``True`` normalizes node and edge colors
    across all compartments and attaches one shared pair of colorbars
    (``graphPlotPerPartition2``, :1672-1718).
    """
    from ..graphs.traversal import reduce_graph

    plt = pyplot()

    names = list(partition_info.keys())
    per_part = []
    for name in names:
        info = partition_info[name]
        seg_ids = info.get("segment_index_list",
                           info.get("segmentIndexList", []))
        DG = reduce_graph(G, segment_list, seg_ids)
        nv = [node_info.get(n, {}).get("cubicLawResult", 0) or 0
              for n in DG.nodes()]
        ev = [segment_info[DG[a][b]["segmentIndex"]]["meanRadius"]
              * spacing_mm for a, b in DG.edges()]
        per_part.append((name, DG, nv, ev))

    all_nv = [v for _, _, nv, _ in per_part for v in nv] or [0.0]
    all_ev = [v for _, _, _, ev in per_part for v in ev] or [0.0]
    ncmap = plt.get_cmap("jet")
    ecmap = plt.get_cmap("jet")

    fig, axes = plt.subplots(1, len(per_part),
                             figsize=(3.2 * len(per_part), 3.6))
    axes = np.atleast_1d(axes)
    for ax, (name, DG, nv, ev) in zip(axes, per_part):
        if shared_colorbar:
            nnorm = plt.Normalize(min(all_nv), max(all_nv) or 1)
            enorm = plt.Normalize(min(all_ev), max(all_ev) or 1)
        else:
            nnorm = plt.Normalize(min(nv, default=0), max(nv, default=1)
                                  or 1)
            enorm = plt.Normalize(min(ev, default=0), max(ev, default=1)
                                  or 1)
        _draw_reduced_graph(ax, DG, nv, ev, nnorm, enorm, ncmap, ecmap,
                            "{}, {}".format(name, dataset_name))
    if shared_colorbar:
        nnorm = plt.Normalize(min(all_nv), max(all_nv) or 1)
        enorm = plt.Normalize(min(all_ev), max(all_ev) or 1)
        sm_n = plt.cm.ScalarMappable(norm=nnorm, cmap=ncmap)
        sm_e = plt.cm.ScalarMappable(norm=enorm, cmap=ecmap)
        cbn = fig.colorbar(sm_n, ax=axes.tolist(), fraction=0.03,
                           pad=0.02)
        cbn.set_label("Murray's law ratio")
        cbe = fig.colorbar(sm_e, ax=axes.tolist(), fraction=0.03,
                           pad=0.06)
        cbe.set_label("Radius (mm)")
    return _save(fig, path)


def graph_plot_per_partition2(G, segment_list, segment_info, node_info,
                              partition_info, spacing_mm: float = 0.4,
                              dataset_name: str = "GBM", path=None):
    """The shared-colorbar variant by name (``graphPlotPerPartition2``,
    graphRelated.py:1672-1745): all five compartments normalized to one
    node scale (Murray's-law ratio) and one edge scale (radius in mm)
    with a single pair of colorbars."""
    return graph_plot_per_partition(
        G, segment_list, segment_info, node_info, partition_info,
        spacing_mm=spacing_mm, shared_colorbar=True,
        dataset_name=dataset_name, path=path)


def plot_radius_vs_graph_level(net, partitions, path=None):
    """Radius-vs-graph-level whisker boxes, one panel per compartment
    (BFSTest, fluidSimulation.py:4474-4535: BFS each partition from its
    start nodes stopping at boundary nodes, then box-plot the visited
    edges' mean radius in mm against their graph level).

    ``partitions`` maps name -> {"start_nodes": [...],
    "boundary_nodes": [...]} (the reference's partitionInfo)."""
    from .helpers import box_plot_whiskers
    from ..flow.boundary import bfs_partition

    fig, axes = _new_fig(1, max(len(partitions), 1))
    radius_mm = np.asarray(net.radius_m()) * 1000.0
    edge_level = np.asarray(net.edge_depth)
    for ax, (name, part) in zip(axes.ravel(), partitions.items()):
        res = bfs_partition(net, part["start_nodes"],
                            part.get("boundary_nodes", []))
        edges = np.asarray(res["visited_edges"], dtype=np.int64)
        if len(edges):
            levels = edge_level[edges]
            positions = np.sort(np.unique(levels))
            values = [radius_mm[edges[levels == p]].tolist()
                      for p in positions]
            box_plot_whiskers(values, ax, positions=positions.tolist(),
                              xlabel="Graph level", ylabel="Radius (mm)")
        ax.set_title(name)
    return _save(fig, path)
