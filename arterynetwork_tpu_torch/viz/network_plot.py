# Copy of arterynetwork_tpu/viz/network_plot.py; matplotlib is imported inside the figure functions, and values may be torch tensors.
"""Network and result plots (reference C23).

Graphviz-free equivalents of ``plotNetwork`` (fluidSimulation.py:2807-2876)
and the result dashboards (:4034-4473): tree layout by depth, node/edge
value colormaps, terminating-pressure distributions, per-compartment flow,
root pressures over time, terminating pressure vs path length.
All figures are returned (and optionally saved); matplotlib's Agg backend
keeps everything headless.  matplotlib is imported by the figure functions
(viz/_mpl.py), not by this module: ``_tree_layout``,
``pressure_velocity_arrays`` and ``pressure_velocity_volumes`` are numpy.
Values may be torch tensors (on any device) or arrays.
"""

from __future__ import annotations

import numpy as np

from ..constants import PASCAL_PER_MMHG
from ..graphs.network import FlowNetwork
from ._mpl import as_numpy, pyplot


def _tree_layout(net: FlowNetwork):
    """Depth-layered layout: y = -depth, x = in-order position of the
    subtree (a dot-like hierarchical layout without graphviz)."""
    children = [[] for _ in range(net.num_nodes)]
    for e in range(net.num_edges):
        children[int(net.heads[e])].append(int(net.tails[e]))
    xs = np.zeros(net.num_nodes)
    counter = [0.0]
    seen = set()

    def place(n):
        if n in seen:
            return xs[n]
        seen.add(n)
        if not children[n]:
            xs[n] = counter[0]
            counter[0] += 1.0
        else:
            xs[n] = np.mean([place(c) for c in children[n]])
        return xs[n]

    import sys
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(10000, net.num_nodes * 2))
    try:
        for root in net.entry_nodes:
            place(int(root))
        for n in range(net.num_nodes):
            place(n)
    finally:
        sys.setrecursionlimit(old)
    ys = -net.node_depth.astype(float)
    return xs, ys


def plot_network(net: FlowNetwork, node_values=None, edge_values=None,
                 node_labels=None, edge_labels=None, title=None,
                 node_colorbar_label=None, edge_colorbar_label=None,
                 path=None, figsize=(15, 8), vmin=None, vmax=None,
                 edge_vmin=None, edge_vmax=None, hide_colorbar=False):
    """Hierarchical network plot with value colormaps
    (plotNetwork parity, fluidSimulation.py:2807-2876).

    ``vmin``/``vmax``/``edge_vmin``/``edge_vmax`` pin the color scales
    (the reference's shared-legend multi-figure comparisons,
    fluidSimulation.py:2862-2868) and ``hide_colorbar`` suppresses the
    in-figure colorbar so a ``graph_plot_standalone_legend`` figure can
    carry one legend for several plots."""
    plt = pyplot()
    xs, ys = _tree_layout(net)
    fig, ax = plt.subplots(figsize=figsize)

    if edge_values is not None:
        ev = as_numpy(edge_values).astype(float)
        lo = ev.min() if edge_vmin is None else edge_vmin
        hi = ev.max() if edge_vmax is None else edge_vmax
        enorm = plt.Normalize(lo, hi if hi > lo else lo + 1)
        ecmap = plt.get_cmap("jet")
    for e in range(net.num_edges):
        h, t = int(net.heads[e]), int(net.tails[e])
        color = (ecmap(enorm(ev[e])) if edge_values is not None else "0.6")
        ax.plot([xs[h], xs[t]], [ys[h], ys[t]], "-", color=color, lw=1.5,
                zorder=1)
        if edge_labels is not None:
            ax.annotate(str(edge_labels[e]),
                        ((xs[h] + xs[t]) / 2, (ys[h] + ys[t]) / 2),
                        fontsize=6, ha="center")

    if node_values is not None:
        nv = as_numpy(node_values).astype(float)
        sc = ax.scatter(xs, ys, c=nv, cmap="jet", s=30, zorder=2,
                        vmin=vmin, vmax=vmax)
        if not hide_colorbar:
            cb = fig.colorbar(sc, ax=ax)
            if node_colorbar_label:
                cb.set_label(node_colorbar_label)
    else:
        ax.scatter(xs, ys, c="k", s=15, zorder=2)
    if node_labels is not None:
        for n in range(net.num_nodes):
            ax.annotate(str(node_labels[n]), (xs[n], ys[n]), fontsize=6)

    ax.set_title(title or "")
    ax.set_axis_off()
    if path:
        fig.savefig(path, dpi=110, bbox_inches="tight")
    return fig


def graph_plot_standalone_legend(vmin, vmax, edge_vmin, edge_vmax,
                                 node_label="Pressure (mmHg)",
                                 edge_label="Flow rate (cm^3/s)",
                                 label_size=18, tick_size=18, path=None):
    """Standalone legend figure: two horizontal colorbars spanning the
    shared node/edge scales (``graphPlotStandaloneLegend``,
    fluidSimulation.py:4006-4032) — pairs with ``hide_colorbar=True``
    network plots."""
    plt = pyplot()
    import matplotlib as mpl

    fig = plt.figure(figsize=(12, 8))
    plt.subplots_adjust(left=0.15, right=0.85, top=0.94, bottom=0.06,
                        wspace=0.3, hspace=0.9)
    ax1 = fig.add_axes([0.15, 0.9, 0.7, 0.04])
    cb1 = mpl.colorbar.ColorbarBase(
        ax1, cmap=plt.get_cmap("jet"),
        norm=mpl.colors.Normalize(vmin=vmin, vmax=vmax),
        orientation="horizontal")
    cb1.set_label(node_label, size=label_size)
    cb1.ax.tick_params(labelsize=tick_size)
    ax2 = fig.add_axes([0.15, 0.75, 0.7, 0.04])
    cb2 = mpl.colorbar.ColorbarBase(
        ax2, cmap=plt.get_cmap("jet"),
        norm=mpl.colors.Normalize(vmin=edge_vmin, vmax=edge_vmax),
        orientation="horizontal")
    cb2.set_label(edge_label, size=label_size)
    cb2.ax.tick_params(labelsize=tick_size)
    if path:
        fig.savefig(path, dpi=110)
    return fig


def plot_terminating_pressure_distribution(net, node_pressure, partitions,
                                           path=None):
    """Per-compartment terminating pressure histograms
    (fluidSimulation.py:4034-4251)."""
    from ..flow.boundary import terminating_nodes_of_partition

    plt = pyplot()
    node_pressure = as_numpy(node_pressure)
    fig, axes = plt.subplots(1, max(len(partitions), 1),
                             figsize=(3 * len(partitions), 3))
    if len(partitions) == 1:
        axes = [axes]
    for ax, (name, part) in zip(np.atleast_1d(axes), partitions.items()):
        nodes = terminating_nodes_of_partition(net, part)
        vals = [node_pressure[n] / PASCAL_PER_MMHG for n in nodes]
        if vals:
            ax.hist(vals, bins=10)
        ax.set_title(name)
        ax.set_xlabel("terminating pressure (mmHg)")
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=110)
    return fig


def plot_flow_per_compartment(net, edge_flow, partitions, path=None):
    """Total flow entering each compartment (fluidSimulation.py:4252-4304)."""
    from ..flow.boundary import bfs_partition

    plt = pyplot()
    edge_flow = as_numpy(edge_flow)
    names, flows = [], []
    for name, part in partitions.items():
        res = bfs_partition(net, part["start_nodes"], part["boundary_nodes"])
        inlet_edges = [e for e in range(net.num_edges)
                       if int(net.tails[e]) in part["start_nodes"]]
        total = float(np.sum([edge_flow[e] for e in inlet_edges])) * 1e6
        names.append(name)
        flows.append(total)
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.bar(names, flows)
    ax.set_ylabel("flow (cm^3/s)")
    if path:
        fig.savefig(path, dpi=110)
    return fig


def plot_root_pressure_over_time(timestep_pressures, root_nodes,
                                 labels=None, path=None):
    """Root pressures across longitudinal timesteps
    (fluidSimulation.py:4305-4337)."""
    plt = pyplot()
    p = as_numpy(timestep_pressures)  # [T, N]
    fig, ax = plt.subplots(figsize=(6, 4))
    for i, n in enumerate(root_nodes):
        ax.plot(p[:, n] / PASCAL_PER_MMHG, "o-",
                label=(labels[i] if labels else f"node {n}"))
    ax.set_xlabel("timestep")
    ax.set_ylabel("pressure (mmHg)")
    ax.legend()
    if path:
        fig.savefig(path, dpi=110)
    return fig


def plot_tp_vs_path_length(net, node_pressure, partitions, path=None):
    """Terminating pressure vs path length scatter per compartment
    (fluidSimulation.py:4338-4400 / showTerminatingPressureAndPathLength)."""
    from ..flow.boundary import (path_lengths_from,
                                 terminating_nodes_of_partition)

    plt = pyplot()
    node_pressure = as_numpy(node_pressure)
    fig, ax = plt.subplots(figsize=(6, 4))
    for name, part in partitions.items():
        nodes = terminating_nodes_of_partition(net, part)
        pls = path_lengths_from(net, part["start_nodes"][0])
        pl = [pls[n] * 1000 for n in nodes]
        pr = [node_pressure[n] / PASCAL_PER_MMHG for n in nodes]
        ax.scatter(pl, pr, label=name, s=12)
    ax.set_xlabel("path length (mm)")
    ax.set_ylabel("terminating pressure (mmHg)")
    ax.legend(prop={"size": 6})
    if path:
        fig.savefig(path, dpi=110)
    return fig


def plot_skeleton_overlay(segments, node_values=None, value_name="value",
                          path=None, figsize=(10, 8)):
    """3D centerline rendering with per-voxel value coloring — the
    headless counterpart of the GL pressure/velocity overlays
    (partitionCompartmentGUIDetail.py:549-595).

    segments: voxel chains; node_values: optional {voxel: value} dict."""
    plt = pyplot()
    from mpl_toolkits.mplot3d import Axes3D  # noqa: F401

    fig = plt.figure(figsize=figsize)
    ax = fig.add_subplot(projection="3d")
    if node_values:
        vals = np.asarray(list(node_values.values()), float)
        norm = plt.Normalize(vals.min(), vals.max())
        cmap = plt.get_cmap("jet")
    for seg in segments:
        arr = np.asarray(seg, float)
        if node_values:
            c = [node_values.get(tuple(int(x) for x in v), np.nan)
                 for v in seg]
            c = np.asarray(c, float)
            fill = np.nanmean(c) if np.isfinite(c).any() else 0.0
            c = np.where(np.isfinite(c), c, fill)
            ax.scatter(arr[:, 0], arr[:, 1], arr[:, 2],
                       c=cmap(norm(c)), s=4)
        else:
            ax.plot(arr[:, 0], arr[:, 1], arr[:, 2], "-", lw=1)
    ax.set_title(value_name)
    if path:
        fig.savefig(path, dpi=110, bbox_inches="tight")
    return fig


def show_terminating_pressure_and_path_length(net, node_pressure, path=None,
                                              figsize=(15, 8)):
    """Terminating pressure vs root path length scatter
    (showTerminatingPressureAndPathLength, fluidSimulation.py:844-871).

    Path length is measured along the tree from the entry nodes in meters
    (one BFS over the whole graph instead of an nx.shortest_path per leaf)."""
    from ..flow.boundary import path_lengths_from

    plt = pyplot()
    term = net.terminal_nodes()
    pls = np.nanmin(np.stack([path_lengths_from(net, int(n))
                              for n in net.entry_nodes]), axis=0)
    tp = as_numpy(node_pressure)[term] / PASCAL_PER_MMHG
    pl = pls[term]
    fig, ax = plt.subplots(figsize=figsize)
    ax.plot(pl, tp, "bo")
    ax.set_xlabel("Path length (m)")
    ax.set_ylabel("Terminating pressure (mmHg)")
    if path:
        fig.savefig(path, dpi=110, bbox_inches="tight")
    return fig


def draw_segments(segment_list, shape=None, path=None, figsize=(12, 9)):
    """Headless counterpart of the reference's GL segment viewer
    (drawSegments, skeletonization.py:682-744): renders every centerline
    chain in 3D, reproducing its greedy coloring (adjacent segments sharing
    an endpoint voxel get distinct colors where possible).

    Returns ``(fig, color_codes)`` with one color index per segment so the
    assignment itself is testable without rendering."""
    plt = pyplot()
    from mpl_toolkits.mplot3d import Axes3D  # noqa: F401

    colors = ["r", "g", "b", "c", "m", "y"]
    node_colors = {}  # endpoint voxel -> list of color codes used there
    codes = []
    for seg in segment_list:
        start, end = tuple(seg[0]), tuple(seg[-1])
        used = set(node_colors.get(start, ())) | set(node_colors.get(end, ()))
        available = [c for c in range(len(colors)) if c not in used]
        chosen = available[0] if available else 0
        node_colors.setdefault(start, []).append(chosen)
        node_colors.setdefault(end, []).append(chosen)
        codes.append(chosen)

    fig = plt.figure(figsize=figsize)
    ax = fig.add_subplot(projection="3d")
    for seg, code in zip(segment_list, codes):
        arr = np.asarray(seg, float)
        ax.plot(arr[:, 0], arr[:, 1], arr[:, 2], "-",
                color=colors[code], lw=2)
    if shape is not None:
        ax.set_xlim(0, shape[0]); ax.set_ylim(0, shape[1])
        ax.set_zlim(0, shape[2])
    if path:
        fig.savefig(path, dpi=110, bbox_inches="tight")
    return fig, codes


def pressure_velocity_arrays(segment_list, segment_indices, net,
                             node_pressure, edge_velocity):
    """Per-voxel overlay value arrays (generatePressureVelocityArray,
    partitionCompartmentGUIDetail.py:602-627): for every chosen segment,
    pressures linearly interpolated from its head node to its tail node
    along the voxel chain, and the segment's (constant) velocity magnitude
    — each returned as an (N, 4) array of [x, y, z, value] rows.

    The reference reads head/tail pressures from per-voxel node dicts;
    here they come from the solved network via ``edge_segment_index`` and
    ``node_coord`` (orientation is fixed by matching the chain's first
    voxel to the edge's endpoints)."""
    if net.edge_segment_index is None or net.node_coord is None:
        raise ValueError("network lacks edge_segment_index/node_coord")
    node_pressure = as_numpy(node_pressure).astype(float)
    edge_velocity = as_numpy(edge_velocity).astype(float)
    seg_to_edge = {int(s): e
                   for e, s in enumerate(np.asarray(net.edge_segment_index))}
    node_of_coord = {tuple(int(c) for c in net.node_coord[n]): n
                     for n in range(net.num_nodes)}
    rows_p, rows_v = [], []
    for si in segment_indices:
        e = seg_to_edge.get(int(si))
        if e is None:
            continue
        seg = segment_list[int(si)]
        arr = np.asarray(seg, float)
        hp = node_pressure[int(net.heads[e])]
        tp = node_pressure[int(net.tails[e])]
        first = node_of_coord.get(tuple(int(x) for x in seg[0]))
        if first == int(net.tails[e]):
            hp, tp = tp, hp
        elif first != int(net.heads[e]):
            # the chain's first voxel coincides with neither endpoint's
            # node coordinate (legacy-ingested or trimmed segment
            # lists): orient by which endpoint is nearer instead of
            # silently assuming head-first
            hc = np.asarray(net.node_coord[int(net.heads[e])], float)
            tc = np.asarray(net.node_coord[int(net.tails[e])], float)
            if (np.linalg.norm(arr[0] - tc)
                    < np.linalg.norm(arr[0] - hc)):
                hp, tp = tp, hp
        n = len(seg)
        rows_p.append(np.hstack([arr, np.linspace(hp, tp, n)[:, None]]))
        rows_v.append(np.hstack(
            [arr, np.full((n, 1), abs(float(edge_velocity[e])))]))
    empty = np.zeros((0, 4))
    pressure_array = np.vstack(rows_p) if rows_p else empty
    velocity_array = np.vstack(rows_v) if rows_v else empty
    return pressure_array, velocity_array


def pressure_velocity_volumes(shape, pressure_array, velocity_array,
                              out=None):
    """Scatter [x, y, z, value] overlay rows into dense volumes
    (updateFluidVolume, partitionCompartmentGUIDetail.py:549-601: the
    reference paints per-partition fluid results into two float volumes
    for its GL overlay; headless here, the volumes are the export).

    Rows from several partitions can be accumulated by passing the
    previous call's result as ``out``; later rows overwrite earlier ones
    at shared voxels (junction boundaries), as in the reference."""
    if out is None:
        pressure_volume = np.zeros(shape, dtype=np.float32)
        velocity_volume = np.zeros(shape, dtype=np.float32)
    else:
        pressure_volume, velocity_volume = out
        if pressure_volume.shape != tuple(shape):
            raise ValueError("out volumes do not match shape")
    for arr, vol in ((pressure_array, pressure_volume),
                     (velocity_array, velocity_volume)):
        arr = as_numpy(arr)
        if not len(arr):
            continue
        idx = arr[:, :3].astype(np.int64)
        vol[idx[:, 0], idx[:, 1], idx[:, 2]] = arr[:, 3]
    return pressure_volume, velocity_volume
