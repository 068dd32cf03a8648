# Copy of arterynetwork_tpu/flow/network_setup.py; load_network reads networkx graphs in the pickles into graphs/voxel_graph's classes.
"""Network setup variants: the rest of the reference's FluidNetwork core
(C13) — ``loadNetwork`` legacy ingestion (fluidSimulation.py:161-192),
``convertNetowrk`` (:233-309, via graphs.traversal), ``adjustNetwork``
hand-set Circle-of-Willis dimensions (:311-350), and ``setNetwork``
option 1: per-compartment BraVa radius fit + binned ADAN c/k (:352-399).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from ..graphs.network import FlowNetwork
from .adan import ADANModel
from .boundary import COW_PARTITIONS, bfs_partition

# BraVa per-compartment radius-vs-level fit, radius(mm) = a*exp(-b*level)+c
# (fluidSimulation.py:368, "new names" table)
BRAVA_FIT_PARAMS: Dict[str, Tuple[float, float, float]] = {
    "LMCA": (0.5569, 0.4199, 0.469),
    "RMCA": (0.6636, 0.3115, 0.3666),
    "LPCA": (0.6571, 0.3252, 0.2949),
    "RPCA": (0.7103, 0.5587, 0.3815),
    "ACA": (0.3604, 1.0538, 0.4714),
}

# adjustNetwork's hand-set Circle-of-Willis branch dimensions
# (fluidSimulation.py:311-350): edgeIndex -> dict of mm values.  "The
# correspondence between branch name and edgeIndex" is network-specific;
# these indices match the reference's BraVa-derived CoW graph.
COW_BRANCH_ADJUSTMENTS: Dict[int, Dict[str, float]] = {
    0: {"radius_mm": 3.3, "length_mm": 1.5},   # LICA(Pre)
    3: {"radius_mm": 3.3, "length_mm": 1.5},   # LICA(Post)
    2: {"radius_mm": 3.3, "length_mm": 1.5},   # RICA(Pre)
    7: {"radius_mm": 3.3, "length_mm": 1.5},   # RICA(Post)
    1: {"length_mm": 28.0},                    # VA
    4: {"length_mm": 16.0},                    # RPCAComm
}


def adjust_network(net: FlowNetwork,
                   adjustments: Optional[Dict[int, Dict[str, float]]] = None
                   ) -> FlowNetwork:
    """Hand-set branch dimensions by edge index (``adjustNetwork``,
    fluidSimulation.py:311-350).  Values are given in mm and converted to
    voxels with the network spacing, exactly like the reference."""
    if adjustments is None:
        adjustments = COW_BRANCH_ADJUSTMENTS
    radius = np.asarray(net.radius, float).copy()
    length = np.asarray(net.length, float).copy()
    mm_per_voxel = net.spacing * 1000.0
    for edge_index, vals in adjustments.items():
        if edge_index >= net.num_edges:
            continue
        if "radius_mm" in vals:
            radius[edge_index] = vals["radius_mm"] / mm_per_voxel
        if "length_mm" in vals:
            length[edge_index] = vals["length_mm"] / mm_per_voxel
    return net.replace(radius=radius, length=length)


def edge_partition_names(net: FlowNetwork,
                         partitions: Optional[Dict[str, dict]] = None
                         ) -> np.ndarray:
    """Compartment name per edge (object array; '' where unreached) via
    the reduced-graph BFS of each compartment (fluidSimulation.py:822-842
    compartment sweeps)."""
    if partitions is None:
        partitions = COW_PARTITIONS
    names = np.full(net.num_edges, "", dtype=object)
    for name, part in partitions.items():
        res = bfs_partition(net, part["start_nodes"], part["boundary_nodes"])
        for e in res["visited_edges"]:
            if names[e] == "":
                names[e] = name
    return names


def set_network(net: FlowNetwork,
                option: int = 1,
                adan: Optional[ADANModel] = None,
                partitions: Optional[Dict[str, dict]] = None,
                fit_params: Optional[Dict[str, tuple]] = None,
                length_range_mm: Tuple[float, float] = (1.0, 70.0),
                rng: Optional[np.random.Generator] = None,
                per_compartment: bool = True) -> FlowNetwork:
    """``setNetwork`` (fluidSimulation.py:352-439).

    option=1: set radii from the BraVa exponential fit (per-compartment
    params applied by partition membership when ``per_compartment`` and
    partition roots exist; the reference's committed code applies the
    LMCA params everywhere, which remains the fallback for unpartitioned
    edges), random lengths in ``length_range_mm``, then **binned** ADAN
    c/k: radii inside [min, max) of ``adan.radius_thresholds`` take
    ``ck_candidates[digitize(r)-1]``, outside use the c-radius regression
    clamped at 0.1 (:384-399).

    option=2: only c/k, from the regression with the reference's
    out-of-band special cases (:401-439) — see ``ADANModel.c_of_radius``.
    """
    if adan is None:
        adan = ADANModel()
    if rng is None:
        rng = np.random.default_rng(0)
    if option == 2:
        c = adan.c_of_radius(net.radius_m())
        k = np.full(net.num_edges, adan.k)
        return net.replace(c=c, k=k)
    if option != 1:
        raise ValueError("option must be 1 or 2")

    if fit_params is None:
        fit_params = BRAVA_FIT_PARAMS
    mm_per_voxel = net.spacing * 1000.0
    depth = net.edge_depth

    default = fit_params.get("LMCA", next(iter(fit_params.values())))
    a = np.full(net.num_edges, default[0])
    b = np.full(net.num_edges, default[1])
    cf = np.full(net.num_edges, default[2])
    if per_compartment and partitions is not None:
        names = edge_partition_names(net, partitions)
        for name, (pa, pb, pc) in fit_params.items():
            sel = names == name
            a[sel], b[sel], cf[sel] = pa, pb, pc
    radius = (a * np.exp(-b * depth) + cf) / mm_per_voxel
    lo, hi = length_range_mm
    length = (rng.random(net.num_edges) * (hi - lo) + lo) / mm_per_voxel

    net = net.replace(radius=radius, length=length)
    c = adan.c_of_radius_binned(net.radius_m())
    k = np.full(net.num_edges, adan.k)
    return net.replace(c=c, k=k)


def apply_darcy_weisbach(net: FlowNetwork,
                         nu: Optional[float] = None,
                         rho: Optional[float] = None) -> FlowNetwork:
    """Set the network's per-edge (c, k) to the laminar Darcy-Weisbach law.

    Finishes the reference's ``method='DW'`` equation branch
    (fluidSimulation.py:4692-4693, an empty ``pass``) at the network
    level: with the laminar friction factor its comment prescribes
    (``f = 64/Re``, fluidSimulation.py:4644-4645) the D-W head loss is
    Hagen-Poiseuille, which the equation stack already expresses as the
    k=1 Hazen-Williams law — see ``physics.darcy_weisbach_ck``.  All
    solvers, ground-truth generation, studies and audits work on the
    returned network unchanged.
    """
    from .physics import darcy_weisbach_ck

    kwargs = {}
    if nu is not None:
        kwargs["nu"] = nu
    if rho is not None:
        kwargs["rho"] = rho
    c, k = darcy_weisbach_ck(net.radius_m(), **kwargs)
    # tag the network so set_network_ck (called by every radius-updating
    # study) re-derives DW instead of reverting to the ADAN HW law
    return net.replace(c=np.asarray(c), k=np.asarray(k), physics="dw")


def load_network(directory: str, version: int = 4, year="BraVa") -> dict:
    """Load the reference's legacy artifact bundle (``loadNetwork``,
    fluidSimulation.py:161-192): the basicFilesForStructureWithCoW pickle
    plus partitionInfo / chosenVoxelsForPartition / resultADANDict where
    present.  Returns the loaded dict (reference ``loadedNetwork``).

    The bundle's ``"G"`` is a pickled networkx graph; it is read into
    graphs/voxel_graph's classes, without importing networkx."""
    from ..graphs.voxel_graph import load_legacy_pickle

    suffix = "" if version == 1 else str(version)
    filename = "basicFilesForStructureWithCoW{}(year={}).pkl".format(
        suffix, year)
    result = load_legacy_pickle(os.path.join(directory, filename))
    for key, name in (("partitionInfo", "partitionInfo.pkl"),
                      ("chosenVoxels", "chosenVoxelsForPartition.pkl"),
                      ("resultADANDict", "resultADANDict.pkl")):
        path = os.path.join(directory, name)
        if os.path.exists(path):
            result[key] = load_legacy_pickle(path)
    return result


def convert_network(loaded: dict, root_coord=None,
                    spacing: float = 0.0004):
    """Legacy bundle -> FlowNetwork (``convertNetowrk``,
    fluidSimulation.py:233-309): reduce the voxel graph so nodes are
    terminating/bifurcating points, index nodes by increasing depthLevel
    and edges by increasing depth, carry meanRadius/pathLength.

    ``root_coord`` is the reference's ``heartLoc`` (entry voxel tuple);
    defaults to a depth-0 node of the reduced graph.
    Returns (FlowNetwork, node_of) like graphs.traversal."""
    from ..graphs.traversal import reduce_graph, reduced_to_flow_network

    G = loaded["G"]
    segment_list = loaded["segmentList"]
    seg_info = loaded.get("segmentInfoDict")
    segment_indices = (list(seg_info.keys()) if seg_info
                       else list(range(len(segment_list))))
    DG = reduce_graph(G, segment_list, segment_indices)
    if root_coord is None:
        root_coord = min(DG.nodes(),
                         key=lambda n: DG.nodes[n].get("depthLevel", 0))
    net, node_of = reduced_to_flow_network(DG, tuple(root_coord), spacing)
    adan = loaded.get("resultADANDict")
    if adan:
        net = set_network(net, option=2, adan=ADANModel.from_dict(adan))
    return net, node_of
