# Copy of arterynetwork_tpu/io/artifacts.py; graphml is written and read here (write_graphml, read_graphml), without networkx.
"""Artifact store mirroring the reference's on-disk stage contracts.

The reference's pipeline communicates through files (README.md:111-199):

    vesselVolumeMask.nii.gz
    graphRepresentation.graphml + segmentList.npz + skeleton.nii.gz
    segmentListCleaned.npz, graphRepresentationCleanedWithEdgeInfo.graphml
    eventList.pkl, chosenVoxelsForPartition.pkl, partitionInfo.pkl
    nodeInfoDict.pkl / segmentInfoDict.pkl
    fluidSimulationResult*.pkl

This module writes/reads the same formats (graphml as networkx does,
segmentList as object npz, dicts as pickles, volumes as NIfTI) so a user
of the reference can interchange artifacts, and adds cached-array helpers
(the reference caches distance transforms the same way,
generateVesselVolume.py:177-185, manualCorrectionGUI.py:243-249).
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List

import numpy as np

from ..graphs import voxel_graph as vg
from .nifti import load_volume, save_volume


class ArtifactStore:
    def __init__(self, base_dir: str):
        self.base_dir = str(base_dir)
        os.makedirs(self.base_dir, exist_ok=True)

    def path(self, name: str) -> str:
        return os.path.join(self.base_dir, name)

    def exists(self, name: str) -> bool:
        return os.path.exists(self.path(name))

    # -- volumes -------------------------------------------------------
    def save_nifti(self, name, volume, affine=None, astype=None):
        if affine is None:
            affine = np.eye(4)
        save_volume(volume, affine, self.path(name), astype=astype)

    def load_nifti(self, name):
        return load_volume(self.path(name))

    # -- graphs --------------------------------------------------------
    def save_graphml(self, name, G):
        """Voxel-tuple nodes are stringified like the reference (it reads
        them back with ast.literal_eval, graphRelated.py:419)."""
        H = vg.relabel_nodes(G, {n: str(n) for n in G.nodes()})
        # graphml only accepts scalar attributes
        for _, _, d in H.edges(data=True):
            for k, v in list(d.items()):
                if isinstance(v, (np.floating, np.integer)):
                    d[k] = v.item()
                elif isinstance(v, (list, tuple, np.ndarray)):
                    d[k] = str(list(np.asarray(v).tolist()))
        for _, d in H.nodes(data=True):
            for k, v in list(d.items()):
                if isinstance(v, (np.floating, np.integer)):
                    d[k] = v.item()
                elif isinstance(v, (list, tuple, np.ndarray)):
                    d[k] = str(list(np.asarray(v).tolist()))
        write_graphml(H, self.path(name))

    def load_graphml(self, name):
        from ast import literal_eval

        H = read_graphml(self.path(name))

        def conv(n):
            try:
                return literal_eval(n)
            except (ValueError, SyntaxError):
                return n
        return vg.relabel_nodes(H, conv)

    # -- segment lists --------------------------------------------------
    def save_segment_list(self, name, segments: List[List]):
        arr = np.empty(len(segments), dtype=object)
        for i, seg in enumerate(segments):
            arr[i] = np.asarray(seg, dtype=np.int32)
        np.savez_compressed(self.path(name), segmentList=arr)

    def load_segment_list(self, name) -> List[List[tuple]]:
        data = np.load(self.path(name), allow_pickle=True)
        return [[tuple(int(x) for x in v) for v in seg]
                for seg in data["segmentList"]]

    # -- pickles ---------------------------------------------------------
    def save_pickle(self, name, obj):
        with open(self.path(name), "wb") as f:
            pickle.dump(obj, f, 2)

    def load_pickle(self, name):
        with open(self.path(name), "rb") as f:
            return pickle.load(f)

    # -- cached arrays (EDT caches etc.) ---------------------------------
    def cached_array(self, name, compute):
        """Load ``name`` if present, else compute, save, and return."""
        p = self.path(name)
        if os.path.exists(p):
            data = np.load(p)
            return data[data.files[0]]
        arr = np.asarray(compute())
        np.savez_compressed(p, arr=arr)
        return arr


def load_basic_files(store_or_dir):
    """One-call loader for the morphology analysis bundle
    (``loadBasicFiles`` parity, graphRelated.py:433-515): the cleaned
    voxel graph, segment list, per-segment/per-node info dicts, and the
    partition files, under the reference's file names.

    ``resultADANDict`` is optional (the reference warns and returns {}
    when its ADAN pickle is absent); every other file is required.
    Accepts an ArtifactStore or a directory path.
    """
    store = (store_or_dir if isinstance(store_or_dir, ArtifactStore)
             else ArtifactStore(str(store_or_dir)))
    required = {
        "segmentInfoDict": "segmentInfoDict.pkl",
        "nodeInfoDict": "nodeInfoDict.pkl",
        "chosenVoxels": "chosenVoxelsForPartition.pkl",
        "partitionInfo": "partitionInfo.pkl",
    }
    for key, name in required.items():
        if not store.exists(name):
            raise FileNotFoundError(store.path(name))
    if not store.exists("graphRepresentationCleanedWithAdvancedInfo"
                        ".graphml"):
        raise FileNotFoundError(store.path(
            "graphRepresentationCleanedWithAdvancedInfo.graphml"))
    if not store.exists("segmentListCleaned.npz"):
        raise FileNotFoundError(store.path("segmentListCleaned.npz"))
    result = {key: store.load_pickle(name)
              for key, name in required.items()}
    result["G"] = store.load_graphml(
        "graphRepresentationCleanedWithAdvancedInfo.graphml")
    result["segmentList"] = store.load_segment_list(
        "segmentListCleaned.npz")
    result["resultADANDict"] = (store.load_pickle("resultADANDict.pkl")
                                if store.exists("resultADANDict.pkl")
                                else {})
    return result


# ---------------------------------------------------------------------------
# GraphML, as networkx writes and reads it (write_graphml_xml,
# read_graphml), on graphs/voxel_graph's classes
# ---------------------------------------------------------------------------
_NS = "http://graphml.graphdrawing.org/xmlns"
_XSI = "http://www.w3.org/2001/XMLSchema-instance"
_XML_TYPE = {bool: "boolean", int: "long", float: "double", str: "string"}
_PY_TYPE = {"integer": int, "yfiles": str, "string": str, "int": int,
            "long": int, "float": float, "double": float, "boolean": bool}
_BOOL = {"true": True, "false": False, "0": False, "1": True}


def _indent(elem, level=0):
    i = "\n" + level * "  "
    if len(elem):
        if not elem.text or not elem.text.strip():
            elem.text = i + "  "
        if not elem.tail or not elem.tail.strip():
            elem.tail = i
        for elem in elem:
            _indent(elem, level + 1)
        if not elem.tail or not elem.tail.strip():
            elem.tail = i
    elif level and (not elem.tail or not elem.tail.strip()):
        elem.tail = i


def write_graphml(G, path):
    """Write a Graph or DiGraph as networkx's ``write_graphml_xml`` does:
    one ``<key>`` per
    (attribute name, type, domain) with ``attr.type`` double, long,
    boolean or string, keys before the graph in reverse order of first
    use, nodes in node order, then edges in ``G.edges()`` order."""
    from xml.etree.ElementTree import Element, ElementTree

    root = Element("graphml", {
        "xmlns": _NS, "xmlns:xsi": _XSI,
        "xsi:schemaLocation": f"{_NS} {_NS}/1.0/graphml.xsd"})
    gattrs = {"edgedefault": ("directed" if G.is_directed()
                              else "undirected")}
    if G.graph.get("id") is not None:
        gattrs["id"] = G.graph["id"]
    graph = Element("graph", gattrs)
    # data elements are added after every node and edge exists, in the
    # order of their owners, so keys are numbered in that order
    pending = [(graph, "graph", {k: v for k, v in G.graph.items()
                                 if k not in ("id", "node_default",
                                              "edge_default")})]
    for n, d in G.nodes(data=True):
        el = Element("node", id=str(n))
        graph.append(el)
        pending.append((el, "node", d))
    for u, v, d in G.edges(data=True):
        el = Element("edge", source=str(u), target=str(v))
        graph.append(el)
        pending.append((el, "edge", d))
    keys = {}
    for el, scope, data in pending:
        for k, v in data.items():
            if type(v) not in _XML_TYPE:
                raise TypeError(f"GraphML does not support type {type(v)} "
                                "as data values.")
            kk = (str(k), _XML_TYPE[type(v)], scope)
            if kk not in keys:
                keys[kk] = f"d{len(keys)}"
                root.insert(0, Element("key", {
                    "id": keys[kk], "for": scope, "attr.name": kk[0],
                    "attr.type": kk[1]}))
            data_el = Element("data", key=keys[kk])
            data_el.text = str(v)
            el.append(data_el)
    root.append(graph)
    _indent(root)
    ElementTree(root).write(path, encoding="utf-8", xml_declaration=True)


def read_graphml(path):
    """Read the first graph of a GraphML file (networkx's writers' or
    ``write_graphml``'s) as networkx's ``read_graphml`` does: string node
    ids, typed attributes, nodes in file order; the adjacency is built as
    a multigraph in file order and converted to a ``Graph`` (or
    ``DiGraph``) the way networkx converts one, which fixes each node's
    neighbour order.  Parallel edges are not supported."""
    from xml.etree.ElementTree import ElementTree

    xml = ElementTree(file=path)
    keys, defaults = {}, {"node": {}, "edge": {}}
    for k in xml.findall(f"{{{_NS}}}key"):
        ptype = _PY_TYPE[k.get("attr.type") or "string"]
        keys[k.get("id")] = (k.get("attr.name"), ptype)
        default = k.find(f"{{{_NS}}}default")
        if default is not None and k.get("for") in defaults:
            text = default.text
            defaults[k.get("for")][k.get("attr.name")] = (
                _BOOL[text.lower()] if ptype is bool else ptype(text))

    def decode(el):
        data = {}
        for d in el.findall(f"{{{_NS}}}data"):
            name, ptype = keys[d.get("key")]
            text = d.text
            if text is None:
                data[name] = ""
            else:
                data[name] = (_BOOL[text.lower()] if ptype is bool
                              else ptype(text))
        return data

    g = xml.findall(f"{{{_NS}}}graph")[0]
    directed = g.get("edgedefault") == "directed"
    nodes, adj, edge_ids = {}, {}, {}

    def node(n):
        if n not in nodes:
            nodes[n] = {}
            adj[n] = {}

    for el in g.findall(f"{{{_NS}}}node"):
        n = el.get("id")
        node(n)
        nodes[n].update(decode(el))
    for el in g.findall(f"{{{_NS}}}edge"):
        u, v = el.get("source"), el.get("target")
        if el.get("id"):
            edge_ids[u, v] = el.get("id")
        node(u)
        node(v)
        if v in adj[u]:
            raise ValueError(f"{path}: parallel edges ({u}, {v}); "
                             "multigraph GraphML is not supported")
        adj[u][v] = decode(el)
        if not directed:
            adj[v][u] = adj[u][v]

    G = vg.DiGraph() if directed else vg.Graph()
    G.add_nodes_from(adj)
    seen = set()
    for u, nbrs in adj.items():
        for v, d in nbrs.items():
            if (u, v) not in seen:
                G.add_edges_from([(u, v, d)])
                if not directed:
                    seen.add((v, u))
    G.graph.update({"node_default": defaults["node"],
                    "edge_default": defaults["edge"]}, **decode(g))
    G._node.update((n, d.copy()) for n, d in nodes.items())
    for (u, v), eid in edge_ids.items():
        if G.has_edge(u, v):
            G[u][v]["id"] = eid
    return G


def read_tabb_segment_file(path) -> List[List[tuple]]:
    """Parse one of the external skeletonizer's ``result_segments_xyz*.txt``
    files (readSegmentFile, skeletonization.py:188-229) into a segment
    list.  Format: first line = number of segments; then, per segment,
    one line with the voxel count followed by that many space-separated
    coordinate lines.  Coordinates are stored reversed (the reference
    flips xyz -> zyx on read); kept here so legacy artifacts load into
    this framework's segment lists unchanged."""
    segments: List[List[tuple]] = []
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    pos = 1  # skip the declared segment count; trust the per-segment lengths
    while pos < len(lines):
        n = int(lines[pos])
        pos += 1
        seg = [tuple(int(x) for x in lines[pos + i].split())[::-1]
               for i in range(n)]
        pos += n
        segments.append(seg)
    return segments


def combine_skeleton_segments(folder) -> List[List[tuple]]:
    """Concatenate every ``result_segments_xyz*.txt`` in a folder
    (combineSkeletonSegments, skeletonization.py:165-186) — the migration
    path for skeletons produced by the reference's external Docker
    skeletonizer."""
    import glob

    segments: List[List[tuple]] = []
    for path in sorted(glob.glob(os.path.join(
            str(folder), "result_segments_xyz*.txt"))):
        segments.extend(read_tabb_segment_file(path))
    return segments
