# Copy of arterynetwork_tpu/io/artifacts.py; networkx is imported inside save_graphml and load_graphml.
"""Artifact store mirroring the reference's on-disk stage contracts.

The reference's pipeline communicates through files (README.md:111-199):

    vesselVolumeMask.nii.gz
    graphRepresentation.graphml + segmentList.npz + skeleton.nii.gz
    segmentListCleaned.npz, graphRepresentationCleanedWithEdgeInfo.graphml
    eventList.pkl, chosenVoxelsForPartition.pkl, partitionInfo.pkl
    nodeInfoDict.pkl / segmentInfoDict.pkl
    fluidSimulationResult*.pkl

This module writes/reads the same formats (graphml via networkx,
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
        import networkx as nx

        H = nx.relabel_nodes(G, {n: str(n) for n in G.nodes()}, copy=True)
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
        nx.write_graphml(H, self.path(name))

    def load_graphml(self, name):
        from ast import literal_eval

        import networkx as nx

        H = nx.read_graphml(self.path(name))

        def conv(n):
            try:
                return literal_eval(n)
            except (ValueError, SyntaxError):
                return n
        return nx.relabel_nodes(H, conv, copy=True)

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
