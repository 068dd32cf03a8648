# Copy of arterynetwork_tpu/graphs/editing.py; the graphs are graphs/voxel_graph's classes.
"""Event-sourced manual-correction engine (headless core of C8).

The reference's ``manualCorrectionGUI(Detail).py`` couples a Qt/OpenGL
viewer to an *event-sourced* editing model: every edit is an event dict,
the event list is persisted (``eventList.pkl``), edits replay on startup,
and undo applies exact inverse operations
(processEvent/reverseEvent, manualCorrectionGUIDetail.py:687-1368;
restore-on-load manualCorrectionGUI.py:150-197).

This module is that model without the GUI.  Operations:

* ``remove``    — delete a segment; neighbor segments whose shared
  endpoint drops to degree 2 are auto-merged so every segment stays a
  simple branch (mergeSegments, manualCorrectionGUIDetail.py:266-374);
* ``reconnect`` — bridge two voxels with a spline re-discretized to a
  26-connected voxel chain (reference :739-1158, including the retry
  weight pool [20, len, 2*len]);
* ``grow``      — extend a terminal segment by an explicit voxel chain;
* ``cut``       — split a segment at an interior voxel (unfinished in the
  reference; completed here).

Every event stores the exact segment snapshots it removed/added, so
``undo`` and ``replay`` are exact inverses/reapplications.
``check_cycles`` is the reference's loop detector (checkCycle, :642-684).
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..morpho.spline import spline_interpolation
from . import voxel_graph as vg
from .segments import extract_segments, segments_to_graph, validate_segment

Voxel = Tuple[int, int, int]


def _line_voxels(a: Voxel, b: Voxel) -> List[Voxel]:
    """26-connected straight walk from a to b (inclusive)."""
    a = np.asarray(a, int)
    b = np.asarray(b, int)
    out = [tuple(a)]
    cur = a.copy()
    while not np.array_equal(cur, b):
        step = np.sign(b - cur)
        cur = cur + step
        out.append(tuple(int(x) for x in cur))
    return out


def _voxelize_chain(points: np.ndarray) -> List[Voxel]:
    """Round a dense polyline to a 26-connected voxel chain without
    duplicates."""
    vox: List[Voxel] = []
    for p in np.round(points).astype(int):
        t = tuple(int(x) for x in p)
        if not vox:
            vox.append(t)
            continue
        if t == vox[-1]:
            continue
        if np.max(np.abs(np.asarray(t) - np.asarray(vox[-1]))) > 1:
            vox.extend(_line_voxels(vox[-1], t)[1:])
        else:
            vox.append(t)
    # drop immediate backtracks
    cleaned: List[Voxel] = []
    for v in vox:
        if len(cleaned) >= 2 and v == cleaned[-2]:
            cleaned.pop()
        elif not cleaned or v != cleaned[-1]:
            cleaned.append(v)
    return cleaned


class CorrectionSession:
    """Edit a segment list with undo/replay semantics."""

    def __init__(self, segments: Sequence[Sequence[Voxel]]):
        self.segments: Dict[int, List[Voxel]] = {
            i: [tuple(int(x) for x in v) for v in seg]
            for i, seg in enumerate(segments)}
        self._next_index = len(self.segments)
        self.events: List[dict] = []

    # -- derived state ---------------------------------------------------
    def graph(self) -> vg.Graph:
        return segments_to_graph(list(self.segments.values()))

    def segment_list(self) -> List[List[Voxel]]:
        return [list(s) for s in self.segments.values()]

    def check_cycles(self) -> List[list]:
        """Loop detection (checkCycle, manualCorrectionGUIDetail.py:642)."""
        return vg.cycle_basis(self.graph())

    def report_cycle_info(self) -> int:
        """Count (and print) the remaining cycles (reportCycleInfo,
        manualCorrectionGUIDetail.py:246-253)."""
        n = len(self.check_cycles())
        print(f"{n} cycles remaining (reportCycleInfo)")
        return n

    # -- event machinery ---------------------------------------------------
    def _apply(self, event: dict):
        for idx in event["removed"]:
            del self.segments[idx]
        for idx, seg in event["added"].items():
            self.segments[idx] = list(map(tuple, seg))

    def _record(self, etype: str, removed: Dict[int, list],
                added: Dict[int, list], **extra) -> dict:
        event = {"type": etype,
                 "removed": {i: copy.deepcopy(self.segments[i])
                             for i in removed},
                 "added": added, **extra}
        self._apply(event)
        self.events.append(event)
        return event

    def undo(self) -> Optional[dict]:
        """Exact inverse of the last event (reverseEvent parity)."""
        if not self.events:
            return None
        event = self.events.pop()
        for idx in event["added"]:
            del self.segments[idx]
        for idx, seg in event["removed"].items():
            self.segments[idx] = list(map(tuple, seg))
        return event

    def replay(self, events: Sequence[dict]):
        """Re-apply a persisted event list (restore-on-load,
        manualCorrectionGUI.py:153-197)."""
        for event in events:
            self._apply({"removed": dict.fromkeys(event["removed"]),
                         "added": event["added"]})
            self.events.append(copy.deepcopy(event))
            # advance the allocator past every replayed index, or the
            # next post-replay edit would reuse an 'added' index and
            # silently clobber the replayed segment
            used = [int(i) for i in event["added"]]
            used += [int(i) for i in event["removed"]]
            if used:
                self._next_index = max(self._next_index, max(used) + 1)

    # -- operations --------------------------------------------------------
    def remove_segment(self, segment_index: int, auto_merge: bool = True):
        """Remove a segment; merge neighbors left with degree-2 joints."""
        if segment_index not in self.segments:
            raise KeyError(segment_index)
        target = self.segments[segment_index]
        removed = {segment_index: None}
        added: Dict[int, list] = {}

        if auto_merge:
            # after removal, each endpoint with exactly two remaining
            # incident segments gets them merged into one simple branch
            others = {i: s for i, s in self.segments.items()
                      if i != segment_index}
            G_after = segments_to_graph(list(others.values()))
            for endpoint in (target[0], target[-1]):
                if endpoint not in G_after:
                    continue
                if G_after.degree(endpoint) != 2:
                    continue
                incident = [i for i, s in others.items()
                            if s[0] == endpoint or s[-1] == endpoint]
                if len(incident) != 2:
                    continue
                ia, ib = incident
                a, b = others[ia], others[ib]
                a = a if a[-1] == endpoint else a[::-1]
                b = b if b[0] == endpoint else b[::-1]
                merged = list(a) + list(b)[1:]
                for idx in (ia, ib):
                    # a cascaded merge can consume a segment this same
                    # event just created; that intermediate never existed
                    # before the event, so drop it from `added` instead
                    # of recording it as removed
                    if idx in added:
                        del added[idx]
                    else:
                        removed[idx] = None
                added[self._next_index] = merged
                self._next_index += 1
                others = {i: s for i, s in others.items()
                          if i not in (ia, ib)}
                others[self._next_index - 1] = merged

        return self._record("remove", removed, added,
                            segmentIndex=segment_index)

    def reconnect(self, point_a: Voxel, point_b: Voxel,
                  context_a: Optional[Sequence[Voxel]] = None,
                  context_b: Optional[Sequence[Voxel]] = None,
                  samples_per_voxel: float = 4.0):
        """Bridge point_a -> point_b with a spline-shaped voxel chain.

        ``context_*``: optional extra voxels shaping the tangent at each
        end (the reference uses 4 picked points, :739-821).  Falls back
        through the reference's retry weight pool when the spline fit
        degenerates."""
        ctx_a = [tuple(v) for v in (context_a or [])]
        ctx_b = [tuple(v) for v in (context_b or [])]
        control = ctx_a + [tuple(point_a), tuple(point_b)] + ctx_b
        control_arr = np.asarray(control, float)

        n_control = len(control)
        chain = None
        if n_control >= 3:
            dist = float(np.linalg.norm(
                np.asarray(point_b, float) - np.asarray(point_a, float)))
            n_samples = max(int(dist * samples_per_voxel), 8)
            for w_end in (20.0, float(n_control), 2.0 * n_control):
                w = np.ones(n_control)
                w[[0, -1]] = w_end
                try:
                    _, _, pts = spline_interpolation(
                        control_arr, np.linspace(0, 1, n_samples),
                        smoothing=None, w=w)
                except Exception:
                    continue
                cand = _voxelize_chain(pts)
                # keep only the bridge portion between the two anchors
                if tuple(point_a) in cand and tuple(point_b) in cand:
                    i0 = cand.index(tuple(point_a))
                    i1 = cand.index(tuple(point_b))
                    if i0 > i1:
                        i0, i1 = i1, i0
                        cand = cand[::-1]
                        i0 = cand.index(tuple(point_a))
                        i1 = cand.index(tuple(point_b))
                    chain = cand[i0:i1 + 1]
                    if len(chain) >= 2:
                        break
                    chain = None
        if chain is None:
            chain = _line_voxels(tuple(point_a), tuple(point_b))

        added = {self._next_index: chain}
        self._next_index += 1
        return self._record("reconnect", {}, added,
                            pointA=tuple(point_a), pointB=tuple(point_b))

    def grow(self, segment_index: int, extension: Sequence[Voxel]):
        """Extend a terminal segment by an explicit voxel chain."""
        seg = self.segments[segment_index]
        ext = [tuple(int(x) for x in v) for v in extension]
        if ext[0] == seg[-1]:
            new = list(seg) + ext[1:]
        elif ext[0] == seg[0]:
            new = ext[::-1] + list(seg)[1:]
        else:
            raise ValueError("extension must start at a segment endpoint")
        added = {self._next_index: new}
        self._next_index += 1
        return self._record("grow", {segment_index: None}, added)

    def cut(self, segment_index: int, voxel: Voxel):
        """Split a segment at an interior voxel into two segments."""
        seg = self.segments[segment_index]
        voxel = tuple(int(x) for x in voxel)
        if voxel not in seg[1:-1]:
            raise ValueError("cut voxel must be interior to the segment")
        k = seg.index(voxel)
        added = {self._next_index: seg[:k + 1],
                 self._next_index + 1: seg[k:]}
        self._next_index += 2
        return self._record("cut", {segment_index: None}, added,
                            voxel=voxel)

    # -- persistence ---------------------------------------------------------
    def save(self, store, prune_min_length: int = 2):
        """Persist the session with the reference's save semantics:
        drop <=2-voxel terminating branches, write eventList.pkl,
        segmentListCleaned.npz and the cleaned graphml
        (manualCorrectionGUIDetail.py:1571-1625)."""
        from .segments import prune_spurs

        cleaned = prune_spurs(self.segment_list(),
                              min_length=prune_min_length)
        store.save_pickle("eventList.pkl", self.events)
        store.save_segment_list("segmentListCleaned.npz", cleaned)
        store.save_graphml("graphRepresentationCleaned.graphml",
                           segments_to_graph(cleaned))
        return cleaned


def audit_junction_bridges(session: CorrectionSession,
                           distance_transform=None,
                           max_len: int = 13, cover_tol: float = 4.0,
                           cover_radius_factor: float = 1.0) -> List[dict]:
    """Apply the junction-bridge audit THROUGH the editing engine.

    Finds the same artifacts as ``graphs.segments.prune_junction_bridges``
    (short junction-junction segments on a cycle whose geometry the
    surviving segments already cover — same-branch thinning loops and
    kissing-vessel necks) but removes them as ordinary ``remove`` events
    on the session, so each cut is undoable, persists in
    ``eventList.pkl`` and replays on load — the reference's manual
    remove+merge workflow (manualCorrectionGUIDetail.py:266-374), driven
    automatically.  Returns the list of events it recorded.

    ``distance_transform`` (full-frame EDT) orders candidates
    weakest-mean-radius first and enables the radius-scaled coverage
    tolerance; without it candidates are tried longest-first with the
    flat tolerance (the same ordering as
    ``segments.prune_junction_bridges``).
    """
    from scipy.spatial import cKDTree

    events: List[dict] = []
    dt = None if distance_transform is None \
        else np.asarray(distance_transform)

    def mean_radius(seg):
        if dt is None:
            return 0.0
        idx = np.asarray(seg, np.int64)
        return float(np.mean(dt[idx[:, 0], idx[:, 1], idx[:, 2]]))

    # connectivity runs on the endpoint-level multigraph (one edge per
    # segment, like segments.prune_junction_bridges) and is updated
    # incrementally through removals/merges; one KD-tree per pass, with
    # voxels of bridges dropped THIS pass excluded from coverage.
    changed = True
    while changed:
        changed = False
        items = list(session.segments.items())
        G = vg.MultiGraph()
        for j, s in items:
            G.add_edge(s[0], s[-1], key=j)
        cand = [(i, seg) for i, seg in items
                if seg[0] != seg[-1] and len(seg) <= max_len
                and G.degree(seg[0]) >= 3 and G.degree(seg[-1]) >= 3]
        cand.sort(key=lambda t: (mean_radius(t[1]), -len(t[1]), t[0]))
        all_pts = np.asarray([v for _, seg in items for v in seg],
                             np.float64)
        tree = cKDTree(all_pts) if len(all_pts) else None
        dropped_pts: set = set()
        for i, seg in cand:
            if i not in session.segments or not G.has_edge(
                    seg[0], seg[-1], key=i):
                continue
            u, v = seg[0], seg[-1]
            G.remove_edge(u, v, key=i)
            if u not in G or v not in G or not vg.has_path(G, u, v):
                G.add_edge(u, v, key=i)
                continue
            if tree is not None and len(seg) > 2:
                tol = max(cover_tol,
                          cover_radius_factor * mean_radius(seg))
                own_pts = set(map(tuple, seg)) | dropped_pts
                covered = True
                for w in seg[1:-1]:
                    hits = tree.query_ball_point(np.asarray(w, float),
                                                 r=tol)
                    if not any(tuple(all_pts[h].astype(int))
                               not in own_pts for h in hits):
                        covered = False
                        break
                if not covered:
                    G.add_edge(u, v, key=i)
                    continue
            ev = session.remove_segment(i)
            events.append(ev)
            changed = True
            # the bridge's interior voxels no longer exist in the
            # session and must not cover later candidates (endpoints
            # survive as junctions of the neighboring segments)
            dropped_pts.update(map(tuple, seg[1:-1]))
            # mirror the event's auto-merges onto the endpoint graph
            for j, s_j in ev["removed"].items():
                if j == i:
                    continue
                s0, s1 = tuple(s_j[0]), tuple(s_j[-1])
                if G.has_edge(s0, s1, key=j):
                    G.remove_edge(s0, s1, key=j)
            for m, s_m in ev["added"].items():
                G.add_edge(tuple(s_m[0]), tuple(s_m[-1]), key=m)
    return events
