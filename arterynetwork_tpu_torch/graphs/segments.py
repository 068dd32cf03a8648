# Copy of arterynetwork_tpu/graphs/segments.py; networkx is imported inside the two nx-building functions.
"""Centerline segments and the voxel-level vessel graph.

Host-side counterpart of the reference's segment post-processing
(skeletonization.py:233-537): turn a skeleton voxel mask (or a rough
segment list) into *simple branches* — centerpoint chains whose interior
voxels have degree 2 and whose ends are junctions (degree >= 3) or tips
(degree 1).

The reference repairs Tabb's rough segment output in place (pairwise
dedupe, split at interior bifurcations, iterative merge of degree-2
endpoints, skeletonization.py:299-518).  All of those operations are
equivalent to *re-extracting* simple branches from the union voxel graph,
which is what we do: build the 26-adjacency graph, walk chains between
degree!=2 voxels (the reference's own ``getSegmentList`` DFS,
skeletonization.py:539-601, does the same).  Pure cycles (all degree 2)
become single closed chains.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

Voxel = Tuple[int, int, int]

_NEIGHBOR_OFFSETS = [(dz, dy, dx)
                     for dz in (-1, 0, 1)
                     for dy in (-1, 0, 1)
                     for dx in (-1, 0, 1)
                     if (dz, dy, dx) != (0, 0, 0)]

# one representative per neighbor pair: lexicographically positive offsets
_HALF_OFFSETS = [o for o in _NEIGHBOR_OFFSETS if o > (0, 0, 0)]


# ---------------------------------------------------------------------------
# Vectorized core: voxel chains from edge arrays (no per-voxel dict ops).
#
# At a realistic MRA scale the skeleton has ~5e4 voxels; building a
# networkx graph (26 hash probes per voxel) and walking it with dict
# operations is seconds-to-minutes of pure Python.  Instead edges are
# extracted with sorted-key lookups (numpy), degrees with bincount, and
# chains walked over CSR adjacency converted to flat Python lists
# (~50 ns/step instead of ~10 us/step for nx).
# ---------------------------------------------------------------------------


def _voxel_keys(coords: np.ndarray, shape) -> np.ndarray:
    c = np.asarray(coords, dtype=np.int64)
    return (c[:, 0] * shape[1] + c[:, 1]) * shape[2] + c[:, 2]


def _keys_to_coords(keys: np.ndarray, shape) -> np.ndarray:
    keys = np.asarray(keys, dtype=np.int64)
    x = keys % shape[2]
    zy = keys // shape[2]
    y = zy % shape[1]
    z = zy // shape[1]
    return np.stack([z, y, x], axis=1)


def _sparse_argwhere(vol: np.ndarray) -> np.ndarray:
    """``np.argwhere`` for very sparse boolean volumes.

    Native word-skipping scan when the C library is available (all-zero
    8-byte words skipped — memory-read speed), else packed-byte scan
    (8 voxels at a time, unpack only nonzero bytes; ~4x faster than
    argwhere at skeleton densities <0.1%)."""
    if vol.dtype in (np.dtype(bool), np.dtype(np.uint8)):
        try:
            from ..ops.native import nonzero_flat_native
            idx = nonzero_flat_native(vol)
            nz, ny, nx = vol.shape
            z, rem = np.divmod(idx, ny * nx)
            y, x = np.divmod(rem, nx)
            return np.stack([z, y, x], axis=1).astype(np.int64)
        except Exception:
            pass  # no toolchain: packed-byte fallback below
    # np.packbits accepts bool input directly: no full-volume uint8
    # copy (a fresh 0.5 GB first-touch at Speck scale on this VM)
    flat = vol.reshape(-1)
    if not flat.flags["C_CONTIGUOUS"]:
        flat = np.ascontiguousarray(flat)
    packed = np.packbits(flat)
    nb = np.flatnonzero(packed)
    if nb.size == 0:
        return np.zeros((0, 3), np.int64)
    bits = np.unpackbits(packed[nb])
    offs = np.flatnonzero(bits)
    idx = nb[offs >> 3] * 8 + (offs & 7)   # packbits is MSB-first
    nz, ny, nx = vol.shape
    z, rem = np.divmod(idx, ny * nx)
    y, x = np.divmod(rem, nx)
    return np.stack([z, y, x], axis=1).astype(np.int64)


def _edges_from_skeleton(skeleton) -> Tuple[np.ndarray, np.ndarray, Tuple]:
    """All 26-adjacency edges of a skeleton mask as (a_keys, b_keys).

    One representative per undirected pair.  Sparse: one argwhere pass
    over the volume, then 13 sorted-key membership checks over the voxel
    list (no full-volume shift-AND per offset)."""
    skel = np.asarray(skeleton)
    if skel.dtype not in (np.dtype(bool), np.dtype(np.uint8)):
        skel = skel != 0  # np.packbits reads by truthiness: bool and
        # uint8 volumes go straight through without a full-frame copy
    shape = skel.shape
    coords = _sparse_argwhere(skel)
    keys = _voxel_keys(coords, shape)
    order = np.argsort(keys)
    skeys = keys[order]
    a_out, b_out = [], []
    for off in _HALF_OFFSETS:
        nc = coords + np.asarray(off, coords.dtype)
        valid = ((nc >= 0).all(axis=1)
                 & (nc[:, 0] < shape[0]) & (nc[:, 1] < shape[1])
                 & (nc[:, 2] < shape[2]))
        nk = _voxel_keys(nc[valid], shape)
        pos = np.searchsorted(skeys, nk)
        pos = np.minimum(pos, len(skeys) - 1) if len(skeys) else pos
        hit = (skeys[pos] == nk) if len(skeys) else np.zeros(0, bool)
        a_out.append(keys[valid][hit])
        b_out.append(nk[hit])
    if not a_out or sum(a.size for a in a_out) == 0:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64), shape)
    return np.concatenate(a_out), np.concatenate(b_out), shape


def _edges_from_segments(segment_list, dedupe: bool = True):
    """Consecutive-pair edges of voxel chains as canonical key pairs."""
    shapes_max = np.zeros(3, np.int64)
    pairs_a, pairs_b = [], []
    for seg in segment_list:
        c = np.asarray(seg, dtype=np.int64)
        if c.ndim != 2 or len(c) < 2:
            continue
        shapes_max = np.maximum(shapes_max, c.max(axis=0))
        pairs_a.append(c[:-1])
        pairs_b.append(c[1:])
    if not pairs_a:
        return np.zeros(0, np.int64), np.zeros(0, np.int64), (1, 1, 1)
    shape = tuple(int(s) + 2 for s in shapes_max)
    a = _voxel_keys(np.concatenate(pairs_a), shape)
    b = _voxel_keys(np.concatenate(pairs_b), shape)
    if dedupe:
        lo, hi = np.minimum(a, b), np.maximum(a, b)
        uniq = np.unique(np.stack([lo, hi], axis=1), axis=0)
        a, b = uniq[:, 0], uniq[:, 1]
    return a, b, shape


def _chains_from_edges(a_keys: np.ndarray, b_keys: np.ndarray):
    """Partition an undirected voxel graph (as edge key arrays) into
    simple chains.  Returns (chains, uniq_keys): chains are int arrays of
    indices into uniq_keys; chains break at vertices with degree != 2;
    pure cycles come back closed (first == last)."""
    E = len(a_keys)
    if E == 0:
        return [], np.zeros(0, np.int64)
    uniq = np.unique(np.concatenate([a_keys, b_keys]))
    a = np.searchsorted(uniq, a_keys)
    b = np.searchsorted(uniq, b_keys)
    return _chains_from_edge_indices(a, b, len(uniq)), uniq


def _chains_from_edge_indices(a: np.ndarray, b: np.ndarray, n: int):
    """Chain partition over pre-indexed edges (vertex ids in [0, n);
    absent vertices simply have degree 0)."""
    E = len(a)
    if E == 0:
        return []
    deg = (np.bincount(a, minlength=n)
           + np.bincount(b, minlength=n)).astype(np.int64)

    src = np.concatenate([a, b])
    dst = np.concatenate([b, a])
    eid = np.concatenate([np.arange(E), np.arange(E)])
    order = np.argsort(src, kind="stable")
    dst_s = dst[order]
    eid_s = eid[order]
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(src, minlength=n), out=indptr[1:])

    # flat Python lists: ~100x faster element access than numpy scalars
    indptr_l = indptr.tolist()
    dst_l = dst_s.tolist()
    eid_l = eid_s.tolist()
    deg_l = deg.tolist()
    visited = bytearray(E)
    chains = []

    def walk(prev, cur, chain):
        while deg_l[cur] == 2:
            q = indptr_l[cur]
            if dst_l[q] == prev:
                q += 1
            if visited[eid_l[q]]:
                break
            visited[eid_l[q]] = 1
            nxt = dst_l[q]
            chain.append(nxt)
            prev, cur = cur, nxt
        return chain

    for s in np.nonzero(deg != 2)[0].tolist():
        for p in range(indptr_l[s], indptr_l[s + 1]):
            if visited[eid_l[p]]:
                continue
            visited[eid_l[p]] = 1
            first = dst_l[p]
            chains.append(walk(s, first, [s, first]))

    # pure cycles: remaining unvisited edges form degree-2 loops
    a_l = a.tolist()
    b_l = b.tolist()
    for e0 in range(E):
        if visited[e0]:
            continue
        visited[e0] = 1
        chains.append(walk(a_l[e0], b_l[e0], [a_l[e0], b_l[e0]]))

    return chains


def _chains_to_tuple_segments(chains, uniq_keys, shape, origin=(0, 0, 0)):
    coords = _keys_to_coords(uniq_keys, shape)
    if any(origin):
        coords = coords + np.asarray(origin, coords.dtype)
    coord_tuples = [tuple(c) for c in coords.tolist()]
    return [[coord_tuples[i] for i in chain] for chain in chains]


def extract_segments_fast(skeleton) -> List[List[Voxel]]:
    """Vectorized equivalent of ``extract_segments(skeleton_to_voxel_graph(s))``."""
    a, b, shape = _edges_from_skeleton(skeleton)
    chains, uniq = _chains_from_edges(a, b)
    return _chains_to_tuple_segments(chains, uniq, shape)


def skeleton_to_voxel_graph(skeleton) -> nx.Graph:
    """26-adjacency graph over skeleton voxels (nodes are voxel tuples)."""
    import networkx as nx

    skeleton = np.asarray(skeleton)
    coords = {tuple(int(v) for v in c) for c in np.argwhere(skeleton)}
    G = nx.Graph()
    G.add_nodes_from(coords)
    for (z, y, x) in coords:
        for (dz, dy, dx) in _NEIGHBOR_OFFSETS:
            q = (z + dz, y + dy, x + dx)
            if q in coords:
                G.add_edge((z, y, x), q)
    return G


def extract_segments(G: nx.Graph) -> List[List[Voxel]]:
    """Partition a voxel graph into simple branches.

    Every edge belongs to exactly one chain; chains break at voxels with
    degree != 2.  Same partition semantics as the reference's
    ``getSegmentList`` (skeletonization.py:539-601).
    """
    segments: List[List[Voxel]] = []
    visited = set()  # undirected edge keys

    def edge_key(a, b):
        return (a, b) if a <= b else (b, a)

    breakpoints = [n for n in G.nodes() if G.degree(n) != 2]
    for start in breakpoints:
        for nbr in G.neighbors(start):
            if edge_key(start, nbr) in visited:
                continue
            chain = [start, nbr]
            visited.add(edge_key(start, nbr))
            cur, prev = nbr, start
            while G.degree(cur) == 2:
                nxts = [n for n in G.neighbors(cur) if n != prev]
                if not nxts:
                    break
                nxt = nxts[0]
                if edge_key(cur, nxt) in visited:
                    break
                visited.add(edge_key(cur, nxt))
                chain.append(nxt)
                prev, cur = cur, nxt
            segments.append(chain)

    # pure cycles: remaining unvisited edges form degree-2 loops
    for a, b in G.edges():
        if edge_key(a, b) in visited:
            continue
        chain = [a, b]
        visited.add(edge_key(a, b))
        cur, prev = b, a
        while True:
            nxts = [n for n in G.neighbors(cur)
                    if edge_key(cur, n) not in visited]
            if not nxts:
                break
            nxt = nxts[0]
            visited.add(edge_key(cur, nxt))
            chain.append(nxt)
            prev, cur = cur, nxt
        segments.append(chain)

    return segments


def segments_to_graph(segments: Sequence[Sequence[Voxel]]) -> nx.Graph:
    """Voxel graph with per-edge ``segmentIndex`` (skeletonization.py:765-769)."""
    import networkx as nx

    G = nx.Graph()
    for idx, seg in enumerate(segments):
        segt = [tuple(v) for v in seg]
        G.add_edges_from(zip(segt[:-1], segt[1:]), segmentIndex=idx)
    return G


def validate_segment(G: nx.Graph, segment: Sequence[Voxel]) -> bool:
    """True iff the segment is a simple branch (skeletonization.py:649-680)."""
    degrees = [G.degree(v) for v in segment]
    if len(degrees) < 2:
        return False
    if degrees[0] == 2 or degrees[-1] == 2:
        return False
    return all(d == 2 for d in degrees[1:-1])


def process_segments(segment_list: Sequence[Sequence[Voxel]]):
    """Re-partition rough segments into simple branches.

    Contract parity with the reference's ``processSegments``
    (skeletonization.py:233-537): duplicates removed, interior
    bifurcations split, degree-2 endpoints merged.  Implemented by
    rebuilding the union voxel graph and re-extracting chains, which
    yields the same simple-branch partition without the iterative repair.

    Returns (G, segments, error_segments); error_segments is always empty
    here because re-extraction cannot produce invalid branches.
    """
    a, b, shape = _edges_from_segments(segment_list)
    chains, uniq = _chains_from_edges(a, b)
    segments = _chains_to_tuple_segments(chains, uniq, shape)
    G = segments_to_graph(segments)
    error_segments: List[List[Voxel]] = []
    return G, segments, error_segments


def prune_spurs(segments: Sequence[Sequence[Voxel]],
                min_length: int = 3,
                iterations: int = 2) -> List[List[Voxel]]:
    """Drop short terminal branches and re-extract.

    Generalization of the reference's removal of 2-voxel terminating
    branches before saving (manualCorrectionGUIDetail.py:1571-1625) —
    also cleans the radius-length end spurs left by curve-preserving
    thinning.  A terminal branch is dropped when it has <= min_length
    voxels; junction voxels shared with other branches are kept.
    """
    segs = [[tuple(int(x) for x in v) for v in s] for s in segments]
    for _ in range(iterations):
        if not segs:
            break
        # endpoint degree = number of incident chain ends (the chains
        # partition the edges, so a breakpoint's voxel-graph degree equals
        # its end count; a closed cycle contributes 2 at its seam)
        ends = [v for s in segs for v in (s[0], s[-1])]
        end_count: Dict[Voxel, int] = {}
        for v in ends:
            end_count[v] = end_count.get(v, 0) + 1
        keep = []
        changed = False
        for seg in segs:
            is_terminal = (end_count[seg[0]] == 1
                           or end_count[seg[-1]] == 1)
            if is_terminal and len(seg) <= min_length:
                changed = True
                continue
            keep.append(seg)
        if not changed:
            break
        a, b, shape = _edges_from_segments(keep)
        chains, uniq = _chains_from_edges(a, b)
        segs = _chains_to_tuple_segments(chains, uniq, shape)
    return segs


def _prune_chains(chains, n: int, min_length: int = 3,
                  iterations: int = 2):
    """``prune_spurs`` on index chains (no tuple materialization between
    rounds): drop terminal chains with <= min_length voxels, then
    re-partition so junctions that dropped to degree 2 merge their two
    surviving chains."""
    for _ in range(iterations):
        if not chains:
            break
        ends = np.fromiter((c[0] for c in chains), np.int64,
                           len(chains))
        ends = np.concatenate(
            [ends, np.fromiter((c[-1] for c in chains), np.int64,
                               len(chains))])
        end_count = np.bincount(ends, minlength=n)
        keep = [c for c in chains
                if not ((end_count[c[0]] == 1 or end_count[c[-1]] == 1)
                        and len(c) <= min_length)]
        if len(keep) == len(chains):
            break
        if not keep:
            return []
        a = np.concatenate([np.asarray(c[:-1], np.int64) for c in keep])
        b = np.concatenate([np.asarray(c[1:], np.int64) for c in keep])
        lo, hi = np.minimum(a, b), np.maximum(a, b)
        uniq_e = np.unique(lo * np.int64(n) + hi)
        a, b = uniq_e // n, uniq_e % n
        chains = _chains_from_edge_indices(a, b, n)
    return chains


# ---------------------------------------------------------------------------
# Skeleton-graph simplification.
#
# A 26-connected thinning skeleton is not a clean curve network: junction
# voxels come in adjacent clusters (every pair of adjacent degree>=3
# voxels is its own 2-voxel "segment"), triangles of mutually-adjacent
# voxels create tiny cycles, and thick vessels leave short parallel arcs
# that re-merge (intra-vessel meshes).  The reference leaves all of this
# to the manual-correction GUI (cycle display + human edits,
# manualCorrectionGUIDetail.py:642-684); the automated pipeline cleans it
# structurally with the three passes below, which on the 512 phantom
# bench take the segment count from ~2100 to ~550 for 400 true branches
# without losing centerline recall.
# ---------------------------------------------------------------------------


def _rebuild_chains(chains, n):
    """Re-partition chain edges into simple chains (dedupes edges,
    merges degree-2 pass-throughs created by a previous pass)."""
    if not chains:
        return []
    a = np.concatenate([np.asarray(c[:-1], np.int64) for c in chains])
    b = np.concatenate([np.asarray(c[1:], np.int64) for c in chains])
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    uniq_e = np.unique(lo * np.int64(n) + hi)
    return _chains_from_edge_indices(uniq_e // n, uniq_e % n, n)


def collapse_junction_clusters(a, b, n, radius):
    """Contract 26-adjacent clusters of junction (degree>=3) vertices to
    their max-radius member (the most interior voxel).

    Input/output are edge index arrays over ``n`` vertices.  Self-edges
    and duplicate edges created by the contraction are dropped, so
    triangles *inside* a cluster vanish and each rasterized bifurcation
    becomes a single graph node (the reference's voxel graph keeps the
    cluster and its 2-voxel segments, skeletonization.py:311-333)."""
    deg = np.bincount(a, minlength=n) + np.bincount(b, minlength=n)
    isj = deg >= 3
    parent = np.arange(n, dtype=np.int64)

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    jj = isj[a] & isj[b]
    for x, y in zip(a[jj].tolist(), b[jj].tolist()):
        rx, ry = find(x), find(y)
        if rx != ry:
            parent[ry] = rx
    roots = np.fromiter((find(i) for i in range(n)), np.int64, n)
    # representative per cluster = member with max radius (stable sort:
    # the LAST assignment per root wins)
    rep_of_root: Dict[int, int] = {}
    for i in np.argsort(radius, kind="stable").tolist():
        rep_of_root[roots[i]] = i
    rep = np.fromiter((rep_of_root[r] for r in roots.tolist()), np.int64, n)
    a2, b2 = rep[a], rep[b]
    keep = a2 != b2
    a2, b2 = a2[keep], b2[keep]
    lo, hi = np.minimum(a2, b2), np.maximum(a2, b2)
    uniq_e = np.unique(lo * np.int64(n) + hi)
    return uniq_e // n, uniq_e % n


def prune_parallel_arcs(chains, n, radius, factor: float = 3.0,
                        min_keep: int = 6):
    """Drop duplicate short arcs between the same junction pair (keep the
    max-mean-radius one) and short self-loops — thinning leftovers inside
    thick vessels.  Arcs longer than ``max(min_keep, factor * junction
    radius)`` are never dropped (they may be real anatomy)."""
    from collections import defaultdict
    groups = defaultdict(list)
    out = []
    for c in chains:
        if c[0] == c[-1]:
            # float(): f64 thresholds, matching the C++ port exactly
            if len(c) <= max(min_keep, factor * float(radius[c[0]])) * 2:
                continue
            out.append(c)
            continue
        key = (c[0], c[-1]) if c[0] < c[-1] else (c[-1], c[0])
        groups[key].append(c)
    for key, cs in groups.items():
        if len(cs) == 1:
            out.append(cs[0])
            continue
        _, score = _chain_mean_radius(cs, radius)
        best = int(np.argmax(score))
        rj = float(max(radius[key[0]], radius[key[1]]))
        for i, c in enumerate(cs):
            if i == best or len(c) > max(min_keep, factor * rj):
                out.append(c)
    return out


def _chain_mean_radius(chains, radius):
    """Per-chain mean radius, vectorized (one cumsum instead of a
    np.mean per chain — the chain count reaches thousands).

    The f64 cumulative sum is SEQUENTIAL in flat order, so the native
    extractor reproduces every mean bit-for-bit (reduceat's pairwise
    float summation would not be portable)."""
    lens = np.fromiter((len(c) for c in chains), np.int64, len(chains))
    flat = np.concatenate([np.asarray(c, np.int64) for c in chains])
    csum = np.zeros(len(flat) + 1, np.float64)
    np.cumsum(radius[flat], dtype=np.float64, out=csum[1:])
    starts = np.zeros(len(chains), np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    sums = csum[starts + lens] - csum[starts]
    return lens, sums / lens


def _fundamental_cycles(arc_ends):
    """Deterministic fundamental cycle basis of the arc graph.

    ``arc_ends``: list of (u, v) vertex pairs, one FIRST arc per
    unordered pair (parallel arcs and self-loops excluded by the
    caller).  BFS spanning forest rooted at the minimum-index vertex of
    each component, neighbors visited in sorted order; every non-tree
    arc closes exactly one cycle (its endpoints' tree paths to their
    LCA).  Returns cycles as lists of arc indices, in non-tree-arc
    order.  Fully deterministic — unlike ``nx.cycle_basis``, whose
    root choice pops a set — so a native port can match it exactly."""
    verts = sorted({u for u, v in arc_ends} | {v for u, v in arc_ends})
    vid = {v: i for i, v in enumerate(verts)}
    nv = len(verts)
    adj = [[] for _ in range(nv)]
    for k, (u, v) in enumerate(arc_ends):
        ui, vi = vid[u], vid[v]
        adj[ui].append((vi, k))
        adj[vi].append((ui, k))
    for lst in adj:
        lst.sort()
    parent = [-1] * nv          # parent vertex in the BFS tree
    parent_arc = [-1] * nv
    depth = [-1] * nv
    tree = [False] * len(arc_ends)
    order = []
    for root in range(nv):
        if depth[root] >= 0:
            continue
        depth[root] = 0
        queue = [root]
        while queue:
            nxt = []
            for x in queue:
                for y, k in adj[x]:
                    if depth[y] < 0:
                        depth[y] = depth[x] + 1
                        parent[y] = x
                        parent_arc[y] = k
                        tree[k] = True
                        nxt.append(y)
            queue = nxt
    cycles = []
    for k, (u, v) in enumerate(arc_ends):
        if tree[k]:
            continue
        ui, vi = vid[u], vid[v]
        if ui == vi:
            continue
        arcs_u, arcs_v = [], []
        while depth[ui] > depth[vi]:
            arcs_u.append(parent_arc[ui])
            ui = parent[ui]
        while depth[vi] > depth[ui]:
            arcs_v.append(parent_arc[vi])
            vi = parent[vi]
        while ui != vi:
            arcs_u.append(parent_arc[ui])
            ui = parent[ui]
            arcs_v.append(parent_arc[vi])
            vi = parent[vi]
        cycles.append([k] + arcs_u + arcs_v[::-1])
    return cycles


def prune_artifact_cycles(chains, n, radius, tight_ratio: float = 16.0,
                          iterations: int = 3):
    """Cut thinning-artifact cycles: for every basis cycle whose total
    arc length is <= ``tight_ratio`` x its max arc radius (a mesh *inside*
    one thick vessel: its extent is a few vessel diameters), remove the
    weakest (min mean-radius) arc.  Long loops — real anatomy like the
    Circle of Willis — are far above the ratio and never touched."""
    for _ in range(iterations):
        if not chains:
            break
        lens, means = _chain_mean_radius(chains, radius)
        info = list(zip(lens.tolist(), means.tolist()))
        seen_pairs = set()
        arc_ends, arc_idx = [], []
        for i, c in enumerate(chains):
            key = (c[0], c[-1]) if c[0] < c[-1] else (c[-1], c[0])
            if c[0] != c[-1] and key not in seen_pairs:
                seen_pairs.add(key)
                arc_ends.append(key)
                arc_idx.append(i)
        drop = set()
        for cyc in _fundamental_cycles(arc_ends):
            arcs = [arc_idx[k] for k in cyc]
            if any(k in drop for k in arcs):
                continue
            tot = sum(info[k][0] for k in arcs)
            rmax = max(info[k][1] for k in arcs)
            if tot <= tight_ratio * max(rmax, 0.5):
                # full tie-break (weakest, longest, LOWEST chain index):
                # junction-cluster meshes tie on radius and length, and
                # the index tie-break both pins the choice for the
                # native port and prefers cutting earlier-walked (more
                # central) arcs, letting later spur passes finish the
                # cluster
                drop.add(min(arcs,
                             key=lambda k: (info[k][1], -info[k][0], k)))
        if not drop:
            break
        chains = _rebuild_chains(
            [c for i, c in enumerate(chains) if i not in drop], n)
    return chains


def prune_junction_bridges(chains, n, radius, coords=None,
                           max_len: int = 13, cover_tol: float = 4.0,
                           cover_radius_factor: float = 1.0,
                           iterations: int = 3):
    """Cut short junction-junction bridge arcs that lie on a cycle —
    the automated form of the reference's manual remove+merge edit
    (manualCorrectionGUIDetail.py:266-374): same-branch thinning loops
    and kissing-vessel mask merges both show up as a short arc joining
    two degree->=3 vertices with the rest of the cycle carrying the real
    anatomy.

    An arc is removed only when (a) both endpoints have degree >= 3,
    (b) its voxel length is <= ``max_len``, (c) its endpoints remain
    connected without it (it is a cycle member, so removal cannot
    disconnect the tree), and (d) — when ``coords`` is given — every
    interior voxel stays within ``cover_tol`` voxels of the surviving
    chains (geometric redundancy: a thinning loop runs beside its twin
    arc and a kissing neck spans a near-touch gap, but a REAL short
    branch carries geometry nothing else covers, so it survives even
    when a mask merge put it on a cycle).  Candidates are cut
    weakest-mean-radius first, re-checking connectivity after each cut
    so two arcs of the same cycle are never both removed.  The rebuild
    afterwards merges the now-degree-2 junction chains — the
    reference's auto-merge.  Long real collaterals (e.g.
    Circle-of-Willis communicating arteries longer than ``max_len``
    voxels) are never candidates; anything cut in error is restorable
    with the editing engine, exactly as the reference resolves kissing
    vessels manually."""
    import networkx as nx
    for _ in range(iterations):
        if not chains:
            break
        ends = np.fromiter((c[0] for c in chains), np.int64, len(chains))
        ends = np.concatenate(
            [ends, np.fromiter((c[-1] for c in chains), np.int64,
                               len(chains))])
        deg = np.bincount(ends, minlength=n)
        lens, means = _chain_mean_radius(chains, radius)
        Gm = nx.MultiGraph()
        for i, c in enumerate(chains):
            Gm.add_edge(c[0], c[-1], key=i)
        cand = [i for i, c in enumerate(chains)
                if c[0] != c[-1] and len(c) <= max_len
                and deg[c[0]] >= 3 and deg[c[-1]] >= 3]
        cand.sort(key=lambda i: (means[i], -lens[i]))
        drop: set = set()
        cover_tree = None
        if coords is not None and cand:
            from scipy.spatial import cKDTree
            chain_of = np.full(n, -1, np.int64)
            for i, c in enumerate(chains):
                chain_of[np.asarray(c, np.int64)] = i
            # junction vertices belong to every incident arc: never let
            # a candidate count as covered by its own endpoints
            all_v = np.concatenate([np.asarray(c, np.int64)
                                    for c in chains])
            all_v = np.unique(all_v)
            cover_tree = (all_v, cKDTree(coords[all_v]))
        for i in cand:
            u, v = chains[i][0], chains[i][-1]
            if not Gm.has_edge(u, v, key=i):
                continue
            Gm.remove_edge(u, v, key=i)
            if not nx.has_path(Gm, u, v):
                Gm.add_edge(u, v, key=i)
                continue
            if cover_tree is not None and len(chains[i]) > 2:
                all_v, tree = cover_tree
                interior = np.asarray(chains[i][1:-1], np.int64)
                own = set(chains[i]) | {
                    w for j in drop for w in chains[j]}
                # thick arcs tolerate wider coverage gaps: a thinning
                # twin inside a radius-r vessel runs ~r away from its
                # sibling, while a thin real branch keeps the strict
                # base tolerance
                tol_i = max(cover_tol,
                            cover_radius_factor * float(means[i]))
                nbrs = tree.query_ball_point(coords[interior], r=tol_i)
                covered = all(
                    any(all_v[t] not in own for t in lst)
                    for lst in nbrs)
                if not covered:
                    Gm.add_edge(u, v, key=i)
                    continue
            drop.add(i)
        if not drop:
            break
        chains = _rebuild_chains(
            [c for i, c in enumerate(chains) if i not in drop], n)
    return chains


def _prune_chains_radius(chains, n, radius, min_length: int = 3,
                         factor: float = 2.5, iterations: int = 4):
    """Radius-aware spur pruning: drop terminal chains shorter than
    ``max(min_length, factor * junction radius)`` voxels — curve-thinning
    grows one spur per surface bump, with length about the local vessel
    radius.  Isolated chains only honor ``min_length``."""
    for _ in range(iterations):
        if not chains:
            break
        ends = np.fromiter((c[0] for c in chains), np.int64, len(chains))
        ends = np.concatenate(
            [ends, np.fromiter((c[-1] for c in chains), np.int64,
                               len(chains))])
        end_count = np.bincount(ends, minlength=n)
        keep = []
        for c in chains:
            t0, t1 = end_count[c[0]] == 1, end_count[c[-1]] == 1
            if t0 and t1:
                if len(c) <= min_length:
                    continue
            elif t0 or t1:
                # float(): f64 threshold to match the C++ port exactly
                # (factor * np.float32 would round the product to f32)
                rj = float(radius[c[-1]] if t0 else radius[c[0]])
                if len(c) <= max(min_length, factor * rj):
                    continue
            keep.append(c)
        if len(keep) == len(chains):
            break
        chains = _rebuild_chains(keep, n)
    return chains


def simplify_chains(chains, n, radius, min_length: int = 3,
                    collapse: bool = True, radius_factor: float = 2.5,
                    cycle_tight_ratio: float = 16.0, rounds: int = 3,
                    bridge_max_len: int = 13, coords=None):
    """Full simplification: junction-cluster collapse -> parallel-arc
    dedupe -> tight-cycle cut -> junction-bridge audit -> radius-aware
    spur prune, iterated (each pass exposes work for the next: pruning
    a spur merges its junction's surviving arcs, collapse after that
    may merge clusters, ...).  ``bridge_max_len=0`` disables the
    bridge audit."""
    for _ in range(rounds):
        if not chains:
            break
        before = len(chains)
        if collapse:
            a = np.concatenate([np.asarray(c[:-1], np.int64)
                                for c in chains])
            b = np.concatenate([np.asarray(c[1:], np.int64)
                                for c in chains])
            a, b = collapse_junction_clusters(a, b, n, radius)
            chains = _chains_from_edge_indices(a, b, n)
        n_before = len(chains)
        chains = prune_parallel_arcs(chains, n, radius)
        if len(chains) != n_before:
            chains = _rebuild_chains(chains, n)
        if cycle_tight_ratio > 0:
            chains = prune_artifact_cycles(chains, n, radius,
                                           cycle_tight_ratio)
        if bridge_max_len > 0:
            chains = prune_junction_bridges(chains, n, radius,
                                            coords=coords,
                                            max_len=bridge_max_len)
        chains = _prune_chains_radius(chains, n, radius,
                                      min_length=min_length,
                                      factor=radius_factor)
        if len(chains) == before:
            break
    return chains


def skeleton_to_segments(skeleton, prune_min_length: int = 0,
                         build_graph: bool = True, origin=(0, 0, 0),
                         distance_transform=None, simplify: bool = False,
                         collapse: bool = True,
                         radius_factor: float = 2.5,
                         cycle_tight_ratio: float = 16.0,
                         simplify_rounds: int = 3,
                         bridge_max_len: int = 13):
    """Skeleton mask -> (G, segmentList): the output contract of the
    reference's skeletonization stage (graphRepresentation + segmentList,
    skeletonization.py:745-790).

    ``build_graph=False`` skips the networkx voxel graph (returns
    ``(None, segments)``) for callers on the array fast path.  A
    box-cropped skeleton passes its box start as ``origin`` so the
    emitted segments carry full-frame coordinates.

    With ``simplify=True`` and a ``distance_transform`` (same frame as
    ``skeleton``), the full structural cleanup runs instead of the plain
    length prune: junction-cluster collapse, parallel-arc dedupe,
    tight-cycle cut, and radius-aware spur pruning (``simplify_chains``).
    """
    a, b, shape = _edges_from_skeleton(skeleton)
    if simplify and distance_transform is not None and len(a):
        uniq = np.unique(np.concatenate([a, b]))
        radius = np.asarray(distance_transform,
                            np.float32).reshape(-1)[uniq]
        coords_i = _keys_to_coords(uniq, shape)
        chains = None
        try:
            # native extractor (graph_ops.cpp): the whole walk +
            # simplification pipeline, bit-exact with the Python passes
            # (~20x on the 1-core host); fall through on any build
            # failure
            from ..ops.native import simplify_chains_native
            chains = simplify_chains_native(
                np.searchsorted(uniq, a), np.searchsorted(uniq, b),
                len(uniq), radius, coords=coords_i,
                min_length=max(prune_min_length, 3), collapse=collapse,
                radius_factor=radius_factor,
                cycle_tight_ratio=cycle_tight_ratio,
                rounds=simplify_rounds, bridge_max_len=bridge_max_len)
        except Exception:
            chains = None
        if chains is None:
            chains, uniq = _chains_from_edges(a, b)
            chains = simplify_chains(chains, len(uniq), radius,
                                     min_length=max(prune_min_length, 3),
                                     collapse=collapse,
                                     radius_factor=radius_factor,
                                     cycle_tight_ratio=cycle_tight_ratio,
                                     rounds=simplify_rounds,
                                     bridge_max_len=bridge_max_len,
                                     coords=coords_i.astype(np.float64))
        segments = _chains_to_tuple_segments(chains, uniq, shape, origin)
        G = segments_to_graph(segments) if build_graph else None
        return G, segments
    chains, uniq = _chains_from_edges(a, b)
    if prune_min_length > 0:
        chains = _prune_chains(chains, len(uniq),
                               min_length=prune_min_length)
    segments = _chains_to_tuple_segments(chains, uniq, shape, origin)
    G = segments_to_graph(segments) if build_graph else None
    return G, segments
