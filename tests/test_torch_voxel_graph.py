"""The port's graph classes (graphs/voxel_graph.py) and graphml store
against networkx, which imports here.

Seeded random graphs with cycles, self-loops in the multigraph and ties
of equal-length paths go through networkx and the port by the same
operations.  Exact equality is required everywhere (no tolerance):
node, neighbour and edge orders, ``degree``, ``subgraph`` order (both of
networkx's node orders), ``connected_components`` order, ``has_path``,
``shortest_path`` with ties, ``cycle_basis`` (the list and the order in
each cycle), attribute updates on re-added edges, graphml written by one
and read by the other (nodes, order, attributes and their Python types;
the port's writer is byte-identical to networkx's ``write_graphml_xml``)
and networkx 3 pickles with cached views loaded into the port's classes.
"""

import pickle

import networkx as nx
import numpy as np
import pytest

from arterynetwork_tpu_torch.graphs import voxel_graph as vg
from arterynetwork_tpu_torch.io.artifacts import (ArtifactStore,
                                                  read_graphml,
                                                  write_graphml)


def _adj(G):
    """Nodes with their attributes, and each node's neighbours in order
    with their edge data (key dicts in a multigraph)."""
    return ([(n, dict(G.nodes[n])) for n in G.nodes()],
            [(n, [(m, dict(d)) for m, d in G.adj[n].items()])
             for n in G.nodes()])


def _same(a, b):
    assert _adj(a) == _adj(b)
    assert type(a).__name__ == type(b).__name__
    assert a.graph == b.graph
    if a.is_multigraph():
        assert list(a.edges(keys=True, data=True)) == \
            list(b.edges(keys=True, data=True))
    else:
        assert list(a.edges(data=True)) == list(b.edges(data=True))
    for n in a.nodes():
        assert a.degree(n) == b.degree(n)
        assert list(a.neighbors(n)) == list(b.neighbors(n))


def _ops(seed, n_nodes=30, n_ops=160, multi=False):
    """A seeded sequence of graph edits on small voxel-tuple nodes."""
    rng = np.random.default_rng(seed)
    nodes = [tuple(int(x) for x in rng.integers(0, 4, 3))
             for _ in range(n_nodes)]
    ops = []
    for _ in range(n_ops):
        r = rng.random()
        u = nodes[rng.integers(len(nodes))]
        v = nodes[rng.integers(len(nodes))]
        if r < 0.55:
            ops.append(("add_edge", u, v, {"w": float(rng.random()),
                                            "segmentIndex": int(
                                                rng.integers(5))}))
        elif r < 0.65:
            ops.append(("add_node", u, {"radius": float(rng.random())}))
        elif r < 0.8:
            ops.append(("update", u, v, {"flag": bool(rng.random() < .5)}))
        else:
            ops.append(("remove", u, v, None))
    return ops


def _apply(G, ops):
    multi = G.is_multigraph()
    for op, u, *rest in ops:
        if op == "add_node":
            G.add_node(u, **rest[0])
        elif op == "add_edge":
            if multi:
                G.add_edge(u, rest[0], key=rest[1]["segmentIndex"],
                           **rest[1])
            else:
                G.add_edge(u, rest[0], **rest[1])
        elif op == "update":
            if G.has_edge(u, rest[0]):
                G.add_edge(u, rest[0], **rest[1])
        elif G.has_edge(u, rest[0]):
            G.remove_edge(u, rest[0])
    return G


@pytest.mark.parametrize("cls", ["Graph", "DiGraph", "MultiGraph"])
@pytest.mark.parametrize("seed", range(4))
def test_random_edits_match_networkx(cls, seed):
    ops = _ops(seed)
    a = _apply(getattr(vg, cls)(), ops)
    b = _apply(getattr(nx, cls)(), ops)
    _same(a, b)
    assert len(a) == len(b) and all(n in a for n in b)
    assert list(a.nodes(data=True)) == list(b.nodes(data=True))


def test_add_edges_from_nodes_from_and_path():
    for lib in (vg, nx):
        G = lib.Graph()
        G.add_nodes_from([(0, 0, 2), (0, 0, 1)], radius=1.0)
        G.add_edges_from([((0, 0, 1), (0, 0, 3)), ((0, 0, 3), (0, 1, 3))],
                         segmentIndex=4)
        G.add_edges_from([((0, 1, 3), (0, 0, 3), {"segmentIndex": 5})],
                         pathLength=2.0)
        lib.add_path(G, [(1, 1, 1), (0, 0, 2), (0, 0, 3)], meanRadius=3.0)
        lib.set_node_attributes(G, {(0, 0, 2): 7, (9, 9, 9): 1}, "depth")
        if lib is vg:
            a = G
    _same(a, G)


def _grid(lib, n, holes=()):
    """n x n x 2 lattice: many equal-length paths between far corners."""
    G = lib.Graph()
    for z in range(2):
        for y in range(n):
            for x in range(n):
                for d in ((0, 0, 1), (0, 1, 0), (1, 0, 0)):
                    q = (z + d[0], y + d[1], x + d[2])
                    if q[0] < 2 and q[1] < n and q[2] < n \
                            and (z, y, x) not in holes and q not in holes:
                        G.add_edge((z, y, x), q)
    return G


def _random_loopy(lib, seed, n=40, m=70):
    rng = np.random.default_rng(seed)
    G = lib.Graph()
    G.add_nodes_from(range(n))
    for _ in range(m):
        u, v = (int(x) for x in rng.integers(0, n, 2))
        G.add_edge(u, v)
    return G


@pytest.mark.parametrize("seed", range(3))
def test_paths_components_cycles_match_networkx(seed):
    rng = np.random.default_rng(seed)
    graphs = [lambda lib: _grid(lib, 5),
              lambda lib: _grid(lib, 6, holes={(0, 2, 2), (1, 3, 1)}),
              lambda lib: _random_loopy(lib, seed),
              lambda lib: _random_loopy(lib, seed + 10, n=60, m=50)]
    for make in graphs:
        P, G = make(vg), make(nx)
        _same(P, G)
        nodes = list(G.nodes())
        for _ in range(25):
            s, t = (nodes[i] for i in rng.integers(0, len(nodes), 2))
            assert vg.has_path(P, s, t) == nx.has_path(G, s, t)
            if nx.has_path(G, s, t):
                assert vg.shortest_path(P, s, t) == nx.shortest_path(G, s, t)
            else:
                with pytest.raises(vg.NoPath):
                    vg.shortest_path(P, s, t)
        assert [sorted(c) for c in vg.connected_components(P)] == \
            [sorted(c) for c in nx.connected_components(G)]
        assert vg.cycle_basis(P) == nx.cycle_basis(G)
        assert vg.cycle_basis(P, nodes[3]) == nx.cycle_basis(G, nodes[3])
        # subgraphs: fewer than half the nodes (networkx iterates its
        # node set) and more than half (the parent's order)
        for k in (len(nodes) // 3, (3 * len(nodes)) // 4):
            pick = [nodes[i] for i in rng.permutation(len(nodes))[:k]]
            sa, sb = P.subgraph(pick), G.subgraph(pick)
            assert list(sa.nodes()) == list(sb.nodes())
            _same(sa, sb)
            s, t = pick[0], pick[-1]
            if nx.has_path(sb, s, t):
                assert vg.shortest_path(sa, s, t) == \
                    nx.shortest_path(sb, s, t)


def test_multigraph_self_loops_degree_and_has_path():
    """Endpoint multigraphs of closed-loop segments: a self-loop counts
    twice in ``degree``; keyed removal and re-adding keep networkx's
    neighbour order."""
    for lib in (vg, nx):
        G = lib.MultiGraph()
        G.add_edge(0, 1, key=0)
        G.add_edge(1, 1, key=1)          # closed loop at a junction
        G.add_edge(1, 2, key=2)
        G.add_edge(0, 1, key=3)          # parallel arc
        G.add_edge(2, 2, key=4)
        G.add_edge(2, 2, key=5)
        G.remove_edge(0, 1, key=0)
        G.add_edge(3, 4, key=6)
        degrees = [G.degree(n) for n in range(5)]
        reach = [lib.has_path(G, 0, t) for t in range(5)]
        G.remove_edge(0, 1, key=3)
        G.add_edge(1, 0, key=7)
        if lib is vg:
            a, da, ra = G, degrees, reach
    assert da == degrees == [1, 4, 5, 1, 1]
    assert ra == reach
    _same(a, G)


@pytest.mark.parametrize("cls", ["Graph", "DiGraph"])
def test_relabel_copy_matches_networkx(cls):
    ops = _ops(7)
    a = _apply(getattr(vg, cls)(), ops)
    b = _apply(getattr(nx, cls)(), ops)
    _same(vg.relabel_nodes(a, str), nx.relabel_nodes(b, str, copy=True))
    m = {n: str(n) for n in list(b.nodes())[::2]}
    _same(vg.relabel_nodes(a, m), nx.relabel_nodes(b, m, copy=True))


# ------------------------------------------------------------------ graphml
def _attr_graph(lib, seed, directed=False):
    rng = np.random.default_rng(seed)
    G = lib.DiGraph() if directed else lib.Graph()
    coords = [tuple(int(x) for x in rng.integers(0, 6, 3)) for _ in range(25)]
    for i in range(45):
        u, v = (coords[j] for j in rng.integers(0, len(coords), 2))
        G.add_edge(str(u), str(v), meanRadius=float(rng.random() * 3),
                   segmentIndex=int(i % 7), tortuosity=1.0 + i / 7,
                   partitionName=("LMCA", "ACA")[i % 2],
                   measured=bool(i % 3))
    for n in list(G.nodes())[::3]:
        G.nodes[n]["radius"] = float(rng.random())
        G.nodes[n]["depthLevel"] = int(rng.integers(9))
    return G


@pytest.mark.parametrize("directed", [False, True])
@pytest.mark.parametrize("seed", range(2))
def test_graphml_port_writes_networkx_reads(tmp_path, seed, directed):
    a = _attr_graph(vg, seed, directed)
    b = _attr_graph(nx, seed, directed)
    _same(a, b)
    pa, pb = str(tmp_path / "port.graphml"), str(tmp_path / "nx.graphml")
    write_graphml(a, pa)
    nx.write_graphml_xml(b, pb)
    assert open(pa, "rb").read() == open(pb, "rb").read()
    back = nx.read_graphml(pa)
    _same(read_graphml(pa), back)
    for n, d in back.nodes(data=True):
        assert [type(v) for v in d.values()] == \
            [type(v) for v in b.nodes[n].values()]


@pytest.mark.parametrize("directed", [False, True])
def test_graphml_networkx_writes_port_reads(tmp_path, directed):
    """networkx's default writer (lxml here) and its etree writer."""
    b = _attr_graph(nx, 3, directed)
    for write in (nx.write_graphml, nx.write_graphml_xml):
        p = str(tmp_path / f"{write.__name__}.graphml")
        write(b, p)
        ref = nx.read_graphml(p)
        got = read_graphml(p)
        _same(got, ref)
        for n, d in got.nodes(data=True):
            assert [type(v) for v in d.values()] == \
                [type(v) for v in ref.nodes[n].values()]
        for u, v, d in got.edges(data=True):
            assert [type(x) for x in d.values()] == \
                [type(x) for x in ref[u][v].values()]
            assert {type(x) for x in d.values()} == {bool, str, float, int}


def test_store_graphml_round_trip_matches_networkx_store(tmp_path):
    """ArtifactStore.save_graphml/load_graphml against the JAX package's
    store (networkx) on a voxel graph with numpy and list attributes."""
    from arterynetwork_tpu.io.artifacts import ArtifactStore as JaxStore

    graphs = []
    for lib in (vg, nx):
        G = lib.Graph()
        segs = [[(0, 0, z) for z in range(5)],
                [(0, 0, 4), (0, 1, 5), (0, 2, 6)],
                [(0, 0, 4), (1, 0, 5), (2, 0, 6), (1, 0, 5)[:2] + (7,)],
                [(0, 2, 6), (1, 1, 6), (2, 0, 6)]]         # a loop
        for i, seg in enumerate(segs):
            for a, b in zip(seg[:-1], seg[1:]):
                G.add_edge(a, b, segmentIndex=np.int64(i),
                           meanRadius=np.float32(1.5 + i),
                           pathLength=float(len(seg)), voxels=[i, i + 1])
        for n in G.nodes():
            G.nodes[n]["radius"] = np.float64(sum(n) / 4)
        graphs.append(G)
    ArtifactStore(str(tmp_path / "port")).save_graphml("g.graphml", graphs[0])
    JaxStore(str(tmp_path / "jax")).save_graphml("g.graphml", graphs[1])
    for d in ("port", "jax"):
        a = ArtifactStore(str(tmp_path / d)).load_graphml("g.graphml")
        b = JaxStore(str(tmp_path / d)).load_graphml("g.graphml")
        _same(a, b)
        assert a[(0, 0, 4)][(0, 0, 3)]["voxels"] == "[0, 1]"
        # write and read each re-add the edges in edges() order: the
        # loaded graph's neighbour order is the relabel rule's, which is
        # idempotent
        want = vg.relabel_nodes(graphs[0], {})
        assert [list(a.adj[n]) for n in a] == [list(want.adj[n])
                                               for n in want]
        again = vg.relabel_nodes(want, str)
        assert [list(again.adj[str(n)]) for n in want] == \
            [[str(m) for m in want.adj[n]] for n in want]
        assert type(a.nodes[(0, 0, 4)]["radius"]) is float
        assert type(a[(0, 0, 4)][(0, 0, 3)]["segmentIndex"]) is int


# ------------------------------------------------------------ legacy pickles
@pytest.mark.parametrize("protocol", [2, pickle.HIGHEST_PROTOCOL])
def test_networkx_pickle_with_views_loads_into_port_classes(tmp_path,
                                                            protocol):
    b = _attr_graph(nx, 5)
    d = _attr_graph(nx, 6, directed=True)
    for G in (b, d):      # touch the cached views so the pickle holds them
        list(G.nodes(data=True)), list(G.edges()), dict(G.degree)
        G.adj, G.nodes, G.edges, G.degree
    bundle = {"G": b, "DG": d, "segmentList": [[(0, 0, 1)]],
              "info": np.arange(3)}
    p = str(tmp_path / "bundle.pkl")
    with open(p, "wb") as f:
        pickle.dump(bundle, f, protocol)
    assert b"networkx" in open(p, "rb").read()
    loaded = vg.load_legacy_pickle(p)
    assert type(loaded["G"]) is vg.Graph and type(loaded["DG"]) is vg.DiGraph
    _same(loaded["G"], b)
    _same(loaded["DG"], d)
    assert loaded["segmentList"] == bundle["segmentList"]
    np.testing.assert_array_equal(loaded["info"], bundle["info"])
    # the port's own graphs pickle and unpickle with their dicts only
    again = pickle.loads(pickle.dumps(loaded["DG"]))
    _same(again, d)
