"""Graph classes with networkx's semantics, for the voxel-graph path.

The voxel graph, its traversal, the editing engine, the morphology
metrics and the graphml store use this small subset of networkx, so the
port runs where networkx is not installed.  ``Graph``, ``DiGraph`` and
``MultiGraph`` hold dict-of-dict adjacency with node and edge attribute
dicts and iterate nodes, neighbours and edges in networkx's insertion
orders.  Those orders decide results: ``partition_bfs`` keeps the first
discovery over ``neighbors``, ``reduced_to_flow_network`` numbers nodes
by a stable sort of ``nodes()``, compartments are named in component
order.  ``shortest_path`` (bidirectional BFS) and ``cycle_basis`` (a
stack walk) are transcribed from networkx, so on graphs with cycles the
same path and the same basis come out.

``load_legacy_pickle`` reads pickles that hold networkx graphs (the
reference's legacy bundles) into these classes without importing
networkx.
"""

# Portions of this module (Graph/DiGraph/MultiGraph edge bookkeeping,
# the edge views' iteration order, subgraph node order, relabel copy,
# connected_components, _bidirectional_pred_succ, cycle_basis) are
# transcribed from NetworkX 3.6, which carries this notice:
#
#   Copyright (c) 2004-2025, NetworkX Developers
#   Aric Hagberg <hagberg@lanl.gov>
#   Dan Schult <dschult@colgate.edu>
#   Pieter Swart <swart@lanl.gov>
#   All rights reserved.
#
#   Redistribution and use in source and binary forms, with or without
#   modification, are permitted provided that the following conditions
#   are met:
#
#     * Redistributions of source code must retain the above copyright
#       notice, this list of conditions and the following disclaimer.
#
#     * Redistributions in binary form must reproduce the above
#       copyright notice, this list of conditions and the following
#       disclaimer in the documentation and/or other materials provided
#       with the distribution.
#
#     * Neither the name of the NetworkX Developers nor the names of its
#       contributors may be used to endorse or promote products derived
#       from this software without specific prior written permission.
#
#   THIS SOFTWARE IS PROVIDED BY THE COPYRIGHT HOLDERS AND CONTRIBUTORS
#   "AS IS" AND ANY EXPRESS OR IMPLIED WARRANTIES, INCLUDING, BUT NOT
#   LIMITED TO, THE IMPLIED WARRANTIES OF MERCHANTABILITY AND FITNESS FOR
#   A PARTICULAR PURPOSE ARE DISCLAIMED. IN NO EVENT SHALL THE COPYRIGHT
#   OWNER OR CONTRIBUTORS BE LIABLE FOR ANY DIRECT, INDIRECT, INCIDENTAL,
#   SPECIAL, EXEMPLARY, OR CONSEQUENTIAL DAMAGES (INCLUDING, BUT NOT
#   LIMITED TO, PROCUREMENT OF SUBSTITUTE GOODS OR SERVICES; LOSS OF USE,
#   DATA, OR PROFITS; OR BUSINESS INTERRUPTION) HOWEVER CAUSED AND ON ANY
#   THEORY OF LIABILITY, WHETHER IN CONTRACT, STRICT LIABILITY, OR TORT
#   (INCLUDING NEGLIGENCE OR OTHERWISE) ARISING IN ANY WAY OUT OF THE USE
#   OF THIS SOFTWARE, EVEN IF ADVISED OF THE POSSIBILITY OF SUCH DAMAGE.

from __future__ import annotations

import pickle
from itertools import chain, pairwise


class NoPath(Exception):
    """No path joins the two nodes (networkx's ``NetworkXNoPath``)."""


class NodeView:
    """``G.nodes``: iterate, ``in``, ``len``, ``G.nodes[n]`` is the
    attribute dict, ``G.nodes()`` the view, ``G.nodes(data=True)`` the
    (node, attributes) pairs."""

    __slots__ = ("_nodes",)

    def __init__(self, nodes):
        self._nodes = nodes

    def __call__(self, data=False):
        return self._nodes.items() if data else self

    def __iter__(self):
        return iter(self._nodes)

    def __len__(self):
        return len(self._nodes)

    def __contains__(self, n):
        return n in self._nodes

    def __getitem__(self, n):
        return self._nodes[n]


def _filtered(adj, order, keep):
    return {n: {m: d for m, d in adj[n].items() if m in keep} for n in order}


class Graph:
    """Undirected simple graph (networkx ``Graph``): ``_adj[u][v]`` is
    the edge's attribute dict, shared by both directions."""

    def __init__(self):
        self.graph = {}
        self._node = {}
        self._adj = {}

    # Pickles hold the dicts only.  A networkx pickle also holds cached
    # views, a cache dict, dict factories or a self-reference
    # (``load_legacy_pickle``); __setstate__ keeps the dicts of both.
    def __getstate__(self):
        return {"graph": self.graph, "_node": self._node, "_adj": self._adj}

    def __setstate__(self, state):
        self.graph = state.get("graph", {})
        self._node = state["_node"]
        self._adj = state["_adj"]

    def is_directed(self):
        return False

    def is_multigraph(self):
        return False

    def __iter__(self):
        return iter(self._node)

    def __contains__(self, n):
        try:
            return n in self._node
        except TypeError:
            return False

    def __len__(self):
        return len(self._node)

    def __getitem__(self, n):
        return self._adj[n]

    @property
    def nodes(self):
        return NodeView(self._node)

    @property
    def adj(self):
        return self._adj

    def _new_node(self, n):
        self._adj[n] = {}
        self._node[n] = {}

    def add_node(self, n, **attr):
        if n not in self._node:
            self._new_node(n)
        self._node[n].update(attr)

    def add_nodes_from(self, nodes, **attr):
        for n in nodes:
            try:
                newnode = n not in self._node
                newdict = attr
            except TypeError:         # (node, attribute dict) pairs
                n, ndict = n
                newnode = n not in self._node
                newdict = attr.copy()
                newdict.update(ndict)
            if newnode:
                self._new_node(n)
            self._node[n].update(newdict)

    def _link(self, u, v, datadict):
        self._adj[u][v] = datadict
        self._adj[v][u] = datadict

    def add_edge(self, u, v, **attr):
        """Add an edge, or update the attribute dict of an existing one."""
        if u not in self._node:
            self._new_node(u)
        if v not in self._node:
            self._new_node(v)
        datadict = self._adj[u].get(v, {})
        datadict.update(attr)
        self._link(u, v, datadict)

    def add_edges_from(self, ebunch, **attr):
        for e in ebunch:
            if len(e) == 3:
                u, v, dd = e
            else:
                u, v = e
                dd = {}
            if u not in self._node:
                self._new_node(u)
            if v not in self._node:
                self._new_node(v)
            datadict = self._adj[u].get(v, {})
            datadict.update(attr)
            datadict.update(dd)
            self._link(u, v, datadict)

    def remove_edge(self, u, v):
        del self._adj[u][v]
        if u != v:
            del self._adj[v][u]

    def has_edge(self, u, v):
        try:
            return v in self._adj[u]
        except KeyError:
            return False

    def neighbors(self, n):
        return iter(self._adj[n])

    def degree(self, n):
        """Neighbour count; a self-loop counts twice."""
        nbrs = self._adj[n]
        return len(nbrs) + (n in nbrs)

    def edges(self, data=False):
        """Each edge once, from the first of its endpoints in node order."""
        out = []
        seen = set()
        for n, nbrs in self._adj.items():
            for nbr, d in nbrs.items():
                if nbr not in seen:
                    out.append((n, nbr, d) if data else (n, nbr))
            seen.add(n)
        return out

    def subgraph(self, nodes):
        """Induced subgraph sharing the attribute dicts.  Nodes come in
        networkx's order: the parent's, unless the subgraph holds fewer
        than half its nodes, when networkx iterates its node set; each
        neighbour dict keeps the parent's order."""
        keep = set(n for n in nodes if n in self)
        order = (keep if 2 * len(keep) < len(self._node)
                 else [n for n in self._node if n in keep])
        sub = self.__class__()
        sub.graph = self.graph
        sub._node = {n: self._node[n] for n in order}
        sub._adj = _filtered(self._adj, order, keep)
        if self.is_directed():
            sub._pred = _filtered(self._pred, order, keep)
        return sub


class DiGraph(Graph):
    """Directed simple graph (networkx ``DiGraph``): ``_adj`` holds the
    successors, ``_pred`` the predecessors."""

    def __init__(self):
        super().__init__()
        self._pred = {}

    def __getstate__(self):
        return dict(super().__getstate__(), _pred=self._pred)

    def __setstate__(self, state):
        self.graph = state.get("graph", {})
        self._node = state["_node"]
        self._adj = state.get("_succ", state.get("_adj"))
        self._pred = state["_pred"]

    def is_directed(self):
        return True

    def _new_node(self, n):
        super()._new_node(n)
        self._pred[n] = {}

    def _link(self, u, v, datadict):
        self._adj[u][v] = datadict
        self._pred[v][u] = datadict

    def remove_edge(self, u, v):
        del self._adj[u][v]
        del self._pred[v][u]

    def degree(self, n):
        return len(self._adj[n]) + len(self._pred[n])

    def edges(self, data=False):
        """Successors per node, in node order."""
        return [(n, nbr, d) if data else (n, nbr)
                for n, nbrs in self._adj.items() for nbr, d in nbrs.items()]


class MultiGraph(Graph):
    """Undirected multigraph (networkx ``MultiGraph``): ``_adj[u][v]`` is
    a dict from edge key to attribute dict."""

    def is_multigraph(self):
        return True

    def new_edge_key(self, u, v):
        try:
            keydict = self._adj[u][v]
        except KeyError:
            return 0
        key = len(keydict)
        while key in keydict:
            key += 1
        return key

    def add_edge(self, u, v, key=None, **attr):
        if u not in self._node:
            self._new_node(u)
        if v not in self._node:
            self._new_node(v)
        if key is None:
            key = self.new_edge_key(u, v)
        if v in self._adj[u]:
            keydict = self._adj[u][v]
            datadict = keydict.get(key, {})
            datadict.update(attr)
            keydict[key] = datadict
        else:
            self._link(u, v, {key: dict(attr)})
        return key

    def add_edges_from(self, ebunch, **attr):
        """Edges as (u, v), (u, v, key), (u, v, data) or (u, v, key,
        data)."""
        for u, v, *rest in ebunch:
            dd = rest.pop() if rest and isinstance(rest[-1], dict) else {}
            self.add_edge(u, v, rest[0] if rest else None, **{**attr, **dd})

    def remove_edge(self, u, v, key=None):
        d = self._adj[u][v]
        if key is None:
            d.popitem()
        else:
            del d[key]
        if not d:
            del self._adj[u][v]
            if u != v:
                del self._adj[v][u]

    def has_edge(self, u, v, key=None):
        try:
            if key is None:
                return v in self._adj[u]
            return key in self._adj[u][v]
        except KeyError:
            return False

    def degree(self, n):
        """Edge-end count; a self-loop counts twice."""
        nbrs = self._adj[n]
        return (sum(len(keys) for keys in nbrs.values())
                + (len(nbrs[n]) if n in nbrs else 0))

    def edges(self, keys=False, data=False):
        out = []
        seen = set()
        for n, nbrs in self._adj.items():
            for nbr, keydict in nbrs.items():
                if nbr not in seen:
                    for k, d in keydict.items():
                        out.append((n, nbr) + ((k,) if keys else ())
                                   + ((d,) if data else ()))
            seen.add(n)
        return out


# ---------------------------------------------------------------------------
# functions
# ---------------------------------------------------------------------------
def set_node_attributes(G, values, name):
    """Set ``name`` on each node of the dict ``values`` that is in G (or
    on every node, when ``values`` is not a dict)."""
    try:
        items = values.items()
    except AttributeError:
        for d in G._node.values():
            d[name] = values
        return
    for n, v in items:
        if n in G._node:
            G._node[n][name] = v


def add_path(G, nodes, **attr):
    nlist = iter(nodes)
    try:
        first = next(nlist)
    except StopIteration:
        return
    G.add_node(first)
    G.add_edges_from(pairwise(chain((first,), nlist)), **attr)


def relabel_nodes(G, mapping):
    """Copy of a Graph or DiGraph with node ``n`` renamed ``mapping(n)``
    (a callable) or ``mapping.get(n, n)``: networkx's
    ``relabel_nodes(copy=True)``, which
    adds the nodes in G's order, then the edges in ``G.edges()`` order,
    so the copy's neighbour order can differ from G's."""
    m = ({n: mapping(n) for n in G} if callable(mapping) else mapping)
    H = G.__class__()
    H.add_nodes_from(m.get(n, n) for n in G)
    H._node.update((m.get(n, n), d.copy()) for n, d in G._node.items())
    H.add_edges_from((m.get(u, u), m.get(v, v), d.copy())
                     for u, v, d in G.edges(data=True))
    H.graph.update(G.graph)
    return H


def _plain_bfs(adj, n, source):
    seen = {source}
    nextlevel = [source]
    while nextlevel:
        thislevel = nextlevel
        nextlevel = []
        for v in thislevel:
            for w in adj[v]:
                if w not in seen:
                    seen.add(w)
                    nextlevel.append(w)
            if len(seen) == n:
                return seen
    return seen


def connected_components(G):
    """Node sets of the components, in the order of each one's first
    node."""
    seen = set()
    n = len(G)
    for v in G:
        if v not in seen:
            c = _plain_bfs(G._adj, n - len(seen), v)
            seen.update(c)
            yield c


def _bidirectional_pred_succ(G, source, target):
    if target == source:
        return ({target: None}, {source: None}, source)
    Gsucc = G._adj
    Gpred = G._pred if G.is_directed() else G._adj
    pred = {source: None}
    succ = {target: None}
    forward_fringe = [source]
    reverse_fringe = [target]
    while forward_fringe and reverse_fringe:
        if len(forward_fringe) <= len(reverse_fringe):
            this_level = forward_fringe
            forward_fringe = []
            for v in this_level:
                for w in Gsucc[v]:
                    if w not in pred:
                        forward_fringe.append(w)
                        pred[w] = v
                    if w in succ:
                        return pred, succ, w
        else:
            this_level = reverse_fringe
            reverse_fringe = []
            for v in this_level:
                for w in Gpred[v]:
                    if w not in succ:
                        succ[w] = v
                        reverse_fringe.append(w)
                    if w in pred:
                        return pred, succ, w
    raise NoPath(f"No path between {source} and {target}.")


def shortest_path(G, source, target):
    """An unweighted shortest path, as networkx's bidirectional BFS
    finds it (the same path among equal-length ones)."""
    if source not in G or target not in G:
        raise KeyError(f"Either source {source} or target {target} is not "
                       "in G")
    pred, succ, w = _bidirectional_pred_succ(G, source, target)
    path = []
    while w is not None:
        path.append(w)
        w = pred[w]
    path.reverse()
    w = succ[path[-1]]
    while w is not None:
        path.append(w)
        w = succ[w]
    return path


def has_path(G, source, target):
    try:
        shortest_path(G, source, target)
    except NoPath:
        return False
    return True


def cycle_basis(G, root=None):
    """Cycles forming a basis of G's cycle space, as networkx's stack
    walk lists them (components rooted at the last node not yet seen)."""
    gnodes = dict.fromkeys(G)
    cycles = []
    while gnodes:
        if root is None:
            root = gnodes.popitem()[0]
        stack = [root]
        pred = {root: root}
        used = {root: set()}
        while stack:
            z = stack.pop()
            zused = used[z]
            for nbr in G._adj[z]:
                if nbr not in used:
                    pred[nbr] = z
                    stack.append(nbr)
                    used[nbr] = {z}
                elif nbr == z:
                    cycles.append([z])
                elif nbr not in zused:
                    pn = used[nbr]
                    cycle = [nbr, z]
                    p = pred[z]
                    while p not in pn:
                        cycle.append(p)
                        p = pred[p]
                    cycle.append(p)
                    cycles.append(cycle)
                    used[nbr].add(z)
        for node in pred:
            gnodes.pop(node, None)
        root = None
    return cycles


# ---------------------------------------------------------------------------
# legacy pickles
# ---------------------------------------------------------------------------
class _Inert:
    """Stands in for any other networkx class a pickle names (cached
    views, caches): takes any arguments and state and keeps nothing."""

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        pass


_NX_CLASSES = {("networkx.classes.graph", "Graph"): Graph,
               ("networkx.classes.digraph", "DiGraph"): DiGraph}


class LegacyUnpickler(pickle.Unpickler):
    """Unpickles networkx ``Graph``/``DiGraph`` objects into this module's
    classes, without importing networkx."""

    def find_class(self, module, name):
        if module == "networkx" or module.startswith("networkx."):
            return _NX_CLASSES.get((module, name), _Inert)
        return super().find_class(module, name)


def load_legacy_pickle(path):
    with open(path, "rb") as f:
        return LegacyUnpickler(f).load()
