"""A small undirected graph in place of networkx, which the card's machine
does not have.

The JAX package builds networkx graphs in the contours stage (the skeleton
paths of core/skeleton.py) and the layout stage (core/neighbors.py and the
mergers of batch/detect/layout.py). The results there depend on the order
in which networkx visits nodes and edges, so this module keeps networkx's
orders: nodes and each node's neighbours in insertion order, an edge added
again updating its data in place, `edges()` yielding each edge once from
the end that came first, components found by breadth-first search from
each unseen node in insertion order, and Dijkstra's algorithm with the
same heap entries (distance, push count, node) and the same predecessor
rule.
"""

from __future__ import annotations

import heapq
from itertools import count


class NoPath(Exception):
    """No path joins the two nodes."""


class Graph:
    def __init__(self):
        self._adj = {}

    def add_node(self, n):
        if n not in self._adj:
            self._adj[n] = {}

    def add_nodes_from(self, nodes):
        for n in nodes:
            self.add_node(n)

    def add_edge(self, u, v, **attr):
        self.add_node(u)
        self.add_node(v)
        data = self._adj[u].get(v, {})
        data.update(attr)
        self._adj[u][v] = data
        self._adj[v][u] = data

    def has_edge(self, u, v):
        return u in self._adj and v in self._adj[u]

    def __getitem__(self, n):
        return self._adj[n]

    def __iter__(self):
        return iter(self._adj)

    @property
    def nodes(self):
        return list(self._adj)

    def edges(self):
        """Each edge once, as networkx's EdgeView yields it."""
        seen = set()
        out = []
        for n, nbrs in self._adj.items():
            for nbr in nbrs:
                if nbr not in seen:
                    out.append((n, nbr))
            seen.add(n)
        return out

    def number_of_edges(self):
        return len(self.edges())


def connected_components(g):
    """The node sets of g's components (networkx.connected_components)."""
    seen = set()
    for v in g:
        if v in seen:
            continue
        comp = {v}
        level = [v]
        while level:
            nxt = []
            for u in level:
                for w in g[u]:
                    if w not in comp:
                        comp.add(w)
                        nxt.append(w)
            level = nxt
        seen |= comp
        yield comp


def _dijkstra(g, source, weight, target=None):
    dist = {}
    seen = {source: 0}
    pred = {}
    c = count()
    fringe = [(0, next(c), source)]
    while fringe:
        d, _, v = heapq.heappop(fringe)
        if v in dist:
            continue
        dist[v] = d
        if v == target:
            break
        for u, e in g[v].items():
            vu = d + weight(v, u, e)
            if u in dist:
                if vu < dist[u]:
                    raise ValueError("Contradictory paths found: "
                                     "negative weights?")
            elif u not in seen or vu < seen[u]:
                seen[u] = vu
                heapq.heappush(fringe, (vu, next(c), u))
                pred[u] = v
    return dist, pred


def single_source_dijkstra_path_length(g, source, weight):
    """{node: distance} in the order the nodes were settled."""
    return _dijkstra(g, source, weight)[0]


def dijkstra_path(g, source, target, weight):
    """Node list of a shortest path (networkx.shortest_path with a weight
    function); raises NoPath."""
    dist, pred = _dijkstra(g, source, weight, target)
    if target not in dist:
        raise NoPath((source, target))
    path = [target]
    while path[-1] in pred:
        path.append(pred[path[-1]])
    path.reverse()
    return path
