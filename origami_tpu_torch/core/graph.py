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
rule: from one source for distances, from both ends in turn for the
path between two nodes.
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


def single_source_dijkstra_path_length(g, source, weight):
    """{node: distance} in the order the nodes were settled."""
    dist = {}
    seen = {source: 0}
    c = count()
    fringe = [(0, next(c), source)]
    while fringe:
        d, _, v = heapq.heappop(fringe)
        if v in dist:
            continue
        dist[v] = d
        for u, e in g[v].items():
            vu = d + weight(v, u, e)
            if u in dist:
                if vu < dist[u]:
                    raise ValueError("Contradictory paths found: "
                                     "negative weights?")
            elif u not in seen or vu < seen[u]:
                seen[u] = vu
                heapq.heappush(fringe, (vu, next(c), u))
    return dist


def dijkstra_path(g, source, target, weight):
    """Node list of a shortest path, as networkx.shortest_path with a
    weight function finds it: networkx.bidirectional_dijkstra, which
    searches from both ends in turn and so breaks ties between equal
    paths otherwise than a search from the source alone. Raises NoPath."""
    if source == target:
        return [source]
    dists = [{}, {}]
    preds = [{source: None}, {target: None}]
    seen = [{source: 0}, {target: 0}]
    c = count()
    fringe = [[(0, next(c), source)], [(0, next(c), target)]]
    finaldist = meet = None
    direction = 1
    while fringe[0] and fringe[1]:
        direction = 1 - direction
        d, _, v = heapq.heappop(fringe[direction])
        if v in dists[direction]:
            continue
        dists[direction][v] = d
        if v in dists[1 - direction]:
            path, n = [], meet
            while n is not None:
                path.append(n)
                n = preds[0][n]
            path.reverse()
            n = preds[1][meet]
            while n is not None:
                path.append(n)
                n = preds[1][n]
            return path
        for u, e in g[v].items():
            vu = d + (weight(v, u, e) if direction == 0 else weight(u, v, e))
            if u in dists[direction]:
                if vu < dists[direction][u]:
                    raise ValueError("Contradictory paths found: "
                                     "negative weights?")
            elif u not in seen[direction] or vu < seen[direction][u]:
                seen[direction][u] = vu
                heapq.heappush(fringe[direction], (vu, next(c), u))
                preds[direction][u] = v
                if u in seen[1 - direction]:
                    total = vu + seen[1 - direction][u]
                    if finaldist is None or finaldist > total:
                        finaldist, meet = total, u
    raise NoPath((source, target))
