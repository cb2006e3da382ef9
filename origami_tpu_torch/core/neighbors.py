"""Region adjacency graph.

Port of origami_tpu/core/neighbors.py, with core/graph.py in place of
networkx (the same node and edge orders). The reference builds
neighbourhoods from a Voronoi diagram of polygon segments
(origami/core/neighbors.py, boost::polygon via pyvoronoi). The
same "which regions are visually adjacent" relation is computed here with
a buffered-proximity graph: regions are neighbours when their shapes,
grown by an adaptive fringe, intersect — with an occlusion pass dropping
pairs whose connecting line crosses a third region.
"""

from __future__ import annotations

import numpy as np

from origami_tpu_torch import geometry as G
from origami_tpu_torch.core import graph as _graph
from origami_tpu_torch.geometry.ops import dwithin


def neighbors(contours, fringe_ratio=0.02):
    """contours: {path: polygon}. Returns a core.graph.Graph over paths."""
    g = _graph.Graph()
    keys = list(contours.keys())
    g.add_nodes_from(keys)
    if len(keys) < 2:
        return g
    polys = [contours[k] for k in keys]
    bounds = np.array([p.bounds for p in polys])
    diag = np.hypot(bounds[:, 2].max() - bounds[:, 0].min(),
                    bounds[:, 3].max() - bounds[:, 1].min())
    fringe = max(2.0, fringe_ratio * diag)

    tree = G.STRtree(polys)
    cands = set()
    for i, p in enumerate(polys):
        minx, miny, maxx, maxy = p.bounds
        probe = G.box(minx - fringe, miny - fringe,
                      maxx + fringe, maxy + fringe)
        for j in tree.query_indices(probe):
            if int(j) > i:
                cands.add((i, int(j)))

    cents = [p.centroid for p in polys]
    for i, j in cands:
        if not dwithin(polys[i], polys[j], fringe):
            continue
        # occlusion: skip if the connecting segment crosses another region
        conn = G.LineString([(cents[i].x, cents[i].y),
                             (cents[j].x, cents[j].y)])
        occluded = False
        for k in tree.query_indices(conn):
            k = int(k)
            if k in (i, j):
                continue
            if conn.intersects(polys[k]):
                occluded = True
                break
        if not occluded:
            g.add_edge(keys[i], keys[j])
    return g
