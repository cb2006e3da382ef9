"""Skeleton graph extraction for separator polyline estimation.

Port of origami_tpu/core/skeleton.py. Zhang-Suen thinning and the
city-block EDT run in the C++ of native.cpp, as on the JAX side's path;
the JAX package's device fallback for them (ops/morphology.skeletonize
and label_edt, reached only when its native library fails to build) is
not ported, because the port's native build raises instead. The skeleton
is traced into a graph by native.cpp's tracer (the Python walk below
takes over only when the tracer's buffers overflow, as on the JAX side):
nodes are junction/end pixels, edges the pixel paths between them, each
path annotated with twice its mean distance-transform value (the stroke
width). Paths through the graph use core/graph.py in place of networkx.
"""

from __future__ import annotations

import numpy as np

from origami_tpu_torch.core import graph as _graph
from origami_tpu_torch.geometry.native_bindings import (
    chamfer_edt_native, thin_mask_native, trace_skeleton_native)

_OFFS = [(-1, -1), (-1, 0), (-1, 1), (0, -1),
         (0, 1), (1, -1), (1, 0), (1, 1)]


class SkeletonGraph:
    """nodes: {id: (x, y)}; edges: list of (n0, n1, path_xy, width)."""

    def __init__(self, nodes, edges):
        self.nodes = nodes
        self.edges = edges

    def longest_path(self, direction=None):
        """Approximate longest path through the graph, optionally biased
        to progress along `direction` (unit 2-vector). Returns (N, 2)
        coords or None."""
        if not self.edges:
            return None
        g = _graph.Graph()
        for i, (n0, n1, path, width) in enumerate(self.edges):
            c = np.asarray(path)
            if direction is not None and len(c) >= 2:
                proj = abs(float((c[-1] - c[0]) @ np.asarray(direction)))
                length = proj + 0.25 * _path_len(c)
            else:
                length = _path_len(c)
            if g.has_edge(n0, n1):
                if g[n0][n1]["weight"] >= length:
                    continue
            g.add_edge(n0, n1, weight=length, index=i)
        # two-sweep heuristic: farthest node from an arbitrary node, then
        # farthest from that — exact on trees, good on near-trees
        start = next(iter(g.nodes))
        a = _farthest(g, start)
        b = _farthest(g, a)
        try:
            node_path = _graph.dijkstra_path(
                g, a, b, weight=lambda u, v, d: -0.0 + 1.0
                / (1e-9 + d["weight"]))
        except _graph.NoPath:
            return None
        coords = []
        for u, v in zip(node_path[:-1], node_path[1:]):
            e = self.edges[g[u][v]["index"]]
            seg = np.asarray(e[2])
            if e[0] != u:
                seg = seg[::-1]
            if coords:
                seg = seg[1:]
            coords.append(seg)
        if not coords:
            return None
        return np.vstack(coords)

    @property
    def mean_width(self):
        if not self.edges:
            return 1.0
        ws = [e[3] for e in self.edges]
        ls = [max(len(e[2]), 1) for e in self.edges]
        return float(np.average(ws, weights=ls))


def _path_len(c):
    if len(c) < 2:
        return 0.0
    return float(np.sum(np.linalg.norm(np.diff(c, axis=0), axis=1)))


def _farthest(g, start):
    dist = _graph.single_source_dijkstra_path_length(
        g, start, weight=lambda u, v, d: d["weight"])
    # farthest by accumulated weight
    return max(dist.items(), key=lambda kv: kv[1])[0]


def trace_skeleton(skel, dist=None):
    """Trace a boolean skeleton mask into a SkeletonGraph.

    dist: optional distance-transform of the original mask (for widths).
    Uses the C++ tracer (geometry.native_bindings); the numpy walk below
    runs only when the tracer's buffers overflow.
    """
    sk = np.asarray(skel, dtype=bool)
    native = _trace_native(sk, dist)
    if native is not None:
        return native
    h, w = sk.shape
    ys, xs = np.nonzero(sk)
    if len(ys) == 0:
        return SkeletonGraph({}, [])

    idx = {}
    for i, (y, x) in enumerate(zip(ys, xs)):
        idx[(y, x)] = i

    # neighbour counts
    def neighbours(y, x):
        out = []
        for dy, dx in _OFFS:
            ny, nx_ = y + dy, x + dx
            if 0 <= ny < h and 0 <= nx_ < w and sk[ny, nx_]:
                out.append((ny, nx_))
        return out

    ncount = np.zeros(len(ys), dtype=np.int32)
    for i, (y, x) in enumerate(zip(ys, xs)):
        ncount[i] = len(neighbours(y, x))

    is_node = (ncount != 2)
    node_ids = {}
    nodes = {}
    for i in np.nonzero(is_node)[0]:
        node_ids[(ys[i], xs[i])] = len(nodes)
        nodes[len(nodes)] = (float(xs[i]), float(ys[i]))

    if not nodes:
        # pure cycle: pick an arbitrary pixel as the single node
        p = (ys[0], xs[0])
        node_ids[p] = 0
        nodes[0] = (float(p[1]), float(p[0]))

    def width_at(path):
        if dist is None:
            return 1.0
        vals = [dist[int(py), int(px)] for px, py in path]
        return 2.0 * float(np.mean(vals)) if vals else 1.0

    edges = []
    visited_edges = set()
    for (y0, x0), n0 in node_ids.items():
        for ny, nx_ in neighbours(y0, x0):
            # walk from the node through degree-2 pixels to the next node
            prev = (y0, x0)
            cur = (ny, nx_)
            path = [(float(x0), float(y0))]
            while cur not in node_ids:
                path.append((float(cur[1]), float(cur[0])))
                nbrs = [p for p in neighbours(*cur) if p != prev]
                if not nbrs:
                    break
                prev, cur = cur, nbrs[0]
            if cur in node_ids:
                path.append((float(cur[1]), float(cur[0])))
                n1 = node_ids[cur]
                key = (min(n0, n1), max(n0, n1),
                       tuple(path[1]) if len(path) > 1 else ())
                if key in visited_edges:
                    continue
                visited_edges.add(key)
                edges.append((n0, n1, np.asarray(path), width_at(path)))
    return SkeletonGraph(nodes, edges)


def _trace_native(sk, dist):
    paths = trace_skeleton_native(sk)
    if paths is None:
        return None
    h, w = sk.shape
    nodes = {}
    node_ids = {}
    edges = []
    for path in paths:
        if len(path) < 2:
            continue
        coords = np.stack([path % w, path // w], axis=-1).astype(float)
        ends = []
        for px in (int(path[0]), int(path[-1])):
            if px not in node_ids:
                node_ids[px] = len(nodes)
                nodes[len(nodes)] = (float(px % w), float(px // w))
            ends.append(node_ids[px])
        if dist is not None:
            vals = dist[path // w, path % w]
            width = 2.0 * float(np.mean(vals)) if len(vals) else 1.0
        else:
            width = 1.0
        edges.append((ends[0], ends[1], coords, width))
    return SkeletonGraph(nodes, edges)


class FastSkeleton:
    """mask -> SkeletonGraph, native thinning + chamfer EDT widths."""

    def __call__(self, mask):
        ink = np.asarray(mask) > 0
        sk, d_bg = _thin_and_edt(ink)
        return trace_skeleton(sk, dist=d_bg)


def _thin_and_edt(ink):
    """(skeleton, background-EDT) of a padded bool mask, both from the
    C++ of native.cpp."""
    return thin_mask_native(ink), chamfer_edt_native(~ink)


def full_mask_skeleton(mask):
    """(skeleton, edt) of a whole class mask in ONE pass.

    Thinning is 3x3-local and 8-connected components are disjoint, so
    the full-mask skeleton cropped to a component's bbox equals
    thinning that component alone — callers trace each component
    (trace_skeleton) instead of thinning each one.
    Returns (bool (h, w) skeleton, float32 (h, w) background EDT).
    """
    ink = np.asarray(mask) > 0
    h, w = ink.shape
    # thin + EDT only inside the ink bounding box: a separator-class
    # mask is sparse and the raster passes are O(page) otherwise
    rows = np.flatnonzero(ink.any(axis=1))
    if not len(rows):
        return (np.zeros((h, w), bool), np.zeros((h, w), np.float32))
    cols = np.flatnonzero(ink.any(axis=0))
    y0, y1 = int(rows[0]), int(rows[-1]) + 1
    x0, x1 = int(cols[0]), int(cols[-1]) + 1
    crop = ink[y0:y1, x0:x1]
    padded = np.zeros((y1 - y0 + 4, x1 - x0 + 4), dtype=bool)
    padded[2:-2, 2:-2] = crop
    sk_c, d_c = _thin_and_edt(padded)
    sk = np.zeros((h, w), bool)
    d_bg = np.zeros((h, w), np.float32)
    sk[y0:y1, x0:x1] = sk_c[2:-2, 2:-2]
    d_bg[y0:y1, x0:x1] = d_c[2:-2, 2:-2]
    return sk, d_bg
