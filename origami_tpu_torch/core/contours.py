"""Contour extraction pipelines: label masks -> region polygons /
separator polylines.

Port of origami_tpu/core/contours.py. Label maps are vectorized on the
host by geometry/contour_trace.py, which gives cv2's findContours,
contourArea and connected components without cv2, then a pipeline of
small operators refines the shapes:

  Contours          border following of one class mask -> polygons
  Decompose         repair invalid polygons (raster make_valid; the
                    reference used CGAL arrangements)
  Simplify          Douglas-Peucker
  FilterByArea      drop specks below a minimum area
  Glue              merge nearby fragments of over-segmented regions via
                    buffered union + connected components
  EstimatePolyline  separator masks -> skeleton-based polylines
  HeuristicFrameDetector   drop margin noise hugging the page border

Operators compose with `pipeline(...)`; `multi_class_constructor` runs a
pipeline per label class of a prediction.
"""

from __future__ import annotations

import numpy as np

from origami_tpu_torch import geometry as G
from origami_tpu_torch.core import graph as _graph
from origami_tpu_torch.geometry import contour_trace as _ct
from origami_tpu_torch.geometry.poly import convex_hull_indices


def find_contour_polygons(mask, min_area=0.0, convex=False):
    """Vectorize a binary mask into polygons (with holes)."""
    m = (np.asarray(mask) > 0).astype(np.uint8)
    contours, hierarchy = _ct.find_contours(m)
    out = []
    if not contours:
        return out
    hierarchy = hierarchy[0]
    for i, cnt in enumerate(contours):
        if hierarchy[i][3] != -1:
            continue
        if _ct.contour_area(cnt) < max(min_area, 1.0):
            continue
        if convex:
            c2 = cnt.reshape(-1, 2)
            cnt = c2[convex_hull_indices(c2)]
        shell = cnt.reshape(-1, 2).astype(np.float64)
        holes = []
        child = hierarchy[i][2]
        while child != -1:
            hc = contours[child]
            if _ct.contour_area(hc) >= max(min_area, 1.0):
                holes.append(hc.reshape(-1, 2).astype(np.float64))
            child = hierarchy[child][0]
        if len(shell) >= 3:
            out.append(G.Polygon(shell, holes))
    return out


# ---------------------------------------------------------------------------
# operators
# ---------------------------------------------------------------------------

class Contours:
    """Extract class polygons from a label map."""

    def __init__(self, min_area=0.0):
        self._min_area = min_area

    def __call__(self, mask):
        return find_contour_polygons(mask, self._min_area)


class Decompose:
    """Repair invalid polygons; split multi-part results."""

    def __call__(self, polygons):
        out = []
        for p in polygons:
            if p.geom_type == "Polygon" and p.is_valid:
                out.append(p)
                continue
            fixed = G.make_valid(p)
            for q in (fixed.geoms if hasattr(fixed, "geoms") else [fixed]):
                if q.geom_type == "Polygon" and not q.is_empty:
                    out.append(q)
        return out


class Simplify:
    def __init__(self, tolerance):
        self._tol = tolerance

    def __call__(self, polygons):
        out = []
        for p in polygons:
            s = p.simplify(self._tol)
            out.append(s if not s.is_empty else p)
        return out


class FilterByArea:
    def __init__(self, min_area):
        self._min_area = min_area

    def __call__(self, polygons):
        return [p for p in polygons if p.area >= self._min_area]


class Glue:
    """Merge fragments whose buffered shapes touch (connected components
    over an STRtree adjacency)."""

    def __init__(self, buffer=5.0):
        self._buffer = buffer

    def __call__(self, polygons):
        if len(polygons) <= 1:
            return list(polygons)
        buffered = [p.buffer(self._buffer) for p in polygons]
        tree = G.STRtree(buffered)
        g = _graph.Graph()
        g.add_nodes_from(range(len(polygons)))
        for i, b in enumerate(buffered):
            for j in tree.query_indices(b):
                if j > i and buffered[j].intersects(b):
                    g.add_edge(i, int(j))
        out = []
        for comp in _graph.connected_components(g):
            comp = sorted(comp)
            if len(comp) == 1:
                out.append(polygons[comp[0]])
            else:
                # morphological closing: union the buffered shapes, then
                # erode back — bridges the gaps that caused the grouping
                merged = G.unary_union([buffered[i] for i in comp]) \
                    .buffer(-self._buffer)
                hull_parts = merged.geoms \
                    if hasattr(merged, "geoms") else [merged]
                for q in hull_parts:
                    if q.geom_type == "Polygon":
                        out.append(q)
        return out


class HeuristicFrameDetector:
    """Drop margin noise: shapes hugging the page border that are thin
    relative to their length (scan frames, black edges)."""

    def __init__(self, size, distance_ratio=0.01):
        self._size = size
        self._margin = distance_ratio * max(size)

    def __call__(self, polygons):
        w, h = self._size
        m = self._margin
        out = []
        for p in polygons:
            minx, miny, maxx, maxy = p.bounds
            at_border = (minx <= m or miny <= m
                         or maxx >= w - m or maxy >= h - m)
            if at_border:
                bw = maxx - minx
                bh = maxy - miny
                bbox_area = max(bw * bh, 1e-6)
                solidity = p.area / bbox_area
                long_thin = min(bw, bh) < 3 * m and max(bw, bh) > 0.5 * max(w, h)
                if long_thin and solidity < 0.5:
                    continue
                if long_thin and (bw >= w - 2 * m or bh >= h - 2 * m):
                    continue
            out.append(p)
        return out


class EstimatePolyline:
    """Separator masks -> polylines with widths."""

    def __init__(self, orientation, simplify_tol=3.0):
        self._orientation = orientation
        self._tol = simplify_tol

    def __call__(self, mask):
        from origami_tpu_torch.core.polyline import (
            Polyline, polyline_from_graph, polyline_from_polygon)
        from origami_tpu_torch.core.skeleton import (full_mask_skeleton,
                                                     trace_skeleton)
        m = (np.asarray(mask) > 0).astype(np.uint8)
        n, labels, stats = _ct.connected_components_with_stats(m)
        if n <= 1:
            return []
        # one pass thins the whole class mask and computes the EDT;
        # components are 8-disjoint, so thinning one alone equals
        # cropping the whole mask's skeleton
        sk_full, dist_full = full_mask_skeleton(m > 0)
        out = []
        for i in range(1, n):
            if stats[i, _ct.CC_STAT_AREA] < 8:
                continue
            x0 = stats[i, _ct.CC_STAT_LEFT]
            y0 = stats[i, _ct.CC_STAT_TOP]
            cw = stats[i, _ct.CC_STAT_WIDTH]
            ch = stats[i, _ct.CC_STAT_HEIGHT]
            csel = labels[y0:y0 + ch, x0:x0 + cw] == i
            sk = np.pad(sk_full[y0:y0 + ch, x0:x0 + cw] & csel, 2)
            dist = np.pad(dist_full[y0:y0 + ch, x0:x0 + cw], 2)
            pl = polyline_from_graph(
                trace_skeleton(sk, dist=dist), self._orientation,
                self._tol)
            if pl is None:
                polys = find_contour_polygons(np.pad(csel, 2))
                if polys:
                    pl = polyline_from_polygon(
                        polys[0], self._orientation, self._tol)
            if pl is not None and not pl.is_empty:
                c = pl.np_coords + np.array([x0 - 2, y0 - 2])
                out.append(Polyline(c, pl.width))
        return out


def pipeline(*stages):
    """Compose mask->shapes stages left to right."""
    def run(x):
        for s in stages:
            x = s(x)
        return x
    return run


def multi_class_constructor(pipeline_for_label, classes):
    """Run a per-class pipeline over each label of a prediction.

    pipeline_for_label: callable(label) -> callable(mask) -> shapes.
    classes: iterable of ClassLabel. Returns callable(labels_map) ->
    {class: [shapes]}.
    """
    def run(labels):
        labels = np.asarray(labels)
        out = {}
        for c in classes:
            if c.name == "BACKGROUND":
                continue
            mask = labels == c.value
            out[c] = pipeline_for_label(c)(mask)
        return out
    return run
