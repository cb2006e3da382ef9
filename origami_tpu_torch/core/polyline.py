"""Polyline value type + estimation from masks via skeleton graphs.

Port of origami_tpu/core/polyline.py: the longest path through a
separator's skeleton graph, biased along the separator's direction, as a
Polyline value carrying the stroke width; a slice-centroid fallback for
thin polygons.
"""

from __future__ import annotations

import math

import numpy as np

from origami_tpu_torch import geometry as G
from origami_tpu_torch.core.math import Orientation


class Polyline:
    def __init__(self, coords, width=1.0, error=0.0):
        self._line = G.LineString(coords)
        self._width = float(width)
        self._error = float(error)

    @property
    def line_string(self):
        return self._line

    @property
    def coords(self):
        return self._line.coords

    @property
    def np_coords(self):
        return self._line.np_coords

    @property
    def width(self):
        return self._width

    @property
    def error(self):
        """Fit residual of the estimation this polyline came from (mean
        source-pixel distance, normalized by stroke width); 0 when built
        directly from coordinates."""
        return self._error

    @property
    def is_empty(self):
        return self._line.is_empty

    def simplify(self, tolerance):
        return Polyline(self._line.simplify(tolerance).np_coords,
                        self._width, self._error)

    def oriented(self, orientation):
        """Ensure coordinates progress along the given orientation."""
        c = self._line.np_coords
        if len(c) < 2:
            return self
        d = c[-1] - c[0]
        axis = 0 if orientation == Orientation.H else 1
        if d[axis] < 0:
            return Polyline(c[::-1], self._width, self._error)
        return self

    @property
    def centroid(self):
        return self._line.centroid

    def extended(self, amount):
        """Extend both ends along their end directions by `amount` px."""
        c = self._line.np_coords
        if len(c) < 2 or amount <= 0:
            return self
        d0 = c[0] - c[1]
        d1 = c[-1] - c[-2]
        n0 = np.linalg.norm(d0)
        n1 = np.linalg.norm(d1)
        head = c[0] + d0 / n0 * amount if n0 > 1e-9 else c[0]
        tail = c[-1] + d1 / n1 * amount if n1 > 1e-9 else c[-1]
        return Polyline(np.vstack([head, c, tail]), self._width,
                        self._error)

    def mapped(self, func):
        """Apply a vectorized (xs, ys) -> (xs', ys') coordinate map."""
        c = self._line.np_coords
        xs, ys = func(c[:, 0], c[:, 1])
        return Polyline(np.stack([xs, ys], axis=-1), self._width,
                        self._error)


def estimate_polyline(mask, orientation, simplify_tol=3.0):
    """Estimate the dominant polyline of a separator mask.

    Thins the mask (native C++), traces the skeleton graph, and extracts
    the longest path biased toward the separator's orientation.
    Returns a Polyline or None.
    """
    from origami_tpu_torch.core.skeleton import FastSkeleton
    graph = FastSkeleton()(mask)
    return polyline_from_graph(graph, orientation, simplify_tol)


def polyline_from_graph(graph, orientation, simplify_tol=3.0):
    """Dominant polyline of an already-traced SkeletonGraph (callers
    that thin a whole class mask in one pass trace each component and
    come here)."""
    direction = orientation.direction
    path = graph.longest_path(direction=direction)
    if path is None or len(path) < 2:
        return None
    pl = Polyline(path, width=graph.mean_width)
    if simplify_tol:
        pl = pl.simplify(simplify_tol)
    return pl.oriented(orientation)


def polyline_from_polygon(polygon, orientation, simplify_tol=3.0):
    """Fallback: centerline of a thin polygon by sweeping its extent along
    the orientation axis and taking per-slice centroids."""
    minx, miny, maxx, maxy = polygon.bounds
    axis = 0 if orientation == Orientation.H else 1
    lo = [minx, miny][axis]
    hi = [maxx, maxy][axis]
    n = max(2, int((hi - lo) / 5.0))
    pts = []
    for t in np.linspace(lo, hi, n):
        if axis == 0:
            probe = G.LineString([(t, miny - 1), (t, maxy + 1)])
        else:
            probe = G.LineString([(minx - 1, t), (maxx + 1, t)])
        inter = probe.intersection(polygon)
        if inter.is_empty:
            continue
        c = inter.centroid
        pts.append((c.x, c.y))
    if len(pts) < 2:
        return None
    width = polygon.area / max(hi - lo, 1e-6)
    pl = Polyline(pts, width=width)
    if simplify_tol:
        pl = pl.simplify(simplify_tol)
    return pl.oriented(orientation)
