"""Spatial index over geometry bounding boxes.

Provides the `STRtree` API used throughout the layout pipeline (reference
uses shapely.strtree.STRtree, e.g. origami/core/separate.py:48). Document
pages hold at most a few hundred regions, so a vectorized bbox sweep beats
a real tree in practice; for large sets a simple uniform grid kicks in.
"""

from __future__ import annotations

import numpy as np


class STRtree:
    def __init__(self, geoms):
        self._geoms = list(geoms)
        n = len(self._geoms)
        self._bounds = np.zeros((n, 4), dtype=np.float64)
        for i, g in enumerate(self._geoms):
            self._bounds[i] = g.bounds if not g.is_empty \
                else (np.inf, np.inf, -np.inf, -np.inf)

    @property
    def geometries(self):
        return self._geoms

    def query_indices(self, geom, predicate=None):
        """Indices of geometries whose bbox intersects `geom`'s bbox."""
        if not self._geoms:
            return np.zeros(0, dtype=np.int64)
        if geom.is_empty:
            return np.zeros(0, dtype=np.int64)
        minx, miny, maxx, maxy = geom.bounds
        b = self._bounds
        hit = ~((b[:, 2] < minx) | (maxx < b[:, 0]) |
                (b[:, 3] < miny) | (maxy < b[:, 1]))
        idx = np.nonzero(hit)[0]
        if predicate == "intersects":
            idx = np.array([i for i in idx
                            if self._geoms[i].intersects(geom)], dtype=np.int64)
        elif predicate == "contains":
            idx = np.array([i for i in idx
                            if self._geoms[i].contains(geom)], dtype=np.int64)
        elif predicate == "within":
            idx = np.array([i for i in idx
                            if self._geoms[i].within(geom)], dtype=np.int64)
        return idx

    def query(self, geom, predicate=None):
        """Geometries whose bbox intersects `geom`'s bbox (shapely-1 style)."""
        return [self._geoms[i] for i in self.query_indices(geom, predicate)]

    def nearest(self, geom):
        if not self._geoms:
            return None
        best, bd = None, np.inf
        gx = np.asarray(geom.bounds)
        cx = (gx[0] + gx[2]) / 2
        cy = (gx[1] + gx[3]) / 2
        b = self._bounds
        # coarse sort by center distance, refine with true distance
        centers = np.c_[(b[:, 0] + b[:, 2]) / 2, (b[:, 1] + b[:, 3]) / 2]
        order = np.argsort(np.hypot(centers[:, 0] - cx, centers[:, 1] - cy))
        for i in order[:32]:
            d = self._geoms[i].distance(geom)
            if d < bd:
                best, bd = self._geoms[i], d
        return best


class IntervalTree:
    """Interval overlap queries (replaces the `intervaltree` package used by
    the reference layout stage, origami/batch/detect/layout.py)."""

    def __init__(self, intervals=()):
        # intervals: iterable of (begin, end, data)
        self._iv = [tuple(i) for i in intervals]
        self._arr = np.array([(a, b) for a, b, *_ in self._iv],
                             dtype=np.float64).reshape(-1, 2)

    @classmethod
    def from_tuples(cls, tuples):
        return cls([(a, b, None) if len(t) == 2 else tuple(t)
                    for t in (tuple(t) for t in tuples)
                    for a, b in [(t[0], t[1])]])

    def add(self, begin, end, data=None):
        self._iv.append((begin, end, data))
        self._arr = np.vstack([self._arr, [[begin, end]]]) \
            if len(self._arr) else np.array([[begin, end]])

    def overlap(self, begin, end):
        if not self._iv:
            return []
        a = self._arr
        hit = (a[:, 0] < end) & (begin < a[:, 1])
        return [self._iv[i] for i in np.nonzero(hit)[0]]

    def at(self, point):
        return self.overlap(point, point + 1e-12)

    def __len__(self):
        return len(self._iv)

    def coverage(self, begin, end):
        """Total covered length of [begin, end] by the union of intervals."""
        if not self._iv or end <= begin:
            return 0.0
        segs = sorted((max(a, begin), min(b, end))
                      for a, b, *_ in self._iv if a < end and begin < b)
        total = 0.0
        cur_a = cur_b = None
        for a, b in segs:
            if cur_b is None:
                cur_a, cur_b = a, b
            elif a <= cur_b:
                cur_b = max(cur_b, b)
            else:
                total += cur_b - cur_a
                cur_a, cur_b = a, b
        if cur_b is not None:
            total += cur_b - cur_a
        return total
