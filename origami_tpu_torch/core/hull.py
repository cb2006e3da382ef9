"""Concave hulls (concaveman-style) through the C++ of native.cpp.

Port of origami_tpu/core/hull.py: `concave_hull(points, concavity,
length_threshold)` starts from the convex hull and digs in edges whose
nearest interior point is closer than edge_length / concavity (the
layout stage's "concave" hull operator). The JAX module falls back to a
numpy dig when its native library is missing or the dig returns fewer
than 3 points; the port's native build raises instead of missing, and the
port has no numpy dig: a dig of fewer than 3 points gives the convex hull
of the points, in scipy's order.
"""

from __future__ import annotations

import numpy as np

from origami_tpu_torch.geometry.native_bindings import concave_hull_native


def concave_hull(points, concavity=2.0, length_threshold=0.0):
    """Concave hull of a 2-D point set. Returns (M, 2) hull coordinates
    in order."""
    points = np.asarray(points, dtype=np.float64).reshape(-1, 2)
    points = np.unique(points, axis=0)
    if len(points) < 4:
        return points
    ring = concave_hull_native(points, concavity, length_threshold)
    if ring is None:
        import scipy.spatial
        ring = points[scipy.spatial.ConvexHull(points).vertices]
    return ring


def concave_hull_polygon(geom, concavity=2.0, length_threshold=0.0):
    """Concave hull of a geometry's vertices, unioned with the original
    shape so the hull never loses area."""
    from origami_tpu_torch import geometry as G
    pts = geom._all_coords()
    if len(pts) < 4:
        return geom.convex_hull
    ring = concave_hull(pts, concavity, length_threshold)
    if len(ring) < 3:
        return geom.convex_hull
    hull = G.Polygon(ring)
    if not hull.is_valid:
        hull = G.make_valid(hull)
    out = hull.union(geom)
    if out.geom_type == "MultiPolygon":
        out = out.convex_hull
    return out
