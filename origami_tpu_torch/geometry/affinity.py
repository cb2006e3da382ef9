"""Affine transforms over geometries (shapely.affinity-compatible API).

Port of origami_tpu/geometry/affinity.py over the port's `ops.transform`.
"""

from __future__ import annotations

import math

from . import ops as _ops

__all__ = ["affine_transform", "rotate", "scale", "translate"]


def affine_transform(geom, matrix):
    """matrix = [a, b, d, e, xoff, yoff]: x' = a x + b y + xoff, etc."""
    a, b, d, e, xoff, yoff = matrix

    def f(x, y):
        return a * x + b * y + xoff, d * x + e * y + yoff
    return _ops.transform(f, geom)


def _origin_point(geom, origin):
    if origin == "center":
        minx, miny, maxx, maxy = geom.bounds
        return (minx + maxx) / 2.0, (miny + maxy) / 2.0
    if origin == "centroid":
        c = geom.centroid
        return c.x, c.y
    if hasattr(origin, "x"):
        return origin.x, origin.y
    return tuple(origin)


def rotate(geom, angle, origin="center", use_radians=False):
    if not use_radians:
        angle = math.radians(angle)
    ox, oy = _origin_point(geom, origin)
    ca, sa = math.cos(angle), math.sin(angle)
    return affine_transform(
        geom, [ca, -sa, sa, ca,
               ox - ox * ca + oy * sa,
               oy - ox * sa - oy * ca])


def scale(geom, xfact=1.0, yfact=1.0, origin="center"):
    ox, oy = _origin_point(geom, origin)
    return affine_transform(
        geom, [xfact, 0, 0, yfact, ox - ox * xfact, oy - oy * yfact])


def translate(geom, xoff=0.0, yoff=0.0):
    return affine_transform(geom, [1, 0, 0, 1, xoff, yoff])
