"""origami_tpu_torch.geometry — the port's own host geometry library.

A copy of origami_tpu/geometry (which the port may not import): geometry
value types, WKT serialization (the artifact contract), spatial indexing,
transforms, polyline clipping, exact areal booleans through the C++
library of native.cpp (built with g++ at first use) and raster-backed
buffers. It needs numpy and scipy, not cv2: the convex hull repeats
cv2.convexHull's algorithm and the raster bridge has its own fill and
contour tracer. See `poly.py` for the design notes.

Usage mirrors shapely where practical::

    from origami_tpu_torch import geometry as G
    p = G.Polygon([(0, 0), (10, 0), (10, 10), (0, 10)])
    q = G.wkt.loads("POLYGON ((5 5, 15 5, 15 15, 5 15, 5 5))")
    inter = p.intersection(q)
    tree = G.STRtree([p, q])
"""

from .poly import (
    Geometry, Point, MultiPoint, LineString, MultiLineString, LinearRing,
    Polygon, MultiPolygon, GeometryCollection, box, GEOMETRY_EMPTY,
)
from .ops import (
    unary_union, transform, collect, clip_line_to_polygon, make_valid,
    scale_geometry,
)
from .strtree import STRtree, IntervalTree
from . import wkt
from . import raster
from . import ops

__all__ = [
    "Geometry", "Point", "MultiPoint", "LineString", "MultiLineString",
    "LinearRing", "Polygon", "MultiPolygon", "GeometryCollection", "box",
    "GEOMETRY_EMPTY", "unary_union", "transform", "collect",
    "clip_line_to_polygon", "make_valid", "scale_geometry",
    "STRtree", "IntervalTree", "wkt", "raster", "ops",
]
