"""Raster bridge: polygons <-> masks, without cv2.

Port of origami_tpu/geometry/raster.py, which fills with cv2.fillPoly,
strokes with cv2.polylines, dilates with an elliptic cv2 kernel and traces
with cv2.findContours. The port has no cv2, so it keeps the same frames,
scales and operations and does each step itself:

  * fill: cv2.fillPoly's scanline algorithm with its outline, and
    thin lines as cv2's 8-connected Bresenham lines (native C++,
    contour_trace.cpp);
  * thick strokes: pixels within half the thickness of the polyline;
  * dilate / erode: scipy.ndimage with cv2's MORPH_ELLIPSE kernel (erosion
    treats pixels outside the raster as set, as cv2 does);
  * trace: cv2's findContours (RETR_CCOMP, CHAIN_APPROX_SIMPLE) from
    contour_trace.py, vertex for vertex, each ring moved half a pixel
    outward by `_offset_ring` as in the JAX copy.

Fill, thin lines, dilation and tracing give cv2's pixels and vertices,
so make_valid, unions, overlays and polygon buffers equal the JAX
package's; only strokes thicker than one pixel (raster buffers of
linework) stay within about a raster pixel of cv2.polylines'.
"""

from __future__ import annotations

import ctypes

import numpy as np
from scipy import ndimage

from .contour_trace import contour_area, find_contours
from .native_bindings import library
from .poly import Polygon, MultiPolygon, GEOMETRY_EMPTY

# raster side-length budget for boolean ops
_MAX_SIDE = 4096.0
_MIN_SIDE = 256.0


def _pick_scale(w, h):
    side = max(w, h, 1e-6)
    scale = 1.0
    if side * scale > _MAX_SIDE:
        scale = _MAX_SIDE / side
    elif side * scale < _MIN_SIDE:
        scale = min(_MIN_SIDE / side, 32.0)
    return scale


class RasterFrame:
    """Maps a world bbox to an integer raster with some scale and margin."""

    def __init__(self, bounds, scale=None, margin=2):
        minx, miny, maxx, maxy = bounds
        w = maxx - minx
        h = maxy - miny
        if scale is None:
            scale = _pick_scale(w, h)
        self.scale = float(scale)
        self.origin = np.array([minx, miny], dtype=np.float64)
        self.margin = int(margin)
        self.width = int(np.ceil(w * self.scale)) + 2 * self.margin + 1
        self.height = int(np.ceil(h * self.scale)) + 2 * self.margin + 1

    def to_px(self, coords):
        return (np.asarray(coords, dtype=np.float64) - self.origin) \
            * self.scale + self.margin

    def to_world(self, coords):
        return (np.asarray(coords, dtype=np.float64) - self.margin) \
            / self.scale + self.origin

    def zeros(self):
        return np.zeros((self.height, self.width), dtype=np.uint8)


# ---------------------------------------------------------------------------
# drawing
# ---------------------------------------------------------------------------

def _draw_segments(mask, pts, closed, value):
    """cv2.polylines(mask, [pts], closed, value) with thickness 1: the
    8-connected Bresenham line of each segment (native C++)."""
    lib = library()
    h, w = mask.shape
    p = np.asarray(pts, dtype=np.int64)
    q = np.roll(p, -1, axis=0) if closed else p[1:]
    p = p if closed else p[:-1]
    ptr = _u8_ptr(mask)
    for (x0, y0), (x1, y1) in zip(p.tolist(), q.tolist()):
        lib.draw_line(ptr, h, w, x0, y0, x1, y1, int(value))


def _u8_ptr(mask):
    if mask.dtype != np.uint8 or not mask.flags.c_contiguous:
        raise ValueError("a C-contiguous uint8 mask is needed")
    return mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _fill_polygon(mask, pts, value):
    """cv2.fillPoly(mask, [pts], value) for one ring of integer points
    (native C++, contour_trace.cpp)."""
    h, w = mask.shape
    p = np.ascontiguousarray(pts, dtype=np.int32).reshape(-1, 2)
    library().fill_poly(_u8_ptr(mask), h, w,
                        p.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                        len(p), int(value))


def _stroke(mask, pts, thickness, value):
    """cv2.polylines(mask, [pts], False, value, thickness): pixels whose
    centre lies within thickness / 2 of the polyline."""
    h, w = mask.shape
    p = np.asarray(pts, dtype=np.float64)
    if thickness <= 1 or len(p) < 2:
        _draw_segments(mask, p.astype(np.int64), False, value)
        return
    rad = thickness / 2.0
    for a, b in zip(p[:-1], p[1:]):
        x_lo = max(int(np.floor(min(a[0], b[0]) - rad)), 0)
        x_hi = min(int(np.ceil(max(a[0], b[0]) + rad)), w - 1)
        y_lo = max(int(np.floor(min(a[1], b[1]) - rad)), 0)
        y_hi = min(int(np.ceil(max(a[1], b[1]) + rad)), h - 1)
        if x_hi < x_lo or y_hi < y_lo:
            continue
        yy, xx = np.mgrid[y_lo:y_hi + 1, x_lo:x_hi + 1].astype(np.float64)
        ab = b - a
        l2 = float(ab @ ab)
        t = np.zeros_like(xx) if l2 == 0 else np.clip(
            ((xx - a[0]) * ab[0] + (yy - a[1]) * ab[1]) / l2, 0.0, 1.0)
        d2 = (xx - a[0] - t * ab[0]) ** 2 + (yy - a[1] - t * ab[1]) ** 2
        mask[y_lo:y_hi + 1, x_lo:x_hi + 1][d2 <= rad * rad] = value


def ellipse_kernel(r):
    """cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (2r+1, 2r+1)) as bool."""
    size = 2 * r + 1
    k = np.zeros((size, size), dtype=bool)
    inv_r2 = 1.0 / (r * r) if r else 0.0
    for i in range(size):
        dy = i - r
        if abs(dy) <= r:
            dx = int(np.rint(r * np.sqrt((r * r - dy * dy) * inv_r2)))
            k[i, max(r - dx, 0):min(r + dx + 1, size)] = True
    return k


def _dilate(m, k):
    return ndimage.binary_dilation(m > 0, structure=k).astype(np.uint8)


def _erode(m, k):
    return ndimage.binary_erosion(m > 0, structure=k,
                                  border_value=1).astype(np.uint8)


def _fill_rings(mask, frame, shell, holes, value=1):
    pts = np.round(frame.to_px(shell)).astype(np.int32)
    if not holes:
        if len(pts) >= 3:
            _fill_polygon(mask, pts, int(value))
        return mask
    # holed polygon: compose shell-minus-holes in a scratch mask and
    # merge, so a hole never erases area another polygon already drew
    # into the shared mask (raster_union_all of overlapping geometries)
    tmp = np.zeros_like(mask)
    if len(pts) >= 3:
        _fill_polygon(tmp, pts, 1)
    for h in holes:
        hp = np.round(frame.to_px(h)).astype(np.int32)
        if len(hp) >= 3:
            _fill_polygon(tmp, hp, 0)
    mask[tmp > 0] = value
    return mask


def rasterize(geom, frame, mask=None, value=1, thickness=None):
    """Draw a geometry into a uint8 mask in the given frame."""
    if mask is None:
        mask = frame.zeros()
    if geom.is_empty:
        return mask
    t = geom.geom_type
    if t == "Polygon":
        _fill_rings(mask, frame, geom.np_shell, geom.np_holes, value)
    elif t == "MultiPolygon" or t == "GeometryCollection":
        for g in geom.geoms:
            rasterize(g, frame, mask, value, thickness)
    elif t in ("LineString", "LinearRing"):
        pts = np.round(frame.to_px(geom.np_coords)).astype(np.int32)
        th = max(1, int(round((thickness or 1.0) * frame.scale)))
        _stroke(mask, pts, th, int(value))
    elif t == "Point":
        p = np.round(frame.to_px([[geom.x, geom.y]])).astype(np.int32)[0]
        if 0 <= p[1] < mask.shape[0] and 0 <= p[0] < mask.shape[1]:
            mask[p[1], p[0]] = value
    elif t == "MultiPoint":
        for g in geom.geoms:
            rasterize(g, frame, mask, value, thickness)
    return mask


# ---------------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------------

def _offset_ring(c, d=0.5):
    """Offset a traced pixel-center ring outward (away from the filled
    region) by d pixels — cancels the half-pixel inward bias of contour
    tracing. Orientation-aware, so it also works for hole rings."""
    if len(c) < 3:
        return c
    seg = np.diff(np.vstack([c, c[:1]]), axis=0)
    ln = np.linalg.norm(seg, axis=1)
    ln[ln == 0] = 1.0
    n = np.c_[seg[:, 1], -seg[:, 0]] / ln[:, None]
    vn = (n + np.roll(n, 1, axis=0)) * 0.5
    vl = np.linalg.norm(vn, axis=1)
    vl[vl == 0] = 1.0
    vn = vn / vl[:, None]
    x, y = c[:, 0], c[:, 1]
    area2 = np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y)
    s = 1.0 if area2 > 0 else -1.0
    return c + s * vn * d


def vectorize(mask, frame, simplify=None, min_area_px=2.0):
    """Extract polygons (with holes) from a binary mask, in world coords:
    cv2's borders (geometry/contour_trace.py), each moved half a pixel
    outward."""
    contours, hierarchy = find_contours(mask > 0)
    if not contours:
        return GEOMETRY_EMPTY
    hierarchy = hierarchy[0]
    polys = []
    for i, cnt in enumerate(contours):
        if hierarchy[i][3] != -1:
            continue  # hole; attached below
        if contour_area(cnt) < min_area_px:
            continue
        shell = frame.to_world(
            _offset_ring(cnt.reshape(-1, 2).astype(np.float64)))
        holes = []
        child = hierarchy[i][2]
        while child != -1:
            hc = contours[child]
            if contour_area(hc) >= min_area_px:
                holes.append(frame.to_world(
                    _offset_ring(hc.reshape(-1, 2).astype(np.float64))))
            child = hierarchy[child][0]
        if len(shell) >= 3:
            p = Polygon(shell, holes)
            if simplify:
                p = p.simplify(simplify)
            polys.append(p)
    if not polys:
        return GEOMETRY_EMPTY
    if len(polys) == 1:
        return polys[0]
    return MultiPolygon(polys)


# ---------------------------------------------------------------------------
# operations
# ---------------------------------------------------------------------------

def raster_overlay(a, b, op, scale=None):
    """Boolean overlay of two areal geometries on a shared raster."""
    ab_bounds = _join_bounds(a.bounds, b.bounds)
    frame = RasterFrame(ab_bounds, scale=scale)
    ma = rasterize(a, frame)
    mb = rasterize(b, frame)
    if op == "and":
        m = ma & mb
    elif op == "or":
        m = ma | mb
    elif op == "diff":
        m = ma & (1 - mb)
    elif op == "xor":
        m = ma ^ mb
    else:
        raise ValueError(op)
    return vectorize(m, frame, simplify=0.5 / frame.scale)


def raster_union_all(geoms, scale=None):
    bounds = None
    for g in geoms:
        if g.is_empty:
            continue
        bounds = g.bounds if bounds is None else _join_bounds(bounds, g.bounds)
    if bounds is None:
        return GEOMETRY_EMPTY
    frame = RasterFrame(bounds, scale=scale)
    m = frame.zeros()
    for g in geoms:
        rasterize(g, frame, m)
    return vectorize(m, frame, simplify=0.5 / frame.scale)


def raster_buffer(geom, distance, scale=None):
    minx, miny, maxx, maxy = geom.bounds
    pad = abs(distance) + 2
    frame = RasterFrame((minx - pad, miny - pad, maxx + pad, maxy + pad),
                        scale=scale)
    m = frame.zeros()
    if geom.geom_type in ("LineString", "LinearRing", "MultiLineString",
                          "Point", "MultiPoint"):
        # positive buffer of linework: draw with stroke width 2*distance
        if distance <= 0:
            return GEOMETRY_EMPTY
        rasterize(geom, frame, m, thickness=2.0 * distance)
        # stroke the endpoints round by dilating with an ellipse of radius d
        r = max(1, int(round(distance * frame.scale)))
        m0 = frame.zeros()
        rasterize(geom, frame, m0, thickness=1.0 / frame.scale)
        m |= _dilate(m0, ellipse_kernel(r))
    else:
        rasterize(geom, frame, m)
        r = max(1, int(round(abs(distance) * frame.scale)))
        if distance > 0:
            m = _dilate(m, ellipse_kernel(r))
        elif distance < 0:
            m = _erode(m, ellipse_kernel(r))
    return vectorize(m, frame, simplify=0.5 / frame.scale)


def interior_point(poly):
    """A point inside the polygon: the maximum of its distance transform
    (exact Euclidean here; cv2's 3x3 approximation in the JAX copy)."""
    frame = RasterFrame(poly.bounds)
    m = rasterize(poly, frame)
    if not m.any():
        return None
    dist = ndimage.distance_transform_edt(m > 0)
    iy, ix = np.unravel_index(np.argmax(dist), dist.shape)
    return tuple(frame.to_world([[ix, iy]])[0])


def _join_bounds(a, b):
    return (min(a[0], b[0]), min(a[1], b[1]), max(a[2], b[2]), max(a[3], b[3]))
