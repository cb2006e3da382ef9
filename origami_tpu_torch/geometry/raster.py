"""Raster bridge: polygons <-> masks, without cv2.

Port of origami_tpu/geometry/raster.py, which fills with cv2.fillPoly,
strokes with cv2.polylines, dilates with an elliptic cv2 kernel and traces
with cv2.findContours. The port has no cv2, so it keeps the same frames,
scales and operations and does each step in numpy/scipy:

  * fill: pixel centres inside the ring (even-odd scanlines), plus the
    pixels the ring's edges pass through, as cv2 fills integer polygons
    with their outline;
  * stroke: pixels within half the thickness of the polyline;
  * dilate / erode: scipy.ndimage with cv2's MORPH_ELLIPSE kernel (erosion
    treats pixels outside the raster as set, as cv2 does);
  * trace: the pixel-edge (crack) boundary of the mask, saddle corners
    joined so that diagonal pixels connect (cv2's 8-connected
    foreground), straight runs merged. The crack boundary lies half a
    pixel outside the pixel centres cv2 traces, which is where
    `_offset_ring` moves cv2's contour, so no offset is applied.

So buffers and raster overlays agree with the JAX package's in shape to
about a pixel of the raster, not vertex for vertex. The flow and dewarp
stages reach this module only for buffers of polygons (text areas of
overlapping blocks), invalid polygons and overlays the exact path rejects;
on the fixture pages they do not reach it.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

from .poly import Polygon, MultiPolygon, GEOMETRY_EMPTY, _points_in_ring

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
    """Set the pixels the segments between integer points pass through
    (one sample per pixel step along the major axis)."""
    h, w = mask.shape
    p = np.asarray(pts, dtype=np.int64)
    q = np.roll(p, -1, axis=0) if closed else p[1:]
    p = p if closed else p[:-1]
    for (x0, y0), (x1, y1) in zip(p, q):
        n = int(max(abs(x1 - x0), abs(y1 - y0))) + 1
        t = np.linspace(0.0, 1.0, n)
        xs = np.rint(x0 + t * (x1 - x0)).astype(np.int64)
        ys = np.rint(y0 + t * (y1 - y0)).astype(np.int64)
        ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
        mask[ys[ok], xs[ok]] = value


def _fill_polygon(mask, pts, value):
    """cv2.fillPoly(mask, [pts], value) for one ring of integer points:
    pixel centres inside (even-odd), plus the outline."""
    h, w = mask.shape
    p = np.asarray(pts, dtype=np.float64)
    q = np.roll(p, -1, axis=0)
    y_lo = max(int(np.floor(p[:, 1].min())), 0)
    y_hi = min(int(np.ceil(p[:, 1].max())), h - 1)
    if y_hi >= y_lo:
        ys = np.arange(y_lo, y_hi + 1, dtype=np.float64)
        x0, y0, x1, y1 = p[:, 0], p[:, 1], q[:, 0], q[:, 1]
        # half-open crossing rule: an edge covers rows min(y) <= y < max(y)
        cross = ((y0[:, None] <= ys) & (ys < y1[:, None])) \
            | ((y1[:, None] <= ys) & (ys < y0[:, None]))
        with np.errstate(divide="ignore", invalid="ignore"):
            xc = x0[:, None] + (ys - y0[:, None]) * \
                ((x1 - x0) / (y1 - y0))[:, None]
        xc = np.where(cross, xc, np.inf)
        xc.sort(axis=0)
        n = cross.sum(axis=0)
        for k in range(0, int(n.max(initial=0)), 2):
            rows = np.flatnonzero(n > k + 1)
            if not len(rows):
                break
            a = np.ceil(xc[k, rows]).astype(np.int64).clip(0, w)
            b = np.floor(xc[k + 1, rows]).astype(np.int64).clip(-1, w - 1)
            for r, xa, xb in zip(rows, a, b):
                if xb >= xa:
                    mask[y_lo + r, xa:xb + 1] = value
    _draw_segments(mask, pts, True, value)


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

# directions: 0 right, 1 down, 2 left, 3 up (x right, y down)
_DX = np.array([1, 0, -1, 0])
_DY = np.array([0, 1, 0, -1])


def _crack_rings(mask):
    """Boundary rings of a binary mask along pixel edges, each as an (n, 2)
    array of corner points in pixel coordinates (pixel (x, y) spans
    [x - 0.5, x + 0.5] x [y - 0.5, y + 0.5]). The set pixels lie on the
    left of each ring when walked on the screen (y down): outer
    boundaries run counter-clockwise on the screen, holes clockwise."""
    m = np.pad(mask > 0, 1)
    hh, ww = m.shape
    cw = ww + 1                                   # corners per row
    # horizontal cracks between m[i-1, j] and m[i, j]: on corner row i
    i, j = np.nonzero(m[:-1] != m[1:])
    i = i + 1
    up_set = m[i - 1, j]
    h_start = np.where(up_set, i * cw + j, i * cw + j + 1)
    h_dir = np.where(up_set, 0, 2)
    # vertical cracks between m[i, j-1] and m[i, j]: on corner column j
    i2, j2 = np.nonzero(m[:, :-1] != m[:, 1:])
    j2 = j2 + 1
    right_set = m[i2, j2]
    v_start = np.where(right_set, i2 * cw + j2, (i2 + 1) * cw + j2)
    v_dir = np.where(right_set, 1, 3)
    start = np.concatenate([h_start, v_start])
    direc = np.concatenate([h_dir, v_dir])
    n = len(start)
    if n == 0:
        return []
    end = start + _DX[direc] + _DY[direc] * cw
    # out-edges per corner (one, or two at a saddle)
    order = np.argsort(start, kind="stable")
    s_sorted = start[order]
    first = np.searchsorted(s_sorted, end, side="left")
    second = first + 1
    has2 = (second < n) & (s_sorted[np.minimum(second, n - 1)] == end)
    e1 = order[first]
    e2 = order[np.minimum(second, n - 1)]
    # at a saddle take the right turn, which keeps diagonal pixels joined
    turn = (direc + 1) % 4
    nxt = np.where(has2 & (direc[e2] == turn), e2, e1)
    seen = np.zeros(n, dtype=bool)
    rings = []
    for e0 in range(n):
        if seen[e0]:
            continue
        cyc = []
        e = e0
        while not seen[e]:
            seen[e] = True
            cyc.append(e)
            e = nxt[e]
        cyc = np.asarray(cyc)
        d = direc[cyc]
        # keep the corners where the direction changes
        keep = d != np.roll(d, 1)
        corners = start[cyc][keep]
        ci, cj = np.divmod(corners, cw)
        # corner (ci, cj) of the padded mask is the point (cj - 1.5,
        # ci - 1.5) of the unpadded pixel grid
        rings.append(np.c_[cj - 1.5, ci - 1.5].astype(np.float64))
    return rings


def _signed_area(c):
    x, y = c[:, 0], c[:, 1]
    return 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))


def vectorize(mask, frame, simplify=None, min_area_px=2.0):
    """Extract polygons (with holes) from a binary mask, in world coords."""
    rings = _crack_rings(mask)
    if not rings:
        return GEOMETRY_EMPTY
    # outer boundaries run counter-clockwise on the screen: negative
    # shoelace area in (x, y-down) coordinates
    shells, holes = [], []
    for r in rings:
        a = _signed_area(r)
        if abs(a) < min_area_px:
            continue
        (shells if a < 0 else holes).append((abs(a), r))
    if not shells:
        return GEOMETRY_EMPTY
    members = [[] for _ in shells]
    by_size = sorted(range(len(shells)), key=lambda k: shells[k][0])
    for _a, h in holes:
        # a point just inside the set pixels beside the hole's first
        # edge: the smallest shell around it is the hole's own
        p0, p1 = h[0], h[1]
        d = (p1 - p0) / max(np.hypot(*(p1 - p0)), 1e-12)
        probe = ((p0 + p1) / 2 + 0.25 * np.array([d[1], -d[0]]))[None]
        for k in by_size:
            if _points_in_ring(probe, shells[k][1])[0]:
                members[k].append(h)
                break
    polys = []
    for (_a, s), hs in zip(shells, members):
        p = Polygon(frame.to_world(s), [frame.to_world(h) for h in hs])
        if simplify:
            p = p.simplify(simplify)
        polys.append(p)
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
