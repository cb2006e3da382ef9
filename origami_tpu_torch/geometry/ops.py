"""Geometry operations: predicates, overlays, buffers, transforms.

Port of origami_tpu/geometry/ops.py. The native library is required:
where the JAX copy drops to Python when it is missing, this one raises.

Linework operations (polyline x polygon clipping, segment intersections,
distances) are exact; areal booleans route through the raster bridge.
"""

from __future__ import annotations

import numpy as np

from .poly import (
    Geometry, Point, MultiPoint, LineString, MultiLineString, LinearRing,
    Polygon, MultiPolygon, GeometryCollection, GEOMETRY_EMPTY,
    _seg_intersections, _points_to_segments_dist, _EPS, convex_hull_f32,
)
from . import raster as _raster

__all__ = [
    "intersects", "contains", "distance", "overlay", "buffer", "unary_union",
    "transform", "clip_line_to_polygon", "equals", "scale_geometry",
]

_AREAL = ("Polygon", "MultiPolygon")
_LINEAL = ("LineString", "LinearRing", "MultiLineString")
_PUNCTUAL = ("Point", "MultiPoint")


def _segments_of(geom):
    t = geom.geom_type
    if t in ("LineString", "LinearRing"):
        return geom.segments
    if t == "MultiLineString":
        segs = [l.segments for l in geom.geoms]
        return np.vstack(segs) if segs else np.zeros((0, 4))
    if t == "Polygon":
        # memoized: geometries are immutable by convention, and the
        # lines stage clips one probe per detected line against the
        # SAME text-area polygon (rebuilding the segment array was
        # ~half of _clip_line's host time)
        memo = getattr(geom, "_segs_memo", None)
        if memo is None:
            rings = [geom.exterior.segments] \
                + [h.segments for h in geom.interiors]
            memo = np.vstack(rings)
            geom._segs_memo = memo
        return memo
    if t in ("MultiPolygon", "GeometryCollection"):
        memo = getattr(geom, "_segs_memo", None)
        if memo is None:
            segs = [_segments_of(g) for g in geom.geoms]
            segs = [s for s in segs if len(s)]
            memo = np.vstack(segs) if segs else np.zeros((0, 4))
            geom._segs_memo = memo
        return memo
    if t == "Point":
        c = np.array([[geom.x, geom.y, geom.x, geom.y]])
        return c
    if t == "MultiPoint":
        c = geom._all_coords()
        return np.c_[c, c]
    return np.zeros((0, 4))


def _vertices_of(geom):
    return geom._all_coords()


def _contains_points(geom, pts):
    t = geom.geom_type
    if t in ("Polygon", "MultiPolygon"):
        return geom.contains_points(pts)
    if t == "GeometryCollection":
        out = np.zeros(len(pts), dtype=bool)
        for g in geom.geoms:
            if g.geom_type in _AREAL:
                out |= g.contains_points(pts)
        return out
    return np.zeros(len(pts), dtype=bool)


def intersects(a, b):
    ta, tb = a.geom_type, b.geom_type
    # point-in-areal fast paths
    if ta in _PUNCTUAL and tb in _AREAL:
        return bool(_contains_points(b, _vertices_of(a)).any()) or \
            _min_seg_dist(a, b) <= 1e-9
    if tb in _PUNCTUAL and ta in _AREAL:
        return intersects(b, a)
    if ta in _PUNCTUAL and tb in _PUNCTUAL:
        return _min_seg_dist(a, b) <= 1e-9

    # any vertex containment
    if tb in _AREAL and len(_vertices_of(a)):
        if _contains_points(b, _vertices_of(a)).any():
            return True
    if ta in _AREAL and len(_vertices_of(b)):
        if _contains_points(a, _vertices_of(b)).any():
            return True
    # any edge crossing
    sa = _segments_of(a)
    sb = _segments_of(b)
    if len(sa) == 0 or len(sb) == 0:
        return False
    if len(sa) * len(sb) > 4_000_000:
        # chunk to bound memory
        step = max(1, 4_000_000 // max(len(sb), 1))
        for i in range(0, len(sa), step):
            if _seg_intersections(sa[i:i + step], sb, bool_only=True):
                return True
        return False
    return _seg_intersections(sa, sb, bool_only=True)


def interiors_overlap(a, b, eps=1e-9):
    """True iff areal `a` and `b` overlap with POSITIVE area (touching
    boundaries don't count). Vectorized predicate — equivalent to
    `a.intersection(b).area > 0` but without building the overlay:
    a vertex of one strictly inside the other decides nearly every
    real layout pair; the exact intersection runs only for the rare
    boundary-contact / transversal-cross-without-vertex cases."""
    if a.is_empty or b.is_empty or a._bbox_disjoint(b):
        return False
    for p, q in ((a, b), (b, a)):
        pts = _vertices_of(p)
        if not len(pts):
            continue
        inside = _contains_points(q, pts)
        if inside.any():
            d = _points_to_segments_dist(pts[inside], _segments_of(q))
            if len(d) and (d.min(axis=1) > eps).any():
                return True
    sa, sb = _segments_of(a), _segments_of(b)
    if len(sa) == 0 or len(sb) == 0 \
            or not _seg_intersections(sa, sb, bool_only=True):
        return False
    inter = overlay(a, b, "and")
    return (not inter.is_empty) and getattr(inter, "area", 0.0) > 0


def contains(a, b):
    ta = a.geom_type
    if ta not in _AREAL and ta != "GeometryCollection":
        return False
    pts = _vertices_of(b)
    if len(pts) == 0:
        return False
    if not _contains_points(a, pts).all():
        # vertices on the boundary are OK for our purposes
        outside = ~_contains_points(a, pts)
        d = _points_to_segments_dist(pts[outside], _segments_of(a))
        if len(d) and (d.min(axis=1) > 1e-6).any():
            return False
    # no boundary crossings allowed: where b's edges intersect a's
    # boundary, tolerate touching but reject passing outside — checked
    # by sampling b's segment midpoints (inside-or-on required)
    sb = _segments_of(b)
    sa = _segments_of(a)
    if len(sb) and len(sa):
        pts_x, _, _ = _seg_intersections(sa, sb)
        if len(pts_x):
            mids = (sb[:, :2] + sb[:, 2:]) * 0.5
            ok = _contains_points(a, mids)
            if not ok.all():
                dm = _points_to_segments_dist(mids[~ok], sa)
                if len(dm) and (dm.min(axis=1) > 1e-6).any():
                    return False
    return True


def _min_seg_dist(a, b, cutoff=0.0):
    sa = _segments_of(a)
    sb = _segments_of(b)
    if len(sa) == 0 or len(sb) == 0:
        return float("inf")
    if len(sa) * len(sb) > 512:
        from .native_bindings import min_seg_dist_native
        return min_seg_dist_native(sa, sb, cutoff)
    va = np.vstack([sa[:, :2], sa[:, 2:]])
    vb = np.vstack([sb[:, :2], sb[:, 2:]])
    d1 = _points_to_segments_dist(va, sb).min() if len(vb) else np.inf
    d2 = _points_to_segments_dist(vb, sa).min() if len(va) else np.inf
    return float(min(d1, d2))


def distance(a, b):
    if a.is_empty or b.is_empty:
        return float("inf")
    if intersects(a, b):
        return 0.0
    return _min_seg_dist(a, b)


def dwithin(a, b, dist):
    """True iff distance(a, b) <= dist — with a bbox pre-check and an
    early-exiting native kernel (the adjacency graph asks this for
    every candidate region pair).

    Deliberately avoids the full intersects() test: if the boundaries
    come within `dist` the early-exiting segment-distance kernel
    answers directly (crossing boundaries have distance 0), and if
    they do not, the only remaining way to be within `dist` is full
    containment — decided by a single-vertex point-in-polygon test
    (boundaries that far apart cannot cross). The previous
    vertex-containment + all-pairs segment-intersection prelude was
    ~45% of the layout stage's host geometry time."""
    if a.is_empty or b.is_empty:
        return False
    ab, bb = a.bounds, b.bounds
    gap_x = max(bb[0] - ab[2], ab[0] - bb[2], 0.0)
    gap_y = max(bb[1] - ab[3], ab[1] - bb[3], 0.0)
    if gap_x * gap_x + gap_y * gap_y > dist * dist:
        return False
    if _min_seg_dist(a, b, cutoff=dist) <= dist:
        return True
    if a.geom_type in _AREAL or a.geom_type == "GeometryCollection":
        pts = _vertices_of(b)
        if len(pts) and _contains_points(a, pts[:1]).any():
            return True
    if b.geom_type in _AREAL or b.geom_type == "GeometryCollection":
        pts = _vertices_of(a)
        if len(pts) and _contains_points(b, pts[:1]).any():
            return True
    return False


def equals(a, b, tol=1e-9):
    if a.geom_type != b.geom_type:
        return abs(a.area - b.area) < tol and \
            a.symmetric_difference(b).area < max(a.area, b.area, 1.0) * 1e-6
    ca, cb = a._all_coords(), b._all_coords()
    if ca.shape == cb.shape and np.allclose(ca, cb, atol=tol):
        return True
    if a.geom_type in _AREAL:
        return a.symmetric_difference(b).area < max(a.area, b.area, 1.0) * 1e-6
    return False


# ---------------------------------------------------------------------------
# overlays
# ---------------------------------------------------------------------------

def overlay(a, b, op):
    if a.is_empty:
        return b if op in ("or", "xor") else GEOMETRY_EMPTY
    if b.is_empty:
        return a if op in ("or", "diff", "xor") else GEOMETRY_EMPTY
    ta, tb = a.geom_type, b.geom_type

    if op == "and" and a._bbox_disjoint(b):
        return GEOMETRY_EMPTY
    if op == "diff" and a._bbox_disjoint(b):
        return a

    # line x areal intersection — exact clipping
    if op == "and" and ta in _LINEAL and tb in _AREAL:
        return clip_line_to_polygon(a, b)
    if op == "and" and tb in _LINEAL and ta in _AREAL:
        return clip_line_to_polygon(b, a)
    # line x line intersection — points
    if op == "and" and ta in _LINEAL and tb in _LINEAL:
        pts, _, _ = _seg_intersections(_segments_of(a), _segments_of(b))
        if len(pts) == 0:
            return GEOMETRY_EMPTY
        uniq = _dedup_points(pts)
        if len(uniq) == 1:
            return Point(uniq[0])
        return MultiPoint(uniq)
    # point ops
    if ta in _PUNCTUAL or tb in _PUNCTUAL:
        return _point_overlay(a, b, op)

    # convex x convex intersection — exact Sutherland-Hodgman clipping
    # (the lines stage clips thousands of line rectangles against text
    # areas; skipping the raster path there is a large host-time win)
    if op == "and" and ta == "Polygon" and tb == "Polygon" \
            and _poly_convex(a) and _poly_convex(b):
        return _convex_clip(a, b)

    # areal x areal — exact arrangement overlay (booleans.py); the
    # raster path remains only as the fallback for inputs the exact
    # path rejects (self-intersections and other invalidities)
    if ta in _AREAL and tb in _AREAL:
        from .native_bindings import library
        library()       # a missing native library raises here, not below
        try:
            return _exact_overlay(a, b, op)
        except Exception:
            return _raster.raster_overlay(a, b, op)

    # mixed collections: recurse
    if ta == "GeometryCollection":
        parts = [overlay(g, b, op) for g in a.geoms]
        return collect(parts)
    if tb == "GeometryCollection":
        if op == "and":
            parts = [overlay(a, g, op) for g in b.geoms]
            return collect(parts)
        return _raster.raster_overlay(a, b, op)
    # line diff/union with areal — approximate with raster of thin lines
    if op == "diff" and ta in _LINEAL and tb in _AREAL:
        return _clip_line_outside_polygon(a, b)
    return _raster.raster_overlay(a, b, op)


def _areal_rings(g):
    """All rings (shells + holes) of an areal geometry, open form."""
    rings = []
    if g.geom_type == "Polygon":
        rings.append(g._shell)
        rings.extend(g._holes)
    else:
        for p in g.geoms:
            rings.extend(_areal_rings(p))
    return rings


def _exact_overlay(a, b, op):
    """Exact polygon boolean via the arrangement overlay (booleans.py
    polygon_boolean); raises on degenerate input for raster fallback."""
    from . import booleans as _bool
    polys = _bool.polygon_boolean(_areal_rings(a), _areal_rings(b), op)
    out = []
    for shell, holes in polys:
        out.append(Polygon(shell, [h for h in holes]))
    if not out:
        return GEOMETRY_EMPTY
    if len(out) == 1:
        return out[0]
    return MultiPolygon(out)


def _is_convex_ring(c):
    """True iff the open ring (n, 2) is convex (collinear points ok)."""
    if len(c) < 3:
        return False
    e = np.concatenate((c[1:], c[:1])) - c
    f = np.concatenate((e[1:], e[:1]))
    cr = e[:, 0] * f[:, 1] - e[:, 1] * f[:, 0]
    scale = max(float(np.abs(cr).max()), 1.0)
    pos = (cr > 1e-9 * scale).any()
    neg = (cr < -1e-9 * scale).any()
    return not (pos and neg)


def _poly_convex(p):
    memo = getattr(p, "_convex_memo", None)
    if memo is None:
        memo = (not p._holes) and _is_convex_ring(p._shell)
        p._convex_memo = memo
    return memo


def _sh_clip_points(subject, clip):
    """Sutherland-Hodgman clip of the `subject` ring by the CONVEX
    `clip` ring (both open (n, 2), clip must be CCW). Returns the
    output ring points — exact for convex subjects; for non-convex
    subjects the point set still traces the true intersection's
    boundary (possibly with bridge edges), so hulls/extents taken from
    it are exact."""
    out = subject
    eps = 1e-12
    for i in range(len(clip)):
        n = len(out)
        if n == 0:
            break
        p1 = clip[i]
        p2 = clip[(i + 1) % len(clip)]
        ex, ey = p2[0] - p1[0], p2[1] - p1[1]
        d = ex * (out[:, 1] - p1[1]) - ey * (out[:, 0] - p1[0])
        nxt = np.concatenate([out[1:], out[:1]])
        d2 = np.concatenate([d[1:], d[:1]])
        inside = d >= -eps
        crossing = inside != (d2 >= -eps)
        denom = np.where(crossing, d - d2, 1.0)
        ipts = out + (d / denom)[:, None] * (nxt - out)
        # interleave kept vertices with edge intersections (same order
        # as the classic per-vertex loop, but vectorized — this inner
        # loop was the lines stage's hottest host geometry)
        both = np.empty((2 * n, 2))
        both[0::2] = out
        both[1::2] = ipts
        mask = np.empty(2 * n, bool)
        mask[0::2] = inside
        mask[1::2] = crossing
        out = both[mask]
    return out


def _ccw_shell(ring):
    """Open ring in CCW orientation, or None when degenerate."""
    x, y = ring[:, 0], ring[:, 1]
    # shoelace over slice views, not np.roll (call-overhead hot spot)
    area2 = float(x[:-1] @ y[1:] - y[:-1] @ x[1:]
                  + x[-1] * y[0] - y[-1] * x[0])
    if abs(area2) < 1e-12:
        return None
    return ring[::-1] if area2 < 0 else ring


def _convex_clip(a, b):
    """Exact intersection of two convex hole-free polygons via
    Sutherland-Hodgman clipping of a's shell by b's edges. Result is a
    convex Polygon (or empty)."""
    clip = _ccw_shell(b._shell)
    if clip is None:
        return GEOMETRY_EMPTY
    out = _sh_clip_points(a._shell, clip)
    if len(out) >= 3:
        # drop near-duplicate consecutive vertices
        dup = np.linalg.norm(
            out - np.concatenate([out[-1:], out[:-1]]), axis=1) < 1e-9
        out = out[~dup]
    if len(out) < 3:
        return GEOMETRY_EMPTY
    poly = Polygon(out)
    poly._convex_memo = True
    return GEOMETRY_EMPTY if poly.area < 1e-12 else poly


def clip_hull(subject, rect):
    """convex_hull(subject ∩ rect) for a CONVEX hole-free `rect` and an
    arbitrary areal `subject`, ignoring subject holes (hull semantics:
    the hull of an intersection re-covers interior holes anyway).
    Returns a convex Polygon, or GEOMETRY_EMPTY, or None when the
    input types don't qualify (caller falls back to the exact overlay).

    This replaces `hull(intersection(...))` on the Line-polygon hot
    path (one call per detected line): the exact arrangement overlay
    costs ~0.8 ms against the obstacle-carved text areas, while one
    SH pass per shell + a hull is ~30x cheaper and hull-identical."""
    if rect.geom_type != "Polygon" or rect._holes \
            or not _poly_convex(rect):
        return None
    t = subject.geom_type
    if t == "Polygon":
        shells = [subject._shell]
    elif t == "MultiPolygon":
        shells = [p._shell for p in subject.geoms]
    else:
        return None
    if subject._bbox_disjoint(rect):
        return GEOMETRY_EMPTY
    clip = _ccw_shell(rect._shell)
    if clip is None:
        return GEOMETRY_EMPTY
    pts = [p for s in shells for p in (_sh_clip_points(s, clip),)
           if len(p)]
    if not pts:
        return GEOMETRY_EMPTY
    allpts = pts[0] if len(pts) == 1 else np.vstack(pts)
    if len(allpts) < 3:
        return GEOMETRY_EMPTY
    h = convex_hull_f32(allpts)
    if len(h) < 3:
        return GEOMETRY_EMPTY
    poly = Polygon(h)
    poly._convex_memo = True
    return poly


def _point_overlay(a, b, op):
    pa = _vertices_of(a) if a.geom_type in _PUNCTUAL else None
    if op == "and":
        pts, target = (pa, b) if pa is not None else (_vertices_of(b), a)
        if target.geom_type in _AREAL:
            keep = _contains_points(target, pts)
        else:
            d = _points_to_segments_dist(pts, _segments_of(target))
            keep = d.min(axis=1) <= 1e-9 if len(d) else np.zeros(len(pts), bool)
        sel = pts[keep]
        if len(sel) == 0:
            return GEOMETRY_EMPTY
        return Point(sel[0]) if len(sel) == 1 else MultiPoint(sel)
    if op == "or":
        return collect([a, b])
    if op == "diff":
        if pa is None:
            return a
        if b.geom_type in _AREAL:
            keep = ~_contains_points(b, pa)
        else:
            keep = np.ones(len(pa), bool)
        sel = pa[keep]
        if len(sel) == 0:
            return GEOMETRY_EMPTY
        return Point(sel[0]) if len(sel) == 1 else MultiPoint(sel)
    return GEOMETRY_EMPTY


def _dedup_points(pts, tol=1e-7):
    out = []
    for p in pts:
        if not any(np.linalg.norm(p - q) < tol for q in out):
            out.append(p)
    return out


def clip_line_to_polygon(line, poly):
    """Exact clip of a polyline (or multi) to an areal geometry."""
    if line.geom_type == "MultiLineString":
        parts = [clip_line_to_polygon(l, poly) for l in line.geoms]
        return collect(parts)
    return _clip_line(line, poly, inside=True)


def _clip_line_outside_polygon(line, poly):
    if line.geom_type == "MultiLineString":
        parts = [_clip_line_outside_polygon(l, poly) for l in line.geoms]
        return collect(parts)
    return _clip_line(line, poly, inside=False)


def _clip_line(line, poly, inside=True):
    coords = line.np_coords
    if len(coords) < 2:
        return GEOMETRY_EMPTY
    psegs = _segments_of(poly)
    pieces = []
    cur = []

    def flush():
        if len(cur) >= 2:
            pieces.append(np.array(cur))
        cur.clear()

    for i in range(len(coords) - 1):
        p0, p1 = coords[i], coords[i + 1]
        seg = np.array([[p0[0], p0[1], p1[0], p1[1]]])
        pts, _, _ = _seg_intersections(seg, psegs)
        ts = [0.0, 1.0]
        d = p1 - p0
        L2 = float(d @ d)
        if L2 > _EPS:
            for q in pts:
                ts.append(float(np.clip((q - p0) @ d / L2, 0.0, 1.0)))
        ts = sorted(set(round(t, 12) for t in ts))
        spans = [(t0, t1) for t0, t1 in zip(ts[:-1], ts[1:])
                 if t1 - t0 >= 1e-12]
        if not spans:
            continue
        # one vectorized containment call for ALL span midpoints (a
        # per-span call was ~half of extend_baseline's host time)
        mids = p0[None, :] + np.array(
            [(t0 + t1) * 0.5 for t0, t1 in spans])[:, None] * d[None, :]
        ins = _contains_points(poly, mids)
        for (t0, t1), is_in in zip(spans, ins):
            if bool(is_in) == inside:
                a = p0 + t0 * d
                b = p0 + t1 * d
                if cur and np.linalg.norm(np.array(cur[-1]) - a) < 1e-9:
                    cur.append(tuple(b))
                else:
                    flush()
                    cur.extend([tuple(a), tuple(b)])
            else:
                flush()
    flush()
    if not pieces:
        return GEOMETRY_EMPTY
    if len(pieces) == 1:
        return LineString(pieces[0])
    return MultiLineString(pieces)


# ---------------------------------------------------------------------------
# constructive ops
# ---------------------------------------------------------------------------

def _polyline_buffer_fast(coords, dist, miter_limit=2.5):
    """Exact miter-offset buffer of an open polyline: square caps,
    miter joins (bevel past `miter_limit`). Returns a simple Polygon or
    None when the offset self-intersects (sharp inner corners with
    dist > segment length) — callers fall back to the raster buffer.
    ~100x cheaper than rasterize/dilate/vectorize for the nearly
    straight linework (separators) this is hot for."""
    c = np.asarray(coords, dtype=np.float64)
    if len(c) < 2:
        return None
    d = np.diff(c, axis=0)
    ln = np.hypot(d[:, 0], d[:, 1])
    keep = ln > 1e-9
    if not keep.all():
        if not keep.any():
            return None
        c = np.vstack([c[:1], c[1:][keep]])
        d = np.diff(c, axis=0)
        ln = np.hypot(d[:, 0], d[:, 1])
    t = d / ln[:, None]
    nrm = np.c_[-t[:, 1], t[:, 0]]
    left, right = [], []
    p0 = c[0] - t[0] * dist                       # square start cap
    left.append(p0 + nrm[0] * dist)
    right.append(p0 - nrm[0] * dist)
    for i in range(1, len(t)):
        p = c[i]
        for side, out in ((1.0, left), (-1.0, right)):
            n0, n1 = side * nrm[i - 1], side * nrm[i]
            m = n0 + n1
            m2 = float(m @ m)
            if m2 < 1e-12:                        # 180-degree turn
                return None
            m = m / np.sqrt(m2)
            scale = 1.0 / max(float(m @ n1), 1e-9)
            if scale > miter_limit:               # bevel
                out.append(p + n0 * dist)
                out.append(p + n1 * dist)
            else:
                out.append(p + m * (dist * scale))
    pn = c[-1] + t[-1] * dist                     # square end cap
    left.append(pn + nrm[-1] * dist)
    right.append(pn - nrm[-1] * dist)
    poly = Polygon(np.vstack(left + right[::-1]))
    return poly if poly.is_valid else None


def buffer(geom, dist, resolution=16):
    if geom.is_empty:
        return GEOMETRY_EMPTY
    if dist == 0:
        if geom.geom_type in _AREAL:
            return make_valid(geom)
        return geom
    if dist > 0 and geom.geom_type in ("LineString", "MultiLineString"):
        parts = geom.geoms if geom.geom_type == "MultiLineString" \
            else (geom,)
        polys = [_polyline_buffer_fast(p._c, dist) for p in parts]
        if all(p is not None for p in polys):
            if len(polys) == 1:
                return polys[0]
            return MultiPolygon(polys)
    return _raster.raster_buffer(geom, dist)


def make_valid(geom):
    """Fix self-intersections/degeneracies by round-tripping via raster."""
    if geom.is_empty or geom.geom_type not in _AREAL:
        return geom
    if geom.geom_type == "Polygon" and geom.is_valid:
        return geom
    return _raster.raster_union_all([geom])


def unary_union(geoms):
    geoms = [g for g in geoms if g is not None and not g.is_empty]
    if not geoms:
        return GEOMETRY_EMPTY
    if len(geoms) == 1:
        return make_valid(geoms[0]) if geoms[0].geom_type in _AREAL else geoms[0]
    if all(g.geom_type in _LINEAL for g in geoms):
        lines = []
        for g in geoms:
            if g.geom_type == "MultiLineString":
                lines.extend(g.geoms)
            else:
                lines.append(g)
        return MultiLineString(lines)
    if all(g.geom_type in _AREAL for g in geoms):
        # exact n-ary union in ONE arrangement pass (booleans.py)
        from .native_bindings import library
        library()
        try:
            from . import booleans as _bool
            polys = _bool.union_all([_areal_rings(g) for g in geoms])
            out = [Polygon(shell, list(holes)) for shell, holes in polys]
            if not out:
                return GEOMETRY_EMPTY
            return out[0] if len(out) == 1 else MultiPolygon(out)
        except Exception:
            return _raster.raster_union_all(geoms)
    return _raster.raster_union_all(geoms)


def collect(parts):
    """Flatten a list of geometries into the tightest collection type."""
    flat = []
    for p in parts:
        if p is None or p.is_empty:
            continue
        if p.geom_type in ("MultiPolygon", "MultiLineString", "MultiPoint",
                           "GeometryCollection"):
            flat.extend(p.geoms)
        else:
            flat.append(p)
    if not flat:
        return GEOMETRY_EMPTY
    if len(flat) == 1:
        return flat[0]
    types = set(g.geom_type for g in flat)
    if types <= {"Polygon"}:
        return MultiPolygon(flat)
    if types <= {"LineString", "LinearRing"}:
        return MultiLineString(flat)
    if types <= {"Point"}:
        return MultiPoint([(g.x, g.y) for g in flat])
    return GeometryCollection(flat)


def transform(func, geom):
    """Apply ``func(xs, ys) -> (xs', ys')`` to all coordinates (shapely-style).

    ``func`` must accept vectorized numpy arrays.
    """
    def conv(c):
        if len(c) == 0:
            return c
        x, y = func(c[:, 0].copy(), c[:, 1].copy())
        return np.c_[np.asarray(x, dtype=np.float64),
                     np.asarray(y, dtype=np.float64)]

    t = geom.geom_type
    if t == "Point":
        c = conv(np.array([[geom.x, geom.y]]))
        return Point(c[0])
    if t == "MultiPoint":
        return MultiPoint(conv(geom._all_coords()))
    if t in ("LineString", "LinearRing"):
        return LineString(conv(geom.np_coords))
    if t == "MultiLineString":
        return MultiLineString([LineString(conv(l.np_coords))
                                for l in geom.geoms])
    if t == "Polygon":
        return Polygon(conv(geom.np_shell),
                       [conv(h) for h in geom.np_holes])
    if t == "MultiPolygon":
        return MultiPolygon([transform(func, p) for p in geom.geoms])
    if t == "GeometryCollection":
        return GeometryCollection([transform(func, g) for g in geom.geoms])
    return geom


def scale_geometry(geom, sx, sy, origin=(0, 0)):
    ox, oy = origin

    def f(x, y):
        return (x - ox) * sx + ox, (y - oy) * sy + oy
    return transform(f, geom)
