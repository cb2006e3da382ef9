"""Host geometry primitives (port of origami_tpu/geometry/poly.py).

A self-contained, numpy-backed geometry library exposing a shapely-like
API (Polygon, LineString, STRtree, WKT, affine ops). The reference framework
(poke1024/origami) leans on shapely/CGAL/boost for all vector geometry; this
module provides the equivalent capability without those dependencies:

  * exact predicates and linework ops implemented directly on numpy arrays
    (point-in-polygon, segment intersection, polyline clipping, Douglas-
    Peucker simplification, convex hulls);
  * exact *area* booleans (intersection/union/difference of polygons)
    through the arrangement overlay of booleans.py / native.cpp, and
    raster-backed buffers (raster.py) — resolution-adaptive, which is the
    right trade-off for a document-imaging pipeline whose coordinates are
    pixels to begin with.

Coordinates are float64 ``(N, 2)`` arrays in page-pixel space.
"""

from __future__ import annotations

import math
import numpy as np

__all__ = [
    "Geometry", "Point", "MultiPoint", "LineString", "MultiLineString",
    "LinearRing", "Polygon", "MultiPolygon", "GeometryCollection",
    "box", "GEOMETRY_EMPTY",
]


_EPS = 1e-12


def _as_coords(coords):
    a = np.asarray(coords, dtype=np.float64)
    if a.ndim == 1:
        a = a.reshape(-1, 2)
    if a.ndim != 2 or (a.size and a.shape[1] < 2):
        raise ValueError("coordinates must be (N, 2)-shaped, got %r" % (a.shape,))
    return a[:, :2] if a.size else a.reshape(0, 2)


def _ring_area(c):
    """Signed area of a closed ring (shoelace). Positive = CCW in y-up frames."""
    if len(c) < 3:
        return 0.0
    x, y = c[:, 0], c[:, 1]
    # shoelace over slice views (np.roll on small rings is ~25 us of
    # pure call overhead; these run 10^4+ times per page batch)
    s = float(x[:-1] @ y[1:] - y[:-1] @ x[1:])
    return 0.5 * (s + float(x[-1] * y[0] - y[-1] * x[0]))


def _close_ring(c):
    if len(c) and not np.array_equal(c[0], c[-1]):
        return np.vstack([c, c[:1]])
    return c


def _open_ring(c):
    if len(c) > 1 and np.array_equal(c[0], c[-1]):
        return c[:-1]
    return c


def _points_in_ring(points, ring):
    """Vectorized even-odd point-in-polygon for one ring (open coords)."""
    if len(ring) < 3:
        return np.zeros(len(points), dtype=bool)
    x = points[:, 0][:, None]
    y = points[:, 1][:, None]
    x0, y0 = ring[:, 0][None, :], ring[:, 1][None, :]
    x1 = np.concatenate((ring[1:, 0], ring[:1, 0]))[None, :]
    y1 = np.concatenate((ring[1:, 1], ring[:1, 1]))[None, :]
    cond = (y0 <= y) != (y1 <= y)
    denom = y1 - y0
    denom = np.where(np.abs(denom) < _EPS, _EPS, denom)
    xin = x0 + (y - y0) * (x1 - x0) / denom
    crossings = cond & (x < xin)
    return (np.count_nonzero(crossings, axis=1) % 2) == 1


def _points_on_ring(points, ring, tol=1e-9):
    """True where a point lies on the ring boundary (within tol)."""
    if len(ring) < 2:
        return np.zeros(len(points), dtype=bool)
    d = _points_to_segments_dist(
        points, np.c_[ring, np.concatenate((ring[1:], ring[:1]))])
    return d.min(axis=1) <= tol


def _points_to_segments_dist(points, segs):
    """Distance from each point to each segment. segs: (M,4) [x0 y0 x1 y1]."""
    p = points[:, None, :]                      # (N,1,2)
    a = segs[None, :, :2]                       # (1,M,2)
    b = segs[None, :, 2:]                       # (1,M,2)
    ab = b - a
    denom = np.sum(ab * ab, axis=2)
    denom = np.where(denom < _EPS, 1.0, denom)
    t = np.clip(np.sum((p - a) * ab, axis=2) / denom, 0.0, 1.0)
    proj = a + t[..., None] * ab
    return np.linalg.norm(p - proj, axis=2)


def _seg_intersections(segs_a, segs_b, *, bool_only=False):
    """All proper+touching intersections between two segment sets.

    segs_*: (N,4) arrays [x0,y0,x1,y1]. Returns (pts, ia, ib) or a bool.
    """
    a0 = segs_a[:, None, 0:2]
    a1 = segs_a[:, None, 2:4]
    b0 = segs_b[None, :, 0:2]
    b1 = segs_b[None, :, 2:4]
    r = a1 - a0
    s = b1 - b0
    denom = r[..., 0] * s[..., 1] - r[..., 1] * s[..., 0]
    qp = b0 - a0
    t_num = qp[..., 0] * s[..., 1] - qp[..., 1] * s[..., 0]
    u_num = qp[..., 0] * r[..., 1] - qp[..., 1] * r[..., 0]
    nonpar = np.abs(denom) > _EPS
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.where(nonpar, t_num / np.where(nonpar, denom, 1.0), np.nan)
        u = np.where(nonpar, u_num / np.where(nonpar, denom, 1.0), np.nan)
    tol = 1e-9
    hit = nonpar & (t >= -tol) & (t <= 1 + tol) & (u >= -tol) & (u <= 1 + tol)

    # collinear overlap counts as intersecting for the boolean predicate
    if bool_only:
        if hit.any():
            return True
        # parallel AND collinear: both cross products must vanish —
        # t_num alone is identically 0 for degenerate (point) segments,
        # which made any point projecting onto a segment "intersect" it
        # regardless of its perpendicular offset
        par = ~nonpar & (np.abs(t_num) < 1e-9) & (np.abs(u_num) < 1e-9)
        if par.any():
            ia, ib = np.nonzero(par)
            for i, j in zip(ia[:256], ib[:256]):
                p0, p1 = segs_a[i, :2], segs_a[i, 2:]
                q0, q1 = segs_b[j, :2], segs_b[j, 2:]
                d = p1 - p0
                L = float(d @ d)
                if L < _EPS:
                    # a is degenerate: parametrize along b instead
                    d = q1 - q0
                    L = float(d @ d)
                    if L < _EPS:
                        dp = p0 - q0
                        if float(dp @ dp) < _EPS:
                            return True
                        continue
                    p0, p1, q0, q1 = q0, q1, p0, p1
                t0 = float((q0 - p0) @ d) / L
                t1 = float((q1 - p0) @ d) / L
                if max(min(t0, t1), 0.0) <= min(max(t0, t1), 1.0) + 1e-9:
                    return True
        return False

    ia, ib = np.nonzero(hit)
    pts = a0[ia, 0] + t[ia, ib][:, None] * r[ia, 0]
    return pts, ia, ib


class Geometry:
    """Base class of all geometry values. Immutable by convention."""

    geom_type = "Geometry"
    _bounds = None

    # -- basic properties --------------------------------------------------
    @property
    def is_empty(self):
        return False

    @property
    def bounds(self):
        if self._bounds is None:
            c = self._all_coords()
            if len(c) == 0:
                self._bounds = (0.0, 0.0, 0.0, 0.0)
            else:
                self._bounds = (float(c[:, 0].min()), float(c[:, 1].min()),
                                float(c[:, 0].max()), float(c[:, 1].max()))
        return self._bounds

    @property
    def area(self):
        return 0.0

    @property
    def length(self):
        return 0.0

    @property
    def is_valid(self):
        return True

    @property
    def envelope(self):
        minx, miny, maxx, maxy = self.bounds
        return box(minx, miny, maxx, maxy)

    @property
    def convex_hull(self):
        c = self._all_coords()
        if len(c) == 0:
            return GEOMETRY_EMPTY
        if len(c) == 1:
            return Point(c[0])
        if len(c) == 2:
            return LineString(c)
        h = convex_hull_f32(c)
        if len(h) < 3:
            return LineString(c)
        return Polygon(h)

    @property
    def centroid(self):
        c = self._all_coords()
        if len(c) == 0:
            return Point(0.0, 0.0)
        return Point(float(c[:, 0].mean()), float(c[:, 1].mean()))

    def _all_coords(self):
        raise NotImplementedError

    # -- generic predicates (overridden where cheaper) ---------------------
    def _bbox_disjoint(self, other):
        a = self.bounds
        b = other.bounds
        return a[2] < b[0] or b[2] < a[0] or a[3] < b[1] or b[3] < a[1]

    def intersects(self, other):
        if self.is_empty or other.is_empty or self._bbox_disjoint(other):
            return False
        from . import ops as _ops
        return _ops.intersects(self, other)

    def contains(self, other):
        if self.is_empty or other.is_empty:
            return False
        from . import ops as _ops
        return _ops.contains(self, other)

    def within(self, other):
        return other.contains(self)

    def overlaps(self, other):
        return (self.intersects(other) and not self.contains(other)
                and not other.contains(self))

    def touches(self, other):
        if not self.intersects(other):
            return False
        inter = self.intersection(other)
        return inter.area < _EPS

    def disjoint(self, other):
        return not self.intersects(other)

    def distance(self, other):
        from . import ops as _ops
        return _ops.distance(self, other)

    def equals(self, other):
        from . import ops as _ops
        return _ops.equals(self, other)

    # -- overlays ----------------------------------------------------------
    def intersection(self, other):
        from . import ops as _ops
        return _ops.overlay(self, other, "and")

    def union(self, other):
        from . import ops as _ops
        return _ops.overlay(self, other, "or")

    def difference(self, other):
        from . import ops as _ops
        return _ops.overlay(self, other, "diff")

    def symmetric_difference(self, other):
        from . import ops as _ops
        return _ops.overlay(self, other, "xor")

    def buffer(self, distance, resolution=16, **kwargs):
        from . import ops as _ops
        return _ops.buffer(self, distance, resolution=resolution)

    def simplify(self, tolerance, preserve_topology=True):
        return self

    # -- misc --------------------------------------------------------------
    @property
    def wkt(self):
        from . import wkt as _wkt
        return _wkt.dumps(self)

    def representative_point(self):
        return self.centroid

    def __repr__(self):
        w = self.wkt
        if len(w) > 120:
            w = w[:117] + "..."
        return "<%s %s>" % (self.geom_type, w)

    def __bool__(self):
        return not self.is_empty


class _Empty(Geometry):
    geom_type = "GeometryCollection"

    @property
    def is_empty(self):
        return True

    def _all_coords(self):
        return np.zeros((0, 2))

    @property
    def geoms(self):
        return ()

    def intersects(self, other):
        return False

    def intersection(self, other):
        return self

    def union(self, other):
        return other

    def difference(self, other):
        return self

    def buffer(self, distance, **kwargs):
        return self


GEOMETRY_EMPTY = _Empty()


class Point(Geometry):
    geom_type = "Point"

    def __init__(self, *args):
        if len(args) == 1:
            a = np.asarray(args[0], dtype=np.float64).reshape(-1)
        else:
            a = np.asarray(args, dtype=np.float64).reshape(-1)
        self._c = a[:2].copy()

    @property
    def x(self):
        return float(self._c[0])

    @property
    def y(self):
        return float(self._c[1])

    @property
    def coords(self):
        return [tuple(self._c)]

    def _all_coords(self):
        return self._c.reshape(1, 2)

    @property
    def centroid(self):
        return self

    @property
    def is_empty(self):
        return bool(np.any(np.isnan(self._c)))


class MultiPoint(Geometry):
    geom_type = "MultiPoint"

    def __init__(self, points):
        self._pts = [p if isinstance(p, Point) else Point(p) for p in points]

    @property
    def geoms(self):
        return tuple(self._pts)

    @property
    def is_empty(self):
        return len(self._pts) == 0

    def _all_coords(self):
        if not self._pts:
            return np.zeros((0, 2))
        return np.stack([p._c for p in self._pts])


class LineString(Geometry):
    geom_type = "LineString"

    def __init__(self, coords):
        self._c = _as_coords(coords)

    @property
    def coords(self):
        return [tuple(p) for p in self._c]

    @property
    def np_coords(self):
        """Coordinates as a float64 (N, 2) numpy array (origami extension)."""
        return self._c

    def _all_coords(self):
        return self._c

    @property
    def is_empty(self):
        return len(self._c) < 2

    @property
    def length(self):
        if len(self._c) < 2:
            return 0.0
        return float(np.sum(np.linalg.norm(np.diff(self._c, axis=0), axis=1)))

    @property
    def segments(self):
        """(N-1, 4) array of [x0, y0, x1, y1]."""
        return np.c_[self._c[:-1], self._c[1:]]

    def interpolate(self, dist, normalized=False):
        seg = np.diff(self._c, axis=0)
        lens = np.linalg.norm(seg, axis=1)
        total = lens.sum()
        if normalized:
            dist = dist * total
        dist = min(max(dist, 0.0), total)
        cum = np.concatenate([[0.0], np.cumsum(lens)])
        i = int(np.searchsorted(cum, dist, side="right") - 1)
        i = min(i, len(lens) - 1)
        denom = lens[i] if lens[i] > _EPS else 1.0
        t = (dist - cum[i]) / denom
        p = self._c[i] + t * seg[i]
        return Point(p)

    def project(self, point, normalized=False):
        """Arc-length of the closest point on the line to `point`."""
        p = np.asarray([point.x, point.y])
        seg = np.diff(self._c, axis=0)
        lens = np.linalg.norm(seg, axis=1)
        denom = np.where(lens < _EPS, 1.0, lens) ** 2
        t = np.clip(np.sum((p - self._c[:-1]) * seg, axis=1) / denom, 0, 1)
        proj = self._c[:-1] + t[:, None] * seg
        d = np.linalg.norm(proj - p, axis=1)
        i = int(np.argmin(d))
        cum = np.concatenate([[0.0], np.cumsum(lens)])
        s = cum[i] + t[i] * lens[i]
        if normalized:
            total = lens.sum()
            return float(s / total) if total > 0 else 0.0
        return float(s)

    def substring(self, start, end, normalized=False):
        """The sub-line between two arc lengths along this line."""
        seg = np.diff(self._c, axis=0)
        lens = np.linalg.norm(seg, axis=1)
        total = float(lens.sum())
        if normalized:
            start, end = start * total, end * total
        start = min(max(float(start), 0.0), total)
        end = min(max(float(end), 0.0), total)
        if end < start:
            start, end = end, start
        cum = np.concatenate([[0.0], np.cumsum(lens)])

        def at(dist):
            i = int(np.searchsorted(cum, dist, side="right") - 1)
            i = min(max(i, 0), len(lens) - 1)
            denom = lens[i] if lens[i] > _EPS else 1.0
            t = (dist - cum[i]) / denom
            return self._c[i] + t * seg[i], i

        p0, i0 = at(start)
        p1, i1 = at(end)
        mid = self._c[i0 + 1: i1 + 1]
        pts = np.vstack([[p0], mid, [p1]])
        # drop consecutive duplicates
        keep = np.ones(len(pts), bool)
        keep[1:] = np.linalg.norm(np.diff(pts, axis=0), axis=1) > _EPS
        pts = pts[keep]
        if len(pts) < 2:
            pts = np.vstack([p0, p1])
        return LineString(pts)

    def simplify(self, tolerance, preserve_topology=True):
        return LineString(_douglas_peucker(self._c, tolerance))

    def parallel_offset(self, distance, side="left"):
        """Offset polyline by distance; 'left' is to the left of travel."""
        c = self._c
        if len(c) < 2:
            return LineString(c)
        seg = np.diff(c, axis=0)
        ln = np.linalg.norm(seg, axis=1)
        ln = np.where(ln < _EPS, 1.0, ln)
        n = np.c_[-seg[:, 1], seg[:, 0]] / ln[:, None]
        if side == "right":
            n = -n
        # per-vertex normal = mean of adjacent segment normals
        vn = np.vstack([n[:1], (n[:-1] + n[1:]) * 0.5, n[-1:]])
        vln = np.linalg.norm(vn, axis=1)
        vn = vn / np.where(vln < _EPS, 1.0, vln)[:, None]
        return LineString(c + vn * distance)

    @property
    def centroid(self):
        seg = np.diff(self._c, axis=0)
        lens = np.linalg.norm(seg, axis=1)
        if lens.sum() < _EPS:
            return Point(self._c.mean(axis=0))
        mids = (self._c[:-1] + self._c[1:]) * 0.5
        w = lens / lens.sum()
        return Point((mids * w[:, None]).sum(axis=0))


class LinearRing(LineString):
    geom_type = "LinearRing"

    def __init__(self, coords):
        c = _as_coords(coords)
        super().__init__(_close_ring(c))


class MultiLineString(Geometry):
    geom_type = "MultiLineString"

    def __init__(self, lines):
        self._lines = [l if isinstance(l, LineString) else LineString(l)
                       for l in lines]
        self._lines = [l for l in self._lines if not l.is_empty]

    @property
    def geoms(self):
        return tuple(self._lines)

    @property
    def is_empty(self):
        return len(self._lines) == 0

    @property
    def length(self):
        return sum(l.length for l in self._lines)

    def _all_coords(self):
        if not self._lines:
            return np.zeros((0, 2))
        return np.vstack([l._c for l in self._lines])


class Polygon(Geometry):
    geom_type = "Polygon"

    def __init__(self, shell=None, holes=None):
        if shell is None:
            self._shell = np.zeros((0, 2))
        elif isinstance(shell, (LineString,)):
            self._shell = _open_ring(shell._c)
        else:
            self._shell = _open_ring(_as_coords(shell))
        self._holes = []
        for h in (holes or []):
            hc = _open_ring(h._c if isinstance(h, LineString) else _as_coords(h))
            if len(hc) >= 3:
                self._holes.append(hc)

    @property
    def exterior(self):
        return LinearRing(self._shell)

    @property
    def interiors(self):
        return [LinearRing(h) for h in self._holes]

    @property
    def np_shell(self):
        return self._shell

    @property
    def np_holes(self):
        return self._holes

    @property
    def is_empty(self):
        return len(self._shell) < 3

    def _all_coords(self):
        if self.is_empty:
            return self._shell
        if self._holes:
            return np.vstack([self._shell] + self._holes)
        return self._shell

    @property
    def area(self):
        a = abs(_ring_area(self._shell))
        for h in self._holes:
            a -= abs(_ring_area(h))
        return max(a, 0.0)

    @property
    def length(self):
        tot = LinearRing(self._shell).length
        for h in self._holes:
            tot += LinearRing(h).length
        return tot

    @property
    def centroid(self):
        if self.is_empty:
            return Point(0.0, 0.0)
        cx = cy = aa = 0.0
        for ring, sign in [(self._shell, 1.0)] + [(h, -1.0) for h in self._holes]:
            c = ring
            x, y = c[:, 0], c[:, 1]
            x1 = np.concatenate((x[1:], x[:1]))
            y1 = np.concatenate((y[1:], y[:1]))
            cross = x * y1 - x1 * y
            a = 0.5 * cross.sum()
            if abs(a) < _EPS:
                continue
            cx += sign * float(np.sum((x + x1) * cross)) / 6.0
            cy += sign * float(np.sum((y + y1) * cross)) / 6.0
            aa += sign * a
        if abs(aa) < _EPS:
            return Point(self._shell.mean(axis=0))
        return Point(cx / aa, cy / aa)

    @property
    def is_valid(self):
        """Simple-polygon check: no self intersections among shell
        edges. Memoized — geometries are immutable by convention and
        layout asks repeatedly."""
        memo = getattr(self, "_valid_memo", None)
        if memo is not None:
            return memo
        c = self._shell
        if len(c) < 3:
            memo = False
        elif len(c) > 512:
            memo = True  # too expensive; assume fixed upstream
        else:
            segs = np.c_[c, np.concatenate((c[1:], c[:1]))]
            n = len(segs)
            memo = True
            pts, ia, ib = _seg_intersections(segs, segs)
            for i, j in zip(ia, ib):
                if i == j or (i + 1) % n == j or (j + 1) % n == i:
                    continue
                memo = False
                break
        self._valid_memo = memo
        return memo

    def contains_points(self, points):
        """Vectorized containment for an (N,2) array of points."""
        points = np.asarray(points, dtype=np.float64).reshape(-1, 2)
        inside = _points_in_ring(points, self._shell)
        for h in self._holes:
            inside &= ~_points_in_ring(points, h)
        return inside

    def representative_point(self):
        c = self.centroid
        if self.contains_points([[c.x, c.y]])[0]:
            return c
        from .raster import interior_point
        p = interior_point(self)
        return Point(p) if p is not None else c

    def simplify(self, tolerance, preserve_topology=True):
        shell = _douglas_peucker_ring(self._shell, tolerance)
        if len(shell) < 3:
            return self
        holes = [h2 for h2 in
                 (_douglas_peucker_ring(h, tolerance) for h in self._holes)
                 if len(h2) >= 3]
        return Polygon(shell, holes)

    @property
    def geoms(self):
        return (self,)


class MultiPolygon(Geometry):
    geom_type = "MultiPolygon"

    def __init__(self, polys):
        out = []
        for p in polys:
            if isinstance(p, MultiPolygon):
                out.extend(p.geoms)
            elif isinstance(p, Polygon):
                if not p.is_empty:
                    out.append(p)
            else:
                q = Polygon(p)
                if not q.is_empty:
                    out.append(q)
        self._polys = out

    @property
    def geoms(self):
        return tuple(self._polys)

    @property
    def is_empty(self):
        return len(self._polys) == 0

    @property
    def area(self):
        return sum(p.area for p in self._polys)

    @property
    def length(self):
        return sum(p.length for p in self._polys)

    def _all_coords(self):
        if not self._polys:
            return np.zeros((0, 2))
        return np.vstack([p._all_coords() for p in self._polys])

    @property
    def centroid(self):
        if self.is_empty:
            return Point(0.0, 0.0)
        areas = np.array([max(p.area, _EPS) for p in self._polys])
        cents = np.array([[p.centroid.x, p.centroid.y] for p in self._polys])
        w = areas / areas.sum()
        c = (cents * w[:, None]).sum(axis=0)
        return Point(c)

    def contains_points(self, points):
        points = np.asarray(points, dtype=np.float64).reshape(-1, 2)
        out = np.zeros(len(points), dtype=bool)
        for p in self._polys:
            out |= p.contains_points(points)
        return out

    def representative_point(self):
        if self.is_empty:
            return Point(0.0, 0.0)
        big = max(self._polys, key=lambda p: p.area)
        return big.representative_point()

    def simplify(self, tolerance, preserve_topology=True):
        return MultiPolygon([p.simplify(tolerance) for p in self._polys])


class GeometryCollection(Geometry):
    geom_type = "GeometryCollection"

    def __init__(self, geoms=()):
        self._geoms = [g for g in geoms if g is not None and not g.is_empty]

    @property
    def geoms(self):
        return tuple(self._geoms)

    @property
    def is_empty(self):
        return len(self._geoms) == 0

    @property
    def area(self):
        return sum(g.area for g in self._geoms)

    def _all_coords(self):
        if not self._geoms:
            return np.zeros((0, 2))
        return np.vstack([g._all_coords() for g in self._geoms])


def box(minx, miny, maxx, maxy):
    return Polygon([(minx, miny), (maxx, miny), (maxx, maxy), (minx, maxy)])


# ---------------------------------------------------------------------------
# simplification
# ---------------------------------------------------------------------------

def _douglas_peucker(coords, tol):
    c = np.asarray(coords, dtype=np.float64)
    n = len(c)
    if n < 3:
        return c
    from .native_bindings import douglas_peucker_native
    return c[douglas_peucker_native(c, tol)]


def _douglas_peucker_ring(ring, tol):
    c = np.asarray(ring, dtype=np.float64)
    if len(c) < 4:
        return c
    # split at the two farthest-apart vertices to make two open chains
    i0 = 0
    d = np.linalg.norm(c - c[i0], axis=1)
    i1 = int(np.argmax(d))
    if i1 == 0:
        return c
    part1 = _douglas_peucker(c[: i1 + 1], tol)
    part2 = _douglas_peucker(np.vstack([c[i1:], c[:1]]), tol)
    return np.vstack([part1[:-1], part2[:-1]])


# ---------------------------------------------------------------------------
# convex hull (cv2.convexHull's algorithm, without cv2)
# ---------------------------------------------------------------------------

def _sign(v):
    return int(v > 0) - int(v < 0)


def _unit(x, y):
    """OpenCV's normalize() of a difference vector taken in float32: the
    norm and the scaling in double, each component rounded to float32."""
    xd, yd = float(np.float32(x)), float(np.float32(y))
    n = math.sqrt(xd * xd + yd * yd)
    inv = 1.0 / n if n != 0 else 0.0
    return float(np.float32(xd * inv)), float(np.float32(yd * inv))


def _sklansky(px, py, order, start, end, nsign, sign2, is_float):
    """OpenCV's Sklansky_ over the (x, y)-sorted point order; returns the
    hull chain as positions in `order`. Integer points take exact
    differences and products; float32 points (cv2 >= 5) take the float32
    differences, normalize both to unit length and take the double cross
    product of the normalized vectors."""
    incr = 1 if end > start else -1
    pprev, pcur, pnext = start, start + incr, start + 2 * incr
    a, b = order[start], order[end]
    if start == end or (px[a] == px[b] and py[a] == py[b]):
        return [start]
    stack = [pprev, pcur, pnext]
    end += incr
    while pnext != end:
        cury = py[order[pcur]]
        nexty = py[order[pnext]]
        by = nexty - cury
        if _sign(by) != nsign:
            ax = px[order[pcur]] - px[order[pprev]]
            bx = px[order[pnext]] - px[order[pcur]]
            ay = cury - py[order[pprev]]
            if is_float:
                ax, ay = _unit(ax, ay)
                bx, by = _unit(bx, by)
            convexity = ay * bx - ax * by
            if _sign(convexity) == sign2 and (ax != 0 or ay != 0):
                pprev, pcur = pcur, pnext
                pnext += incr
                stack.append(pnext)
            elif pprev == start:
                pcur = pnext
                stack[1] = pcur
                pnext += incr
                stack[2] = pnext
            else:
                stack[-2] = pnext
                pcur = pprev
                pprev = stack[-4]
                stack.pop()
        else:
            pnext += incr
            stack[-1] = pnext
    return stack[:-1]


def convex_hull_indices(points):
    """Indices of the convex hull of (n, 2) points, in the order
    cv2.convexHull(points) (clockwise=False) returns them: Sklansky's
    scan over the x-sorted points, then the cyclic shift that makes the
    indices ascend or descend where it can. Integer points are taken as
    int32 (exact arithmetic, as cv2 takes an int32 contour), all others as
    float32 (cv2's normalized float scan), so near-collinear sets keep the
    points cv2 keeps (tests/test_torch_geometry.py)."""
    pts = np.asarray(points)
    is_float = not np.issubdtype(pts.dtype, np.integer)
    pts = pts.astype(np.float32 if is_float else np.int32).reshape(-1, 2)
    total = len(pts)
    if total == 0:
        return []
    # python scalars: float32 differences are exact in double, integer
    # differences and products exact as python ints
    if is_float:
        px = pts[:, 0].astype(np.float64).tolist()
        py = pts[:, 1].astype(np.float64).tolist()
    else:
        px, py = pts[:, 0].tolist(), pts[:, 1].tolist()
    order = np.lexsort((pts[:, 1], pts[:, 0])).tolist()
    miny = maxy = 0
    for i in range(1, total):
        y = py[order[i]]
        if py[order[miny]] > y:
            miny = i
        if py[order[maxy]] < y:
            maxy = i
    first, last = order[0], order[-1]
    if px[first] == px[last] and py[first] == py[last]:
        return [first]
    # upper half, counter-clockwise: the right chain first
    tr = _sklansky(px, py, order, 0, maxy, -1, 1, is_float)
    tl = _sklansky(px, py, order, total - 1, maxy, -1, -1, is_float)
    hull = [order[s] for s in tl[:-1]] + [order[s] for s in tr[:0:-1]]
    stop = tr[1] if len(tr) > 2 else (tl[-2] if len(tl) > 2 else -1)
    # lower half
    bl = _sklansky(px, py, order, 0, miny, 1, -1, is_float)
    br = _sklansky(px, py, order, total - 1, miny, 1, 1, is_float)
    if stop >= 0:
        check = bl[1] if len(bl) > 2 else (
            br[2 - len(bl)] if len(bl) + len(br) > 2 else -1)
        if check == stop or (check >= 0
                             and px[order[check]] == px[order[stop]]
                             and py[order[check]] == py[order[stop]]):
            # all points on one line: the lower chain mirrors the upper
            bl, br = bl[:2], br[:2]
    hull += [order[s] for s in bl[:-1]] + [order[s] for s in br[:0:-1]]
    return _ascending_shift(hull)


def _ascending_shift(hull):
    """cv2's cyclic shift of the hull indices into an ascending or
    descending run, where one exists."""
    nout = len(hull)
    if nout < 3:
        return hull
    min_i = max_i = lt = 0
    for i in range(1, nout):
        idx = hull[i]
        lt += hull[i - 1] < idx
        if 1 < lt <= i - 2:
            break
        if idx < hull[min_i]:
            min_i = i
        if idx > hull[max_i]:
            max_i = i
    mm = abs(max_i - min_i)
    if not ((mm == 1 or mm == nout - 1) and (lt <= 1 or lt >= nout - 2)):
        return hull
    asc = (max_i + 1) % nout == min_i
    j = min_i if asc else max_i
    if j == 0:
        return hull
    out = []
    for i in range(nout):
        cur = hull[j]
        nj = j + 1 if j + 1 < nout else 0
        out.append(cur)
        if i < nout - 1 and asc != (cur < hull[nj]):
            return hull
        j = nj
    return out


def convex_hull_f32(points):
    """cv2.convexHull(points.astype(float32)) as float64 (m, 2)."""
    pts = np.asarray(points, dtype=np.float32).reshape(-1, 2)
    return pts[convex_hull_indices(pts)].astype(np.float64)
