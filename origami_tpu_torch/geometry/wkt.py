"""OpenGIS Well-Known-Text reader/writer for origami_tpu geometries.

The artifact formats of the pipeline store every region and separator shape
as a ``.wkt`` file inside contour zips (see reference docs/formats.md), so
this module defines the on-disk contract for all vector artifacts.
"""

from __future__ import annotations

import re
import numpy as np

from .poly import (
    Point, MultiPoint, LineString, MultiLineString, LinearRing,
    Polygon, MultiPolygon, GeometryCollection, GEOMETRY_EMPTY,
)

__all__ = ["dumps", "loads"]


def _fmt(v):
    # shapely-compatible float formatting (repr-shortest)
    return repr(float(v))


def _coords_str(coords):
    return ", ".join("%s %s" % (_fmt(p[0]), _fmt(p[1])) for p in coords)


def _ring_str(ring):
    c = np.asarray(ring, dtype=np.float64)
    if len(c) and not np.array_equal(c[0], c[-1]):
        c = np.vstack([c, c[:1]])
    return "(" + _coords_str(c) + ")"


def _poly_str(poly):
    rings = [_ring_str(poly.np_shell)] + [_ring_str(h) for h in poly.np_holes]
    return "(" + ", ".join(rings) + ")"


def dumps(geom):
    t = geom.geom_type
    if geom.is_empty:
        if t == "Polygon":
            return "POLYGON EMPTY"
        if t in ("LineString", "LinearRing"):
            return "LINESTRING EMPTY"
        if t == "MultiPolygon":
            return "MULTIPOLYGON EMPTY"
        if t == "MultiLineString":
            return "MULTILINESTRING EMPTY"
        if t == "Point":
            return "POINT EMPTY"
        return "GEOMETRYCOLLECTION EMPTY"
    if t == "Point":
        return "POINT (%s %s)" % (_fmt(geom.x), _fmt(geom.y))
    if t == "MultiPoint":
        return "MULTIPOINT (" + _coords_str(geom._all_coords()) + ")"
    if t in ("LineString", "LinearRing"):
        return "LINESTRING (" + _coords_str(geom.np_coords) + ")"
    if t == "MultiLineString":
        return "MULTILINESTRING (" + ", ".join(
            "(" + _coords_str(l.np_coords) + ")" for l in geom.geoms) + ")"
    if t == "Polygon":
        return "POLYGON " + _poly_str(geom)
    if t == "MultiPolygon":
        return "MULTIPOLYGON (" + ", ".join(
            _poly_str(p) for p in geom.geoms) + ")"
    if t == "GeometryCollection":
        return "GEOMETRYCOLLECTION (" + ", ".join(
            dumps(g) for g in geom.geoms) + ")"
    raise ValueError("cannot serialize %s" % t)


_TOKEN = re.compile(r"\s*([A-Za-z]+|\(|\)|,|[-+0-9.eE]+)")


class _Parser:
    def __init__(self, text):
        self.text = text
        self.pos = 0

    def next(self):
        m = _TOKEN.match(self.text, self.pos)
        if not m:
            return None
        self.pos = m.end()
        return m.group(1)

    def peek(self):
        m = _TOKEN.match(self.text, self.pos)
        return m.group(1) if m else None

    def expect(self, tok):
        t = self.next()
        if t != tok:
            raise ValueError("WKT parse error: expected %r got %r at %d"
                             % (tok, t, self.pos))

    def coords(self):
        """Parse '( x y, x y, ... )'."""
        self.expect("(")
        pts = []
        while True:
            x = float(self.next())
            y = float(self.next())
            # tolerate Z/M ordinates
            while self.peek() not in (",", ")"):
                self.next()
            pts.append((x, y))
            t = self.next()
            if t == ")":
                break
            if t != ",":
                raise ValueError("WKT parse error near %d" % self.pos)
        return np.array(pts, dtype=np.float64)

    def ring_list(self):
        """Parse '(( ... ), ( ... ))'."""
        self.expect("(")
        rings = []
        while True:
            rings.append(self.coords())
            t = self.next()
            if t == ")":
                break
            if t != ",":
                raise ValueError("WKT parse error near %d" % self.pos)
        return rings

    def poly_list(self):
        self.expect("(")
        polys = []
        while True:
            polys.append(self.ring_list())
            t = self.next()
            if t == ")":
                break
            if t != ",":
                raise ValueError("WKT parse error near %d" % self.pos)
        return polys


_RE_RINGSPLIT = re.compile(r"\)\s*,\s*\(")
_RE_POLYSPLIT = re.compile(r"\)\s*\)\s*,\s*\(\s*\(")


def _fast_numbers(s):
    """Bulk-parse 'x y, x y, ...' into an (N, 2) array. Raises on
    malformed or non-2D coordinate lists (parser fallback)."""
    n_pts = s.count(",") + 1
    arr = np.array(s.replace(",", " ").split(), dtype=np.float64)
    if arr.size != 2 * n_pts:
        raise ValueError("non-2D coordinates")
    return arr.reshape(-1, 2)


def _fast_loads(text):
    """Fast path for the common 2-D WKT shapes: splits the paren
    structure with two regexes and bulk-converts each coordinate list
    in one numpy call (~20x over the token parser — artifact zips are
    read WKT-by-WKT in every stage). Returns None for anything that
    doesn't match the canonical structure (EMPTY, Z/M ordinates,
    points, collections), which falls back to the exact parser."""
    i = text.find("(")
    if i <= 0:
        return None
    kind = text[:i].strip().upper()
    body = text[i:].strip()
    if not body.endswith(")"):
        return None
    try:
        if kind == "LINESTRING":
            return LineString(_fast_numbers(body[1:-1]))
        if kind == "LINEARRING":
            return LinearRing(_fast_numbers(body[1:-1]))
        if kind in ("POLYGON", "MULTILINESTRING"):
            inner = body[1:-1].strip()
            if not (inner.startswith("(") and inner.endswith(")")):
                return None
            rings = [_fast_numbers(r)
                     for r in _RE_RINGSPLIT.split(inner[1:-1])]
            if kind == "POLYGON":
                return Polygon(rings[0], rings[1:])
            return MultiLineString([LineString(r) for r in rings])
        if kind == "MULTIPOLYGON":
            inner = body[1:-1].strip()
            if not (inner.startswith("((") and inner.endswith("))")):
                return None
            polys = []
            for ptxt in _RE_POLYSPLIT.split(inner[2:-2]):
                rings = [_fast_numbers(r)
                         for r in _RE_RINGSPLIT.split(ptxt)]
                polys.append(Polygon(rings[0], rings[1:]))
            return MultiPolygon(polys)
    except (ValueError, IndexError):
        return None
    return None


def loads(text):
    text = text.strip()
    fast = _fast_loads(text)
    if fast is not None:
        return fast
    p = _Parser(text)
    kind = p.next().upper()
    nxt = p.peek()
    if nxt is not None and nxt.upper() == "EMPTY":
        return GEOMETRY_EMPTY if kind == "GEOMETRYCOLLECTION" else _empty(kind)
    if kind == "POINT":
        c = p.coords()
        return Point(c[0])
    if kind == "MULTIPOINT":
        # both MULTIPOINT (1 2, 3 4) and MULTIPOINT ((1 2), (3 4))
        if p.text[p.pos:].lstrip().startswith("(("):
            rings = p.ring_list()
            return MultiPoint(np.vstack(rings))
        return MultiPoint(p.coords())
    if kind == "LINESTRING":
        return LineString(p.coords())
    if kind == "LINEARRING":
        return LinearRing(p.coords())
    if kind == "MULTILINESTRING":
        return MultiLineString([LineString(r) for r in p.ring_list()])
    if kind == "POLYGON":
        rings = p.ring_list()
        return Polygon(rings[0], rings[1:])
    if kind == "MULTIPOLYGON":
        return MultiPolygon([Polygon(r[0], r[1:]) for r in p.poly_list()])
    if kind == "GEOMETRYCOLLECTION":
        p.expect("(")
        geoms = []
        depth = 1
        start = p.pos
        # split top-level by commas at depth 0 relative to the collection
        items = []
        buf_start = p.pos
        while True:
            ch = p.text[p.pos] if p.pos < len(p.text) else None
            if ch is None:
                break
            if ch == "(":
                depth += 1
            elif ch == ")":
                depth -= 1
                if depth == 0:
                    items.append(p.text[buf_start:p.pos])
                    p.pos += 1
                    break
            elif ch == "," and depth == 1:
                items.append(p.text[buf_start:p.pos])
                buf_start = p.pos + 1
            p.pos += 1
        for item in items:
            item = item.strip()
            if item:
                geoms.append(loads(item))
        return GeometryCollection(geoms)
    raise ValueError("unknown WKT type %r" % kind)


def _empty(kind):
    if kind == "POLYGON":
        return Polygon()
    if kind == "MULTIPOLYGON":
        return MultiPolygon([])
    if kind in ("LINESTRING", "LINEARRING"):
        return LineString([])
    if kind == "MULTILINESTRING":
        return MultiLineString([])
    if kind == "MULTIPOINT":
        return MultiPoint([])
    if kind == "POINT":
        return Point(float("nan"), float("nan"))
    return GEOMETRY_EMPTY
