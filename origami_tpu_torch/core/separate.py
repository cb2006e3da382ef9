"""Separator store: typed H/V/T separator polylines with spatial queries.

Port of origami_tpu/core/separate.py:18-96 (`extract_segments`,
`Separators`): per-separator labels and widths, an STRtree over the
geometries, obstacle checks within bounds. The XY-cut gap scorer
(`ObstacleSampler`) belongs to the layout and order stages and is not
ported yet (ROADMAP.md, queue A).
"""

from __future__ import annotations

from origami_tpu_torch import geometry as G
from origami_tpu_torch.core.segment import PredictorType


def extract_segments(geom):
    t = geom.geom_type
    if t in ("LineString", "LinearRing"):
        return [geom]
    if t == "MultiLineString":
        return list(geom.geoms)
    if t in ("Point", "MultiPoint"):
        return []
    if t == "GeometryCollection":
        out = []
        for g in geom.geoms:
            out.extend(extract_segments(g))
        return out
    if t in ("Polygon", "MultiPolygon"):
        # treat thin polygons as their exterior
        out = []
        for p in (geom.geoms if t == "MultiPolygon" else [geom]):
            out.append(p.exterior)
        return out
    return []


class Separators:
    def __init__(self, segmentation, separators, widths=None):
        self._predictions = {}
        for p in segmentation.predictions:
            if p.type == PredictorType.SEPARATOR:
                self._predictions[p.name] = p
        self._by_path = dict(separators)
        self._names = {}
        self._by_label = {}
        geoms = []
        for parts, geom in self._by_path.items():
            pred = self._predictions[parts[0]]
            label = pred.classes[parts[1]]
            self._by_label.setdefault(label, []).append(geom)
            self._names[id(geom)] = "/".join(parts)
            geoms.append(geom)
        self._geoms = geoms
        self._widths = widths or {}
        self._tree = G.STRtree(geoms)

    @property
    def by_path(self):
        return self._by_path

    @property
    def geoms(self):
        return self._geoms

    def name(self, geom):
        return self._names[id(geom)]

    def query(self, shape):
        return self._tree.query(shape)

    def label(self, name):
        pname, plabel = name.split("/")[:2]
        return self._predictions[pname].classes[plabel]

    def for_label(self, name):
        return self._by_label.get(self.label(name), [])

    def width(self, name):
        return self._widths.get(tuple(name.split("/")), 1)

    def check_obstacles(self, bounds, obstacles, fringe=0):
        minx, miny, maxx, maxy = bounds
        cx, cy = (minx + maxx) / 2, (miny + maxy) / 2
        minx = min(minx + fringe, cx)
        maxx = max(maxx - fringe, cx)
        miny = min(miny + fringe, cy)
        maxy = max(maxy - fringe, cy)
        labels = set(self.label(o) for o in obstacles)
        bx = G.box(minx, miny, maxx, maxy)
        for sep in self.query(bx):
            if self.label(self.name(sep)) in labels and bx.intersects(sep):
                return True
        return False
