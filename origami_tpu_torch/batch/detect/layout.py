"""detect.layout — heuristic region refinement on the dewarped page
(CLI stage 5).

Port of origami_tpu/batch/detect/layout.py (warped contours/lines/
segmentation + dewarped contours -> contours.2.zip + tables.json).
A pluggable pipeline of operators mutates a RegionState: merging
over-segmented regions (same-line adjacency, overlap, sequential chains
with separator obstacles), resolving dominance conflicts between region
types, splitting spill-overs at column whitespace (periodogram over the
device-binarized dewarped page), detecting table columns/dividers from
T/H separators, and subdividing tables into division blocks.

Rule sets live in origami_tpu_torch.custom.layouts.<name> (--layout bbz).

The device work is the binarized page of the whitespace splitters: on the
card the page is dewarped by the dewarp kernel (Page.dewarped_dev), then
binarized by the Sauvola kernel at a window from the median line height,
and the separator label mask is whitened into it (ops/binarize.py: a
linear resize onto the warped page, the f32 dewarp kernel through the
grid, a 0.2 threshold, a 3x3 dilation; one launch each of sauvola_packed,
dewarp_u8 and dewarp_f32 a page). Graphs use core/graph.py in place of
networkx. Where the JAX stage swallows a failure of that binarization
(RegionState.start_binarize), this one lets it raise, so the page is
recorded FAILED.

    python -m origami_tpu_torch.batch.detect.layout CORPUS [--device cpu]
"""

from __future__ import annotations

import argparse
import collections
import importlib
import json
import logging
from functools import cached_property, partial
from pathlib import Path

import numpy as np
import torch

from origami_tpu_torch import geometry as G
from origami_tpu_torch.batch.core.io import Artifact, Input, Output, Stage
from origami_tpu_torch.batch.core.processor import (BatchedProcessor,
                                                    Processor)
from origami_tpu_torch.batch.core.utils import RegionsFilter
from origami_tpu_torch.batch.detect.flow import kernel_launches
from origami_tpu_torch.core import graph as _graph
from origami_tpu_torch.core.hull import concave_hull_polygon
from origami_tpu_torch.core.neighbors import neighbors
from origami_tpu_torch.core.segment import PredictorType
from origami_tpu_torch.core.utils import build_func_from_string
from origami_tpu_torch.core.xycut import polygon_order

# the JAX stage's runtime.json key: later stages of either package read it
STAGE_NAME = "origami_tpu.batch.detect.layout"


def interval_overlap(a0, a1, b0, b1, mode="min"):
    """Shared fraction of two 1-D intervals relative to the min/a/b
    extent."""
    shared = min(a1, b1) - max(a0, b0)
    if shared <= 0:
        return 0.0
    da, db = a1 - a0, b1 - b0
    if mode == "min":
        d = min(da, db)
    elif mode == "a":
        d = da
    elif mode == "b":
        d = db
    else:
        raise ValueError(mode)
    return shared / max(d, 1e-9)


# alias used by custom layout rule sets
alignment = interval_overlap


def cohesion(shapes, union):
    return sum(s.area for s in shapes) / max(union.area, 1e-9)


class LineCounts:
    def __init__(self, lines):
        counts = collections.defaultdict(int)
        for path in lines.keys():
            counts[tuple(path[:3])] += 1
        self._counts = counts

    def __getitem__(self, path):
        return self._counts.get(tuple(path), 0)

    def combine(self, sources, target):
        total = sum(self._counts.get(tuple(s), 0) for s in sources)
        for s in sources:
            self._counts.pop(tuple(s), None)
        self._counts[tuple(target)] = total

    def remove(self, path):
        self._counts.pop(tuple(path), None)


class RegionState:
    """Mutable layout state handed through the operator pipeline."""

    def __init__(self, page, warped_lines, contours, separators,
                 segmentation, grid=None):
        self._page = page
        self._grid = grid if grid is not None else page.grid
        self._contours = {tuple(k): c for k, c in contours
                          if not c.is_empty}
        self._unmodified = dict(self._contours)
        self._separators = separators
        self._segmentation = segmentation
        self._warped_lines = warped_lines
        self._line_counts = LineCounts(warped_lines)
        self._union_op = None
        self._mapped_from = collections.defaultdict(list)
        self._max_ids = collections.defaultdict(int)
        for k in self._contours:
            try:
                self._max_ids[k[:2]] = max(
                    self._max_ids[k[:2]], int(str(k[2]).split(".")[0]))
            except ValueError:
                pass

    # -- accessors ---------------------------------------------------------
    @property
    def page(self):
        return self._page

    @property
    def grid(self):
        return self._grid

    @property
    def separators(self):
        return self._separators

    @property
    def contours(self):
        return self._contours

    @property
    def unmodified_contours(self):
        return self._unmodified

    @cached_property
    def geometry(self):
        return self._page.geometry(dewarped=self._grid is not None)

    @property
    def by_predictors(self):
        out = collections.defaultdict(list)
        for k, c in self._contours.items():
            out[k[:2]].append(k)
        return out

    def sauvola_window(self):
        """The Sauvola window of the page: the median line height halved,
        in steps of 8, made odd (the JAX stage's buckets)."""
        return max(3, (int(self.median_line_height) // 2 // 8 * 8 + 4) | 1)

    @cached_property
    def _binarized_packed(self):
        """The bit-packed binarized page on the page's device (True =
        paper or separator), and its width. On the dewarped page when
        there is a grid, as Page.dewarped_dev gives it."""
        from origami_tpu_torch.ops.binarize import (
            binarize_sep_dewarped_packed, binarize_sep_resized_packed,
            binarize_with_separators_packed, sauvola_packed)
        window = self.sauvola_window()
        if self._grid is not None:
            gray = self._page.dewarped_dev
        else:
            gray = self._page.device_pixels
        dev = gray.device
        masks = [
            pred.labels != pred.classes["BACKGROUND"].value
            for pred in self._segmentation.predictions
            if pred.type == PredictorType.SEPARATOR]
        if not masks:
            packed = sauvola_packed(gray, window)
        else:
            sep = masks[0]
            for m in masks[1:]:
                h = min(sep.shape[0], m.shape[0])
                w = min(sep.shape[1], m.shape[1])
                sep = sep[:h, :w] | m[:h, :w]
            sep = torch.from_numpy(np.ascontiguousarray(sep)).to(dev)
            ww, wh = self._page.size(False)
            if self._grid is None:
                packed = binarize_sep_resized_packed(gray, window, sep)
            else:
                hv = torch.from_numpy(self._grid.points("sample")).to(dev)
                res = self._grid.resolution
                if self._grid.has_banded_plan((wh, ww)):
                    packed = binarize_sep_dewarped_packed(
                        gray, window, sep, hv, res, wh, ww)
                else:
                    packed = binarize_with_separators_packed(
                        gray, window, sep, hv, res, wh, ww)
        return packed, int(gray.shape[1])

    @cached_property
    def binarized(self):
        """Dewarped binarized page (True = paper) with separator pixels
        whitened, so whitespace-split detection treats separator lines
        as gaps, not content; the packed mask comes to the host once."""
        packed, width = self._binarized_packed
        return np.unpackbits(
            packed.cpu().numpy(), axis=1)[:, :width].astype(bool)

    def start_binarize(self):
        """Queue the device work of `binarized` before the host operators
        run (the launches are asynchronous); a failure raises here."""
        self._binarized_packed

    # -- line statistics ---------------------------------------------------
    @property
    def warped_lines(self):
        return self._warped_lines

    @cached_property
    def warped_lines_by_block(self):
        out = collections.defaultdict(list)
        for k, line in self._warped_lines.items():
            out[tuple(k[:3])].append(line)
        return out

    def line_count(self, path):
        return self._line_counts[path]

    def sources(self, path):
        m = self._mapped_from.get(tuple(path))
        if not m:
            return [tuple(path)]
        out = []
        for x in m:
            out.extend(self.sources(x))
        return out

    @cached_property
    def _line_heights_by_block(self):
        """Dewarped height of every warped line, computed in ONE
        batched Newton grid inversion (line_heights is consulted for
        every candidate region pair; per-line transformer_points calls
        were ~0.1 s/page of layout host time)."""
        blocks, lines = [], []
        for k, ls in self.warped_lines_by_block.items():
            for line in ls:
                blocks.append(k)
                lines.append(line)
        if not lines:
            return {}
        if self._grid is None:
            heights = [line.height for line in lines]
        else:
            pts = np.empty((2 * len(lines), 2))
            for i, line in enumerate(lines):
                pts[2 * i] = line.p
                pts[2 * i + 1] = line.p + line.up
            mapped = self._grid.transformer_points(pts)
            d = mapped[1::2] - mapped[0::2]
            heights = np.hypot(d[:, 0], d[:, 1])
        out = collections.defaultdict(list)
        for k, h in zip(blocks, heights):
            out[k].append(float(h))
        return dict(out)

    def line_heights(self, path):
        heights = []
        for src in self.sources(path):
            heights.extend(self._line_heights_by_block.get(src, ()))
        return heights

    @cached_property
    def _line_spans_by_block(self):
        """Dewarped baseline x-extent of every warped line, in one
        batched grid inversion — line-bridge evidence for the column
        splitters: a whitespace column that the block's own text lines
        read straight across is an aligned inter-word gap, not a
        gutter (the residual 2.5% bad_text tail of COMPARE_r03)."""
        blocks, lines = [], []
        for k, ls in self.warped_lines_by_block.items():
            for line in ls:
                blocks.append(k)
                lines.append(line)
        if not lines:
            return {}
        pts = np.empty((2 * len(lines), 2))
        for i, line in enumerate(lines):
            pts[2 * i] = line.p
            pts[2 * i + 1] = line.p + line.right
        if self._grid is not None:
            pts = self._grid.transformer_points(pts)
        x0 = np.minimum(pts[0::2, 0], pts[1::2, 0])
        x1 = np.maximum(pts[0::2, 0], pts[1::2, 0])
        out = collections.defaultdict(list)
        for k, a, b in zip(blocks, x0, x1):
            out[k].append((float(a), float(b)))
        return dict(out)

    def line_spans(self, path):
        """Dewarped (x0, x1) baseline extents of the block's lines."""
        spans = []
        for src in self.sources(path):
            spans.extend(self._line_spans_by_block.get(src, ()))
        return spans

    @cached_property
    def median_line_height(self):
        hs = [h for heights in self._line_heights_by_block.values()
              for h in heights]
        return max(6, int(np.median(hs))) if hs else 16

    # -- mutation ----------------------------------------------------------
    def set_union_operator(self, op):
        self._union_op = op

    def union(self, shapes):
        if self._union_op is not None:
            return self._union_op(self._page, shapes)
        u = G.unary_union(shapes)
        if u.geom_type != "Polygon":
            u = u.convex_hull
        return u

    def map(self, f):
        self._contours = {k: f(k, c) for k, c in self._contours.items()}

    def modify_contour(self, path, contour):
        path = tuple(path)
        if contour.is_empty:
            self.remove_contour(path)
        else:
            self._contours[path] = contour

    def remove_contour(self, path):
        path = tuple(path)
        self._contours.pop(path, None)
        self._line_counts.remove(path)

    def add_contour(self, label, contour):
        self._max_ids[tuple(label)] += 1
        path = tuple(label) + (str(self._max_ids[tuple(label)]),)
        self._contours[path] = contour
        return path

    def combine(self, sources, agg_path=None):
        sources = [tuple(s) for s in sources]
        if agg_path is None:
            agg_path = max(sources, key=lambda p: self._contours[p].area)
        u = self.union([self._contours[p] for p in sources
                        if p in self._contours])
        self.modify_contour(agg_path, u)
        self._line_counts.combine(sources, agg_path)
        for s in sources:
            if s != tuple(agg_path):
                self.remove_contour(s)
                self._mapped_from[tuple(agg_path)].append(s)

    def combine_from_graph(self, graph):
        if graph.number_of_edges() == 0:
            return False
        for nodes in _graph.connected_components(graph):
            if len(nodes) > 1:
                self.combine(sorted(nodes))
        return True

    def check_geometries(self, allowed=("Polygon",)):
        for k, c in list(self._contours.items()):
            if c.geom_type not in allowed or not c.is_valid:
                fixed = G.make_valid(c)
                if fixed.geom_type == "MultiPolygon":
                    fixed = max(fixed.geoms, key=lambda p: p.area)
                if fixed.is_empty:
                    self.remove_contour(k)
                else:
                    self._contours[k] = fixed


class Transformer:
    def __init__(self, operators):
        self._operators = operators

    def __call__(self, regions, callback=None):
        regions.check_geometries(("Polygon", "MultiPolygon"))
        for i, op in enumerate(self._operators):
            try:
                op(regions)
                regions.check_geometries(("Polygon",))
            except Exception:
                logging.exception("layout operator %s (stage %d) failed",
                                  op.__class__.__name__, i + 1)
            if callback:
                callback(i, regions)


# ---------------------------------------------------------------------------
# hull / union operators
# ---------------------------------------------------------------------------

class HullOperator:
    def __init__(self, spec):
        funcs = dict(none=HullOperator._none, rect=HullOperator._rect,
                     convex=HullOperator._convex,
                     concave=HullOperator._concave)
        self._f = build_func_from_string(spec, funcs)

    @staticmethod
    def _none(page, shape):
        return shape if shape.geom_type == "Polygon" else shape.convex_hull

    @staticmethod
    def _rect(page, shape):
        return G.box(*shape.bounds)

    @staticmethod
    def _convex(page, shape):
        return shape.convex_hull

    @staticmethod
    def _concave(page, shape, concavity=2, detail=0.01):
        detail_px = page.geometry(dewarped=True).rel_length(detail)
        return concave_hull_polygon(shape, concavity, detail_px)

    def __call__(self, page, shape):
        return self._f(page, shape)


class UnionOperator:
    def __init__(self, spec):
        self._hull = HullOperator(spec)

    def __call__(self, page, shapes):
        u = G.unary_union(shapes) if len(shapes) > 1 else shapes[0]
        return self._hull(page, u)


class SetUnionOperator:
    def __init__(self, spec):
        self._union = UnionOperator(spec)

    def __call__(self, regions):
        regions.set_union_operator(self._union)


class Dilation:
    def __init__(self, spec):
        self._hull = HullOperator(spec)

    def __call__(self, regions):
        regions.map(lambda _, c: self._hull(regions.page, c))


# ---------------------------------------------------------------------------
# merge criteria + mergers
# ---------------------------------------------------------------------------

class IsOnSameLine:
    def __init__(self, max_line_count=3, cohesion=0.8, alignment=0.8,
                 fringe=0, max_distance=0.006):
        self._max_line_count = max_line_count
        self._cohesion = cohesion
        self._min_alignment = alignment
        self._fringe = fringe
        self._max_distance = max_distance

    def for_regions(self, regions):
        return partial(self.check, regions=regions)

    def check(self, p, q, regions):
        if max(regions.line_count(p),
               regions.line_count(q)) > self._max_line_count:
            return False
        a = regions.contours[p]
        b = regions.contours[q]
        _, ay0, _, ay1 = a.bounds
        _, by0, _, by1 = b.bounds
        if interval_overlap(ay0, ay1, by0, by1) < self._min_alignment:
            return False
        if a.distance(b) > regions.geometry.rel_length(self._max_distance):
            return False
        u = regions.union([a, b])
        if regions.separators.check_obstacles(
                u.bounds, ["separators/V", "separators/T"], self._fringe):
            return False
        return cohesion([a, b], u) > self._cohesion


class IsBelow:
    def __init__(self, alignment=0.95):
        self._min_alignment = alignment

    def for_regions(self, regions):
        return partial(self.check, regions=regions)

    def _is_below(self, a, b, h):
        minxa, _, maxxa, maxya = a.bounds
        minxb, minyb, maxxb, _ = b.bounds
        if not (0 < minyb - maxya < h):
            return False
        return interval_overlap(minxa, maxxa, minxb, maxxb) \
            >= self._min_alignment

    def check(self, p, q, regions):
        hs = regions.line_heights(p) + regions.line_heights(q)
        if len(hs) < 2:
            return False
        h = float(np.median(hs))
        a = regions.contours[p]
        b = regions.contours[q]
        return self._is_below(a, b, h) or self._is_below(b, a, h)


class AdjacencyMerger:
    def __init__(self, filters, criterion):
        self._filter = RegionsFilter(filters)
        self._criterion = criterion

    def __call__(self, regions):
        should_merge = self._criterion.for_regions(regions)
        adj = neighbors(regions.contours)
        graph = _graph.Graph()
        graph.add_nodes_from(regions.contours.keys())
        for p, q in adj.edges():
            if self._filter(p) and self._filter(q) and should_merge(p, q):
                graph.add_edge(p, q)
        regions.combine_from_graph(graph)


def overlap_ratio(a, b):
    inter = a.intersection(b)
    if inter.is_empty:
        return 0.0
    return inter.area / max(min(a.area, b.area), 1e-9)


class OverlapMerger:
    def __init__(self, maximum_overlap):
        self._max_overlap = maximum_overlap

    def _merge_label(self, regions, paths):
        graph = _graph.Graph()
        graph.add_nodes_from(paths)
        polys = [regions.contours[p] for p in paths]
        tree = G.STRtree(polys)
        for i, p in enumerate(paths):
            for j in tree.query_indices(polys[i]):
                j = int(j)
                if j <= i:
                    continue
                if overlap_ratio(polys[i], polys[j]) > self._max_overlap:
                    graph.add_edge(p, paths[j])
        return regions.combine_from_graph(graph)

    def __call__(self, regions):
        dirty = set(regions.by_predictors.keys())
        while dirty:
            changed = set()
            for label, paths in regions.by_predictors.items():
                if label in dirty and len(paths) > 1:
                    if self._merge_label(regions, paths):
                        changed.add(label)
            dirty = changed


class Shrinker:
    """Clip each (dilated) contour back to the bbox of the original
    shapes it covers."""

    def __init__(self, min_area=0):
        self._min_area = min_area

    def __call__(self, regions):
        by_label = collections.defaultdict(list)
        for k, c in regions.unmodified_contours.items():
            by_label[k[:2]].append(c)
        min_area = regions.geometry.rel_area(self._min_area)
        for label, originals in by_label.items():
            tree = G.STRtree(originals)
            for k, contour in list(regions.contours.items()):
                if k[:2] != label:
                    continue
                hits = [g for g in tree.query(contour)
                        if g.intersects(contour)]
                if not hits:
                    continue
                bounds = G.unary_union(hits).bounds
                clipped = G.box(*bounds).intersection(contour)
                if clipped.geom_type == "MultiPolygon":
                    clipped = max(clipped.geoms, key=lambda p: p.area)
                if clipped.area >= min_area and not clipped.is_empty:
                    regions.modify_contour(k, clipped)
                else:
                    regions.remove_contour(k)


class Overlap:
    """Max fractional overlap of a shape with contours of other labels."""

    def __init__(self, contours, active_labels):
        self._polys = [c for k, c in contours.items()
                       if k[:2] in active_labels]
        self._tree = G.STRtree(self._polys)

    def __call__(self, shape):
        best = 0.0
        for i in self._tree.query_indices(shape):
            t = self._polys[int(i)]
            inter = t.intersection(shape)
            if not inter.is_empty:
                best = max(best, inter.area / max(t.area, 1e-9))
        return best


class SequentialMerger:
    """Merge runs of same-label regions in reading order, stopping at
    separator obstacles, distance jumps, low cohesion, or overlap with
    other labels."""

    def __init__(self, filters, cohesion, max_distance, max_error,
                 fringe, obstacles):
        self._filter = RegionsFilter(filters)
        self._cohesion = cohesion
        self._max_distance = max_distance
        self._max_error = max_error
        self._fringe = fringe
        self._obstacles = obstacles

    def _merge(self, regions, names, error_overlap):
        contours = regions.contours
        shapes = [contours[x] for x in names]
        fringe = regions.geometry.rel_length(self._fringe)
        max_distance = regions.geometry.rel_length(self._max_distance)
        graph = _graph.Graph()
        graph.add_nodes_from(names)

        i = 0
        while i < len(shapes):
            good = False
            for j in range(i + 1, len(shapes)):
                d = regions.union(shapes[i:j]).distance(shapes[j])
                if d > max_distance:
                    break
                u = regions.union(shapes[i:j + 1])
                if regions.separators.check_obstacles(
                        u.bounds, self._obstacles, fringe):
                    break
                c = cohesion(shapes[i:j + 1], u)
                err = error_overlap(u)
                if c < self._cohesion[0] or err > self._max_error:
                    break
                if c > self._cohesion[1]:
                    for k in range(i, j):
                        graph.add_edge(names[k], names[k + 1])
                    shapes[j] = u
                    i = j
                    good = True
                    break
            if not good:
                i += 1
        return regions.combine_from_graph(graph)

    def __call__(self, regions):
        by_predictors = regions.by_predictors
        while by_predictors:
            dirty = set()
            for label, paths in by_predictors.items():
                if not self._filter(label + ("0",)):
                    continue
                fringe = regions.geometry.rel_length(self._fringe)
                order = polygon_order(
                    list(regions.contours.items()), fringe=fringe)
                selection = set(paths)
                order = [x for x in order if x in selection]
                error_overlap = Overlap(
                    regions.unmodified_contours,
                    set(regions.by_predictors.keys()) - {label})
                if self._merge(regions, order, error_overlap):
                    dirty.add(label)
            if not dirty:
                break
            by_predictors = {
                k: v for k, v in regions.by_predictors.items()
                if k in dirty}


class DominanceOperator:
    """Resolve overlaps between (possibly differently-labelled) regions:
    containment consumes; remaining conflicts are settled by a pluggable
    strategy (merge / split / custom reshaping)."""

    def __init__(self, filters, fringe, strategy):
        self._filter = RegionsFilter(filters)
        self._fringe = fringe
        self._strategy = strategy

    def _conflict_graph(self, regions, paths):
        graph = _graph.Graph()
        graph.add_nodes_from(paths)
        polys = [regions.contours[p] for p in paths]
        tree = G.STRtree(polys)
        for i, p in enumerate(paths):
            for j in tree.query_indices(polys[i]):
                j = int(j)
                if j > i and polys[i].intersects(polys[j]):
                    graph.add_edge(p, paths[j])
        return graph

    def _resolve(self, regions, nodes):
        if len(nodes) <= 1:
            return
        fringe = regions.geometry.rel_length(self._fringe)
        remaining = {k: regions.contours[k].area for k in nodes
                     if k in regions.contours}

        def merge(union, agg):
            regions.combine(union, agg_path=agg)
            for x in union:
                if x != agg:
                    remaining.pop(x, None)
            remaining[agg] = regions.contours[agg].area

        # phase 1: containment consumption, largest first
        done = False
        while not done:
            done = True
            by_area = sorted(remaining, key=lambda k: remaining[k])
            for i in reversed(range(1, len(by_area))):
                big_path = by_area[i]
                big = regions.contours[big_path].buffer(fringe) \
                    if fringe > 0 else regions.contours[big_path]
                union = [big_path]
                for p in by_area[:i]:
                    poly = regions.contours.get(p)
                    if poly is None or poly.is_empty or big.contains(poly):
                        union.append(p)
                if len(union) > 1:
                    merge(union, big_path)
                    done = False
                    break

        # phase 2: strategy-resolved partial overlaps
        def modify(key, shape):
            if shape.geom_type == "Polygon":
                regions.modify_contour(key, shape)
                remaining[key] = shape.area
            elif shape.geom_type == "MultiPolygon":
                regions.remove_contour(key)
                remaining.pop(key, None)
                for geom in shape.geoms:
                    np_ = regions.add_contour(key[:2], geom)
                    remaining[np_] = geom.area
            else:
                regions.remove_contour(key)
                remaining.pop(key, None)

        def shrink(victim, keeper):
            shape = regions.contours[victim]
            other = regions.contours[keeper]
            if shape.intersection(other).area < 1:
                return
            rest = shape.difference(other)
            if rest.is_empty:
                regions.remove_contour(victim)
                remaining.pop(victim, None)
            else:
                modify(victim, rest)

        done = len(remaining) < 2
        guard = 64
        while not done and guard > 0:
            guard -= 1
            done = True
            adj = neighbors({k: regions.contours[k] for k in remaining
                             if k in regions.contours})
            for pk, qk in list(adj.edges()):
                if pk not in regions.contours or qk not in regions.contours:
                    continue
                if regions.contours[pk].intersection(
                        regions.contours[qk]).area < 1:
                    continue
                done = False
                r = self._strategy(regions.contours, pk, qk)
                if r[0] == "merge":
                    merge([pk, qk], r[1])
                elif r[0] == "split":
                    shrink(r[1], r[2])
                elif r[0] == "custom":
                    ps, qs = r[1]
                    modify(pk, ps)
                    modify(qk, qs)
                else:
                    raise ValueError(r)

    def __call__(self, regions):
        paths = [k for k in regions.contours if self._filter(k)]
        graph = self._conflict_graph(regions, paths)
        for nodes in _graph.connected_components(graph):
            self._resolve(regions, sorted(nodes))


# ---------------------------------------------------------------------------
# spill-over splitting
# ---------------------------------------------------------------------------

class SplitFilter:
    def __init__(self, min_area=0.2):
        self._min_area = min_area

    def __call__(self, union, shapes):
        if not shapes:
            return False
        return min(s.area for s in shapes) >= union.area * self._min_area


class SplitDetector:
    """Find whitespace columns via the vertical-frequency periodogram of
    a binarized crop (reference layout.py:915-944)."""

    def __init__(self, quantile=0.9, smooth=1, intensity=0.05, width=2,
                 border=0.1):
        self._quantile = quantile
        self._smooth = smooth
        self._intensity = intensity
        self._width = width
        self._border = border

    def __call__(self, pixels, scale):
        import scipy.fft
        import scipy.signal
        import scipy.ndimage
        if pixels.dtype == np.uint8:
            pixels = pixels.astype(np.float32) / 255.0
        elif pixels.dtype != np.float32:
            # bool crops from Regions.binarized: keep the FFT in f32
            # (float64 periodograms double the stage's host time)
            pixels = pixels.astype(np.float32)
        if pixels.shape[0] < 4 or pixels.shape[1] < 4:
            return np.array([], dtype=int), dict(peak_heights=np.array([]))
        # direct one-sided periodogram (== scipy.signal.periodogram
        # with boxcar/density/constant-detrend, ~4x faster: no stft
        # framing machinery for a single full-length frame)
        n = pixels.shape[0]
        xm = pixels - pixels.mean(axis=0, keepdims=True)
        spec = scipy.fft.rfft(xm, axis=0)
        dens = (np.abs(spec) ** 2) / n
        dens[1:] *= 2.0
        if n % 2 == 0:
            dens[-1] /= 2.0
        prof = np.quantile(dens, self._quantile, axis=0)
        k = max(1, int(self._smooth * scale))
        prof = scipy.ndimage.uniform_filter1d(prof, k, mode="nearest")
        span = int(self._border * len(prof))
        if span:
            prof[:span] = 0
            prof[-span:] = 0
        peaks, info = scipy.signal.find_peaks(
            -prof, height=-self._intensity,
            distance=max(1, int(self._width * scale)))
        return peaks, info


def split_polygon(polygon, line):
    """Split a polygon with a straight line into the pieces on each
    side (replaces shapely.ops.split).

    The half-planes are sized to the polygon's own extent: huge
    fixed-size half-planes (the old 1e6 factor on an UNNORMALIZED
    direction) put vertices at ~1e9, where the float-eps logic of the
    arrangement overlay breaks down and `intersection` can return the
    half-plane itself (observed on the 1925 BBZ scan: a column split
    emitted 1e12-area TEXT regions)."""
    c = line.np_coords
    p0, p1 = c[0], c[-1]
    d = p1 - p0
    d = d / (np.linalg.norm(d) + 1e-12)
    n = np.array([-d[1], d[0]])
    minx, miny, maxx, maxy = polygon.bounds
    big = 4.0 * (abs(maxx - minx) + abs(maxy - miny) + 1.0)
    # recenter the half-planes on the polygon so the line segment's own
    # position can't blow up the extent
    mid = np.array([(minx + maxx) / 2.0, (miny + maxy) / 2.0])
    t = float(np.dot(mid - p0, d))
    q0 = p0 + d * (t - big)
    q1 = p0 + d * (t + big)
    half1 = G.Polygon([q0, q1, q1 + n * big, q0 + n * big])
    half2 = G.Polygon([q0, q1, q1 - n * big, q0 - n * big])
    parts = []
    for h in (half1, half2):
        piece = polygon.intersection(h)
        if piece.is_empty:
            continue
        if piece.area > polygon.area * (1.0 + 1e-6):
            # a boolean-robustness escape must never leak a piece
            # larger than its input
            continue
        if piece.geom_type == "MultiPolygon":
            parts.extend(piece.geoms)
        elif piece.geom_type == "Polygon":
            parts.append(piece)
    return parts


def _crop(pixels, contour):
    minx, miny, maxx, maxy = contour.bounds
    miny = int(max(0, miny))
    minx = int(max(0, minx))
    maxy = int(min(maxy, pixels.shape[0]))
    maxx = int(min(maxx, pixels.shape[1]))
    return pixels[miny:maxy, minx:maxx], (minx, miny)


def _line_length(geom):
    return geom.length if hasattr(geom, "length") else 0.0


def _gutter_is_clear(crop, px, lh, halfwidth_frac=0.15, max_bridge=0.2,
                     min_gap_frac=1.5):
    """True iff the candidate whitespace column at crop-x ``px`` is a
    believable gutter.

    Two checks, both over the rows that have ink on BOTH sides of px:
      * bridge: at most ``max_bridge`` of them may have ink inside the
        gutter band (a real gutter is ink-free down the whole block);
      * width: the median contiguous ink-free span around px must be at
        least ``min_gap_frac`` detected-band heights. Aligned
        inter-word gaps measure ~1.1 band heights (13.5 px at lh=12 on
        the page that motivated this — the periodogram cut every line
        of one text block in half there, the residual 2.5% bad_text
        tail in COMPARE_r03); genuine column gutters are 2.4-5."""
    g = max(1, int(halfwidth_frac * lh))
    lo = max(px - g, 0)
    hi = min(px + g + 1, crop.shape[1])
    if lo >= hi or px <= 0 or px >= crop.shape[1] - 1:
        return False
    ink = ~crop     # Regions.binarized: True = paper
    left = ink[:, :lo].any(axis=1)
    right = ink[:, hi:].any(axis=1)
    both = left & right
    n = int(both.sum())
    if n == 0:
        return True
    if float((ink[:, lo:hi].any(axis=1) & both).sum()) / n > max_bridge:
        return False
    # per bridging row: distance from the last ink column left of px to
    # the first ink column right of px
    w = crop.shape[1]
    cols = np.arange(w)
    ink_b = ink[both]
    lpart = np.where(ink_b[:, :px], cols[:px], -1).max(axis=1)
    rrel = np.where(ink_b[:, px:], cols[px:], w + px).min(axis=1)
    gaps = rrel - lpart - 1
    return float(np.median(gaps)) >= min_gap_frac * lh


def _lines_bridge(spans, x, margin, max_frac=0.2):
    """True iff more than ``max_frac`` of the block's detected baselines
    read straight across the candidate split column ``x`` — i.e. their
    dewarped x-extent covers [x-margin, x+margin]. Those lines would be
    cut in half by the split; a genuine column gutter has (nearly) no
    such lines, while an aligned inter-word whitespace column has them
    on every text row (the bad_text tail of COMPARE_r03)."""
    if not spans:
        return False
    n_bridge = sum(1 for x0, x1 in spans
                   if x0 <= x - margin and x1 >= x + margin)
    return n_bridge > max_frac * len(spans)


class FixSpillOverH:
    """Split regions at detected whitespace columns."""

    def __init__(self, filters, split_detector=None, min_line_count=3,
                 split_filter=None, max_line_bridge=0.2):
        self._filter = RegionsFilter(filters)
        self._detector = split_detector or SplitDetector()
        self._min_line_count = min_line_count
        self._split_filter = split_filter or SplitFilter()
        self._max_line_bridge = max_line_bridge

    def __call__(self, regions):
        binarized = regions.binarized
        splits = []
        for k, contour in regions.contours.items():
            if not self._filter(k):
                continue
            if regions.line_count(k) < self._min_line_count:
                continue
            hs = regions.line_heights(k)
            if not hs:
                continue
            lh = float(np.median(hs))
            crop, (minx, miny) = _crop(binarized, contour)
            peaks, info = self._detector(crop, scale=lh)
            if len(peaks):
                spans = regions.line_spans(k)
                order = np.argsort(info["peak_heights"])[::-1]
                for i in map(int, order):
                    if not _gutter_is_clear(crop, int(peaks[i]), lh):
                        continue
                    x = peaks[i] + minx
                    if _lines_bridge(spans, x, margin=lh,
                                     max_frac=self._max_line_bridge):
                        continue
                    sep = G.LineString(
                        [[x, -1], [x, binarized.shape[0] + 1]])
                    splits.append((k, contour, sep, lh))
                    break
        for k, contour, sep, lh in splits:
            if _line_length(contour.intersection(sep)) \
                    < lh * self._min_line_count:
                continue
            shapes = split_polygon(contour, sep)
            if self._split_filter(contour, shapes):
                regions.remove_contour(k)
                for s in shapes:
                    regions.add_contour(k[:2], s)


class FixSpillOverV:
    def __init__(self, filters, split_detector=None):
        self._filter = RegionsFilter(filters)
        self._detector = split_detector or SplitDetector()

    def __call__(self, regions):
        lh = regions.median_line_height
        binarized = regions.binarized
        splits = []
        for k, contour in regions.contours.items():
            if not self._filter(k):
                continue
            crop, (minx, miny) = _crop(binarized, contour)
            peaks, info = self._detector(crop.T, scale=lh)
            if len(peaks):
                i = int(np.argmax(info["peak_heights"]))
                y = peaks[i] + miny
                sep = G.LineString([[-1, y], [binarized.shape[1] + 1, y]])
                splits.append((k, contour, sep))
        for k, contour, sep in splits:
            shapes = split_polygon(contour, sep)
            if len(shapes) > 1:
                regions.remove_contour(k)
                for s in shapes:
                    regions.add_contour(k[:2], s)


class FixSpillOverHOnSeparator:
    """Split regions at separator-derived column positions."""

    def __init__(self, detector, split_filter=None):
        self._detector = detector
        self._split_filter = split_filter or SplitFilter()

    def __call__(self, regions):
        page_h = regions.geometry.size[1]
        dividers = self._detector(regions)
        for k, xs in dividers.items():
            if not xs or k not in regions.contours:
                continue
            remaining = regions.contours[k]
            split_shapes = []
            for x in xs:
                sep = G.LineString([[x, -1], [x, page_h + 1]])
                shapes = split_polygon(remaining, sep)
                if len(shapes) > 1 and self._split_filter(remaining, shapes):
                    shapes = sorted(shapes, key=lambda p: p.bounds[0])
                    split_shapes.extend(shapes[:-1])
                    remaining = shapes[-1]
            if split_shapes:
                regions.remove_contour(k)
                for s in split_shapes:
                    regions.add_contour(k[:2], s)
                regions.add_contour(k[:2], remaining)


class Squeeze:
    """Split dumbbell-shaped regions at their narrowest pinch
    (reference layout `Squeeze` op backed by CGAL straight skeletons,
    origami/core/contours.py:227-271; raster-based here)."""

    def __init__(self, filters, max_neck_ratio=0.3, min_part_ratio=0.2):
        self._filter = RegionsFilter(filters)
        self._max_neck = max_neck_ratio
        self._min_part = min_part_ratio

    def __call__(self, regions):
        from origami_tpu_torch.core.geometry_ops import squeeze_split
        for k, contour in list(regions.contours.items()):
            if not self._filter(k):
                continue
            parts = squeeze_split(contour, self._max_neck,
                                  self._min_part)
            if len(parts) > 1:
                regions.remove_contour(k)
                for p in parts:
                    regions.add_contour(k[:2], p)


class AreaFilter:
    def __init__(self, min_area):
        self._min_area = min_area

    def __call__(self, regions):
        min_area = regions.geometry.rel_area(self._min_area)
        for k in [k for k, c in regions.contours.items()
                  if c.area < min_area]:
            regions.remove_contour(k)


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------

def _cluster_1d(values, min_distance):
    """Gap-based 1-D clustering (replaces sklearn agglomerative for the
    separator x/y positions)."""
    values = np.asarray(values, dtype=np.float64)
    order = np.argsort(values)
    labels = np.zeros(len(values), dtype=int)
    cur = 0
    for a, b in zip(order[:-1], order[1:]):
        if values[b] - values[a] > min_distance:
            cur += 1
        labels[b] = cur
    labels_out = np.zeros(len(values), dtype=int)
    labels_out[order] = [labels[i] for i in order]
    # relabel in original order
    out = np.empty(len(values), dtype=int)
    for pos, i in enumerate(order):
        out[i] = labels[i]
    return out


class RegionSeparatorDetector:
    """Cluster separator positions inside filtered regions into column /
    divider coordinates with sufficient coverage."""

    def __init__(self, filters, label, axis, min_distance=20,
                 coverage_ratio=0.3):
        self._filter = RegionsFilter(filters)
        self._label = label
        self._axis = axis
        self._min_distance = min_distance
        self._coverage_ratio = coverage_ratio

    def __call__(self, regions):
        contours = {k: v for k, v in regions.contours.items()
                    if self._filter(k)}
        if not contours:
            return {}
        keys = list(contours.keys())
        polys = [contours[k] for k in keys]
        tree = G.STRtree(polys)
        seps = collections.defaultdict(list)
        labels = (self._label,) if isinstance(self._label, str) \
            else tuple(self._label)
        sep_geoms = [g for lbl in labels
                     for g in regions.separators.for_label(lbl)]
        for sep in sep_geoms:
            for i in tree.query_indices(sep):
                i = int(i)
                inter = polys[i].intersection(sep)
                if inter.is_empty:
                    continue
                coords = inter._all_coords()
                if len(coords) < 2:
                    continue
                mx = float(np.median(coords[:, self._axis]))
                lo = float(np.min(coords[:, 1 - self._axis]))
                hi = float(np.max(coords[:, 1 - self._axis]))
                seps[keys[i]].append((mx, lo, hi))

        columns = {}
        for path, entries in seps.items():
            entries = np.array(entries)
            labels = _cluster_1d(entries[:, 0], self._min_distance) \
                if len(entries) > 1 else np.array([0])
            cx = []
            for i in range(labels.max() + 1):
                grp = entries[labels == i]
                sep_x = float(np.median(grp[:, 0]))
                coverage = G.IntervalTree(
                    [(lo, hi + 1, None) for _, lo, hi in grp])
                bounds = contours[path].bounds
                cmin = bounds[1 - self._axis]
                cmax = bounds[3 - self._axis]
                coords = np.zeros((2, 2))
                coords[:, self._axis] = sep_x
                coords[:, 1 - self._axis] = (cmin - 1, cmax + 1)
                divider = contours[path].intersection(
                    G.LineString(coords))
                if divider.is_empty:
                    continue
                dc = divider._all_coords()
                dmin = float(np.min(dc[:, 1 - self._axis]))
                dmax = float(np.max(dc[:, 1 - self._axis]))
                dlen = max(dmax - dmin, 1e-6)
                clen = coverage.coverage(dmin, dmax)
                if clen / dlen > self._coverage_ratio:
                    cx.append(sep_x)
            columns[path] = sorted(cx)
        return columns


def divide_shape(shape, dividers, axis):
    """Split a shape at the given axis positions into ordered pieces."""
    if not dividers:
        return [shape]
    rest = shape
    areas = []
    for div in sorted(dividers):
        bounds = np.array(rest.bounds if not rest.is_empty
                          else shape.bounds).reshape(2, 2)
        p0 = bounds[0] - 1
        p1 = bounds[1] + 1
        p0[axis] = div
        p1[axis] = div
        line = G.LineString([p0, p1])
        pieces = split_polygon(rest, line) if not rest.is_empty else []
        bins = ([], [])
        for geom in pieces:
            c = geom.centroid
            coord = (c.x, c.y)[axis]
            bins[0 if coord < div else 1].append(geom)
        parts = []
        for i in (0, 1):
            geoms = bins[i]
            if len(geoms) > 1:
                parts.append(G.unary_union(geoms).convex_hull)
            elif len(geoms) == 1:
                parts.append(geoms[0])
            else:
                parts.append(G.GEOMETRY_EMPTY)
        areas.append(parts[0])
        rest = parts[1]
    areas.append(rest)
    return areas


def find_table_headers(areas, line_h):
    if line_h is None:
        return
    for i, area in enumerate(areas):
        if area.geom_type == "Polygon":
            _, miny, _, maxy = area.bounds
            if maxy - miny < 3 * line_h:
                yield i


def _map_dict(values, mapping):
    out = {}
    for k, v in values.items():
        for k2 in mapping.get(k, [k]):
            out[k2] = v
    return out


def subdivide_table_blocks(filters, regions, columns, dividers):
    """Split TABULAR regions into division blocks (X.1.1.1-style ids);
    header divisions additionally split per column (reference
    layout.py:1245-1316)."""
    split_map = collections.defaultdict(list)
    split_contours = {}
    filt = RegionsFilter(filters)

    for k, contour in regions.contours.items():
        if not filt(k):
            split_contours[k] = contour
            continue
        block_path = k[:3]
        block_id = block_path[-1]

        def make_id(division, row, column):
            pos = [str(x) for x in (division, row, column) if x]
            return "%s.%s" % (block_id, ".".join(pos))

        hs = regions.line_heights(k)
        line_h = float(np.median(hs)) if len(hs) >= 2 else None

        areas = divide_shape(contour, dividers.get(k, []), 1)
        for i in list(find_table_headers(areas, line_h)):
            areas[i] = divide_shape(areas[i], columns.get(k, []), 0)

        for i, area_y in enumerate(areas):
            if isinstance(area_y, list):
                for j, area_xy in enumerate(area_y):
                    split_contours[
                        block_path[:2] + (make_id(i + 1, 1, j + 1),)] \
                        = area_xy
            else:
                split_k = block_path[:2] + (make_id(i + 1, 1, 1),)
                if k in columns:
                    split_map[k].append(split_k)
                split_contours[split_k] = area_y

    return (split_contours,
            _map_dict(columns, split_map),
            _map_dict(dividers, split_map))


def _to_table_dict(items):
    return {"/".join(path): [round(float(x), 1) for x in xs]
            for path, xs in items.items()}


# ---------------------------------------------------------------------------
# the stage
# ---------------------------------------------------------------------------

class LayoutDetectionProcessor(BatchedProcessor):
    """One page per batch: a page that fails is recorded FAILED on its
    own and the stage goes on with the next."""

    POOLED = True

    def __init__(self, options):
        super().__init__(options, batch_size=1)
        self._transformer = load_layout(
            options.get("layout", "bbz")).make_transformer()
        # T and V: a vertical stroke inside a TABULAR region is a table
        # divider whatever the pixel classifier called it
        self._col_detector = RegionSeparatorDetector(
            "regions/TABULAR", ("separators/T", "separators/V"), axis=0)
        self._div_detector = RegionSeparatorDetector(
            "regions/TABULAR", "separators/H", axis=1)

    @property
    def processor_name(self):
        return STAGE_NAME

    def artifacts(self):
        return [
            ("warped", Input(Artifact.CONTOURS, Artifact.LINES,
                             Artifact.SEGMENTATION, stage=Stage.WARPED)),
            ("dewarped", Input(Artifact.CONTOURS, stage=Stage.DEWARPED)),
            ("output", Output(Artifact.CONTOURS, Artifact.TABLES,
                              stage=Stage.AGGREGATE)),
        ]

    def process_batch(self, pages):
        return {p: self.process(p, kw["warped"], kw["dewarped"],
                                kw["output"])
                for p, kw in pages}

    def process(self, page_path, warped, dewarped, output):
        blocks = dewarped.regions.by_path
        if not blocks:
            output.tables(dict(version=1, columns={}, dividers={}))
            with output.contours(copy_meta_from=dewarped):
                pass
            return {}

        regions = RegionState(
            dewarped.page,
            warped.lines.by_path,
            [(k, b.image_space_polygon) for k, b in blocks.items()],
            dewarped.separators,
            warped.segmentation,
            grid=dewarped.grid)

        # queue the device binarization now: the transformer's early host
        # operators run while the card works, FixSpillOver reads it later
        regions.start_binarize()
        self._transformer(regions)

        split_contours, columns, dividers = subdivide_table_blocks(
            "regions/TABULAR", regions,
            columns=self._col_detector(regions),
            dividers=self._div_detector(regions))

        output.tables(dict(
            version=1,
            columns=_to_table_dict(columns),
            dividers=_to_table_dict(dividers)))

        with output.contours(copy_meta_from=dewarped) as zf:
            for path, shape in split_contours.items():
                if shape.is_empty:
                    continue
                zf.writestr("/".join(path) + ".wkt",
                            shape.wkt.encode("utf8"))
        return dict(n_regions=len(split_contours),
                    sauvola_window=regions.sauvola_window())


def load_layout(name):
    """The rule set origami_tpu_torch.custom.layouts.<name>."""
    try:
        return importlib.import_module(
            "origami_tpu_torch.custom.layouts.%s" % name)
    except ModuleNotFoundError:
        raise ValueError("layout %s not found in "
                         "origami_tpu_torch.custom.layouts" % name)


def parser():
    p = argparse.ArgumentParser(
        prog="python -m origami_tpu_torch.batch.detect.layout",
        description="Refine layout for documents in DATA_PATH.")
    p.add_argument("--layout", type=str, default="bbz",
                   help="Name of the layout rule set to apply.")
    p.add_argument("data_path", type=str)
    Processor.add_arguments(p)
    return p


def main(argv=None):
    p = parser()
    args = p.parse_args(argv)
    if not Path(args.data_path).exists():
        raise SystemExit("no such path: %s" % args.data_path)
    try:
        load_layout(args.layout)
    except ValueError as e:
        p.error(str(e))
    LayoutDetectionProcessor(vars(args)).traverse(args.data_path)
    # one JSON line: how often each kernel ran (read by chip_smoke.py)
    print(json.dumps({"kernel_launches": kernel_launches()}), flush=True)


if __name__ == "__main__":
    main()
