"""Blocks and text lines.

Port of origami_tpu/core/block.py (the parts the flow and OCR stages
use). A `Block` binds a region polygon to its page at a stage; a `Line`
keeps the p/right/up frame, the detection data and the confidence of the
lines.N.zip JSON (docs/formats.md#lineszip), its polygon (the line
rectangle clipped to the block's text area, or the stored WKT, kept as
text), and builds the (2, 3) strip frames the strip kernel consumes;
the lines stage scores a detected line with its label evidence
(`update_confidence`, `predicted_path`, `predicted_path_error`,
block.py:190-223) sampled on `dewarped_grid_coords` (:291-308).
`Line.image` cuts one line's strip (block.py:310-339): through the
dewarping grid's `inverse_points` and remap_batch on the dewarped route,
else the deskewed frame through ops.remap.affine_warp; `Line.ink` is the
column ink density of the deskewed binarized strip (:341-352).
`Lines.open` reads lines.N.zip and drops lines whose block is
not among the regions (block.py:444-460). `TextAreaFactory` carves a
block's text area out of its neighbours and the page's separators
(block.py:486-538).
"""

from __future__ import annotations

import json
import math
import zipfile
from functools import cached_property

import numpy as np
import torch

from origami_tpu_torch import geometry as G

# Canonical recognizer framing (block.py:89-98): the detected band is the
# ink extent; padding it by these fractions of its height before the
# scale-to-height puts serving strips at the centre of the recognizer's
# training distribution.
BAND_PAD = (0.28, 0.12)


class Block:
    """A region polygon bound to a page at some stage."""

    def __init__(self, page, polygon, stage):
        self._page = page
        self._polygon = polygon
        self._stage = stage

    @property
    def page(self):
        return self._page

    @property
    def stage(self):
        return self._stage

    @property
    def image_space_polygon(self):
        return self._polygon

    @property
    def bounds(self):
        return self._polygon.bounds

    @property
    def _dewarped(self):
        return self._stage is not None and self._stage.is_dewarped

    @property
    def page_pixels(self):
        """The page's u8 pixels (numpy) in the block's frame: dewarped
        at a dewarped stage."""
        if self._dewarped:
            return self._page.dewarped_dev.cpu().numpy()
        return self._page.warped

    @property
    def page_pixels_dev(self):
        """page_pixels as a u8 tensor on the page's device."""
        if self._dewarped:
            return self._page.dewarped_dev
        return self._page.device_pixels

    @cached_property
    def background(self):
        """Background intensity estimate: high quantile of the block
        crop."""
        x0, y0, x1, y1 = [int(v) for v in self.bounds]
        px = self.page_pixels
        x0 = max(0, x0)
        y0 = max(0, y0)
        x1 = min(px.shape[1], x1 + 1)
        y1 = min(px.shape[0], y1 + 1)
        if x1 <= x0 or y1 <= y0:
            return 255
        crop = px[y0:y1, x0:x1]
        return float(np.quantile(crop, 0.8))


class Line:
    """A text line: rectangle frame (p + right + up), polygon,
    confidence and detection data."""

    def __init__(self, block, p, right, up, tesseract_data=None,
                 wkt=None, text_area=None, confidence=1):
        self._block = block
        self._p = np.asarray(p, dtype=np.float64)
        self._right = np.asarray(right, dtype=np.float64)
        self._up = np.asarray(up, dtype=np.float64)
        self._data = tesseract_data or {}
        self._wkt = wkt or None
        self._polygon = None
        if not self._wkt:
            rect = G.Polygon([
                self._p, self._p + self._right,
                self._p + self._right + self._up, self._p + self._up])
            if text_area is not None:
                rect._convex_memo = True
                # hull(text_area ∩ rect) without the exact overlay: one
                # Sutherland-Hodgman pass per shell + a hull
                from origami_tpu_torch.geometry.ops import clip_hull
                inter = clip_hull(text_area, rect)
                if inter is None:              # unsupported input type
                    inter = text_area.intersection(rect)
                    inter = inter.convex_hull if not inter.is_empty \
                        else rect
                rect = inter if inter.geom_type == "Polygon" \
                    and not inter.is_empty else rect
            self._polygon = rect
        self._confidence = confidence

    @property
    def block(self):
        return self._block

    @property
    def p(self):
        return self._p

    @property
    def right(self):
        return self._right

    @property
    def up(self):
        return self._up

    @property
    def image_space_polygon(self):
        """The line's polygon; one read from lines.N.zip is parsed from
        its WKT at first use."""
        if self._polygon is None:
            self._polygon = G.wkt.loads(self._wkt)
        return self._polygon

    @property
    def baseline(self):
        bl = self._data.get("baseline")
        if bl is None:
            return [list(self._p), list(self._p + self._right)]
        return bl

    @property
    def center(self):
        p1, p2 = self.baseline
        return (np.asarray(p1) + np.asarray(p2)) / 2.0

    @property
    def angle(self):
        return math.atan2(self._right[1], self._right[0])

    @property
    def length(self):
        return float(np.linalg.norm(self._right))

    @property
    def height(self):
        return float(np.linalg.norm(self._up))

    @property
    def info(self):
        """The lines.N.zip JSON (docs/formats.md#lineszip)."""
        return dict(
            p=[float(v) for v in self._p],
            right=[float(v) for v in self._right],
            up=[float(v) for v in self._up],
            wkt=self._wkt or self._polygon.wkt,
            confidence=self._confidence,
            tesseract_data=_jsonable(self._data))

    # -- confidence: a number, or {"pred/CLASS": evidence} ---------------
    @property
    def confidence(self):
        if isinstance(self._confidence, dict):
            vals = [v for k, v in self._confidence.items()
                    if not k.endswith("/BACKGROUND")]
            return max(vals) if vals else 0.0
        return float(self._confidence)

    def update_confidence(self, confidence):
        self._confidence = confidence

    def _best_evidence(self):
        if not isinstance(self._confidence, dict):
            return None
        items = [(k, v) for k, v in self._confidence.items()
                 if not k.endswith("/BACKGROUND")]
        if not items:
            return None
        return max(items, key=lambda kv: kv[1])

    @property
    def predicted_path(self):
        best = self._best_evidence()
        return None if best is None else tuple(best[0].split("/"))

    def predicted_path_error(self, path):
        """How much more evidence the best class has than `path`'s."""
        best = self._best_evidence()
        if best is None or tuple(best[0].split("/")) == tuple(path):
            return 0.0
        return best[1] - self._confidence.get("/".join(path), 0.0)

    def _column_extent(self, column):
        """(p0, right) clipped to a table column's x range."""
        p0, right = self._p, self._right
        if column is None:
            return p0, right
        x0, x1 = column
        bx0 = min(p0[0], (p0 + right)[0])
        bx1 = max(p0[0], (p0 + right)[0])
        if x0 is None:
            x0 = bx0
        if x1 is None:
            x1 = bx1
        denom = max(bx1 - bx0, 1e-6)
        t0 = (x0 - bx0) / denom
        t1 = (x1 - bx0) / denom
        return p0 + right * t0, right * max(t1 - t0, 1e-6)

    def dewarped_frame(self, target_height, xres=1.0, column=None,
                       pad=None):
        """((2, 3) float32 affine, width): strip pixel (x, y, 1) ->
        dewarped page coords (block.py:268-289). pad=(top, bottom)
        extends the band by those fractions of its height."""
        p0, right = self._column_extent(column)
        up = self._up
        if pad:
            pt, pb = pad
            p0 = p0 - up * pb
            up = up * (1.0 + pt + pb)
        width = max(2, int(math.ceil(np.linalg.norm(right) * xres)))
        dx = right / (width - 1)
        dy = -up / max(target_height - 1, 1)
        origin = p0 + up
        frame = np.array([[dx[0], dy[0], origin[0]],
                          [dx[1], dy[1], origin[1]]], np.float32)
        return frame, width

    def deskewed_frame(self, target_height):
        """(2, 3) affine mapping strip (x, y) -> page coords: x spans
        `right`, y runs top(0) -> bottom(target_height-1) down `up`."""
        width = max(2, int(math.ceil(self.length)))
        h = max(target_height - 1, 1)
        ex = self._right / max(width - 1, 1)
        ey = -self._up / h          # strip y grows downward; up points up
        origin = self._p + self._up  # strip (0, 0) is the top-left corner
        return np.array([
            [ex[0], ey[0], origin[0]],
            [ex[1], ey[1], origin[1]]]), width

    def dewarped_grid_coords(self, target_height, xres=1.0, column=None,
                             pad=None):
        """Dewarped-space sample grid (target_height, W, 2) of the line:
        rows from its top (p + up) down to p, columns along `right`;
        `column` and `pad` as dewarped_frame's."""
        p0, right = self._column_extent(column)
        up = self._up
        if pad:
            pt, pb = pad
            p0 = p0 - up * pb
            up = up * (1.0 + pt + pb)
        width = max(2, int(math.ceil(np.linalg.norm(right) * xres)))
        xs = np.linspace(0.0, 1.0, width)
        ys = np.linspace(1.0, 0.0, target_height)
        return (p0[None, None, :]
                + ys[:, None, None] * up[None, None, :]
                + xs[None, :, None] * right[None, None, :])

    def image(self, target_height=48, column=None, dewarped=True,
              deskewed=True, binarizer=None):
        """Single-line extraction (the batch path is LineExtractor) on
        the page's device -> u8 numpy strip. Dewarped (with a grid): the
        padded band's sample grid through the grid's inverse_points,
        sampled from the warped page by remap_batch; else the deskewed
        frame through affine_warp."""
        from origami_tpu_torch.ops import remap as _remap
        page = self._block.page
        fill = float(self._block.background)
        if dewarped and page.grid is not None:
            # aspect-preserving: x sampled at the same magnification
            # the (padded) band -> target_height scaling applies in y
            pt, pb = BAND_PAD
            band_h = float(np.linalg.norm(self._up)) * (1.0 + pt + pb)
            xres = target_height / max(band_h, 1.0)
            coords = self.dewarped_grid_coords(target_height,
                                               xres=xres, column=column,
                                               pad=BAND_PAD)
            warped = page.grid.inverse_points(
                coords.reshape(-1, 2)).reshape(coords.shape)
            maps = torch.from_numpy(warped.astype(np.float32)[None]) \
                .to(page.device)
            out = _remap.remap_batch(page.device_pixels.float()[None], maps,
                                     fill, border="hard")[0]
        else:
            frame, width = self.deskewed_frame(target_height)
            out = _remap.affine_warp(self._block.page_pixels_dev.float(),
                                     frame, (target_height, width), fill)
        out = np.clip(out.cpu().numpy(), 0, 255).astype(np.uint8)
        if binarizer is not None:
            out = binarizer(out)
        return out

    @cached_property
    def ink(self):
        """Per-column ink density of the deskewed binarized strip."""
        from origami_tpu_torch.ops import remap as _remap
        page = self._block.page
        height = max(2, int(math.ceil(self.height)))
        frame, width = self.deskewed_frame(height)
        binar = torch.from_numpy(page.binarized).to(page.device) \
            .float() * 255.0
        strip = _remap.affine_warp(binar, frame, (height, width), 255.0) \
            .cpu().numpy()
        return 1.0 - np.mean(strip / 255.0, axis=0)


def _jsonable(d):
    out = {}
    for k, v in d.items():
        if isinstance(v, np.ndarray):
            out[k] = v.tolist()
        elif isinstance(v, (np.floating, np.integer)):
            out[k] = float(v)
        elif isinstance(v, (list, tuple)):
            out[k] = [_jsonable({"": x})[""] if isinstance(x, dict)
                      else (x.tolist() if isinstance(x, np.ndarray) else x)
                      for x in v]
        else:
            out[k] = v
    return out


class Regions:
    """Regions keyed by artifact path tuple ("regions", "TEXT", "0")."""

    def __init__(self, blocks):
        self._blocks = dict(blocks)

    @property
    def by_path(self):
        return self._blocks

    def __len__(self):
        return len(self._blocks)


class Lines:
    """Lines keyed by path tuple ("regions", "TEXT", "0", "3")."""

    def __init__(self, lines, meta=None):
        self._lines = dict(lines)
        self._meta = meta or dict(version=1)

    @staticmethod
    def open(path, regions, open=open):
        blocks = regions.by_path
        meta = dict(version=1)
        lines = {}
        with open(path, "rb") as f:
            with zipfile.ZipFile(f, "r") as zf:
                for name in zf.namelist():
                    if name == "meta.json":
                        meta = json.loads(zf.read(name))
                        continue
                    if not name.endswith(".json"):
                        continue
                    parts = tuple(name[:-5].split("/"))
                    block = blocks.get(tuple(parts[:3]))
                    if block is None:
                        continue
                    lines[parts] = Line(block, **json.loads(zf.read(name)))
        return Lines(lines, meta)

    @property
    def meta(self):
        return self._meta

    @property
    def min_confidence(self):
        return self._meta.get("min_confidence", 0.5)

    @property
    def by_path(self):
        return self._lines

    def __len__(self):
        return len(self._lines)


class TextAreaFactory:
    """Text area of a block = its polygon minus buffered neighbour blocks
    and minus pre-buffered areal obstacles (the page's separators), the
    latter unless the caller opts out (block.py:486-538)."""

    def __init__(self, blocks=(), buffer=10, obstacles=()):
        self._blocks = list(blocks)
        self._buffer = buffer
        self._tree = G.STRtree([b.image_space_polygon for b in self._blocks])
        self._index = {id(b): i for i, b in enumerate(self._blocks)}
        self._overlaps = {}
        self._obstacles = [o for o in obstacles
                           if o is not None and not o.is_empty]
        self._obstacle_tree = (G.STRtree(self._obstacles)
                               if self._obstacles else None)

    def _interiors_overlap(self, i, j, pi, pj):
        # each candidate pair is probed from both sides: memoize the
        # symmetric answer
        from origami_tpu_torch.geometry.ops import interiors_overlap
        if i < 0:
            return interiors_overlap(pi, pj)
        key = (i, j) if i < j else (j, i)
        hit = self._overlaps.get(key)
        if hit is None:
            hit = interiors_overlap(pi, pj)
            self._overlaps[key] = hit
        return hit

    def __call__(self, block, avoid_obstacles=True):
        poly = block.image_space_polygon
        area = poly
        bi = self._index.get(id(block), -1)
        for idx in self._tree.query_indices(poly):
            other = self._blocks[idx]
            if other is block:
                continue
            if other.image_space_polygon.equals(poly):
                continue
            if self._interiors_overlap(bi, int(idx), poly,
                                       other.image_space_polygon):
                area = area.difference(
                    other.image_space_polygon.buffer(self._buffer))
        if avoid_obstacles and self._obstacle_tree is not None:
            for idx in self._obstacle_tree.query_indices(poly):
                area = area.difference(self._obstacles[int(idx)])
        return area if not area.is_empty else poly
