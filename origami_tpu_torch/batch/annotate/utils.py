"""Shared rendering helpers of the annotate debug renders.

Port of origami_tpu/batch/annotate/utils.py, which draws with cv2 on a
(H, W, 3) uint8 BGR canvas and saves a JPEG through PIL. The port has
neither, so it draws the same pixels itself and writes PIL's JPEG bytes
of them (core/_jpeg.encode, RGB at quality 85):

  * `to_canvas`: the page lightened in float32 (px * 0.6 + 102), clipped
    and truncated, as the numpy expression of the JAX module;
  * fills: cv2.fillPoly through `geometry/raster._fill_polygon`, blended
    as cv2.addWeighted does for uint8 (float32, fma(src1, alpha,
    src2 * beta), rounded half to even);
  * outlines and arrows: cv2.polylines / cv2.line at LINE_8, thickness 1
    as Bresenham lines, thicker as OpenCV's ThickLine (`_draw_segments`,
    `_stroke`), arrow tips as cv2.arrowedLine places them;
  * points: cv2.circle filled, radius 3.

Each primitive draws into a uint8 mask over the bounding box of its
points, grown by a margin that holds the strokes and cut to the canvas,
and the colour is set per channel where the mask is set.

Labels are the one exception: cv2.putText's Hershey strokes are not in
the repo, so a label is drawn with the glyph atlas of train/draw.py
(DejaVu Sans) inside `label_box`, a box that holds cv2's ink for the
same text at the same origin. The renders equal the JAX module's on
every pixel outside the label boxes (ROADMAP C8).
"""

from __future__ import annotations

import math

import numpy as np

from origami_tpu_torch.core import _jpeg
from origami_tpu_torch.geometry.raster import (
    _draw_segments, _fill_circle, _fill_polygon, _stroke)

# distinct, print-friendly overlay colors (BGR, as the JAX module's)
LABEL_COLORS = {
    "TEXT": (180, 119, 31),
    "TABULAR": (14, 127, 255),
    "ILLUSTRATION": (44, 160, 44),
    "H": (40, 39, 214),
    "V": (189, 103, 148),
    "T": (75, 86, 140),
}
DEFAULT_COLOR = (127, 127, 127)

# cv2.getTextSize(c, FONT_HERSHEY_SIMPLEX, 1.0, 0) width of each
# printable ASCII character, " " to "~"
_HERSHEY_ADVANCE = dict(zip(map(chr, range(32, 127)), (
    8, 8, 11, 21, 18, 22, 21, 7, 18, 18, 13, 18, 8, 14, 8, 14, 18, 18, 18,
    18, 18, 18, 18, 18, 18, 18, 8, 8, 15, 17, 15, 16, 25, 20, 20, 20, 20,
    18, 17, 20, 21, 8, 19, 18, 17, 23, 21, 20, 19, 20, 19, 18, 17, 21, 19,
    24, 19, 19, 18, 10, 14, 10, 13, 22, 10, 16, 18, 16, 18, 17, 12, 18,
    18, 7, 8, 15, 8, 26, 18, 17, 18, 18, 11, 15, 12, 18, 16, 24, 16, 16,
    15, 11, 7, 11, 17)))
LABEL_SCALE = 0.6         # putText's fontScale in the JAX module
LABEL_FONT = ("sans", 16)  # the atlas font the port draws labels in


def color_for(label):
    return LABEL_COLORS.get(label, DEFAULT_COLOR)


def to_canvas(page_pixels):
    """Grayscale page -> BGR canvas, lightened for overlay contrast."""
    px = np.asarray(page_pixels).astype(np.float32)
    lit = (px * np.float32(0.6) + np.float32(255 * 0.4)).clip(0, 255) \
        .astype(np.uint8)
    return np.repeat(lit[:, :, None], 3, axis=2)


def _add_weighted(src1, alpha, src2):
    """cv2.addWeighted(src1, alpha, src2, 1 - alpha, 0) on uint8: in
    float32, fma(src1, alpha, src2 * beta) (one rounding each), then
    saturate_cast (round half to even, clip)."""
    a, b = np.float32(alpha), np.float32(1 - alpha)
    inner = src2.astype(np.float32) * b
    # src1 * a is exact in float64, and so is the sum: one rounding
    out = (src1.astype(np.float64) * np.float64(a)
           + inner.astype(np.float64)).astype(np.float32)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def _paint(canvas, pts, margin, draw, color, alpha=None):
    """draw(mask, pts) into a uint8 mask over the points' bounding box
    grown by `margin` and cut to the canvas, then set `color` where the
    mask is set, or blend it in with `alpha`. Each crop edge is either
    the canvas's or `margin` (more than a stroke reaches) beyond every
    point, and the drawing is the same under whole-pixel shifts, so the
    strokes are clipped where cv2 clips them on the whole canvas."""
    h, w = canvas.shape[:2]
    pts = np.asarray(pts, np.int64).reshape(-1, 2)
    if not len(pts):
        return
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    x0, y0 = max(int(lo[0]) - margin, 0), max(int(lo[1]) - margin, 0)
    x1, y1 = min(int(hi[0]) + margin, w - 1), min(int(hi[1]) + margin, h - 1)
    if x0 > x1 or y0 > y1:
        return
    mask = np.zeros((y1 - y0 + 1, x1 - x0 + 1), np.uint8)
    draw(mask, pts - (x0, y0))
    sel = mask.astype(bool)
    sub = canvas[y0: y1 + 1, x0: x1 + 1]
    color = np.asarray(color, np.uint8)
    if alpha is None:
        sub[sel] = color
    else:
        sub[sel] = _add_weighted(np.broadcast_to(color, (int(sel.sum()), 3)),
                                 alpha, sub[sel])


def polylines(canvas, pts, closed, color, thickness=1):
    """cv2.polylines(canvas, [pts], closed, color, thickness)."""
    pts = np.asarray(pts, np.int64).reshape(-1, 2)
    if thickness <= 1:
        _paint(canvas, pts, 2, lambda m, p: _draw_segments(m, p, closed, 1),
               color)
        return
    if closed and len(pts):
        # PolyLine's closing segment first: every vertex gets a cap
        pts = np.concatenate([pts, pts[:1]])
    _paint(canvas, pts, thickness + 2,
           lambda m, p: _stroke(m, p, thickness, 1), color)


def fill_poly(canvas, pts, color, alpha):
    """cv2.fillPoly on a copy of the canvas, blended back with
    cv2.addWeighted(copy, alpha, canvas, 1 - alpha, 0, canvas): outside
    the polygon the blend gives the canvas back."""
    _paint(canvas, pts, 1, lambda m, p: _fill_polygon(m, p, 1), color,
           alpha)


def circle(canvas, center, radius, color):
    """cv2.circle(canvas, center, radius, color, -1)."""
    cx, cy = center
    _paint(canvas, [(cx, cy)], radius + 1,
           lambda m, p: _fill_circle(m, p[0], radius, 1), color)


def label_box(label, org):
    """(x0, y0, x1, y1), x1 and y1 exclusive: the box that holds cv2's
    putText(label, org, FONT_HERSHEY_SIMPLEX, 0.6, thickness 2) ink and
    the port's label, from the Hershey advances of the label's
    characters."""
    width = sum(_HERSHEY_ADVANCE.get(c, 26) for c in str(label))
    x, y = (int(v) for v in org)
    return (x - 2, y - 18, x + int(math.ceil(width * LABEL_SCALE)) + 3,
            y + 8)


def put_label(canvas, label, org, color):
    """The label in DejaVu Sans from the glyph atlas, its pen at `org` on
    the baseline, blended per channel and clipped to `label_box`;
    characters the atlas lacks are drawn as '?'. -> the box."""
    from origami_tpu_torch.train import draw
    font = draw.font(*LABEL_FONT)
    text = "".join(c if c in draw.CHARSET else "?" for c in str(label))
    box = label_box(label, org)
    cov = draw.coverage(org, text, font)
    if cov is None:
        return box
    mask, mx, my = cov
    h, w = canvas.shape[:2]
    x0, y0 = max(box[0], mx, 0), max(box[1], my, 0)
    x1 = min(box[2], mx + mask.shape[1], w)
    y1 = min(box[3], my + mask.shape[0], h)
    if x0 < x1 and y0 < y1:
        m = mask[y0 - my: y1 - my, x0 - mx: x1 - mx, None]
        bg = canvas[y0:y1, x0:x1].astype(np.int32)
        fill = np.asarray(color, np.int32)
        canvas[y0:y1, x0:x1] = draw._div255(bg * (255 - m) + fill * m)
    return box


def draw_geometry(canvas, geom, color, thickness=2, fill_alpha=0.15,
                  label=None):
    """Draw `geom` as the JAX module does; -> the label boxes drawn."""
    t = geom.geom_type
    boxes = []
    if t == "Polygon":
        pts = np.round(geom.np_shell).astype(np.int32)
        if fill_alpha > 0:
            fill_poly(canvas, pts, color, fill_alpha)
        polylines(canvas, pts, True, color, thickness)
        if label:
            c = pts.mean(axis=0).astype(int)
            boxes.append(put_label(canvas, label, tuple(c), color))
    elif t == "MultiPolygon":
        for g in geom.geoms:
            boxes += draw_geometry(canvas, g, color, thickness, fill_alpha,
                                   label)
            label = None
    elif t in ("LineString", "LinearRing"):
        pts = np.round(geom.np_coords).astype(np.int32)
        polylines(canvas, pts, False, color, thickness)
    elif t == "MultiLineString":
        for g in geom.geoms:
            boxes += draw_geometry(canvas, g, color, thickness)
    elif t == "Point":
        circle(canvas, (int(geom.x), int(geom.y)), 3, color)
    return boxes


def draw_arrow(canvas, p0, p1, color, thickness=2):
    """cv2.arrowedLine(canvas, p0, p1, color, thickness, tipLength=0.05):
    the shaft, then two tip lines of 0.05 x its length at +-pi/4."""
    p0 = tuple(map(int, p0))
    p1 = tuple(map(int, p1))
    dx, dy = p0[0] - p1[0], p0[1] - p1[1]
    tip = math.sqrt(dx * dx + dy * dy) * 0.05  # cv::norm
    # cv2.line is polylines of one segment: LINE_8, both caps
    polylines(canvas, [p0, p1], False, color, thickness)
    angle = math.atan2(dy, dx)
    for turn in (math.pi / 4, -math.pi / 4):
        p = (round(p1[0] + tip * math.cos(angle + turn)),
             round(p1[1] + tip * math.sin(angle + turn)))
        polylines(canvas, [p, p1], False, color, thickness)


class AnnotateWriter:
    """Bridges a BGR canvas to the Writer.annotation contract: an RGB
    JPEG at quality 85, as the JAX module's save_jpeg writes it.
    `label_boxes` are the boxes the labels were drawn in."""

    def __init__(self, canvas, label_boxes=()):
        self.canvas = canvas
        self.label_boxes = list(label_boxes)

    def save(self, path):
        _jpeg.write(path, self.canvas[:, :, ::-1], 85)
