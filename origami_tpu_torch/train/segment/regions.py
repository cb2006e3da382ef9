"""GT region generation: deskewed master annotations + stopper geometry.

Port of origami_tpu/train/segment/regions.py, host code without cv2.
From a page's non-separator GT labels and the cleaned separator
polylines (segments.py) it derives, in a deskewed frame,

  * the MASTER annotation raster: separators painted at their natural
    thickness over the non-separator labels, and
  * the STOPS raster: the same, but each separator EXTENDED along its
    end directions by a per-class amount and clipped against the other
    segments; extended separators act as barriers ("stoppers") that
    region growth must not cross.

cv2's pieces come from the port's raster bridge (geometry/raster.py):
getRotationMatrix2D and warpAffine (`rotation_matrix_2d`,
`warp_affine_u8`), polylines (`_stroke`, which clips a thick stroke off
the raster as cv2 5 does) and connectedComponents
(geometry/contour_trace.py, cv2's label numbering); the closing is
ops/morphology's dilation and erosion, whose borders are cv2's for a
rectangular odd kernel.
"""

from __future__ import annotations

import math

import numpy as np

import torch

from origami_tpu_torch import geometry as G
from origami_tpu_torch.core.polyline import Polyline
from origami_tpu_torch.geometry import raster
from origami_tpu_torch.geometry.contour_trace import (
    connected_components_with_stats)
from origami_tpu_torch.ops.morphology import dilate, erode
from origami_tpu_torch.train.segment.skew import ransac_angle


def estimate_skew(segments_by_class, horizontal_classes=("H", "T")):
    """Page skew from the cleaned horizontal separator segments."""
    segs = []
    for cls, polylines in segments_by_class.items():
        if cls not in horizontal_classes:
            continue
        for pl in polylines:
            c = pl.np_coords
            segs.append((c[0, 0], c[0, 1], c[-1, 0], c[-1, 1]))
    if not segs:
        return 0.0
    return ransac_angle(segs)


class Deskewing:
    """Rotation about the raster center that REMOVES the given skew:
    strokes of image-coordinate slope `skew` (radians, y down) come out
    level. Maps masks and polylines consistently."""

    def __init__(self, shape, skew):
        h, w = shape
        self.skew = float(skew)
        self.shape = (h, w)
        # cv2's positive angle maps slope +a to level for angle == +a
        # (y-down coordinates)
        self.matrix = raster.rotation_matrix_2d(
            (w / 2.0, h / 2.0), math.degrees(skew), 1.0)

    def pixels(self, pixels, nearest=True):
        """The uint8 raster rotated: nearest, or cv2's INTER_AREA (which
        warpAffine runs as INTER_LINEAR); the border replicated."""
        h, w = self.shape
        return raster.warp_affine_u8(pixels, self.matrix, (w, h), nearest)

    def polyline(self, pl):
        m = self.matrix

        def f(xs, ys):
            return (m[0, 0] * xs + m[0, 1] * ys + m[0, 2],
                    m[1, 0] * xs + m[1, 1] * ys + m[1, 2])
        return pl.mapped(f)


def _clip_extension(extended, original, others):
    """Clip an extended polyline against other segments: when the
    extension crosses another separator, keep the longer piece
    (reference gen/regions.py:89-97 via shapely.ops.split)."""
    line = extended.line_string
    for other in others:
        inter = line.intersection(other.line_string)
        if inter.is_empty:
            continue
        pts = []
        if inter.geom_type == "Point":
            pts = [(inter.x, inter.y)]
        elif inter.geom_type == "MultiPoint":
            pts = [(p.x, p.y) for p in inter.geoms]
        if not pts:
            continue
        # split at each crossing; keep the longer side, and never cut
        # into the ORIGINAL extent
        for px, py in pts:
            t = line.project(G.Point(px, py))
            la = t
            lb = line.length - t
            cut = line.substring(0.0, t) if la >= lb \
                else line.substring(t, line.length)
            if cut.length + 1e-6 >= original.line_string.length:
                line = cut
    return Polyline(line.np_coords, extended.width, extended.error)


def extend_and_clip(segments_by_class, extend_amounts):
    """Extend each class's polylines by its stopper amount, clipping
    extensions on other segments. Returns a new {class: [Polyline]}."""
    flat = [(cls, pl) for cls, pls in segments_by_class.items()
            for pl in pls]
    out = {cls: [] for cls in segments_by_class}
    for i, (cls, pl) in enumerate(flat):
        amount = extend_amounts.get(cls, 0)
        if amount <= 0:
            out[cls].append(pl)
            continue
        ext = pl.extended(amount)
        others = [q for j, (_, q) in enumerate(flat) if j != i]
        out[cls].append(_clip_extension(ext, pl, others))
    return out


class AnnotationsGenerator:
    """Deskewed master + stops rasters for one GT page.

    label_set: train.segment.labels.LabelSet; non_separator_labels: the
    region-kind GT raster; segments_by_class: {sep class name:
    [Polyline]} from segments.clean_separators."""

    def __init__(self, label_set, non_separator_labels,
                 segments_by_class, segment_thickness=1.0,
                 segment_extend=None):
        self._label_set = label_set
        self._labels = np.asarray(non_separator_labels)
        self._segments = segments_by_class
        self._thickness = float(segment_thickness)
        self._extend = dict(segment_extend or {})

        self.skew = estimate_skew(segments_by_class)
        self.deskewing = Deskewing(self._labels.shape, self.skew)
        self._deskewed_segments = {
            cls: [self.deskewing.polyline(pl) for pl in pls]
            for cls, pls in segments_by_class.items()}

    @property
    def segments(self):
        return self._deskewed_segments

    def _paint(self, segments_by_class, base):
        data = base.copy()
        for cls, pls in segments_by_class.items():
            index = self._label_set.label("separator", cls).index
            for pl in pls:
                th = max(2, int(math.floor(pl.width * self._thickness)))
                pts = np.round(pl.np_coords).astype(np.int32)
                raster._stroke(data, pts, th, int(index))
        return data

    @property
    def master(self):
        """Deskewed labels with separators at natural thickness."""
        base = self.deskewing.pixels(self._labels)
        return self._paint(self._deskewed_segments, base)

    @property
    def stops(self):
        """Deskewed labels with EXTENDED separators — the stopper
        raster bounding region growth."""
        base = self.deskewing.pixels(self._labels)
        extended = extend_and_clip(self._deskewed_segments,
                                   self._extend)
        return self._paint(extended, base)


def generate_regions(text_mask, stops_mask, close=(24, 12),
                     min_area=400):
    """Region candidates: close text ink into blocks, with stopper
    pixels acting as impassable barriers, then connected components.

    Returns an int32 label raster (0 = background, 1..N = regions)."""
    text = torch.from_numpy((np.asarray(text_mask) > 0)
                            .astype(np.float32))
    barrier = (np.asarray(stops_mask) > 0)
    kx, ky = int(close[0]) | 1, int(close[1]) | 1
    # cv2.morphologyEx(MORPH_CLOSE) with a (kx, ky) rectangle
    blocks = (erode(dilate(text, ky, kx), ky, kx) > 0).numpy() \
        .astype(np.uint8)
    blocks[barrier] = 0
    n, labels, _ = connected_components_with_stats(blocks)
    if min_area > 0:
        counts = np.bincount(labels.ravel(), minlength=n)
        kill = np.nonzero(counts < min_area)[0]
        if len(kill):
            labels[np.isin(labels, kill)] = 0
    return labels
