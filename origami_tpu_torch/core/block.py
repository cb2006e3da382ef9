"""Blocks and text lines: what line extraction needs of them.

Port of the extraction side of origami_tpu/core/block.py. A `Block` binds
a region to its page (the region polygon is not parsed: the strip frames
never use it); a `Line` keeps the p/right/up frame and confidence of the
lines.N.zip JSON (docs/formats.md#lineszip) and builds the (2, 3) strip
frames the strip kernel consumes. `Lines.open` reads lines.N.zip and
drops lines whose block is not among the regions (block.py:444-460).
"""

from __future__ import annotations

import json
import math
import zipfile

import numpy as np

# Canonical recognizer framing (block.py:89-98): the detected band is the
# ink extent; padding it by these fractions of its height before the
# scale-to-height puts serving strips at the centre of the recognizer's
# training distribution.
BAND_PAD = (0.28, 0.12)


class Block:
    """A region bound to a page at some stage."""

    def __init__(self, page, path, stage):
        self._page = page
        self._path = tuple(path)
        self._stage = stage

    @property
    def page(self):
        return self._page

    @property
    def path(self):
        return self._path

    @property
    def stage(self):
        return self._stage


class Line:
    """A text line: rectangle frame (p + right + up) and confidence."""

    def __init__(self, block, p, right, up, confidence=1,
                 tesseract_data=None, wkt=None, text_area=None):
        # wkt / tesseract_data / text_area are read and dropped: the
        # extraction frames never use them
        self._block = block
        self._p = np.asarray(p, dtype=np.float64)
        self._right = np.asarray(right, dtype=np.float64)
        self._up = np.asarray(up, dtype=np.float64)
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
    def confidence(self):
        if isinstance(self._confidence, dict):
            vals = [v for k, v in self._confidence.items()
                    if not k.endswith("/BACKGROUND")]
            return max(vals) if vals else 0.0
        return float(self._confidence)

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
