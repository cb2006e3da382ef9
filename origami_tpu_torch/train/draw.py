"""The subset of PIL.ImageDraw that train/synth.py draws with, on a uint8
numpy canvas, through a glyph atlas in place of PIL, FreeType, HarfBuzz
and the DejaVu fonts.

The atlas (glyphs/dejavu.npz, built by scripts/make_torch_glyph_atlas.py
from PIL itself) holds, for every (font, size) the synthetic corpus
draws in: each glyph's hinted 8-bit coverage and its offset from the
pen, its advance and control box, the GPOS pair adjustments in both
script contexts, and the GSUB ligature rules. Text is laid out and drawn
as PIL 12 with raqm does it:

  * the text is shaped into units (characters and f-ligatures), each
    ligature lookup applied over the whole text in turn, the first rule
    that matches at a position winning;
  * the pen advances by each unit's advance plus the pair adjustment to
    the next unit, in 26.6 fixed point (the Latin kern table when the
    text holds a letter, the default script's otherwise);
  * glyph k lands on the whole pixel PIXEL(start + pen_k), PIXEL(v) =
    (v + 32) >> 6, where start is the fractional part of x in 26.6,
    floor(frac * 64 + 0.5);
  * overlapping coverage combines as alpha over, a + b - ab/255, and the
    fill blends into the canvas as (bg (255 - m) + fill m) / 255, both
    with PIL's rounding division by 255.

A (font, size, character) that the atlas lacks raises, naming it.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np

ATLAS = Path(__file__).resolve().parent / "glyphs" / "dejavu.npz"

# recognizer charset: digits, latin incl. German extras, punctuation
CHARSET = (" abcdefghijklmnopqrstuvwxyz"
           "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
           "0123456789.,;:!?-'()\"/äöüßÄÖÜ")

# the (font, size) pairs synth.py draws in
# (scripts/make_torch_glyph_atlas.py lists where each comes from)
FONT_SIZES = dict(serif=range(11, 31), serif_bold=range(11, 42),
                  sans=range(11, 31))


def _pixel(v):
    return (v + 32) >> 6


def _div255(v):
    v = v + 128
    return ((v >> 8) + v) >> 8


def shape_units(text, lookups):
    """`text` as a list of units: characters, and the ligature strings of
    `lookups` ([[rule, ...], ...], each rule the characters it joins)
    applied lookup by lookup, left to right, first rule first."""
    seq = list(text)
    for rules in lookups:
        out, i = [], 0
        while i < len(seq):
            for r in rules:
                if seq[i: i + len(r)] == list(r):
                    out.append(r)
                    i += len(r)
                    break
            else:
                out.append(seq[i])
                i += 1
        seq = out
    return seq


class _Atlas:
    def __init__(self, path):
        with np.load(path) as z:
            self.meta = json.loads(str(z["meta"]))
            for k in ("adv", "box", "dxy", "hw", "off", "bits", "kern_latn",
                      "kern_dflt"):
                setattr(self, k, z[k])
        self.unit_index = {u: i for i, u in enumerate(self.meta["units"])}
        self.pair_index = {(k, s): i
                           for i, (k, s) in enumerate(self.meta["pairs"])}


_ATLAS = None
_FONTS = {}


def _atlas():
    global _ATLAS
    if _ATLAS is None:
        _ATLAS = _Atlas(ATLAS)
    return _ATLAS


class Font:
    """One (kind, size) of the atlas: what ImageFont.truetype gives."""

    def __init__(self, kind, size):
        a = _atlas()
        key = (kind, int(size))
        if key not in a.pair_index:
            raise KeyError("the glyph atlas has no font %s at size %d"
                           % key)
        self.kind, self.size = key
        p = a.pair_index[key]
        self._a = a
        self._lookups = a.meta["lookups"][kind]
        self._adv = a.adv[p]
        self._box = a.box[p]
        self._dxy = a.dxy[p]
        self._hw = a.hw[p]
        self._off = a.off[p]
        self._kern = dict(latn=a.kern_latn[p], dflt=a.kern_dflt[p])
        self._glyphs = {}

    def units(self, text):
        """Unit indices of `text`; raises for what the atlas lacks."""
        idx = []
        for u in shape_units(text, self._lookups):
            i = self._a.unit_index.get(u)
            if i is None or self._adv[i] < 0:
                raise KeyError("the glyph atlas has no glyph %r in %s %d"
                               % (u, self.kind, self.size))
            idx.append(i)
        return np.asarray(idx, np.int64)

    def layout(self, text):
        """(unit indices, pen position of each unit, advance of the
        whole text), all in 26.6."""
        u = self.units(text)
        if not len(u):
            return u, np.zeros(0, np.int64), 0
        kern = self._kern["latn" if any(c.isalpha() for c in text)
                          else "dflt"]
        step = self._adv[u].astype(np.int64)
        step[:-1] += kern[u[:-1], u[1:]]
        pen = np.concatenate([[0], np.cumsum(step)])
        return u, pen[:-1], int(pen[-1])

    def getlength(self, text):
        return self.layout(text)[2] / 64.0

    def getbbox(self, text):
        """PIL's getbbox(text, anchor="ls"): (left, top, right, bottom)."""
        u, pen, total = self.layout(text)
        x_min = x_max = y_min = y_max = 0
        for k in range(len(u)):
            px = _pixel(int(pen[k]))
            end = pen[k + 1] if k + 1 < len(u) else total
            x_lo, y_hi, x_hi, y_lo = (int(v) for v in self._box[u[k]])
            x_max = max(x_max, _pixel(int(end)), px + x_hi)
            x_min = min(x_min, px + x_lo)
            y_max = max(y_max, y_hi)
            y_min = min(y_min, y_lo)
        return x_min, -y_max, x_max, -y_min

    def glyph(self, i):
        """(coverage u8 (h, w), dx, dy) of unit `i`: its ink's top-left
        corner relative to the pen pixel on the baseline."""
        g = self._glyphs.get(i)
        if g is None:
            h, w = (int(v) for v in self._hw[i])
            o = int(self._off[i])
            cov = self._a.bits[o: o + h * w].reshape(h, w).astype(np.int32)
            g = self._glyphs[i] = (cov, int(self._dxy[i, 0]),
                                   int(self._dxy[i, 1]))
        return g


def font(kind, size):
    """The atlas font of `kind` ("serif", "serif_bold", "sans") at
    `size` px, cached."""
    key = (kind, int(size))
    if key not in _FONTS:
        _FONTS[key] = Font(*key)
    return _FONTS[key]


def coverage(xy, text, font):
    """(mask, x0, y0): the text's 8-bit coverage (int32 (h, w)) with its
    top-left corner at (x0, y0), the pen starting at xy on the baseline;
    None when nothing is inked."""
    x, y = xy
    start = math.floor(math.modf(x)[0] * 64 + 0.5)
    u, pen, _ = font.layout(text)
    glyphs = []
    for k in range(len(u)):
        cov, dx, dy = font.glyph(int(u[k]))
        if cov.size:
            glyphs.append((cov, math.floor(x) + _pixel(start + int(pen[k]))
                           + dx, int(y) + dy))
    if not glyphs:
        return None
    x0 = min(g[1] for g in glyphs)
    y0 = min(g[2] for g in glyphs)
    x1 = max(g[1] + g[0].shape[1] for g in glyphs)
    y1 = max(g[2] + g[0].shape[0] for g in glyphs)
    mask = np.zeros((y1 - y0, x1 - x0), np.int32)
    for cov, gx, gy in glyphs:
        sub = mask[gy - y0: gy - y0 + cov.shape[0],
                   gx - x0: gx - x0 + cov.shape[1]]
        sub += cov - _div255(sub * cov)
    return mask, x0, y0


def _anchor(anchor):
    if anchor != "ls":
        raise ValueError("only the 'ls' anchor is drawn, not %r" % anchor)


class Draw:
    """ImageDraw.Draw over a uint8 (H, W) canvas, modified in place."""

    def __init__(self, canvas):
        if canvas.dtype != np.uint8 or canvas.ndim != 2:
            raise ValueError("the canvas must be uint8 (H, W)")
        self.canvas = canvas

    def textlength(self, text, font):
        return font.getlength(text)

    def textbbox(self, xy, text, font, anchor="ls"):
        _anchor(anchor)
        left, top, right, bottom = font.getbbox(text)
        x, y = xy
        return left + x, top + y, right + x, bottom + y

    def text(self, xy, text, font, fill, anchor="ls"):
        _anchor(anchor)
        x, y = xy
        if x < 0 or y < 0 or y != int(y):
            raise ValueError("text is drawn from x >= 0 and a whole y, "
                             "not %r" % (xy,))
        cov = coverage(xy, text, font)
        if cov is not None:
            self._blend(*cov, fill)

    def _blend(self, mask, x0, y0, fill):
        """Blend `fill` through coverage `mask` placed at (x0, y0),
        clipped to the canvas."""
        h, w = self.canvas.shape
        cx0, cy0 = max(x0, 0), max(y0, 0)
        cx1 = min(x0 + mask.shape[1], w)
        cy1 = min(y0 + mask.shape[0], h)
        if cx0 >= cx1 or cy0 >= cy1:
            return
        m = mask[cy0 - y0: cy1 - y0, cx0 - x0: cx1 - x0]
        bg = self.canvas[cy0:cy1, cx0:cx1].astype(np.int32)
        self.canvas[cy0:cy1, cx0:cx1] = _div255(bg * (255 - m) + fill * m)

    def _fill(self, x0, y0, x1, y1, value):
        """Set the inclusive box [x0, x1] x [y0, y1], clipped."""
        h, w = self.canvas.shape
        x0, y0 = max(int(x0), 0), max(int(y0), 0)
        x1, y1 = min(int(x1), w - 1), min(int(y1), h - 1)
        if x0 <= x1 and y0 <= y1:
            self.canvas[y0: y1 + 1, x0: x1 + 1] = value

    def line(self, xy, fill, width=1):
        """An axis-aligned line between two whole points, width 1 or 2
        (a width-2 line covers the row or column below or right of it)."""
        (xa, ya), (xb, yb) = xy
        if width not in (1, 2) or (xa != xb and ya != yb) or any(
                v != int(v) for v in (xa, ya, xb, yb)):
            raise ValueError("only axis-aligned lines of width 1 or 2 "
                             "between whole points are drawn")
        xa, xb = sorted((int(xa), int(xb)))
        ya, yb = sorted((int(ya), int(yb)))
        if ya == yb:
            self._fill(xa, ya, xb, ya + width - 1, fill)
        else:
            self._fill(xa, ya, xa + width - 1, yb, fill)

    def rectangle(self, xy, outline, width=1):
        """The outline of the inclusive box xy = [x0, y0, x1, y1], `width`
        pixels inside it."""
        x0, y0, x1, y1 = (int(v) for v in xy)
        for box in ((x0, y0, x1, y0 + width - 1),
                    (x0, y1 - width + 1, x1, y1),
                    (x0, y0, x0 + width - 1, y1),
                    (x1 - width + 1, y0, x1, y1)):
            self._fill(*box, outline)

    def paste(self, block, xy):
        """Copy the uint8 `block` with its top-left corner at xy,
        clipped."""
        x, y = (int(v) for v in xy)
        h, w = self.canvas.shape
        bh, bw = block.shape
        cx0, cy0 = max(x, 0), max(y, 0)
        cx1, cy1 = min(x + bw, w), min(y + bh, h)
        if cx0 < cx1 and cy0 < cy1:
            self.canvas[cy0:cy1, cx0:cx1] = \
                block[cy0 - y: cy1 - y, cx0 - x: cx1 - x]
