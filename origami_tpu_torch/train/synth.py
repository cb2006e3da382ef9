"""Synthetic newspaper-page corpus with pixel-exact ground truth.

Port of origami_tpu/train/synth.py. The JAX module draws with PIL and
the DejaVu fonts and resamples with cv2; here the text, lines, frames
and pasted blocks go through train/draw.py (the subset of PIL.ImageDraw
that this module uses, over a glyph atlas that reproduces PIL's pixels
and measurements), the resizes and the blur through cv2's uint8
counterparts in train/segment/data.py, and the PNGs through core/_png.
The random draws are the JAX module's, call for call, so the same seed
gives the same page, strip and ground truth (tests/test_torch_synth_*).

Rendering is host work: numpy on the host, as PIL is in the JAX module.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from origami_tpu_torch.core import _png
from origami_tpu_torch.core.block import BAND_PAD
from origami_tpu_torch.train import draw as _draw
from origami_tpu_torch.train.draw import CHARSET  # noqa: F401
from origami_tpu_torch.train.segment.data import (gaussian_blur_u8,
                                                  resize_area_u8,
                                                  resize_linear_u8)

REGION = dict(TEXT=0, TABULAR=1, ILLUSTRATION=2, BACKGROUND=3)
SEP = dict(H=0, V=1, T=2, BACKGROUND=3)

_SYLLABLES = ("ber lin ger zei tung mor gen abend an zeige markt preis "
              "han del bör se thea ter stadt land volk haus stras se "
              "herr frau kauf ver ein gross klein neu alt jahr tag "
              "woche monat schaft lich keit ung der die das und von").split()


def _font(kind, size):
    return _draw.font(kind, int(size))


def _resize(img, size, shrink):
    """cv2.resize with INTER_AREA when shrinking, else INTER_LINEAR."""
    return resize_area_u8(img, size) if shrink else \
        resize_linear_u8(img, size)


def random_word(rng, capital=False):
    n = int(rng.integers(1, 4))
    w = "".join(rng.choice(_SYLLABLES) for _ in range(n))
    if capital or rng.random() < 0.3:
        w = w.capitalize()
    if rng.random() < 0.05:
        w += rng.choice(list(".,;:!?"))
    return w


def random_text(rng, min_words=2, max_words=9):
    n = int(rng.integers(min_words, max_words + 1))
    words = [random_word(rng, capital=(i == 0)) for i in range(n)]
    if rng.random() < 0.3:
        words.append(str(rng.integers(0, 2000)))
    return " ".join(words)


@dataclass
class LineGT:
    text: str
    baseline: list          # [(x0, y), (x1, y)] in page coords
    bbox: tuple             # (x0, y0, x1, y1) ink box
    region: tuple           # region path key e.g. ("regions","TEXT",i)


@dataclass
class PageGT:
    image: np.ndarray               # uint8 (H, W)
    region_labels: np.ndarray       # uint8 (H, W)
    separator_labels: np.ndarray    # uint8 (H, W)
    lines: list = field(default_factory=list)
    regions: list = field(default_factory=list)   # (kind, (x0,y0,x1,y1))


def _draw_text_line(draw, x, y, text, font):
    """Draw one line with its baseline at y; returns ink bbox."""
    draw.text((x, y), text, font=font, fill=0, anchor="ls")
    return draw.textbbox((x, y), text, font=font, anchor="ls")


def _paragraph(rng, draw, x0, y, width, font_size, n_lines, region_key,
               lines_out, indent_first=True):
    """Render a justified-ish paragraph; returns y after the block."""
    font = _font("serif", font_size)
    lh = int(font_size * 1.45)
    for li in range(n_lines):
        y += lh
        indent = int(font_size * 1.2) if (indent_first and li == 0) else 0
        x = x0 + indent
        words = []
        while True:
            w = random_word(rng, capital=(not words and li == 0))
            probe = " ".join(words + [w])
            tw = draw.textlength(probe, font=font)
            if x + tw > x0 + width - 2:
                break
            words.append(w)
            if len(words) > 14:
                break
        if not words:
            words = [random_word(rng)[:6]]
        text = " ".join(words)
        bbox = _draw_text_line(draw, x, y, text, font)
        x1 = x + draw.textlength(text, font=font)
        lines_out.append(LineGT(text, [(x, y), (float(x1), y)],
                                tuple(bbox), region_key))
    return y + int(lh * 0.4)


def _table(rng, draw, sep_mask, x0, y, width, region_key, lines_out):
    """A small numeric table with vertical column rules (class T)."""
    font = _font("sans", 15)
    n_cols = int(rng.integers(2, 5))
    n_rows = int(rng.integers(3, 8))
    col_w = width // n_cols
    lh = 24
    top = y
    for r in range(n_rows):
        y += lh
        for c in range(n_cols):
            cx = x0 + c * col_w + 6
            val = str(rng.integers(0, 10000))
            if rng.random() < 0.3:
                val = random_word(rng, capital=True)[:8]
            bbox = _draw_text_line(draw, cx, y, val, font)
            x1 = cx + draw.textlength(val, font=font)
            lines_out.append(LineGT(val, [(cx, y), (float(x1), y)],
                                    tuple(bbox), region_key))
    bottom = y + 6
    # column rules: T separators (reference label class for table rules)
    for c in range(1, n_cols):
        cx = x0 + c * col_w
        draw.line([(cx, top), (cx, bottom)], fill=40, width=1)
        sep_mask[top:bottom, max(cx - 1, 0):cx + 2] = SEP["T"]
    return bottom + 8


def _illustration(rng, draw, x0, y, width):
    h = int(rng.integers(80, 220))
    x1, y1 = x0 + width, y + h
    # textured gray block with a frame
    tex = (rng.random((h, width)) * 60 + 120)
    yy, xx = np.mgrid[0:h, 0:width]
    tex = (tex * (0.8 + 0.2 * np.sin(xx / 9.0) * np.sin(yy / 7.0))
           ).astype(np.uint8)
    draw.paste(tex, (x0, y))
    draw.rectangle([x0, y, x1 - 1, y1 - 1], outline=60, width=2)
    return y1 + 8


def render_page(seed, width=1312, height=1920, n_columns=None,
                degrade=True):
    """Render one synthetic newspaper page with exact GT."""
    rng = np.random.default_rng(seed)
    img = np.full((height, width), 255, np.uint8)
    draw = _draw.Draw(img)
    region_mask = np.full((height, width), REGION["BACKGROUND"], np.uint8)
    sep_mask = np.full((height, width), SEP["BACKGROUND"], np.uint8)
    lines: list = []
    regions: list = []

    margin = int(rng.integers(40, 70))
    n_cols = n_columns or int(rng.integers(2, 5))
    gutter = 18
    col_w = (width - 2 * margin - (n_cols - 1) * gutter) // n_cols
    top = margin + 40

    # masthead across all columns
    mast_font = _font("serif_bold", int(rng.integers(30, 42)))
    title = " ".join(random_word(rng, capital=True) for _ in range(2))
    tw = draw.textlength(title, font=mast_font)
    mx = (width - tw) / 2
    bbox = _draw_text_line(draw, mx, margin + 26, title, mast_font)
    lines.append(LineGT(title, [(mx, margin + 26),
                                (mx + tw, margin + 26)],
                        tuple(bbox), ("regions", "TEXT", 0)))
    b = [int(v) for v in bbox]
    region_mask[max(b[1] - 2, 0):b[3] + 2, max(b[0] - 2, 0):b[2] + 2] \
        = REGION["TEXT"]
    regions.append(("TEXT", (b[0], b[1], b[2], b[3])))
    # rule under the masthead
    ry = margin + 40
    draw.line([(margin, ry), (width - margin, ry)], fill=30, width=2)
    sep_mask[ry - 1:ry + 2, margin:width - margin] = SEP["H"]

    region_id = 1
    for c in range(n_cols):
        x0 = margin + c * (col_w + gutter)
        y = top + 10
        while y < height - margin - 60:
            kind = rng.choice(
                ["para", "para", "para", "head", "table", "illus",
                 "rule"],
                p=[0.30, 0.25, 0.15, 0.12, 0.08, 0.05, 0.05])
            block_top = y
            if kind == "rule":
                ry = y + 4
                draw.line([(x0 + 8, ry), (x0 + col_w - 8, ry)],
                          fill=40, width=1)
                sep_mask[ry - 1:ry + 2, x0 + 8:x0 + col_w - 8] = SEP["H"]
                y = ry + 10
                continue
            region_key = ("regions", "TEXT", region_id)
            if kind == "head":
                fs = int(rng.integers(19, 26))
                y = _paragraph(rng, draw, x0, y, col_w, fs,
                               int(rng.integers(1, 3)), region_key,
                               lines, indent_first=False)
                rkind = "TEXT"
            elif kind == "para":
                fs = int(rng.integers(14, 18))
                y = _paragraph(rng, draw, x0, y, col_w, fs,
                               int(rng.integers(3, 10)), region_key,
                               lines)
                rkind = "TEXT"
            elif kind == "table":
                region_key = ("regions", "TABULAR", region_id)
                y = _table(rng, draw, sep_mask, x0, y, col_w,
                           region_key, lines)
                rkind = "TABULAR"
            else:
                y = _illustration(rng, draw, x0, y, col_w)
                rkind = "ILLUSTRATION"
            y0c, y1c = max(block_top, 0), min(y - 4, height)
            region_mask[y0c:y1c, x0:x0 + col_w] = REGION[rkind]
            regions.append((rkind, (x0, y0c, x0 + col_w, y1c)))
            region_id += 1
            y += int(rng.integers(6, 18))
        # vertical column separator to the right
        if c < n_cols - 1:
            sx = x0 + col_w + gutter // 2
            draw.line([(sx, top), (sx, height - margin)], fill=35,
                      width=1)
            sep_mask[top:height - margin, sx - 1:sx + 2] = SEP["V"]

    # drop GT for lines the page boundary clipped away: a block that
    # starts before the column limit may extend past the bottom, where
    # the drawing is clipped. Keep a line only when >= 75% of its ink
    # band is visible.
    lines = [l for l in lines
             if (min(l.bbox[3], height) - l.bbox[1])
             >= 0.75 * max(l.bbox[3] - l.bbox[1], 1.0)]
    out = img.astype(np.float32)
    if degrade:
        out = _degrade(rng, out)
    page = PageGT(out.astype(np.uint8), region_mask, sep_mask,
                  lines, regions)
    return page


def _degrade(rng, img):
    """Scanner-style degradation: tone curve, low-frequency background
    unevenness, gaussian noise, specks. Geometry is kept (GT masks stay
    aligned); warping is a training-time augmentation (segment.warp)."""
    h, w = img.shape
    # paper tone + low-frequency lighting
    yy, xx = np.mgrid[0:h, 0:w]
    lf = (np.sin(xx / w * np.pi * rng.uniform(0.5, 2)) *
          np.sin(yy / h * np.pi * rng.uniform(0.5, 2)))
    img = img * rng.uniform(0.88, 0.97) + lf * rng.uniform(2, 9)
    img = img + rng.normal(0, rng.uniform(3, 7), img.shape)
    # dark specks
    n_specks = int(rng.integers(30, 120))
    sy = rng.integers(0, h, n_specks)
    sx = rng.integers(0, w, n_specks)
    img[sy, sx] = rng.integers(0, 90, n_specks)
    return np.clip(img, 0, 255)


def page_gt_json(page):
    """The <stem>.gt.json document of a rendered page."""
    return dict(
        lines=[dict(text=l.text, baseline=l.baseline,
                    bbox=[float(v) for v in l.bbox],
                    region=list(l.region)) for l in page.lines],
        regions=[dict(kind=k, bbox=list(b)) for k, b in page.regions],
        size=[int(page.image.shape[1]), int(page.image.shape[0])])


def write_corpus(out_dir, n_pages, seed=0, **kw):
    """Write page images + label masks (the train.segment.data
    convention: <stem>.labels.<kind>.png) + <stem>.gt.json line GT."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    names = []
    for i in range(n_pages):
        page = render_page(seed * 10_000 + i, **kw)
        name = "synth%04d" % i
        _png.write_gray(out_dir / (name + ".png"), page.image)
        _png.write_gray(out_dir / (name + ".labels.region.png"),
                        page.region_labels)
        _png.write_gray(out_dir / (name + ".labels.separator.png"),
                        page.separator_labels)
        (out_dir / (name + ".gt.json")).write_text(
            json.dumps(page_gt_json(page)))
        names.append(name)
    return names


def render_line(seed, text=None, height=48, max_width=2000):
    """Render one OCR training line strip (uint8 (height, W)) + text.

    Matches the serving domain (LineExtractor strips): text is rendered
    at page-scale font sizes (11..30 px), framed as [baseline -
    ascent_like, baseline + descent_like] with the varied proportions
    the projection-profile band detector produces, then
    aspect-preservingly scaled to `height`."""
    rng = np.random.default_rng(seed)
    if text is None:
        text = random_text(rng)
    fs = int(rng.integers(11, 31))
    kind = rng.choice(["serif", "serif_bold", "sans"],
                      p=[0.7, 0.15, 0.15])
    font = _font(kind, fs)
    tw = int(font.getlength(text)) + 16
    canvas_h = int(fs * 3)
    base_y = int(fs * 1.8)
    img = np.full((canvas_h, max(tw, 8)), 255, np.uint8)
    _draw.Draw(img).text((8, base_y), text, font=font, fill=0,
                         anchor="ls")
    arr = img.astype(np.float32)
    arr = arr * rng.uniform(0.92, 1.0) \
        + rng.normal(0, rng.uniform(2, 6), arr.shape)
    arr = np.clip(arr, 0, 255).astype(np.uint8)
    # crop a band around the baseline the way the band detector frames
    # lines: most of an em above, a sliver-to-half-descender below
    top = base_y - int(fs * rng.uniform(0.85, 1.2))
    bottom = base_y + int(fs * rng.uniform(0.1, 0.5))
    arr = arr[max(top, 0): min(bottom, canvas_h)]
    # x-margin jitter: serving strips are the detected ink extent with
    # about zero leading/trailing margin
    cols = np.nonzero((arr < 160).any(axis=0))[0]
    if len(cols):
        ml, mr = rng.integers(0, 9, size=2)
        x0 = max(int(cols[0]) - int(ml), 0)
        x1 = min(int(cols[-1]) + 1 + int(mr), arr.shape[1])
        arr = arr[:, x0:x1]
    # scale to target height, preserve aspect
    scale = height / arr.shape[0]
    w = max(8, min(int(arr.shape[1] * scale), max_width))
    arr = _resize(arr, (w, height), scale < 1)
    # resampling softness: half the pool gets an extra blur/down-up
    # cycle so decode is resampling-invariant
    if rng.random() < 0.5:
        if rng.random() < 0.5:
            arr = gaussian_blur_u8(arr, rng.uniform(0.3, 0.9))
        else:
            f = rng.uniform(0.6, 0.9)
            small = resize_area_u8(arr, (max(8, int(w * f)),
                                         max(8, int(height * f))))
            arr = resize_linear_u8(small, (w, height))
    return arr, text


def line_batch(seed, n, height=48):
    """A list of (strip, text) pairs for recognizer training."""
    return [render_line(seed * 100_000 + i, height=height)
            for i in range(n)]


def page_line_pool(n_pages=40, height=48, seed=7_000_000,
                   max_width=2000, min_width=12):
    """(strip, text) pairs cut from rendered degraded pages with the
    serving band framing (core/block.py BAND_PAD): glyphs at page scale
    with render_page's scanner degradation and tight ink x extents."""
    pt, pb = BAND_PAD
    pool = []
    for p in range(n_pages):
        page = render_page(seed + p)
        img = page.image
        H, W = img.shape
        for line in page.lines:
            x0, y0, x1, y1 = line.bbox
            if x1 - x0 < min_width or y1 - y0 < 6:
                continue
            bh = y1 - y0
            t = int(max(0, np.floor(y0 - pt * bh)))
            b = int(min(H, np.ceil(y1 + pb * bh)))
            l = int(max(0, np.floor(x0)))
            r = int(min(W, np.ceil(x1)))
            strip = img[t:b, l:r]
            if strip.shape[0] < 6 or strip.shape[1] < 8:
                continue
            scale = height / strip.shape[0]
            w = max(8, min(int(strip.shape[1] * scale), max_width))
            strip = _resize(strip, (w, height), scale < 1)
            pool.append((strip, line.text))
    return pool
