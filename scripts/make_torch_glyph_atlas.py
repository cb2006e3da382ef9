#!/usr/bin/env python3
"""Build origami_tpu_torch/train/glyphs/dejavu.npz: what PIL draws and
measures for the synthetic corpus, so that the port's renderer
(origami_tpu_torch/train/draw.py) reproduces origami_tpu/train/synth.py
on every pixel without PIL, FreeType, HarfBuzz or the fonts.

    python scripts/make_torch_glyph_atlas.py [--out PATH] [--workers N]

Needs Pillow with raqm (text layout through HarfBuzz), fontTools and the
DejaVu fonts of origami_tpu/train/synth.py. About 5 s with 8 workers.

Why an atlas reproduces PIL exactly:
  * PIL places glyph k of a string at the whole pixel round(pen_k)
    (26.6 pen positions, PIXEL(x) = (x + 32) >> 6), so a glyph's 8-bit
    coverage depends only on (font, size, glyph): rendered once here;
  * the pen advances by HarfBuzz's advances plus its GPOS pair
    adjustments, each an integer in 26.6: measured here with
    font.getlength, per pair and per script context (a string with a
    letter is shaped as Latin, one of digits and punctuation only in the
    default script, whose kern lookups differ in DejaVu Sans);
  * the f-ligatures come from the fonts' GSUB 'liga' lookups, applied
    lookup by lookup as HarfBuzz applies them: read here with fontTools;
  * textbbox needs each glyph's grid-fitted control box, clamped as PIL
    clamps it (x_min <= 0, y_max >= 0, y_min <= 0): the vertical edges
    from font.getbbox of the glyph alone; the horizontal ones from the
    outline's points (fontTools), scaled as FreeType scales them, since
    its v40 interpreter hints vertically only, and checked against
    getbbox wherever the advance does not hide them.
Every number is checked against PIL on the string it came from.

The (font, size) pairs are those synth.py reaches: serif 11-30
(render_line, heads 19-25, paragraphs 14-17), serif_bold 11-41
(render_line, the masthead 30-41), sans 11-30 (render_line, the table
at 15). sans_bold is declared there but drawn nowhere.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import shutil
import sys
from pathlib import Path

import numpy as np
import PIL
import PIL.features
import PIL.ImageFont
from fontTools.ttLib import TTFont

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from origami_tpu_torch.train.draw import (CHARSET, FONT_SIZES,  # noqa: E402
                                          shape_units)

FONT_DIR = Path("/usr/share/fonts/truetype/dejavu")
FONT_FILES = dict(serif="DejaVuSerif.ttf", serif_bold="DejaVuSerif-Bold.ttf",
                  sans="DejaVuSans.ttf")
COPYRIGHT = Path("/usr/share/doc/fonts-dejavu-core/copyright")
OUT = ROOT / "origami_tpu_torch" / "train" / "glyphs" / "dejavu.npz"
LIGA_FEATURES = ("liga",)


def liga_lookups(path):
    """The GSUB ligature lookups of the Latin script's default language
    system, in the order HarfBuzz applies them: ([[rule, ...], ...] with
    each rule the characters it joins, {rule: glyph name})."""
    font = TTFont(str(path))
    rev = {g: chr(c) for c, g in font.getBestCmap().items()}
    gsub = font["GSUB"].table
    feats = gsub.FeatureList.FeatureRecord
    script = next(s for s in gsub.ScriptList.ScriptRecord
                  if s.ScriptTag == "latn")
    index = sorted({i for fi in script.Script.DefaultLangSys.FeatureIndex
                    if feats[fi].FeatureTag in LIGA_FEATURES
                    for i in feats[fi].Feature.LookupListIndex})
    lookups, names = [], {}
    for li in index:
        lk = gsub.LookupList.Lookup[li]
        assert lk.LookupType == 4, (path, li, lk.LookupType)
        rules = []
        for st in lk.SubTable:
            for first, ligs in st.ligatures.items():
                for lig in ligs:
                    comps = [first] + list(lig.Component)
                    if all(g in rev and rev[g] in CHARSET for g in comps):
                        rule = "".join(rev[g] for g in comps)
                        rules.append(rule)
                        names[rule] = lig.LigGlyph
        lookups.append(rules)
    return lookups, names


def _mulfix(a, b):
    """FreeType's FT_MulFix: a * b / 2^16, rounded half away from 0."""
    v = (abs(a) * abs(b) + 0x8000) >> 16
    return -v if (a < 0) != (b < 0) else v


def x_extents(path, size, names):
    """{unit: (floor(x_min), ceil(x_max))} in pixels of each unit's
    outline points scaled to `size` px (x_scale = size * 2048 in 16.16
    for a 2048-unit em), or None for a glyph without points."""
    font = TTFont(str(path))
    assert font["head"].unitsPerEm == 2048, path
    glyf = font["glyf"]
    cmap = font.getBestCmap()
    out = {}
    for u in list(CHARSET) + sorted(names):
        coords = glyf[names[u] if len(u) > 1 else cmap[ord(u)]] \
            .getCoordinates(glyf)[0]
        if not len(coords):
            out[u] = None
            continue
        xs = [c[0] for c in coords]
        lo = _mulfix(min(xs), size * 2048)
        hi = _mulfix(max(xs), size * 2048)
        out[u] = (lo // 64, -((-hi) // 64))
    return out


def units_for(lookups):
    """Every unit (character or ligature) the charset text can shape to:
    the charset's characters, then each ligature's component string."""
    ligs = sorted({r for lk in lookups for r in lk}, key=lambda s: (len(s), s))
    return list(CHARSET) + ligs


def _ink(font, s):
    m, off = font.getmask2(s, "L", anchor="ls")
    a = np.asarray(m, dtype=np.uint8).reshape(m.size[1], m.size[0])
    ys, xs = np.nonzero(a)
    if not len(ys):
        return np.zeros((0, 0), np.uint8), 0, 0
    a = a[ys.min(): ys.max() + 1, xs.min(): xs.max() + 1]
    return np.ascontiguousarray(a), off[0] + int(xs.min()), \
        off[1] + int(ys.min())


def build_pair(args):
    """The atlas entries of one (font kind, size)."""
    kind, size, lookups, names = args
    font = PIL.ImageFont.truetype(str(FONT_DIR / FONT_FILES[kind]), size)
    xext = x_extents(FONT_DIR / FONT_FILES[kind], size, names)
    units = units_for(lookups)
    n = len(units)

    def length(s):
        return int(round(font.getlength(s) * 64))

    adv = np.full(n, -1, np.int32)
    box = np.zeros((n, 4), np.int16)
    bitmaps = []
    dxy = np.zeros((n, 2), np.int16)
    reach = np.zeros(n, bool)
    for u, s in enumerate(units):
        if shape_units(s, lookups) != [s]:
            bitmaps.append(np.zeros((0, 0), np.uint8))
            continue          # a ligature this font never forms
        reach[u] = True
        adv[u] = length(s)
        ink, dx, dy = _ink(font, s)
        bitmaps.append(ink)
        dxy[u] = dx, dy
        left, top, right, bottom = font.getbbox(s, anchor="ls")
        pix_adv = (int(adv[u]) + 32) >> 6
        x_lo, x_hi = xext[s] or (0, 0)
        # where getbbox shows an edge, the outline's must be it
        assert left == min(0, x_lo), (kind, size, s, left, x_lo)
        assert (right == x_hi) if right > pix_adv else (x_hi <= pix_adv), \
            (kind, size, s, right, x_hi, pix_adv)
        box[u] = left, -top, x_hi, -bottom    # x_lo, y_hi, x_hi, y_lo

    common = np.array([not s.isalpha() for s in units])
    kern_latn = np.zeros((n, n), np.int16)
    kern_dflt = np.zeros((n, n), np.int16)
    for a in range(n):
        if not reach[a]:
            continue
        sa = units[a]
        for b in range(n):
            sb = units[b]
            if not reach[b] or shape_units(sa + sb, lookups) != [sa, sb]:
                continue
            k = length(sa + sb) - adv[a] - adv[b]
            if common[a] and common[b]:
                kern_dflt[a, b] = k
                # the same pair inside Latin text, behind an 'a'
                kern_latn[a, b] = (length("a" + sa + sb) - length("a" + sa)
                                   - adv[b])
            else:
                kern_latn[a, b] = kern_dflt[a, b] = k
    return kind, size, adv, box, bitmaps, dxy, kern_latn, kern_dflt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(OUT))
    ap.add_argument("--workers", type=int, default=8)
    args = ap.parse_args()
    assert PIL.features.check("raqm"), "Pillow needs raqm (HarfBuzz layout)"
    probe = PIL.ImageFont.truetype(str(FONT_DIR / FONT_FILES["serif"]), 12)
    assert probe.layout_engine == PIL.ImageFont.Layout.RAQM

    liga = {k: liga_lookups(FONT_DIR / f) for k, f in FONT_FILES.items()}
    lookups = {k: v[0] for k, v in liga.items()}
    units = units_for([r for lk in lookups.values() for r in lk])
    jobs = [(k, s, lookups[k], liga[k][1]) for k, sizes in FONT_SIZES.items()
            for s in sizes]
    with multiprocessing.Pool(args.workers) as pool:
        results = pool.map(build_pair, jobs)

    n = len(units)
    p = len(results)
    adv = np.full((p, n), -1, np.int32)
    box = np.zeros((p, n, 4), np.int16)
    dxy = np.zeros((p, n, 2), np.int16)
    hw = np.zeros((p, n, 2), np.int16)
    off = np.zeros((p, n), np.int64)
    kern_latn = np.zeros((p, n, n), np.int16)
    kern_dflt = np.zeros((p, n, n), np.int16)
    chunks, at = [], 0
    for i, (kind, size, a, b, bms, d, kl, kd) in enumerate(results):
        local = units_for(lookups[kind])
        idx = [units.index(u) for u in local]
        adv[i, idx] = a
        box[i, idx] = b
        dxy[i, idx] = d
        kern_latn[i, np.ix_(idx, idx)[0], np.ix_(idx, idx)[1]] = kl
        kern_dflt[i, np.ix_(idx, idx)[0], np.ix_(idx, idx)[1]] = kd
        for u, bm in zip(idx, bms):
            hw[i, u] = bm.shape
            off[i, u] = at
            chunks.append(bm.ravel())
            at += bm.size
    meta = dict(
        units=units, lookups=lookups,
        pairs=[[k, s] for k, s, _, _ in jobs],
        fonts=FONT_FILES,
        versions=dict(pillow=PIL.__version__,
                      freetype=PIL.features.version("freetype2"),
                      raqm=PIL.features.version("raqm"),
                      harfbuzz=PIL.features.version("harfbuzz"),
                      layout_engine="RAQM"))
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        out, meta=np.array(json.dumps(meta)), adv=adv, box=box, dxy=dxy,
        hw=hw, off=off, bits=np.concatenate(chunks), kern_latn=kern_latn,
        kern_dflt=kern_dflt)
    shutil.copyfile(COPYRIGHT, out.parent / "COPYRIGHT.dejavu")
    print("wrote %s: %d pairs, %d units, %d bytes" % (
        out, p, n, out.stat().st_size))


if __name__ == "__main__":
    main()
