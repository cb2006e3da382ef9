"""Reliable contours for the lines stage; line extraction for the OCR
stage.

Port of origami_tpu/batch/core/lines.py (`reliable_contours`, :26-68;
`LineRewriter`, `LineExtractor`, :69-328). All strips of a page are cut
by the strip kernel in one launch per mode, into one u8 buffer of which
each (width bucket, profile) group is a view:

  * each line's (2, 3) frame is its BAND_PAD-framed band scaled to the
    recognizer height, with x sampled at the same magnification; lines
    wider than `max_width` are sampled squeezed (:199-228);
  * strips group by the 256-px width ladder (:240-244) and by the same
    p1 / p2 / gather partition as the JAX route, padded to a power of two
    >= 32 rows (:273-279);
  * p1 and p2 go to strip mode (a) on the device-resident dewarped page,
    gather to mode (b) on the warped page through the inverse grid
    (--extract-mode gather sends every line there), at the two sites of
    lines.py:281-296;
  * a page's frames, widths, strip descriptors (and mode (b)'s grid)
    reach the device in one host-to-device copy.
"""

from __future__ import annotations

import collections
import itertools
import logging

import numpy as np
import torch

from origami_tpu_torch import geometry as G
from origami_tpu_torch.batch.core.prof import span
from origami_tpu_torch.batch.core.utils import TableRegionCombinator
from origami_tpu_torch.core.block import BAND_PAD
from origami_tpu_torch.models.recognizer import strip_width_bucket
from origami_tpu_torch.ops import remap as ops


def reliable_contours(all_blocks, free_lines, detected_lines):
    """Shrink each region to the convex hull of its detected lines and
    promote reclassified ("free") lines to new regions of their
    predicted label (lines.py:26-68). `detected_lines` gains the
    promoted lines."""
    contours = {k: b.image_space_polygon for k, b in all_blocks.items()}

    combinator = TableRegionCombinator(all_blocks.keys())
    combined_lines = combinator.lines(detected_lines)
    mapping = combinator.mapping

    max_ids = collections.defaultdict(int)
    for k in contours:
        try:
            max_ids[k[:2]] = max(max_ids[k[:2]],
                                 int(str(k[2]).split(".")[0]))
        except ValueError:
            pass

    for pred_path, line in free_lines:
        new_id = max_ids[tuple(pred_path)] + 1
        max_ids[tuple(pred_path)] = new_id
        new_path = tuple(pred_path) + (str(new_id),)
        contours[new_path] = line.image_space_polygon
        detected_lines[new_path + (0,)] = line

    by_block = collections.defaultdict(list)
    for path, line in combined_lines.items():
        by_block[tuple(path[:3])].append(line)

    for path, lines in by_block.items():
        hull = G.unary_union(
            [l.image_space_polygon for l in lines]).convex_hull
        for k in mapping.get(path, [path]):
            if k not in contours:
                continue
            shape = contours[k].intersection(hull)
            if shape.geom_type != "Polygon":
                shape = shape.convex_hull
            contours[k] = shape

    return contours


class LineRewriter:
    """Split table lines into per-column cell lines using tables.json."""

    def __init__(self, tables):
        self._columns = {tuple(k.split("/")): xs
                         for k, xs in tables.get("columns", {}).items()}

    def _column_path(self, path, column):
        predictor, label = path[:2]
        parts = str(path[2]).split(".")
        if len(parts) != 4:
            raise ValueError("%s is not a table path" % str(path))
        block, division, _, _ = parts
        line = 1 + int(path[-1])
        grid = ".".join(map(str, (block, division, line, column)))
        return (predictor, label, grid, str(0))

    def __call__(self, lines):
        parts = []
        for path, line in lines.items():
            cols = self._columns.get(tuple(map(str, path[:3])))
            if cols is None:
                parts.append((path, line, None))
                continue
            # inset interior edges: the column x-values are divider
            # centres, so a divider-to-divider cell would include the
            # stroke itself at both ends
            up_h = float(np.linalg.norm(line.up))
            inset = min(6.0, max(2.0, 0.12 * up_h))
            edges = [None] + list(cols) + [None]
            for i, (x0, x1) in enumerate(zip(edges, edges[1:])):
                ix0 = None if x0 is None else x0 + inset
                ix1 = None if x1 is None else x1 - inset
                if ix0 is not None and ix1 is not None and ix1 - ix0 < 4:
                    ix0, ix1 = x0, x1
                parts.append((self._column_path(path, 1 + i), line,
                              (ix0, ix1)))
        return parts


def identity_grid(page_w, page_h):
    """A 2x2 dewarp sample grid whose inverse transform is the identity
    (bilinear interpolation of a linear map is exact)."""
    res = float(max(page_w, page_h))
    hv = np.array([[[0.0, 0.0], [res, 0.0]],
                   [[0.0, res], [res, res]]], np.float32)
    return hv, res


class LineExtractor:
    def __init__(self, tables, line_height, options, min_confidence=0.5,
                 max_width=None):
        self._line_height = int(line_height)
        self._options = options
        self._min_confidence = min_confidence
        self._max_width = max_width
        self._rewriter = LineRewriter(tables)
        spec = options.get("binarize", "").strip()
        if spec:
            from origami_tpu_torch.core.binarize import from_string
            self._binarizer = from_string(spec, options.get("device"))
        else:
            self._binarizer = None

    @staticmethod
    def add_arguments(parser):
        parser.add_argument("--binarize", type=str, default="",
                            help="line binarization (e.g. otsu, sauvola)")
        parser.add_argument("--do-not-dewarp", action="store_true")
        parser.add_argument("--do-not-deskew", action="store_true")
        parser.add_argument("--extract-mode", choices=["banded", "gather"],
                            default="banded",
                            help="strip extraction: strip kernel mode (a) "
                                 "off the dewarped page (default) vs mode "
                                 "(b) through the inverse grid")

    def parts(self, lines, ignored=None):
        """Filter + table-split lines into extraction parts."""
        if ignored is not None:
            lines = {k: v for k, v in lines.items()
                     if not ignored(tuple(k[:2]))}
        kept = {}
        for path, line in lines.items():
            if line.confidence < self._min_confidence:
                logging.info("skipping line %s (confidence %.2f)",
                             path, line.confidence)
                continue
            kept[path] = line
        return self._rewriter(kept)

    def _frame(self, lpath, line, column):
        """(frame, width) of one part, squeezed past max_width."""
        th = self._line_height
        pt, pb = BAND_PAD
        band_h = float(np.linalg.norm(line.up)) * (1 + pt + pb)
        xres = th / max(band_h, 1.0)
        frame, width = line.dewarped_frame(th, xres=xres, column=column,
                                           pad=BAND_PAD)
        if self._max_width and width > self._max_width:
            logging.warning(
                "line %s wider than %d px (%d): sampling squeezed",
                "/".join(map(str, lpath)), self._max_width, width)
            frame, width = line.dewarped_frame(
                th, xres=xres * self._max_width / width, column=column,
                pad=BAND_PAD)
            width = min(width, self._max_width)
        return frame, width

    def groups(self, parts):
        """Plan the strip launches: parts [(path, line, column)] -> yield
        per (page, width bucket, profile) group (page, paths, frames
        (nb, 2, 3) float32, widths (nb,) int32, wmax, profile); rows past
        len(paths) are zero padding."""
        th = self._line_height
        banded = self._options.get("extract_mode", "banded") == "banded"
        by_page = collections.defaultdict(list)
        for path, line, column in parts:
            by_page[id(line.block.page)].append((path, line, column))
        for group in by_page.values():
            page = group[0][1].block.page
            fw = [self._frame(*g) for g in group]
            buckets = collections.defaultdict(list)
            for i, (_, wid) in enumerate(fw):
                buckets[strip_width_bucket(wid, self.bucket_cap)].append(i)
            for wmax, idxs in sorted(buckets.items()):
                by_prof = {"p1": [], "p2": [], "gather": []}
                for i in idxs:
                    by_prof[self._extract_profile(
                        fw[i][0], fw[i][1], th, banded)].append(i)
                for prof, sub in by_prof.items():
                    if not sub:
                        continue
                    nb = 32
                    while nb < len(sub):
                        nb *= 2
                    fr = np.zeros((nb, 2, 3), np.float32)
                    fr[: len(sub)] = np.stack([fw[i][0] for i in sub])
                    wd = np.zeros(nb, np.int32)
                    wd[: len(sub)] = [fw[i][1] for i in sub]
                    yield (page, [group[i][0] for i in sub], fr, wd, wmax,
                           prof)

    def device_groups(self, parts):
        """parts: [(path, line, column)] -> yield per group of `groups`
        (paths, strips (nb, th, wmax) u8 on the page's device, widths
        (n,) int32 numpy, wmax): p1/p2 groups through strip mode (a) on
        the dewarped page, gather groups through mode (b); per page one
        upload, one u8 buffer of which the strips are views, and one
        launch per mode."""
        planned = self.groups(parts)
        for _, page_groups in itertools.groupby(planned,
                                                key=lambda g: id(g[0])):
            yield from self._page_strips(list(page_groups))

    def _page_strips(self, plan):
        """One page's groups of `groups` -> their (paths, strips, widths,
        wmax), cut by one launch per mode."""
        page = plan[0][0]
        th = self._line_height
        dewarp = not self._options.get("do_not_dewarp", False) \
            and page.grid is not None
        # the host tables of both modes, laid out in one int32 upload:
        # per mode desc (N, 4), frames (N, 6) as float32 bits, widths
        # (N,); then mode (b)'s grid
        words, launch, offsets, end = [], {}, [0] * len(plan), 0
        for mode in ("a", "b"):
            idx = [i for i, g in enumerate(plan)
                   if (g[5] == "gather") == (mode == "b")]
            if not idx:
                continue
            gs = [plan[i] for i in idx]
            desc, offs, end = ops.strip_layout(
                [(len(fr), len(paths), wmax)
                 for _, paths, fr, _, wmax, _ in gs], th, start=end)
            for i, off in zip(idx, offs):
                offsets[i] = off
            launch[mode] = (sum(map(len, words)), len(desc),
                            max(g[4] for g in gs))
            words += [desc.reshape(-1),
                      np.concatenate([g[2] for g in gs]).reshape(-1)
                      .view(np.int32),
                      np.concatenate([g[3] for g in gs])]
        if "b" in launch:
            if dewarp:
                hv = np.ascontiguousarray(page.grid.points("sample"),
                                          np.float32)
                res = float(page.grid.resolution)
            else:
                hv, res = identity_grid(*page.size())
            hv_at = sum(map(len, words))
            words.append(hv.reshape(-1).view(np.int32))
        with span("lines.page_upload"):
            table = torch.from_numpy(np.concatenate(words)).to(page.device)
            out = torch.empty(end, dtype=torch.uint8, device=page.device)
            src = page.dewarped_dev if dewarp and "a" in launch \
                else page.device_pixels
        with span("lines.extract_dispatch"):
            for mode, (at, n, max_w) in launch.items():
                desc = table[at: at + 4 * n].view(n, 4)
                fr = table[at + 4 * n: at + 10 * n].view(torch.float32) \
                    .view(n, 2, 3)
                wd = table[at + 10 * n: at + 11 * n]
                if mode == "a":
                    ops.strips_dewarped_page(src, fr, wd, desc, out, th,
                                             max_w, 255.0)
                    continue
                hv_dev = table[hv_at: hv_at + hv.size] \
                    .view(torch.float32).view(hv.shape)
                ops.strips_through_grid_page(
                    page.device_pixels, hv_dev, res, fr, wd, desc, out, th,
                    max_w, 255.0)
        for (_, paths, fr, wd, wmax, _), off in zip(plan, offsets):
            strips = out[off: off + len(fr) * th * wmax] \
                .view(len(fr), th, wmax)
            yield paths, strips, wd[: len(paths)].copy(), wmax

    @staticmethod
    def _extract_profile(frame, width, th, banded):
        """Which extraction a line takes: "p1" (body-text banded
        statics), "p2" (large-text banded statics) or "gather"
        (footprint past both banded profiles, or --extract-mode gather)
        — the JAX route's partition (lines.py:300-318), kept so every
        line takes the same route as there."""
        if not banded:
            return "gather"
        a0, a1 = float(frame[0, 0]), float(frame[0, 1])
        b0, b1 = float(frame[1, 0]), float(frame[1, 1])
        if abs(a1) * max(th - 1, 1) / 2.0 > 2.0:
            return "gather"
        vspan = abs(b0) * max(width - 1, 1) + abs(b1) * (th - 1) + 4
        hspan = a0 * max(width - 1, 1) + abs(a1) * (th - 1) + 4
        if a0 <= 1.0 and vspan <= 62 and hspan <= width + 6:
            return "p1"
        if a0 <= 2.0 and vspan <= 126:
            return "p2"
        return "gather"

    @property
    def bucket_cap(self):
        """Ladder ceiling of max_width (None = unbounded)."""
        if not self._max_width:
            return None
        return strip_width_bucket(self._max_width, cap=None)

    @property
    def binarizer(self):
        """The --binarize spec's callable (u8 strip -> u8, 255 = paper),
        or None."""
        return self._binarizer

    def __call__(self, lines, ignored=None):
        return self.extract(self.parts(lines, ignored=ignored))

    def extract(self, parts):
        """parts: [(path, line, column)] -> [(path, strip u8 numpy)],
        each strip binarized when a binarizer is set."""
        out = []
        for paths, dev, widths, _ in self.device_groups(parts):
            strips = dev.cpu().numpy()
            for i, path in enumerate(paths):
                strip = strips[i, :, : widths[i]]
                if self._binarizer is not None:
                    strip = self._binarizer(strip)
                out.append((path, strip))
        return out
