"""detect.compose — the composed text and Page-XML (CLI stage 9).

Port of origami_tpu/batch/detect/compose.py (ocr.zip + order.json +
contours.3.zip + lines.3.zip + tables.json -> compose.zip holding
page.txt and, with --page-xml, page.xml; :26-305). The plain text
follows the "*" reading order with paragraph separation and optional
region and letter filters; split tables are read row by row. Page-XML
nests the regions and their lines and maps every coordinate back to the
warped page through the dewarp grid. Host only: the stage launches no
kernel, and its Page-XML skips the XSD check (pagexml/pagexml.py).

    python -m origami_tpu_torch.batch.detect.compose CORPUS [--page-xml]
        [--device cpu]
"""

from __future__ import annotations

import argparse
import collections
import json
import re
from pathlib import Path

import numpy as np

from origami_tpu_torch import geometry as G
from origami_tpu_torch.batch.core.io import Artifact, Input, Output, Stage
from origami_tpu_torch.batch.core.processor import (BatchedProcessor,
                                                    Processor)
from origami_tpu_torch.batch.core.utils import (RegionsFilter,
                                                TableRegionCombinator)
from origami_tpu_torch.batch.detect.flow import kernel_launches

# the JAX stage's runtime.json key: later stages of either package read it
STAGE_NAME = "origami_tpu.batch.detect.compose"


def _rewarp(grid, geom):
    """Map dewarped-space geometry back into warped image space."""
    def f(x, y):
        pts = grid.inverse_points(np.c_[x, y])
        return pts[:, 0], pts[:, 1]
    return G.transform(f, geom)


def _line_sort_key(parts):
    out = []
    for p in parts:
        segs = str(p).split(".")
        if all(s.lstrip("-").isdigit() for s in segs):
            out.append((0, tuple(int(s) for s in segs), ""))
        else:
            out.append((1, (), str(p)))
    return out


class ComposeProcessor(BatchedProcessor):
    """One page per batch: a page that fails is recorded FAILED on its
    own and the stage goes on with the next."""

    def __init__(self, options):
        super().__init__(options, batch_size=1)
        self._opt = options
        self._page_xml = options.get("page_xml", False)
        self._regions_filter = None
        spec = options.get("regions", "")
        if spec.strip():
            self._regions_filter = RegionsFilter(spec)
        letters = options.get("only_letters", "")
        self._letter_re = re.compile("[^%s]" % re.escape(letters)) \
            if letters.strip() else None
        self._paragraph = options.get("paragraph", "\n\n")

    @property
    def processor_name(self):
        return STAGE_NAME

    def artifacts(self):
        return [
            ("input", Input(Artifact.OCR, Artifact.ORDER, Artifact.TABLES,
                            Artifact.CONTOURS, Artifact.LINES,
                            stage=Stage.RELIABLE)),
            ("output", Output(Artifact.COMPOSE)),
        ]

    # -- text assembly -----------------------------------------------------
    def _clean(self, text):
        if self._letter_re is not None:
            text = self._letter_re.sub("", text)
        return text

    def _region_texts(self, input):
        """{region_path(3): [(line_path, text)] in line order}."""
        texts = collections.defaultdict(list)
        for parts, text in input.sorted_ocr:
            texts[tuple(parts[:3])].append((tuple(parts), text))
        for k in texts:
            texts[k].sort(key=lambda kv: _line_sort_key(kv[0][3:]))
        return texts

    def _compose_text(self, input):
        orders = input.order["orders"]
        order = orders.get("*", [])
        region_texts = self._region_texts(input)
        combinator = TableRegionCombinator(list(region_texts.keys()))

        out = []
        seen = set()
        for name in order:
            path = tuple(name.split("/"))
            if self._regions_filter is not None \
                    and not self._regions_filter(path):
                continue
            if len(path) > 3:
                # line-level entry from region splitting
                block = tuple(path[:3])
                for lp, text in region_texts.get(block, []):
                    if lp == path and lp not in seen:
                        seen.add(lp)
                        out.append(self._clean(text))
                continue
            members = combinator.mapping.get(path, [path])
            if len(members) > 1:
                # a split table: interleave the column sub-regions back
                # into visual rows (readers scan tables row by row;
                # emitting member columns in sequence read whole
                # columns first — the stride-k walks diagnose_order
                # isolated)
                lines = self._table_rows(input, members, region_texts,
                                         seen)
            else:
                lines = []
                for m in members:
                    for lp, text in region_texts.get(tuple(m), []):
                        if lp in seen:
                            continue
                        seen.add(lp)
                        lines.append(self._clean(text))
            if lines:
                out.append("\n".join(lines))
        return self._paragraph.join(x for x in out if x.strip())

    def _table_rows(self, input, members, region_texts, seen):
        """Row-major line texts of a split table: cluster baselines by
        y (tolerance = half the median row pitch), read each row left
        to right."""
        entries = []
        for m in members:
            for lp, text in region_texts.get(tuple(m), []):
                if lp in seen:
                    continue
                seen.add(lp)
                line = input.lines.by_path.get(lp)
                if line is None:
                    entries.append((float("inf"), 0.0, len(entries),
                                    text))
                    continue
                p1, p2 = line.baseline
                entries.append(((p1[1] + p2[1]) / 2.0,
                                min(p1[0], p2[0]), len(entries), text))
        entries.sort(key=lambda e: (e[0], e[1], e[2]))
        ys = [e[0] for e in entries if e[0] != float("inf")]
        gaps = sorted(b - a for a, b in zip(ys, ys[1:]) if b - a > 1.0)
        tol = 0.5 * gaps[len(gaps) // 2] if gaps else 1.0
        rows = []
        last_y = None
        for e in entries:
            if last_y is None or e[0] - last_y > tol:
                rows.append([])
            rows[-1].append(e)
            last_y = e[0]
        out = []
        for row in rows:
            row.sort(key=lambda e: (e[1], e[0], e[2]))
            out.extend(self._clean(e[3]) for e in row)
        return out

    # -- page xml ----------------------------------------------------------
    def _compose_xml(self, page_path, input):
        from origami_tpu_torch.pagexml.pagexml import Page as XmlPage
        # contours at the reliable stage imply the dewarp grid among the
        # inputs, so a page reaches this stage only with its dewarp.zip
        grid = input.grid
        page = input.page
        size = page.size(False)
        doc = XmlPage(Path(page_path).name, size)

        region_texts = self._region_texts(input)
        regions = input.regions.by_path
        lines = input.lines.by_path
        combinator = TableRegionCombinator(list(regions.keys()))

        orders = input.order["orders"]
        order = [tuple(n.split("/")) for n in orders.get("*", [])]
        # group the order: region-level entries combine table paths;
        # consecutive line-level entries (from reading-order region
        # splitting) form merged pseudo-regions holding just those
        # lines (the reference's MergedTextRegion, compose.py)
        groups = []
        seen_regions = set()
        for path in order:
            if len(path) > 3:
                if groups and groups[-1][0] == "lines":
                    groups[-1][1].append(path)
                else:
                    groups.append(("lines", [path]))
            else:
                base = combinator.combined_path(path[:3])
                if base not in seen_regions:
                    seen_regions.add(base)
                    groups.append(("region", base))

        region_ids = []
        merged_idx = 0
        for kind_g, payload in groups:
            if kind_g == "lines":
                merged_idx += 1
                rid = "r_merged_%d" % merged_idx
                reg = doc.append_region("TextRegion", rid,
                                        region_type="paragraph")
                members = [(lp, lines.get(lp)) for lp in payload]
                shapes = [l.image_space_polygon
                          for _, l in members if l is not None]
                if shapes:
                    hull = G.unary_union(shapes).convex_hull
                    reg.append_coords(
                        _rewarp(grid, hull)._all_coords())
                text_accum = []
                for lp, line in members:
                    text = dict(region_texts.get(tuple(lp[:3]), [])) \
                        .get(tuple(lp), "")
                    tl = reg.append_text_line(
                        "l_%s" % "_".join(map(str, lp)))
                    if line is not None:
                        poly = _rewarp(grid, line.image_space_polygon)
                        tl.append_coords(poly._all_coords())
                        bl = _rewarp(grid, G.LineString(line.baseline))
                        tl.append_baseline(bl.np_coords)
                    tl.append_text_equiv(self._clean(text))
                    text_accum.append(self._clean(text))
                reg.append_text_equiv("\n".join(text_accum))
                region_ids.append(rid)
                continue
            base = payload
            label = base[1]
            members = combinator.mapping.get(base, [base])
            shapes = [regions[m].image_space_polygon
                      for m in members if m in regions]
            if not shapes:
                continue
            shape = G.unary_union(shapes)
            if shape.geom_type != "Polygon":
                shape = shape.convex_hull
            shape = _rewarp(grid, shape)
            rid = "r_%s" % "_".join(map(str, base)).replace("/", "_")
            kind = "TableRegion" if label == "TABULAR" else (
                "GraphicRegion" if label == "ILLUSTRATION"
                else "TextRegion")
            reg = doc.append_region(kind, rid, region_type="paragraph")
            reg.append_coords(shape._all_coords()
                              if shape.geom_type != "Polygon"
                              else shape.np_shell)
            region_ids.append(rid)

            # lines of all member blocks, in member order
            text_accum = []
            for m in members:
                for lp, text in region_texts.get(tuple(m), []):
                    line = lines.get(lp)
                    if kind == "TextRegion":
                        tl = reg.append_text_line(
                            "l_%s" % "_".join(map(str, lp)))
                        if line is not None:
                            poly = _rewarp(grid, line.image_space_polygon)
                            tl.append_coords(poly._all_coords())
                            bl = _rewarp(grid, G.LineString(line.baseline))
                            tl.append_baseline(bl.np_coords)
                        tl.append_text_equiv(self._clean(text))
                    text_accum.append(self._clean(text))
            if kind == "TextRegion":
                # TableRegionType / GraphicRegionType carry no
                # TextEquiv in the PAGE schema
                reg.append_text_equiv("\n".join(text_accum))

        doc.append_reading_order(region_ids)
        doc.validate()
        return doc

    def process_batch(self, pages):
        return {p: self.process(p, kw["input"], kw["output"])
                for p, kw in pages}

    def process(self, page_path, input, output):
        text = self._compose_text(input)
        with output.compose() as zf:
            zf.writestr("page.txt", text)
            if self._page_xml:
                doc = self._compose_xml(page_path, input)
                zf.writestr("page.xml", doc.tostring())
        return dict(n_chars=len(text))


def parser():
    p = argparse.ArgumentParser(
        prog="python -m origami_tpu_torch.batch.detect.compose",
        description="Compose final text / PAGE XML for documents in "
                    "DATA_PATH.")
    p.add_argument("data_path", type=str)
    p.add_argument("--page-xml", action="store_true",
                   help="also write PAGE XML output")
    p.add_argument("--regions", type=str, default="",
                   help="only compose text of these region types")
    p.add_argument("--only-letters", type=str, default="",
                   help="restrict output to the given characters")
    p.add_argument("--paragraph", type=str, default="\n\n")
    Processor.add_arguments(p)
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    if not Path(args.data_path).exists():
        raise SystemExit("no such path: %s" % args.data_path)
    ComposeProcessor(vars(args)).traverse(args.data_path)
    # one JSON line: how often each kernel ran (read by chip_smoke.py)
    print(json.dumps({"kernel_launches": kernel_launches()}), flush=True)


if __name__ == "__main__":
    main()
