"""detect.lines — reliable baseline detection on the refined regions
(CLI stage 6).

Port of origami_tpu/batch/detect/lines.py (segment.zip + contours.1/2.zip
+ tables.json -> contours.3.zip + lines.3.zip). Lines are detected per
text block of the layout stage's regions with the projection-profile
detector (forced lines on empty blocks), scored by nearest-sampling the
label maps under each line's sample grid pushed back through the dewarp
grid, reclassified when the evidence contradicts the block's label, and
each region is shrunk to the convex hull of its lines.

The device work is the binarized dewarped page that line detection
reads (`Page.dewarped_binarized`): on the card the page is dewarped by
the dewarp kernel and binarized by the Sauvola kernel (window 15,
bit-packed), one launch of `dewarp_u8` and of `sauvola_packed` a page;
the rest is host numpy and the port's own geometry.

    python -m origami_tpu_torch.batch.detect.lines CORPUS [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from origami_tpu_torch.batch.core.io import Artifact, Input, Output, Stage
from origami_tpu_torch.batch.core.lines import reliable_contours
from origami_tpu_torch.batch.core.processor import (BatchedProcessor,
                                                    Processor)
from origami_tpu_torch.batch.core.utils import RegionsFilter
from origami_tpu_torch.batch.detect.flow import (detect_block_lines,
                                                 kernel_launches)
from origami_tpu_torch.core.page import Page

# the JAX stage's runtime.json key: later stages of either package read it
STAGE_NAME = "origami_tpu.batch.detect.lines"


class ConfidenceSampler:
    """Evidence per prediction class under a line's area: the label maps
    nearest-sampled on the warped page (lines.py:30-83)."""

    def __init__(self, blocks, segmentation, grid):
        self._predictions = {p.name: p
                             for p in segmentation.predictions}
        self._grid = grid
        first = next(iter(blocks.values()))
        self._page_size = first.page.size(False)   # warped (w, h)

    def batch(self, items, res=0.5):
        """Evidence dicts for [(path, line), ...]: one grid inversion for
        all lines and one label gather per predictor."""
        coords, spans = [], []
        off = 0
        for path, line in items:
            c = line.dewarped_grid_coords(
                max(2, int(line.height * res)), xres=res).reshape(-1, 2)
            coords.append(c)
            spans.append((off, off + len(c)))
            off += len(c)
        if not coords:
            return []
        pts = np.concatenate(coords, axis=0)
        if self._grid is not None:
            pts = self._grid.inverse_points(pts)
        pw, ph = self._page_size
        labels_by_pred = {}
        out = []
        for (path, line), (a, b) in zip(items, spans):
            pred = self._predictions[path[0]]
            labels = labels_by_pred.get(path[0])
            if labels is None:
                lw, lh = pred.size
                xs = np.clip((pts[:, 0] * lw / pw).astype(int), 0, lw - 1)
                ys = np.clip((pts[:, 1] * lh / ph).astype(int), 0, lh - 1)
                labels = pred.labels[ys, xs]
                labels_by_pred[path[0]] = labels
            counts = np.bincount(labels[a:b],
                                 minlength=len(pred.classes))
            total = counts.sum()
            evidence = {}
            if total > 0:
                for c in pred.classes:
                    evidence["%s/%s" % (path[0], c.name)] = \
                        counts[c.value] / total
            out.append(evidence)
        return out


class LineDetectionProcessor(BatchedProcessor):
    """One page per batch: a page that fails is recorded FAILED on its
    own and the stage goes on with the next."""

    POOLED = True

    def __init__(self, options):
        super().__init__(options, batch_size=1)
        self._text_regions = RegionsFilter(
            options.get("text_regions", "regions/TEXT, regions/TABULAR"))
        self._reclassify_threshold = options.get(
            "reclassify_lines_threshold", 0.5)
        self._min_confidence = 0

    @property
    def processor_name(self):
        return STAGE_NAME

    def artifacts(self):
        return [
            ("warped", Input(Artifact.SEGMENTATION, stage=Stage.WARPED)),
            ("dewarped", Input(Artifact.CONTOURS, Artifact.SEGMENTATION,
                               stage=Stage.DEWARPED)),
            ("aggregate", Input(Artifact.CONTOURS, Artifact.TABLES,
                                stage=Stage.AGGREGATE)),
            ("output", Output(Artifact.CONTOURS, Artifact.LINES,
                              stage=Stage.RELIABLE)),
        ]

    def preload(self, page_path):
        # the PNG decodes on a feeder thread into the process-wide LRU
        return Page(page_path, device=self.device).warped

    def process_batch(self, pages):
        return {p: self.process(p, kw["warped"], kw["dewarped"],
                                kw["aggregate"], kw["output"])
                for p, kw in pages}

    def process(self, page_path, warped, dewarped, aggregate, output):
        blocks = aggregate.regions.by_path
        if not blocks:
            return {}

        page = aggregate.page
        sampler = ConfidenceSampler(blocks, warped.segmentation,
                                    aggregate.grid)
        text_blocks = {p: b for p, b in blocks.items()
                       if self._text_regions(p)}

        # the separators of the dewarped contours share the aggregate
        # regions' coordinates (contours.2.zip carries regions only)
        detected_by_block = detect_block_lines(
            page, aggregate.regions, force_lines=True,
            region_filter=lambda p: p in text_blocks,
            separators=dewarped.separators)

        flat = [(block_path, line)
                for block_path, lines in detected_by_block.items()
                for line in lines]
        for (block_path, line), ev in zip(flat, sampler.batch(flat)):
            line.update_confidence(ev)

        table_columns = aggregate.tables.get("columns", {})
        c_tables = set(tuple(x.split("/")) for x in table_columns.keys())

        detected_lines = {}
        free_lines = []
        for parts, lines in detected_by_block.items():
            pred_name, class_name, block_id = parts[:3]
            for line_id, line in enumerate(lines):
                error = line.predicted_path_error((pred_name, class_name))
                if (pred_name, class_name) == ("regions", "TABULAR") \
                        and (pred_name, class_name, block_id) not in c_tables:
                    error = 0   # never reclassify a columnless table
                if error > self._reclassify_threshold:
                    free_lines.append((line.predicted_path, line))
                else:
                    detected_lines[
                        (pred_name, class_name, block_id, line_id)] = line

        reliable = reliable_contours(blocks, free_lines, detected_lines)

        with output.lines() as zf:
            zf.writestr("meta.json", json.dumps(dict(
                version=1, min_confidence=self._min_confidence)))
            for line_path, line in detected_lines.items():
                zf.writestr("/".join(map(str, line_path)) + ".json",
                            json.dumps(line.info))

        with output.contours(copy_meta_from=aggregate) as zf:
            for k, contour in reliable.items():
                if contour.is_empty:
                    continue
                zf.writestr("/".join(map(str, k)) + ".wkt", contour.wkt)
        return dict(n_lines=len(detected_lines),
                    n_reclassified=len(free_lines))


def parser():
    p = argparse.ArgumentParser(
        prog="python -m origami_tpu_torch.batch.detect.lines",
        description="Detect reliable lines for documents in DATA_PATH.")
    p.add_argument("--text-regions", type=str,
                   default="regions/TEXT, regions/TABULAR")
    p.add_argument("--reclassify-lines-threshold", type=float, default=0.5)
    p.add_argument("data_path", type=str)
    Processor.add_arguments(p)
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    if not Path(args.data_path).exists():
        raise SystemExit("no such path: %s" % args.data_path)
    LineDetectionProcessor(vars(args)).traverse(args.data_path)
    # one JSON line: how often each kernel ran (read by chip_smoke.py)
    print(json.dumps({"kernel_launches": kernel_launches()}), flush=True)


if __name__ == "__main__":
    main()
