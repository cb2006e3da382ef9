"""detect.order — reading order by separator-aware recursive XY-cut
(CLI stage 7).

Port of origami_tpu/batch/detect/order.py (contours.1/2/3.zip +
lines.3.zip -> order.json with an order per region label and the
global "*" order, :28-150). Ambiguous overlap groups are cut again at
line level on the lines' baseline boxes; gaps are scored by
`ObstacleSampler`, which favours cuts along thick separators. Host
geometry only: the stage launches no kernel.

    python -m origami_tpu_torch.batch.detect.order CORPUS [--device cpu]
"""

from __future__ import annotations

import argparse
import collections
import json
from pathlib import Path

from origami_tpu_torch.batch.core.io import Artifact, Input, Output, Stage
from origami_tpu_torch.batch.core.processor import (BatchedProcessor,
                                                    Processor)
from origami_tpu_torch.batch.core.utils import (RegionsFilter,
                                                TableRegionCombinator)
from origami_tpu_torch.batch.detect.flow import kernel_launches
from origami_tpu_torch.core.separate import ObstacleSampler
from origami_tpu_torch.core.xycut import polygon_order
from origami_tpu_torch.core.xycut import reading_order as _ro

# the JAX stage's runtime.json key: later stages of either package read it
STAGE_NAME = "origami_tpu.batch.detect.order"


def _is_table_path(path):
    return "." in str(path[2])


class ReadingOrderProcessor(BatchedProcessor):
    """One page per batch: a page that fails is recorded FAILED on its
    own and the stage goes on with the next."""

    POOLED = True

    def __init__(self, options):
        super().__init__(options, batch_size=1)
        self._opt = options
        self._ignore = RegionsFilter(
            options.get("ignore", "regions/ILLUSTRATION"))
        self._splittable = RegionsFilter(
            options.get("splittable", "regions/TEXT"))
        self._split_regions = not options.get(
            "disable_region_splitting", False)
        self._sep_flow_width = options.get("separator_flow_width", 2)

    @property
    def processor_name(self):
        return STAGE_NAME

    def _thickness_delta(self, width):
        return 2 if width > self._sep_flow_width else 0

    def compute_order(self, page, contours, region_lines, sampler):
        fringe = page.geometry(dewarped=True).rel_length(
            self._opt.get("fringe", 0.005))
        order = []
        for group in polygon_order(list(contours.items()), fringe=fringe,
                                   score=sampler, mode="grouped"):
            if len(group) <= 1 or not self._split_regions:
                order.extend(group)
                continue
            items = []
            line_y = {}
            for g in group:
                if self._splittable(g) and not _is_table_path(g):
                    for line_path, line in region_lines.get(g, []):
                        p1, p2 = line.baseline
                        minx = min(p1[0], p2[0])
                        maxx = max(p1[0], p2[0])
                        y = (p1[1] + p2[1]) / 2
                        data = line.info["tesseract_data"]
                        ascent = abs(data.get("ascent", 8))
                        descent = abs(data.get("descent", 2))
                        items.append((line_path, (
                            minx, y - ascent * 0.5, maxx,
                            y + descent * 0.5)))
                        line_y[line_path] = y + ascent / 2
                else:
                    bounds = contours[g].bounds
                    items.append((g, bounds))
                    line_y[g] = (bounds[1] + bounds[3]) / 2
            for sub in _ro(items, score=sampler, mode="grouped"):
                if len(sub) <= 1:
                    order.extend(sub)
                else:
                    order.extend(sorted(sub, key=lambda k: line_y[k]))
        return order

    def artifacts(self):
        return [
            ("warped", Input(Artifact.SEGMENTATION, stage=Stage.WARPED)),
            ("dewarped", Input(Artifact.CONTOURS, stage=Stage.DEWARPED)),
            ("aggregate", Input(Artifact.CONTOURS, stage=Stage.AGGREGATE)),
            ("reliable", Input(Artifact.CONTOURS, Artifact.LINES,
                               stage=Stage.RELIABLE)),
            ("output", Output(Artifact.ORDER, stage=Stage.RELIABLE)),
        ]

    def process_batch(self, pages):
        return {p: self.process(p, kw["dewarped"], kw["aggregate"],
                                kw["reliable"], kw["output"])
                for p, kw in pages}

    def process(self, page_path, dewarped, aggregate, reliable, output):
        blocks = aggregate.regions.by_path
        if not blocks:
            output.order(dict(version=1, orders={"*": []}))
            return {}

        page = aggregate.page
        min_confidence = reliable.lines.min_confidence
        min_area = page.geometry(True).rel_area(
            self._opt.get("region_area", 0.0025))

        combinator = TableRegionCombinator(
            reliable.regions.by_path.keys())
        combined = combinator.contours_from_blocks(
            reliable.regions.by_path)
        combined = {k: v for k, v in combined.items()
                    if v.area >= min_area and not self._ignore(k)
                    and not v.is_empty}

        region_lines = collections.defaultdict(list)
        for line_path, line in reliable.lines.by_path.items():
            if line.confidence >= min_confidence:
                region_lines[tuple(line_path[:3])].append(
                    (line_path, line))

        sampler = ObstacleSampler(dewarped.separators,
                                  self._thickness_delta)

        by_labels = collections.defaultdict(dict)
        for p, c in combined.items():
            by_labels[p[:2]][p] = c
        by_labels[("*",)] = dict(combined)

        orders = {}
        for key, contours in by_labels.items():
            order = self.compute_order(page, contours, region_lines,
                                       sampler)
            orders["/".join(key)] = ["/".join(map(str, p)) for p in order]

        output.order(dict(version=1, orders=orders))
        return dict(n_ordered=len(orders.get("*", [])))


def parser():
    p = argparse.ArgumentParser(
        prog="python -m origami_tpu_torch.batch.detect.order",
        description="Detect reading order for documents in DATA_PATH.")
    p.add_argument("data_path", type=str)
    p.add_argument("--ignore", type=str, default="regions/ILLUSTRATION")
    p.add_argument("--fringe", type=float, default=0.005)
    p.add_argument("--region-area", type=float, default=0.0025)
    p.add_argument("--splittable", type=str, default="regions/TEXT")
    p.add_argument("--disable-region-splitting", action="store_true")
    p.add_argument("--separator-flow-width", type=float, default=2)
    Processor.add_arguments(p)
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    if not Path(args.data_path).exists():
        raise SystemExit("no such path: %s" % args.data_path)
    ReadingOrderProcessor(vars(args)).traverse(args.data_path)
    # one JSON line: how often each kernel ran (read by chip_smoke.py)
    print(json.dumps({"kernel_launches": kernel_launches()}), flush=True)


if __name__ == "__main__":
    main()
