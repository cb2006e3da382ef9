"""detect.dewarp — build the dewarping grid, transform contours (CLI
stage 4).

Port of origami_tpu/batch/detect/dewarp.py: contours.0.zip + flow.zip ->
dewarp.zip + contours.1.zip. The grid is built on the card (the two
scan kernels of csrc/grid.cu, ops.grid.grid_scan) and comes back to the
host once; the contours move into the
dewarped frame on the host through the grid's Newton inverse. Then the
stage dewarps and binarizes the page on the card (the dewarp kernel of
csrc/remap.cu, the Sauvola kernel of csrc/sauvola.cu) into the
process-wide LRUs that the layout and lines stages read. Where the JAX
stage swallows a failure of that prefetch, this one lets it raise, so the
page is recorded FAILED.

    python -m origami_tpu_torch.batch.detect.dewarp CORPUS [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path

from origami_tpu_torch import geometry as G
from origami_tpu_torch.batch.core.io import Artifact, Input, Output, Stage
from origami_tpu_torch.batch.core.processor import (BatchedProcessor,
                                                    Processor)
from origami_tpu_torch.batch.detect.flow import kernel_launches
from origami_tpu_torch.core.dewarp import Grid
from origami_tpu_torch.core.page import Page

# the JAX stage's runtime.json key: later stages of either package read it
STAGE_NAME = "origami_tpu.batch.detect.dewarp"


class DewarpProcessor(BatchedProcessor):
    """One page per batch: a page that fails is recorded FAILED on its
    own and the stage goes on with the next."""

    POOLED = True

    def __init__(self, options):
        super().__init__(options, batch_size=1)
        self._opt = options

    @property
    def processor_name(self):
        return STAGE_NAME

    def artifacts(self):
        return [
            ("warped", Input(Artifact.CONTOURS, Artifact.FLOW,
                             stage=Stage.WARPED)),
            ("output", Output(Artifact.DEWARPING_TRANSFORM,
                              Artifact.CONTOURS, stage=Stage.DEWARPED)),
        ]

    def preload(self, page_path):
        # the PNG decodes on a feeder thread into the process-wide LRU
        return Page(page_path, device=self.device).warped

    def process_batch(self, pages):
        return {p: self.process(p, kw["warped"], kw["output"])
                for p, kw in pages}

    def process(self, page_path, warped, output):
        if not warped.regions.by_path and not warped.separators.by_path:
            return {}

        page = warped.page
        flow = warped.flow
        grid = Grid.create(
            page.size(), flow["h"], flow["v"],
            grid_res=self._opt.get("grid_cell_size", 25),
            device=self.device)

        min_area = grid.geometry.rel_area(self._opt.get("region_area", 0))
        transformer = grid.transformer

        lost = 0
        with output.contours(copy_meta_from=warped) as zf:
            for parts, geom in warped.contours:
                dew = G.transform(transformer, geom)
                if dew.is_empty or (dew.geom_type == "Polygon"
                                    and dew.area < min_area):
                    lost += 1
                    continue
                if dew.geom_type == "Polygon" and not dew.is_valid:
                    dew = G.make_valid(dew)
                zf.writestr("/".join(parts) + ".wkt", dew.wkt)
        if lost:
            logging.warning("lost %d contours during dewarping", lost)

        with output.dewarping_transform() as f:
            grid.save(f)
        # prefetch the dewarped page and its Sauvola mask into the
        # process-wide LRUs (keyed by the grid's values, which the
        # float32 save/load round trip keeps), for layout and lines
        Page(page.path, grid, device=self.device).dewarped_binarized
        return dict(grid_shape=list(grid.points("sample").shape[:2]),
                    warping=grid.warping)


def parser():
    p = argparse.ArgumentParser(
        prog="python -m origami_tpu_torch.batch.detect.dewarp",
        description="Dewarp documents in DATA_PATH.")
    p.add_argument("--grid-cell-size", type=int, default=25,
                   help="Dewarp grid cell size in pixels.")
    p.add_argument("--region-area", type=float, default=0,
                   help="Drop dewarped regions below this relative area.")
    p.add_argument("data_path", type=str)
    Processor.add_arguments(p)
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    if not Path(args.data_path).exists():
        raise SystemExit("no such path: %s" % args.data_path)
    DewarpProcessor(vars(args)).traverse(args.data_path)
    # one JSON line: how often each kernel ran (read by chip_smoke.py)
    print(json.dumps({"kernel_launches": kernel_launches()}), flush=True)


if __name__ == "__main__":
    main()
