"""detect.contours — vectorize label masks into region polygons and
separator polylines (CLI stage 2).

Port of origami_tpu/batch/detect/contours.py: segment.zip ->
contours.0.zip. Region masks run through the polygon pipeline (border
following, Decompose, area filter, frame noise filter); separator masks
through thinning and skeleton polyline estimation. Label-space shapes are
scaled to page coordinates before writing. All of it is host work (the
port's geometry and the C++ of geometry/native.cpp and
contour_trace.cpp); the stage launches no kernel.

    python -m origami_tpu_torch.batch.detect.contours CORPUS [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from origami_tpu_torch import geometry as G
from origami_tpu_torch.batch.core.io import Artifact, Input, Output, Stage
from origami_tpu_torch.batch.core.processor import (BatchedProcessor,
                                                    Processor)
from origami_tpu_torch.batch.detect.flow import kernel_launches
from origami_tpu_torch.core import contours as C
from origami_tpu_torch.core.math import Geometry
from origami_tpu_torch.core.page import Page
from origami_tpu_torch.core.segment import PredictorType

# the JAX stage's runtime.json key: later stages of either package read it
STAGE_NAME = "origami_tpu.batch.detect.contours"


class ContoursProcessor(BatchedProcessor):
    """One page per batch: a page that fails is recorded FAILED on its
    own and the stage goes on with the next."""

    def __init__(self, options):
        super().__init__(options, batch_size=1)
        if options.get("export_images"):
            raise NotImplementedError(
                "--export-images is not ported (it needs PIL and "
                "core/mask.py; ROADMAP.md, queue A)")
        self._opt = options

    @property
    def processor_name(self):
        return STAGE_NAME

    def artifacts(self):
        return [
            ("input", Input(Artifact.SEGMENTATION)),
            ("output", Output(Artifact.CONTOURS, stage=Stage.WARPED)),
        ]

    def process_batch(self, pages):
        return {p: self.process(p, kw["input"], kw["output"])
                for p, kw in pages}

    def _scale(self, label_size, page_size):
        sx = page_size[0] / label_size[0]
        sy = page_size[1] / label_size[1]
        return lambda geom: G.ops.transform(
            lambda x, y: (x * sx, y * sy), geom)

    def process(self, p, input, output):
        seg = input.segmentation
        page_size = Page(p, device=self.device).size()

        opt = self._opt
        with output.contours() as zf:
            predictions = []
            for pred in seg.predictions:
                label_geom = Geometry(*pred.size)
                to_page = self._scale(pred.size, page_size)
                if pred.type == PredictorType.REGION:
                    pipe = C.pipeline(
                        C.Contours(),
                        C.Decompose(),
                        C.FilterByArea(label_geom.rel_area(
                            opt.get("region_area", 0.0025))),
                        C.HeuristicFrameDetector(
                            pred.size, opt.get("margin_distance", 0.01)),
                    )
                    build = C.multi_class_constructor(
                        lambda label: pipe, list(pred.classes))
                    for cls, shapes in build(pred.labels).items():
                        for i, poly in enumerate(shapes):
                            zf.writestr(
                                "%s/%s/%d.wkt" % (pred.name, cls.name, i),
                                to_page(poly).wkt)
                else:
                    tol = label_geom.rel_length(
                        opt.get("separator_threshold", 4 / 1000))
                    build = C.multi_class_constructor(
                        lambda label: C.pipeline(
                            C.EstimatePolyline(label.orientation,
                                               simplify_tol=tol)),
                        list(pred.classes))
                    for cls, polylines in build(pred.labels).items():
                        widths = []
                        for i, pl in enumerate(polylines):
                            zf.writestr(
                                "%s/%s/%d.wkt" % (pred.name, cls.name, i),
                                to_page(pl.line_string).wkt)
                            widths.append(pl.width)
                        zf.writestr(
                            "%s/%s/meta.json" % (pred.name, cls.name),
                            json.dumps(dict(width=widths)))
                predictions.append(dict(name=pred.name,
                                        type=pred.type.name))
            zf.writestr("meta.json", json.dumps(dict(
                version=2, predictions=predictions)))
        return {}


def parser():
    p = argparse.ArgumentParser(
        prog="python -m origami_tpu_torch.batch.detect.contours",
        description="Extract contours for all pages in DATA_PATH.")
    p.add_argument("--export-images", action="store_true",
                   help="Also store region crops in the zip (not ported: "
                        "raises).")
    p.add_argument("--region-area", type=float, default=0.0025,
                   help="Ignore regions below this relative area.")
    p.add_argument("--margin-distance", type=float, default=0.01,
                   help="Border distance for margin-noise removal.")
    p.add_argument("--separator-threshold", type=float, default=4 / 1000,
                   help="Relative separator simplification.")
    p.add_argument("data_path", type=str)
    Processor.add_arguments(p)
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    if not Path(args.data_path).exists():
        raise SystemExit("no such path: %s" % args.data_path)
    ContoursProcessor(vars(args)).traverse(args.data_path)
    # one JSON line: how often each kernel ran (read by chip_smoke.py)
    print(json.dumps({"kernel_launches": kernel_launches()}), flush=True)


if __name__ == "__main__":
    main()
