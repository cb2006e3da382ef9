"""annotate.lines — render the lines with their confidence.

Port of origami_tpu/batch/annotate/lines.py: each line's polygon shaded
from red (low confidence) to green (high) and its baseline in blue, in
`annotation.lines.jpg`. For a dewarped stage (reliable, the default)
the canvas is the dewarped page, which the page's device makes through
the dewarp kernel (`Page.pixels(True)`).

    python -m origami_tpu_torch.batch.annotate.lines CORPUS \\
        [--stage warped|reliable] [--device cpu]
"""

from __future__ import annotations

import numpy as np

from origami_tpu_torch import geometry as G
from origami_tpu_torch.batch.annotate.utils import (
    AnnotateWriter, draw_geometry, to_canvas)
from origami_tpu_torch.batch.core.io import (
    Annotation, Artifact, Input, Output, Stage)
from origami_tpu_torch.batch.core.processor import PageProcessor, run_cli


def _confidence_color(conf):
    # red (low) -> green (high), BGR
    c = float(np.clip(conf, 0, 1))
    return (0, int(200 * c + 30), int(200 * (1 - c) + 30))


class AnnotateLinesProcessor(PageProcessor):
    def __init__(self, options):
        super().__init__(options)
        self._stage = Stage[options.get("stage", "RELIABLE").upper()]

    @property
    def processor_name(self):
        return "origami_tpu.batch.annotate.lines"

    def artifacts(self):
        return [
            ("input", Input(Artifact.CONTOURS, Artifact.LINES,
                            stage=self._stage)),
            ("output", Output(Annotation("lines"))),
        ]

    def process(self, page_path, input, output):
        canvas = to_canvas(input.page.pixels(self._stage.is_dewarped))
        for path, line in input.lines.by_path.items():
            draw_geometry(canvas, line.image_space_polygon,
                          _confidence_color(line.confidence),
                          thickness=1, fill_alpha=0.25)
            draw_geometry(canvas, G.LineString(line.baseline),
                          (255, 100, 0), thickness=1)
        output.annotation(AnnotateWriter(canvas))


def add_options(p):
    p.add_argument("--stage", type=str, default="reliable",
                   help="warped | reliable")


def main(argv=None):
    return run_cli(AnnotateLinesProcessor, argv,
                   "python -m origami_tpu_torch.batch.annotate.lines",
                   "Render line overlays for pages in DATA_PATH.",
                   add_options)


if __name__ == "__main__":
    main()
