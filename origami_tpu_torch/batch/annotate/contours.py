"""annotate.contours — render the contours of a stage over its page.

Port of origami_tpu/batch/annotate/contours.py: writes
`annotation.contours.<stage>.jpg`. For a dewarped stage (dewarped,
aggregate, reliable) the canvas is the dewarped page, which the page's
device makes through the dewarp kernel (`Page.pixels(True)`).

    python -m origami_tpu_torch.batch.annotate.contours CORPUS \\
        [--stage warped|dewarped|aggregate|reliable] [--device cpu]
"""

from __future__ import annotations

from origami_tpu_torch.batch.annotate.utils import (
    AnnotateWriter, color_for, draw_geometry, to_canvas)
from origami_tpu_torch.batch.core.io import (
    Annotation, Artifact, Input, Output, Stage)
from origami_tpu_torch.batch.core.processor import PageProcessor, run_cli


class AnnotateContoursProcessor(PageProcessor):
    def __init__(self, options):
        super().__init__(options)
        self._stage = Stage[options.get("stage", "RELIABLE").upper()]

    @property
    def processor_name(self):
        return "origami_tpu.batch.annotate.contours"

    def artifacts(self):
        extra = [Artifact.DEWARPING_TRANSFORM] \
            if self._stage.is_dewarped else []
        return [
            ("input", Input(Artifact.CONTOURS, *extra,
                            stage=self._stage)),
            ("output", Output(
                Annotation("contours.%d" % self._stage.value))),
        ]

    def process(self, page_path, input, output):
        canvas = to_canvas(input.page.pixels(self._stage.is_dewarped))
        boxes = []
        for parts, geom in input.contours:
            boxes += draw_geometry(canvas, geom, color_for(parts[1]),
                                   label="/".join(parts[1:]))
        output.annotation(AnnotateWriter(canvas, boxes))


def add_options(p):
    p.add_argument("--stage", type=str, default="reliable",
                   help="warped | dewarped | aggregate | reliable")


def main(argv=None):
    return run_cli(AnnotateContoursProcessor, argv,
                   "python -m origami_tpu_torch.batch.annotate.contours",
                   "Render contour overlays for pages in DATA_PATH.",
                   add_options)


if __name__ == "__main__":
    main()
