"""annotate.flow — render the flow samples and separators.

Port of origami_tpu/batch/annotate/flow.py: the separators three pixels
wide, each H (blue) and V (red) flow sample as an arrow of 30 px along
its angle, over the warped page, in `annotation.flow.jpg`. Host work
only.

    python -m origami_tpu_torch.batch.annotate.flow CORPUS [--device cpu]
"""

from __future__ import annotations

import math

from origami_tpu_torch.batch.annotate.utils import (
    AnnotateWriter, color_for, draw_arrow, draw_geometry, to_canvas)
from origami_tpu_torch.batch.core.io import (
    Annotation, Artifact, Input, Output, Stage)
from origami_tpu_torch.batch.core.processor import PageProcessor, run_cli


class AnnotateFlowProcessor(PageProcessor):
    @property
    def processor_name(self):
        return "origami_tpu.batch.annotate.flow"

    def artifacts(self):
        return [
            ("warped", Input(Artifact.CONTOURS, Artifact.FLOW,
                             stage=Stage.WARPED)),
            ("output", Output(Annotation("flow"))),
        ]

    def process(self, page_path, warped, output):
        canvas = to_canvas(warped.page.pixels(False))
        for parts, geom in warped.separators.by_path.items():
            draw_geometry(canvas, geom, color_for(parts[1]), thickness=3)
        flow = warped.flow
        for kind, color in (("h", (0, 64, 255)), ("v", (255, 64, 0))):
            samples = flow[kind]
            length = 30.0
            for (x, y), phi in zip(samples.points, samples.values):
                dx, dy = math.cos(phi) * length, math.sin(phi) * length
                draw_arrow(canvas, (x - dx / 2, y - dy / 2),
                           (x + dx / 2, y + dy / 2), color)
        output.annotation(AnnotateWriter(canvas))


def main(argv=None):
    return run_cli(AnnotateFlowProcessor, argv,
                   "python -m origami_tpu_torch.batch.annotate.flow",
                   "Render flow overlays for pages in DATA_PATH.")


if __name__ == "__main__":
    main()
