"""annotate.grid — render the dewarping grid over the warped page.

Port of origami_tpu/batch/annotate/grid.py: the grid's rows in red and
its columns in blue, one pixel wide, in `annotation.dewarp.jpg`. Host
work only.

    python -m origami_tpu_torch.batch.annotate.grid CORPUS [--device cpu]
"""

from __future__ import annotations

import numpy as np

from origami_tpu_torch.batch.annotate.utils import (
    AnnotateWriter, polylines, to_canvas)
from origami_tpu_torch.batch.core.io import (
    Annotation, Artifact, Input, Output)
from origami_tpu_torch.batch.core.processor import PageProcessor, run_cli


class AnnotateGridProcessor(PageProcessor):
    @property
    def processor_name(self):
        return "origami_tpu.batch.annotate.grid"

    def artifacts(self):
        return [
            ("input", Input(Artifact.DEWARPING_TRANSFORM)),
            ("output", Output(Annotation("dewarp"))),
        ]

    def process(self, page_path, input, output):
        from origami_tpu_torch.core.page import Page
        canvas = to_canvas(Page(page_path, device=self.device).pixels(False))
        grid = input.grid.points("sample")
        h, w = grid.shape[:2]
        for gy in range(h):
            polylines(canvas, np.round(grid[gy]).astype(np.int32), False,
                      (0, 0, 200), 1)
        for gx in range(w):
            polylines(canvas, np.round(grid[:, gx]).astype(np.int32), False,
                      (160, 0, 0), 1)
        output.annotation(AnnotateWriter(canvas))


def main(argv=None):
    return run_cli(AnnotateGridProcessor, argv,
                   "python -m origami_tpu_torch.batch.annotate.grid",
                   "Render dewarp grid overlays for pages in DATA_PATH.")


if __name__ == "__main__":
    main()
