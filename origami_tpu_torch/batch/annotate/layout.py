"""annotate.layout — render the aggregate regions and the reading order.

Port of origami_tpu/batch/annotate/layout.py: the regions of
contours.2.zip, labelled, over the dewarped page (made on the page's
device through the dewarp kernel, `Page.pixels(True)`), and the "*"
reading order of order.json as arrows from region centroid to region
centroid, in `annotation.layout.jpg`.

    python -m origami_tpu_torch.batch.annotate.layout CORPUS [--device cpu]
"""

from __future__ import annotations

from origami_tpu_torch.batch.annotate.utils import (
    AnnotateWriter, color_for, draw_arrow, draw_geometry, to_canvas)
from origami_tpu_torch.batch.core.io import (
    Annotation, Artifact, Input, Output, Stage)
from origami_tpu_torch.batch.core.processor import PageProcessor, run_cli


def _center(centers, name):
    """The centroid of region `name`; an order path may name a table
    region by its combined path (`pred/label/block` for the contours'
    `pred/label/block.cell...`)."""
    c = centers.get(name)
    if c is None:
        base = name.split("/")
        for k, v in centers.items():
            if k.startswith("/".join(base[:2])) and \
                    k.split("/")[2].split(".")[0] == base[-1]:
                return v
    return c


class AnnotateLayoutProcessor(PageProcessor):
    @property
    def processor_name(self):
        return "origami_tpu.batch.annotate.layout"

    def artifacts(self):
        return [
            ("aggregate", Input(Artifact.CONTOURS, stage=Stage.AGGREGATE)),
            ("reliable", Input(Artifact.ORDER, stage=Stage.RELIABLE,
                               take_any=True)),
            ("output", Output(Annotation("layout"))),
        ]

    def process(self, page_path, aggregate, reliable, output):
        canvas = to_canvas(aggregate.page.pixels(True))
        centers = {}
        boxes = []
        for parts, geom in aggregate.contours:
            boxes += draw_geometry(canvas, geom, color_for(parts[1]),
                                   label="/".join(parts[1:]))
            c = geom.centroid
            centers["/".join(parts)] = (c.x, c.y)
        try:
            order = reliable.order["orders"].get("*", [])
        except FileNotFoundError:
            order = []
        prev = None
        for name in order:
            c = _center(centers, name)
            if c is None:
                continue
            if prev is not None:
                draw_arrow(canvas, prev, c, (0, 0, 255), 3)
            prev = c
        output.annotation(AnnotateWriter(canvas, boxes))


def main(argv=None):
    return run_cli(AnnotateLayoutProcessor, argv,
                   "python -m origami_tpu_torch.batch.annotate.layout",
                   "Render layout and reading order overlays for DATA_PATH.")


if __name__ == "__main__":
    main()
