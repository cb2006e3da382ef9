"""utils.dewarp — dump the dewarped page images.

Port of origami_tpu/batch/utils/dewarp.py: each page through its grid
(dewarp.zip) on the page's device, one launch of the dewarp kernel a
page (`Page.dewarped`), written as `<page>.out/dewarped.jpg`, or as
`OUTPUT/<stem>.dewarped.jpg` with -o: PIL's JPEG bytes at quality 90
(core/_jpeg.encode).

    python -m origami_tpu_torch.batch.utils.dewarp CORPUS [-o DIR] \\
        [--device cpu]
"""

from __future__ import annotations

from pathlib import Path

from origami_tpu_torch.batch.core.io import Artifact, Input
from origami_tpu_torch.batch.core.processor import PageProcessor, run_cli
from origami_tpu_torch.core import _jpeg

# the JAX module's JPEG quality
QUALITY = 90


class DewarpImageProcessor(PageProcessor):
    def __init__(self, options):
        super().__init__(options)
        self._out = Path(options["output"]) if options.get("output") \
            else None

    @property
    def processor_name(self):
        return "origami_tpu.batch.utils.dewarp"

    def artifacts(self):
        return [("input", Input(Artifact.DEWARPING_TRANSFORM))]

    def process(self, page_path, input):
        from origami_tpu_torch.core.page import Page
        page = Page(page_path, input.grid, device=self.device)
        if self._out:
            self._out.mkdir(parents=True, exist_ok=True)
            dst = self._out / (Path(page_path).stem + ".dewarped.jpg")
        else:
            dst = input.data_path / "dewarped.jpg"
        _jpeg.write(dst, page.dewarped, QUALITY)


def add_options(p):
    p.add_argument("-o", "--output", type=str, default=None)


def main(argv=None):
    return run_cli(DewarpImageProcessor, argv,
                   "python -m origami_tpu_torch.batch.utils.dewarp",
                   "Write dewarped page images for DATA_PATH.", add_options)


if __name__ == "__main__":
    main()
