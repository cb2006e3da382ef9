"""utils.rtext — per-region text files from the composed Page-XML.

Port of origami_tpu/batch/utils/rtext.py: for each page whose
compose.zip holds a page.xml, the last TextEquiv/Unicode of every
TextRegion as `OUTPUT/<stem>/<region id>.txt`. The XML is read with
ElementTree (the JAX module uses lxml). Host work only: `--device` is
taken as every stage takes it.

    python -m origami_tpu_torch.batch.utils.rtext CORPUS -o DIR \\
        [--device cpu]
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
import zipfile
from pathlib import Path

from origami_tpu_torch.batch.core.io import Artifact, Input
from origami_tpu_torch.batch.core.processor import PageProcessor, run_cli


class RegionTextProcessor(PageProcessor):
    def __init__(self, options):
        super().__init__(options)
        self._out = Path(options["output"])

    @property
    def processor_name(self):
        return "origami_tpu.batch.utils.rtext"

    def artifacts(self):
        return [("input", Input(Artifact.COMPOSE))]

    def process(self, page_path, input):
        with zipfile.ZipFile(input.path(Artifact.COMPOSE)) as zf:
            if "page.xml" not in zf.namelist():
                return
            root = ET.fromstring(zf.read("page.xml"))
        out_dir = self._out / Path(page_path).stem
        out_dir.mkdir(parents=True, exist_ok=True)
        for i, reg in enumerate(root.iterfind(".//{*}TextRegion")):
            uni = reg.findall("./{*}TextEquiv/{*}Unicode")
            text = uni[-1].text if uni and uni[-1].text else ""
            rid = reg.get("id", "r%d" % i)
            (out_dir / ("%s.txt" % rid)).write_text(text)


def add_options(p):
    p.add_argument("-o", "--output", type=str, required=True)


def main(argv=None):
    return run_cli(RegionTextProcessor, argv,
                   "python -m origami_tpu_torch.batch.utils.rtext",
                   "Export per-region texts for pages in DATA_PATH.",
                   add_options)


if __name__ == "__main__":
    main()
