"""utils.sample — copy artifacts of chosen pages for corpus QA.

Port of origami_tpu/batch/utils/sample.py: the pages of CORPUS in the
processor's order, `-n` of them drawn by random.Random(0).sample (all
with -n 0), each page image and the named artifacts of its `.out`
folder copied to OUTPUT/<stem>/, unpacked there (--unpack: each zip into
OUTPUT/<stem>/<zip stem>/), or written into OUTPUT when it ends in .zip
(as <stem>/<file>). Host work only: `--device` is taken as every stage
takes it.

    python -m origami_tpu_torch.batch.utils.sample CORPUS -a SPECS \\
        -o DIR|FILE.zip [-n 10] [--unpack] [--device cpu]
"""

from __future__ import annotations

import contextlib
import random
import shutil
import zipfile
from pathlib import Path

from origami_tpu_torch.batch.core.io import find_data_path, parse_artifact
from origami_tpu_torch.batch.core.processor import PageProcessor, run_cli


class SampleProcessor(PageProcessor):
    def __init__(self, options):
        options = dict(options)
        options.setdefault("lock_strategy", "NONE")
        # the pages are gathered in this process
        options["processes"] = 1
        super().__init__(options)
        self._specs = [parse_artifact(s.strip())
                       for s in options["artifacts"].split(",")
                       if s.strip()]
        self._out = Path(options["output"])
        self._n = options.get("n", 0)
        self._unpack = options.get("unpack", False)
        self._pages = []

    def artifacts(self):
        return []

    def prepare_process(self, page_path):
        return {}

    def process(self, page_path):
        self._pages.append(Path(page_path))

    def export(self):
        """Copy the sampled pages' files -> (files, pages) exported."""
        pages = self._pages
        if self._n and len(pages) > self._n:
            pages = random.Random(0).sample(pages, self._n)
        to_zip = self._out.suffix == ".zip"
        if not to_zip:
            self._out.mkdir(parents=True, exist_ok=True)
        n = 0
        with zipfile.ZipFile(self._out, "w", zipfile.ZIP_DEFLATED) \
                if to_zip else contextlib.nullcontext() as zf:
            for page in pages:
                data_path = find_data_path(page)
                files = [page] + [
                    data_path / artifact.filename(stage)
                    for artifact, stage in self._specs
                    if (data_path / artifact.filename(stage)).exists()]
                for f in files:
                    if to_zip:
                        zf.write(f, "%s/%s" % (page.stem, f.name))
                    elif self._unpack and f.suffix == ".zip":
                        with zipfile.ZipFile(f) as inner:
                            inner.extractall(self._out / page.stem / f.stem)
                    else:
                        dst = self._out / page.stem
                        dst.mkdir(parents=True, exist_ok=True)
                        shutil.copy2(f, dst / f.name)
                    n += 1
        print("exported %d files from %d pages." % (n, len(pages)))
        return n, len(pages)


def add_options(p):
    p.add_argument("-a", "--artifacts", type=str, required=True)
    p.add_argument("-o", "--output", type=str, required=True,
                   help="output directory or .zip")
    p.add_argument("-n", type=int, default=0,
                   help="sample this many random pages (0 = all)")
    p.add_argument("--unpack", action="store_true")


def main(argv=None):
    p = run_cli(SampleProcessor, argv,
                "python -m origami_tpu_torch.batch.utils.sample",
                "Export artifact samples from DATA_PATH.", add_options)
    p.export()
    return p


if __name__ == "__main__":
    main()
