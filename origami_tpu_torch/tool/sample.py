"""GT sampling: pick random lines per region type into the annotation DB,
optionally importing existing Page-XML transcriptions.

Port of origami_tpu/tool/sample.py on the port's PageProcessor: the
pages in the processor's order, one random.Random(seed) over all of
them, `--per-type` lines a (predictor, label) of each page's reliable
lines; `--import-transcriptions` takes each line's text from
`<page>.gt.page.xml` (pagexml/transcriptions.py). Host work only:
`--device` is taken as every stage takes it.

    python -m origami_tpu_torch.tool.sample CORPUS --db-path DB \\
        [--per-type 5] [--seed 0] [--import-transcriptions] [--device cpu]
"""

from __future__ import annotations

import random
from pathlib import Path

from origami_tpu_torch.batch.core.io import Artifact, Input, Stage
from origami_tpu_torch.batch.core.processor import PageProcessor, run_cli
from origami_tpu_torch.tool.lineload import AnnotationDB


class SampleLinesProcessor(PageProcessor):
    def __init__(self, options):
        options = dict(options)
        options.setdefault("lock_strategy", "NONE")
        # one random stream over the pages, in order
        options["processes"] = 1
        super().__init__(options)
        self._db = AnnotationDB(options["db_path"])
        self._per_type = options.get("per_type", 5)
        self._rng = random.Random(options.get("seed", 0))
        self._import_gt = options.get("import_transcriptions", False)

    @property
    def processor_name(self):
        return "origami_tpu.tool.sample"

    def artifacts(self):
        return [("reliable", Input(Artifact.LINES, stage=Stage.RELIABLE))]

    def process(self, page_path, reliable):
        by_type = {}
        for path, line in reliable.lines.by_path.items():
            by_type.setdefault(path[:2], []).append(path)
        gt = None
        if self._import_gt:
            from origami_tpu_torch.pagexml.transcriptions import (
                TranscriptionReader)
            gt_path = Path(page_path).with_suffix(".gt.page.xml")
            if gt_path.exists():
                gt = TranscriptionReader(
                    gt_path, reliable.lines.by_path)
        for t, paths in by_type.items():
            chosen = self._rng.sample(
                paths, min(self._per_type, len(paths)))
            for p in chosen:
                text = gt.text_for("/".join(map(str, p))) if gt else None
                self._db.add_line(page_path, "/".join(map(str, p)),
                                  annotation=text)


def add_options(p):
    p.add_argument("--db-path", type=str, required=True)
    p.add_argument("--per-type", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--import-transcriptions", action="store_true")


def main(argv=None):
    return run_cli(SampleLinesProcessor, argv,
                   "python -m origami_tpu_torch.tool.sample",
                   "Sample GT candidate lines from DATA_PATH into the "
                   "annotation DB.", add_options)


if __name__ == "__main__":
    main()
