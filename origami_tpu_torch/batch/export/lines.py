"""export.lines — write each detected line's strip as a PNG, on the card.

Port of origami_tpu/batch/export/lines.py: for every page with reliable
lines (lines.3.zip, tables.json) the lines are table-split and extracted
as the OCR stage extracts them (strip kernel mode (a) `strips_dewarped`
off the dewarped page, or mode (b) `strips_through_grid` with
`--extract-mode gather`), binarized with `--binarize` (Sauvola: one
`sauvola` launch a strip), and written as 8-bit gray PNGs to
`OUTPUT/<page>/dw<1|0>-ds<1|0>-h<height>/<line path>.png`.

    python -m origami_tpu_torch.batch.export.lines CORPUS -o OUT \
        [--binarize sauvola] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from origami_tpu_torch.batch.core.io import Artifact, Input, Stage
from origami_tpu_torch.batch.core.lines import LineExtractor
from origami_tpu_torch.batch.core.processor import (BatchedProcessor,
                                                    Processor)
from origami_tpu_torch.batch.detect.flow import kernel_launches
from origami_tpu_torch.core import _png


class LineExportProcessor(BatchedProcessor):
    POOLED = True

    def __init__(self, options):
        super().__init__(options, batch_size=1)
        self._opt = options
        self._out = Path(options["output"])
        self._line_height = options.get("line_height", 48)

    @property
    def processor_name(self):
        return "origami_tpu.batch.export.lines"

    def artifacts(self):
        return [
            ("reliable", Input(Artifact.LINES, Artifact.TABLES,
                               stage=Stage.RELIABLE)),
        ]

    def process_batch(self, pages):
        return {p: self.process(p, kw["reliable"]) for p, kw in pages}

    def process(self, page_path, reliable):
        extractor = LineExtractor(
            reliable.tables, self._line_height, self._opt,
            min_confidence=reliable.lines.min_confidence)
        strips = extractor(reliable.lines.by_path)
        tag = "dw%d-ds%d-h%d" % (
            0 if self._opt.get("do_not_dewarp") else 1,
            0 if self._opt.get("do_not_deskew") else 1,
            self._line_height)
        out_dir = self._out / Path(page_path).stem / tag
        out_dir.mkdir(parents=True, exist_ok=True)
        for path, strip in strips:
            name = "-".join(map(str, path)).replace("/", "-")
            _png.write_gray(out_dir / (name + ".png"), strip)
        return dict(n_lines=len(strips))


def parser():
    p = argparse.ArgumentParser(
        prog="python -m origami_tpu_torch.batch.export.lines",
        description="Export line images for pages in DATA_PATH.")
    p.add_argument("data_path", type=str)
    p.add_argument("-o", "--output", type=str, required=True)
    p.add_argument("--line-height", type=int, default=48)
    Processor.add_arguments(p)
    LineExtractor.add_arguments(p)
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    if not Path(args.data_path).exists():
        raise SystemExit("no such path: %s" % args.data_path)
    LineExportProcessor(vars(args)).traverse(args.data_path)
    # one JSON line: how often each kernel ran (read by chip_smoke.py)
    print(json.dumps({"kernel_launches": kernel_launches()}), flush=True)


if __name__ == "__main__":
    main()
