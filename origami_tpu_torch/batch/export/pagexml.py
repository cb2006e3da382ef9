"""export.pagexml — a minimal Page-XML from the warped lines alone.

Port of origami_tpu/batch/export/pagexml.py: for every page with
lines.0.zip (the flow stage's lines), one TextRegion per text block with
its polygon, one TextLine per line with its polygon and baseline, and a
reading order of the blocks in path order; written with the port's
Page-XML writer (pagexml/pagexml.py) to `OUTPUT/<page>.xml`. Host work
only: the stage launches no kernel.

    python -m origami_tpu_torch.batch.export.pagexml CORPUS -o OUT \
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from origami_tpu_torch.batch.core.io import Artifact, Input, Stage
from origami_tpu_torch.batch.core.processor import (BatchedProcessor,
                                                    Processor)
from origami_tpu_torch.batch.detect.flow import kernel_launches


class PageXMLExportProcessor(BatchedProcessor):
    POOLED = True

    def __init__(self, options):
        super().__init__(options, batch_size=1)
        self._out = Path(options["output"])

    @property
    def processor_name(self):
        return "origami_tpu.batch.export.pagexml"

    def artifacts(self):
        return [
            ("warped", Input(Artifact.LINES, stage=Stage.WARPED)),
        ]

    def process_batch(self, pages):
        return {p: self.process(p, kw["warped"]) for p, kw in pages}

    def process(self, page_path, warped):
        from origami_tpu_torch.pagexml.pagexml import Page as XmlPage
        page = warped.page
        doc = XmlPage(Path(page_path).name, page.size(False))
        region_ids = []
        by_block = {}
        for path, line in warped.lines.by_path.items():
            by_block.setdefault(tuple(path[:3]), []).append((path, line))
        for block_path, lines in sorted(by_block.items()):
            rid = "r_" + "_".join(map(str, block_path))
            reg = doc.append_region("TextRegion", rid)
            block = lines[0][1].block
            reg.append_coords(block.image_space_polygon._all_coords())
            for path, line in sorted(lines):
                tl = reg.append_text_line("l_" + "_".join(map(str, path)))
                tl.append_coords(line.image_space_polygon._all_coords())
                tl.append_baseline(line.baseline)
            region_ids.append(rid)
        doc.append_reading_order(region_ids)
        self._out.mkdir(parents=True, exist_ok=True)
        doc.write(self._out / (Path(page_path).stem + ".xml"))
        return dict(n_lines=sum(len(v) for v in by_block.values()))


def parser():
    p = argparse.ArgumentParser(
        prog="python -m origami_tpu_torch.batch.export.pagexml",
        description="Export minimal Page-XML (warped lines) for "
                    "DATA_PATH.")
    p.add_argument("data_path", type=str)
    p.add_argument("-o", "--output", type=str, required=True)
    Processor.add_arguments(p)
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    if not Path(args.data_path).exists():
        raise SystemExit("no such path: %s" % args.data_path)
    PageXMLExportProcessor(vars(args)).traverse(args.data_path)
    # one JSON line: how often each kernel ran (none here)
    print(json.dumps({"kernel_launches": kernel_launches()}), flush=True)


if __name__ == "__main__":
    main()
