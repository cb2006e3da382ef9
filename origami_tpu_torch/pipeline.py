"""One-call serving pipeline: page images in, structured text out, on
the card.

Port of origami_tpu/pipeline.py. `PagePipeline` drives the port's nine
detect stages over a scratch corpus, so a caller gets the batch CLIs'
artifacts and numerics through one call:

    pipe = PagePipeline(segmentation_model="heuristic", ocr_model="FAKE",
                        device="cuda")
    result = pipe.process(image)          # or process_batch([...])
    result.text, result.regions, result.lines, result.page_xml

The scratch corpus lives under the process's temporary directory
(`tempfile.gettempdir()`, i.e. TMPDIR: point it at a tmpfs for the JAX
package's RAM-backed scratch, which that package takes from /dev/shm).
Page images are written there as 8-bit gray PNGs by the port's encoder.

    python -m origami_tpu_torch.pipeline IMAGE.png [-m heuristic]
        [--ocr-model FAKE] [--xml OUT.xml] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import shutil
import tempfile
import threading
import time
import zipfile
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from origami_tpu_torch.core import _image, _png


def _scratch_root():
    return Path(tempfile.gettempdir())


@dataclass
class PageResult:
    text: str
    page_xml: bytes | None
    regions: dict = field(default_factory=dict)   # path -> wkt
    lines: dict = field(default_factory=dict)     # path -> line info
    order: list = field(default_factory=list)
    tables: dict = field(default_factory=dict)
    artifacts_dir: Path | None = None


class PagePipeline:
    def __init__(self, segmentation_model="heuristic", ocr_model="FAKE",
                 layout="bbz", page_xml=True, keep_artifacts=False,
                 stage_options=None, device=None):
        self._seg_model = segmentation_model
        self._ocr_model = ocr_model
        self._layout = layout
        self._page_xml = page_xml
        self._keep = keep_artifacts
        self._stage_options = stage_options or {}
        self._device = "cuda" if device is None else str(device)
        self._stages = None

    def _build_stages(self):
        from origami_tpu_torch.batch.detect.compose import ComposeProcessor
        from origami_tpu_torch.batch.detect.contours import \
            ContoursProcessor
        from origami_tpu_torch.batch.detect.dewarp import DewarpProcessor
        from origami_tpu_torch.batch.detect.flow import \
            FlowDetectionProcessor
        from origami_tpu_torch.batch.detect.layout import \
            LayoutDetectionProcessor
        from origami_tpu_torch.batch.detect.lines import \
            LineDetectionProcessor
        from origami_tpu_torch.batch.detect.ocr import OCRProcessor
        from origami_tpu_torch.batch.detect.order import \
            ReadingOrderProcessor
        from origami_tpu_torch.batch.detect.segment import \
            SegmentationProcessor

        def opts(**extra):
            o = dict(lock_strategy="NONE", plain=True, device=self._device)
            o.update(self._stage_options)
            o.update(extra)
            return o

        return [
            SegmentationProcessor(self._seg_model, opts()),
            ContoursProcessor(opts()),
            FlowDetectionProcessor(opts()),
            DewarpProcessor(opts()),
            LayoutDetectionProcessor(opts(layout=self._layout)),
            LineDetectionProcessor(opts()),
            ReadingOrderProcessor(opts()),
            OCRProcessor(opts(model=self._ocr_model)),
            ComposeProcessor(opts(page_xml=self._page_xml)),
        ]

    def process(self, image, name="page0001"):
        return self.process_batch([image], names=[name])[0]

    def process_batch(self, images, names=None, overlap=None):
        """Run the whole chain over a batch of u8 (H, W) pages.

        overlap=True (the default for more than 2 pages) runs the
        segment stage in a thread while the other stages sweep the
        corpus and take each page as its segment.zip lands; the stages'
        readiness checks and idempotent artifacts make the repeated
        sweeps safe."""
        if self._stages is None:
            self._stages = self._build_stages()
        root = Path(tempfile.mkdtemp(prefix="origami_serve_",
                                     dir=_scratch_root()))
        corpus = root / "corpus"
        corpus.mkdir()
        names = names or ["page%04d" % i for i in range(len(images))]
        for img, name in zip(images, names):
            _png.write_gray(corpus / (name + ".png"), np.asarray(img))
        if overlap is None:
            overlap = len(images) > 2
        try:
            if overlap:
                self._run_overlapped(corpus, names)
            else:
                for stage in self._stages:
                    stage.traverse(corpus)
            return [self._collect(corpus, name) for name in names]
        finally:
            if not self._keep:
                shutil.rmtree(root, ignore_errors=True)

    def _run_overlapped(self, corpus, names):
        seg, rest = self._stages[0], self._stages[1:]
        err = []

        def run_seg():
            try:
                seg.traverse(corpus)
            except BaseException as e:   # raised in the calling thread
                err.append(e)

        t = threading.Thread(target=run_seg, daemon=True)
        t.start()

        def all_done():
            return all((corpus / (n + ".out") / "compose.zip").exists()
                       for n in names)

        while True:
            segmenting = t.is_alive()
            for stage in rest:
                stage.traverse(corpus)
            if err:
                raise err[0]
            if all_done():
                break
            if not segmenting:
                # segmentation ended before this sweep began, so the
                # sweep saw every page: one more pass takes the rest
                for stage in rest:
                    stage.traverse(corpus)
                break
            time.sleep(0.05)
        t.join()

    def _collect(self, corpus, name):
        out = corpus / (name + ".out")
        text = ""
        page_xml = None
        compose = out / "compose.zip"
        if compose.exists():
            with zipfile.ZipFile(compose) as zf:
                if "page.txt" in zf.namelist():
                    text = zf.read("page.txt").decode("utf8")
                if "page.xml" in zf.namelist():
                    page_xml = zf.read("page.xml")
        regions = {}
        lines = {}
        c3 = out / "contours.3.zip"
        if c3.exists():
            with zipfile.ZipFile(c3) as zf:
                for n in zf.namelist():
                    if n.endswith(".wkt"):
                        regions[n[:-4]] = zf.read(n).decode("utf8")
        l3 = out / "lines.3.zip"
        if l3.exists():
            with zipfile.ZipFile(l3) as zf:
                for n in zf.namelist():
                    if n.endswith(".json") and n != "meta.json":
                        lines[n[:-5]] = json.loads(zf.read(n))
        order = []
        op = out / "order.json"
        if op.exists():
            order = json.loads(op.read_text())["orders"].get("*", [])
        tables = {}
        tp = out / "tables.json"
        if tp.exists():
            tables = json.loads(tp.read_text())
        return PageResult(
            text=text, page_xml=page_xml, regions=regions, lines=lines,
            order=order, tables=tables,
            artifacts_dir=out if self._keep else None)


def parser():
    p = argparse.ArgumentParser(
        prog="python -m origami_tpu_torch.pipeline",
        description="Run the full pipeline on one page image (PNG, JPEG, "
                    "TIFF or BMP) and print its text.")
    p.add_argument("image_path", type=str)
    p.add_argument("-m", "--model", type=str, default="heuristic")
    p.add_argument("--ocr-model", type=str, default="FAKE")
    p.add_argument("--layout", type=str, default="bbz")
    p.add_argument("--xml", type=str, default=None,
                   help="also write PAGE XML here")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (default) or cpu")
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    path = Path(args.image_path)
    if not path.exists():
        raise SystemExit("no such file: %s" % path)
    # PNG, JPEG, TIFF or BMP, by the file's magic bytes (core/_image.py)
    img = _image.read_gray(path)
    pipe = PagePipeline(segmentation_model=args.model,
                        ocr_model=args.ocr_model, layout=args.layout,
                        page_xml=args.xml is not None, device=args.device)
    result = pipe.process(img, name=path.stem)
    if args.xml and result.page_xml:
        Path(args.xml).write_bytes(result.page_xml)
    print(result.text)


if __name__ == "__main__":
    main()
