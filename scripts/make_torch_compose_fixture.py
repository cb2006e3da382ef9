"""Build the order- and compose-stage fixture that the PyTorch port is
held against.

Runs the JAX `order` stage on the CPU over the two pages of
tests/data/torch_ocr/full (their PNG, segment.zip, dewarp.zip,
contours.3.zip, lines.3.zip and tables.json), with contours.1.zip from
tests/data/torch_flow and contours.2.zip from tests/data/torch_layout,
then the JAX `compose` stage from ref/<page>.single.ocr.zip, once plain
and once with --page-xml, and keeps what they write:

    tests/data/torch_compose/<page>.out/{order.json, compose.zip,
                                         compose_xml.zip}

Nothing under the other tests/data folders changes.

    JAX_PLATFORMS=cpu python scripts/make_torch_compose_fixture.py
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("ORIGAMI_TPU_PLATFORM", "cpu")

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

OCR = ROOT / "tests" / "data" / "torch_ocr" / "full"
FLOW = ROOT / "tests" / "data" / "torch_flow"
LAYOUT = ROOT / "tests" / "data" / "torch_layout"
ORDER_STAGE = "origami_tpu.batch.detect.order"
COMPOSE_STAGE = "origami_tpu.batch.detect.compose"


def corpus_from_fixtures(dst):
    """The order stage's inputs for each fixture page, all written by the
    JAX chain of scripts/make_torch_ocr_fixture.py."""
    dst.mkdir(parents=True, exist_ok=True)
    stems = []
    for png in sorted(OCR.glob("*.png")):
        out = dst / (png.stem + ".out")
        shutil.copy(png, dst / png.name)
        shutil.copytree(OCR / (png.stem + ".out"), out)
        shutil.copy(FLOW / (png.stem + ".out") / "contours.1.zip", out)
        shutil.copy(LAYOUT / (png.stem + ".out") / "contours.2.zip", out)
        stems.append(png.stem)
    return stems


def completed(src, stage):
    rt = json.loads((src / "runtime.json").read_text())
    if rt.get(stage, {}).get("status") != "COMPLETED":
        raise RuntimeError("%s: %s" % (src, rt.get(stage)))
    return rt[stage]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "tests" / "data" /
                                         "torch_compose"))
    args = ap.parse_args()
    from origami_tpu.batch.detect.compose import ComposeProcessor
    from origami_tpu.batch.detect.order import ReadingOrderProcessor

    common = dict(lock_strategy="NONE", plain=True)
    out = Path(args.out)
    with tempfile.TemporaryDirectory() as tmp:
        corpus = Path(tmp) / "corpus"
        stems = corpus_from_fixtures(corpus)
        ReadingOrderProcessor(dict(common)).traverse(str(corpus))
        for stem in stems:
            src = corpus / (stem + ".out")
            print(stem, completed(src, ORDER_STAGE))
            shutil.copy(OCR / "ref" / (stem + ".single.ocr.zip"),
                        src / "ocr.zip")
        ComposeProcessor(dict(common)).traverse(str(corpus))
        kept = {}
        for stem in stems:
            src = corpus / (stem + ".out")
            print(stem, completed(src, COMPOSE_STAGE))
            kept[stem] = (src / "compose.zip").read_bytes()
        ComposeProcessor(dict(common, page_xml=True,
                              overwrite=True)).traverse(str(corpus))
        if out.exists():
            shutil.rmtree(out)
        for stem in stems:
            src = corpus / (stem + ".out")
            completed(src, COMPOSE_STAGE)
            dst = out / (stem + ".out")
            dst.mkdir(parents=True)
            shutil.copyfile(src / "order.json", dst / "order.json")
            (dst / "compose.zip").write_bytes(kept[stem])
            shutil.copyfile(src / "compose.zip", dst / "compose_xml.zip")
    total = sum(p.stat().st_size for p in out.rglob("*") if p.is_file())
    print("wrote %s (%d bytes)" % (out, total))


if __name__ == "__main__":
    main()
