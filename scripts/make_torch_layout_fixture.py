"""Build the layout-stage fixture that the PyTorch port is held against.

Runs the JAX `layout` stage (rule set bbz, as bench.py does) on the CPU
over the two pages of tests/data/torch_flow, with their PNG and
segment.zip from tests/data/torch_ocr/full, and keeps what it writes:

    tests/data/torch_layout/<page>.out/{contours.2.zip, tables.json}

The script checks that each tables.json equals
torch_ocr/full/<page>.out/tables.json, which came from the same chain.

    JAX_PLATFORMS=cpu python scripts/make_torch_layout_fixture.py
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
INPUTS = ("contours.0.zip", "lines.0.zip", "contours.1.zip", "dewarp.zip",
          "runtime.json")
KEEP = ("contours.2.zip", "tables.json")
STAGE = "origami_tpu.batch.detect.layout"


def corpus_from_fixtures(dst):
    """Page PNGs and segment.zip of torch_ocr/full with the contours,
    flow and dewarp stages' artifacts of torch_flow."""
    dst.mkdir(parents=True, exist_ok=True)
    stems = []
    for png in sorted(OCR.glob("*.png")):
        out = dst / (png.stem + ".out")
        out.mkdir()
        shutil.copy(png, dst / png.name)
        shutil.copy(OCR / (png.stem + ".out") / "segment.zip", out)
        for name in INPUTS:
            shutil.copy(FLOW / (png.stem + ".out") / name, out)
        stems.append(png.stem)
    return stems


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "tests" / "data" /
                                         "torch_layout"))
    args = ap.parse_args()
    from origami_tpu.batch.detect.layout import LayoutDetectionProcessor

    out = Path(args.out)
    with tempfile.TemporaryDirectory() as tmp:
        corpus = Path(tmp) / "corpus"
        stems = corpus_from_fixtures(corpus)
        LayoutDetectionProcessor(dict(lock_strategy="NONE", plain=True,
                                      layout="bbz")).traverse(str(corpus))
        if out.exists():
            shutil.rmtree(out)
        for stem in stems:
            src = corpus / (stem + ".out")
            rt = json.loads((src / "runtime.json").read_text())
            if rt.get(STAGE, {}).get("status") != "COMPLETED":
                raise RuntimeError("%s: %s" % (stem, rt.get(STAGE)))
            dst = out / (stem + ".out")
            dst.mkdir(parents=True)
            for name in KEEP:
                shutil.copy(src / name, dst / name)
            want = json.loads((OCR / (stem + ".out") / "tables.json")
                              .read_text())
            got = json.loads((dst / "tables.json").read_text())
            if got != want:
                raise RuntimeError("%s: tables.json differs from %s" % (
                    stem, OCR / (stem + ".out") / "tables.json"))
            print(stem, rt[STAGE])
    total = sum(p.stat().st_size for p in out.rglob("*") if p.is_file())
    print("wrote %s (%d bytes)" % (out, total))


if __name__ == "__main__":
    main()
