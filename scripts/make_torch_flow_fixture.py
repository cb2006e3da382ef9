"""Build the flow/dewarp-stage fixture that the PyTorch port is held
against.

Runs the JAX `contours`, `flow` and `dewarp` stages on the CPU over the
two pages of tests/data/torch_ocr/full (their PNG and segment.zip, the
trained-student segmentation of scripts/make_torch_ocr_fixture.py) and
keeps what the two stages read and write:

    tests/data/torch_flow/<page>.out/{contours.0.zip, flow.zip,
        lines.0.zip, dewarp.zip, contours.1.zip, runtime.json}

No page PNG or segment.zip is copied: the tests and chip_smoke.py
assemble a corpus from torch_ocr/full's. The JAX Sauvola masks of the
warped pages, which the flow stage binarizes, are already
tests/data/torch_segment/ref/<page>.sauvola15.npz. The script checks
that each dewarp.zip holds the grid of torch_ocr/full/<page>.out/dewarp.zip,
which came from the same chain.

    JAX_PLATFORMS=cpu python scripts/make_torch_flow_fixture.py
"""

from __future__ import annotations

import argparse
import io
import json
import os
import shutil
import sys
import tempfile
import zipfile
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("ORIGAMI_TPU_PLATFORM", "cpu")

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SOURCE = ROOT / "tests" / "data" / "torch_ocr" / "full"
KEEP = ("contours.0.zip", "flow.zip", "lines.0.zip", "dewarp.zip",
        "contours.1.zip", "runtime.json")
STAGES = ("origami_tpu.batch.detect.segment",
          "origami_tpu.batch.detect.contours",
          "origami_tpu.batch.detect.flow",
          "origami_tpu.batch.detect.dewarp")


def corpus_from_source(dst):
    """Page PNGs and segment.zip of torch_ocr/full, with a runtime.json
    that holds only the segment stage."""
    dst.mkdir(parents=True, exist_ok=True)
    stems = []
    for png in sorted(SOURCE.glob("*.png")):
        shutil.copy(png, dst / png.name)
        out = dst / (png.stem + ".out")
        out.mkdir(exist_ok=True)
        shutil.copy(SOURCE / (png.stem + ".out") / "segment.zip",
                    out / "segment.zip")
        rt = json.loads((SOURCE / (png.stem + ".out") /
                         "runtime.json").read_text())
        (out / "runtime.json").write_text(json.dumps(
            {STAGES[0]: rt[STAGES[0]]}))
        stems.append(png.stem)
    return stems


def zip_entries(path):
    with zipfile.ZipFile(path) as zf:
        return {n: zf.read(n) for n in zf.namelist()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "tests" / "data" /
                                         "torch_flow"))
    args = ap.parse_args()
    from origami_tpu.batch.detect.contours import ContoursProcessor
    from origami_tpu.batch.detect.dewarp import DewarpProcessor
    from origami_tpu.batch.detect.flow import FlowDetectionProcessor

    out = Path(args.out)
    with tempfile.TemporaryDirectory() as tmp:
        corpus = Path(tmp) / "corpus"
        stems = corpus_from_source(corpus)
        opts = dict(lock_strategy="NONE", plain=True)
        for proc in (ContoursProcessor(opts), FlowDetectionProcessor(opts),
                     DewarpProcessor(opts)):
            proc.traverse(str(corpus))
        if out.exists():
            shutil.rmtree(out)
        for stem in stems:
            src = corpus / (stem + ".out")
            rt = json.loads((src / "runtime.json").read_text())
            bad = {k: v for k, v in rt.items()
                   if k in STAGES and v.get("status") != "COMPLETED"}
            if bad:
                raise RuntimeError("%s: %s" % (stem, bad))
            dst = out / (stem + ".out")
            dst.mkdir(parents=True)
            for name in KEEP:
                shutil.copy(src / name, dst / name)
            want = zip_entries(SOURCE / (stem + ".out") / "dewarp.zip")
            got = zip_entries(dst / "dewarp.zip")
            if got != want:
                raise RuntimeError(
                    "%s: dewarp.zip differs from %s" % (
                        stem, SOURCE / (stem + ".out") / "dewarp.zip"))
            print(stem, {k: v for k, v in rt.items() if k in STAGES[2:]})
    total = sum(p.stat().st_size for p in out.rglob("*") if p.is_file())
    print("wrote %s (%d bytes)" % (out, total))


if __name__ == "__main__":
    main()
