"""Build the OCR-stage fixture that the PyTorch port is held against.

Runs the JAX chain on the CPU up to `order` in trained-student mode (the
stage list of scripts/make_compare_report.run_pipeline, with
models_pretrained/students) over synthetic pages from
train.synth.write_corpus, keeps only what the OCR stage reads, then runs
the JAX OCR stage three ways and stores each ocr.zip as a reference:

    tests/data/torch_ocr/full/<page>.png
    tests/data/torch_ocr/full/<page>.out/{segment.zip, dewarp.zip,
        contours.3.zip, lines.3.zip, tables.json, runtime.json}
    tests/data/torch_ocr/full/ref/<page>.<mode>.ocr.zip
        mode: single (-m models_pretrained/recognizer),
              ensemble (-m models_pretrained: recognizer{,2,3} voted),
              gather (single, --extract-mode gather)

and `tests/data/torch_ocr/small/`: one page whose lines.3.zip is trimmed
to about 24 lines that cover the p1, p2 and gather extraction profiles
(where the page has them) and at least two width buckets, with its own
three references.

    JAX_PLATFORMS=cpu python scripts/make_torch_ocr_fixture.py
"""

from __future__ import annotations

import argparse
import collections
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

KEEP = ("segment.zip", "dewarp.zip", "contours.3.zip", "lines.3.zip",
        "tables.json", "runtime.json")
OCR_STAGE = "origami_tpu.batch.detect.ocr"
MODES = {
    "single": ("models_pretrained/recognizer", {}),
    "ensemble": ("models_pretrained", {}),
    "gather": ("models_pretrained/recognizer", {"extract_mode": "gather"}),
}


def run_to_order(corpus, students):
    """make_compare_report.run_pipeline's stages, segment .. order."""
    from origami_tpu.batch.detect.contours import ContoursProcessor
    from origami_tpu.batch.detect.dewarp import DewarpProcessor
    from origami_tpu.batch.detect.flow import FlowDetectionProcessor
    from origami_tpu.batch.detect.layout import LayoutDetectionProcessor
    from origami_tpu.batch.detect.lines import LineDetectionProcessor
    from origami_tpu.batch.detect.order import ReadingOrderProcessor
    from origami_tpu.batch.detect.segment import SegmentationProcessor

    opts = dict(lock_strategy="NONE", plain=True)
    for proc in (
            SegmentationProcessor(str(students),
                                  dict(target="quality", **opts)),
            ContoursProcessor(opts),
            FlowDetectionProcessor(opts),
            DewarpProcessor(opts),
            LayoutDetectionProcessor(dict(layout="bbz", **opts)),
            LineDetectionProcessor(opts),
            ReadingOrderProcessor(opts)):
        proc.traverse(str(corpus))


def keep_ocr_inputs(src, dst):
    """Copy the page images and the OCR stage's inputs; runtime.json
    without an ocr entry, so the stage finds the pages ready."""
    dst.mkdir(parents=True, exist_ok=True)
    pages = sorted(p for p in src.glob("*.png") if ".labels." not in p.name)
    for img in pages:
        shutil.copy(img, dst / img.name)
        out_src = src / (img.stem + ".out")
        out_dst = dst / (img.stem + ".out")
        out_dst.mkdir(exist_ok=True)
        for name in KEEP:
            shutil.copy(out_src / name, out_dst / name)
        rt = json.loads((out_dst / "runtime.json").read_text())
        rt.pop(OCR_STAGE, None)
        (out_dst / "runtime.json").write_text(json.dumps(rt))
    return [p.stem for p in pages]


def run_ocr(fixture, mode, scratch):
    """Run the JAX OCR stage on a copy of `fixture`; store the refs."""
    from origami_tpu.batch.detect.ocr import OCRProcessor
    model, extra = MODES[mode]
    work = scratch / ("ocr_" + mode)
    if work.exists():
        shutil.rmtree(work)
    shutil.copytree(fixture, work, ignore=shutil.ignore_patterns("ref"))
    OCRProcessor(dict(model=str(ROOT / model), lock_strategy="NONE",
                      plain=True, **extra)).traverse(str(work))
    ref = fixture / "ref"
    ref.mkdir(exist_ok=True)
    for img in sorted(work.glob("*.png")):
        src = work / (img.stem + ".out") / "ocr.zip"
        if not src.exists():
            raise RuntimeError("JAX ocr wrote no %s" % src)
        shutil.copy(src, ref / ("%s.%s.ocr.zip" % (img.stem, mode)))


def line_profiles(fixture, stem, line_height=48, max_width=2048):
    """{line path: (profile, width bucket)} for every extraction part of
    a page, as batch.core.lines.LineExtractor.device_groups routes it
    under --extract-mode banded."""
    import numpy as np
    from origami_tpu.batch.core.io import Input, Artifact, Stage
    from origami_tpu.batch.core.lines import LineExtractor
    from origami_tpu.core.block import BAND_PAD
    from origami_tpu.models.recognizer import strip_width_bucket

    reader = Input(Artifact.LINES, Artifact.TABLES,
                   stage=Stage.RELIABLE).instantiate(
        fixture / (stem + ".png"))
    ext = LineExtractor(reader.tables, line_height, {},
                        min_confidence=reader.lines.min_confidence,
                        max_width=max_width)
    out = collections.defaultdict(set)
    pt, pb = BAND_PAD
    for lpath, line, column in (
            (lp, ln, col) for lp, l0 in reader.lines.by_path.items()
            for _, ln, col in ext.parts({lp: l0})):
        band_h = float(np.linalg.norm(line._up)) * (1 + pt + pb)
        xres = line_height / max(band_h, 1.0)
        frame, width = line.dewarped_frame(line_height, xres=xres,
                                           column=column, pad=BAND_PAD)
        if width > max_width:
            frame, width = line.dewarped_frame(
                line_height, xres=xres * max_width / width,
                column=column, pad=BAND_PAD)
            width = min(width, max_width)
        prof = LineExtractor._extract_profile(frame, width, line_height,
                                              object())
        key = tuple(map(str, lpath))
        out[key].add((prof, strip_width_bucket(width, 2048)))
    return out


def pick_lines(by_line, n=24):
    """Line paths of one page: every gather/p2 line first (up to half
    of n), then p1 lines spread over the width buckets."""
    rare = [k for k, t in by_line.items()
            if any(p != "p1" for p, _ in t)][: n // 2]
    chosen = list(rare)
    buckets = collections.defaultdict(list)
    for k, t in sorted(by_line.items()):
        if k in chosen:
            continue
        buckets[min(b for _, b in t)].append(k)
    while len(chosen) < n and any(buckets.values()):
        for b in sorted(buckets):
            if buckets[b] and len(chosen) < n:
                chosen.append(buckets[b].pop(0))
    return chosen


def trim_lines_zip(path, keep_line_paths):
    """Rewrite lines.3.zip with only the lines in keep_line_paths."""
    keep = {"/".join(p) + ".json" for p in keep_line_paths}
    with zipfile.ZipFile(path) as zf:
        items = [(n, zf.read(n)) for n in zf.namelist()]
    kept = 0
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        for name, data in items:
            if name == "meta.json" or name in keep:
                zf.writestr(name, data)
                kept += name in keep
    return kept


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(ROOT / "tests/data/torch_ocr"))
    ap.add_argument("--pages", type=int, default=2)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--small-lines", type=int, default=24)
    args = ap.parse_args()

    from origami_tpu.train.synth import write_corpus

    out = Path(args.out)
    full, small = out / "full", out / "small"
    for d in (full, small):
        if d.exists():
            shutil.rmtree(d)
    with tempfile.TemporaryDirectory() as tmp:
        scratch = Path(tmp)
        corpus = scratch / "corpus"
        write_corpus(corpus, args.pages, seed=args.seed)
        for p in corpus.iterdir():
            if ".labels." in p.name or p.name.endswith(".gt.json"):
                p.unlink()
        run_to_order(corpus, ROOT / "models_pretrained" / "students")
        stems = keep_ocr_inputs(corpus, full)

        # small: the page with the most non-p1 lines, trimmed
        best = None
        for stem in stems:
            prof = line_profiles(full, stem)
            rare = sum(any(p != "p1" for p, _ in t) for t in prof.values())
            if best is None or rare > best[0]:
                best = (rare, stem, prof)
        _, stem, prof = best
        small.mkdir(parents=True)
        shutil.copy(full / (stem + ".png"), small / (stem + ".png"))
        shutil.copytree(full / (stem + ".out"), small / (stem + ".out"))
        line_paths = pick_lines(prof, args.small_lines)
        kept = trim_lines_zip(small / (stem + ".out") / "lines.3.zip",
                              line_paths)
        tags = collections.Counter(t for p in line_paths
                                   for t in prof.get(p, ()))
        print("small fixture: page %s, %d lines, (profile, bucket) %s"
              % (stem, kept, dict(tags)), flush=True)

        for fixture in (small, full):
            for mode in MODES:
                run_ocr(fixture, mode, scratch)
    for d in (full, small):
        size = sum(f.stat().st_size for f in d.rglob("*") if f.is_file())
        print("%s: %d bytes" % (d, size))


if __name__ == "__main__":
    main()
