#!/usr/bin/env python3
"""Build tests/data/torch_gt: the JAX package's ground-truth generation,
segmentation evaluation and affine-warp helpers on the pages of
chip_smoke.train_corpus, which chip_smoke.py phase 15 holds the port to
on the card.

    JAX_PLATFORMS=cpu python scripts/make_torch_gt_fixture.py \
        [--only bin,deskew,gt,lines,eval]

Writes, from the JAX functions run on the CPU:

    params.json          every parameter passed below (chip_smoke's
                         GT_PARAMS, the extension amounts among them; the
                         deskew cases; the Sauvola window; the line and
                         evaluation settings) and the two float32
                         evaluation reports
    bin/<page>.png       gen_binarized's 1-bit pages (window 15)
    deskew_<page>.npz    deskew_pair of the page and its region map
                         (resized to the page, nearest) at
                         chip_smoke.DESKEW_CASES' angle: the labels whole,
                         every SAMPLE_ROWS-th row of the image
    gt_<page>.npz        chip_smoke.gt_chain given the JAX modules: the
                         cleaned segments, the skew, the master, stops
                         and region rasters
    lines_<page>.npz     chip_smoke.line_results, given the JAX modules,
                         on the OCR fixture's
                         pages: Line.image on both routes, Line.ink, the
                         Deskewer's angle, image rows and a geometry

The evaluation runs models_pretrained/students with every convolution in
float32 (make_torch_segment_fixture.f32_predictor) over the corpus as the
validation set. About 3 minutes here.
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

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import cv2  # noqa: E402
import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402

OUT = ROOT / "tests" / "data" / "torch_gt"
WINDOW = 15
EVAL = dict(models=cs.STUDENTS, target="quality", tol=3, batch=4)
PARTS = ("bin", "deskew", "gt", "lines", "eval")


def deskew_case(corpus, page, angle):
    from origami_tpu.train.segment.annotations import load_page_annotations
    from origami_tpu.train.segment.skew import deskew_pair
    ann = load_page_annotations(corpus / (page + ".png"))
    h, w = ann.image.shape
    labels = cv2.resize(ann.labels("region"), (w, h),
                        interpolation=cv2.INTER_NEAREST)
    image, lab = deskew_pair(ann.image, labels, angle)
    return dict(image=image[::cs.SAMPLE_ROWS], labels=lab)


def jax_modules():
    """The JAX package's modules under chip_smoke.gt_modules' names."""
    from origami_tpu.batch.core import deskew, io
    from origami_tpu.core import math
    from origami_tpu.train.segment import (annotations, labels, regions,
                                           segments)
    return dict(annotations=annotations, segments=segments,
                regions=regions, labels=labels, math=math, io=io,
                deskew=deskew)


def eval_reports(corpus):
    from make_torch_segment_fixture import f32_predictor
    from origami_tpu.core import predict
    from origami_tpu.train import bootstrap
    models = ROOT / EVAL["models"]
    pred = f32_predictor(models)
    real = predict.SegmentationPredictor
    predict.SegmentationPredictor = lambda *args, **kwargs: pred
    try:
        return dict(
            segmentation=bootstrap.eval_segmentation(
                models, corpus, target=EVAL["target"], batch=EVAL["batch"]),
            separator_tolerant=bootstrap.eval_separator_tolerant(
                models, corpus, target=EVAL["target"], tol=EVAL["tol"],
                batch=EVAL["batch"]))
    finally:
        predict.SegmentationPredictor = real


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default=",".join(PARTS))
    only = set(ap.parse_args().only.split(","))
    OUT.mkdir(parents=True, exist_ok=True)
    params_path = OUT / "params.json"
    params = json.loads(params_path.read_text()) if params_path.exists() \
        else {}
    params.update(gt=cs.GT_PARAMS, window_size=WINDOW,
                  deskew=[list(c) for c in cs.DESKEW_CASES],
                  sample_rows=cs.SAMPLE_ROWS,
                  lines=dict(pages=list(cs.LINE_PAGES),
                             count=cs.LINE_COUNT, height=cs.LINE_HEIGHT))
    with tempfile.TemporaryDirectory(prefix="torch_gt_") as tmp:
        corpus = cs.train_corpus(Path(tmp) / "corpus")
        pages = sorted(p for p in corpus.glob("*.png")
                       if ".labels." not in p.name)
        if "bin" in only:
            from origami_tpu.train.segment.binarize import gen_binarized
            n = gen_binarized(corpus, WINDOW)
            shutil.rmtree(OUT / "bin", ignore_errors=True)
            shutil.copytree(Path(tmp) / "bin", OUT / "bin")
            print("bin: %d pages" % n)
        if "deskew" in only:
            for page, angle in cs.DESKEW_CASES:
                np.savez_compressed(OUT / ("deskew_%s.npz" % page),
                                    **deskew_case(corpus, page, angle))
                print("deskew %s at %g" % (page, angle))
        if "gt" in only:
            mods = jax_modules()
            for png in pages:
                res = cs.gt_chain(mods, png, cs.GT_PARAMS)
                np.savez_compressed(OUT / ("gt_%s.npz" % png.stem), **res)
                print("gt %s: skew %r, %d regions" % (
                    png.stem, float(res["skew"]), int(res["regions"].max())))
        if "lines" in only:
            for page in cs.LINE_PAGES:
                res = cs.line_results(jax_modules(),
                                      cs.FIXTURE / (page + ".png"))
                np.savez_compressed(OUT / ("lines_%s.npz" % page), **res)
                print("lines %s" % page)
        if "eval" in only:
            params["eval"] = dict(EVAL, reports=eval_reports(corpus))
            print(json.dumps(params["eval"]["reports"]))
    params_path.write_text(json.dumps(params, indent=1, sort_keys=True)
                           + "\n")
    total = sum(f.stat().st_size for f in OUT.rglob("*") if f.is_file())
    print("%s: %d bytes" % (OUT.relative_to(ROOT), total))


if __name__ == "__main__":
    main()
