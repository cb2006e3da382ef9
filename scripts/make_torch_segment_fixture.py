"""Build the segment-stage references that the PyTorch port is held
against.

Runs the JAX package on the CPU over the two pages of
tests/data/torch_ocr/full (which stay as they are) and writes, per page,
under tests/data/torch_segment/ref/:

    <page>.f32.segment.zip        the students' label maps with every
                                  convolution in float32: the predictor
                                  of core/predict.py with its U-Nets
                                  rebuilt by create_unet(dtype=float32)
    <page>.heuristic.segment.zip  HeuristicSegmentationPredictor's output
    <page>.sauvola15.npz          ops.binarize.sauvola_packed(page, 15),
                                  the mask Page.binarized unpacks

(the students' bf16 label maps are the fixture's own segment.zip files).
Nothing is random: the pages and the weights are files of the
repository.

    JAX_PLATFORMS=cpu python scripts/make_torch_segment_fixture.py
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("ORIGAMI_TPU_PLATFORM", "cpu")

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def f32_predictor(students):
    """SegmentationPredictor whose graphs run float32 U-Nets."""
    import jax.numpy as jnp
    from origami_tpu.core import predict
    from origami_tpu.models.unet import create_unet

    pred = predict.SegmentationPredictor(students, target="quality")
    graphs = []
    for g in pred._graphs:
        meta = g.meta
        model = create_unet(len(meta["classes"]),
                            width=meta.get("width", 1.0),
                            dtype=jnp.float32, s2d=meta.get("s2d", 1),
                            features=meta.get("features"),
                            bottleneck=meta.get("bottleneck"))
        graphs.append(predict._EnsembleGraph(model, g._params, meta))
    pred._graphs = graphs
    return pred


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pages", default=str(ROOT / "tests/data/torch_ocr/full"))
    ap.add_argument("--out", default=str(ROOT / "tests/data/torch_segment"))
    args = ap.parse_args()

    import numpy as np
    import jax.numpy as jnp
    from origami_tpu.core.page import Page
    from origami_tpu.core.predict import HeuristicSegmentationPredictor
    from origami_tpu.ops.binarize import sauvola_packed

    ref = Path(args.out) / "ref"
    ref.mkdir(parents=True, exist_ok=True)
    pages = sorted(Path(args.pages).glob("*.png"))
    images = [Page(p).warped for p in pages]

    segs = f32_predictor(ROOT / "models_pretrained" / "students") \
        .predict_batch(images)
    heuristic = HeuristicSegmentationPredictor()
    for png, img, seg in zip(pages, images, segs):
        seg.save(ref / (png.stem + ".f32.segment.zip"))
        heuristic(img).save(ref / (png.stem + ".heuristic.segment.zip"))
        np.savez_compressed(
            ref / (png.stem + ".sauvola15.npz"),
            packed=np.asarray(sauvola_packed(jnp.asarray(img), 15)))
    size = sum(f.stat().st_size for f in ref.iterdir())
    print("%s: %d files, %d bytes" % (ref, len(list(ref.iterdir())), size))


if __name__ == "__main__":
    main()
