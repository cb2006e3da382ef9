"""detect.segment — U-Net page segmentation (CLI stage 1), on the card.

Port of origami_tpu/batch/detect/segment.py: image -> segment.zip
(paletted label PNGs + class JSONs) plus the stage's runtime.json entry.
A whole lock-chunk of pages goes through the region and separator
ensembles in one device batch; `--model heuristic` uses the model-free
device segmenter. Every batch also prefetches each page's Sauvola mask
(the CUDA kernel of csrc/sauvola.cu) into the process-wide LRU that
flow, layout and lines read.

    python -m origami_tpu_torch.batch.detect.segment \
        -m models_pretrained/students CORPUS [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from origami_tpu_torch.batch.core.io import Artifact, Output
from origami_tpu_torch.batch.core.processor import (BatchedProcessor,
                                                    Processor)
from origami_tpu_torch.core.page import Page

# the JAX stage's runtime.json key: a page segmented by either package
# reads the same to every later stage
STAGE_NAME = "origami_tpu.batch.detect.segment"

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class SegmentationProcessor(BatchedProcessor):
    def __init__(self, model, options):
        super().__init__(options, batch_size=options.get("batch_size", 8))
        if str(model).lower().startswith("auto:"):
            raise NotImplementedError(
                "-m auto:<dir> (trained models with a per-page heuristic "
                "fallback) is not ported yet (ROADMAP.md, queue A)")
        self._model_path = model
        self._target = options.get("target", "quality")
        self._dtype = _DTYPES[options.get("dtype", "bfloat16")]
        self._predictor = None

    @property
    def processor_name(self):
        return STAGE_NAME

    def artifacts(self):
        return [("output", Output(Artifact.SEGMENTATION))]

    def _get_predictor(self):
        if self._predictor is None:
            spec = str(self._model_path)
            if spec.lower() in ("heuristic", "fake"):
                from origami_tpu_torch.core.predict import \
                    HeuristicSegmentationPredictor
                self._predictor = HeuristicSegmentationPredictor(
                    device=self.device)
            else:
                from origami_tpu_torch.core.predict import \
                    SegmentationPredictor
                self._predictor = SegmentationPredictor(
                    self._model_path, target=self._target,
                    device=self.device, dtype=self._dtype)
        return self._predictor

    def preload(self, page_path):
        # the image decodes on the feeder threads while the device
        # segments the previous batch
        return Page(page_path, device=self.device).warped

    def process_batch(self, pages):
        predictor = self._get_predictor()
        page_objs = [Page(p, device=self.device) for p, _ in pages]
        images = [kwargs.get("_preloaded") if kwargs.get("_preloaded")
                  is not None else pg.warped
                  for (p, kwargs), pg in zip(pages, page_objs)]
        segs = predictor.predict_batch(images)
        for (p, kwargs), seg in zip(pages, segs):
            kwargs["output"].segmentation(seg)
        # prefetch the Sauvola mask into the process-wide LRU, so flow
        # (its first consumer) finds it there; a failure here fails the
        # batch
        for pg in page_objs:
            pg.binarized
        return {}


def parser():
    p = argparse.ArgumentParser(
        prog="python -m origami_tpu_torch.batch.detect.segment",
        description="Segment all document images in DATA_PATH.")
    p.add_argument("-m", "--model", required=True, type=str,
                   help="models directory, or 'heuristic' for the "
                        "model-free device segmenter")
    p.add_argument("-t", "--target", type=str, default="quality",
                   help="speed (1 model per net) vs quality (full "
                        "ensembles)")
    p.add_argument("-b", "--batch-size", type=int, default=8,
                   help="pages per device batch")
    p.add_argument("--dtype", choices=sorted(_DTYPES), default="bfloat16",
                   help="the convolutions' type: bfloat16 (the main path) "
                        "or float32 (parity runs; turns TF32 off)")
    p.add_argument("data_path", type=str)
    Processor.add_arguments(p)
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    if not Path(args.data_path).exists():
        raise SystemExit("no such path: %s" % args.data_path)
    if args.dtype == "float32":
        # float32 means float32: cuDNN would run these convolutions in
        # TF32 (about three decimal digits) by default
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    from origami_tpu_torch.ops.binarize import launches
    SegmentationProcessor(args.model, vars(args)).traverse(args.data_path)
    # one JSON line: how often each kernel ran (read by chip_smoke.py)
    print(json.dumps({"kernel_launches": dict(launches)}), flush=True)


if __name__ == "__main__":
    main()
