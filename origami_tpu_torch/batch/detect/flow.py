"""detect.flow — page warp samples and warped lines (CLI stage 3).

Port of origami_tpu/batch/detect/flow.py: image + contours.0.zip ->
flow.zip (H and V angle samples) and lines.0.zip (the detected lines).
The page is binarized on the card (the Sauvola kernel of csrc/sauvola.cu,
bit-packed, one launch per page) and read back once; line detection
(projection profiles per block crop), the text areas and the samples are
host numpy and the port's own geometry.

    python -m origami_tpu_torch.batch.detect.flow CORPUS [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import math
from pathlib import Path

import numpy as np

from origami_tpu_torch.batch.core.io import Artifact, Input, Output, Stage
from origami_tpu_torch.batch.core.processor import (BatchedProcessor,
                                                    Processor)
from origami_tpu_torch.core.baselines import (detect_baselines,
                                              estimate_skew,
                                              extend_baselines, unclip_band)
from origami_tpu_torch.core.block import Line, TextAreaFactory
from origami_tpu_torch.core.flow import (Samples, border_angle_samples,
                                         separator_angle_samples)
from origami_tpu_torch.core.page import Page

# the JAX stage's runtime.json key: later stages of either package read it
STAGE_NAME = "origami_tpu.batch.detect.flow"


def detect_block_lines(page, regions, min_height=4, force_lines=False,
                       region_filter=None, separators=None,
                       binarized=None):
    """Detect lines in all blocks of a page (flow.py:29-103).

    Returns {block_path: [Line, ...]}. With `separators`, buffered
    separator geometry is carved out of each non-TABULAR block's text
    area, so extended baselines stop short of a column rule. `binarized`
    (a bool mask, True = paper) replaces the page's own Sauvola mask,
    for holding the host code against another binarization."""
    from origami_tpu_torch.geometry.native_bindings import library
    from origami_tpu_torch.geometry.ops import buffer as _buffer
    library()       # a missing geometry library raises, never skipped
    dewarped = regions is not None and _any_dewarped(regions)
    if binarized is None:
        binarized = page.dewarped_binarized if dewarped else page.binarized
    blocks = regions.by_path
    obstacles = []
    if separators is not None:
        for geom in separators.geoms:
            try:
                obstacles.append(_buffer(geom, 3.0))
            except Exception:
                pass        # as the JAX stage: a separator it cannot
                # buffer is no obstacle
    text_area = TextAreaFactory(list(blocks.values()), obstacles=obstacles)
    # page-level skew once (coarsely decimated), refined per block; a
    # dewarped page is deskewed by construction: hint 0
    page_skew = estimate_skew(
        (~np.asarray(binarized, dtype=bool)).astype(np.float32),
        max_ds=8, hint=0.0 if dewarped else None)
    det_by_block = {}
    h, w = binarized.shape[:2]
    for path, block in blocks.items():
        if region_filter is not None and not region_filter(path):
            continue
        x0, y0, x1, y1 = [int(v) for v in block.bounds]
        x0 = max(0, x0)
        y0 = max(0, y0)
        x1 = min(w, x1 + 1)
        y1 = min(h, y1 + 1)
        if x1 - x0 < 2 or y1 - y0 < min_height:
            det_by_block[path] = (block, [])
            continue
        crop = binarized[y0:y1, x0:x1]
        det_by_block[path] = (block, detect_baselines(
            crop, origin=(x0, y0), min_line_height=min_height,
            force_one=force_lines, skew_hint=page_skew))

    # the page-median band height gates the crop-clip recovery
    heights = [d.ascent + d.descent
               for _, dets in det_by_block.values()
               for d in dets if not d.fake]
    page_band_h = float(np.median(heights)) if heights else 0.0

    out = {}
    for path, (block, detections) in det_by_block.items():
        area = text_area(block, avoid_obstacles="TABULAR" not in tuple(path))
        dets = [unclip_band(det, page_band_h) for det in detections]
        ext = extend_baselines(area, [(d.p, d.right, d.up) for d in dets])
        out[path] = [
            Line(block, p=p, right=right, up=det.up,
                 tesseract_data=det.data, text_area=area)
            for det, (p, right) in zip(dets, ext)]
    return out


def _any_dewarped(regions):
    for b in regions.by_path.values():
        return b.stage is not None and b.stage.is_dewarped
    return False


class FlowDetectionProcessor(BatchedProcessor):
    """One page per batch: a page that fails is recorded FAILED on its
    own and the stage goes on with the next."""

    POOLED = True

    def __init__(self, options):
        super().__init__(options, batch_size=1)
        self._opt = options

    @property
    def processor_name(self):
        return STAGE_NAME

    def artifacts(self):
        return [
            ("warped", Input(Artifact.CONTOURS, stage=Stage.WARPED)),
            ("output", Output(Artifact.FLOW, Artifact.LINES,
                              stage=Stage.WARPED)),
        ]

    def preload(self, page_path):
        # the PNG decodes on a feeder thread into the process-wide LRU
        return Page(page_path, device=self.device).warped

    def process_batch(self, pages):
        return {p: self.process(p, kw["warped"], kw["output"])
                for p, kw in pages}

    def process(self, page_path, warped, output):
        page = warped.page
        geometry = page.geometry(False)
        regions = warped.regions
        separators = warped.separators

        block_lines = detect_block_lines(page, regions,
                                         separators=separators)

        max_phi = math.radians(self._opt.get("max_phi", 30.0))
        min_len = geometry.rel_length(self._opt.get("min_line_length", 0.05))

        samples_h = Samples(geometry)
        samples_v = Samples(geometry)

        # separator tangents
        sep_samples = separator_angle_samples(separators)
        for (pt, phi) in sep_samples["h"]:
            if abs(phi) < max_phi:
                samples_h.append(pt, phi)
        for (pt, phi) in sep_samples["v"]:
            if abs(phi - math.pi / 2) < max_phi:
                samples_v.append(pt, phi)

        # baseline angles (H field) + orthogonals (V field)
        for path, lines in block_lines.items():
            for line in lines:
                if line.length < min_len:
                    continue
                phi = line.angle
                if abs(phi) < max_phi:
                    samples_h.append(tuple(line.center), phi)
                    samples_v.append(tuple(line.center), phi + math.pi / 2)

        if self._opt.get("estimate_border_skew"):
            for pt, phi in border_angle_samples(page.binarized):
                if abs(phi - math.pi / 2) < max_phi:
                    samples_v.append(pt, phi)

        with output.flow() as zf:
            samples_h.save(zf, "h")
            samples_v.save(zf, "v")

        with output.lines() as zf:
            zf.writestr("meta.json", json.dumps(dict(version=1)))
            for parts, lines in block_lines.items():
                for i, line in enumerate(lines):
                    zf.writestr("/".join(parts) + "/%d.json" % i,
                                json.dumps(line.info))
        return dict(n_lines=sum(map(len, block_lines.values())),
                    n_samples_h=len(samples_h),
                    n_samples_v=len(samples_v))


def parser():
    p = argparse.ArgumentParser(
        prog="python -m origami_tpu_torch.batch.detect.flow",
        description="Detect page flow and warped lines in DATA_PATH.")
    p.add_argument("--max-phi", type=float, default=30.0,
                   help="Max baseline angle (deg) used as sample.")
    p.add_argument("--max-phi-std", type=float, default=0.1,
                   help="Max angle std for a trusted separator.")
    p.add_argument("--min-line-length", type=float, default=0.05,
                   help="Min relative length of used lines.")
    p.add_argument("--estimate-border-skew", action="store_true",
                   help="Add V samples from the page content's side "
                        "borders.")
    p.add_argument("data_path", type=str)
    Processor.add_arguments(p)
    return p


def kernel_launches():
    """Every port kernel's launch count in this process."""
    from origami_tpu_torch.ops import binarize, gather, grid, remap
    return {**remap.launches, **binarize.launches, **gather.launches,
            **grid.launches}


def main(argv=None):
    args = parser().parse_args(argv)
    if not Path(args.data_path).exists():
        raise SystemExit("no such path: %s" % args.data_path)
    FlowDetectionProcessor(vars(args)).traverse(args.data_path)
    # one JSON line: how often each kernel ran (read by chip_smoke.py)
    print(json.dumps({"kernel_launches": kernel_launches()}), flush=True)


if __name__ == "__main__":
    main()
