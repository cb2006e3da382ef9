"""utils.signature — page layout signatures for corpus clustering.

Port of origami_tpu/batch/utils/signature.py: for each (predictor,
label) of the reliable contours, the regions rasterized into a frame of
128 / max(w, h) of the dewarped page (`geometry/raster.rasterize`), then
resized to 128 x 128 as PIL's default BICUBIC `resize` does
(utils/thumbnail.resize_bicubic), as `<pred>.<label>.png`; and
`signature.json` with the page size and an 8 x 8 grid count of the
regions' centroids a (predictor, label). Host work only: the page size
comes from the grid, and `--device` is taken as every stage takes it.

    python -m origami_tpu_torch.batch.utils.signature CORPUS [--device cpu]
"""

from __future__ import annotations

import json

import numpy as np

from origami_tpu_torch import geometry as G
from origami_tpu_torch.batch.core.io import Artifact, Input, Output, Stage
from origami_tpu_torch.batch.core.processor import PageProcessor, run_cli
from origami_tpu_torch.batch.utils.thumbnail import resize_bicubic
from origami_tpu_torch.core import _png

SIGNATURE_SIZE = 128
GRID_CELLS = 8


class SignatureProcessor(PageProcessor):
    @property
    def processor_name(self):
        return "origami_tpu.batch.utils.signature"

    def artifacts(self):
        return [
            ("input", Input(Artifact.CONTOURS, stage=Stage.RELIABLE)),
            ("output", Output(Artifact.SIGNATURE)),
        ]

    def process(self, page_path, input, output):
        w, h = input.page.size(True)
        frame = G.raster.RasterFrame(
            (0, 0, w, h), scale=SIGNATURE_SIZE / max(w, h))

        by_pred = {}
        for parts, geom in input.contours:
            if geom.geom_type not in ("Polygon", "MultiPolygon"):
                continue
            by_pred.setdefault(parts[:2], []).append(geom)

        with output.signature() as zf:
            counts = {}
            for (pred, label), geoms in by_pred.items():
                mask = frame.zeros()
                for g in geoms:
                    G.raster.rasterize(g, frame, mask)
                im = resize_bicubic(mask * 255,
                                    (SIGNATURE_SIZE, SIGNATURE_SIZE))
                zf.writestr("%s.%s.png" % (pred, label),
                            _png.encode_gray(im))
                # grid count signature: region centroid histogram
                gridc = np.zeros((GRID_CELLS, GRID_CELLS), int)
                for g in geoms:
                    c = g.centroid
                    gx = min(int(c.x / max(w, 1) * GRID_CELLS),
                             GRID_CELLS - 1)
                    gy = min(int(c.y / max(h, 1) * GRID_CELLS),
                             GRID_CELLS - 1)
                    gridc[gy, gx] += 1
                counts["%s/%s" % (pred, label)] = gridc.flatten().tolist()
            zf.writestr("signature.json", json.dumps(dict(
                version=1, size=[w, h], grid=GRID_CELLS, counts=counts)))


def main(argv=None):
    return run_cli(SignatureProcessor, argv,
                   "python -m origami_tpu_torch.batch.utils.signature",
                   "Write layout signatures for pages in DATA_PATH.")


if __name__ == "__main__":
    main()
