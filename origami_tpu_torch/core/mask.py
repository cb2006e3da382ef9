"""Polygon masks and cutouts.

Port of origami_tpu/core/mask.py: a geometry's pixels within its
floor/ceil bounds, rasterized by the port's raster bridge
(geometry/raster.py, cv2's fill without cv2), and crops of a page
through them. Only what the contours stage's `--export-images` calls is
ported: no explicit bounds, a white background, and no `cutout`.
"""

from __future__ import annotations

import numpy as np

from origami_tpu_torch import geometry as G

_BACKGROUND = 255


class Mask:
    def __init__(self, geometry):
        self._geom = geometry
        minx, miny, maxx, maxy = geometry.bounds
        self._origin = (int(np.floor(minx)), int(np.floor(miny)))
        self._size = (int(np.ceil(maxx)) - self._origin[0] + 1,
                      int(np.ceil(maxy)) - self._origin[1] + 1)

    @property
    def bounds(self):
        x0, y0 = self._origin
        w, h = self._size
        return (x0, y0, x0 + w, y0 + h)

    @property
    def binary(self):
        """(H, W) bool mask of the geometry within its bounds."""
        w, h = self._size
        frame = G.raster.RasterFrame(self.bounds, scale=1.0, margin=0)
        m = G.raster.rasterize(self._geom, frame)
        return m[:h, :w] > 0

    def extract_image(self, pixels):
        """Cut the masked region out of the page -> (crop, origin).
        Pixels outside the geometry become white."""
        x0, y0 = self._origin
        w, h = self._size
        H, W = pixels.shape[:2]
        x1 = min(x0 + w, W)
        y1 = min(y0 + h, H)
        x0c, y0c = max(x0, 0), max(y0, 0)
        crop = np.array(pixels[y0c:y1, x0c:x1])
        m = self.binary[y0c - y0: y1 - y0, x0c - x0: x1 - x0]
        crop = np.where(m, crop, _BACKGROUND).astype(crop.dtype)
        return crop, (x0c, y0c)
