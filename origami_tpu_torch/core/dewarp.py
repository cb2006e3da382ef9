"""Dewarping grid: artifact I/O, coordinate transforms, page dewarp.

Port of the host-facing part of origami_tpu/core/dewarp.py. A `Grid`
holds the dewarped->warped sample lattice `hv` ((gh, gw, 2) float32, one
node every `res` px) of dewarp.zip (data.npy + meta.json {"version",
"cell", "shape"}). The grid's construction (the flow stage's device
build) is not ported; this side reads grids the JAX stages wrote.

`Dewarper.dewarped_dev` launches the dewarp kernel (ops.remap.dewarp_u8)
in place of both JAX routes (dewarp.py:504-531): one direct bilinear
sample per output pixel through the index-aligned upsampled grid, so
neither the banded two-pass plan nor its DMA windows are needed.
"""

from __future__ import annotations

import io as _io
import json
import zipfile
from functools import cached_property

import numpy as np
import torch


class Grid:
    def __init__(self, hv, res):
        self._hv = np.asarray(hv, dtype=np.float32)
        self._res = int(res)

    @property
    def resolution(self):
        return self._res

    def points(self, resolution="sample"):
        """The dewarped->warped map at its sample lattice. (The JAX
        Grid also offers "full", the per-pixel upsampled map; the port's
        consumers upsample inside the kernels instead.)"""
        if resolution == "sample":
            return self._hv
        raise ValueError(resolution)

    def inverse_points(self, dewarped_pts):
        """Map dewarped (x, y) points to warped coordinates (bilinear in
        the sample grid, clamped to its extent)."""
        pts = np.asarray(dewarped_pts, dtype=np.float64).reshape(-1, 2)
        gx = pts[:, 0] / self._res
        gy = pts[:, 1] / self._res
        h, w = self._hv.shape[:2]
        gx = np.clip(gx, 0, w - 1 - 1e-6)
        gy = np.clip(gy, 0, h - 1 - 1e-6)
        x0 = np.floor(gx).astype(int)
        y0 = np.floor(gy).astype(int)
        tx = (gx - x0)[:, None]
        ty = (gy - y0)[:, None]
        g = self._hv
        return (g[y0, x0] * (1 - tx) * (1 - ty)
                + g[y0, x0 + 1] * tx * (1 - ty)
                + g[y0 + 1, x0] * (1 - tx) * ty
                + g[y0 + 1, x0 + 1] * tx * ty)

    # -- artifact IO (docs/formats.md#dewarpzip) ---------------------------
    @staticmethod
    def open(path):
        with zipfile.ZipFile(path, "r") as zf:
            info = json.loads(zf.read("meta.json").decode("utf8"))
            grid = np.load(_io.BytesIO(zf.read("data.npy")),
                           allow_pickle=False)
        return Grid(grid.reshape(info["shape"]), info["cell"])

    def save(self, file_or_path, compression=zipfile.ZIP_DEFLATED):
        buf = _io.BytesIO()
        np.save(buf, self._hv.astype(np.float32), allow_pickle=False)
        info = dict(version=1, cell=self._res, shape=list(self._hv.shape))
        target = file_or_path if hasattr(file_or_path, "write") \
            else str(file_or_path)
        with zipfile.ZipFile(target, "w", compression) as zf:
            zf.writestr("data.npy", buf.getvalue())
            zf.writestr("meta.json", json.dumps(info))


class Dewarper:
    """Applies a grid to a device-resident u8 page."""

    def __init__(self, image, grid):
        if not isinstance(image, torch.Tensor) or image.dtype != torch.uint8:
            raise TypeError("Dewarper wants a uint8 torch.Tensor page")
        self._image = image
        self._grid = grid

    @cached_property
    def dewarped_dev(self):
        """The dewarped page, u8 (gh*res, gw*res), on the page's device."""
        from origami_tpu_torch.ops.remap import dewarp_u8
        hv = torch.from_numpy(self._grid.points("sample")).to(
            self._image.device)
        return dewarp_u8(self._image, hv, self._grid.resolution, 255.0)
