"""Dewarping grid: construction on the device, artifact I/O, coordinate
transforms, page dewarp.

Port of origami_tpu/core/dewarp.py. A `Grid` holds the dewarped->warped
sample lattice `hv` ((gh, gw, 2) float32, one node every `res` px) of
dewarp.zip (data.npy + meta.json {"version", "cell", "shape"}).

`GridFactory` builds the grid of `build_grid_device` (dewarp.py:72-145)
with ops.grid.grid_scan: the H and V scans as two kernels of
csrc/grid.cu on the card (one block per streamline or ray, the V scan's
argmin and gather of t inside), their plain PyTorch version on the CPU;
the grid comes back to the host once. It chooses the JAX package's
static shapes (samples padded to 1024, grid sides rounded up to
multiples of 8 cells with a 2-cell pad), so both packages build the
same grid.

`Dewarper.dewarped_dev` launches the dewarp kernel (ops.remap.dewarp_u8)
in place of both JAX routes (dewarp.py:504-531): one direct bilinear
sample per output pixel through the index-aligned upsampled grid, so
neither the banded two-pass plan nor its DMA windows are needed.
"""

from __future__ import annotations

import io as _io
import json
import math
import zipfile
from functools import cached_property

import numpy as np
import torch

from origami_tpu_torch import device as _device
from origami_tpu_torch.core.math import Geometry
from origami_tpu_torch.ops.grid import grid_scan


# ---------------------------------------------------------------------------
# grid construction
# ---------------------------------------------------------------------------

def _pad_samples(points, values, max_n):
    pts = np.zeros((max_n, 2), dtype=np.float32)
    phi = np.zeros((max_n,), dtype=np.float32)
    mask = np.zeros((max_n,), dtype=np.float32)
    n = min(len(points), max_n)
    if n:
        pts[:n] = np.asarray(points, dtype=np.float32)[:n]
        phi[:n] = np.asarray(values, dtype=np.float32)[:n]
        mask[:n] = 1.0
    return pts, phi, mask


def _round_up(x, m):
    return int(-(-x // m) * m)


class GridFactory:
    """Chooses the static shapes of the JAX build (dewarp.py:432-474) and
    runs the grid scans (ops.grid.grid_scan) on `device` (None: the card,
    raising without one)."""

    def __init__(self, page_size, samples_h, samples_v, grid_res=25,
                 max_grid_size=1000, max_samples=1024, device=None):
        self._size = page_size
        self._res = int(grid_res)
        self._max_grid = max_grid_size
        self._max_samples = max_samples
        self._samples_h = samples_h
        self._samples_v = samples_v
        self._device = _device.resolve(device)

    def shape(self):
        """(n_gy, n_gx): the page in cells plus a 2-cell pad on each side
        and one more cell, rounded up to multiples of 8."""
        w, h = self._size
        pad = 2
        n_gx = _round_up(math.ceil(w / self._res) + 2 * pad + 2, 8)
        n_gy = _round_up(math.ceil(h / self._res) + 2 * pad + 2, 8)
        if max(n_gx, n_gy) > self._max_grid:
            raise RuntimeError("grid too big: (%d, %d)" % (n_gy, n_gx))
        return n_gy, n_gx

    def __call__(self):
        n_gy, n_gx = self.shape()

        def upload(samples):
            return [torch.from_numpy(a).to(self._device)
                    for a in _pad_samples(samples.points, samples.values,
                                          self._max_samples)]

        grid = grid_scan(*upload(self._samples_h), *upload(self._samples_v),
                         n_gy=n_gy, n_gx=n_gx, res=self._res, pad_cells=2)
        return Grid(grid.cpu().numpy(), self._res)


# ---------------------------------------------------------------------------
# host-facing Grid (artifact IO + coordinate transforms)
# ---------------------------------------------------------------------------

class Grid:
    def __init__(self, hv, res):
        self._hv = np.asarray(hv, dtype=np.float32)
        self._res = int(res)

    @staticmethod
    def create(page_size, samples_h, samples_v, grid_res=25, **kwargs):
        return GridFactory(page_size, samples_h, samples_v,
                           grid_res=grid_res, **kwargs)()

    @property
    def geometry(self):
        h, w = self._hv.shape[:2]
        return Geometry(w * self._res, h * self._res)

    @property
    def resolution(self):
        return self._res

    @property
    def warping(self):
        """Warp magnitude: spread of the grid's local distortions."""
        pts = self._hv
        dy = (pts[1:, :, 1] - pts[:-1, :, 1]).flatten()
        dx = (pts[:, 1:, 0] - pts[:, :-1, 0]).flatten()
        return float(max(np.std(dx), np.std(dy)))

    def points(self, resolution="sample"):
        """The dewarped->warped map at its sample lattice. (The JAX
        Grid also offers "full", the per-pixel upsampled map; the port's
        consumers upsample inside the kernels instead.)"""
        if resolution == "sample":
            return self._hv
        raise ValueError(resolution)

    def has_banded_plan(self, src_shape):
        """Whether the JAX Grid.banded_plan(src_shape) (dewarp.py:219-302)
        returns a plan: x increasing along every lattice row, a vertical
        shear of at most 0.25 px a px, and both passes' displacement
        bands at most 768 px wide. The layout stage's separator mask
        takes the JAX stage's route by it."""
        hv = self._hv.astype(np.float64)
        res = self._res
        gh, gw = hv.shape[:2]
        src_w = int(src_shape[1])
        mxr = hv[..., 0]
        if not np.all(np.diff(mxr, axis=1) > 1e-3):
            return False
        if np.abs(np.diff(hv[..., 1], axis=1)).max() / res > 0.25:
            return False
        cw1 = int(np.ceil(src_w / res)) + 2
        x_nodes = np.arange(cw1, dtype=np.float64) * res
        lat_my = np.empty((gh + 1, cw1), np.float32)
        for r in range(gh):
            lat_my[r] = np.interp(x_nodes, mxr[r], hv[r, :, 1])
        lat_my[gh] = lat_my[gh - 1]
        lat_mx = np.empty((gh + 1, gw + 1), np.float32)
        lat_mx[:gh, :gw] = mxr
        lat_mx[:gh, gw] = lat_mx[:gh, gw - 1]
        lat_mx[gh] = lat_mx[gh - 1]

        def narrow(lat, positions):
            rel = lat.astype(np.float64) - positions
            d_lo = int(np.floor(rel.min())) // 4 * 4
            d_hi = int(np.floor(rel.max())) + 1
            return -(-(d_hi - d_lo + 1) // 4) * 4 <= 768

        return (narrow(lat_my, (np.arange(gh + 1.0) * res)[:, None])
                and narrow(lat_mx, (np.arange(gw + 1.0) * res)[None, :]))

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

    def transformer_points(self, warped_pts):
        """Map warped (x, y) points into dewarped space: Newton inversion
        of inverse_points' bilinear map, float64, vectorized
        (dewarp.py:366-403)."""
        pts = np.asarray(warped_pts, dtype=np.float64).reshape(-1, 2)
        if not len(pts):
            return pts
        g = np.asarray(self._hv, dtype=np.float64)
        h, w = g.shape[:2]
        # initial guess: identity (the displacement field is smooth and
        # bounded, so Newton converges from here in a few steps)
        p = pts / self._res
        for _ in range(12):
            x0 = np.clip(np.floor(p[:, 0]).astype(int), 0, w - 2)
            y0 = np.clip(np.floor(p[:, 1]).astype(int), 0, h - 2)
            tx = (p[:, 0] - x0)[:, None]
            ty = (p[:, 1] - y0)[:, None]
            g00 = g[y0, x0]
            g01 = g[y0, x0 + 1]
            g10 = g[y0 + 1, x0]
            g11 = g[y0 + 1, x0 + 1]
            f = (g00 * (1 - tx) * (1 - ty) + g01 * tx * (1 - ty)
                 + g10 * (1 - tx) * ty + g11 * tx * ty) - pts
            if np.max(np.abs(f)) < 1e-3 * self._res:
                break
            dfdx = (g01 - g00) * (1 - ty) + (g11 - g10) * ty
            dfdy = (g10 - g00) * (1 - tx) + (g11 - g01) * tx
            det = dfdx[:, 0] * dfdy[:, 1] - dfdx[:, 1] * dfdy[:, 0]
            det = np.where(np.abs(det) < 1e-12, 1.0, det)
            dx = (f[:, 0] * dfdy[:, 1] - f[:, 1] * dfdy[:, 0]) / det
            dy = (f[:, 1] * dfdx[:, 0] - f[:, 0] * dfdx[:, 1]) / det
            p[:, 0] -= dx
            p[:, 1] -= dy
        return p * self._res

    @property
    def transformer(self):
        """(xs, ys) -> (xs', ys') callable for geometry.transform."""
        def f(x, y):
            out = self.transformer_points(np.c_[x, y])
            return out[:, 0], out[:, 1]
        return f

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
        """The dewarped page, u8 (gh*res, gw*res), on the page's device,
        by the JAX Dewarper's route (core/dewarp.py:504-520): the banded
        route's border (taps off the page read the fill) where the grid
        has a banded plan for the page, else the dense route's hard
        edge."""
        from origami_tpu_torch.ops.remap import dewarp_u8
        hv = torch.from_numpy(self._grid.points("sample")).to(
            self._image.device)
        border = "fill_taps" if self._grid.has_banded_plan(
            tuple(self._image.shape)) else "hard"
        return dewarp_u8(self._image, hv, self._grid.resolution, 255.0,
                         border)
