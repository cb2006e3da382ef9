"""Dewarping grid: construction on the device, artifact I/O, coordinate
transforms, page dewarp.

Port of origami_tpu/core/dewarp.py. A `Grid` holds the dewarped->warped
sample lattice `hv` ((gh, gw, 2) float32, one node every `res` px) of
dewarp.zip (data.npy + meta.json {"version", "cell", "shape"}).

`build_grid` is the port of `build_grid_device` (dewarp.py:72-145): the
angle fields are masked inverse-distance weights over the padded sample
set, evaluated elementwise (a matmul or cdist form would run in TF32 on
the card); the H pass integrates H streamlines column by column, the V
pass marches V rays across the H rows and takes, for each ray, the
nearest intersection with the next row through the gather kernel
(ops.gather.take_along_axis, csrc/gather.cu) where the JAX graph runs
jnp.take_along_axis. The scans are Python loops of small PyTorch ops on
the page's device (about 25 launches per step); the grid comes back to
the host once. `GridFactory` chooses the JAX package's static shapes
(samples padded to 1024, grid sides rounded up to multiples of 8 cells
with a 2-cell pad), so both packages build the same grid.

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


# ---------------------------------------------------------------------------
# device field + grid construction
# ---------------------------------------------------------------------------

def _field_eval(points, sample_xy, sample_phi, sample_mask, phi0):
    """Masked IDW interpolation of angles at `points` (N, 2) -> unit
    direction vectors (N, 2); phi0 where no sample has weight."""
    diff = points[:, None, :] - sample_xy[None, :, :]
    d2 = (diff * diff).sum(dim=-1)
    w = sample_mask[None, :] / (d2 + 25.0)          # soften at ~5px scale
    wsum = w.sum(dim=1)
    # interpolate angles via their unit vectors to avoid wrap issues
    cx = (w * torch.cos(sample_phi)[None, :]).sum(dim=1)
    sx = (w * torch.sin(sample_phi)[None, :]).sum(dim=1)
    have = wsum > 1e-12
    phi0 = torch.tensor(phi0, dtype=torch.float32, device=points.device)
    cx = torch.where(have, cx, torch.cos(phi0))
    sx = torch.where(have, sx, torch.sin(phi0))
    n = torch.sqrt(cx * cx + sx * sx) + 1e-12
    return torch.stack([cx / n, sx / n], dim=-1)


def _intersect_row(p0, d, row, max_len, res_f):
    """Intersect the rays p0 + t * d * max_len with the polyline `row`
    (the next H row); the border segments are extended far outwards, so
    a ray nearly always hits. Picks the hit nearest to p0, else a plain
    field step (dewarp.py:102-136)."""
    from origami_tpu_torch.ops.gather import take_along_axis
    a = row[:-1].clone()                            # (S, 2) segment starts
    b = row[1:].clone()                             # (S, 2) segment ends
    big = 1e5
    dir0 = a[0] - b[0]
    dirn = b[-1] - a[-1]
    n0 = dir0 / (torch.sqrt((dir0 * dir0).sum()) + 1e-12)
    nn = dirn / (torch.sqrt((dirn * dirn).sum()) + 1e-12)
    a[0] = a[0] + n0 * big
    b[-1] = b[-1] + nn * big

    r = d * max_len                                 # (n, 2)
    s = b - a                                       # (S, 2)
    qp = a[None, :, :] - p0[:, None, :]             # (n, S, 2)
    denom = r[:, None, 0] * s[None, :, 1] - r[:, None, 1] * s[None, :, 0]
    denom = torch.where(denom.abs() < 1e-9,
                        torch.full_like(denom, 1e-9), denom)
    t = (qp[..., 0] * s[None, :, 1] - qp[..., 1] * s[None, :, 0]) / denom
    u = (qp[..., 0] * r[:, None, 1] - qp[..., 1] * r[:, None, 0]) / denom
    valid = (u >= -1e-6) & (u <= 1 + 1e-6) & (t > 1e-6)
    t_sel = torch.where(valid, t, torch.full_like(t, math.inf))
    best = torch.argmin(t_sel, dim=1)               # (n,)
    t_best = take_along_axis(
        t_sel, best[:, None].to(torch.int32), axis=1)[:, 0]
    ok = torch.isfinite(t_best)
    p_hit = p0 + r * t_best[:, None]
    p_fallback = p0 + d * res_f
    return torch.where(ok[:, None], p_hit, p_fallback)


def build_grid(h_xy, h_phi, h_mask, v_xy, v_phi, v_mask, n_gy, n_gx, res,
               pad_cells=2):
    """The dewarp sample grid (n_gy, n_gx, 2) float32 on the samples'
    device. h_*: padded H-field samples (points (S, 2), angles (S,),
    mask (S,)), v_*: the same for the V field, all float32 tensors."""
    dev = h_xy.device
    res_f = torch.tensor(float(res), dtype=torch.float32, device=dev)
    origin = -pad_cells * res_f

    # --- horizontal pass: integrate H streamlines column by column ----
    ys = origin + torch.arange(n_gy, dtype=torch.float32, device=dev) * res_f
    pts = torch.stack([origin.expand(n_gy), ys], dim=-1)
    cols = []
    for _ in range(n_gx):
        cols.append(pts)
        d = _field_eval(pts, h_xy, h_phi, h_mask, 0.0)
        pts = pts + d * res_f
    grid_h = torch.stack(cols, dim=1)               # (n_gy, n_gx, 2)

    # --- vertical pass: march V rays, snapping to each H row ----------
    # per-row max step length (worst-case 60 degree shear)
    row_dy = (grid_h[1:, :, 1] - grid_h[:-1, :, 1]).max()
    sixty = torch.tensor(60.0, dtype=torch.float32, device=dev)
    max_len = row_dy / torch.cos(torch.deg2rad(sixty)) + res_f
    p = grid_h[0]
    rows = []
    for k in range(1, n_gy):
        rows.append(p)
        d = _field_eval(p, v_xy, v_phi, v_mask, math.pi / 2)
        p = _intersect_row(p, d, grid_h[k], max_len, res_f)
    rows.append(p)
    return torch.stack(rows, dim=0)


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
    runs `build_grid` on `device` (None: the card, raising without one)."""

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

        grid = build_grid(*upload(self._samples_h), *upload(self._samples_v),
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
        """The dewarped page, u8 (gh*res, gw*res), on the page's device."""
        from origami_tpu_torch.ops.remap import dewarp_u8
        hv = torch.from_numpy(self._grid.points("sample")).to(
            self._image.device)
        return dewarp_u8(self._image, hv, self._grid.resolution, 255.0)
