"""The dewarp grid build's two scans.

`grid_scan` wraps the hand-written CUDA kernels of csrc/grid.cu, which
replace the two `lax.scan`s of `build_grid_device`
(origami_tpu/core/dewarp.py:72-145) and, inside the V scan, the
`jnp.take_along_axis` of its nearest-intersection choice (:131, the
gather of the Pallas probe scripts/pallas_gather_repro.py:73):

    grid_scan_h  one block per H streamline, all n_gx steps in the block
    grid_scan_v  one block per V ray, all n_gy - 1 steps in the block

`build_grid_plain` is the plain PyTorch version: the scans as Python
loops of small PyTorch ops, the IDW field evaluated elementwise (a matmul
or cdist form would run in TF32 on the card). The wrapper given CPU
tensors computes the plain version (the CPU tests run it); given CUDA
tensors it launches the two kernels on the current stream or raises,
never falling back. `launches[name]` counts kernel launches.
"""

from __future__ import annotations

import math

import torch

from origami_tpu_torch.ops import gather
from origami_tpu_torch.ops.remap import (LaunchCounts, _check, _device_of,
                                         _launch, _ptr, kernels)

launches = LaunchCounts(grid_scan_h=0, grid_scan_v=0)

# the most dynamic shared memory a block may use on sm_90
_SHARED_BYTES = 232448


# ---------------------------------------------------------------------------
# plain version
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


def _nearest_hit(t_sel):
    """jnp.argmin over each row of t_sel (lowest index on a tie, a NaN
    before every number) and the gather of t at it -> (best, t_best)."""
    best = torch.argmin(t_sel, dim=1)
    t_best = gather.take_along_axis_plain(
        t_sel, best[:, None].to(torch.int32), axis=1)[:, 0]
    return best, t_best


def _intersect_row(p0, d, row, max_len, res_f):
    """Intersect the rays p0 + t * d * max_len with the polyline `row`
    (the next H row); the border segments are extended far outwards, so
    a ray nearly always hits. Picks the hit nearest to p0, else a plain
    field step (dewarp.py:102-136) -> (points, chosen segments)."""
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
    best, t_best = _nearest_hit(t_sel)
    ok = torch.isfinite(t_best)
    p_hit = p0 + r * t_best[:, None]
    p_fallback = p0 + d * res_f
    return torch.where(ok[:, None], p_hit, p_fallback), best


def scan_h_plain(h_xy, h_phi, h_mask, n_gy, n_gx, res, pad_cells=2):
    """The H scan: n_gy streamlines integrated column by column ->
    grid_h (n_gy, n_gx, 2)."""
    dev = h_xy.device
    res_f = torch.tensor(float(res), dtype=torch.float32, device=dev)
    origin = -pad_cells * res_f
    ys = origin + torch.arange(n_gy, dtype=torch.float32, device=dev) * res_f
    pts = torch.stack([origin.expand(n_gy), ys], dim=-1)
    cols = []
    for _ in range(n_gx):
        cols.append(pts)
        d = _field_eval(pts, h_xy, h_phi, h_mask, 0.0)
        pts = pts + d * res_f
    return torch.stack(cols, dim=1)


def scan_v_plain(grid_h, v_xy, v_phi, v_mask, res, best=None):
    """The V scan: rays from grid_h's first row, snapped to each H row
    -> the grid (n_gy, n_gx, 2); `best` (optional int32 (n_gy - 1,
    n_gx)) receives the segment each step chose."""
    dev = grid_h.device
    res_f = torch.tensor(float(res), dtype=torch.float32, device=dev)
    # per-row max step length (worst-case 60 degree shear)
    row_dy = (grid_h[1:, :, 1] - grid_h[:-1, :, 1]).max()
    sixty = torch.tensor(60.0, dtype=torch.float32, device=dev)
    max_len = row_dy / torch.cos(torch.deg2rad(sixty)) + res_f
    p = grid_h[0]
    rows = []
    for k in range(1, grid_h.shape[0]):
        rows.append(p)
        d = _field_eval(p, v_xy, v_phi, v_mask, math.pi / 2)
        p, chosen = _intersect_row(p, d, grid_h[k], max_len, res_f)
        if best is not None:
            best[k - 1] = chosen.to(torch.int32)
    rows.append(p)
    return torch.stack(rows, dim=0)


def build_grid_plain(h_xy, h_phi, h_mask, v_xy, v_phi, v_mask, n_gy, n_gx,
                     res, pad_cells=2, best=None):
    """The dewarp sample grid (n_gy, n_gx, 2) float32 on the samples'
    device: the H scan, then the V scan over its rows."""
    grid_h = scan_h_plain(h_xy, h_phi, h_mask, n_gy, n_gx, res, pad_cells)
    return scan_v_plain(grid_h, v_xy, v_phi, v_mask, res, best)


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

def _check_field(xy, phi, mask, name, dev):
    _check(xy, name + "_xy", torch.float32, 2, dev)
    _check(phi, name + "_phi", torch.float32, 1, dev)
    _check(mask, name + "_mask", torch.float32, 1, dev)
    n = xy.shape[0]
    if xy.shape[1] != 2 or phi.shape[0] != n or mask.shape[0] != n:
        raise ValueError("%s samples must be xy (S, 2), phi (S,), mask (S,);"
                         " got %s, %s, %s" % (name, tuple(xy.shape),
                                              tuple(phi.shape),
                                              tuple(mask.shape)))
    return n


def grid_scan(h_xy, h_phi, h_mask, v_xy, v_phi, v_mask, n_gy, n_gx, res,
              pad_cells=2, best=None):
    """H-field samples (xy (S, 2), phi (S,), mask (S,)) and V-field
    samples, all float32 -> the grid (n_gy, n_gx, 2) float32, nodes
    `res` px apart starting `pad_cells` cells outside the page. `best`:
    optional int32 (n_gy - 1, n_gx) tensor for each V step's segment."""
    dev = _device_of(h_xy)
    n_h = _check_field(h_xy, h_phi, h_mask, "h", dev)
    n_v = _check_field(v_xy, v_phi, v_mask, "v", dev)
    n_gy, n_gx = int(n_gy), int(n_gx)
    if n_gy < 2 or n_gx < 2:
        raise ValueError("the grid needs at least 2 x 2 nodes, got %d x %d"
                         % (n_gy, n_gx))
    if best is not None:
        _check(best, "best", torch.int32, 2, dev)
        if tuple(best.shape) != (n_gy - 1, n_gx):
            raise ValueError("best must be (%d, %d)" % (n_gy - 1, n_gx))
    if dev.type == "cpu":
        return build_grid_plain(h_xy, h_phi, h_mask, v_xy, v_phi, v_mask,
                                n_gy, n_gx, res, pad_cells, best)
    if 4 * (5 * max(n_h, n_v) + n_gx) > _SHARED_BYTES:
        raise ValueError("%d samples and %d columns exceed a block's shared "
                         "memory" % (max(n_h, n_v), n_gx))
    res_f = float(res)
    grid_h = torch.empty((n_gy, n_gx, 2), dtype=torch.float32, device=dev)
    out = torch.empty((n_gy, n_gx, 2), dtype=torch.float32, device=dev)
    _launch(dev, kernels.origami_grid_scan_h, _ptr(h_xy), _ptr(h_phi),
            _ptr(h_mask), n_h, n_gy, n_gx, res_f, -pad_cells * res_f,
            _ptr(grid_h))
    launches.add("grid_scan_h")
    _launch(dev, kernels.origami_grid_scan_v, _ptr(grid_h), _ptr(v_xy),
            _ptr(v_phi), _ptr(v_mask), n_v, n_gy, n_gx, res_f, _ptr(out),
            None if best is None else _ptr(best))
    launches.add("grid_scan_v")
    return out
