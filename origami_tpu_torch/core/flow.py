"""Flow sampling: (point, angle) evidence of page warp.

Port of origami_tpu/core/flow.py (host numpy):

  * `Samples` — the flow.zip sample container (docs/formats.md#flowzip:
    (n, 3) float64 [x, y, phi] npy + {"version", "size"} json);
  * `patch_skew_samples` — local text skew on the page's device: the
    ink of the binarized page cut into tiles, each tile's skew the shear
    (of 33 from -0.12 to 0.12 rad) whose row profile has the largest
    variance, all tiles and shears in one batched computation;
  * `border_angle_samples` — V-field samples from the page content's
    side borders (the flow stage's --estimate-border-skew);
  * `separator_angle_samples` — angle samples along separator polylines
    (reference flow.py:245-268), from vector geometry.
"""

from __future__ import annotations

import io as _io
import json
import math

import numpy as np
import torch

from origami_tpu_torch import device as _device
from origami_tpu_torch.core.math import Geometry, Orientation


class Samples:
    def __init__(self, geometry, points=None, values=None):
        self._geometry = geometry
        self._points = list(points) if points is not None else []
        self._values = list(values) if values is not None else []

    def __len__(self):
        return len(self._points)

    @property
    def geometry(self):
        return self._geometry

    @property
    def points(self):
        return self._points

    @property
    def values(self):
        return self._values

    def append(self, point, value):
        self._points.append(tuple(point))
        self._values.append(float(value))

    # -- flow.zip format ---------------------------------------------------
    def save(self, zf, name):
        if self._points:
            arr = np.hstack([
                np.asarray(self._points, dtype=np.float64),
                np.asarray(self._values, dtype=np.float64)[:, None]])
        else:
            arr = np.empty((3, 0))
        buf = _io.BytesIO()
        np.save(buf, arr.astype(np.float64), allow_pickle=False)
        zf.writestr("%s.npy" % name, buf.getvalue())
        zf.writestr("%s.json" % name, json.dumps(dict(
            version=1, size=list(self._geometry.size))))

    @staticmethod
    def from_zip(zf, name):
        info = json.loads(zf.read("%s.json" % name))
        arr = np.load(_io.BytesIO(zf.read("%s.npy" % name)),
                      allow_pickle=False)
        geom = Geometry(*info["size"])
        if arr.size and arr.ndim == 2 and arr.shape[1] == 3:
            return Samples(geom, arr[:, :2], arr[:, 2])
        return Samples(geom)


# ---------------------------------------------------------------------------
# border skew estimation
# ---------------------------------------------------------------------------

def shear_angles(n_angles=33, max_angle=0.12):
    """(angles, tan(angles)) as float32 numpy: `jnp.linspace(-max_angle,
    max_angle, n_angles)` as XLA's CPU backend computes it inside
    flow.py:_patch_skews, and the tangents rounded from float64, which
    equal XLA's float32 tan on these angles.

    XLA evaluates -m (1 - i / d) + i (m / d) for i < d = n_angles - 1,
    then m, and fuses each element into one fma: fma(i, m / d, -m (1 -
    i / d)), except at i = 1, where the product by i folds away and the
    other product fuses: fma(-m, 1 - 1 / d, m / d)."""
    f32, f64 = np.float32, np.float64
    m = f32(max_angle)
    div = n_angles - 1
    it = np.arange(div, dtype=f32)
    inv = f32(1.0 / div)
    one_minus = f32(1) - it * inv
    step = m * inv
    # the float64 sums of a float32 product and a float32 are exact
    angles = (f64(step) * it + (-m) * one_minus).astype(f32)
    if div > 1:
        angles[1] = f32(f64(-m) * f64(one_minus[1]) + f64(step))
    angles = np.concatenate([angles, [m]])
    return angles, np.tan(angles.astype(f64)).astype(f32)


def _patch_skews(ink, patch=256, n_angles=33, max_angle=0.12):
    """flow.py:_patch_skews on a float32 ink tensor (1 = ink): for each
    (patch x patch) tile, the shear angle whose sheared row profile
    (row y + tan(a) (x - patch / 2), rounded half to even and clipped)
    has the largest variance. -> ((gy, gx) text angles, (gy, gx) ink
    mass), float32 tensors on the ink's device. The profiles are
    integer counts, so their scatter-add is exact in any order; the
    variances are taken in float64."""
    h, w = ink.shape
    gy, gx = h // patch, w // patch
    dev = ink.device
    tiles = ink[: gy * patch, : gx * patch] \
        .reshape(gy, patch, gx, patch).permute(0, 2, 1, 3) \
        .reshape(gy * gx, patch * patch)
    angles, tans = shear_angles(n_angles, max_angle)
    xs = torch.arange(patch, dtype=torch.float32, device=dev) - patch / 2.0
    ys = torch.arange(patch, dtype=torch.float32, device=dev)
    shift = torch.from_numpy(tans).to(dev)[:, None] * xs[None, :]
    yy = ys[None, :, None] + shift[:, None, :]            # (A, y, x)
    rows = torch.round(yy).clamp_(0, patch - 1).long() \
        .reshape(1, n_angles, patch * patch)
    prof = torch.zeros((gy * gx, n_angles, patch), dtype=torch.float32,
                       device=dev)
    prof.scatter_add_(2, rows.expand(gy * gx, -1, -1),
                      tiles[:, None, :].expand(-1, n_angles, -1))
    scores = prof.double().var(dim=2, unbiased=False)
    best = scores.argmax(dim=1)
    mass = tiles.sum(dim=1)
    text = -torch.from_numpy(angles).to(dev)[best]
    return text.reshape(gy, gx), mass.reshape(gy, gx)


def patch_skew_samples(binarized, patch=256, min_ink_frac=0.02,
                       max_angle=0.12, device=None):
    """H-field samples from local text skew over the binarized page
    (True = paper; flow.py:138-157). `binarized` is a numpy mask or a
    bool tensor, whose device it runs on; a numpy mask goes to `device`
    (None: the card, raising without one). -> [((x, y), angle)]."""
    if isinstance(binarized, torch.Tensor):
        ink = (~binarized).float()
    else:
        ink = torch.from_numpy(~np.asarray(binarized, bool)).float() \
            .to(_device.resolve(device))
    angles, mass = _patch_skews(ink, patch=patch, max_angle=max_angle)
    angles = angles.cpu().numpy()
    mass = mass.cpu().numpy()
    out = []
    thresh = min_ink_frac * patch * patch
    for iy in range(angles.shape[0]):
        for ix in range(angles.shape[1]):
            if mass[iy, ix] >= thresh:
                cx = (ix + 0.5) * patch
                cy = (iy + 0.5) * patch
                out.append(((cx, cy), float(angles[iy, ix])))
    return out


def border_angle_samples(binarized, n_samples=12, smooth=51,
                         min_content_rows=0.3):
    """V-field samples from the page content's left/right borders
    (reference BorderEstimator, origami/batch/detect/flow.py:157-235):
    the ink envelope's side profiles bend with the page warp; their
    local tangents constrain the vertical field near the margins."""
    ink = ~np.asarray(binarized, dtype=bool)
    h, w = ink.shape
    rows_with_ink = ink.any(axis=1)
    if rows_with_ink.sum() < h * min_content_rows:
        return []
    first = np.where(ink.any(axis=1), np.argmax(ink, axis=1), -1)
    last = np.where(ink.any(axis=1),
                    w - 1 - np.argmax(ink[:, ::-1], axis=1), -1)
    out = []
    for profile in (first, last):
        ys = np.nonzero(profile >= 0)[0]
        if len(ys) < smooth * 2:
            continue
        xs = profile[ys].astype(np.float64)
        # robust smoothing: running median then boxcar
        k = smooth
        med = np.array([np.median(xs[max(0, i - k): i + k])
                        for i in range(len(xs))])
        # reject rows far from the envelope (indents, dropcaps)
        good = np.abs(xs - med) < np.maximum(10.0, 0.02 * w)
        ys_g = ys[good]
        med_g = med[good]
        if len(ys_g) < n_samples * 4:
            continue
        idx = np.linspace(k, len(ys_g) - 1 - k, n_samples).astype(int)
        for i in idx:
            lo = max(0, i - k)
            hi = min(len(ys_g) - 1, i + k)
            dy = float(ys_g[hi] - ys_g[lo])
            dx = float(med_g[hi] - med_g[lo])
            if dy <= 0:
                continue
            phi = math.atan2(dy, dx)
            if phi < 0:
                phi += math.pi
            out.append(((float(med_g[i]), float(ys_g[i])), phi))
    return out


# ---------------------------------------------------------------------------
# separator angle samples (host)
# ---------------------------------------------------------------------------

def separator_angle_samples(separators, n_samples_per_sep=8):
    """Sample local tangents along separator polylines; returns
    {"h": [((x, y), phi)], "v": [...]} keyed by separator orientation.

    V separators constrain the V field; H and T separators the H field
    (reference flow.py:245-268 `_angles`).
    """
    out = {"h": [], "v": []}
    for parts, geom in separators.by_path.items():
        label = separators.label("/".join(parts[:2]))
        vertical = label.orientation == Orientation.V
        for line in _as_lines(geom):
            c = line.np_coords
            if len(c) < 2:
                continue
            seg = np.diff(c, axis=0)
            lens = np.linalg.norm(seg, axis=1)
            total = lens.sum()
            if total <= 1e-6:
                continue
            n = max(2, min(n_samples_per_sep, len(seg)))
            # sample midpoints of n arc-length-equal pieces
            cum = np.concatenate([[0.0], np.cumsum(lens)])
            targets = (np.arange(n) + 0.5) * total / n
            idx = np.clip(np.searchsorted(cum, targets) - 1, 0, len(seg) - 1)
            for i in idx:
                mid = (c[i] + c[i + 1]) / 2
                dx, dy = seg[i]
                if vertical:
                    phi = math.atan2(dy, dx)
                    if phi < 0:
                        phi += math.pi   # normalize to [0, pi)
                    out["v"].append((tuple(mid), phi))
                else:
                    phi = math.atan2(dy, dx)
                    if phi > math.pi / 2:
                        phi -= math.pi
                    elif phi < -math.pi / 2:
                        phi += math.pi
                    out["h"].append((tuple(mid), phi))
    return out


def _as_lines(geom):
    t = geom.geom_type
    if t in ("LineString", "LinearRing"):
        return [geom]
    if t == "MultiLineString":
        return list(geom.geoms)
    if t == "Polygon":
        return [geom.exterior]
    if t in ("MultiPolygon", "GeometryCollection"):
        out = []
        for g in geom.geoms:
            out.extend(_as_lines(g))
        return out
    return []
