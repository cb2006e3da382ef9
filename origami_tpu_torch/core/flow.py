"""Flow sampling: (point, angle) evidence of page warp.

Port of origami_tpu/core/flow.py (host numpy):

  * `Samples` — the flow.zip sample container (docs/formats.md#flowzip:
    (n, 3) float64 [x, y, phi] npy + {"version", "size"} json);
  * `border_angle_samples` — V-field samples from the page content's
    side borders (the flow stage's --estimate-border-skew);
  * `separator_angle_samples` — angle samples along separator polylines
    (reference flow.py:245-268), from vector geometry.

`patch_skew_samples` (device local-skew estimation) has no caller on any
stage's path and is not ported yet (ROADMAP.md, queue A).
"""

from __future__ import annotations

import io as _io
import json
import math

import numpy as np

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
