"""Scattered-data interpolation with bounded extrapolation.

Port of origami_tpu/core/lingrid.py: scipy's LinearNDInterpolator inside
the convex hull of the points, its NearestNDInterpolator outside, with
the points deduplicated to 1e-6 first (qhull refuses duplicates). Host
numpy and scipy, as in the JAX package, whose line tools and
harmonizations use it.
"""

from __future__ import annotations

import numpy as np
import scipy.interpolate


class Interpolator:
    def __init__(self, points, values, bounds):
        points = np.asarray(points, dtype=np.float64).reshape(-1, 2)
        values = np.asarray(values, dtype=np.float64)
        if values.ndim == 1:
            values = values[:, None]
            self._squeeze = True
        else:
            self._squeeze = False
        self._bounds = bounds

        # dedupe points (qhull chokes on duplicates)
        _, idx = np.unique(np.round(points, 6), axis=0, return_index=True)
        points = points[idx]
        values = values[idx]
        self._points = points
        self._values = values

        if len(points) >= 4:
            try:
                self._lin = scipy.interpolate.LinearNDInterpolator(
                    points, values)
            except Exception:
                self._lin = None
        else:
            self._lin = None
        if len(points) >= 1:
            self._near = scipy.interpolate.NearestNDInterpolator(
                points, values)
        else:
            self._near = None

    def __call__(self, pts):
        pts = np.asarray(pts, dtype=np.float64).reshape(-1, 2)
        if self._near is None:
            out = np.zeros((len(pts), self._values.shape[1]))
        elif self._lin is None:
            out = self._near(pts)
        else:
            out = self._lin(pts)
            bad = np.any(np.isnan(out), axis=-1)
            if bad.any():
                out[bad] = self._near(pts[bad])
        return out[:, 0] if self._squeeze else out


def lininterp(points, values, bounds):
    return Interpolator(points, values, bounds)


def lingrid(points, values, width, height):
    """Evaluate the interpolation on a full (height, width) grid."""
    interp = Interpolator(points, values, (0, 0, width, height))
    xs, ys = np.meshgrid(np.arange(width), np.arange(height))
    flat = interp(np.stack([xs.flatten(), ys.flatten()], axis=-1))
    if flat.ndim == 1:
        return flat.reshape(height, width)
    return flat.reshape(height, width, -1)
