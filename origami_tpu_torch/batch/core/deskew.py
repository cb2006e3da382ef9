"""Page deskewing from detected line angles.

Port of origami_tpu/batch/core/deskew.py: the length-weighted median of
the line angles, the rotation applied to pixels (ops.remap.affine_warp,
one remap_affine launch on the card) and to geometries
(geometry.affinity).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from origami_tpu_torch import device as _device
from origami_tpu_torch import geometry as G
from origami_tpu_torch.core.math import rotation_matrix, to_affine_coeffs


def weighted_median(values, weights):
    order = np.argsort(values)
    v = np.asarray(values, dtype=np.float64)[order]
    w = np.asarray(weights, dtype=np.float64)[order]
    cum = np.cumsum(w)
    if cum[-1] <= 0:
        return float(np.median(v))
    idx = int(np.searchsorted(cum, cum[-1] / 2.0))
    return float(v[min(idx, len(v) - 1)])


class Deskewer:
    def __init__(self, lines, max_angle=math.radians(15)):
        angles = []
        weights = []
        for line in (lines.values() if isinstance(lines, dict)
                     else lines):
            a = line.angle
            if abs(a) <= max_angle:
                angles.append(a)
                weights.append(max(line.length, 1.0))
        self._angle = weighted_median(angles, weights) if angles else 0.0

    @property
    def angle(self):
        return self._angle

    def matrix(self, size):
        """(2, 3) inverse-map rotation about the page center."""
        w, h = size
        return rotation_matrix(self._angle, center=(w / 2.0, h / 2.0))

    def image(self, pixels, background=255.0, device=None):
        """The page rotated into the deskewed frame on `device` (None:
        the card) -> u8 numpy."""
        from origami_tpu_torch.ops.remap import affine_warp
        dev = _device.resolve(device)
        h, w = np.asarray(pixels).shape[:2]
        m = self.matrix((w, h))
        px = torch.from_numpy(np.ascontiguousarray(pixels, np.float32))
        out = affine_warp(px.to(dev), m, (h, w), fill=background)
        return np.clip(out.cpu().numpy(), 0, 255).astype(np.uint8)

    def geometry(self, geom, size):
        """Rotate a geometry into the deskewed frame (the forward map,
        i.e. the inverse of the image sampling matrix)."""
        w, h = size
        forward = rotation_matrix(-self._angle, center=(w / 2.0, h / 2.0))
        return G.affinity.affine_transform(
            geom, to_affine_coeffs(forward))
