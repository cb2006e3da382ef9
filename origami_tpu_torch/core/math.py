"""Page geometry helpers (port of origami_tpu/core/math.py: `Geometry`,
which core.page needs, `Orientation`, which core.segment and the
separator polylines need, and the (2, 3) affine helpers
`rotation_matrix` and `to_affine_coeffs`, float64 numpy as in JAX, which
the deskewing code needs), and `fma_f32`, the exact float32 fused
multiply-add of the affine warps' source coordinates."""

from __future__ import annotations

import enum
import math

import numpy as np


class Orientation(enum.Enum):
    H = 0
    V = 1

    @property
    def direction(self):
        return np.array([1.0, 0.0]) if self == Orientation.H \
            else np.array([0.0, 1.0])


class Geometry:
    """Page geometry: converts relative lengths/areas (fractions of the
    page diagonal / its square) to absolute pixel quantities."""

    def __init__(self, width, height):
        self._w = float(width)
        self._h = float(height)
        self._diameter = math.hypot(self._w, self._h)

    @property
    def size(self):
        return self._w, self._h

    @property
    def area(self):
        return self._w * self._h

    @property
    def diameter(self):
        return self._diameter

    def rel_length(self, length):
        return length * self._diameter

    def rel_area(self, area):
        # (a * diameter)^2, as the reference (origami/core/math.py:90-91)
        return (area * self._diameter) ** 2


def to_affine_coeffs(m):
    """(2, 3) matrix -> shapely-style [a, b, d, e, xoff, yoff]."""
    return [m[0, 0], m[0, 1], m[1, 0], m[1, 1], m[0, 2], m[1, 2]]


def rotation_matrix(angle, center=(0.0, 0.0)):
    """(2, 3) rotation by `angle` radians about `center`."""
    c, s = math.cos(angle), math.sin(angle)
    cx, cy = center
    return np.array([
        [c, -s, cx - c * cx + s * cy],
        [s, c, cy - s * cx - c * cy]])


def fma_f32(a, b, c):
    """a * b + c of float32 arrays rounded once to float32 (a fused
    multiply-add; XLA's CPU backend and cv2's warpAffine both fuse their
    affine coordinates). The product is exact in float64; the float64
    sum is rounded to float32 with it, except where that sum lies on a
    float32 midpoint (its low 29 significand bits 1 << 28) and is
    inexact: there it is first moved one step toward the exact sum
    (TwoSum's error)."""
    p = np.asarray(a, np.float32).astype(np.float64) \
        * np.asarray(b, np.float32).astype(np.float64)
    c = np.asarray(c, np.float32).astype(np.float64)
    s = p + c
    tie = (s.view(np.int64) & 0x1FFFFFFF) == 0x10000000
    if tie.any():
        p, c = np.broadcast_arrays(p, c)
        pt, ct, st = p[tie], c[tie], s[tie]
        bb = st - pt
        err = (pt - (st - bb)) + (ct - bb)
        s[tie] = np.where(err != 0, np.nextafter(
            st, np.where(err > 0, np.inf, -np.inf)), st)
    return s.astype(np.float32)
