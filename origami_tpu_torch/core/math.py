"""Page geometry helpers (port of origami_tpu/core/math.py: `Geometry`,
which core.page needs, and `Orientation`, which core.segment and the
separator polylines need)."""

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
