"""The raster bridge's strokes (origami_tpu_torch/geometry/raster.py
`_stroke`, the C++ of contour_trace.cpp) against cv2.polylines, which the
JAX package's raster bridge calls.

Tolerance: every pixel equal. Thick strokes repeat OpenCV's ThickLine
(the segment clipped to the mask grown by the thickness, the
quadrilateral in 16-bit fixed point through FillConvexPoly, the round
caps as filled Bresenham circles), thin ones its 8-connected
LineIterator, clipped to the mask as cv2 clips them. The first cases
keep the vertices on the mask, as the raster frames place every vertex
(the thick strokes still run off its edges); the off-raster cases put
them up to 3x the thickness off it, as the ground-truth generator's
extended separators do (train/segment/regions.py `stops`).
"""

import cv2
import numpy as np
import pytest

from origami_tpu_torch.geometry import raster


def _both(h, w, pts, thickness):
    want = np.zeros((h, w), np.uint8)
    cv2.polylines(want, [pts], False, 1, thickness=thickness)
    got = np.zeros((h, w), np.uint8)
    raster._stroke(got, pts, thickness, 1)
    return got, want


@pytest.mark.parametrize("thickness", range(2, 16))
def test_thick_stroke_is_cv2s(thickness):
    rng = np.random.default_rng(thickness)
    off_mask = 0
    for _ in range(40):
        h, w = (int(v) for v in rng.integers(20, 90, 2))
        n = int(rng.integers(2, 7))
        pts = np.c_[rng.integers(0, w, n), rng.integers(0, h, n)] \
            .astype(np.int32)
        got, want = _both(h, w, pts, thickness)
        np.testing.assert_array_equal(got, want, err_msg=str(pts.tolist()))
        big = np.zeros((h + 40, w + 40), np.uint8)
        cv2.polylines(big, [pts + 20], False, 1, thickness=thickness)
        off_mask += int(big.sum() > want.sum())
    assert off_mask >= 10            # strokes that run off the mask


def test_thin_stroke_clipped_like_cv2():
    """Thickness 1 with vertices off the mask: LineIterator clips the
    segment to the mask before it steps (integer clipLine)."""
    rng = np.random.default_rng(3)
    for _ in range(200):
        h, w = (int(v) for v in rng.integers(20, 60, 2))
        n = int(rng.integers(2, 6))
        pts = np.c_[rng.integers(-20, w + 20, n),
                    rng.integers(-20, h + 20, n)].astype(np.int32)
        got, want = _both(h, w, pts, 1)
        np.testing.assert_array_equal(got, want, err_msg=str(pts.tolist()))


@pytest.mark.parametrize("thickness", range(2, 16))
def test_thick_stroke_off_raster_is_cv2s(thickness):
    """29 seeded polylines a thickness (406 in all) whose vertices lie up
    to 3x the thickness off the mask."""
    rng = np.random.default_rng(100 + thickness)
    for _ in range(29):
        h, w = (int(v) for v in rng.integers(20, 90, 2))
        n = int(rng.integers(2, 6))
        m = 3 * thickness
        pts = np.c_[rng.integers(-m, w + m, n),
                    rng.integers(-m, h + m, n)].astype(np.int32)
        got, want = _both(h, w, pts, thickness)
        np.testing.assert_array_equal(got, want, err_msg=str(pts.tolist()))


@pytest.mark.parametrize("pts, thickness", [
    ([(150, -20), (150, 220)], 2), ([(150, -20), (150, 220)], 3),
    ([(-30, 50), (330, 57)], 3), ([(-30, 50), (330, 57)], 4)])
def test_extended_separator_off_raster_is_cv2s(pts, thickness):
    """An extended separator leaving a 200x300 raster: a vertical one and
    a slanted one (the unclipped stroke differed from cv2's on 170 of
    its 1500 pixels at thickness 3)."""
    got, want = _both(200, 300, np.asarray(pts, np.int32), thickness)
    np.testing.assert_array_equal(got, want)
