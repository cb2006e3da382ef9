"""cv2's uint8 helpers that train/synth.py's strips need, ported to
numpy (origami_tpu_torch/train/segment/data.py), against cv2 on seeded
shapes, scales and sigmas, every pixel equal: INTER_LINEAR resizes
(enlarging, as render_line and page_line_pool do, and shrinking),
GaussianBlur with sigma 0.3-0.9 (render_line's softness), and INTER_AREA
on render_line's down-up cycle (shrink by 0.6-0.9, enlarge back).
"""

import cv2
import numpy as np
import pytest

from origami_tpu_torch.train.segment import data

CASES = 40


def _image(rng):
    h = int(rng.integers(2, 70))
    w = int(rng.integers(2, 260))
    img = rng.integers(0, 256, (h, w)).astype(np.uint8)
    if rng.random() < 0.5:          # smooth content, as text strips are
        img = cv2.GaussianBlur(img, (0, 0), 2)
    return img


@pytest.mark.parametrize("seed", range(4))
def test_resize_linear_equals_cv2(seed):
    rng = np.random.default_rng(seed)
    for _ in range(CASES):
        img = _image(rng)
        if rng.random() < 0.7:      # the strips' aspect-kept enlargement
            s = float(rng.uniform(1.0, 4.5))
            size = (max(1, int(img.shape[1] * s)),
                    max(1, int(img.shape[0] * s)))
        else:
            size = (int(rng.integers(1, 400)), int(rng.integers(1, 90)))
        want = cv2.resize(img, size, interpolation=cv2.INTER_LINEAR)
        np.testing.assert_array_equal(data.resize_linear_u8(img, size), want,
                                      err_msg=str((img.shape, size)))


@pytest.mark.parametrize("seed", range(4))
def test_gaussian_blur_equals_cv2(seed):
    rng = np.random.default_rng(100 + seed)
    for _ in range(CASES):
        img = _image(rng)
        sigma = float(rng.uniform(0.3, 0.9))
        want = cv2.GaussianBlur(img, (0, 0), sigmaX=sigma)
        np.testing.assert_array_equal(data.gaussian_blur_u8(img, sigma),
                                      want, err_msg=str((img.shape, sigma)))


def test_gaussian_blur_on_one_row_and_column():
    rng = np.random.default_rng(7)
    for shape in ((1, 40), (30, 1), (1, 1), (2, 3)):
        img = rng.integers(0, 256, shape).astype(np.uint8)
        for sigma in (0.3, 0.55, 0.9):
            np.testing.assert_array_equal(
                data.gaussian_blur_u8(img, sigma),
                cv2.GaussianBlur(img, (0, 0), sigmaX=sigma))


@pytest.mark.parametrize("seed", range(2))
def test_down_up_cycle_equals_cv2(seed):
    """render_line's softness: INTER_AREA to f of the size, then
    INTER_LINEAR back, on 48-row strips."""
    rng = np.random.default_rng(200 + seed)
    for _ in range(CASES):
        w = int(rng.integers(8, 600))
        img = _image(rng)
        img = cv2.resize(img, (w, 48), interpolation=cv2.INTER_LINEAR)
        f = float(rng.uniform(0.6, 0.9))
        small_size = (max(8, int(w * f)), max(8, int(48 * f)))
        small = cv2.resize(img, small_size, interpolation=cv2.INTER_AREA)
        np.testing.assert_array_equal(
            data.resize_area_u8(img, small_size), small)
        np.testing.assert_array_equal(
            data.resize_linear_u8(small, (w, 48)),
            cv2.resize(small, (w, 48), interpolation=cv2.INTER_LINEAR))
