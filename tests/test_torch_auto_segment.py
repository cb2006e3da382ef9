"""`-m auto:<dir>`: the port's AutoSegmentationPredictor and its host
helpers against the JAX package's (origami_tpu/core/predict.py:295-444)
and against cv2, which the JAX helpers call.

Tolerances, each with its reason:
  * Otsu's threshold and the ink mask: bit-equal to cv2's (the port
    repeats getThreshVal_Otsu_8u in float64);
  * cv2's INTER_NEAREST resize: equal indices (the same float64
    arithmetic); the ink coverage: within 1e-12 of the JAX staticmethod
    (the same integer counts divided once);
  * sanitize_tabular: the same label maps and pixel count;
  * the whole predictor with float32 students (TF32 off, both sides):
    the JAX auto-mode modes and >= 99.9 % of the label-map pixels
    (tests/data/torch_segment/ref, scripts/make_torch_segment_fixture.py;
    an argmax flips only where two classes tie to within float32
    summation order);
  * the heuristic fallback, forced by a trained map without text: the
    heuristic maps themselves, 100 % equal.
"""

import json
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from origami_tpu.core import predict as jax_predict
from origami_tpu.core import segment as jax_segment
from origami_tpu_torch.core import _png, predict
from origami_tpu_torch.core import segment as port_segment

ROOT = Path(__file__).resolve().parent.parent
REF = ROOT / "tests/data/torch_segment/ref"
STUDENTS = ROOT / "models_pretrained/students"
PAGES = {"real_scan_1872": ROOT / "tests/data/real_scan_1872.png",
         "real_scan_bbz_1925": ROOT / "tests/data/real_scan_bbz_1925.png",
         "synth0000": ROOT / "tests/data/torch_ocr/full/synth0000.png",
         "synth0001": ROOT / "tests/data/torch_ocr/full/synth0001.png"}
REGION = {"TEXT": 0, "TABULAR": 1, "ILLUSTRATION": 2, "BACKGROUND": 3}
SEP = {"H": 0, "V": 1, "T": 2, "BACKGROUND": 3}


def _gray(name):
    if name.startswith("noise"):
        rng = np.random.default_rng(int(name[5:]))
        img = rng.normal(180, 50, (333, 517))
        img[100:140] = rng.normal(40, 20, (40, 517))
        return np.clip(img, 0, 255).astype(np.uint8)
    return _png.read_gray(PAGES[name])


@pytest.mark.parametrize("name", list(PAGES) + ["noise1", "noise2"])
def test_otsu_ink_mask_is_cv2s(name):
    gray = _gray(name)
    g = np.ascontiguousarray(gray[::4, ::4])
    t, want = cv2.threshold(g, 0, 1, cv2.THRESH_BINARY_INV
                            + cv2.THRESH_OTSU)
    assert predict.otsu_threshold_u8(g) == int(t)
    got = predict.AutoSegmentationPredictor._ink_mask(gray)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, jax_predict.AutoSegmentationPredictor._ink_mask(gray))


@pytest.mark.parametrize("src,dst", [((77, 53), (480, 328)),
                                     ((480, 328), (77, 53)),
                                     ((128, 96), (384, 257)),
                                     ((601, 413), (601, 413))])
def test_nearest_resize_is_cv2s(src, dst):
    m = np.random.default_rng(src[0]).integers(0, 4, src).astype(np.uint8)
    want = cv2.resize(m, (dst[1], dst[0]), interpolation=cv2.INTER_NEAREST)
    np.testing.assert_array_equal(predict._resize_nearest(m, dst), want)


def _segs(reg, sep):
    """The same label maps as a port and a JAX Segmentation."""
    out = []
    for mod in (port_segment, jax_segment):
        out.append(mod.Segmentation([
            mod.Prediction("REGION", "regions", reg.copy(), REGION),
            mod.Prediction("SEPARATOR", "separators", sep.copy(), SEP)]))
    return out


def _blobs(seed, shape, n, value, fill, rng=None):
    rng = rng or np.random.default_rng(seed)
    lab = np.full(shape, fill, np.uint8)
    h, w = shape
    for _ in range(n):
        y, x = rng.integers(0, h - 10), rng.integers(0, w - 10)
        lab[y: y + rng.integers(5, h // 3), x: x + rng.integers(5, w // 3)] \
            = value
    return lab


@pytest.mark.parametrize("name", list(PAGES))
def test_ink_coverage_matches_jax(name):
    gray = _gray(name)
    h, w = gray.shape
    for seed in range(3):
        reg = _blobs(seed, (h // 3 + seed, w // 3 - seed), 12, 0, 3)
        reg[_blobs(seed + 9, reg.shape, 4, 1, 0) == 1] = 1
        sep = np.full(reg.shape, 3, np.uint8)
        port, jax = _segs(reg, sep)
        got = predict.AutoSegmentationPredictor.ink_coverage(port, gray)
        want = jax_predict.AutoSegmentationPredictor.ink_coverage(jax, gray)
        assert 0.0 < want < 1.0
        assert abs(got - want) <= 1e-12


@pytest.mark.parametrize("seed", range(4))
def test_sanitize_tabular_matches_jax(seed):
    rng = np.random.default_rng(seed)
    shape = (240, 180)
    reg = _blobs(seed, shape, 10, 0, 3, rng)
    reg[_blobs(seed, shape, 8, 1, 0, rng) == 1] = 1
    sep = np.full((360 if seed % 2 else 240, 270 if seed % 2 else 180), 3,
                  np.uint8)
    for _ in range(6):                     # table-column dividers
        x, y = rng.integers(0, sep.shape[1] - 3), rng.integers(0, 200)
        sep[y: y + rng.integers(20, 150), x: x + 2] = 2
    port, jax = _segs(reg, sep)
    kw = dict(min_t_density=0.012, min_area=500)
    n_got = predict.AutoSegmentationPredictor.sanitize_tabular(port, **kw)
    n_want = jax_predict.AutoSegmentationPredictor.sanitize_tabular(jax, **kw)
    assert n_got == n_want
    np.testing.assert_array_equal(port.by_name("regions").labels,
                                  jax.by_name("regions").labels)


class _Blank:
    """A trained predictor whose maps hold no text: the page's ink goes
    uncovered, so the auto predictor must fall back."""

    def predict_batch(self, pages):
        return [port_segment.Segmentation([
            port_segment.Prediction("REGION", "regions",
                                    np.full((60, 40), 3, np.uint8), REGION),
            port_segment.Prediction("SEPARATOR", "separators",
                                    np.full((60, 40), 3, np.uint8), SEP)])
            for _ in pages]


def test_forced_fallback_gives_the_heuristic_maps():
    gray = _gray("synth0001")
    heuristic = predict.HeuristicSegmentationPredictor(device="cpu")
    auto = predict.AutoSegmentationPredictor(trained=_Blank(),
                                             heuristic=heuristic)
    got = auto.predict_batch([gray])[0]
    assert auto.last_modes == ["heuristic"]
    want = jax_segment.Segmentation.open(
        REF / "synth0001.heuristic.segment.zip")
    for name in ("regions", "separators"):
        np.testing.assert_array_equal(got.by_name(name).labels,
                                      want.by_name(name).labels)


@pytest.fixture(scope="module")
def f32_students():
    allow_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield predict.SegmentationPredictor(STUDENTS, device="cpu",
                                        dtype=torch.float32)
    torch.backends.cudnn.allow_tf32 = allow_tf32


@pytest.mark.parametrize("name", list(PAGES))
def test_auto_matches_jax_with_float32_students(name, f32_students):
    modes = json.loads((REF / "auto_modes.json").read_text())
    auto = predict.AutoSegmentationPredictor(trained=f32_students,
                                             device="cpu")
    got = auto.predict_batch([_gray(name)])[0]
    assert auto.last_modes == [modes[name]["f32"]]
    want = jax_segment.Segmentation.open(REF / (name + ".auto.f32.segment.zip"))
    for name_ in ("regions", "separators"):
        a, b = got.by_name(name_).labels, want.by_name(name_).labels
        assert a.shape == b.shape
        assert (a == b).mean() >= 0.999, (name_, (a == b).mean())
