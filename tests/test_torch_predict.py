"""core/predict.py against origami_tpu/core/predict.py on the CPU: the
trained predictor on tiny freshly initialised model directories, the
heuristic predictor, and the numpy Otsu that stands in for cv2's.

Tolerances:

  * trained label maps: >= 99.9 % of pixels equal with both sides in
    float32 (the JAX predictor's U-Nets rebuilt with dtype float32): an
    argmax flips only where two classes tie to within the float32
    summation-order noise of the convolutions;
  * heuristic label maps: >= 99.9 % (the port's Sauvola box sums are
    exact, JAX's come from float32 integral images; everything after
    the mask is max and min over windows, which is exact);
  * line pitch, structuring elements and the Otsu threshold: equal.
"""

from pathlib import Path

import cv2
import numpy as np
import PIL.Image
import pytest
import torch

import jax.numpy as jnp

from origami_tpu.core import predict as jax_predict
from origami_tpu.models import registry as jax_registry
from origami_tpu.models.unet import create_unet as jax_create_unet
from origami_tpu_torch.core import predict
from origami_tpu_torch.ops import morphology

ROOT = Path(__file__).resolve().parent.parent
PAGE_FILES = [ROOT / "tests/data/torch_ocr/full/synth0000.png",
              ROOT / "tests/data/torch_ocr/full/synth0001.png",
              ROOT / "tests/data/real_scan_1872.png",
              ROOT / "tests/data/real_scan_bbz_1925.png"]


def text_page(seed, h, w, pitch=18):
    """Paper with text-like rows in two columns and two separators."""
    rng = np.random.default_rng(seed)
    img = rng.integers(215, 250, (h, w)).astype(np.uint8)
    mid = w // 2
    for x0, x1 in ((12, mid - 12), (mid + 12, w - 12)):
        for y in range(20, h - 20, pitch):
            mask = rng.random(x1 - x0) < 0.8
            img[y: y + pitch - 7, x0: x1][:, mask] = rng.integers(10, 80)
    img[15: h - 15, mid - 1: mid + 1] = 20
    img[h // 2: h // 2 + 2, mid + 12: w - 12] = 20
    return img


def as_gray(path):
    return np.asarray(PIL.Image.open(path).convert("L"))


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("models")
    for group, kind, s2d, seeds in (("region", "region", 4, (0, 1)),
                                    ("separator", "separator", 2, (2,))):
        meta = jax_registry.default_segmentation_meta(
            kind, full_size=(128, 192), width=0.125, s2d=s2d)
        for i, seed in enumerate(seeds):
            jax_registry.init_and_save(root / group / str(i), meta,
                                       seed=seed)
    return root


def jax_f32_predictor(models, target):
    pred = jax_predict.SegmentationPredictor(models, target=target)
    graphs = []
    for g in pred._graphs:
        m = g.meta
        model = jax_create_unet(len(m["classes"]), width=m["width"],
                                dtype=jnp.float32, s2d=m["s2d"])
        graphs.append(jax_predict._EnsembleGraph(model, g._params, m))
    pred._graphs = graphs
    return pred


@pytest.mark.parametrize("target", ["quality", "speed"])
def test_trained_predictor_matches_jax(model_dir, target):
    pages = [text_page(0, 300, 210), text_page(1, 260, 170)]
    ref = jax_f32_predictor(model_dir, target).predict_batch(pages)
    got = predict.SegmentationPredictor(
        model_dir, target=target, device="cpu",
        dtype=torch.float32).predict_batch(pages)
    assert len(got) == len(ref) == 2
    for a, b in zip(got, ref):
        for pa, pb in zip(a.predictions, b.predictions):
            assert (pa.name, pa.type.name) == (pb.name, pb.type.name)
            assert pa.classes.as_dict() == pb.classes.as_dict()
            assert pa.labels.shape == pb.labels.shape
            assert pa.labels.dtype == np.uint8
            assert (pa.labels == pb.labels).mean() >= 0.999


def test_trained_predictor_tiled_canvas_matches_jax(tmp_path):
    """A canvas cut into overlapping tiles (192 rows in 128-row tiles):
    the graph stitches the members' probabilities from the tiles' inner
    regions before the argmax."""
    for group, s2d in (("region", 2), ("separator", 1)):
        meta = jax_registry.default_segmentation_meta(
            group, full_size=(128, 192), tile_size=(128, 128), width=0.125,
            s2d=s2d)
        jax_registry.init_and_save(tmp_path / group / "0", meta, seed=s2d)
    pages = [text_page(6, 280, 190)]
    ref = jax_f32_predictor(tmp_path, "quality").predict_batch(pages)[0]
    pred = predict.SegmentationPredictor(tmp_path, device="cpu",
                                         dtype=torch.float32)
    assert len(pred._graphs[0]._layout) == 2
    got = pred.predict_batch(pages)[0]
    for pa, pb in zip(got.predictions, ref.predictions):
        assert pa.labels.shape == pb.labels.shape
        assert (pa.labels == pb.labels).mean() >= 0.999


def test_trained_predictor_single_page_call(model_dir):
    page = text_page(2, 200, 150)
    pred = predict.SegmentationPredictor(model_dir, device="cpu",
                                         dtype=torch.float32)
    seg = pred(page)
    # 200x150 pads to 256x192; the 192x128 canvas is cropped back
    assert seg.by_name("regions").labels.shape == (
        int(round(192 * 200 / 256)), int(round(128 * 150 / 192)))
    with pytest.raises(FileNotFoundError):
        predict.SegmentationPredictor(model_dir / "region", device="cpu")


def test_pad_batch_matches_jax():
    pages = [text_page(0, 130, 70), text_page(1, 64, 128)]
    ref, ref_sizes = jax_predict._pad_batch(pages)
    got, sizes = predict._pad_batch(pages)
    assert sizes == ref_sizes and got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("seed,hw", [(3, (600, 400)), (4, (450, 330))])
def test_heuristic_predictor_matches_jax(seed, hw):
    page = text_page(seed, *hw)
    ref = jax_predict.HeuristicSegmentationPredictor()(page)
    got = predict.HeuristicSegmentationPredictor(device="cpu")(page)
    for pa, pb in zip(got.predictions, ref.predictions):
        assert (pa.name, pa.type.name) == (pb.name, pb.type.name)
        assert pa.classes.as_dict() == pb.classes.as_dict()
        assert (pa.labels == pb.labels).mean() >= 0.999
    # the page is not trivial: text, and both separator directions
    assert got.by_name("regions").class_mask("TEXT").mean() > 0.2
    assert got.by_name("separators").class_mask("V").any()
    assert got.by_name("separators").class_mask("H").any()


def test_heuristic_predictor_fixed_elements_even_sizes():
    """Given (even) structuring elements pad as XLA's SAME does."""
    page = text_page(5, 200, 180)
    ref = jax_predict.HeuristicSegmentationPredictor(
        sep_len=20, text_gap=10)(page)
    got = predict.HeuristicSegmentationPredictor(
        sep_len=20, text_gap=10, device="cpu").predict_batch([page])[0]
    for pa, pb in zip(got.predictions, ref.predictions):
        assert (pa.labels == pb.labels).mean() >= 0.999


@pytest.mark.parametrize("kh,kw", [(1, 21), (21, 1), (9, 9), (4, 6)])
def test_dilate_erode_are_min_max_filters(kh, kw):
    from scipy import ndimage
    x = (np.random.default_rng(kh).random((40, 50)) < 0.3) \
        .astype(np.float32)
    origin = (-(1 - kh % 2) if kh > 1 else 0, -(1 - kw % 2) if kw > 1 else 0)
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(
        morphology.dilate(t, kh, kw).numpy(),
        ndimage.maximum_filter(x, size=(kh, kw), mode="constant",
                               cval=-np.inf, origin=origin))
    np.testing.assert_array_equal(
        morphology.erode(t, kh, kw).numpy(),
        ndimage.minimum_filter(x, size=(kh, kw), mode="constant",
                               cval=np.inf, origin=origin))


@pytest.mark.parametrize("path", PAGE_FILES, ids=lambda p: p.stem)
def test_otsu_and_pitch_equal_cv2_on_files(path):
    gray = as_gray(path)
    t, _ = cv2.threshold(gray, 0, 1, cv2.THRESH_BINARY_INV + cv2.THRESH_OTSU)
    assert predict.otsu_threshold_u8(gray) == int(t)
    assert predict.HeuristicSegmentationPredictor.estimate_line_pitch(gray) \
        == jax_predict.HeuristicSegmentationPredictor.estimate_line_pitch(
            gray)


@pytest.mark.parametrize("seed", range(6))
def test_otsu_and_pitch_equal_cv2_on_synthetic(seed):
    rng = np.random.default_rng(seed)
    gray = text_page(seed, 240 + 40 * seed, 200, pitch=12 + 3 * seed)
    if seed % 2:
        gray = (gray * rng.uniform(0.4, 0.9)).astype(np.uint8)
    if seed == 5:
        gray = np.full((50, 40), 200, np.uint8)       # flat, short page
    t, _ = cv2.threshold(gray, 0, 1, cv2.THRESH_BINARY_INV + cv2.THRESH_OTSU)
    assert predict.otsu_threshold_u8(gray) == int(t)
    assert predict.HeuristicSegmentationPredictor.estimate_line_pitch(gray) \
        == jax_predict.HeuristicSegmentationPredictor.estimate_line_pitch(
            gray)
