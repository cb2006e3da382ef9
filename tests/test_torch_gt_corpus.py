"""The port's GT corpus modules against the JAX ones: annotations
(origami_tpu_torch/train/segment/annotations.py), the binarized corpus
(binarize.py) and the skew (skew.py).

Tolerances: label maps equal; gen_binarized's 1-bit pages open in PIL as
mode "1" and equal JAX's (the CPU runs the plain Sauvola, whose exact
integer sums may differ from JAX's float32 integral images on a few
pixels of a page, ROADMAP C10: here at most 1e-4 of them); ransac_angle
equal (the same default_rng draws); deskew_pair's labels equal and its
image within 1 gray level, equal on at least 99.9 % of the pixels.
"""

import math
import numpy as np
import PIL.Image
import pytest

from origami_tpu_torch.core import _png
from origami_tpu_torch.train.segment import skew as K
from origami_tpu_torch.train.segment.annotations import (
    load_page_annotations)
from origami_tpu_torch.train.segment.binarize import gen_binarized


def _palette_png(path, lab):
    im = PIL.Image.fromarray(lab, "P")
    im.putpalette([0, 0, 0, 255, 0, 0, 0, 255, 0, 255, 255, 255] * 64)
    im.save(path)


def test_page_annotations(tmp_path, rng):
    from origami_tpu.train.segment.annotations import (
        load_page_annotations as jax_load)
    img = (rng.random((50, 40)) * 255).astype(np.uint8)
    lab = np.full((50, 40), 3, np.uint8)
    lab[10:30, 5:35] = 0
    PIL.Image.fromarray(img).save(tmp_path / "p.png")
    PIL.Image.fromarray(lab).save(tmp_path / "p.labels.region.png")
    _palette_png(tmp_path / "p.labels.separator.png", lab[::-1].copy())
    ann = load_page_annotations(tmp_path / "p.png")
    assert ann.kinds == ["region", "separator"]
    assert (ann.labels("region") == 0).sum() == 20 * 30
    want = jax_load(tmp_path / "p.png")
    np.testing.assert_array_equal(ann.image, want.image)
    for kind in want.kinds:
        np.testing.assert_array_equal(ann.labels(kind), want.labels(kind))
    with pytest.raises(FileNotFoundError):
        PIL.Image.fromarray(img).save(tmp_path / "q.png")
        load_page_annotations(tmp_path / "q.png")


def test_ransac_skew():
    # many segments at 0.03 rad, a few outliers
    segs = []
    for i in range(20):
        x0, y0 = i * 10, 50 + i
        segs.append((x0, y0, x0 + 100, y0 + 100 * math.tan(0.03)))
    segs.append((0, 0, 0.5, 100))   # vertical outlier
    a = K.ransac_angle(segs)
    assert abs(a - 0.03) < 0.005


@pytest.mark.parametrize("seed", range(3))
def test_ransac_angle_equal_jax(seed):
    from origami_tpu.train.segment.skew import ransac_angle
    rng = np.random.default_rng(seed)
    segs = rng.normal(0, 1, (40, 4)) * [200, 200, 200, 200]
    segs[:25, 3] = segs[:25, 1] + (segs[:25, 2] - segs[:25, 0]) * 0.02
    assert K.ransac_angle(segs, seed=seed) == ransac_angle(segs, seed=seed)


def _page(seed, h=300, w=400):
    """A seeded gray page: paper with a gradient, text-like ink rows,
    a rule."""
    rng = np.random.default_rng(seed)
    px = 200 + 40 * np.linspace(0, 1, w)[None, :] \
        + rng.normal(0, 6, (h, w))
    for y in range(20, h - 20, 18):
        x0 = int(rng.integers(10, 60))
        ink = rng.random(w - x0 - 20) < 0.6
        px[y:y + 9, x0:w - 20][:, ink] = rng.integers(10, 90)
    px[h // 2:h // 2 + 3, 10:w - 10] = 30
    return np.clip(px, 0, 255).astype(np.uint8)


def test_gen_binarized_equal_jax(tmp_path):
    from origami_tpu.train.segment.binarize import (
        gen_binarized as jax_gen)
    for name, seed in (("a", 0), ("b", 1)):
        for corpus in ("jax", "port"):
            (tmp_path / corpus / "c").mkdir(parents=True, exist_ok=True)
            PIL.Image.fromarray(_page(seed)).save(
                tmp_path / corpus / "c" / (name + ".png"))
        _palette_png(tmp_path / "port" / "c" / (name + ".labels.region.png"),
                     np.zeros((300, 400), np.uint8))
    assert jax_gen(tmp_path / "jax" / "c") == 2
    assert gen_binarized(tmp_path / "port" / "c", device="cpu") == 2
    # existing outputs and label files are skipped
    assert gen_binarized(tmp_path / "port" / "c", device="cpu") == 0
    for name in ("a", "b"):
        got = PIL.Image.open(tmp_path / "port" / "bin" / (name + ".png"))
        want = PIL.Image.open(tmp_path / "jax" / "bin" / (name + ".png"))
        assert got.mode == "1" and want.mode == "1"
        g, w = np.asarray(got), np.asarray(want)
        assert g.shape == w.shape
        assert (g != w).sum() <= 1e-4 * g.size
        np.testing.assert_array_equal(
            _png.read(tmp_path / "port" / "bin" / (name + ".png")),
            g.astype(np.uint8) * 255)


def test_binarize_cli_help(capsys):
    from origami_tpu_torch.train.segment import binarize
    with pytest.raises(SystemExit) as e:
        binarize.main(["--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "--window-size" in out and "--device" in out


@pytest.mark.parametrize("angle", [0.02, -0.015])
def test_deskew_pair_equal_jax(angle):
    from origami_tpu.train.segment.skew import deskew_pair
    img = _page(3, 260, 370)
    lab = np.full(img.shape, 3, np.uint8)
    lab[40:200, 30:300] = 0
    lab[120:130, 20:350] = 1
    want_img, want_lab = deskew_pair(img, lab, angle)
    got_img, got_lab = K.deskew_pair(img, lab, angle, device="cpu")
    np.testing.assert_array_equal(got_lab, want_lab)
    d = np.abs(got_img.astype(int) - want_img.astype(int))
    assert d.max() <= 1 and (d == 0).mean() >= 0.999


def test_entry_points_need_a_card_or_cpu(tmp_path, monkeypatch):
    import torch
    from origami_tpu_torch.batch.core.deskew import Deskewer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = np.zeros((8, 8), np.uint8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        K.deskew_pair(img, img, 0.01)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gen_binarized(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Deskewer([]).image(img)
