"""The port's training data (origami_tpu_torch/train/segment/{data,
labels}.py, train/bootstrap.load_corpus_arrays, train/checkpoint.py)
against the JAX modules and cv2 5:

  * resize_area_u8 / resize_nearest_u8 equal cv2.resize's INTER_AREA /
    INTER_NEAREST byte for byte: the fixture pages' enlargement to the
    net canvas (1312x1920, 1400x2143, 1024x1459 -> 1280x2432, where
    INTER_AREA is cv2's bilinear path with area weights), integer and
    fractional shrinking, mixed axes;
  * class_weights, k_folds, LabelSet equal;
  * TileDataset.generate (no augmentation) writes the tiles, weights,
    codes and folds the JAX one writes; load_tile_batch equal;
  * load_corpus_arrays equal, label PNGs paletted or gray;
  * checkpoints: latest step, max_to_keep, a model and AdamW restored.
"""

import json

import cv2
import numpy as np
import PIL.Image
import pytest
import torch

from origami_tpu.train import bootstrap as jax_boot
from origami_tpu.train.segment import data as jax_data
from origami_tpu.train.segment import labels as jax_labels
from origami_tpu_torch.train import bootstrap as port_boot
from origami_tpu_torch.train import checkpoint
from origami_tpu_torch.train.segment import data as port_data
from origami_tpu_torch.train.segment import labels as port_labels

SHAPES = [((1920, 1312), (1280, 2432)), ((2143, 1400), (1280, 2432)),
          ((1459, 1024), (1280, 2432)), ((300, 200), (192, 288)),
          ((100, 80), (40, 50)), ((100, 80), (40, 33)), ((64, 64), (32, 32)),
          ((90, 60), (20, 30)), ((97, 61), (40, 23)), ((50, 40), (50, 80)),
          ((31, 17), (90, 45)), ((40, 100), (200, 35))]


def _image(hw, seed):
    rng = np.random.default_rng(seed)
    img = (rng.random(hw) * 255).astype(np.uint8)
    img[::7] = rng.integers(0, 256, size=img[::7].shape)
    return img


@pytest.mark.parametrize("src,dst", SHAPES)
def test_resizes_equal_cv2(src, dst):
    img = _image(src, sum(src) + sum(dst))
    np.testing.assert_array_equal(
        port_data.resize_area_u8(img, dst),
        cv2.resize(img, dst, interpolation=cv2.INTER_AREA))
    np.testing.assert_array_equal(
        port_data.resize_nearest_u8(img, dst),
        cv2.resize(img, dst, interpolation=cv2.INTER_NEAREST))


def test_class_weights_k_folds_and_label_set_equal_jax():
    rng = np.random.default_rng(0)
    maps = [rng.integers(0, 3, (20, 30)) for _ in range(3)]
    maps[1][:5] = 3
    for n in (4, 5):
        np.testing.assert_array_equal(port_data.class_weights(maps, n),
                                      jax_data.class_weights(maps, n))
    np.testing.assert_array_equal(port_data.class_weights([], 4),
                                  jax_data.class_weights([], 4))
    names = ["p%02d" % i for i in range(11)]
    for k, seed in ((5, 0), (3, 7), (2, 1)):
        assert port_data.k_folds(names, k, seed) \
            == jax_data.k_folds(names, k, seed)
    a = port_labels.LabelSet(port_labels.DEFAULT_BBZ_SPEC)
    b = jax_labels.LabelSet(jax_labels.DEFAULT_BBZ_SPEC)
    for kind in ("region", "separator"):
        assert a.classes_dict(kind) == b.classes_dict(kind)
        assert [(l.name, l.weight, l.orientation) for l in a.labels(kind)] \
            == [(l.name, l.weight, l.orientation) for l in b.labels(kind)]
        assert a.background(kind).index == b.background(kind).index


@pytest.fixture
def gt_corpus(tmp_path):
    """Three pages with region label maps, two paletted and one gray."""
    root = tmp_path / "gt"
    root.mkdir()
    rng = np.random.default_rng(4)
    for i in range(3):
        img = _image((300, 200), i)
        lab = np.full((300, 200), 3, np.uint8)
        lab[40:140, 20:180] = 0
        lab[160 + i * 10:260, 20:180] = 1 + i % 2
        PIL.Image.fromarray(img).save(root / ("p%d.png" % i))
        im = PIL.Image.fromarray(lab)
        if i < 2:
            im = im.convert("P")
            im.putpalette(list(rng.integers(0, 256, 768).astype(np.uint8)))
        im.save(root / ("p%d.labels.region.png" % i))
    return root


def test_tile_generation_equals_jax(gt_corpus, tmp_path):
    kw = dict(full_size=(192, 288), tile_size=(192, 160), beta0=16,
              augmentations=1)
    a = port_data.TileDataset(gt_corpus, port_labels.LabelSet(
        port_labels.DEFAULT_BBZ_SPEC), "region", device="cpu", **kw)
    b = jax_data.TileDataset(gt_corpus, jax_labels.LabelSet(
        jax_labels.DEFAULT_BBZ_SPEC), "region", **kw)
    names = a.generate(tmp_path / "port")
    assert names == b.generate(tmp_path / "jax")
    for f in ("weights.json", "codes.json", "folds.json"):
        assert json.loads((tmp_path / "port" / f).read_text()) \
            == json.loads((tmp_path / "jax" / f).read_text())
    for n in names:
        for suffix in (".png", ".labels.png"):
            np.testing.assert_array_equal(
                np.asarray(PIL.Image.open(tmp_path / "port" / (n + suffix))),
                np.asarray(PIL.Image.open(tmp_path / "jax" / (n + suffix))))
    got = port_data.load_tile_batch(tmp_path / "port", names[:4], (160, 192))
    want = jax_data.load_tile_batch(tmp_path / "jax", names[:4], (160, 192))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_augmented_tiles_are_warped_pages(gt_corpus, tmp_path):
    ds = port_data.TileDataset(
        gt_corpus, port_labels.LabelSet(port_labels.DEFAULT_BBZ_SPEC),
        "region", full_size=(192, 288), tile_size=(192, 160), beta0=16,
        augmentations=2, warp_amplitude=6.0, device="cpu")
    names = ds.generate(tmp_path / "t")
    assert len(names) == 3 * 2 * len(ds.layout)
    warped = [n for n in names if ".warp1." in n]
    plain = np.asarray(PIL.Image.open(tmp_path / "t" / (
        warped[0].replace(".warp1", "") + ".labels.png")))
    lab = np.asarray(PIL.Image.open(tmp_path / "t" / (
        warped[0] + ".labels.png")))
    assert set(np.unique(lab)) <= {0, 1, 2, 3}
    assert (lab != plain).any()


def test_load_corpus_arrays_equals_jax(gt_corpus):
    got = port_boot.load_corpus_arrays(gt_corpus, "region", (160, 256))
    want = jax_boot.load_corpus_arrays(gt_corpus, "region", (160, 256))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
    with pytest.raises(FileNotFoundError):
        port_boot.load_corpus_arrays(gt_corpus, "separator", (160, 256))


def test_checkpoints_keep_the_newest_and_restore(tmp_path):
    model = torch.nn.Linear(3, 2)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-2)
    model(torch.ones(1, 3)).sum().backward()
    opt.step()
    d = tmp_path / "ck"
    assert checkpoint.latest_step(d) is None
    assert checkpoint.restore_state(d) is None
    for step in (1, 5, 7, 9):
        checkpoint.save_state(d, step, model.state_dict(), opt.state_dict(),
                              max_to_keep=3)
    assert checkpoint.latest_step(d) == 9
    assert sorted(p.name for p in d.iterdir()) == ["5", "7", "9"]
    step, params, opt_state = checkpoint.restore_state(d)
    assert step == 9
    other = torch.nn.Linear(3, 2)
    other.load_state_dict(params)
    torch.testing.assert_close(other.weight, model.weight)
    opt2 = torch.optim.AdamW(other.parameters(), lr=1e-2)
    opt2.load_state_dict(opt_state)
    assert opt2.state_dict()["state"][0]["step"] == 1
