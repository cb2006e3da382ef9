"""The port's training entry points on the CPU at a tiny size
(origami_tpu_torch/train/segment/main.py, train/bootstrap.py):

  * `main gen` cuts a labelled corpus into tiles (with warped variants)
    and `main train` trains on them and writes a model directory that
    the port's and the JAX package's registry.load_model both load;
  * bootstrap.train_segmentation (a 2-member k-fold ensemble, warp on),
    distill_students and train_recognizer_pool write directories the
    port loads and serves, with finite losses (a recognizer the port
    saves loads in the JAX package: tests/test_torch_train_saved.py).
"""

import json

import numpy as np
import PIL.Image
import pytest
import torch

from origami_tpu.models import registry as jax_registry
from origami_tpu_torch.models import registry
from origami_tpu_torch.ops.tiling import TileLayout
from origami_tpu_torch.train import bootstrap
from origami_tpu_torch.train.segment import main as seg_main
from torch_train_helpers import REC, UNET, corpus_arrays
from torch_train_helpers import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

CHARSET = "abcdefgh"


@pytest.fixture
def corpus(tmp_path):
    """Four 128 x 64 pages with region and separator label PNGs."""
    root = tmp_path / "gt"
    root.mkdir()
    imgs, labs = corpus_arrays(4, hw=(128, 64), seed=9)
    for i, (img, lab) in enumerate(zip(imgs, labs)):
        PIL.Image.fromarray(img).save(root / ("p%d.png" % i))
        for kind in ("region", "separator"):
            PIL.Image.fromarray(lab).save(
                root / ("p%d.labels.%s.png" % (i, kind)))
    return root


def test_gen_then_train_writes_a_model_both_packages_load(corpus, tmp_path,
                                                         capsys):
    tiles, out = tmp_path / "tiles", tmp_path / "model"
    seg_main.main(["gen", str(corpus), "-o", str(tiles), "--kind", "region",
                   "--full-width", "64", "--full-height", "128",
                   "--tile-width", "64", "--tile-height", "64",
                   "--augmentations", "2", "--device", "cpu"])
    n = 4 * 2 * len(TileLayout((64, 128), (64, 64), 50))
    assert "wrote %d tiles" % n in capsys.readouterr().out
    seg_main.main(["train", str(tiles), "-o", str(out), "--kind", "region",
                   "--steps", "3", "--batch-size", "2", "--width", "0.25",
                   "--s2d", "2", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "step 0 loss" in printed and "saved model" in printed
    model, meta = registry.load_model(out, "cpu", conv_dtype=torch.float32)
    assert meta["classes"] == ["TEXT", "TABULAR", "ILLUSTRATION",
                               "BACKGROUND"]
    assert meta["tile_size"] == [64, 64] and meta["s2d"] == 2
    _, jparams, jmeta = jax_registry.load_model(out)
    assert jmeta == meta
    np.testing.assert_array_equal(
        np.asarray(jparams["Conv_3"]["kernel"]),
        registry.flax_params(model)["Conv_3"]["kernel"])


def test_main_needs_cuda_unless_told_cpu(corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        seg_main.main(["gen", str(corpus), "-o", str(tmp_path / "t"),
                       "--augmentations", "2"])


def test_ensemble_then_students(corpus, tmp_path):
    steps = []
    losses = bootstrap.train_segmentation(
        corpus, tmp_path / "ens", "separator", members=2, steps=3,
        full_size=(64, 128), batch=2, warp_amplitude=8.0, device="cpu",
        dtype=torch.float32,
        on_step=lambda *a: steps.append(a[:3] + (float(a[3]),)), **UNET)
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert [s[:3] for s in steps] == [("separator", m, k) for m in (0, 1)
                                      for k in range(3)]
    members = sorted((tmp_path / "ens" / "separator").iterdir())
    assert [m.name for m in members] == ["00", "01"]
    student = bootstrap.distill_students(
        tmp_path / "ens", corpus, tmp_path / "stu", steps=2, batch=2,
        kinds=("separator",), device="cpu", dtype=torch.float32)
    assert np.isfinite(student["separator"])
    model, meta = registry.load_model(tmp_path / "stu" / "separator" / "00",
                                      "cpu", conv_dtype=torch.float32)
    assert meta == bootstrap.meta_for("separator", bootstrap.SEP_CLASSES,
                                      (64, 128), 0.25, 2)
    with torch.no_grad():
        out = model(torch.rand(1, 128, 64, 1))
    assert out.shape == (1, 128, 64, 4) and torch.isfinite(out).all()


def test_recognizer_pool_training(tmp_path):
    rng = np.random.default_rng(0)
    pool = []
    for i in range(12):
        w = int(rng.integers(40, 300))
        text = "".join(rng.choice(list(CHARSET), size=int(rng.integers(1, 6))))
        pool.append(((rng.random((REC["height"], w)) * 255)
                     .astype(np.uint8), text))
    buckets, counts = bootstrap.pool_buckets(pool, CHARSET, REC["height"])
    assert sorted(counts) == sorted(buckets) and sum(counts.values()) == 12
    for b, (x, wds, labels, pad) in buckets.items():
        assert x.shape[1:] == (REC["height"], b) and (wds <= b).all()
        # room for the longest text of the bucket and one more
        assert ((labels.shape[1] - pad.sum(1)) < labels.shape[1]).all()
    loss = bootstrap.train_recognizer_pool(
        pool, tmp_path / "rec", CHARSET, steps=3, batch=4, device="cpu",
        dtype=torch.float32, **REC)
    assert np.isfinite(loss)
    meta = json.loads((tmp_path / "rec" / "meta.json").read_text())
    assert meta["arch"] == registry.RECOGNIZER_ARCH
    assert meta["charset"] == CHARSET
    registry.load_model(tmp_path / "rec", "cpu")
