"""The port's segmentation evaluation (origami_tpu_torch/train/bootstrap
.py `eval_segmentation`, `eval_separator_tolerant`) against the JAX
functions: tiny U-Nets (init_unet at the smallest width, features 8)
saved once with registry.save_model, loaded by both packages' predictors,
scoring two seeded 256 x 384 pages.

Tolerance: in float32 on the CPU (the JAX predictor's graphs rebuilt as
float32 U-Nets, the port's with dtype=float32) the separator report is
equal and every IoU within 1e-4: XLA's and PyTorch's float32
convolutions sum in other orders, and a random net's near-tied logits
then take another class on a few pixels (about 2e-5 of an IoU). Given the
same label rasters (a stand-in predictor), both reports are equal.
"""

import numpy as np
import PIL.Image
import pytest
import torch

from origami_tpu_torch.models import registry
from origami_tpu_torch.models.unet import create_unet, init_unet
from origami_tpu_torch.train import bootstrap

UNET = dict(width=0.03125, s2d=2)
CANVAS = (192, 128)           # the nets' full_size (W, H)


def make_corpus(root):
    """models/{region,separator}/00 and a validation corpus of two pages
    with paletted label PNGs under `root`."""
    for seed, kind in enumerate(("region", "separator")):
        model = create_unet(4, dtype=torch.float32, **UNET)
        init_unet(model, torch.Generator().manual_seed(seed))
        meta = bootstrap.meta_for(kind, bootstrap.KIND_CLASSES[kind],
                                  CANVAS, UNET["width"], UNET["s2d"])
        registry.save_model(root / "models" / kind / "00", meta, model)
    val = root / "val"
    val.mkdir()
    rng = np.random.default_rng(5)
    for i in range(2):
        page = np.full((256, 384), 230, np.uint8)
        for y in range(20, 236, 16):
            page[y:y + 8, 30:350][:, rng.random(320) < 0.6] = 40
        page[120:123, 10:370] = 20
        page[10:246, 190:192] = 20
        PIL.Image.fromarray(page).save(val / ("p%d.png" % i))
        for kind in ("region", "separator"):
            lab = np.full((256, 384), 3, np.uint8)
            if kind == "region":
                lab[15:240, 25:355] = 0
                lab[180:240, 200:355] = 1
            else:
                lab[119:124, 10:370] = 0
                lab[10:246, 189:193] = 1
                lab[60:62, 200:300] = 2
            im = PIL.Image.fromarray(lab, "P")
            im.putpalette([0, 0, 0, 255, 0, 0, 0, 255, 0, 255, 255, 255]
                          * 64)
            im.save(val / ("p%d.labels.%s.png" % (i, kind)))
    return root


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(tmp_path_factory.mktemp("gt_eval"))


@pytest.fixture
def jax_float32(monkeypatch):
    """The JAX SegmentationPredictor with float32 U-Nets. Its ensembles
    load their saved trees with flax's msgpack_restore: the template
    that registry.load_model builds first (flax's init, op by op) takes
    about 20 s of compiles here and checks nothing this test needs (the
    port's directories load in registry.load_model in
    tests/test_torch_train_saved.py)."""
    import jax
    import jax.numpy as jnp
    from flax import serialization
    from origami_tpu.core import predict
    from origami_tpu.models import registry as jax_registry
    from origami_tpu.models.unet import create_unet as jax_create_unet

    def load_ensemble(paths):
        metas = [jax_registry.load_meta(p) for p in paths]
        trees = [serialization.msgpack_restore(
            (p / "params.msgpack").read_bytes()) for p in paths]
        return (jax_registry._build(metas[0]),
                jax.tree.map(lambda *xs: jnp.stack(xs), *trees), metas[0])
    monkeypatch.setattr(jax_registry, "load_ensemble", load_ensemble)
    real = predict.SegmentationPredictor

    def f32(path, target="quality", mesh=None):
        pred = real(path, target=target)
        graphs = []
        for g in pred._graphs:
            meta = g.meta
            model = jax_create_unet(
                len(meta["classes"]), width=meta.get("width", 1.0),
                dtype=jnp.float32, s2d=meta.get("s2d", 1),
                features=meta.get("features"),
                bottleneck=meta.get("bottleneck"))
            graphs.append(predict._EnsembleGraph(model, g._params, meta))
        pred._graphs = graphs
        return pred
    monkeypatch.setattr(predict, "SegmentationPredictor", f32)


def test_eval_segmentation_equal_jax(corpus, jax_float32):
    from origami_tpu.train import bootstrap as jax_boot
    want = jax_boot.eval_segmentation(corpus / "models", corpus / "val",
                                      batch=1)
    got = bootstrap.eval_segmentation(corpus / "models", corpus / "val",
                                      batch=1, device="cpu",
                                      dtype=torch.float32)
    assert got.keys() == want.keys()
    for kind in want:
        assert got[kind].keys() == want[kind].keys()
        for c, v in want[kind].items():
            assert (got[kind][c] is None) == (v is None)
            if v is not None:
                assert abs(got[kind][c] - v) <= 1e-4, (kind, c)
    assert got["region"]["_mean"] is not None


def test_eval_separator_tolerant_equal_jax(corpus, jax_float32):
    from origami_tpu.train import bootstrap as jax_boot
    want = jax_boot.eval_separator_tolerant(corpus / "models",
                                            corpus / "val", tol=2)
    got = bootstrap.eval_separator_tolerant(corpus / "models",
                                            corpus / "val", tol=2,
                                            device="cpu",
                                            dtype=torch.float32)
    assert got == want
    assert got["tol_px"] == 2 and any(
        got[c]["recall"] is not None for c in ("H", "V", "T"))


def test_evaluators_need_a_card_or_cpu(corpus, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (bootstrap.eval_segmentation,
               bootstrap.eval_separator_tolerant):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(corpus / "models", corpus / "val")


class _Fixed:
    """A stand-in SegmentationPredictor: each page's label rasters are
    blocks at 96 x 144 (the evaluators resize the GT to them) seeded by
    the page's pixels."""

    def __init__(self, path, target="quality", **kwargs):
        pass

    def predict_batch(self, pages):
        out = []
        for page in pages:
            rng = np.random.default_rng(int(np.asarray(page).sum()))
            labs = {}
            for name in ("regions", "separators"):
                lab = np.full((96, 144), 3, np.uint8)
                for _ in range(12):
                    y, x = rng.integers(0, 90), rng.integers(0, 140)
                    lab[y:y + rng.integers(1, 30),
                        x:x + rng.integers(1, 60)] = rng.integers(0, 3)
                labs[name] = lab
            out.append(_FixedSeg(labs))
        return out


class _FixedSeg:
    def __init__(self, labs):
        self._labs = labs

    def by_name(self, name):
        return type("P", (), {"labels": self._labs[name]})


def test_evaluators_equal_jax_on_the_same_labels(corpus, monkeypatch):
    from origami_tpu.core import predict as jax_predict
    from origami_tpu.train import bootstrap as jax_boot
    from origami_tpu_torch.core import predict
    monkeypatch.setattr(jax_predict, "SegmentationPredictor", _Fixed)
    monkeypatch.setattr(predict, "SegmentationPredictor", _Fixed)
    args = (corpus / "models", corpus / "val")
    assert bootstrap.eval_segmentation(*args, batch=1) \
        == jax_boot.eval_segmentation(*args, batch=1)
    assert bootstrap.eval_separator_tolerant(*args, tol=3) \
        == jax_boot.eval_separator_tolerant(*args, tol=3)
