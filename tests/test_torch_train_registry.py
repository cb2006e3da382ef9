"""Weights both ways (origami_tpu_torch/models/{_msgpack,registry,unet,
recognizer}.py):

  * `_msgpack.packb` gives flax.serialization.to_bytes' bytes for numpy
    trees (every leaf kind a parameter tree holds, maps past 15 keys,
    arrays past 64 KiB, numpy scalars, key order kept);
  * port -> flax tree -> port is exact, and re-saving the shipped models
    gives their params.msgpack byte for byte;
  * init_unet / init_recognizer give the JAX init tree's structure and
    shapes, flax's initializer statistics, and draw from the generator.
"""

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from origami_tpu.models import recognizer as jrec
from origami_tpu.models import unet as junet
from origami_tpu_torch.models import _msgpack, registry
from origami_tpu_torch.models.recognizer import (LineRecognizer,
                                                 init_recognizer)
from origami_tpu_torch.models.unet import create_unet, init_unet
from torch_train_helpers import REC, TILE_HW, UNET
from torch_train_helpers import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]
SHIPPED = ["recognizer", "students/region/00", "students/separator/00"]


def _trees():
    rng = np.random.default_rng(0)
    yield {"b": {"kernel": rng.random((3, 3, 1, 8)).astype(np.float32),
                 "bias": np.zeros((8,), np.float32)},
           "a": {"x": rng.random((300,)).astype(np.float16)}}
    yield {"s": np.float32(2.5), "z": np.zeros((), np.float32),
           "e": np.zeros((0, 4), np.float32),
           "i": np.arange(70000, dtype=np.int32),
           "big": rng.random((70000,)).astype(np.float32),
           "neg": np.int64(-5), "u": np.arange(5, dtype=np.uint8)}
    yield {"k%d" % k: {"w": rng.random((k + 1,)).astype(np.float32)}
           for k in range(20)}


@pytest.mark.parametrize("tree", list(_trees()))
def test_packb_equals_flax_to_bytes(tree):
    assert _msgpack.packb(tree) == flax.serialization.to_bytes(tree)
    back = _msgpack.unpackb(_msgpack.packb(tree))
    assert list(back) == list(tree)


@pytest.mark.parametrize("name", SHIPPED)
def test_weights_round_trip_and_resave_byte_equal(name, tmp_path):
    path = ROOT / "models_pretrained" / name
    model, meta = registry.load_model(path, "cpu")
    tree, _ = registry.load_params(path)
    back = registry.flax_params(model)
    assert jax.tree_util.tree_structure(back) \
        == jax.tree_util.tree_structure(tree)
    jax.tree.map(np.testing.assert_array_equal, back, tree)
    registry.save_model(tmp_path / "m", meta, model,
                        params_dtype=meta.get("params_dtype"))
    assert (tmp_path / "m" / "params.msgpack").read_bytes() \
        == (path / "params.msgpack").read_bytes()


def _shapes(tree):
    return jax.tree.map(lambda a: tuple(a.shape), tree)


def test_init_unet_has_the_jax_tree_and_flax_statistics():
    jmodel = junet.create_unet(4, dtype=jnp.float32, **UNET)
    want = jax.eval_shape(lambda: junet.init_unet(
        jmodel, jax.random.PRNGKey(0), TILE_HW))
    model = init_unet(create_unet(4, dtype=torch.float32, **UNET),
                      torch.Generator().manual_seed(0))
    got = registry.flax_params(model)
    assert _shapes(got) == _shapes(want)
    big = got["ConvBlock_3"]["Conv_0"]["kernel"]       # fan in 9 x 128
    assert abs(big.std() * np.sqrt(np.prod(big.shape[:3])) - 1) < 0.05
    assert np.abs(big).max() <= 2 / 0.87962566103423978 \
        / np.sqrt(np.prod(big.shape[:3])) + 1e-6   # truncated at 2 sigma
    assert (got["ConvBlock_0"]["GroupNorm_0"]["scale"] == 1).all()
    assert (got["Conv_3"]["bias"] == 0).all()
    again = init_unet(create_unet(4, dtype=torch.float32, **UNET),
                      torch.Generator().manual_seed(0))
    torch.testing.assert_close(again.state_dict(), model.state_dict())


def test_init_recognizer_has_the_jax_tree_and_flax_statistics():
    jmodel = jrec.create_recognizer(5, conv_features=REC["conv_features"],
                                    lstm_features=REC["lstm_features"])
    want = jax.eval_shape(lambda: jrec.init_recognizer(
        jmodel, jax.random.PRNGKey(0), height=REC["height"]))
    model = LineRecognizer(5, REC["conv_features"], REC["lstm_features"],
                           REC["height"])
    init_recognizer(model, torch.Generator().manual_seed(0))
    got = registry.flax_params(model)
    assert _shapes(got) == _shapes(want)
    cell = got["BiLSTM_0"]["OptimizedLSTMCell_1"]
    for g in "ifgo":
        q = cell["h" + g]["kernel"]
        np.testing.assert_allclose(q.T @ q, np.eye(q.shape[0]), atol=1e-5)
        assert (cell["h" + g]["bias"] == 0).all()
    assert (got["Dense_1"]["bias"] == 0).all()
