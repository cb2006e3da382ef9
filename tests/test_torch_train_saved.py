"""Model directories the port saves (origami_tpu_torch/models/
registry.save_model) load in the JAX package: a recognizer (float32 and
params_dtype float16, with the arch tag) and a U-Net, freshly
initialized by the port, give the port's float32 logits through the JAX
registry.load_model within 1e-5 (absolute plus relative: XLA's and
PyTorch's float32 convolutions sum in other orders). The recognizer's
padded frames are left out: the JAX BiLSTM runs on past a row's length
there, the port's packed LSTM does not, and neither frame is read.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from origami_tpu.models import recognizer as jrec
from origami_tpu.models import registry as jax_registry
from origami_tpu.models import unet as junet
from origami_tpu_torch.models import registry
from origami_tpu_torch.models.recognizer import (LineRecognizer,
                                                 init_recognizer)
from origami_tpu_torch.models.unet import create_unet, init_unet
from torch_train_helpers import CLASSES, REC, TILE_HW, UNET
from torch_train_helpers import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")


def _strips(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((3, REC["height"], 96, 1)).astype(np.float32)
    return x, np.array([96, 70, 41], np.float32)


@pytest.mark.parametrize("params_dtype", [None, "float16"])
def test_port_saved_recognizer_loads_in_jax(tmp_path, params_dtype):
    model = LineRecognizer(5, REC["conv_features"], REC["lstm_features"],
                           REC["height"], dtype=torch.float32)
    init_recognizer(model, torch.Generator().manual_seed(3))
    meta = dict(kind="recognizer", charset="abcde", height=REC["height"],
                conv_features=list(REC["conv_features"]),
                lstm_features=REC["lstm_features"], version=1)
    registry.save_model(tmp_path / "r", meta, model,
                        params_dtype=params_dtype)
    saved = registry.load_meta(tmp_path / "r")
    assert saved["arch"] == registry.RECOGNIZER_ARCH
    assert saved.get("params_dtype") == params_dtype
    jmodel, jparams, _ = jax_registry.load_model(tmp_path / "r")
    jmodel = jrec.create_recognizer(5, dtype=jnp.float32,
                                    conv_features=REC["conv_features"],
                                    lstm_features=REC["lstm_features"])
    x, widths = _strips()
    want, _ = jmodel.apply({"params": jparams}, jnp.asarray(x),
                           widths=jnp.asarray(widths))
    port, _ = registry.load_model(tmp_path / "r", "cpu",
                                  conv_dtype=torch.float32)
    with torch.no_grad():
        got, _ = port(torch.tensor(x), widths=torch.tensor(widths))
    valid = np.arange(got.shape[1])[None] < np.ceil(widths / 4)[:, None]
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid],
                               rtol=1e-5, atol=1e-5)


def test_port_saved_unet_loads_in_jax(tmp_path):
    model = create_unet(4, dtype=torch.float32, **UNET)
    init_unet(model, torch.Generator().manual_seed(5))
    meta = dict(kind="unet", type="region", classes=CLASSES,
                full_size=[TILE_HW[1], TILE_HW[0]],
                tile_size=[TILE_HW[1], TILE_HW[0]], tile_beta=50,
                channels=1, version=1, **UNET)
    registry.save_model(tmp_path / "u", meta, model)
    _, jparams, _ = jax_registry.load_model(tmp_path / "u")
    jmodel = junet.create_unet(4, dtype=jnp.float32, **UNET)
    x = np.random.default_rng(1).random((2, *TILE_HW, 1)).astype(np.float32)
    want = np.asarray(jmodel.apply({"params": jparams}, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
