"""Shared pieces of the port's training parity tests
(tests/test_torch_train_*.py): the JAX trainers built in float32 on one
device, weights carried across, and the comparison of parameter trees.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from origami_tpu.parallel.mesh import make_mesh

# the small size of the CPU tests: a U-Net of width 0.25 with s2d 2 on
# 64 x 128 tiles, a recognizer with conv (8, 16, 16), LSTM 16, height 48
TILE_HW = (64, 128)
UNET = dict(width=0.25, s2d=2)
REC = dict(conv_features=(8, 16, 16), lstm_features=16, height=48)
CLASSES = ["TEXT", "TABULAR", "ILLUSTRATION", "BACKGROUND"]


@pytest.fixture
def few_threads():
    """Two torch threads for the test: its tensors are small, and the
    suite runs in several worker processes on the same cores, where
    more threads than cores stall each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def one_device_mesh():
    return make_mesh(devices=jax.devices()[:1])


def float32_unets(monkeypatch, module):
    """Make `module.unet_lib.create_unet` build float32 U-Nets (the JAX
    trainers' nets compute in bf16 otherwise)."""
    from origami_tpu.models import unet as junet
    monkeypatch.setattr(module.unet_lib, "create_unet",
                        functools.partial(junet.create_unet,
                                          dtype=jnp.float32))


def to_numpy(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def leaf_errors(want, got):
    """{path: ||want - got|| / ||want||} over the leaves of two flax
    trees (the port's through registry.flax_params)."""
    out = {}

    def one(path, a, b):
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        assert a.shape == b.shape, (jax.tree_util.keystr(path), a.shape,
                                    b.shape)
        out[jax.tree_util.keystr(path)] = \
            np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30)
    jax.tree_util.tree_map_with_path(one, want, got)
    return out


def corpus_arrays(n=3, hw=TILE_HW, classes=4, seed=0):
    """n seeded uint8 pages with blocky label maps (numpy)."""
    rng = np.random.default_rng(seed)
    h, w = hw
    imgs = (rng.random((n, h, w)) * 255).astype(np.uint8)
    labs = np.full((n, h, w), classes - 1, np.uint8)
    for i in range(n):
        for _ in range(4):
            y, x = rng.integers(0, h - 8), rng.integers(0, w - 8)
            labs[i, y:y + rng.integers(4, 24), x:x + rng.integers(4, 48)] = \
                rng.integers(0, classes - 1)
    # ink on text: darker pixels where labels say TEXT
    imgs[labs == 0] //= 3
    return imgs, labs
