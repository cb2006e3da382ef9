"""The port's SegmentationTrainer (origami_tpu_torch/train/segment/
train.py) against the JAX trainer: the same float32 weights carried
across (registry.unet_params_from_flax), the same device-resident
corpus and page indices, warp off; 3 steps. Losses within 1e-4
relative, every parameter leaf within 1e-4 relative (the L2 norm of its
difference over its own). A U-Net of width 0.25, s2d 2, on 64 x 128
tiles; region (plain class-weighted CE) and separator (with the
band_dontcare tolerance band) configurations. The host-batch step is
held to the corpus step.
"""

import numpy as np
import pytest
import torch

import origami_tpu.train.segment.train as jax_train
from origami_tpu_torch.models import registry
from origami_tpu_torch.train.segment import train as port_train
from torch_train_helpers import (CLASSES, TILE_HW, UNET, corpus_arrays,
                                 float32_unets, leaf_errors,
                                 one_device_mesh, to_numpy)
from torch_train_helpers import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

STEPS = 3
BAR = 1e-4


@pytest.mark.parametrize("kind", ["region", "separator"])
def test_three_steps_match_jax(monkeypatch, kind):
    float32_unets(monkeypatch, jax_train)
    imgs, labs = corpus_arrays(3)
    cw = np.array([1.0, 2.5, 4.0, 0.5], np.float32)
    band = (3, 2, 0.15) if kind == "separator" else None
    cfg = jax_train.TrainConfig(num_classes=4, tile_hw=TILE_HW, steps=10,
                                warmup=2, class_weights=cw,
                                band_dontcare=band, **UNET)
    jt = jax_train.SegmentationTrainer(cfg, mesh=one_device_mesh(), seed=0)
    pt = port_train.SegmentationTrainer(
        port_train.TrainConfig(**cfg.__dict__), device="cpu",
        dtype=torch.float32)
    meta = dict(classes=CLASSES)
    pt.model.load_state_dict(
        registry.unet_params_from_flax(to_numpy(jt.params), meta))
    jt.attach_dataset(imgs, labs)
    pt.attach_dataset(imgs, labs)
    for step in range(STEPS):
        idx = [step % 3, (step + 1) % 3]
        lj = float(jt.train_on_indices(idx))
        lp = pt.train_on_indices(idx)
        assert isinstance(lp, torch.Tensor) and lp.dim() == 0
        assert abs(float(lp) - lj) <= BAR * abs(lj), (step, lj, float(lp))
        errs = leaf_errors(to_numpy(jt.params),
                           registry.flax_params(pt.model))
        worst = max(errs, key=errs.get)
        assert errs[worst] <= BAR, (step, worst, errs[worst])
    # the first update ran at learning rate 0 (optax's warmup starts
    # there), so the weights moved only from the second step on
    assert pt.optimizer.count == STEPS


def test_host_batch_step_equals_the_corpus_step():
    """The host-batch path (train_step: float images, int labels) takes
    the same update as the device-resident corpus path on the same
    pages."""
    imgs, labs = corpus_arrays(2, seed=5)
    cfg = port_train.TrainConfig(num_classes=4, tile_hw=TILE_HW, steps=5,
                                 warmup=1, **UNET)
    a, b = (port_train.SegmentationTrainer(cfg, seed=1, device="cpu",
                                           dtype=torch.float32)
            for _ in range(2))
    a.attach_dataset(imgs, labs)
    # the corpus step's normalization, rounded as it rounds
    x = (torch.from_numpy(imgs).float() / torch.tensor(255.0))[..., None]
    for _ in range(2):
        la = float(a.train_on_indices([0, 1]))
        lb = b.train_step(x.numpy(), labs.astype(np.int64))
        assert la == lb
    for pa, pb in zip(a.model.parameters(), b.model.parameters()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0)
