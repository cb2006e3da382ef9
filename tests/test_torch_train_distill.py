"""The port's Distiller (origami_tpu_torch/train/segment/distill.py)
against the JAX Distiller: two random float32 teacher members and the
student's float32 weights carried across, the same device-resident
corpus and page indices; 3 steps of distill_on_indices and 2 of the
host-batch train_step (hard labels, then none). Losses within 1e-4
relative, every student leaf within 1e-4 relative (L2 norm of its
difference over its own). U-Nets of width 0.25, s2d 2, on 64 x 128.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import origami_tpu.train.segment.distill as jax_distill
from origami_tpu.models import unet as junet
from origami_tpu_torch.models import registry
from origami_tpu_torch.train.segment import distill as port_distill
from torch_train_helpers import (CLASSES, TILE_HW, UNET, corpus_arrays,
                                 float32_unets, leaf_errors,
                                 one_device_mesh, to_numpy)
from torch_train_helpers import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

BAR = 1e-4
META = dict(classes=CLASSES, **UNET)


@pytest.fixture
def pair(monkeypatch):
    float32_unets(monkeypatch, jax_distill)
    teacher = junet.create_unet(4, dtype=jnp.float32, **UNET)
    members = [junet.init_unet(teacher, jax.random.PRNGKey(k), TILE_HW)
               for k in (1, 2)]
    stack = jax.tree.map(lambda a, b: jnp.stack([a, b]), *members)
    cfg = jax_distill.DistillConfig(num_classes=4, tile_hw=TILE_HW,
                                    steps=10, warmup=2, **UNET)
    jd = jax_distill.Distiller(cfg, teacher, stack, mesh=one_device_mesh(),
                               seed=0)
    teachers = []
    for m in members:
        t = registry.build_unet(META, dtype=torch.float32)
        t.load_state_dict(registry.unet_params_from_flax(to_numpy(m), META))
        teachers.append(t)
    pd = port_distill.Distiller(port_distill.DistillConfig(**cfg.__dict__),
                                teachers, device="cpu", dtype=torch.float32)
    pd.student.load_state_dict(
        registry.unet_params_from_flax(to_numpy(jd.params), META))
    return jd, pd


def _check(jd, pd, lj, lp, what):
    assert abs(lp - lj) <= BAR * abs(lj), (what, lj, lp)
    errs = leaf_errors(to_numpy(jd.params), registry.flax_params(pd.student))
    worst = max(errs, key=errs.get)
    assert errs[worst] <= BAR, (what, worst, errs[worst])


def test_distill_steps_match_jax(pair):
    """3 steps on the corpus rows, then 2 host-batch steps (hard labels,
    then none: KL only, the hard term's mask all zero)."""
    jd, pd = pair
    imgs, labs = corpus_arrays(3, seed=2)
    jd.attach_dataset(imgs, labs)
    pd.attach_dataset(imgs, labs)
    for step in range(3):
        idx = [step % 3, (step + 1) % 3]
        lj = float(jd.distill_on_indices(idx))
        lp = pd.distill_on_indices(idx)
        assert isinstance(lp, torch.Tensor)
        _check(jd, pd, lj, float(lp), step)
    x = (imgs[:2] / 255.0).astype(np.float32)[..., None]
    _check(jd, pd, jd.train_step(x, labs[:2].astype(np.int32)),
           pd.train_step(x, labs[:2].astype(np.int64)), "labels")
    _check(jd, pd, jd.train_step(x), pd.train_step(x), "soft only")


def test_teacher_runs_without_gradients(pair):
    _, pd = pair
    x = torch.rand(1, *TILE_HW, 1)
    p = pd.teacher_probs(x)
    assert not p.requires_grad
    torch.testing.assert_close(p.sum(-1), torch.ones(p.shape[:-1]))
    assert all(not t.training for t in pd.teachers)
