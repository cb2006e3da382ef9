"""The training warp (origami_tpu_torch/train/segment/warp.py) and the
`remap` kernel's new entry points (ops/remap.py: border "hard",
remap_batch) on the CPU, where the wrappers run their plain versions:

  * warp_pair against the JAX warp_pair with the JAX key: the port gets
    the JAX field (jax.random cannot be reproduced); image within 1e-4,
    labels equal;
  * the field's linear upsample against jax.image.resize, 1e-6 of the
    field's largest displacement;
  * remap's "hard" border against JAX's bilinear_sample on coordinates
    inside, on the edge of and far off the image, 1e-4; remap_batch (map
    or planes, both borders) equal to remap image by image;
  * the dataset step warps its whole batch in one remap_batch call.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from origami_tpu.ops import remap as jax_remap
from origami_tpu.train.segment import warp as jax_warp
from origami_tpu_torch.ops import remap as port_remap
from origami_tpu_torch.train.segment import train as port_train
from origami_tpu_torch.train.segment import warp as port_warp
from torch_train_helpers import TILE_HW, UNET, corpus_arrays
from torch_train_helpers import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")


def _jax_coarse(key, amplitude, cells=4):
    """The coarse grid _displacement_field draws from `key`."""
    k1, _ = jax.random.split(key)
    c = np.array(jax.random.normal(k1, (cells + 1, cells + 1, 2))
                 * amplitude)
    c[0] = c[-1] = 0
    c[:, 0] = c[:, -1] = 0
    return c


@pytest.mark.parametrize("seed,hw,amp", [(0, (96, 64), 7.0),
                                         (3, (128, 200), 12.0),
                                         (11, (64, 128), 20.0)])
def test_warp_pair_equals_jax_with_the_jax_field(seed, hw, amp):
    rng = np.random.default_rng(seed)
    img = (rng.random(hw) * 255).astype(np.float32)
    lab = rng.integers(0, 4, hw).astype(np.int32)
    key = jax.random.PRNGKey(seed)
    field = np.asarray(jax_warp._displacement_field(key, hw,
                                                    amplitude=amp))
    want_img, want_lab = jax_warp.warp_pair(key, jnp.asarray(img),
                                            jnp.asarray(lab), amp)
    got_img, got_lab = port_warp.warp_pair(
        torch.tensor(img), torch.tensor(lab), torch.tensor(field))
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img),
                               rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got_lab.numpy(), np.asarray(want_lab))
    # the field moved pixels, and the fill came in at the border
    assert (got_lab.numpy() != lab).any()


@pytest.mark.parametrize("seed,hw,amp", [(0, (96, 64), 7.0),
                                         (5, (2432, 1280), 10.0)])
def test_field_upsample_equals_jax_image_resize(seed, hw, amp):
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax_warp._displacement_field(key, hw, amplitude=amp))
    got = port_warp.displacement_field(
        torch.tensor(_jax_coarse(key, amp))[None], hw)[0].numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    # zero displacement along the page border
    assert np.abs(got[0]).max() == 0 and np.abs(got[:, -1]).max() == 0


def _coords(rng, h, w, shape):
    x = rng.uniform(-3, w + 2, shape).astype(np.float32)
    y = rng.uniform(-3, h + 2, shape).astype(np.float32)
    x.flat[:4] = [0.0, w - 1, -1e7, np.nan]      # edges, far off, NaN
    y.flat[:4] = [h - 1, 0.0, 5.0, 2.0]
    return x, y


def test_hard_border_equals_bilinear_sample():
    rng = np.random.default_rng(2)
    h, w = 40, 56
    img = (rng.random((h, w)) * 255).astype(np.float32)
    x, y = _coords(rng, h, w, (30, 45))
    want = np.asarray(jax_remap.bilinear_sample(
        jnp.asarray(img), jnp.stack([jnp.asarray(x), jnp.asarray(y)], -1),
        fill=255.0))
    got = port_remap.remap(torch.tensor(img),
                           torch.tensor(np.stack([x, y], -1)), fill=255.0,
                           border="hard").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("border", ["hard", "fill_taps"])
def test_remap_batch_equals_remap_per_image(border):
    rng = np.random.default_rng(3)
    imgs = torch.tensor((rng.random((3, 30, 40)) * 255).astype(np.float32))
    x, y = _coords(rng, 30, 40, (3, 20, 25))
    maps = torch.tensor(np.stack([x, y], -1))
    by_map = port_remap.remap_batch(imgs, maps, fill=7.0, border=border)
    by_planes = port_remap.remap_batch(
        imgs, (torch.tensor(x), torch.tensor(y)), fill=7.0, border=border)
    torch.testing.assert_close(by_map, by_planes, rtol=0, atol=0,
                               equal_nan=True)
    for b in range(3):
        torch.testing.assert_close(
            by_map[b], port_remap.remap(imgs[b], maps[b], 7.0, border),
            rtol=0, atol=0, equal_nan=True)
    with pytest.raises(ValueError):
        port_remap.remap_batch(imgs, maps, border="clamp")


def test_dataset_step_warps_its_batch_in_one_call(monkeypatch):
    calls = []
    real = port_remap.remap_batch

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(port_warp, "remap_batch", counted)
    imgs, labs = corpus_arrays(3)
    cfg = port_train.TrainConfig(num_classes=4, tile_hw=TILE_HW, steps=4,
                                 warmup=1, **UNET)
    tr = port_train.SegmentationTrainer(cfg, device="cpu",
                                        dtype=torch.float32)
    tr.attach_dataset(imgs, labs, warp_amplitude=10.0, seed=4)
    losses = [float(tr.train_on_indices([0, 2])) for _ in range(3)]
    assert calls == [(2,) + TILE_HW] * 3
    assert all(np.isfinite(losses))


def test_warp_augmentation_on_numpy_pages():
    imgs, labs = corpus_arrays(1)
    aug = port_warp.WarpAugmentation(amplitude=6.0, seed=1, device="cpu")
    im2, lab2 = aug(imgs[0], labs[0])
    assert im2.dtype == np.uint8 and im2.shape == imgs[0].shape
    assert set(np.unique(lab2)) <= set(np.unique(labs[0]))
    assert (lab2 != labs[0]).any()
    # a fresh field each call
    im3, _ = aug(imgs[0], labs[0])
    assert (im3 != im2).any()
