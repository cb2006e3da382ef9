"""ops/resize.py against origami_tpu/ops/resize.py on the CPU.

Tolerance: 1e-3 gray levels on a 0..255 image for "area" and "linear"
(both sides multiply by the same float32 weight matrices; the sums run
in another order), exact for "nearest", also where an output pixel's
centre falls exactly on a boundary between two source pixels (40 -> 100
has one every fifth pixel): the port computes the scale as XLA folds it.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from origami_tpu.ops import resize as jax_resize
from origami_tpu_torch.ops import resize

TOL = 1e-3
# (in_hw, out_hw): down, up, mixed (H grows, W shrinks: the segment
# stage's 1920x1344 -> 2432x1280 in small), mixed the other way, odd
SHAPES = [((120, 96), (45, 40)), ((41, 36), (100, 90)),
          ((120, 84), (152, 80)), ((90, 130), (64, 190)),
          ((77, 53), (31, 101))]


def image(hw, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, hw).astype(np.float32)


@pytest.mark.parametrize("method", ["area", "linear"])
@pytest.mark.parametrize("in_hw,out_hw", SHAPES)
def test_resize_matches_jax(in_hw, out_hw, method):
    img = image(in_hw)
    ref = np.asarray(jax_resize.resize(jnp.asarray(img), out_hw, method))
    got = resize.resize(torch.from_numpy(img), out_hw, method).numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    assert np.abs(got - ref).max() <= TOL


# sizes whose output centres fall on source pixel boundaries
TIES = [((40, 100), (100, 40)), ((100, 40), (40, 100)),
        ((64, 48), (160, 120))]


@pytest.mark.parametrize("in_hw,out_hw", SHAPES + TIES)
def test_resize_labels_matches_jax(in_hw, out_hw):
    lab = np.random.default_rng(1).integers(0, 4, in_hw).astype(np.uint8)
    ref = np.asarray(jax_resize.resize_labels(jnp.asarray(lab), out_hw))
    got = resize.resize_labels(torch.from_numpy(lab), out_hw).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("method", ["area", "linear", "nearest"])
def test_resize_batch_and_channels(method):
    imgs = np.stack([image((60, 44), s) for s in range(3)])
    ref = np.asarray(jax_resize.resize_batch(jnp.asarray(imgs), (76, 40),
                                             method))
    got = resize.resize_batch(torch.from_numpy(imgs), (76, 40), method)
    assert np.abs(got.numpy() - ref).max() <= TOL
    hwc = np.moveaxis(imgs, 0, -1)
    ref = np.asarray(jax_resize.resize(jnp.asarray(hwc), (30, 50), method))
    got = resize.resize(torch.from_numpy(np.ascontiguousarray(hwc)),
                        (30, 50), method)
    assert got.shape == (30, 50, 3)
    assert np.abs(got.numpy() - ref).max() <= TOL


def test_segment_stage_canvas_resize():
    """The stage's own geometry: a 255-padded 1920x1344 page to the
    2432x1280 net canvas, H growing and W shrinking in one call."""
    img = np.full((1920, 1344), 255, np.float32)
    img[:, :1312] = image((1920, 1312), 4)
    ref = np.asarray(jax_resize.resize(jnp.asarray(img), (2432, 1280),
                                       "area"))
    got = resize.resize(torch.from_numpy(img), (2432, 1280), "area").numpy()
    assert np.abs(got - ref).max() <= TOL


def test_unknown_method_raises():
    with pytest.raises(ValueError):
        resize.resize(torch.zeros(4, 4), (2, 2), "cubic")
