"""Synthetic page-warp augmentation on the card.

Port of origami_tpu/train/segment/warp.py. Training images and their
label maps are deformed by one smooth random displacement field: a
coarse (cells+1)^2 grid of normal draws times the amplitude, zero on its
border, upsampled linearly to the page (jax.image.resize's "linear"
weights, `ops/resize.py`). The image is sampled bilinearly through the
`remap` CUDA kernel at the JAX site's border (bilinear_sample: taps
clamped into the page, `fill` outside [0, w-1] x [0, h-1]); the labels
nearest, rounding half to even as jnp.round does. `warp_batch` warps a
whole batch in one kernel launch (`ops.remap.remap_batch`); on CPU
tensors the kernel's plain version runs.

jax.random cannot be reproduced here: the port draws from a
torch.Generator, and its functions also take a given field.
"""

from __future__ import annotations

import numpy as np
import torch

from origami_tpu_torch.device import resolve
from origami_tpu_torch.ops.remap import remap_batch
from origami_tpu_torch.ops.resize import resize_batch

CELLS = 4


def random_coarse(generator, n, amplitude, cells=CELLS):
    """(n, cells+1, cells+1, 2) float32 normal draws times `amplitude`
    (a float or an (n,) tensor), zero on the grid's border; drawn on the
    CPU from `generator`."""
    coarse = torch.randn((n, cells + 1, cells + 1, 2), generator=generator)
    amp = torch.as_tensor(amplitude, dtype=torch.float32)
    coarse = coarse * amp.reshape(-1, 1, 1, 1)
    coarse[:, 0] = 0
    coarse[:, -1] = 0
    coarse[:, :, 0] = 0
    coarse[:, :, -1] = 0
    return coarse


def displacement_field(coarse, shape):
    """The coarse grids (n, c, c, 2) upsampled linearly to (n, H, W, 2)
    (jax.image.resize(..., "linear"))."""
    return resize_batch(coarse, tuple(shape), method="linear")


def warp_batch(images, labels, fields, fill=255.0):
    """Warp images (B, H, W) float32 and their label maps (B, H, W) by
    fields (B, H, W, 2): one remap_batch launch for the images, a gather
    of the nearest label. -> (images', labels')."""
    b, h, w = images.shape
    dev = images.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    mx = (xs + fields[..., 0]).contiguous()
    my = (ys + fields[..., 1]).contiguous()
    im2 = remap_batch(images.float().contiguous(), (mx, my), fill=fill,
                      border="hard")
    xi = torch.round(mx).long().clamp(0, w - 1)
    yi = torch.round(my).long().clamp(0, h - 1)
    flat = labels.reshape(b, -1)
    lab2 = torch.gather(flat, 1, (yi * w + xi).reshape(b, -1)) \
        .reshape(b, h, w)
    return im2, lab2


def warp_pair(image, labels, field, fill=255.0):
    """One image (H, W) and its label map through `field` (H, W, 2)."""
    im2, lab2 = warp_batch(image[None], labels[None], field[None], fill)
    return im2[0], lab2[0]


class WarpAugmentation:
    """Warps (image, labels) pairs of uint8 numpy pages on `device`, each
    by a fresh field of the given amplitude."""

    def __init__(self, amplitude=12.0, seed=0, device=None, generator=None):
        self._amplitude = amplitude
        self._gen = generator if generator is not None \
            else torch.Generator().manual_seed(seed)
        self.device = resolve(device)

    def __call__(self, image, labels):
        h, w = image.shape
        coarse = random_coarse(self._gen, 1, self._amplitude)
        field = displacement_field(coarse.to(self.device), (h, w))[0]
        im2, lab2 = warp_pair(
            torch.as_tensor(np.asarray(image)).to(self.device).float(),
            torch.as_tensor(np.asarray(labels)).to(self.device), field)
        return (np.clip(im2.cpu().numpy(), 0, 255).astype(np.uint8),
                lab2.cpu().numpy())
