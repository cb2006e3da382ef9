"""Device image resizing.

Port of origami_tpu/ops/resize.py. The JAX functions go through
`jax.image.resize`: "area" is its linear filter with antialiasing, which
widens the triangle per axis only where that axis shrinks; "linear" the
same filter without; both sample at half-pixel centres and resize as a
product with one weight matrix per axis. The port builds the same two
matrices (its own copy of jax.image's `compute_weight_mat`, with the
sample positions rounded as XLA rounds them) and resizes with two
`torch.matmul`s. PyTorch's `F.interpolate(mode="bilinear",
antialias=True)` computes a close filter, but differs by up to 0.013
gray levels on the segment stage's 1920x1344 -> 2432x1280 resize, above
the 1e-3 this port holds (tests/test_torch_resize.py). "nearest" is
`jax.image.resize`'s rule: the source pixel under each output pixel's
centre.
"""

from __future__ import annotations

import numpy as np
import torch


def _weight_matrix(n_in, n_out, antialias, device):
    """(n_in, n_out) float32 weights of a triangle-filter resize along
    one axis; the triangle is `max(n_in / n_out, 1)` source pixels wide
    per side when `antialias`, else 1."""
    # float32 throughout, as jax.image: 1 / float32(n_out / n_in)
    one = torch.ones((), dtype=torch.float32)
    inv_scale = float(one / torch.tensor(n_out / n_in, dtype=torch.float32))
    kernel_scale = max(inv_scale, 1.0) if antialias else 1.0
    # the source position under each output pixel's centre. XLA
    # contracts (i + 0.5) * inv_scale - 0.5 into one fused multiply-add,
    # so the product is not rounded on its own; an ulp of a position
    # near 1000 is 6e-5 of a weight. float64 holds the product of two
    # float32 values exactly, which gives the same positions.
    sample = ((torch.arange(n_out, dtype=torch.float64, device=device)
               + 0.5) * inv_scale - 0.5).float()
    src = torch.arange(n_in, dtype=torch.float32, device=device)
    x = (sample[None, :] - src[:, None]).abs() / kernel_scale
    weights = torch.clamp(1.0 - x, min=0.0)
    total = weights.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(torch.finfo(torch.float32).eps)
    weights = torch.where(
        total.abs() > eps,
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def _nearest_index(n_in, n_out, device):
    """floor((i + 0.5) * scale) in float32 with scale = n_in * (1 /
    n_out), each rounded to float32: jax.image.resize writes
    (i + 0.5) * n_in / n_out, and XLA folds the division by the constant
    into that scale. Where an output centre falls exactly on a source
    pixel boundary (40 -> 100: every fifth pixel), the folded scale
    lands an ulp below it and takes the lower pixel, as JAX does."""
    one = np.float32(1.0)
    scale = np.float32(np.float32(n_in) * (one / np.float32(n_out)))
    i = torch.arange(n_out, dtype=torch.float32, device=device)
    return torch.floor((i + 0.5) * float(scale)).long().clamp(0, n_in - 1)


def resize_batch(images, out_hw, method="area"):
    """Resize a batch (N, H, W[, C]) to `out_hw`. "area" and "linear"
    return float32; "nearest" keeps the dtype."""
    squeeze = images.dim() == 3
    x = images[..., None] if squeeze else images
    h, w = x.shape[1:3]
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if method in ("area", "linear"):
        antialias = method == "area"
        x = x.float().permute(0, 3, 1, 2)                    # (N, C, H, W)
        if oh != h:
            wy = _weight_matrix(h, oh, antialias, x.device)
            x = torch.matmul(wy.t(), x)
        if ow != w:
            wx = _weight_matrix(w, ow, antialias, x.device)
            x = torch.matmul(x, wx)
        out = x.permute(0, 2, 3, 1)
    elif method == "nearest":
        ys = _nearest_index(h, oh, x.device)
        xs = _nearest_index(w, ow, x.device)
        out = x[:, ys][:, :, xs]
    else:
        raise ValueError(method)
    return out[..., 0] if squeeze else out


def resize(image, out_hw, method="area"):
    """Resize an HW or HWC image to `out_hw`.

    method: "area" (anti-aliased, for downscale), "linear", "nearest"."""
    return resize_batch(image[None], out_hw, method)[0]


def resize_labels(labels, out_hw):
    """Nearest-neighbour resize for integer label maps."""
    return resize(labels, out_hw, method="nearest")
