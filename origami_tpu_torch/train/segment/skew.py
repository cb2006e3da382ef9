"""Master-annotation skew estimation from separator evidence.

Port of origami_tpu/train/segment/skew.py: the page's global skew as the
robust consensus angle of near-horizontal separator segments (RANSAC
with numpy's default_rng(seed), the draws of the JAX module), then the
deskew of image and labels: the image through ops.remap.affine_warp (one
remap_affine launch on the card), the labels by the float64 nearest
gather of the JAX module, on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from origami_tpu_torch import device as _device
from origami_tpu_torch.core.math import rotation_matrix


def ransac_angle(segments, n_iter=200, inlier_tol=0.01, seed=0):
    """segments: (N, 4) [x0 y0 x1 y1] near-horizontal candidates.
    Returns the consensus angle (radians) or 0.0."""
    segs = np.asarray(segments, dtype=np.float64).reshape(-1, 4)
    if len(segs) == 0:
        return 0.0
    d = segs[:, 2:] - segs[:, :2]
    lens = np.linalg.norm(d, axis=1)
    ok = lens > 1e-6
    segs, d, lens = segs[ok], d[ok], lens[ok]
    if len(segs) == 0:
        return 0.0
    angles = np.arctan2(d[:, 1], d[:, 0])
    angles = np.where(angles > np.pi / 2, angles - np.pi, angles)
    angles = np.where(angles < -np.pi / 2, angles + np.pi, angles)
    rng = np.random.default_rng(seed)
    best_angle, best_support = 0.0, -1.0
    for _ in range(min(n_iter, len(angles) * 4)):
        a = angles[rng.integers(len(angles))]
        inliers = np.abs(angles - a) < inlier_tol
        support = float(np.sum(lens[inliers]))
        if support > best_support:
            best_support = support
            best_angle = float(np.average(
                angles[inliers], weights=lens[inliers]))
    return best_angle


def deskew_pair(image, labels, angle, device=None):
    """Rotate image (bilinear, on `device`: None is the card) + labels
    (nearest, host) by -angle about the center -> (u8 image, labels)."""
    from origami_tpu_torch.ops.remap import affine_warp
    dev = _device.resolve(device)
    h, w = np.asarray(image).shape[:2]
    m = rotation_matrix(angle, center=(w / 2, h / 2))
    px = torch.from_numpy(np.ascontiguousarray(image, np.float32)).to(dev)
    im2 = affine_warp(px, m, (h, w), fill=255.0).cpu().numpy()
    # nearest for labels via rounded coordinates
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    src_x = m[0, 0] * xs + m[0, 1] * ys + m[0, 2]
    src_y = m[1, 0] * xs + m[1, 1] * ys + m[1, 2]
    xi = np.clip(np.round(src_x).astype(int), 0, w - 1)
    yi = np.clip(np.round(src_y).astype(int), 0, h - 1)
    lab = np.asarray(labels)
    lab2 = lab[yi, xi]
    outside = (src_x < 0) | (src_x > w - 1) | (src_y < 0) | (src_y > h - 1)
    bg = int(lab.max())
    lab2 = np.where(outside, bg, lab2)
    return np.clip(im2, 0, 255).astype(np.uint8), lab2
