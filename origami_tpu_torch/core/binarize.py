"""Host-facing binarization API backed by the device functions.

Port of origami_tpu/core/binarize.py. Spec strings such as
"sauvola(window_size=15)" or "otsu" build a callable that takes host
pixels (u8, H x W) and returns a u8 image, 255 = paper and 0 = ink; the
work runs on `device` (None: the card, raising without one) through
ops.binarize, Sauvola through its CUDA kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from origami_tpu_torch import device as _device
from origami_tpu_torch.core.utils import build_func_from_string


def _runner(fn, device):
    device = _device.resolve(device)

    def run(image):
        px = torch.from_numpy(np.ascontiguousarray(image, dtype=np.uint8))
        return fn(px.to(device)).to(torch.uint8).cpu().numpy() * 255
    return run


def sauvola(window_size=15, k=0.2, device=None):
    """The JAX package reaches this through ops/binarize.sauvola (XLA),
    whose box is 2 * (w // 2) + 1 pixels wide: an even window takes the
    next odd one here (ROADMAP C10); the kernel itself takes odd windows
    only."""
    from origami_tpu_torch.ops.binarize import sauvola as _sauvola
    window = int(window_size) | 1
    return _runner(lambda px: _sauvola(px, window, k), device)


def otsu(device=None):
    from origami_tpu_torch.ops.binarize import otsu as _otsu
    return _runner(_otsu, device)


def from_string(spec, device=None):
    return build_func_from_string(
        spec, dict(otsu=otsu, sauvola=sauvola))(device=device)
