"""Grayscale morphology with rectangular structuring elements.

Port of the SAME-padded `reduce_window` dilation and erosion that the
heuristic segmenter builds its openings and closings from
(origami_tpu/core/predict.py:224-230). `skeletonize` and `label_edt` of
origami_tpu/ops/morphology.py belong to the flow and layout stages.
"""

from __future__ import annotations

import torch.nn.functional as F


def dilate(x, kh, kw):
    """Max over a (kh, kw) window around each pixel of the f32 (H, W)
    image. The border is padded with -inf, `(k - 1) // 2` before and
    `k // 2` after, as XLA's "SAME" padding does."""
    kh, kw = int(kh), int(kw)
    pad = ((kw - 1) // 2, kw // 2, (kh - 1) // 2, kh // 2)
    padded = F.pad(x[None, None], pad, value=float("-inf"))
    return F.max_pool2d(padded, (kh, kw), stride=1)[0, 0]


def erode(x, kh, kw):
    """Min over the window: the border never erodes."""
    return -dilate(-x, kh, kw)
