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
    `k // 2` after, as XLA's "SAME" padding does. The window is taken as
    a row max, then a column max: the same maximum in kh + kw steps
    instead of kh * kw."""
    kh, kw = int(kh), int(kw)
    inf = float("-inf")
    rows = F.max_pool2d(F.pad(x[None, None], ((kw - 1) // 2, kw // 2),
                              value=inf), (1, kw), stride=1)
    return F.max_pool2d(F.pad(rows, (0, 0, (kh - 1) // 2, kh // 2),
                              value=inf), (kh, 1), stride=1)[0, 0]


def erode(x, kh, kw):
    """Min over the window: the border never erodes."""
    return -dilate(-x, kh, kw)
