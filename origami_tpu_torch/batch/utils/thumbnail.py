"""utils.thumbnail — page thumbnails.

Port of origami_tpu/batch/utils/thumbnail.py, which shrinks each page
with PIL's `Image.thumbnail((max_size, max_size))` and writes
`thumbnail.jpg` at quality 85. The port writes PIL's bytes
(core/_jpeg.encode, with the page's comment, which PIL carries over:
core/_image.comment) of the pixels PIL gives, computed in numpy:

  * the aspect-preserving size of `Image.thumbnail` (each side rounded
    down or up, whichever keeps the aspect ratio closer);
  * `reducing_gap` 2.0: where the page is more than twice the size on a
    side, `Image.reduce` first averages whole blocks (8-bit fixed point,
    partial blocks at the right and bottom edges), and the resize then
    samples the reduced page through the matching float box;
  * Pillow's 8-bit BICUBIC resampler (a = -0.5): its support scaled by
    the reduction, coefficients in double normalised to their sum and
    rounded to 22 fractional bits, a horizontal pass, then a vertical
    pass, each rounded and clipped to uint8.

`resize_bicubic` serves utils/signature.py too. Host work only:
`--device` is taken as every stage takes it, and nothing runs on it.

    python -m origami_tpu_torch.batch.utils.thumbnail CORPUS \\
        [--max-size 1024] [--device cpu]
"""

from __future__ import annotations

import math

import numpy as np

from origami_tpu_torch.batch.core.io import Artifact, Output
from origami_tpu_torch.batch.core.processor import PageProcessor, run_cli

_PRECISION_BITS = 32 - 8 - 2
_BICUBIC_SUPPORT = 2.0


def _bicubic(x):
    a = -0.5
    x = np.abs(x)
    inner = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    outer = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, inner, np.where(x < 2.0, outer, 0.0))


def _coefficients(in_size, in0, in1, out_size):
    """precompute_coeffs + normalize_coeffs_8bpc of Pillow's Resample.c:
    -> (first source index (out,), int64 coefficients (out, ksize))."""
    scale = float(np.float32(in1) - np.float32(in0)) / out_size
    filterscale = max(scale, 1.0)
    support = _BICUBIC_SUPPORT * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = float(np.float32(in0)) + (np.arange(out_size) + 0.5) * scale
    # C's (int) truncates toward zero
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5),
                      in_size).astype(np.int64) - xmin
    x = np.arange(ksize)
    w = _bicubic(((x[None, :] + xmin[:, None]) - center[:, None] + 0.5)
                 * (1.0 / filterscale))
    w = np.where(x[None, :] < xmax[:, None], w, 0.0)
    ww = np.cumsum(w, axis=1)[:, -1:]      # summed in order, as in C
    w = np.where(ww != 0.0, w / np.where(ww != 0.0, ww, 1.0), w)
    k = w * (1 << _PRECISION_BITS)
    k = np.trunc(np.where(k < 0, k - 0.5, k + 0.5)).astype(np.int64)
    return xmin, k


def _pass(px, in0, in1, out_size):
    """One 8-bit resampling pass along axis 1 of (rows, in) uint8."""
    xmin, k = _coefficients(px.shape[1], in0, in1, out_size)
    src = px.astype(np.int64)
    acc = np.full((px.shape[0], out_size), 1 << (_PRECISION_BITS - 1),
                  np.int64)
    last = px.shape[1] - 1
    for j in range(k.shape[1]):
        idx = np.minimum(xmin + j, last)
        acc += src[:, idx] * k[None, :, j]
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bicubic(px, size, box=None):
    """PIL's `Image.resize(size, BICUBIC, box)` of a uint8 (H, W) image;
    `size` is (width, height), `box` (x0, y0, x1, y1) floats."""
    h, w = px.shape
    out_w, out_h = size
    if box is None:
        box = (0, 0, w, h)
    if (out_w, out_h) == (w, h) and tuple(box) == (0, 0, w, h):
        return px.copy()
    box = [float(np.float32(v)) for v in box]
    # ImagingResampleInner: the rows the vertical pass reads, resampled
    # horizontally first
    if out_w != w or box[0] or box[2] != out_w:
        px = _pass(px, box[0], box[2], out_w)
    if out_h != h or box[1] or box[3] != out_h:
        px = _pass(np.ascontiguousarray(px.T), box[1], box[3], out_h).T
    return np.ascontiguousarray(px)


def _block_mean(blocks):
    """Pillow's Reduce.c average of (..., n) uint8 sums: (sum + n / 2) x
    multiplier >> 24, with multiplier = (UINT32)(2^32f / (256 n))."""
    n = blocks.shape[-1]
    mult = int(np.float32(4294967296.0) / np.float32(256 * n))
    s = blocks.astype(np.uint64).sum(axis=-1) + n // 2
    return (((s * mult) & 0xFFFFFFFF) >> 24).astype(np.uint8)


def reduce(px, fx, fy):
    """PIL's `Image.reduce((fx, fy))` of a uint8 (H, W) image: the mean
    of each fx x fy block, the partial blocks of the right column and
    the bottom row over the pixels they hold."""
    h, w = px.shape
    out = np.empty((-(-h // fy), -(-w // fx)), np.uint8)
    nh, nw = h // fy, w // fx
    full = px[: nh * fy, : nw * fx].reshape(nh, fy, nw, fx) \
        .transpose(0, 2, 1, 3).reshape(nh, nw, fy * fx)
    out[:nh, :nw] = _block_mean(full)
    if w % fx:
        right = px[: nh * fy, nw * fx:].reshape(nh, fy * (w % fx))
        out[:nh, nw] = _block_mean(right)
    if h % fy:
        bottom = px[nh * fy:, : nw * fx].reshape(h % fy, nw, fx) \
            .transpose(1, 0, 2).reshape(nw, (h % fy) * fx)
        out[nh, :nw] = _block_mean(bottom)
    if w % fx and h % fy:
        out[nh, nw] = _block_mean(px[nh * fy:, nw * fx:].reshape(-1))
    return out


def thumbnail_size(w, h, max_size):
    """`Image.thumbnail`'s aspect-preserving size within max_size x
    max_size; None where the page already fits."""
    x = y = int(math.floor(max_size))
    if x >= w and y >= h:
        return None

    def round_aspect(number, key):
        return max(min(math.floor(number), math.ceil(number), key=key), 1)

    aspect = w / h
    if x / y >= aspect:
        x = round_aspect(y * aspect, key=lambda n: abs(aspect - n / y))
    else:
        y = round_aspect(x / aspect,
                         key=lambda n: 0 if n == 0 else abs(aspect - x / n))
    return x, y


# PIL's `Image.thumbnail` default
REDUCING_GAP = 2.0
# the JAX module's JPEG quality
QUALITY = 85


def thumbnail(px, max_size=1024):
    """PIL's `Image.thumbnail((max_size, max_size))` (BICUBIC) of a uint8
    (H, W) page."""
    h, w = px.shape
    size = thumbnail_size(w, h, max_size)
    if size is None or size == (w, h):
        return px.copy()
    box = (0, 0, w, h)
    fx = int(w / size[0] / REDUCING_GAP) or 1
    fy = int(h / size[1] / REDUCING_GAP) or 1
    if fx > 1 or fy > 1:
        # the safe box of (0, 0, w, h) is the whole page
        px = reduce(px, fx, fy)
        box = (0, 0, w / fx, h / fy)
    return resize_bicubic(px, size, box)


class ThumbnailProcessor(PageProcessor):
    def __init__(self, options):
        super().__init__(options)
        self._max_size = options.get("max_size", 1024)

    @property
    def processor_name(self):
        return "origami_tpu.batch.utils.thumbnail"

    def artifacts(self):
        return [("output", Output(Artifact.THUMBNAIL))]

    def process(self, page_path, output):
        from origami_tpu_torch.core import _image, _jpeg
        _jpeg.write(output.path(Artifact.THUMBNAIL),
                    thumbnail(_image.read_gray(page_path), self._max_size),
                    QUALITY, comment=_image.comment(page_path))


def add_options(p):
    p.add_argument("--max-size", type=int, default=1024)


def main(argv=None):
    return run_cli(ThumbnailProcessor, argv,
                   "python -m origami_tpu_torch.batch.utils.thumbnail",
                   "Write thumbnails for all pages in DATA_PATH.", add_options)


if __name__ == "__main__":
    main()
