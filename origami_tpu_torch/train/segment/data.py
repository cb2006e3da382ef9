"""Training-tile generation: corpus of (image, label) pages -> tile
datasets with class weights and k-fold splits.

Port of origami_tpu/train/segment/data.py. Pages are read with the port's
image readers (`core/_image.py`), label maps with its PNG reader
(`core/_png.py`; a paletted label PNG gives its indices, as PIL does)
and tiles written with its writer. The JAX
module resizes with cv2's INTER_AREA (pages) and INTER_NEAREST (labels);
`resize_area_u8` and `resize_nearest_u8` are cv2-free ports that give
cv2's bytes on uint8 images (tests/test_torch_train_data.py):

  * INTER_AREA shrinking both axes by integer factors: the block mean
    (2 x 2: (sum + 2) >> 2, as cv2's vector path; others sum / area,
    rounded half to even);
  * INTER_AREA shrinking both axes otherwise: cv2's area table, summed
    in float32 in cv2's order, rounded half to even;
  * INTER_AREA enlarging either axis: not an area filter. cv2 takes its
    bilinear path with "area" weights (source x = floor(dx * scale),
    weight frac((dx + 1) - (x + 1) / scale), 0 where that is <= 0), in
    11-bit fixed point: a horizontal pass to int32, then the vertical
    pass's ((b0 (S0 >> 4)) >> 16) + ((b1 (S1 >> 4)) >> 16) + 2) >> 2;
  * INTER_NEAREST: source = min(floor(d * scale), n - 1), scale =
    1 / (dst / src) in double;
  * INTER_LINEAR (`resize_linear_u8`, train/synth.py's strips): source
    x = (dx + 0.5) scale - 0.5 in float32, weights 1 - frac and frac in
    11-bit fixed point, then the same two passes. A column off the image
    is clamped with weight 1 on the edge; a row off it is not: both its
    taps read the edge row with their weights, rounded apart.

`gaussian_blur_u8` is cv2.GaussianBlur(img, (0, 0), sigma) on uint8:
ksize round(6 sigma + 1) | 1, the kernel's side taps rounded to 8
fractional bits from the outside in with the rounding error carried to
the next tap, the centre 1 minus their sum, the row pass exact in
integers, the column pass (sum + 2^15) >> 16, borders reflected
without the edge (BORDER_REFLECT_101): cv2's bit-exact fixed-point path.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np

from origami_tpu_torch.core import _image, _png
from origami_tpu_torch.ops.tiling import TileLayout


# ---------------------------------------------------------------------------
# cv2.resize on uint8, without cv2
# ---------------------------------------------------------------------------

def _round_u8(v):
    """cv2's saturate_cast<uchar> of a float: rounded half to even,
    clipped to [0, 255]."""
    return np.clip(np.rint(v), 0, 255).astype(np.uint8)


def _nearest_index(n_src, n_dst):
    scale = 1.0 / (n_dst / n_src)
    return np.minimum(np.floor(np.arange(n_dst) * scale).astype(np.int64),
                      n_src - 1)


def resize_nearest_u8(img, size):
    """cv2.resize(img, size, interpolation=cv2.INTER_NEAREST); size is
    (W, H)."""
    w, h = int(size[0]), int(size[1])
    ys = _nearest_index(img.shape[0], h)
    xs = _nearest_index(img.shape[1], w)
    return np.ascontiguousarray(img[ys][:, xs])


def _area_linear_taps(n_src, n_dst):
    """cv2's bilinear taps in INTER_AREA mode along one axis: (first
    source index, int16 weight of it, of the next) at 11 bits."""
    inv = n_dst / n_src
    scale = 1.0 / inv
    sx = np.zeros(n_dst, np.int64)
    a = np.zeros((n_dst, 2), np.int32)
    for d in range(n_dst):
        s = math.floor(d * scale)
        f = np.float32((d + 1) - (s + 1) * inv)
        f = np.float32(0.0) if f <= 0 else np.float32(f - np.floor(f))
        if s >= n_src - 1:
            s, f = n_src - 1, np.float32(0.0)
        sx[d] = s
        c = np.array([np.float32(1.0) - f, f], np.float32)
        a[d] = np.clip(np.rint(c * np.float32(2048.0)), -32768, 32767)
    return sx, a


def _resize_area_linear(img, w, h):
    return _two_pass(img, _area_linear_taps(img.shape[1], w),
                     _area_linear_taps(img.shape[0], h))


def _linear_taps(n_src, n_dst, clamp):
    """cv2's INTER_LINEAR taps along one axis: (first source index, int16
    weight of it, of the next) at 11 bits. With `clamp` (columns) a tap
    off the image becomes weight 1 on the edge; without (rows) the
    index may be -1 or n_src - 1 with its fraction kept."""
    scale = 1.0 / (n_dst / n_src)
    f = ((np.arange(n_dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    if clamp:
        f[s < 0] = 0
        s[s < 0] = 0
        edge = s >= n_src - 1
        f[edge] = 0
        s[edge] = n_src - 1
    c = np.stack([np.float32(1.0) - f, f], axis=1)
    return s, np.rint(c * np.float32(2048.0)).astype(np.int32)


def _two_pass(img, taps_x, taps_y):
    """cv2's fixed-point bilinear passes over (source index, weights)
    taps of each axis; source indices are clipped to the image."""
    sx, ax = taps_x
    sy, ay = taps_y
    src = img.astype(np.int64)
    x1 = np.minimum(sx + 1, img.shape[1] - 1)
    rows = src[:, sx] * ax[:, 0] + src[:, x1] * ax[:, 1]     # (H_src, w)
    y0 = np.clip(sy, 0, img.shape[0] - 1)
    y1 = np.clip(sy + 1, 0, img.shape[0] - 1)
    s0, s1 = rows[y0] >> 4, rows[y1] >> 4
    b0, b1 = ay[:, 0, None], ay[:, 1, None]
    out = (((b0 * s0) >> 16) + ((b1 * s1) >> 16) + 2) >> 2
    return out.astype(np.uint8)


def resize_linear_u8(img, size):
    """cv2.resize(img, size, interpolation=cv2.INTER_LINEAR) of a uint8
    (H, W) image; size is (W, H)."""
    w, h = int(size[0]), int(size[1])
    img = np.asarray(img, np.uint8)
    if (h, w) == img.shape:
        return img.copy()
    return _two_pass(img, _linear_taps(img.shape[1], w, True),
                     _linear_taps(img.shape[0], h, False))


def _gaussian_taps(sigma):
    """cv2's fixed-point Gaussian kernel for uint8 (8 fractional bits)."""
    n = int(round(sigma * 6 + 1)) | 1
    scale2 = -0.125 / (sigma * sigma)
    values = [math.exp(float(x * x) * scale2)
              for x in range(1 - n, -1, 2)]
    total = 2 * sum(values) + 1.0
    side, err = [], 0.0
    for v in values:
        adj = v / total * 256 + err
        side.append(int(round(adj)))
        err = adj - side[-1]
    return np.asarray(side + [256 - 2 * sum(side)] + side[::-1], np.int64)


def gaussian_blur_u8(img, sigma):
    """cv2.GaussianBlur(img, (0, 0), sigmaX=sigma) of a uint8 (H, W)
    image."""
    img = np.asarray(img, np.uint8)
    k = _gaussian_taps(float(sigma))
    r = len(k) // 2
    h, w = img.shape
    kx, ky = (r if w > 1 else 0), (r if h > 1 else 0)
    src = np.pad(img.astype(np.int64), ((ky, ky), (kx, kx)),
                 mode="reflect")
    # a one-pixel axis is not blurred (cv2 takes ksize 1 there)
    one = np.array([256], np.int64)
    kr = k if kx else one
    kc = k if ky else one
    rows = sum(kr[i] * src[:, i: i + w] for i in range(len(kr)))
    out = sum(kc[i] * rows[i: i + h] for i in range(len(kc)))
    return ((out + (1 << 15)) >> 16).astype(np.uint8)


def _area_table(n_src, n_dst, scale):
    """cv2's computeResizeAreaTab: [(dst index, src index, weight)] in
    cv2's order."""
    tab = []
    for d in range(n_dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, n_src - f1)
        s1, s2 = math.ceil(f1), math.floor(f2)
        s2 = min(s2, n_src - 1)
        s1 = min(s1, s2)
        if s1 - f1 > 1e-3:
            tab.append((d, s1 - 1, np.float32((s1 - f1) / cell)))
        for s in range(s1, s2):
            tab.append((d, s, np.float32(1.0 / cell)))
        if f2 - s2 > 1e-3:
            tab.append((d, s2, np.float32(min(min(f2 - s2, 1.0), cell)
                                          / cell)))
    return tab


def _resize_area_general(img, w, h):
    scale_x = 1.0 / (w / img.shape[1])
    scale_y = 1.0 / (h / img.shape[0])
    xtab = _area_table(img.shape[1], w, scale_x)
    ytab = _area_table(img.shape[0], h, scale_y)
    # the horizontal pass in cv2's order: each output column sums its
    # taps left to right in float32
    by_col = [[] for _ in range(w)]
    for d, s, a in xtab:
        by_col[d].append((s, a))
    depth = max(len(t) for t in by_col)
    src = img.astype(np.float32)
    xs = np.zeros((depth, w), np.int64)
    xa = np.zeros((depth, w), np.float32)
    for d, taps in enumerate(by_col):
        for j, (s, a) in enumerate(taps):
            xs[j, d], xa[j, d] = s, a
    rows = np.zeros((img.shape[0], w), np.float32)
    for j in range(depth):
        rows = rows + src[:, xs[j]] * xa[j]
    out = np.zeros((h, w), np.float32)
    for d, s, b in ytab:
        out[d] = out[d] + b * rows[s]
    return _round_u8(out)


def _resize_area_fast(img, ix, iy):
    h, w = img.shape[0] // iy, img.shape[1] // ix
    blocks = img[:h * iy, :w * ix].astype(np.int64) \
        .reshape(h, iy, w, ix).sum(axis=(1, 3))
    if ix == 2 and iy == 2:
        return ((blocks + 2) >> 2).astype(np.uint8)
    scale = np.float32(1.0) / np.float32(ix * iy)
    return _round_u8(blocks.astype(np.float32) * scale)


def resize_area_u8(img, size):
    """cv2.resize(img, size, interpolation=cv2.INTER_AREA) of a uint8
    (H, W) image; size is (W, H)."""
    w, h = int(size[0]), int(size[1])
    img = np.asarray(img, np.uint8)
    if (h, w) == img.shape:
        return img.copy()
    scale_x = 1.0 / (w / img.shape[1])
    scale_y = 1.0 / (h / img.shape[0])
    if scale_x >= 1 and scale_y >= 1:
        ix, iy = int(round(scale_x)), int(round(scale_y))
        if abs(scale_x - ix) < np.finfo(np.float64).eps \
                and abs(scale_y - iy) < np.finfo(np.float64).eps:
            return _resize_area_fast(img, ix, iy)
        return _resize_area_general(img, w, h)
    return _resize_area_linear(img, w, h)


# ---------------------------------------------------------------------------
# the JAX module's functions
# ---------------------------------------------------------------------------

def read_labels(path):
    """A label PNG as PIL gives it: a paletted PNG's indices, else its
    (first) channel."""
    with open(path, "rb") as f:
        data = f.read()
    if data[25] == 3:        # IHDR colour type: paletted
        return _png.decode_paletted(data)[0]
    px = _png.read(path)
    return px if px.ndim == 2 else px[..., 0]


def page_pairs(corpus_dir, kind):
    """Yield (image_path, label_path) pairs for one network kind."""
    corpus_dir = Path(corpus_dir)
    for img in sorted(corpus_dir.glob("*.png")):
        if ".labels." in img.name:
            continue
        lab = img.with_name(img.stem + ".labels.%s.png" % kind)
        if lab.exists():
            yield img, lab


def class_weights(label_maps, num_classes):
    """Median-frequency class weights (reference main.py:302-319)."""
    freqs = np.zeros(num_classes, dtype=np.float64)
    for lab in label_maps:
        freqs += np.bincount(np.asarray(lab).flatten(),
                             minlength=num_classes)[:num_classes]
    total = freqs.sum()
    if total == 0:
        return np.ones(num_classes)
    freqs = freqs / total
    med = np.median(freqs[freqs > 0])
    w = np.where(freqs > 0, med / np.maximum(freqs, 1e-9), 0.0)
    return w / max(w.max(), 1e-9) * 10.0


def k_folds(names, k=5, seed=0):
    """Deterministic k-fold split (reference gen/folds.py)."""
    rng = np.random.default_rng(seed)
    names = sorted(names)
    order = rng.permutation(len(names))
    folds = [[] for _ in range(k)]
    for i, idx in enumerate(order):
        folds[i % k].append(names[idx])
    return [sorted(f) for f in folds]


def load_pair(img_path, lab_path, full_size):
    """A page (gray) and its label map at the net canvas `full_size`
    (W, H): INTER_AREA for the page, INTER_NEAREST for the labels."""
    img = _image.read_gray(img_path)
    lab = read_labels(lab_path)
    return resize_area_u8(img, full_size), resize_nearest_u8(lab, full_size)


class TileDataset:
    """Generates training tiles for one kind; optionally augmented
    (each augmented variant warped on `device` by `WarpAugmentation`,
    through the remap kernel)."""

    def __init__(self, corpus_dir, label_set, kind,
                 full_size=(1280, 2400), tile_size=(1280, 896), beta0=50,
                 augmentations=1, warp_amplitude=12.0, seed=0,
                 device=None):
        self.kind = kind
        self.label_set = label_set
        self.layout = TileLayout(full_size, tile_size, beta0)
        self.full_size = full_size
        self.tile_size = tile_size
        self.pairs = list(page_pairs(corpus_dir, kind))
        self.augmentations = augmentations
        self.warp_amplitude = warp_amplitude
        self.seed = seed
        self.device = device

    def _load_pair(self, img_path, lab_path):
        return load_pair(img_path, lab_path, self.full_size)

    def tiles(self):
        """Yield (name, tile_image (th, tw), tile_labels (th, tw))."""
        from origami_tpu_torch.train.segment.warp import WarpAugmentation
        aug = WarpAugmentation(self.warp_amplitude, seed=self.seed,
                               device=self.device) \
            if self.augmentations > 1 else None
        for img_path, lab_path in self.pairs:
            img, lab = self._load_pair(img_path, lab_path)
            variants = [("", img, lab)]
            for a in range(1, self.augmentations):
                im2, lab2 = aug(img, lab)
                variants.append((".warp%d" % a, im2, lab2))
            for suffix, im, lb in variants:
                for i, t in enumerate(self.layout.tiles):
                    x0, y0, x1, y1 = t["outer"]
                    yield ("%s%s.t%d" % (img_path.stem, suffix, i),
                           im[y0:y1, x0:x1], lb[y0:y1, x0:x1])

    def generate(self, out_dir):
        """Write tiles + weights.json + codes.json + folds.json."""
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        names = []
        labels_seen = []
        for name, tile_img, tile_lab in self.tiles():
            _png.write_gray(out_dir / (name + ".png"), tile_img)
            _png.write_gray(out_dir / (name + ".labels.png"),
                            tile_lab.astype(np.uint8))
            names.append(name)
            labels_seen.append(tile_lab)
        n_cls = self.label_set.num_classes(self.kind)
        w = class_weights(labels_seen, n_cls)
        (out_dir / "weights.json").write_text(json.dumps(
            dict(weights=w.tolist())))
        (out_dir / "codes.json").write_text(json.dumps(
            self.label_set.classes_dict(self.kind)))
        page_names = sorted(set(n.split(".")[0] for n in names))
        (out_dir / "folds.json").write_text(json.dumps(
            dict(folds=k_folds(page_names))))
        return names


def load_tile_batch(out_dir, names, tile_hw):
    """Load a batch of generated tiles as (images, labels) arrays."""
    out_dir = Path(out_dir)
    th, tw = tile_hw
    images = np.zeros((len(names), th, tw, 1), np.float32)
    labels = np.zeros((len(names), th, tw), np.int32)
    for i, n in enumerate(names):
        im = _png.read_gray(out_dir / (n + ".png"))
        lb = read_labels(out_dir / (n + ".labels.png"))
        images[i, : im.shape[0], : im.shape[1], 0] = im / 255.0
        labels[i, : lb.shape[0], : lb.shape[1]] = lb
    return images, labels
