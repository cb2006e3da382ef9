"""Device binarization: Sauvola (a hand-written CUDA kernel), Otsu, and
the layout stage's Sauvola with separators whitened.

Port of origami_tpu/ops/binarize.py.

`sauvola` and `sauvola_packed` wrap the kernel of csrc/sauvola.cu, which
replaces the Pallas kernel `sauvola_pallas`
(origami_tpu/ops/pallas/sauvola.py) and the XLA integral-image route the
JAX main path runs. Both take any odd window: a box larger than the page
is the page. The kernel slides each column's box sums down a band of
rows and scans them along each row, so a pixel costs the same at every
window; neither an integral image nor the unpacked mask reaches device
memory (the packed mask comes from a warp ballot). Each wrapper sits
beside its plain PyTorch version (`*_plain`), which has the same
signature and arithmetic: exact integer box sums, then the float formula
in the order `_sauvola_kernel` writes it. A wrapper given a CPU tensor
computes the plain version (the CPU tests run it); given a CUDA tensor
it launches the kernel on the current stream or raises; it never falls
back. `launches[name]` counts kernel launches.

`border` says what the window does at the page's edge: "clamp" clips the
box to the page and divides by the clipped area (ops/binarize.sauvola,
the main path), "zero" counts pixels outside the page as 0 and always
divides by window^2 (sauvola_pallas).

The box sums here are exact, while the JAX route takes them from float32
integral images of the whole page, whose differences carry rounding
error: the two agree on all but a few pixels per ten thousand
(tests/test_torch_binarize.py), not bit for bit.
"""

from __future__ import annotations

import torch

from origami_tpu_torch.ops.remap import (LaunchCounts, _check, _device_of,
                                         _div, _launch, _ptr)

launches = LaunchCounts(sauvola=0, sauvola_packed=0)

_BORDERS = {"zero": 0, "clamp": 1}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _window_sums(image, window):
    """Exact sums of v and v^2 over the window x window box around each
    pixel, the box clipped to the page (pixels outside add nothing), and
    the clipped box's area. int64 (H, W) each."""
    h, w = image.shape
    rad = window // 2
    v = image.to(torch.int64)
    dev = image.device

    def integral(a):
        s = torch.cumsum(torch.cumsum(a, dim=0), dim=1)
        return torch.nn.functional.pad(s, (1, 0, 1, 0))

    ys = torch.arange(h, device=dev)
    xs = torch.arange(w, device=dev)
    y0 = (ys - rad).clamp(0, h)[:, None]
    y1 = (ys + rad + 1).clamp(0, h)[:, None]
    x0 = (xs - rad).clamp(0, w)[None, :]
    x1 = (xs + rad + 1).clamp(0, w)[None, :]

    def box(s):
        return s[y1, x1] - s[y0, x1] - s[y1, x0] + s[y0, x0]

    return box(integral(v)), box(integral(v * v)), (y1 - y0) * (x1 - x0)


def _check_args(image, window_size, border):
    if image.dtype != torch.uint8 or image.dim() != 2:
        raise TypeError("image must be a uint8 (H, W) tensor, got %s %s"
                        % (image.dtype, tuple(image.shape)))
    window_size = int(window_size)
    if window_size < 1 or window_size % 2 == 0:
        raise ValueError("window_size must be odd and at least 1, got %d"
                         % window_size)
    if border not in _BORDERS:
        raise ValueError("border must be 'clamp' or 'zero', got %r"
                         % (border,))
    return window_size


def sauvola_threshold(image, window_size=15, k=0.2, r=128.0,
                      border="clamp"):
    """Per-pixel Sauvola threshold T = m * (1 + k ((s / r) - 1)), f32."""
    window_size = _check_args(image, window_size, border)
    s1, s2, area = _window_sums(image, window_size)
    if border == "zero":
        area = torch.full_like(area, window_size * window_size)
    counts = area.float()
    mean = s1.float() / counts
    var = torch.clamp(s2.float() / counts - mean * mean, min=0.0)
    std = torch.sqrt(var)
    return mean * (1.0 + float(k) * (_div(std, r) - 1.0))


def sauvola_plain(image, window_size=15, k=0.2, r=128.0, border="clamp"):
    """(H, W) bool, True where pixel > threshold (ink False, paper
    True)."""
    return image.float() > sauvola_threshold(image, window_size, k, r,
                                             border)


def pack_bits(mask):
    """(H, W) bool -> (H, ceil(W/8)) uint8, bit 7-i of byte j =
    mask[:, 8j+i] (numpy.packbits' big-endian convention)."""
    h, w = mask.shape
    pw = -(-w // 8) * 8
    m = torch.nn.functional.pad(mask.to(torch.uint8), (0, pw - w))
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.uint8,
                           device=mask.device)
    return (m.reshape(h, pw // 8, 8) * weights).sum(dim=-1) \
        .to(torch.uint8)


def unpack_bits(packed, out_w):
    """Inverse of pack_bits: (H, PW) uint8 -> (H, out_w) bool."""
    h, pw = packed.shape
    shifts = torch.tensor([7, 6, 5, 4, 3, 2, 1, 0], dtype=torch.uint8,
                          device=packed.device)
    bits = (packed[:, :, None] >> shifts) & 1
    return bits.reshape(h, pw * 8)[:, :out_w].bool()


def sauvola_packed_plain(image, window_size=15, k=0.2, r=128.0,
                         border="clamp"):
    return pack_bits(sauvola_plain(image, window_size, k, r, border))


def otsu_threshold(image):
    """Otsu's method over a 256-bin histogram (image in [0, 255]); the
    threshold as a 0-dim f32 tensor (ops/binarize.py:73-89)."""
    hist = torch.bincount(image.reshape(-1).long().clamp(0, 255),
                          minlength=256).float()
    total = hist.sum()
    bins = torch.arange(256, dtype=torch.float32, device=image.device)
    w0 = torch.cumsum(hist, dim=0)
    w1 = total - w0
    sum0 = torch.cumsum(hist * bins, dim=0)
    m0 = sum0 / w0.clamp(min=1e-6)
    m1 = (sum0[-1] - sum0) / w1.clamp(min=1e-6)
    between = w0 * w1 * (m0 - m1) ** 2
    between = torch.where((w0 > 0) & (w1 > 0), between,
                          torch.full_like(between, -1.0))
    return torch.argmax(between).float()


def otsu(image):
    return image.float() > otsu_threshold(image)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _sauvola_launch(name, image, window_size, k, r, border, packed):
    dev = _device_of(image)
    window_size = _check_args(image, window_size, border)
    _check(image, "image", torch.uint8, 2, dev)
    h, w = image.shape
    shape = (h, -(-w // 8)) if packed else (h, w)
    out = torch.empty(shape, dtype=torch.uint8, device=dev)
    if out.numel():
        _launch("origami_sauvola_u8", _ptr(image), h, w, window_size,
                float(k), float(r), _BORDERS[border], int(packed), _ptr(out))
        launches.add(name)
    return out


def sauvola(image, window_size=15, k=0.2, r=128.0, border="clamp"):
    """u8 page (H, W) -> (H, W) bool, True = paper."""
    if _device_of(image).type == "cpu":
        return sauvola_plain(image, window_size, k, r, border)
    return _sauvola_launch("sauvola", image, window_size, k, r, border,
                           False).view(torch.bool)


def sauvola_packed(image, window_size=15, k=0.2, r=128.0, border="clamp"):
    """u8 page (H, W) -> the Sauvola mask bit-packed, (H, ceil(W/8)) u8
    in numpy.packbits order; the unpacked mask is never stored."""
    if _device_of(image).type == "cpu":
        return sauvola_packed_plain(image, window_size, k, r, border)
    return _sauvola_launch("sauvola_packed", image, window_size, k, r,
                           border, True)


# ---------------------------------------------------------------------------
# the layout stage: Sauvola with the separator pixels whitened
# ---------------------------------------------------------------------------
#
# The JAX stage's three routes (ops/binarize.py:169-236 there) binarize the
# page with Sauvola and OR in the separator label mask, moved from the
# warped page's label space onto the binarized page, thresholded and
# dilated by a 3x3 box. They are composed here from PyTorch ops around the
# Sauvola kernel (sauvola_packed) and, for the dewarped page, the remap
# kernel (ops.remap.remap): nothing is fused into a kernel. `sep_mask` is
# the (lh, lw) bool label mask on the page's device; each function returns
# the (H, ceil(W/8)) u8 packed mask, True = paper or separator.

# jax.image.resize(..., "linear") antialiases where it shrinks, by
# default: that is the port's "area" method
_JAX_LINEAR = "area"


def _whiten(packed, sep):
    """packed | pack(3x3 max of sep > 0.5) for a float (H, W) map."""
    d = torch.nn.functional.max_pool2d(sep[None, None], 3, stride=1,
                                       padding=1)[0, 0]
    return packed | pack_bits(d > 0.5)


def binarize_sep_dewarped_packed(image, window_size, sep_mask, hv, res,
                                 warp_h, warp_w):
    """The dewarped page `image` (u8, (H, W)), grid `hv` ((gh, gw, 2)
    f32, gh*res = H, gw*res = W): the mask is resized onto the warped
    page (warp_h, warp_w), dewarped through the grid by the remap kernel
    (taps outside the warped page read 0) and thresholded at 0.2 (the
    JAX function: binarize_sep_banded_packed, which dewarps by its banded
    two-pass route)."""
    from origami_tpu_torch.ops.remap import _upsample_grid, remap
    from origami_tpu_torch.ops.resize import resize
    packed = sauvola_packed(image, window_size)
    sep = resize(sep_mask.float(), (warp_h, warp_w), _JAX_LINEAR)
    mx, my = _upsample_grid(hv.float(), int(res))
    sepd = remap(sep.contiguous(), torch.stack([mx, my], dim=-1), fill=0.0)
    return _whiten(packed, (sepd > 0.2).float())


def binarize_sep_resized_packed(image, window_size, sep_mask):
    """No grid: the mask is only resized onto the page, then thresholded
    at 0.2 (binarize_sep_resized_packed)."""
    from origami_tpu_torch.ops.resize import resize
    packed = sauvola_packed(image, window_size)
    sep = resize(sep_mask.float(), tuple(image.shape), _JAX_LINEAR)
    return _whiten(packed, (sep > 0.2).float())


def binarize_with_separators_packed(image, window_size, sep_mask, hv, res,
                                    warp_h, warp_w):
    """A grid the JAX stage has no banded plan for: each dewarped pixel
    maps through the grid (bilinear in the sample lattice, clamped to it)
    into the label mask, nearest sample (binarize_with_separators)."""
    packed = sauvola_packed(image, window_size)
    h, w = image.shape
    gh, gw = hv.shape[:2]
    lh, lw = sep_mask.shape
    dev = image.device
    hv = hv.float()
    gy = _div(torch.arange(h, dtype=torch.float32, device=dev), res) \
        .clamp(0.0, gh - 1 - 1e-6)
    gx = _div(torch.arange(w, dtype=torch.float32, device=dev), res) \
        .clamp(0.0, gw - 1 - 1e-6)
    y0, x0 = torch.floor(gy).long(), torch.floor(gx).long()
    ty = (gy - y0)[:, None]
    tx = (gx - x0)[None, :]

    def interp(g):
        top = g[y0][:, x0] * (1 - tx) + g[y0][:, x0 + 1] * tx
        bot = g[y0 + 1][:, x0] * (1 - tx) + g[y0 + 1][:, x0 + 1] * tx
        return top * (1 - ty) + bot * ty

    wx, wy = interp(hv[..., 0]), interp(hv[..., 1])
    mi = torch.round(wy * (lh / warp_h)).long().clamp(0, lh - 1)
    mj = torch.round(wx * (lw / warp_w)).long().clamp(0, lw - 1)
    return _whiten(packed, sep_mask.float()[mi, mj])
