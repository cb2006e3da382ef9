"""Device binarization: Sauvola (a hand-written CUDA kernel) and Otsu.

Port of origami_tpu/ops/binarize.py (the page-level functions; the
separator-whitening variants belong to the layout stage).

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

from origami_tpu_torch.ops.remap import (_check, _device_of, _div, _launch,
                                          _ptr)

launches = {"sauvola": 0, "sauvola_packed": 0}

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
        launches[name] += 1
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
