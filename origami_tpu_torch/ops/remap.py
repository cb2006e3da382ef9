"""Bilinear remap, page dewarp and line-strip extraction.

Each function here wraps one hand-written CUDA kernel (csrc/remap.cu,
csrc/strips.cu) and sits beside its plain PyTorch version, which has the
same signature and arithmetic:

    remap               ports remap_pallas (ops/pallas/remap.py:415)
                        through a dense map (no stage calls it: the
                        layout stage takes dewarp_f32)
    remap_batch         the same kernel over a batch in one launch, at
                        the training warp's border (bilinear_sample_xy,
                        train/segment/warp.py:44)
    dewarp_u8           ports the dewarp of core/dewarp.py:504-531
    dewarp_f32          the same dewarp of an f32 image at the fill_taps
                        border: remap through the upsampled grid, with
                        the grid upsampled inside the kernel (the layout
                        stage's separator mask)
    strips_dewarped     strip mode (a): extract_strips_banded's function
    strips_through_grid strip mode (b): extract_dewarped_strips' function
    affine_warp         an inverse-map affine warp (ops/remap.py:76-85):
                        the remap kernel with each source coordinate
                        computed from the six coefficients, at the hard
                        border (counted as remap_affine)

The strip modes also have a page-level entry (`strips_dewarped_page`,
`strips_through_grid_page`): all (width bucket, profile) groups of a page
in one launch, each group a 16-byte aligned (nb, out_h, wmax) block of
one flat u8 buffer placed by `strip_layout`'s per-strip descriptor. The
group-level entries are the one-group case of the same kernels.

A wrapper given CPU tensors computes the plain version (the CPU tests run
it); given CUDA tensors it launches its kernel on the current stream or
raises — it never falls back. `launches[name]` counts kernel launches.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from origami_tpu_torch.core.math import fma_f32
from origami_tpu_torch.ops import _build


class LaunchCounts(dict):
    """Launch counts by kernel name. `add` holds a lock: the pipelined
    runner launches kernels from several threads at once."""

    _lock = threading.Lock()

    def add(self, name, n=1):
        with self._lock:
            self[name] += n


launches = LaunchCounts(remap=0, remap_batch=0, remap_affine=0, dewarp_u8=0,
                        dewarp_f32=0, strips_dewarped=0,
                        strips_through_grid=0)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _taps(img, yi, xi, fill):
    """img[yi, xi] where inside the image, else fill."""
    h, w = img.shape
    inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    v = img.reshape(-1)[(yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1))]
    return torch.where(inside, v, torch.full_like(v, fill))


def _bilinear_fill_taps(img, x, y, fill):
    """Bilinear sample; each tap outside the image reads `fill`."""
    fx, fy = torch.floor(x), torch.floor(y)
    tx, ty = x - fx, y - fy
    x0, y0 = fx.long(), fy.long()
    top = _taps(img, y0, x0, fill) * (1 - tx) \
        + _taps(img, y0, x0 + 1, fill) * tx
    bot = _taps(img, y0 + 1, x0, fill) * (1 - tx) \
        + _taps(img, y0 + 1, x0 + 1, fill) * tx
    return top * (1 - ty) + bot * ty


def _bilinear_hard_edge(img, x, y, fill):
    """ops/remap.bilinear_sample_xy: taps clamped into the image, the
    sample `fill` outside [0, w-1] x [0, h-1]."""
    h, w = img.shape
    fx, fy = torch.floor(x), torch.floor(y)
    tx, ty = x - fx, y - fy
    x0 = fx.long().clamp(0, w - 1)
    y0 = fy.long().clamp(0, h - 1)
    x1 = (fx.long() + 1).clamp(0, w - 1)
    y1 = (fy.long() + 1).clamp(0, h - 1)
    flat = img.reshape(-1)
    top = flat[y0 * w + x0] * (1 - tx) + flat[y0 * w + x1] * tx
    bot = flat[y1 * w + x0] * (1 - tx) + flat[y1 * w + x1] * tx
    out = top * (1 - ty) + bot * ty
    inb = (x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1)
    return torch.where(inb, out, torch.full_like(out, fill))


def _div(a, b):
    """a / b, correctly rounded on every device: CUDA turns division by
    a Python scalar into multiplication by its reciprocal, which the
    kernels (and the JAX reference) do not do."""
    return a / torch.full((), float(b), dtype=a.dtype, device=a.device)


def _to_u8_round(v):
    return torch.clamp(torch.round(v), 0.0, 255.0).to(torch.uint8)


def _sample(image, x, y, fill, border):
    """One bilinear sample of f32 `image` (H, W) at the (x, y) planes
    under `border` (REMAP_BORDERS)."""
    if border == "hard":
        return _bilinear_hard_edge(image.float(), x, y, float(fill))
    h, w = image.shape
    return _bilinear_fill_taps(image.float(), x.clamp(-2.0, w + 1.0),
                               y.clamp(-2.0, h + 1.0), float(fill))


def remap_plain(image, map_xy, fill=0.0, border="fill_taps"):
    """cv2.remap-style bilinear sample of f32 `image` (H, W) at `map_xy`
    (H', W', 2) source (x, y) -> f32. border "fill_taps"
    (remap_pallas): coordinates clamped into a fill margin ([-2, w+1] x
    [-2, h+1]), out-of-image taps read `fill`; "hard"
    (bilinear_sample_xy): taps clamped into the image, the sample `fill`
    outside [0, w-1] x [0, h-1]."""
    return _sample(image, map_xy[..., 0], map_xy[..., 1], fill, border)


def remap_batch_plain(images, map_x, map_y, fill=0.0, border="hard"):
    """remap_plain of each image (B, H, W) at its planes map_x, map_y
    (B, H', W') -> f32 (B, H', W')."""
    return torch.stack([_sample(images[b], map_x[b], map_y[b], fill,
                                border) for b in range(images.shape[0])])


def _upsample_grid(hv, res):
    """Index-aligned upsample of the (gh, gw, 2) grid: full[y, x] =
    bilinear(hv at (x/res, y/res)), nearest beyond the last node ->
    (mx, my) planes of (gh*res, gw*res)."""
    gh, gw = hv.shape[:2]
    dev = hv.device
    gy = _div(torch.arange(gh * res, dtype=torch.float32, device=dev), res)
    gx = _div(torch.arange(gw * res, dtype=torch.float32, device=dev), res)
    fy, fx = torch.floor(gy), torch.floor(gx)
    ty, tx = (gy - fy)[:, None], (gx - fx)[None, :]
    y0 = fy.long().clamp(max=gh - 1)
    y1 = (fy.long() + 1).clamp(max=gh - 1)
    x0 = fx.long().clamp(max=gw - 1)
    x1 = (fx.long() + 1).clamp(max=gw - 1)
    planes = []
    for c in (0, 1):
        p = hv[..., c]
        r0 = p[y0][:, x0] * (1 - ty) + p[y1][:, x0] * ty
        r1 = p[y0][:, x1] * (1 - ty) + p[y1][:, x1] * ty
        planes.append(r0 * (1 - tx) + r1 * tx)
    return planes


BORDERS = ("hard", "fill_taps")
# the grid forms' tiles: grid cells a side (csrc/remap.cu kU8Cells,
# kF32Cells), for counting a launch's tiles against staged_tiles
TILE_CELLS = {torch.uint8: 4, torch.float32: 2}


def dewarp_u8_plain(page_u8, hv, res, fill=255.0, border="hard"):
    """The dewarped page u8 (gh*res, gw*res): one bilinear sample of the
    u8 page per output pixel through the upsampled grid. border "hard"
    (the JAX dense route, core/dewarp.py:459-482): `fill` outside
    [0, w-1] x [0, h-1], clipped and truncated. "fill_taps" (the JAX
    banded route, whose passes pad the page with `fill`,
    ops/remap.py:189-275): coordinates clamped into [-2, w+1] x
    [-2, h+1], each tap off the page reads `fill`, rounded and
    clipped."""
    mx, my = _upsample_grid(hv.float(), int(res))
    img = page_u8.float()
    if border == "hard":
        v = _bilinear_hard_edge(img, mx, my, float(fill))
        return torch.clamp(v, 0.0, 255.0).to(torch.uint8)
    h, w = img.shape
    return _to_u8_round(_bilinear_fill_taps(
        img, mx.clamp(-2.0, w + 1.0), my.clamp(-2.0, h + 1.0), float(fill)))


def dewarp_f32_plain(image, hv, res, fill=0.0):
    """The dewarped f32 image (gh*res, gw*res): `image` (H, W) sampled
    through the upsampled grid at the fill_taps border, as remap_plain
    samples it through the map of _upsample_grid."""
    mx, my = _upsample_grid(hv.float(), int(res))
    return _sample(image, mx, my, fill, "fill_taps")


def strips_dewarped_plain(dew_u8, frames, widths, out_h, out_w, fill=255.0):
    """Strip mode (a): N strips (N, out_h, out_w) u8 from the DEWARPED
    page; frames (N, 2, 3) map strip (x, y, 1) -> page coords."""
    h, w = dew_u8.shape
    dev = dew_u8.device
    f = frames.float()
    xs = torch.arange(out_w, dtype=torch.float32, device=dev)[None, None, :]
    ys = torch.arange(out_h, dtype=torch.float32, device=dev)[None, :, None]
    a0 = f[:, 0, 0].clamp(min=1e-6)[:, None, None]
    a1, a2 = f[:, 0, 1, None, None], f[:, 0, 2, None, None]
    b0, b1, b2 = (f[:, 1, k, None, None] for k in range(3))
    px = a0 * xs + a1 * ys + a2
    py = b0 * xs + b1 * ys + b2
    wf = widths.float().clamp(min=2.0)[:, None, None]
    valid = ((px > -0.5) & (px < w - 0.5) & (py > -0.5) & (py < h - 0.5)
             & (xs < wf))
    v = _bilinear_fill_taps(dew_u8.float(), px, py, float(fill))
    return _to_u8_round(torch.where(valid, v, torch.full_like(v, fill)))


def _inverse_grid(hv, res, dx, dy):
    """Bilinear in the sample grid, clamped to its extent."""
    gh, gw = hv.shape[:2]
    gx = _div(dx, res).clamp(0.0, gw - 1 - 1e-6)
    gy = _div(dy, res).clamp(0.0, gh - 1 - 1e-6)
    fx, fy = torch.floor(gx), torch.floor(gy)
    tx, ty = gx - fx, gy - fy
    x0, y0 = fx.long(), fy.long()
    x1, y1 = (x0 + 1).clamp(max=gw - 1), (y0 + 1).clamp(max=gh - 1)
    w00, w01 = (1 - tx) * (1 - ty), tx * (1 - ty)
    w10, w11 = (1 - tx) * ty, tx * ty
    out = []
    for c in (0, 1):
        g = hv[..., c]
        out.append(g[y0, x0] * w00 + g[y0, x1] * w01 + g[y1, x0] * w10
                   + g[y1, x1] * w11)
    return out


def through_grid_coords(hv, res, frames, widths, out_h, out_w):
    """Warped-page (x, y) planes (N, out_h, out_w) of strip mode (b):
    frames map strip pixels to dewarped coords, pushed through the
    inverse grid on the 8-px lattice and lerped; columns past a strip's
    width are sent far off the page."""
    step = 8
    dev = hv.device
    f = frames.float()
    hv = hv.float()
    n = f.shape[0]
    ch, cw = out_h // step + 2, out_w // step + 2
    ys_c = (torch.arange(ch, dtype=torch.float32, device=dev)
            * step)[None, :, None]
    xs_c = (torch.arange(cw, dtype=torch.float32, device=dev)
            * step)[None, None, :]
    dx = f[:, 0, 0, None, None] * xs_c + f[:, 0, 1, None, None] * ys_c \
        + f[:, 0, 2, None, None]
    dy = f[:, 1, 0, None, None] * xs_c + f[:, 1, 1, None, None] * ys_c \
        + f[:, 1, 2, None, None]
    lat = _inverse_grid(hv, float(res), dx, dy)          # 2 x (N, ch, cw)
    wv = torch.arange(step, dtype=torch.float32, device=dev) / step
    planes = []
    for c in lat:
        r = (c[:, :-1, None, :] * (1 - wv)[None, None, :, None]
             + c[:, 1:, None, :] * wv[None, None, :, None])
        r = r.reshape(n, (ch - 1) * step, cw)[:, :out_h]
        r = (r[:, :, :-1, None] * (1 - wv)[None, None, None, :]
             + r[:, :, 1:, None] * wv[None, None, None, :])
        planes.append(r.reshape(n, out_h, (cw - 1) * step)[:, :, :out_w])
    xs = torch.arange(out_w, dtype=torch.float32, device=dev)[None, None, :]
    pad = xs >= widths.float()[:, None, None]
    cx = torch.where(pad, torch.full_like(planes[0], -1e6), planes[0])
    cy = torch.where(pad, torch.full_like(planes[1], -1e6), planes[1])
    return cx, cy


def strips_through_grid_plain(page_u8, hv, res, frames, widths, out_h,
                              out_w, fill=255.0):
    """Strip mode (b): the WARPED page sampled hard-edged at
    through_grid_coords; clip, then truncate to u8."""
    cx, cy = through_grid_coords(hv, res, frames, widths, out_h, out_w)
    v = _bilinear_hard_edge(page_u8.float(), cx, cy, float(fill))
    return torch.clamp(v, 0.0, 255.0).to(torch.uint8)


# ---------------------------------------------------------------------------
# a page's strips in one buffer
# ---------------------------------------------------------------------------

STRIP_ALIGN = 16     # bytes: each group's block starts 16-byte aligned


def strip_layout(groups, out_h, start=0):
    """Lay out strip groups in one flat u8 buffer. groups: [(nb, n_real,
    wmax)] -> (desc (N, 4) int32 numpy, one row per strip: (group,
    offset, wmax, real), the group offsets, end). Group g's (nb, out_h,
    wmax) block starts at the first multiple of STRIP_ALIGN at or after
    the previous block's end (the first at or after `start`); its rows
    past n_real are padding (real 0)."""
    rows, offsets = [], []
    off = int(start)
    for g, (nb, n_real, wmax) in enumerate(groups):
        off = -(-off // STRIP_ALIGN) * STRIP_ALIGN
        offsets.append(off)
        stride = out_h * wmax
        rows += [(g, off + r * stride, wmax, int(r < n_real))
                 for r in range(nb)]
        off += nb * stride
    if off >= 2 ** 31:
        raise ValueError("a page's strips need %d bytes; offsets are "
                         "int32" % off)
    return np.asarray(rows, np.int32).reshape(-1, 4), offsets, off


def _page_plain(group_plain, frames, widths, desc, out):
    """Run `group_plain(frames, widths, wmax)` on each group of `desc`
    (a run of rows with one group id, placed one after another as
    strip_layout places them) and write its strips at its offset in
    `out`."""
    rows = desc.cpu().tolist()
    lo = 0
    while lo < len(rows):
        hi = lo + 1
        while hi < len(rows) and rows[hi][0] == rows[lo][0]:
            hi += 1
        strips = group_plain(frames[lo:hi], widths[lo:hi], rows[lo][2])
        start = rows[lo][1]
        if any(rows[r][1] != start + (r - lo) * strips[0].numel()
               for r in range(lo, hi)):
            raise ValueError("the rows of group %d are not contiguous"
                             % rows[lo][0])
        out[start: start + strips.numel()] = strips.reshape(-1)
        lo = hi
    return out


def strips_dewarped_page_plain(dew_u8, frames, widths, desc, out, out_h,
                               max_w=None, fill=255.0):
    """Strip mode (a) for a page: strips_dewarped_plain of each group of
    `desc`, each strip's (out_h, wmax) rows written at its offset in the
    flat u8 `out` -> out. `max_w` is the kernel's and unused here."""
    return _page_plain(
        lambda fr, wd, wmax: strips_dewarped_plain(dew_u8, fr, wd, out_h,
                                                   wmax, fill),
        frames, widths, desc, out)


def strips_through_grid_page_plain(page_u8, hv, res, frames, widths, desc,
                                   out, out_h, max_w=None, fill=255.0):
    """Strip mode (b) for a page: strips_through_grid_plain of each
    group of `desc`, written into `out` as strips_dewarped_page_plain
    does -> out."""
    return _page_plain(
        lambda fr, wd, wmax: strips_through_grid_plain(
            page_u8, hv, res, fr, wd, out_h, wmax, fill),
        frames, widths, desc, out)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check(t, name, dtype, ndim, device):
    """Raise unless `t` is a tensor of `dtype` with `ndim` dims on
    `device`, contiguous on the card (the tensor's flags, not the
    device's type string, say where it is)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError("%s must be a torch.Tensor" % name)
    if t.dtype != dtype:
        raise TypeError("%s must be %s, got %s" % (name, dtype, t.dtype))
    if t.ndim != ndim:
        raise ValueError("%s must have %d dims, got shape %s"
                         % (name, ndim, tuple(t.shape)))
    if t.device != device:
        raise ValueError("%s is on %s, expected %s" % (name, t.device,
                                                       device))
    if t.is_cuda and not t.is_contiguous():
        raise ValueError("%s must be contiguous" % name)


# the kernels' C entry points, bound once (`kernels.origami_remap_f32`)
kernels = _build.entries


def _launch(dev, fn, *args):
    """Call the bound C entry point `fn` with `args` on the card `dev`
    (the tensors' card, made current for the call where it is not) and
    that card's current stream (its raw handle: no torch.cuda.Stream
    object is built per call); raise on a CUDA error."""
    index = dev.index
    if index == torch._C._cuda_getDevice():
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError("%s: CUDA error %d at launch" % (fn.__name__, rc))


def _ptr(t):
    """A tensor's address for a ctypes.c_void_p argument."""
    return t.data_ptr()


def _device_of(t):
    if not (t.is_cuda or t.is_cpu):
        raise ValueError("unsupported device %s" % t.device)
    return t.device


REMAP_BORDERS = ("fill_taps", "hard")


def _check_border(border):
    if border not in REMAP_BORDERS:
        raise ValueError("border must be one of %s, got %r"
                         % (REMAP_BORDERS, border))


def remap(image, map_xy, fill=0.0, border="fill_taps"):
    """f32 image (H, W), f32 map (H', W', 2) -> f32 (H', W'); `border`
    as remap_plain's."""
    dev = _device_of(image)
    _check(image, "image", torch.float32, 2, dev)
    _check(map_xy, "map_xy", torch.float32, 3, dev)
    _check_border(border)
    if map_xy.shape[2] != 2:
        raise ValueError("map_xy must be (H', W', 2)")
    if dev.type == "cpu":
        return remap_plain(image, map_xy, fill, border)
    oh, ow = map_xy.shape[:2]
    out = torch.empty((oh, ow), dtype=torch.float32, device=dev)
    if out.numel():
        h, w = image.shape
        p = _ptr(map_xy)
        _launch(dev, kernels.origami_remap_f32, _ptr(image), 1, h, w, p,
                p + 4, 2, oh, ow, float(fill), int(border == "hard"),
                _ptr(out))
        launches.add("remap")
    return out


def remap_batch(images, maps, fill=0.0, border="hard"):
    """B f32 images (B, H, W) through their maps in one launch: `maps`
    is an f32 (B, H', W', 2) tensor of source (x, y), or a pair (map_x,
    map_y) of f32 (B, H', W') planes -> f32 (B, H', W'). The default
    border is the training warp's (bilinear_sample_xy)."""
    dev = _device_of(images)
    _check(images, "images", torch.float32, 3, dev)
    _check_border(border)
    if isinstance(maps, torch.Tensor):
        _check(maps, "maps", torch.float32, 4, dev)
        if maps.shape[3] != 2 or maps.shape[0] != images.shape[0]:
            raise ValueError("maps must be (B, H', W', 2)")
        map_x, map_y, stride = maps[..., 0], maps[..., 1], 2
        ptrs = (_ptr(maps), _ptr(maps) + 4)
    else:
        map_x, map_y = maps
        _check(map_x, "map_x", torch.float32, 3, dev)
        _check(map_y, "map_y", torch.float32, 3, dev)
        if map_x.shape != map_y.shape or map_x.shape[0] != images.shape[0]:
            raise ValueError("map_x and map_y must both be (B, H', W')")
        stride = 1
        ptrs = (_ptr(map_x), _ptr(map_y))
    if dev.type == "cpu":
        return remap_batch_plain(images, map_x, map_y, fill, border)
    b, oh, ow = map_x.shape
    if b > 65535:
        raise ValueError("at most 65535 images a launch, got %d" % b)
    out = torch.empty((b, oh, ow), dtype=torch.float32, device=dev)
    if out.numel():
        _, h, w = images.shape
        _launch(dev, kernels.origami_remap_f32, _ptr(images), b, h, w,
                *ptrs, stride, oh, ow, float(fill), int(border == "hard"),
                _ptr(out))
        launches.add("remap_batch")
    return out


def _staged_ptr(staged_tiles, dev):
    """The address of a kernel's staged-tile counter, None for none."""
    if staged_tiles is None:
        return None
    _check(staged_tiles, "staged_tiles", torch.int32, 1, dev)
    if dev.type != "cuda" or staged_tiles.numel() != 1:
        raise ValueError("staged_tiles is a (1,) tensor on the card")
    return _ptr(staged_tiles)


def _check_grid(hv, res, dev):
    _check(hv, "hv", torch.float32, 3, dev)
    if hv.shape[2] != 2 or res < 1:
        raise ValueError("hv must be (gh, gw, 2) and res >= 1")


def dewarp_u8(page_u8, hv, res, fill=255.0, border="hard",
              staged_tiles=None):
    """u8 page (H, W), f32 grid (gh, gw, 2), int res -> u8 (gh*res,
    gw*res) dewarped page; `border` as dewarp_u8_plain's ("fill_taps"
    wants an integer fill in [0, 255]). `staged_tiles` (CUDA only): an
    int32 (1,) tensor to which the kernel adds the number of its 4x4-cell
    tiles that read their taps from a window staged in shared memory
    (the others read them through the read-only cache; TILE_CELLS gives
    the tiles' size)."""
    dev = _device_of(page_u8)
    _check(page_u8, "page_u8", torch.uint8, 2, dev)
    res = int(res)
    _check_grid(hv, res, dev)
    if border not in BORDERS:
        raise ValueError("border must be one of %s, got %r"
                         % (BORDERS, border))
    if border == "fill_taps" and not (0 <= fill <= 255
                                      and float(fill).is_integer()):
        raise ValueError("fill_taps wants an integer fill in [0, 255]")
    staged = _staged_ptr(staged_tiles, dev)
    if dev.type == "cpu":
        return dewarp_u8_plain(page_u8, hv, res, fill, border)
    gh, gw = hv.shape[:2]
    out = torch.empty((gh * res, gw * res), dtype=torch.uint8, device=dev)
    if out.numel():
        h, w = page_u8.shape
        _launch(dev, kernels.origami_dewarp_u8, _ptr(page_u8), h, w,
                _ptr(hv), gh, gw, res, float(fill),
                int(border == "fill_taps"), _ptr(out), staged)
        launches.add("dewarp_u8")
    return out


def dewarp_f32(image, hv, res, fill=0.0, staged_tiles=None):
    """f32 image (H, W), f32 grid (gh, gw, 2), int res -> f32 (gh*res,
    gw*res): dewarp_f32_plain's samples, each tap off the image `fill`,
    in one launch that upsamples the grid tile by tile (no dense map is
    written). `staged_tiles` as dewarp_u8's."""
    dev = _device_of(image)
    _check(image, "image", torch.float32, 2, dev)
    res = int(res)
    _check_grid(hv, res, dev)
    staged = _staged_ptr(staged_tiles, dev)
    if dev.type == "cpu":
        return dewarp_f32_plain(image, hv, res, fill)
    gh, gw = hv.shape[:2]
    out = torch.empty((gh * res, gw * res), dtype=torch.float32, device=dev)
    if out.numel():
        h, w = image.shape
        _launch(dev, kernels.origami_dewarp_f32, _ptr(image), h, w,
                _ptr(hv), gh, gw, res, float(fill), _ptr(out), staged)
        launches.add("dewarp_f32")
    return out


MAX_STRIPS = 65535   # the grid's z extent: one strip per z index


def _check_frames(frames, widths, dev):
    _check(frames, "frames", torch.float32, 3, dev)
    _check(widths, "widths", torch.int32, 1, dev)
    if frames.shape[1:] != (2, 3) or widths.shape[0] != frames.shape[0]:
        raise ValueError("frames must be (N, 2, 3) and widths (N,)")
    if dev.type == "cuda" and frames.shape[0] > MAX_STRIPS:
        raise ValueError("at most %d strips a launch, got %d"
                         % (MAX_STRIPS, frames.shape[0]))


def _check_image(img, name, dev):
    """A strip kernel's u8 page: its taps are int32 offsets."""
    _check(img, name, torch.uint8, 2, dev)
    if img.numel() >= 2 ** 31:
        raise ValueError("%s must hold < 2**31 pixels" % name)


def _check_page(desc, out, n, dev):
    _check(desc, "desc", torch.int32, 2, dev)
    _check(out, "out", torch.uint8, 1, dev)
    if desc.shape != (n, 4):
        raise ValueError("desc must be (N, 4), got %s" % (tuple(desc.shape),))


def strips_dewarped(dew_u8, frames, widths, out_h, out_w, fill=255.0):
    """Strip mode (a): u8 dewarped page (H, W), f32 frames (N, 2, 3),
    int32 widths (N,) -> u8 (N, out_h, out_w)."""
    dev = _device_of(dew_u8)
    _check_image(dew_u8, "dew_u8", dev)
    _check_frames(frames, widths, dev)
    if dev.type == "cpu":
        return strips_dewarped_plain(dew_u8, frames, widths, out_h, out_w,
                                     fill)
    n = frames.shape[0]
    out = torch.empty((n, out_h, out_w), dtype=torch.uint8, device=dev)
    if out.numel():
        h, w = dew_u8.shape
        _launch(dev, kernels.origami_strips_dewarped, _ptr(dew_u8), h, w,
                _ptr(frames), _ptr(widths), None, n, int(out_h), int(out_w),
                float(fill), _ptr(out), out.numel())
        launches.add("strips_dewarped")
    return out


def strips_dewarped_page(dew_u8, frames, widths, desc, out, out_h, max_w,
                         fill=255.0):
    """Strip mode (a) for all groups of a page in one launch: u8
    dewarped page (H, W), f32 frames (N, 2, 3), int32 widths (N,), int32
    desc (N, 4) from strip_layout, the flat u8 buffer `out`, max_w >=
    every wmax of desc -> out, strip n's (out_h, wmax_n) rows written at
    its offset."""
    dev = _device_of(dew_u8)
    _check_image(dew_u8, "dew_u8", dev)
    _check_frames(frames, widths, dev)
    n = frames.shape[0]
    _check_page(desc, out, n, dev)
    if dev.type == "cpu":
        return strips_dewarped_page_plain(dew_u8, frames, widths, desc, out,
                                          out_h, max_w, fill)
    if n and out_h > 0 and max_w > 0:
        h, w = dew_u8.shape
        _launch(dev, kernels.origami_strips_dewarped, _ptr(dew_u8), h, w,
                _ptr(frames), _ptr(widths), _ptr(desc), n, int(out_h),
                int(max_w), float(fill), _ptr(out), out.numel())
        launches.add("strips_dewarped")
    return out


def strips_through_grid(page_u8, hv, res, frames, widths, out_h, out_w,
                        fill=255.0):
    """Strip mode (b): u8 warped page (H, W), f32 grid (gh, gw, 2), res,
    f32 frames (N, 2, 3), int32 widths (N,) -> u8 (N, out_h, out_w)."""
    dev = _device_of(page_u8)
    _check_image(page_u8, "page_u8", dev)
    _check(hv, "hv", torch.float32, 3, dev)
    _check_frames(frames, widths, dev)
    if dev.type == "cpu":
        return strips_through_grid_plain(page_u8, hv, res, frames, widths,
                                         out_h, out_w, fill)
    n = frames.shape[0]
    gh, gw = hv.shape[:2]
    out = torch.empty((n, out_h, out_w), dtype=torch.uint8, device=dev)
    if out.numel():
        h, w = page_u8.shape
        _launch(dev, kernels.origami_strips_through_grid, _ptr(page_u8), h,
                w, _ptr(hv), gh, gw, float(res), _ptr(frames), _ptr(widths),
                None, n, int(out_h), int(out_w), float(fill), _ptr(out),
                out.numel())
        launches.add("strips_through_grid")
    return out


def strips_through_grid_page(page_u8, hv, res, frames, widths, desc, out,
                             out_h, max_w, fill=255.0):
    """Strip mode (b) for all groups of a page in one launch: the
    arguments of strips_through_grid, with desc, out and max_w as in
    strips_dewarped_page -> out."""
    dev = _device_of(page_u8)
    _check_image(page_u8, "page_u8", dev)
    _check(hv, "hv", torch.float32, 3, dev)
    _check_frames(frames, widths, dev)
    n = frames.shape[0]
    _check_page(desc, out, n, dev)
    if dev.type == "cpu":
        return strips_through_grid_page_plain(page_u8, hv, res, frames,
                                              widths, desc, out, out_h,
                                              max_w, fill)
    if n and out_h > 0 and max_w > 0:
        h, w = page_u8.shape
        gh, gw = hv.shape[:2]
        _launch(dev, kernels.origami_strips_through_grid, _ptr(page_u8), h,
                w, _ptr(hv), gh, gw, float(res), _ptr(frames), _ptr(widths),
                _ptr(desc), n, int(out_h), int(max_w), float(fill), _ptr(out),
                out.numel())
        launches.add("strips_through_grid")
    return out


# ---------------------------------------------------------------------------
# affine warps
# ---------------------------------------------------------------------------

def affine_planes(matrix, out_hw):
    """The source (x, y) planes (h, w), float32 numpy, of an inverse-map
    affine warp: `matrix` (2, 3) cast to float32, then m00 x + m01 y +
    m02 in float32 as XLA's CPU backend evaluates ops/remap.py:80-84:
    m01 y rounded, m00 x added to it in one fused multiply-add, then m02
    added."""
    h, w = (int(v) for v in out_hw)
    m = np.asarray(matrix, np.float32).reshape(2, 3)
    ys = np.arange(h, dtype=np.float32)[:, None]
    xs = np.arange(w, dtype=np.float32)[None, :]
    return [fma_f32(m[r, 0], xs, m[r, 1] * ys) + m[r, 2] for r in (0, 1)]


def affine_warp_plain(image, matrix, out_hw, fill=0.0):
    """affine_warp's plain version: the planes of affine_planes, moved to
    the image's device, through remap_batch_plain at the hard border."""
    sx, sy = (torch.from_numpy(p).to(image.device)[None]
              for p in affine_planes(matrix, out_hw))
    return remap_batch_plain(image[None], sx, sy, fill, "hard")[0]


def affine_warp(image, matrix, out_hw, fill=0.0):
    """Inverse-map affine warp of the f32 image (H, W): `matrix` (2, 3)
    maps OUTPUT (x, y, 1) to source coordinates (cv2.warpAffine with
    WARP_INVERSE_MAP) -> f32 (h, w) on the image's device. Each sample is
    bilinear_sample_xy's: taps clamped into the image, `fill` outside
    [0, w-1] x [0, h-1]. On the card one remap_affine launch, which
    computes each source coordinate from the six coefficients (passed by
    value)."""
    dev = _device_of(image)
    _check(image, "image", torch.float32, 2, dev)
    m = np.asarray(matrix, np.float32).ravel().tolist()
    if len(m) != 6:
        raise ValueError("matrix must be (2, 3), got %d values" % len(m))
    if dev.type == "cpu":
        return affine_warp_plain(image, matrix, out_hw, fill)
    oh, ow = (int(v) for v in out_hw)
    out = torch.empty((oh, ow), dtype=torch.float32, device=dev)
    if out.numel():
        h, w = image.shape
        _launch(dev, kernels.origami_remap_affine_f32, _ptr(image), h, w,
                *m, oh, ow, float(fill), _ptr(out))
        launches.add("remap_affine")
    return out


def invert_affine(matrix):
    """Invert a (2, 3) forward affine into the inverse-map form, in
    float32 as ops/remap.py:88-94 -> f32 (2, 3) tensor."""
    m = torch.as_tensor(np.asarray(matrix, np.float32).reshape(2, 3))
    ai = torch.linalg.inv(m[:, :2])
    ti = -(ai @ m[:, 2])
    return torch.cat([ai, ti[:, None]], dim=1)
