"""The page kinds PIL reads beyond those of test_torch_image_formats.py,
against PIL: lossless and arithmetic-coded JPEG (genuine libjpeg-turbo
files from tests/data/torch_formats/more, written by
scripts/make_torch_formats_fixture.py), sub-sampled lossless JPEG (which
no writer at hand makes), BigTIFF, planar, CMYK, signed, float and
associated-alpha TIFF and the BMP palettes PIL drops (written here,
seeded). Each file PIL reads must give PIL's `convert("L")` on
every pixel, its `convert("RGB")` where the port reads RGB, and its
`.size`; each kind PIL refuses must raise a ValueError that names it.
Tolerance: none.
"""

import hashlib
import json
import struct
from pathlib import Path

import numpy as np
import PIL.Image
import pytest

from origami_tpu_torch.core import _image, _png
from test_torch_image_formats import (bmp_file, bmp_rows, pil_tiff,
                                      texture, tiff_file)

ROOT = Path(__file__).resolve().parent.parent
FORMATS = ROOT / "tests/data/torch_formats"
MANIFEST = json.loads((FORMATS / "manifest.json").read_text())
FULL = ROOT / "tests/data/torch_ocr/full"


# ---------------------------------------------------------------- TIFF

def premultiplied(px):
    """RGBA samples with the colour multiplied by alpha, and the corner
    cases of Pillow's unpackRGBa (alpha 0, 1, 255, colour above alpha)."""
    px = px.copy()
    px[..., :3] = (px[..., :3].astype(int) * px[..., 3:] // 255)
    px[0, :6] = [[200, 10, 5, 100], [255, 255, 255, 10], [3, 3, 3, 0],
                 [9, 8, 7, 1], [90, 80, 70, 255], [0, 0, 0, 0]]
    return px


def float_samples(h, w, seed):
    """float32 around 0-255 with NaN, infinities and values at the
    clipping and truncation edges."""
    f = texture(h, w, 1, seed).astype(np.float32) * 1.37 - 60.3
    f[0, :12] = [np.nan, np.inf, -np.inf, 255.5, 254.5, -0.5, 0.5, 1.5,
                 254.99, 1e10, -1e-30, 256.0]
    return f


def ifd_edit(data, tag, value=None):
    """A classic little-endian TIFF with `tag`'s one inline value set to
    `value`, or the tag dropped where `value` is None."""
    off = struct.unpack("<I", data[4:8])[0]
    n = struct.unpack("<H", data[off: off + 2])[0]
    entries = [bytearray(data[off + 2 + 12 * i: off + 14 + 12 * i])
               for i in range(n)]
    for e in entries:
        if struct.unpack("<H", e[:2])[0] == tag and value is not None:
            e[8:12] = struct.pack("<HH" if e[2] == 3 else "<I", value,
                                  *([0] if e[2] == 3 else []))
    entries = [e for e in entries if value is not None or
               struct.unpack("<H", e[:2])[0] != tag]
    return data[:off] + struct.pack("<H", len(entries)) + b"".join(
        entries) + b"\0" * 4


def tiff_cases():
    cases = {}
    gray, rgb = texture(37, 45, 1, 90), texture(37, 45, 3, 91)
    cmyk = texture(37, 45, 4, 92)
    f32 = float_samples(37, 45, 93)
    i16 = texture(37, 45, 1, 94).astype(np.int16) * 3 - 300
    i16[0, :4] = [-32768, 32767, 255, 256]
    i32 = texture(37, 45, 1, 95).astype(np.int32) * 5 - 400
    i32[0, :4] = [-2 ** 31, 2 ** 31 - 1, 255, 256]
    rgba = premultiplied(texture(37, 45, 4, 96))
    for bo, b in (("<", "le"), (">", "be")):
        def add(name, px, photometric, bo=bo, **kw):
            cases["tiff-%s-%s" % (name, b)] = \
                lambda: tiff_file(px, photometric, bo=bo, **kw)
        # planar configuration 2: one set of strips or tiles a sample
        add("planar-rgb", rgb, 2, planar=True, rows_per_strip=8)
        add("planar-rgb-lzw-predictor", rgb, 2, planar=True, compression=5,
            predictor=2, rows_per_strip=8)
        add("planar-rgb-tiles-deflate", rgb, 2, planar=True, compression=8,
            tile=(32, 16))
        add("planar-rgb-packbits", rgb, 2, planar=True, compression=32773)
        add("planar-rgba-tiles-lzw", texture(37, 45, 4, 97), 2, planar=True,
            compression=5, tile=(16, 32), extra=((338, 3, [2]),))
        add("planar-rgb16-lzw", rgb.astype(np.uint16) * 257 + 3, 2,
            planar=True, compression=5)
        add("planar-rgb16-deflate-tiles", rgb.astype(np.uint16) * 257 + 3,
            2, planar=True, compression=8, predictor=2, tile=(16, 16))
        # uncompressed 16-bit planes: PIL's 8-bit band unpackers
        add("planar-rgb16", rgb.astype(np.uint16) * 257 + 3, 2, planar=True)
        add("planar-rgb16-tiles", rgb.astype(np.uint16) * 257 + 3, 2,
            planar=True, tile=(16, 16))
        add("planar-cmyk", cmyk, 5, planar=True)
        add("planar-cmyk16", cmyk.astype(np.uint16) * 250, 5, planar=True,
            rows_per_strip=5)
        add("planar-gray-alpha-deflate", texture(37, 45, 2, 98), 1,
            planar=True, compression=8, extra=((338, 3, [2]),))
        # CMYK (photometric 5)
        add("cmyk", cmyk, 5)
        add("cmyk-lzw-predictor", cmyk, 5, compression=5, predictor=2)
        add("cmyk-tiles-deflate", cmyk, 5, compression=8, tile=(16, 16))
        add("cmyk16", cmyk.astype(np.uint16) * 255, 5)
        # float32 and signed samples
        add("float", f32, 1)
        add("float-miniswhite", f32, 0)
        add("float-deflate", f32, 1, compression=8)
        add("float-deflate-predictor3", f32, 1, compression=8, predictor=3)
        add("float-lzw-predictor3-tiles", f32, 1, compression=5,
            predictor=3, tile=(16, 16))
        add("float-raw-predictor3", f32, 1, predictor=3)
        add("int16", i16, 1)
        add("int16-deflate-predictor", i16, 1, compression=8, predictor=2)
        add("int32", i32, 1)
        add("int32-lzw", i32, 1, compression=5)
        add("int8", gray.astype(np.int8), 1)
        # associated alpha: PIL unpremultiplies
        add("rgba-associated", rgba, 2, extra=((338, 3, [1]),))
        add("rgba-associated-lzw-strips", rgba, 2, extra=((338, 3, [1]),),
            compression=5, rows_per_strip=6)
        add("rgba16-associated", rgba.astype(np.uint16) * 257, 2,
            extra=((338, 3, [1]),))
        add("rgbax-associated", np.concatenate(
            [rgba, gray[..., None]], axis=2), 2, extra=((338, 3, [1, 0]),))
        # the predictor tag where libtiff's codec takes none: PIL ignores it
        add("gray-raw-predictor", gray, 1, predictor=2)
        add("gray-packbits-predictor", gray, 1, predictor=2,
            compression=32773)
    # BigTIFF (little-endian: PIL takes big-endian BigTIFF for classic)
    for name, args, kw in (
            ("gray", (gray, 1), {}),
            ("rgb-deflate-predictor", (rgb, 2),
             dict(compression=8, predictor=2, rows_per_strip=10)),
            ("rgb-lzw-tiles", (rgb, 2), dict(compression=5, tile=(16, 16))),
            ("planar-cmyk", (cmyk, 5), dict(planar=True)),
            ("float-predictor3", (f32, 1),
             dict(compression=8, predictor=3))):
        cases["tiff-bigtiff-" + name] = lambda a=args, k=kw: tiff_file(
            *a, big=True, **k)
    cases["tiff-bigtiff-pil-gray"] = lambda: pil_tiff(gray, big_tiff=True)
    cases["tiff-bigtiff-pil-rgb"] = lambda: pil_tiff(rgb, big_tiff=True)
    # Pillow's own writers of CMYK, F and I
    cases["tiff-pil-cmyk"] = lambda: pil_tiff(cmyk, "CMYK")
    cases["tiff-pil-cmyk-lzw"] = lambda: pil_tiff(cmyk, "CMYK",
                                                  compression="tiff_lzw")
    cases["tiff-pil-float"] = lambda: pil_tiff(f32, "F")
    cases["tiff-pil-float-lzw-predictor3"] = lambda: pil_tiff(
        f32, "F", compression="tiff_lzw", tiffinfo={317: 3})
    cases["tiff-pil-int32-deflate"] = lambda: pil_tiff(
        i32, "I", compression="tiff_adobe_deflate")
    cases["tiff-uint32-le"] = lambda: tiff_file(i32.astype(np.uint32), 1)
    # planes through libtiff: associated alpha, and RGBA without
    # ExtraSamples (libtiff calls the fourth sample unspecified), are
    # unpremultiplied as after "RGBa"; tiles take the first planes
    cmap = [(i * 7919) % 65536 for i in range(768)]
    for name, args, kw in (
            ("rgba-associated-deflate", (rgba, 2),
             dict(compression=8, extra=((338, 3, [1]),))),
            ("rgba16-associated-lzw-tiles", (rgba.astype(np.uint16) * 257, 2),
             dict(compression=5, tile=(16, 16), extra=((338, 3, [1]),))),
            ("rgba-no-extra-deflate", (rgba, 2), dict(compression=8)),
            ("rgbx-tiles-deflate", (rgba, 2), dict(
                compression=8, tile=(16, 32), extra=((338, 3, [0]),))),
            ("cmykx-tiles-lzw", (np.concatenate([cmyk, gray[..., None]], 2),
                                 5), dict(compression=5, tile=(32, 16),
                                          extra=((338, 3, [0]),))),
            ("palette-alpha-deflate", (texture(37, 45, 2, 102), 3), dict(
                compression=8, bps=8, colormap=cmap, extra=((338, 3, [2]),))),
            # uncompressed: Pillow's own tiles, a letter of the rawmode a
            # plane, rows a tile width x all samples' bits / PIL's sample
            # count apart past the right edge (4/3 of a row here)
            ("rgba-no-extra-raw-tiles", (rgba, 2), dict(tile=(16, 16))),
            ("rgba-corel-raw", (rgba, 2), dict(extra=((338, 3, [999]),))),
            ("gray-miniswhite-raw", (gray, 0), dict(rows_per_strip=7)),
            ("gray1-miniswhite-raw", (gray >> 7, 0), dict(bps=1)),
            ("gray4-raw-one-tile", (texture(9, 11, 1, 103) >> 4, 1),
             dict(bps=4, tile=(16, 16))),
            ("int32-be-raw", (i32, 1), dict(bo=">", rows_per_strip=5)),
            ("float-be-raw", (f32, 1), dict(bo=">"))):
        cases["tiff-planar-" + name] = lambda a=args, k=kw: tiff_file(
            *a, planar=True, **k)
    # the predictor where libtiff's codec takes none, PIL's default
    # photometric interpretation (MinIsWhite)
    cases["tiff-gray-packbits-predictor3"] = lambda: tiff_file(
        gray, 1, compression=32773, extra=((317, 3, [3]),))
    cases["tiff-gray-no-photometric"] = lambda: ifd_edit(tiff_file(
        gray, 1, compression=8), 262)
    return {k: ("tif", v) for k, v in cases.items()}


# ----------------------------------------------------------------- BMP

def clr_used(data, n):
    """A BMP with its header's biClrUsed set to `n`."""
    return data[:46] + struct.pack("<I", n) + data[50:]


def bmp_cases():
    """Palettes that BmpImagePlugin drops: entries 0, 1, 2, ... make it
    read the data as "L" (4-bit rows as their bytes), black and white as
    "1"; a ramp 0, 17, ..., 255 stays a palette."""
    gray = texture(19, 23, 1, 99)
    idx = (gray >> 4).astype(np.uint8)
    ident = [(i, i, i) for i in range(16)]
    ramp = [(17 * i,) * 3 for i in range(16)]
    bits = (gray > 128).astype(np.uint8)
    cases = {
        "bmp-4bit-identity-16": lambda: bmp_file(4, bmp_rows(idx, 4), 23, 19,
                                                 ident),
        "bmp-4bit-identity-0": lambda: clr_used(bmp_file(
            4, bmp_rows(idx, 4), 23, 19, ident), 0),
        "bmp-4bit-identity-core": lambda: bmp_file(
            4, bmp_rows(idx, 4), 23, 19, ident, header=12),
        "bmp-4bit-identity-top-down": lambda: bmp_file(
            4, bmp_rows(idx, 4, True), 23, 19, ident, top_down=True),
        "bmp-4bit-identity-5": lambda: bmp_file(
            4, bmp_rows(idx % 5, 4), 23, 19, ident[:5]),
        "bmp-4bit-ramp-16": lambda: bmp_file(4, bmp_rows(idx, 4), 23, 19,
                                             ramp),
        "bmp-4bit-ramp-0": lambda: clr_used(bmp_file(
            4, bmp_rows(idx, 4), 23, 19, ramp), 0),
        "bmp-4bit-ramp-core": lambda: bmp_file(
            4, bmp_rows(idx, 4), 23, 19, ramp, header=12),
        "bmp-8bit-identity-16": lambda: bmp_file(   # indices past it
            8, bmp_rows(gray, 8), 23, 19, ident),
        "bmp-8bit-identity-core": lambda: bmp_file(
            8, bmp_rows(gray, 8), 23, 19, [(i, i, i) for i in range(256)],
            header=12),
        "bmp-1bit-black-white": lambda: bmp_file(
            1, bmp_rows(bits, 1), 23, 19, [(0, 0, 0), (255, 255, 255)]),
        "bmp-1bit-black-white-core": lambda: bmp_file(
            1, bmp_rows(bits, 1), 23, 19, [(0, 0, 0), (255, 255, 255)],
            header=12),
    }
    return {k: ("bmp", v) for k, v in cases.items()}


# -------------------------------------- lossless JPEG that no writer makes

def lossless_jpeg(planes, samp, h, w, psv=1, pt=0, restart_rows=0,
                  interleaved=True):
    """A lossless (SOF3) file of `planes` (uint8, each at its component's
    size) with sampling factors `samp` [(h, v), ...], written here because
    libjpeg-turbo writes no sub-sampled lossless file: one Huffman table
    of SSSS 0-16 at 5 bits each, predictor `psv`, point transform `pt`, a
    restart every `restart_rows` MCU rows (the predictors start again at
    the restart's row, as ITU T.81 H.1.2.1 says), one scan or one a
    component."""
    n = len(planes)
    inter = interleaved and n > 1
    hmax, vmax = max(s[0] for s in samp), max(s[1] for s in samp)
    mcux, mcuy = -(-w // hmax), -(-h // vmax)
    diffs = []
    for p, (sh, sv) in zip(planes, samp):
        rows, cols = (mcuy * sv, mcux * sh) if inter else p.shape
        a = np.pad(p.astype(np.int64) >> pt, ((0, rows - p.shape[0]),
                                              (0, cols - p.shape[1])), "edge")
        pred = np.empty_like(a)
        pred[1:, 0] = a[:-1, 0]
        ra, rb, rc = a[1:, :-1], a[:-1, 1:], a[:-1, :-1]
        pred[1:, 1:] = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc,
                        5: ra + ((rb - rc) >> 1), 6: rb + ((ra - rc) >> 1),
                        7: (ra + rb) >> 1}[psv]
        every = restart_rows * (sv if inter else 1) or rows
        for y in range(0, rows, every):     # first rows: from the left
            pred[y, 0] = 1 << (7 - pt)
            pred[y, 1:] = a[y, :-1]
        diffs.append((a - pred) & 0xFFFF)
    out = bytearray(b"\xff\xd8")
    sof = struct.pack(">BHHB", 8, h, w, n) + b"".join(
        struct.pack(">BBB", c + 1, s[0] << 4 | s[1], 0)
        for c, s in enumerate(samp))
    dht = bytes([0, 0, 0, 0, 0, 17] + [0] * 11) + bytes(range(17))
    for marker, body in ((0xC3, sof), (0xC4, dht)):
        out += struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body
    for comps in [range(n)] if inter else [[c] for c in range(n)]:
        if inter:
            units = [[(c, my * samp[c][1] + y, mx * samp[c][0] + x)
                      for c in comps for y in range(samp[c][1])
                      for x in range(samp[c][0])]
                     for my in range(mcuy) for mx in range(mcux)]
            per_row = mcux
        else:
            units = [[(comps[0], y, x)]
                     for y in range(diffs[comps[0]].shape[0])
                     for x in range(diffs[comps[0]].shape[1])]
            per_row = diffs[comps[0]].shape[1]
        interval = restart_rows * per_row
        out += struct.pack(">HHH", 0xFFDD, 4, interval)
        segments = []                       # the restart intervals' bits
        for i, unit in enumerate(units):
            if not interval and i == 0 or interval and i % interval == 0:
                segments.append("")
            for c, y, x in unit:
                d = int(diffs[c][y, x])
                d = d - 65536 if d >= 32768 else d
                s = 16 if d == -32768 else abs(d).bit_length()
                v = d if d >= 0 else d + (1 << s) - 1
                segments[-1] += format(s, "05b") + (
                    format(v, "0%db" % s) if 0 < s < 16 else "")
        data = bytearray()
        for j, seg in enumerate(segments):
            if j:
                data += bytes((0xFF, 0xD0 + (j - 1) % 8))
            seg += "1" * (-len(seg) % 8)
            for k in range(0, len(seg), 8):
                byte = int(seg[k: k + 8], 2)
                data += bytes((byte, 0) if byte == 0xFF else (byte,))
        sos = bytes([len(comps)]) + b"".join(
            bytes((c + 1, 0)) for c in comps) + bytes((psv, 0, pt))
        out += struct.pack(">HH", 0xFFDA, len(sos) + 2) + sos + data
    return bytes(out + b"\xff\xd9")


def lossless_file(samp, h=23, w=19, seed=0, **kw):
    """`lossless_jpeg` of seeded planes at `samp` for an h x w image."""
    rng = np.random.default_rng(seed)
    hmax, vmax = max(s[0] for s in samp), max(s[1] for s in samp)
    planes = [rng.integers(0, 256, (-(-h * sv // vmax), -(-w * sh // hmax)),
                           dtype=np.uint8) for sh, sv in samp]
    return lossless_jpeg(planes, samp, h, w, **kw)


def lossless_cases():
    """Sub-sampled lossless files, which PIL reads with the planes
    replicated; restarts in scans of one component whose v is above 1,
    where libjpeg-turbo restarts the predictors at the first row of the
    iMCU row that holds the restart."""
    s420, s440 = [(2, 2), (1, 1), (1, 1)], [(1, 2), (1, 1), (1, 1)]
    cases = {
        "420": (s420, {}),
        "422-p4-pt2": ([(2, 1), (1, 1), (1, 1)], dict(psv=4, pt=2)),
        "440-p7": (s440, dict(psv=7)),
        "311-p5": ([(3, 1), (1, 1), (1, 1)], dict(psv=5)),
        "wide-chroma-p6": ([(1, 1), (2, 2), (1, 1)], dict(psv=6)),
        "cmyk-k-2x2-p2": ([(1, 1), (1, 1), (1, 1), (2, 2)], dict(psv=2)),
        "420-restart": (s420, dict(psv=6, restart_rows=1)),
        "420-scans": (s420, dict(psv=3, interleaved=False)),
        "440-scans-restart-2": (s440, dict(psv=3, restart_rows=2,
                                           interleaved=False)),
        "131-scans-restart-2": ([(1, 3), (1, 1), (1, 1)],
                                dict(psv=1, restart_rows=2, h=4, w=4,
                                     interleaved=False)),
        "gray-2x2-restart-1": ([(2, 2)], dict(psv=7, restart_rows=1)),
        "gray-1x4-restart-3": ([(1, 4)], dict(psv=4, restart_rows=3, h=9,
                                              w=40)),
    }
    return {"lossless-sampled-" + name: (
        "jpg", lambda s=s, kw=kw, i=i: lossless_file(s, seed=200 + i, **kw))
        for i, (name, (s, kw)) in enumerate(cases.items())}


CASES = {**tiff_cases(), **bmp_cases(), **lossless_cases()}

# kinds both PIL and the port refuse: (suffix, make, a word of the error)
_gray, _rgba = texture(37, 45, 1, 100), texture(37, 45, 4, 101)
REFUSED = {
    "tiff-bigtiff-be": ("tif", lambda: tiff_file(_gray, 1, bo=">",
                                                  big=True), "BigTIFF"),
    "tiff-float64": ("tif", lambda: tiff_file(
        _gray.astype(np.float64), 1), "float samples of 64 bits"),
    "tiff-uint32-be": ("tif", lambda: tiff_file(
        _gray.astype(np.uint32), 1, bo=">"), "unsigned samples of 32"),
    "tiff-gray-associated-alpha": ("tif", lambda: tiff_file(
        _rgba[..., 2:], 1, extra=((338, 3, [1]),)), "associated alpha"),
    "tiff-planar-rgba-associated": ("tif", lambda: tiff_file(
        premultiplied(_rgba), 2, planar=True, extra=((338, 3, [1]),)),
        "read as 'RGBa'"),
    "tiff-planar-gray-alpha-raw": ("tif", lambda: tiff_file(
        _rgba[..., :2], 1, planar=True, extra=((338, 3, [2]),)),
        "read as 'LA'"),
    "tiff-planar-rgbx": ("tif", lambda: tiff_file(
        _rgba, 2, planar=True, extra=((338, 3, [0]),), compression=8),
        "planar"),
    "lossless-sampled-11-blocks": ("jpg", lambda: lossless_file(
        [(2, 4), (1, 1), (1, 2)]), "too large for an interleaved scan"),
    "tiff-cmyk16-extra": ("tif", lambda: tiff_file(np.concatenate(
        [_rgba, _gray[..., None]], axis=2).astype(np.uint16) * 257, 5,
        extra=((338, 3, [0]),), compression=5), "16 bits, 5 a pixel"),
    "tiff-gray16-miniswhite-be": ("tif", lambda: tiff_file(
        _gray.astype(np.uint16) * 257, 0, bo=">", compression=8),
        "photometric interpretation 0"),
    "tiff-gray16-extra": ("tif", lambda: tiff_file(
        _rgba[..., :2].astype(np.uint16) * 257, 1, compression=8,
        extra=((338, 3, [0]),)), "16 bits, 2 a pixel"),
    "tiff-gray16-planar-raw": ("tif", lambda: tiff_file(
        _gray.astype(np.uint16), 1, planar=True), "read as 'I;16'"),
    "tiff-miniswhite-fill2-raw": ("tif", lambda: tiff_file(
        _gray, 0, extra=((266, 3, [2]),)), "FillOrder 2"),
    "tiff-packbits-short": ("tif", lambda: ifd_edit(tiff_file(
        _gray, 1, compression=32773), 279, 100), "PackBits data ends"),
    "tiff-lzw-short": ("tif", lambda: ifd_edit(tiff_file(
        _gray, 1, compression=5), 279, 100), "LZW data ends"),
    "tiff-deflate-short": ("tif", lambda: ifd_edit(tiff_file(
        _gray, 1, compression=8), 279, 100), "Deflate data"),
    "tiff-planar-int16-raw-strips": ("tif", lambda: tiff_file(
        (_gray.astype(np.int16) - 99), 1, planar=True, rows_per_strip=5),
        "runs past"),
    "tiff-planar-palette4-raw": ("tif", lambda: tiff_file(
        _gray >> 4, 3, bps=4, planar=True, colormap=list(range(48))),
        "runs past"),
    "tiff-planar-cmykx": ("tif", lambda: tiff_file(
        np.concatenate([_rgba, _gray[..., None]], axis=2), 5, planar=True,
        extra=((338, 3, [0]),)), "read as 'CMYKX'"),
}


def test_layout_table_is_pillows():
    """core/_tiff.py's table of the sample layouts PIL has a mode for is
    Pillow's (TiffImagePlugin.OPEN_INFO's keys)."""
    from PIL import TiffImagePlugin

    from origami_tpu_torch.core import _tiff
    want = {("<" if k[0] == TiffImagePlugin.II else ">",) + k[1:]
            for k in TiffImagePlugin.OPEN_INFO}
    assert {(bo,) + k for k, orders in _tiff._PIL_LAYOUTS.items()
            for bo in orders} == want


def test_palette_with_an_extra_plane_in_tiles_is_refused(tmp_path):
    """A deliberate difference (ROADMAP C8): Pillow unpacks the one band
    of such a tile as "PX" from the first plane, past each row's end."""
    path = tmp_path / "page.tif"
    path.write_bytes(tiff_file(_rgba[..., :2], 3, compression=8, bps=8,
                               planar=True, tile=(16, 16),
                               colormap=list(range(768)),
                               extra=((338, 3, [0]),)))
    with pytest.raises(ValueError, match="in tiles, 1 bands in PIL"):
        _image.read_gray(path)


def check_reads_as_pil(path):
    with PIL.Image.open(path) as im:
        size = im.size
        ref = np.asarray(im.convert("L"))
        rgb = np.asarray(im.convert("RGB"))
    assert _image.read_size(path) == size
    got = _image.read_gray(path)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    assert int((got != ref).sum()) == 0
    px = _image.read(path)
    if px.ndim == 3:
        np.testing.assert_array_equal(px, rgb)
    return got


@pytest.mark.parametrize("name", sorted(CASES))
def test_reads_as_pil(tmp_path, name):
    suffix, make = CASES[name]
    path = tmp_path / ("page." + suffix)
    path.write_bytes(make())
    check_reads_as_pil(path)


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_both_refuse(tmp_path, name):
    suffix, make, word = REFUSED[name]
    path = tmp_path / ("page." + suffix)
    path.write_bytes(make())
    with pytest.raises(Exception):
        with PIL.Image.open(path) as im:
            im.convert("L")
    with pytest.raises(ValueError, match=word):
        _image.read_gray(path)


# ------------------------------------------- libjpeg-turbo's own files

LIBJPEG = sorted(k for k in MANIFEST if k.startswith("more/jpeg-"))


def test_fixture_holds_the_libjpeg_kinds():
    """The genuine files the fixture script wrote: every lossless
    predictor, arithmetic coding sequential and progressive, and the
    pairs on both sides of PIL's 65536-byte block."""
    names = {k[len("more/"):].rsplit(".", 1)[0] for k in LIBJPEG}
    for p in range(1, 8):
        assert "jpeg-lossless-gray-p%d" % p in names
        assert "jpeg-lossless-rgb-p%d" % p in names
    for name in ("jpeg-arith-block-fits", "jpeg-arith-block-past",
                 "jpeg-arith-prog-block-fits", "jpeg-arith-prog-block-past",
                 "jpeg-arith-sos-past-block", "jpeg-arith-sos-block-past",
                 "jpeg-12-bit", "jpeg-lossless-6-bit"):
        assert name in names
    fits = (FORMATS / "more/jpeg-arith-block-fits.jpg").stat().st_size
    past = (FORMATS / "more/jpeg-arith-block-past.jpg").stat().st_size
    assert (fits, past) == (65536, 65537)


@pytest.mark.parametrize("rel", LIBJPEG)
def test_libjpeg_file_as_pil(rel):
    """Each genuine file reads as PIL reads it (and as the manifest's
    digest says), or both refuse it."""
    path = FORMATS / rel
    want = MANIFEST[rel]
    if "raises" in want:
        with pytest.raises(Exception):
            with PIL.Image.open(path) as im:
                im.convert("L")
        with pytest.raises(ValueError, match=want["raises"]):
            _image.read_gray(path)
        return
    got = check_reads_as_pil(path)
    assert hashlib.sha256(got.tobytes()).hexdigest() == want["sha256"]
    assert list(_image.read_size(path)) == want["size"]


@pytest.mark.parametrize("stem", ["synth0000", "synth0001"])
def test_lossless_pages_are_the_png_pages(stem):
    """The chain's lossless pages (predictor 1; predictor 6 with a
    restart interval) decode to the PNG page's pixels and to PIL's."""
    path = FORMATS / "pages" / (stem + ".lossless.jpg")
    got = check_reads_as_pil(path)
    np.testing.assert_array_equal(got, _png.read_gray(FULL / (stem + ".png")))


@pytest.mark.parametrize("rel", sorted(
    k for k in MANIFEST if k.startswith("more/") and
    not k.startswith("more/jpeg-")))
def test_fixture_files_match_the_manifest(rel):
    """The fixture's TIFF and BMP files (what chip_smoke.py phase 24
    checks on the card) against the manifest PIL wrote."""
    path = FORMATS / rel
    want = MANIFEST[rel]
    if "raises" in want:
        with pytest.raises(ValueError, match=want["raises"]):
            _image.read_gray(path)
        return
    got = _image.read_gray(path)
    assert hashlib.sha256(got.tobytes()).hexdigest() == want["sha256"]
    assert list(_image.read_size(path)) == want["size"]
