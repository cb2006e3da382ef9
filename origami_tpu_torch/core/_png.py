"""A small PNG reader and writer: zlib + numpy (un)filtering.

Reads what the corpora of this project hold (PIL-written pages): 8-bit
grayscale or RGB and 1-bit grayscale (PIL's mode "1", read as 0 and 255,
as its `convert("L")` gives), non-interlaced. Everything else raises
ValueError. `read_gray` converts color the way PIL's `convert("L")` does
(ITU-R 601-2 luma in 16-bit fixed point), so pixels match the reference
loader exactly. `encode_bilevel` / `write_bilevel` write the 1-bit
grayscale PNG that PIL writes for a mode "1" image. `encode_rgb` /
`write_rgb` write 8-bit RGB (colour type 2): the annotation renders.
`encode_paletted` / `decode_paletted` write and read the paletted label
maps of segment.zip (colour type 3 with a PLTE chunk).
Keeps the port free of PIL.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3}


def _chunks(data):
    i = len(_SIG)
    while i + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[i: i + 8])
        yield kind, data[i + 8: i + 8 + n]
        i += 12 + n
        if kind == b"IEND":
            return
    raise ValueError("PNG ends without IEND")


def read_size(path):
    """(width, height) from the IHDR chunk, without decoding."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != _SIG or head[12:16] != b"IHDR":
        raise ValueError("%s is not a PNG file" % path)
    return struct.unpack(">II", head[16:24])


def _unfilter(raw, h, stride, bpp):
    """Undo the per-row PNG filters (types 0-4) of `raw`."""
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype = rows[y, 0]
        line = rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        elif ftype == 1:
            # Sub: a running sum per interleaved channel
            cur = (np.cumsum(line.reshape(-1, bpp), axis=0) & 0xFF) \
                .reshape(stride)
        elif ftype in (3, 4):
            # Average / Paeth: nonlinear left recurrences, per byte
            # (on Python ints: numpy scalar indexing is slower here)
            lin, up = line.tolist(), prev.tolist()
            res = [0] * stride
            for x in range(stride):
                a = res[x - bpp] if x >= bpp else 0
                b = up[x]
                if ftype == 3:
                    p = (a + b) >> 1
                else:
                    c = up[x - bpp] if x >= bpp else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    p = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                res[x] = (lin[x] + p) & 0xFF
            cur = np.asarray(res, np.int32)
        else:
            raise ValueError("bad PNG filter type %d" % ftype)
        out[y] = cur
        prev = cur
    return out


def _parse(data, what="data"):
    """(IHDR fields, PLTE bytes or None, decompressed scanlines)."""
    if data[:8] != _SIG:
        raise ValueError("%s is not a PNG file" % what)
    ihdr = plte = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"PLTE":
            plte = body
    if ihdr is None:
        raise ValueError("PNG without IHDR")
    if ihdr[6] != 0:
        raise ValueError("interlaced PNGs are not supported")
    return ihdr, plte, zlib.decompress(b"".join(idat))


def read(path):
    """Decode a PNG file into uint8 (H, W) or (H, W, C)."""
    with open(path, "rb") as f:
        return decode(f.read(), path)


def decode(data, what="data"):
    """Decode PNG bytes into uint8 (H, W) or (H, W, C)."""
    (w, h, depth, ctype, _c, _f, _i), _plte, raw = _parse(data, what)
    if depth == 1 and ctype == 0:
        rows = _unfilter(raw, h, (w + 7) // 8, 1)
        bits = np.unpackbits(rows, axis=1)[:, :w]
        return np.ascontiguousarray(bits * np.uint8(255))
    if depth != 8 or ctype not in _CHANNELS:
        raise ValueError("unsupported PNG (depth %d, color type %d)"
                         % (depth, ctype))
    ch = _CHANNELS[ctype]
    px = _unfilter(raw, h, w * ch, ch)
    return px.reshape(h, w, ch)[..., 0] if ch == 1 else px.reshape(h, w, ch)


def decode_paletted(data):
    """PNG bytes of colour type 3 -> (uint8 (H, W) palette indices,
    uint8 (n, 3) palette). Bit depths 1, 2, 4 and 8."""
    (w, h, depth, ctype, _c, _f, _i), plte, raw = _parse(data)
    if ctype != 3 or depth not in (1, 2, 4, 8) or plte is None:
        raise ValueError("not a paletted PNG (depth %d, color type %d)"
                         % (depth, ctype))
    stride = (w * depth + 7) // 8
    rows = _unfilter(raw, h, stride, 1)
    if depth < 8:
        bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)
        weights = 1 << np.arange(depth - 1, -1, -1)
        rows = (bits * weights).sum(axis=-1).astype(np.uint8)
    palette = np.frombuffer(plte, np.uint8).reshape(-1, 3)
    return np.ascontiguousarray(rows[:, :w]), palette


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body \
        + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def encode_paletted(indices, palette, level=1):
    """uint8 (H, W) palette indices + uint8 (n <= 256, 3) palette -> PNG
    bytes: colour type 3, 8 bits, every row with filter 0, zlib `level`."""
    idx = np.ascontiguousarray(indices, np.uint8)
    if idx.ndim != 2:
        raise ValueError("indices must be (H, W)")
    pal = np.ascontiguousarray(palette, np.uint8).reshape(-1, 3)
    if not 1 <= len(pal) <= 256:
        raise ValueError("a palette holds 1..256 colours")
    h, w = idx.shape
    rows = np.zeros((h, w + 1), np.uint8)
    rows[:, 1:] = idx
    return b"".join([
        _SIG,
        _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 3, 0, 0, 0)),
        _chunk(b"PLTE", pal.tobytes()),
        _chunk(b"IDAT", zlib.compress(rows.tobytes(), level)),
        _chunk(b"IEND", b"")])


_GRAY_LEVEL = 6  # zlib's default level


def encode_gray(pixels):
    """uint8 (H, W) gray pixels -> PNG bytes: colour type 0, 8 bits,
    every row with filter 0, zlib level `_GRAY_LEVEL`. (PIL writes
    other bytes for the same pixels; both decode to them.)"""
    px = np.ascontiguousarray(pixels, np.uint8)
    if px.ndim != 2:
        raise ValueError("pixels must be (H, W)")
    h, w = px.shape
    rows = np.zeros((h, w + 1), np.uint8)
    rows[:, 1:] = px
    return b"".join([
        _SIG,
        _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)),
        _chunk(b"IDAT", zlib.compress(rows.tobytes(), _GRAY_LEVEL)),
        _chunk(b"IEND", b"")])


def write_gray(path, pixels):
    with open(path, "wb") as f:
        f.write(encode_gray(pixels))


# zlib level 1: a page render compresses 4x faster than at 6
_RGB_LEVEL = 1


def encode_rgb(pixels):
    """uint8 (H, W, 3) RGB pixels -> PNG bytes: colour type 2, 8 bits,
    every row with filter 0, zlib level `_RGB_LEVEL`."""
    px = np.ascontiguousarray(pixels, np.uint8)
    if px.ndim != 3 or px.shape[2] != 3:
        raise ValueError("pixels must be (H, W, 3)")
    h, w, _ = px.shape
    rows = np.zeros((h, 3 * w + 1), np.uint8)
    rows[:, 1:] = px.reshape(h, 3 * w)
    return b"".join([
        _SIG,
        _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)),
        _chunk(b"IDAT", zlib.compress(rows.tobytes(), _RGB_LEVEL)),
        _chunk(b"IEND", b"")])


def write_rgb(path, pixels):
    with open(path, "wb") as f:
        f.write(encode_rgb(pixels))


def encode_bilevel(mask):
    """bool (H, W) mask, True = white -> PNG bytes: colour type 0, 1 bit,
    8 pixels a byte from the most significant bit, rows padded to a
    byte, every row with filter 0, zlib level `_GRAY_LEVEL`."""
    m = np.asarray(mask)
    if m.ndim != 2:
        raise ValueError("mask must be (H, W)")
    h, w = m.shape
    packed = np.packbits(m.astype(bool), axis=1)
    rows = np.zeros((h, packed.shape[1] + 1), np.uint8)
    rows[:, 1:] = packed
    return b"".join([
        _SIG,
        _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 1, 0, 0, 0, 0)),
        _chunk(b"IDAT", zlib.compress(rows.tobytes(), _GRAY_LEVEL)),
        _chunk(b"IEND", b"")])


def write_bilevel(path, mask):
    with open(path, "wb") as f:
        f.write(encode_bilevel(mask))


def to_gray(px):
    """PIL `convert("L")`: L = (19595 R + 38470 G + 7471 B + 2^15) >> 16."""
    if px.ndim == 2:
        return px
    rgb = px.astype(np.uint32)
    lum = (rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471
           + 0x8000) >> 16
    return lum.astype(np.uint8)


def read_gray(path):
    return to_gray(read(path))
