"""A PNG reader and writer: zlib, numpy and the host library's unfilter.

Reads every PNG that PIL reads, as PIL's `convert("L")` and
`convert("RGB")` give it: gray at 1, 2, 4, 8 and 16 bits (1-bit as 0 and
255, 2 and 4 bits scaled to 0-255, 16 bits clipped at 255 as PIL's
"I;16" -> "L"), RGB at 8 and 16 bits (16: the high bytes), paletted
at 1-8 bits (through the palette), gray + alpha and RGBA (the alpha
dropped), plain or Adam7-interlaced. `read_gray` converts colour the
way PIL's `convert("L")` does (ITU-R 601-2 luma in 16-bit fixed point),
so pixels match the reference loader exactly. The row filters are
undone in C++ (png.cpp, in the port's host library).
`encode_bilevel` / `write_bilevel` write the 1-bit grayscale PNG that
PIL writes for a mode "1" image. `encode_rgb` writes 8-bit RGB (colour
type 2). `encode_paletted` /
`decode_paletted` write and read the paletted label maps of segment.zip
(colour type 3 with a PLTE chunk). Keeps the port free of PIL.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
# samples a pixel of each colour type
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _chunks(data):
    i = len(_SIG)
    while i + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[i: i + 8])
        yield kind, data[i + 8: i + 8 + n]
        i += 12 + n
        if kind == b"IEND":
            return
    raise ValueError("PNG ends without IEND")


def comment(data):
    """PIL's info["comment"] of a loaded PNG, as PIL writes it into a
    JPEG (UTF-8): the text of the last tEXt, zTXt or iTXt chunk whose
    keyword is "comment", or None."""
    found = None
    for kind, body in _chunks(data):
        key, _, rest = body.partition(b"\0")
        if kind not in (b"tEXt", b"zTXt", b"iTXt") or key != b"comment":
            continue
        if kind == b"tEXt":
            found = rest.decode("latin-1", "replace")
        elif kind == b"zTXt":
            found = zlib.decompress(rest[1:]).decode("latin-1", "replace")
        else:
            _, _, value = rest[2:].split(b"\0", 2)
            found = (zlib.decompress(value) if rest[0] else value).decode(
                "utf-8")
    return None if found is None else found.encode("utf-8")


def read_size(path):
    """(width, height) from the IHDR chunk, without decoding."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != _SIG or head[12:16] != b"IHDR":
        raise ValueError("%s is not a PNG file" % path)
    return struct.unpack(">II", head[16:24])


def _unfilter(raw, h, stride, bpp):
    """Undo the per-row PNG filters (types 0-4) of `raw` (h rows of
    1 + stride bytes) -> uint8 (h, stride)."""
    from origami_tpu_torch.geometry.native_bindings import _U8P, library
    raw = np.frombuffer(raw, np.uint8)
    if raw.size < h * (stride + 1):
        raise ValueError("PNG image data ends early")
    out = np.empty((h, stride), np.uint8)
    bad = library().png_unfilter(raw.ctypes.data_as(_U8P), h, stride, bpp,
                                 out.ctypes.data_as(_U8P))
    if bad:
        raise ValueError("bad PNG filter type in row %d" % (-bad - 1))
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
    return ihdr, plte, zlib.decompress(b"".join(idat))


def _samples(rows, w, depth, ch):
    """Unfiltered rows -> (h, w, ch) samples: uint8 below 16 bits (the
    raw values), uint16 at 16."""
    h = rows.shape[0]
    if depth == 16:
        px = rows[:, : 2 * w * ch].reshape(h, w * ch, 2).astype(np.uint16)
        return ((px[..., 0] << 8) | px[..., 1]).reshape(h, w, ch)
    if depth < 8:
        bits = np.unpackbits(rows, axis=1)[:, : w * depth]
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        px = (bits.reshape(h, w, depth) * weights).sum(axis=-1,
                                                        dtype=np.uint8)
        return px[..., None]
    return rows[:, : w * ch].reshape(h, w, ch)


def _pixels(raw, w, h, depth, ctype, interlace):
    """The decompressed image data -> (h, w, samples) of the file's
    depth, Adam7 passes put in place."""
    ch = _CHANNELS[ctype]
    bpp = max(1, depth * ch // 8)
    if not interlace:
        stride = (w * ch * depth + 7) // 8
        return _samples(_unfilter(raw, h, stride, bpp), w, depth, ch)
    out = np.zeros((h, w, ch), np.uint16 if depth == 16 else np.uint8)
    off = 0
    for x0, y0, dx, dy in _ADAM7:
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue
        stride = (pw * ch * depth + 7) // 8
        n = ph * (stride + 1)
        rows = _unfilter(raw[off: off + n], ph, stride, bpp)
        out[y0::dy, x0::dx] = _samples(rows, pw, depth, ch)
        off += n
    return out


def read(path):
    """Decode a PNG file into uint8 (H, W) or (H, W, C)."""
    with open(path, "rb") as f:
        return decode(f.read(), path)


def decode(data, what="data"):
    """Decode PNG bytes into uint8 (H, W) gray or (H, W, 3) RGB, as PIL's
    convert("L") / convert("RGB") give the file's pixels."""
    (w, h, depth, ctype, _c, _f, interlace), plte, raw = _parse(data, what)
    if depth not in _DEPTHS.get(ctype, ()) or interlace > 1:
        raise ValueError("unsupported PNG (depth %d, color type %d)"
                         % (depth, ctype))
    px = _pixels(raw, w, h, depth, ctype, interlace)
    if ctype == 3:
        if plte is None:
            raise ValueError("paletted PNG without PLTE")
        palette = np.zeros((256, 3), np.uint8)
        pal = np.frombuffer(plte, np.uint8)[: 768]
        palette.reshape(-1)[: pal.size - pal.size % 3] = \
            pal[: pal.size - pal.size % 3]
        return palette[px[..., 0]]
    if ctype == 0:
        g = px[..., 0]
        if depth == 16:      # PIL's "I;16" -> "L": clipped, not scaled
            return np.minimum(g, 255).astype(np.uint8)
        if depth < 8:        # PIL's "1", "L;2", "L;4": scaled to 0-255
            return g * np.uint8(255 // ((1 << depth) - 1))
        return np.ascontiguousarray(g)
    if depth == 16:          # "RGB;16B", "LA;16B", "RGBA;16B": high bytes
        px = (px >> 8).astype(np.uint8)
    if ctype == 4:           # gray + alpha: the gray
        return np.ascontiguousarray(px[..., 0])
    return np.ascontiguousarray(px[..., :3])


def decode_paletted(data):
    """PNG bytes of colour type 3 -> (uint8 (H, W) palette indices,
    uint8 (n, 3) palette). Bit depths 1, 2, 4 and 8."""
    (w, h, depth, ctype, _c, _f, interlace), plte, raw = _parse(data)
    if interlace:
        raise ValueError("interlaced label maps are not supported")
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


# zlib level 1: a page-sized RGB image compresses 4x faster than at 6
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
