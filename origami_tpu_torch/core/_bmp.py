"""BMP pages without PIL, as PIL's BmpImagePlugin reads them.

Headers of 12 (OS/2), 40, 52, 56, 64, 108 and 124 bytes; 1, 4 and 8 bits
through the palette (gray where every entry is), but for PIL's own
reading of a palette whose entries are 0, 1, 2, ...: it drops the
palette and maps an uncompressed file as "L" bytes, so its rows come out
as the rows' bytes, `width` bytes from each row's start (at 4 bits the
next row's bytes, or zeros past the file's end, where the row is
shorter; at 8 bits an index past the palette its own value); 16 bits
(5-5-5, or 5-6-5 by its bit fields), 24 and 32 bits (B, G, R; the
fourth byte dropped, as PIL's "BGRX"; the bit-field layouts PIL knows);
bottom-up or top-down rows; RLE8 and RLE4 in the way PIL's own decoder
walks them. Pixels come out gray (H, W) or RGB
(H, W, 3); `read_gray` in core/_image.py takes PIL's luma of RGB.
"""

from __future__ import annotations

import struct

import numpy as np

_RAW, _RLE8, _RLE4, _BITFIELDS = 0, 1, 2, 3
# 32-bit bit-field masks (R, G, B, A) -> byte of each of R, G, B in a pixel
_MASKS32 = {
    (0xFF0000, 0xFF00, 0xFF, 0x0): (2, 1, 0),
    (0xFF000000, 0xFF0000, 0xFF00, 0x0): (3, 2, 1),
    (0xFF000000, 0xFF00, 0xFF, 0x0): (3, 1, 0),
    (0xFF000000, 0xFF0000, 0xFF00, 0xFF): (3, 2, 1),
    (0xFF, 0xFF00, 0xFF0000, 0xFF000000): (0, 1, 2),
    (0xFF0000, 0xFF00, 0xFF, 0xFF000000): (2, 1, 0),
    (0xFF000000, 0xFF00, 0xFF, 0xFF0000): (3, 1, 0),
    (0x0, 0x0, 0x0, 0x0): (2, 1, 0),
}
_MASKS16 = {(0xF800, 0x7E0, 0x1F): 16, (0x7C00, 0x3E0, 0x1F): 15}


def is_bmp(head):
    return head[:2] == b"BM"


def _header(data):
    """The fields PIL's _bitmap reads -> dict."""
    if not is_bmp(data):
        raise ValueError("not a BMP file")
    (offset,) = struct.unpack("<I", data[10:14])
    (size,) = struct.unpack("<I", data[14:18])
    hd = data[18: 14 + size]
    info = {"header_size": size, "direction": -1}
    pos = 14 + size
    if size == 12:
        w, h, _planes, bits = struct.unpack("<hhHH", hd[:8])
        info.update(width=w, height=h, bits=bits, compression=_RAW,
                    padding=3, colors=0)
    elif size in (40, 52, 56, 64, 108, 124):
        flip = hd[7] == 0xFF
        w, h = struct.unpack("<iI", hd[:8])
        if flip:
            h = 2 ** 32 - h
            info["direction"] = 1
        _planes, bits, comp = struct.unpack("<HHI", hd[8:16])
        (colors,) = struct.unpack("<I", hd[28:32])
        info.update(width=w, height=h, bits=bits, compression=comp,
                    padding=4, colors=colors)
        if comp == _BITFIELDS:
            if len(hd) >= 48:
                n = 4 if len(hd) >= 52 else 3
                masks = struct.unpack("<%dI" % n, hd[36: 36 + 4 * n])
            else:
                masks = struct.unpack("<3I", data[pos: pos + 12])
                pos += 12
            info["masks"] = tuple(masks) + (0,) * (4 - len(masks))
    else:
        raise ValueError("unsupported BMP header size %d" % size)
    if not info["colors"]:
        info["colors"] = 1 << info["bits"]
    if offset == 14 + size and info["bits"] <= 8:
        offset += 4 * info["colors"]
    info["offset"] = offset
    info["palette_at"] = pos
    return info


def read_size(data):
    info = _header(data)
    return info["width"], info["height"]


def _rle(data, info, w, h):
    """PIL's BmpRleDecoder: palette indices, rows in file order."""
    rle4 = info["compression"] == _RLE4
    out = bytearray()
    x = 0
    pos = info["offset"]
    n = len(data)
    total = w * h
    while len(out) < total:
        if pos + 2 > n:
            break
        count, byte = data[pos], data[pos + 1]
        pos += 2
        if count:
            if x + count > w:
                count = max(0, w - x)
            if rle4:
                pair = bytes((byte >> 4, byte & 0x0F))
                out += (pair * ((count + 1) // 2))[:count]
            else:
                out += bytes((byte,)) * count
            x += count
        elif byte == 0:                     # end of line
            if len(out) % w:
                out += bytes(w - len(out) % w)
            x = 0
        elif byte == 1:                     # end of bitmap
            break
        elif byte == 2:                     # delta, as PIL reads it: two
            if pos + 2 > n:                 # bytes skipped, then right, up
                break
            pos += 2
            right, up = data[pos], data[pos + 1]
            pos += 2
            out += bytes(right + up * w)
            x = len(out) % w
        else:                               # absolute run
            if rle4:
                k = byte // 2
                chunk = data[pos: pos + k]
                for b in chunk:
                    out += bytes((b >> 4, b & 0x0F))
            else:
                k = byte
                chunk = data[pos: pos + k]
                out += chunk
            pos += len(chunk)
            if len(chunk) < k:
                break
            x += byte
            if pos % 2:
                pos += 1
    idx = np.zeros(total, np.uint8)
    m = min(total, len(out))
    idx[:m] = np.frombuffer(bytes(out[:m]), np.uint8)
    return idx.reshape(h, w)


def _identity_palette(data, info):
    """BmpImagePlugin's gray test: entry i is (i, i, i) (with two
    entries: black and white); then PIL reads the data as "L" or "1"."""
    n, pad, at = info["colors"], info["padding"], info["palette_at"]
    want = (0, 255) if n == 2 else range(n)
    return n <= 256 and all(data[at + i * pad: at + i * pad + 3]
                            == bytes((v, v, v)) for i, v in enumerate(want))


def decode(data):
    """BMP bytes -> uint8 (H, W) gray or (H, W, 3) RGB."""
    info = _header(data)
    w, h, bits = info["width"], info["height"], info["bits"]
    comp = info["compression"]
    as_bytes = bits in (4, 8) and comp == _RAW and \
        _identity_palette(data, info)
    if bits not in (1, 4, 8, 16, 24, 32):
        raise ValueError("unsupported BMP pixel depth %d" % bits)
    if comp in (_RLE8, _RLE4):
        if bits not in (4, 8):
            raise ValueError("corrupt BMP: RLE at %d bits" % bits)
        px = _rle(data, info, w, h)
    elif comp in (_RAW, _BITFIELDS):
        stride = ((w * bits + 31) >> 3) & ~3
        buf = np.zeros(stride * h, np.uint8)
        src = np.frombuffer(data, np.uint8)[info["offset"]:]
        buf[: min(buf.size, src.size)] = src[: buf.size]
        rows = buf.reshape(h, stride)
        if as_bytes:        # PIL maps the rows as "L": w bytes from each
            flat = np.zeros((h - 1) * stride + w, np.uint8)
            flat[: min(flat.size, src.size)] = src[: flat.size]
            px = flat[np.arange(h)[:, None] * stride + np.arange(w)]
        elif bits == 8:
            px = rows[:, :w]
        elif bits < 8:
            bitsv = np.unpackbits(rows, axis=1)[:, : w * bits]
            weights = (1 << np.arange(bits - 1, -1, -1)).astype(np.uint8)
            px = (bitsv.reshape(h, w, bits) * weights).sum(axis=-1,
                                                           dtype=np.uint8)
        elif bits == 16:
            layout = 15
            if comp == _BITFIELDS:
                layout = _MASKS16.get(info["masks"][:3])
                if layout is None:
                    raise ValueError("unsupported BMP bit-field layout")
            v = rows[:, : 2 * w].view("<u2").astype(np.uint32)
            px = _rgb16(v, layout)
        else:
            order = (2, 1, 0)
            if comp == _BITFIELDS:
                key = info["masks"] if bits == 32 else info["masks"][:3]
                order = _MASKS32.get(key) if bits == 32 else \
                    ((2, 1, 0) if key == (0xFF0000, 0xFF00, 0xFF) else None)
                if order is None:
                    raise ValueError("unsupported BMP bit-field layout")
            nb = bits // 8
            px = rows[:, : nb * w].reshape(h, w, nb)[..., list(order)]
    else:
        raise ValueError("unsupported BMP compression %d" % comp)
    if info["direction"] == -1:
        px = px[::-1]
    if bits <= 8 and not as_bytes:
        pad = info["padding"]
        n = info["colors"]
        at = info["palette_at"]
        pal = np.frombuffer(data[at: at + pad * n], np.uint8)
        palette = np.zeros((256, 3), np.uint8)
        k = min(n, pal.size // pad, 256)
        palette[:k] = pal[: k * pad].reshape(k, pad)[:, 2::-1]
        if (palette == palette[:, :1]).all():    # gray: its luma is its
            return palette[:, 0][px]             # value, one plane will do
        return palette[px]
    return np.ascontiguousarray(px)


def _rgb16(v, layout):
    """PIL's "BGR;15" / "BGR;16" unpackers: each field scaled to 0-255
    as v * 255 // (2^bits - 1)."""
    if layout == 15:
        r, g, b = (v >> 10) & 31, (v >> 5) & 31, v & 31
        g8 = g * 255 // 31
    else:
        r, g, b = (v >> 11) & 31, (v >> 5) & 63, v & 31
        g8 = g * 255 // 63
    return np.stack([r * 255 // 31, g8, b * 255 // 31],
                    axis=-1).astype(np.uint8)


def encode_gray(px):
    """uint8 (H, W) -> the bytes of PIL's BMP of an "L" image: 8 bits
    through a gray palette, rows bottom-up, 96 dpi."""
    px = np.asarray(px, np.uint8)
    h, w = px.shape
    stride = (w + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w] = px[::-1]
    palette = np.repeat(np.arange(256, dtype=np.uint8), 4).reshape(256, 4)
    palette[:, 3] = 0
    offset = 14 + 40 + palette.size
    ppm = int(96 * 39.3701 + 0.5)
    return (b"BM" + struct.pack("<IHHI", offset + rows.size, 0, 0, offset)
            + struct.pack("<IiiHHIIiiII", 40, w, h, 1, 8, 0, rows.size,
                          ppm, ppm, 256, 256)
            + palette.tobytes() + rows.tobytes())
