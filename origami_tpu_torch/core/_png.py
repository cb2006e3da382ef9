"""A small PNG reader: zlib + numpy unfiltering.

Reads what the corpora of this project hold (PIL-written pages): 8-bit
grayscale or RGB, non-interlaced. Everything else raises ValueError.
`read_gray` converts color the way PIL's `convert("L")` does (ITU-R
601-2 luma in 16-bit fixed point), so pixels match the reference loader
exactly. Keeps the port free of PIL.
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


def read(path):
    """Decode a PNG into uint8 (H, W) or (H, W, C)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIG:
        raise ValueError("%s is not a PNG file" % path)
    ihdr = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"PLTE":
            raise ValueError("palette PNGs are not supported")
    if ihdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _comp, _filt, interlace = ihdr
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError("unsupported PNG (depth %d, color type %d, "
                         "interlace %d)" % (depth, ctype, interlace))
    ch = _CHANNELS[ctype]
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch, ch)
    return px.reshape(h, w, ch)[..., 0] if ch == 1 else px.reshape(h, w, ch)


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
