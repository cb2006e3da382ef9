"""TIFF pages without PIL: frame 0 of a file, as PIL (through libtiff)
gives it for `convert("L")` / `convert("RGB")`.

Little- and big-endian files, strips or tiles, compression none,
PackBits, LZW (with horizontal predictor 2), Deflate (8 and 32946) and
CCITT Modified Huffman, Group 3 (one- and two-dimensional) and Group 4,
FillOrder 1 and 2; MinIsWhite and MinIsBlack at 1, 2, 4, 8 and 16 bits
(16 clipped at 255, as PIL's "I;16" -> "L", which leaves MinIsWhite at 16
bits uninverted), gray + alpha, RGB and RGBA
(contiguous, 8 and 16 bits: the high bytes), and palette at 1-8 bits
(the colour map's high bytes). LZW, PackBits and CCITT decode in C++
(core/tiff.cpp, the port's host library); Deflate is zlib. JPEG-in-TIFF
(compression 7, gray, RGB and YCbCr at 8 bits, strips and tiles): each
strip or tile is a JPEG of its own, decoded by core/_jpeg.py with the
JPEGTables tag spliced in front of it as libtiff does, YCbCr to RGB as
libtiff's JPEGCOLORMODE_RGB (what PIL asks for); old-style JPEG
(compression 6) where JPEGInterchangeFormat holds a whole one-component
JPEG. Old-style JPEG of three components (libtiff converts its YCbCr
itself), planar files, BigTIFF and float samples raise ValueError.
"""

from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

# the integer TIFF field types
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 13: "I"}
_COMPRESSION = {1: "none", 2: "CCITT RLE", 3: "CCITT Group 3",
                4: "CCITT Group 4", 5: "LZW", 6: "old-style JPEG",
                7: "JPEG", 8: "Deflate", 32946: "Deflate",
                32773: "PackBits"}
_FAX = (2, 3, 4)
# bits reversed within a byte (FillOrder 2)
_REVERSE = np.array([int("{:08b}".format(i)[::-1], 2) for i in range(256)],
                    np.uint8)
_ERR = 256


def is_tiff(head):
    return head[:4] in (b"II*\x00", b"MM\x00*")


def _ifd0(data):
    """{tag: tuple of values} of the first image directory, and the
    struct byte order."""
    if data[:4] in (b"II+\x00", b"MM\x00+"):
        raise ValueError("unsupported TIFF: BigTIFF")
    if not is_tiff(data):
        raise ValueError("not a TIFF file")
    bo = "<" if data[:2] == b"II" else ">"
    (off,) = struct.unpack(bo + "I", data[4:8])
    if off + 2 > len(data):
        raise ValueError("corrupt TIFF: no image directory")
    (n,) = struct.unpack(bo + "H", data[off: off + 2])
    tags = {}
    for i in range(n):
        e = off + 2 + 12 * i
        tag, typ, count = struct.unpack(bo + "HHI", data[e: e + 8])
        if tag == 347 and typ == 7:
            typ = 1           # JPEGTables: undefined bytes
        if typ not in _TYPE_FMT:
            continue          # ASCII, rationals, floats: not needed here
        size = struct.calcsize(_TYPE_FMT[typ])
        if size * count <= 4:
            raw = data[e + 8: e + 8 + size * count]
        else:
            (vo,) = struct.unpack(bo + "I", data[e + 8: e + 12])
            raw = data[vo: vo + size * count]
        if len(raw) < size * count:
            raise ValueError("corrupt TIFF: tag %d past the file's end"
                             % tag)
        tags[tag] = struct.unpack(bo + _TYPE_FMT[typ] * count, raw)
    return tags, bo


def _one(tags, tag, default=None):
    v = tags.get(tag)
    if v is None:
        if default is None:
            raise ValueError("TIFF without tag %d" % tag)
        return default
    return v[0]


def read_size(data):
    tags, _ = _ifd0(data)
    return _one(tags, 256), _one(tags, 257)


def _lib():
    from origami_tpu_torch.geometry.native_bindings import library
    return library()


def _inflate(chunk, size, compression, width, rows, t4options):
    """One strip's or tile's bytes -> `size` bytes of samples (rows
    padded to a byte), or for CCITT (rows, width) 0/1 pixels."""
    from origami_tpu_torch.geometry.native_bindings import _U8P
    src = np.frombuffer(chunk, np.uint8)
    if compression == 1:
        out = np.zeros(size, np.uint8)
        out[: min(size, src.size)] = src[: size]
        return out
    if compression in (8, 32946):
        out = np.zeros(size, np.uint8)
        raw = zlib.decompressobj().decompress(chunk, size)
        out[: len(raw)] = np.frombuffer(raw, np.uint8)
        return out
    if compression in (5, 32773):
        if compression == 5 and src.size >= 2 and src[0] == 0 \
                and src[1] & 1:
            raise ValueError("unsupported TIFF: old-style LZW codes")
        out = np.zeros(size, np.uint8)
        fn = _lib().tiff_lzw if compression == 5 else _lib().tiff_packbits
        if fn(src.ctypes.data_as(_U8P), src.size, out.ctypes.data_as(_U8P),
              size) < 0:
            raise ValueError("corrupt TIFF: bad LZW code")
        return out
    if compression in _FAX:
        out = np.zeros((rows, width), np.uint8)
        err = ctypes.create_string_buffer(_ERR)
        if _lib().tiff_fax(src.ctypes.data_as(_U8P), src.size,
                           compression, t4options, width, rows,
                           out.ctypes.data_as(_U8P), err, _ERR) < 0:
            raise ValueError("corrupt TIFF: " + err.value.decode())
        return out
    raise ValueError("unsupported TIFF compression: %s"
                     % _COMPRESSION.get(compression, compression))


def _samples(buf, rows, width, bps, spp, bo, predictor):
    """A chunk's bytes -> (rows, width, spp) samples: uint8, or uint16 at
    16 bits; bits below 8 unpacked per row."""
    row_bytes = (width * bps * spp + 7) // 8
    buf = buf[: rows * row_bytes].reshape(rows, row_bytes)
    if bps == 16:
        px = buf.view(bo + "u2").astype(np.uint16).reshape(rows, width, spp)
        if predictor == 2:
            px = np.cumsum(px, axis=1, dtype=np.uint16)
        return px
    if bps == 8:
        px = buf[:, : width * spp].reshape(rows, width, spp)
        if predictor == 2:
            px = np.cumsum(px, axis=1, dtype=np.uint8)
        return px
    if predictor == 2:
        raise ValueError("unsupported TIFF: predictor at %d bits" % bps)
    bits = np.unpackbits(buf, axis=1)[:, : width * spp * bps]
    weights = (1 << np.arange(bps - 1, -1, -1)).astype(np.uint8)
    px = (bits.reshape(rows, width * spp, bps) * weights).sum(
        axis=-1, dtype=np.uint8)
    return px.reshape(rows, width, spp)


def decode(data):
    """TIFF bytes -> uint8 (H, W) gray or (H, W, 3) RGB of frame 0."""
    tags, bo = _ifd0(data)
    width, height = _one(tags, 256), _one(tags, 257)
    compression = _one(tags, 259, 1)
    if compression not in _COMPRESSION:
        raise ValueError("unsupported TIFF compression: %s (the port reads "
                         "none, PackBits, LZW, Deflate, CCITT and JPEG)"
                         % compression)
    photometric = _one(tags, 262, 0 if compression in _FAX else 1)
    if compression == 7:
        return _jpeg_in_tiff(data, tags, photometric)
    if compression == 6:
        return _old_jpeg(data, tags, photometric)
    spp = _one(tags, 277, 1)
    bps = tags.get(258, (1,) * spp)[0]
    if _one(tags, 339, 1) != 1:
        raise ValueError("unsupported TIFF: non-integer samples")
    if spp > 1 and _one(tags, 284, 1) != 1:
        raise ValueError("unsupported TIFF: planar configuration 2")
    if photometric not in (0, 1, 2, 3):
        raise ValueError("unsupported TIFF: photometric interpretation %d"
                         % photometric)
    if bps not in (1, 2, 4, 8, 16) or (photometric == 2 and bps < 8) or \
            (photometric == 3 and bps > 8):
        raise ValueError("unsupported TIFF: %d bits a sample" % bps)
    if compression in _FAX and (bps != 1 or spp != 1):
        raise ValueError("corrupt TIFF: CCITT data of %d x %d bits"
                         % (spp, bps))
    if 1 in tags.get(338, ()):
        raise ValueError("unsupported TIFF: associated (premultiplied) "
                         "alpha")
    predictor = _one(tags, 317, 1)
    if predictor not in (1, 2):
        raise ValueError("unsupported TIFF: predictor %d" % predictor)
    t4options = _one(tags, 292, 0)
    reverse = _one(tags, 266, 1) == 2
    if 322 in tags:
        cw, ch = _one(tags, 322), _one(tags, 323)
        offsets, counts = tags.get(324), tags.get(325)
    else:
        cw, ch = width, min(_one(tags, 278, height), height)
        offsets, counts = tags.get(273), tags.get(279)
    if offsets is None or counts is None:
        raise ValueError("corrupt TIFF: no strip or tile offsets")
    across = -(-width // cw)
    out = np.zeros((height, width, spp),
                   np.uint16 if bps == 16 else np.uint8)
    row_bytes = (cw * bps * spp + 7) // 8
    for i, (off, cnt) in enumerate(zip(offsets, counts)):
        y0, x0 = (i // across) * ch, (i % across) * cw
        if y0 >= height:
            break
        rows = ch if 322 in tags else min(ch, height - y0)
        chunk = data[off: off + cnt]
        if reverse:
            chunk = _REVERSE[np.frombuffer(chunk, np.uint8)].tobytes()
        buf = _inflate(chunk, rows * row_bytes, compression, cw, rows,
                       t4options)
        if compression in _FAX:
            px = buf[:, :, None]      # 1 = black: as 1-bit samples
        else:
            px = _samples(buf, rows, cw, bps, spp, bo, predictor)
        h, w = min(rows, height - y0), min(cw, width - x0)
        out[y0: y0 + h, x0: x0 + w] = px[:h, :w]
    return _convert(out, photometric, bps, spp, tags)


# an APP14 "Adobe" segment that sets libjpeg's colour space for a strip:
# transform 0 = as stored (libtiff's photometric RGB and gray), 1 = YCbCr
# (photometric YCbCr under JPEGCOLORMODE_RGB)
_ADOBE = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00"


def _jpeg_in_tiff(data, tags, photometric):
    """Compression 7: each strip or tile through core/_jpeg.py -> uint8
    (H, W) gray or (H, W, 3) RGB."""
    from origami_tpu_torch.core import _jpeg
    width, height = _one(tags, 256), _one(tags, 257)
    spp = _one(tags, 277, 1)
    bps = tags.get(258, (8,) * spp)[0]
    if bps != 8:
        raise ValueError("unsupported TIFF: JPEG of %d bits a sample" % bps)
    if spp > 1 and _one(tags, 284, 1) != 1:
        raise ValueError("unsupported TIFF: planar configuration 2")
    if (photometric, spp) not in ((1, 1), (2, 3), (6, 3)):
        raise ValueError("unsupported TIFF: JPEG of photometric "
                         "interpretation %d with %d samples"
                         % (photometric, spp))
    tables = bytes(tags.get(347, ()))
    if tables and (tables[:2] != b"\xff\xd8" or tables[-2:] != b"\xff\xd9"):
        raise ValueError("corrupt TIFF: JPEGTables")
    if 322 in tags:
        cw, ch = _one(tags, 322), _one(tags, 323)
        offsets, counts = tags.get(324), tags.get(325)
    else:
        cw, ch = width, min(_one(tags, 278, height), height)
        offsets, counts = tags.get(273), tags.get(279)
    if offsets is None or counts is None:
        raise ValueError("corrupt TIFF: no strip or tile offsets")
    across = -(-width // cw)
    out = np.zeros((height, width, 3 if spp == 3 else 1), np.uint8)
    colour = _ADOBE + (b"\x01" if photometric == 6 else b"\x00")
    for i, (off, cnt) in enumerate(zip(offsets, counts)):
        y0, x0 = (i // across) * ch, (i % across) * cw
        if y0 >= height:
            break
        chunk = data[off: off + cnt]
        if chunk[:2] != b"\xff\xd8":
            raise ValueError("corrupt TIFF: a JPEG strip without SOI")
        # the tables' SOI ... their EOI left out, the strip's SOI left out
        px = _jpeg.decode(b"\xff\xd8" + colour + tables[2:-2] + chunk[2:])
        h, w = min(px.shape[0], height - y0), min(px.shape[1], width - x0)
        out[y0: y0 + h, x0: x0 + w] = px.reshape(px.shape[0], px.shape[1],
                                                 -1)[:h, :w]
    return out[..., 0] if spp == 1 else out


def _old_jpeg(data, tags, photometric):
    """Compression 6 with JPEGInterchangeFormat: the whole JPEG there, as
    libtiff's OJPEG codec gives its one component."""
    from origami_tpu_torch.core import _jpeg
    spp = _one(tags, 277, 1)
    if 513 not in tags or spp != 1 or photometric != 1:
        raise ValueError("unsupported TIFF: old-style JPEG %s" % (
            "without JPEGInterchangeFormat" if 513 not in tags else
            "of %d samples, photometric interpretation %d"
            % (spp, photometric)))
    off = _one(tags, 513)
    stream = data[off: off + _one(tags, 514, len(data) - off)]
    if stream[:2] != b"\xff\xd8":
        raise ValueError("corrupt TIFF: old-style JPEG without SOI")
    px = _jpeg.decode(stream)
    if px.shape != (_one(tags, 257), _one(tags, 256)):
        raise ValueError("corrupt TIFF: old-style JPEG of %s pixels in a "
                         "%d x %d image" % (px.shape, _one(tags, 256),
                                            _one(tags, 257)))
    return px


def _convert(px, photometric, bps, spp, tags):
    """Samples -> what PIL's convert("L") / convert("RGB") gives."""
    if photometric == 3:
        cmap = np.asarray(tags.get(320, ()), np.uint16)
        n = 1 << bps
        if cmap.size != 3 * n:
            raise ValueError("corrupt TIFF: colour map of %d values"
                             % cmap.size)
        palette = (cmap.reshape(3, n).T >> 8).astype(np.uint8)
        return palette[px[..., 0]]
    if photometric == 2:
        if spp < 3:
            raise ValueError("corrupt TIFF: RGB with %d samples" % spp)
        rgb = px[..., :3]
        return np.ascontiguousarray(
            (rgb >> 8).astype(np.uint8) if bps == 16 else rgb)
    g = px[..., 0]
    if bps == 16:            # PIL reads MinIsWhite too as plain "I;16"
        return np.minimum(g, 255).astype(np.uint8)
    if bps < 8:
        g = g * np.uint8(255 // ((1 << bps) - 1))
    if photometric == 0:
        g = 255 - g
    return np.ascontiguousarray(g)


def encode_gray(px):
    """uint8 (H, W) -> the bytes of PIL's uncompressed TIFF of an "L"
    image: little-endian, one strip after the first IFD."""
    px = np.asarray(px, np.uint8)
    h, w = px.shape
    entries = ((256, 4, w), (257, 4, h), (258, 3, 8), (259, 3, 1),
               (262, 3, 1), (273, 4, None), (278, 4, h), (279, 4, w * h),
               (284, 3, 1))
    offset = 8 + 2 + 12 * len(entries) + 4
    ifd = struct.pack("<H", len(entries))
    for tag, typ, val in entries:
        val = offset if val is None else val
        ifd += struct.pack("<HHI", tag, typ, 1) + (
            struct.pack("<HH", val, 0) if typ == 3 else struct.pack("<I", val))
    return b"II*\x00" + struct.pack("<I", 8) + ifd + b"\x00" * 4 + \
        np.ascontiguousarray(px).tobytes()
