"""TIFF pages without PIL: frame 0 of a file, as PIL (through libtiff)
gives it for `convert("L")` / `convert("RGB")`.

Little- and big-endian files and little-endian BigTIFF (8-byte offsets,
LONG8 and IFD8 fields), strips or tiles, chunky or planar (one set of
strips or tiles a sample), compression none, PackBits, LZW (and
old-style LZW: LSB-first codes, libtiff's LZWDecodeCompat), Deflate (8
and 32946) and CCITT Modified Huffman, Group 3 (one- and
two-dimensional) and Group 4, FillOrder 1 and 2; the horizontal
predictor 2 and the floating-point predictor 3 under LZW and Deflate
(libtiff's codecs that take one; PIL ignores the tag under the others);
MinIsWhite and MinIsBlack at 1, 2, 4, 8, 12 and 16 bits (12 and 16
clipped at 255, as PIL's "I;12" / "I;16" -> "L", which leaves
MinIsWhite at 16 bits uninverted; MinIsWhite where the tag is missing,
as PIL defaults), signed samples (8 bits read as unsigned "L", 16 and
32 as PIL's mode I), float32 (mode F) and little-endian unsigned 32
bits (PIL's "I;32N"), each clipped into "L" as PIL's i2l and f2l clip;
gray + alpha, RGB and RGBA (8 and 16 bits: the high bytes), RGB with
associated alpha (unpremultiplied as PIL's "RGBa" unpacker), CMYK (8
and 16 bits, through Pillow's cmyk2rgb) and palette at 1-8 bits (the
colour map's high bytes). LZW, PackBits and CCITT decode in C++
(core/tiff.cpp, the port's host library); Deflate is zlib.

YCbCr (photometric 6) outside JPEG goes PIL's two ways. Compressed, it
goes through libtiff's RGBA reader: every sub-sampling that reader takes
(4x4, 4x2, 4x1, 2x2, 2x1, 1x2, 1x1; planes at 1x1 only), its strip
reads of TIFFScanlineSize rows, its 4x4 tile skip, a predictor it
cannot undo left undone and a chunk that decodes short read as far as
it goes (the reader does not stop on errors), then TIFFYCbCrToRGB
(`_ycbcr_rgb`: YCbCrCoefficients and ReferenceBlackWhite in float32 and
16-bit fixed point). Uncompressed, PIL reads the bytes itself as
"RGBX" (`_raw_ycbcr`), whatever the sub-sampling; one sample is "L".

JPEG-in-TIFF (compression 7, gray, RGB and YCbCr at 8 bits, strips and
tiles): each strip or tile is a JPEG of its own, decoded by
core/_jpeg.py with the JPEGTables tag spliced in front of it as libtiff
does, YCbCr to RGB as libtiff's JPEGCOLORMODE_RGB (what PIL asks for).
Old-style JPEG (compression 6) as libtiff's OJPEG codec reads it
(`_old_jpeg`): the stream it builds from a JPEGInterchangeFormat stream
or from the tables tags, with the strips' data; one component decoded
to gray, three as libjpeg's raw planes (`_jpeg.planes`) through the
RGBA reader's YCbCr conversion.

Planes go the two ways PIL takes them. Through libtiff (every
compression but none), Pillow's strip decoder takes a plane a band of
its mode, its tile decoder the first planes, and RGBA planes whose first
extra sample is associated or unspecified come out unpremultiplied.
Uncompressed, PIL reads them itself (`_raw_planar`): each plane through
the unpacker of its letter in the rawmode, which for one sample a pixel
drops MinIsWhite, FillOrder 2 and the sample width ("L" reads bytes).

What PIL does not read raises ValueError: a sample layout outside
PIL's table (TiffImagePlugin.OPEN_INFO, `_PIL_LAYOUTS`), big-endian
BigTIFF (PIL takes it for a classic TIFF), CIELab (PIL cannot convert
mode LAB), YCbCr sub-samplings and layouts libtiff's RGBA reader has no
routine for, old-style JPEG that libtiff refuses (progressive or
arithmetic frames, Cb or Cr sub-sampled, a frame that does not fit the
image, strips that are not whole restart intervals), planar JPEG,
planes or rawmodes Pillow has no unpacker for, planes in strips that
are not one a band, a compressed chunk that decodes short outside the
RGBA reader, an uncompressed one that PIL's reads take past the file's
end. The port also refuses two kinds that PIL reads through a fault: a
palette with an extra plane in tiles, which Pillow unpacks past each
row's end, and big-endian old-style JPEG in several strips, which
libtiff reads skipping strips. Where libtiff decodes a big-endian file
of 16- or 32-bit signed or float samples, it hands PIL the samples in
the host's (little-endian) order and PIL unpacks them as big-endian:
the port gives the byte-swapped values PIL gives.
"""

from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

# the integer TIFF field types (16-18: BigTIFF's LONG8, SLONG8, IFD8)
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 13: "I",
             16: "Q", 17: "q", 18: "Q"}
_COMPRESSION = {1: "none", 2: "CCITT RLE", 3: "CCITT Group 3",
                4: "CCITT Group 4", 5: "LZW", 6: "old-style JPEG",
                7: "JPEG", 8: "Deflate", 32946: "Deflate",
                32773: "PackBits"}
_FAX = (2, 3, 4)
# bits reversed within a byte (FillOrder 2)
_REVERSE = np.array([int("{:08b}".format(i)[::-1], 2) for i in range(256)],
                    np.uint8)
_ERR = 256

# The sample layouts PIL knows (TiffImagePlugin.OPEN_INFO, Pillow 12):
# (photometric, sample formats, fill order, bits a sample, extra samples)
# -> the byte orders it knows each in. PIL refuses every other layout.
_PIL_LAYOUTS = {(photometric, (1,), fill, (bits,), ()): "<>"
                for photometric in (0, 1, 3) for fill in (1, 2)
                for bits in (1, 2, 4, 8)}
_PIL_LAYOUTS.update({
    (0, (1,), 1, (16,), ()): "<", (0, (3,), 1, (32,), ()): "<>",
    (1, (1,), 1, (12,), ()): "<", (1, (1,), 1, (16,), ()): "<>",
    (1, (1,), 2, (16,), ()): "<", (1, (1,), 1, (32,), ()): "<",
    (1, (2,), 1, (8,), ()): "<>", (1, (2,), 1, (16,), ()): "<>",
    (1, (2,), 1, (32,), ()): "<>", (1, (3,), 1, (32,), ()): "<>",
    (1, (1,), 1, (8, 8), (2,)): "<>",
    (2, (1,), 1, (8,) * 3, ()): "<>", (2, (1,), 2, (8,) * 3, ()): "<>",
    (2, (1,), 1, (16,) * 3, ()): "<>",
    (3, (1,), 1, (8, 8), (0,)): "<>", (3, (1,), 1, (8, 8), (2,)): "<>",
    (5, (1,), 1, (8,) * 4, ()): "<>", (5, (1,), 1, (8,) * 5, (0,)): "<>",
    (5, (1,), 1, (8,) * 6, (0, 0)): "<>", (5, (1,), 1, (16,) * 4, ()): "<>",
    (6, (1,), 1, (8,), ()): "<>", (6, (1,), 1, (8,) * 3, ()): "<>",
    (8, (1,), 1, (8,) * 3, ()): "<>"})
_PIL_LAYOUTS.update({
    (2, (1,), 1, (8,) * (4 + len(rest)), (alpha,) + rest): "<>"
    for rest in ((), (0,), (0, 0)) for alpha in (0, 1, 2)})
_PIL_LAYOUTS.update({(2, (1,), 1, (8,) * 4, extra): "<>"
                     for extra in ((), (999,))})
_PIL_LAYOUTS.update({(2, (1,), 1, (16,) * 4, extra): "<>"
                     for extra in ((), (0,), (1,), (2,))})


def is_tiff(head):
    return head[:4] in (b"II*\x00", b"MM\x00*")


def _ifd0(data):
    """{tag: tuple of values} of the first image directory, and the
    struct byte order."""
    if data[:4] == b"MM\x00+":
        raise ValueError("unsupported TIFF: big-endian BigTIFF (PIL takes "
                         "it for a classic TIFF and cannot read it)")
    big = data[:4] == b"II+\x00"
    if not (big or is_tiff(data)):
        raise ValueError("not a TIFF file")
    bo = "<" if data[:2] == b"II" else ">"
    if big:
        # BigTIFF: offset size 8, 8-byte entry counts, 20-byte entries
        size, _, off = struct.unpack(bo + "HHQ", data[4:16])
        if size != 8:
            raise ValueError("corrupt BigTIFF: offset size %d" % size)
        count_fmt, entry, field = "Q", 20, 8
    else:
        (off,) = struct.unpack(bo + "I", data[4:8])
        count_fmt, entry, field = "H", 12, 4
    head = struct.calcsize(count_fmt)
    if off + head > len(data):
        raise ValueError("corrupt TIFF: no image directory")
    (n,) = struct.unpack(bo + count_fmt, data[off: off + head])
    tags = {}
    for i in range(n):
        e = off + head + entry * i
        tag, typ, count = struct.unpack(bo + ("HHQ" if big else "HHI"),
                                        data[e: e + 4 + field])
        e += 4 + field        # the value field
        if tag == 347 and typ == 7:
            typ = 1           # JPEGTables: undefined bytes
        if typ not in _TYPE_FMT and typ != 5:
            continue          # ASCII, signed rationals, floats: not needed
        size = 8 if typ == 5 else struct.calcsize(_TYPE_FMT[typ])
        if size * count <= field:
            raw = data[e: e + size * count]
        else:
            (vo,) = struct.unpack(bo + ("Q" if big else "I"),
                                  data[e: e + field])
            raw = data[vo: vo + size * count]
        if len(raw) < size * count:
            raise ValueError("corrupt TIFF: tag %d past the file's end"
                             % tag)
        if typ == 5:          # as libtiff reads them: float(num) / float(den)
            v = np.frombuffer(raw, bo + "u4").astype(np.float32)
            num, den = v[0::2], v[1::2]
            tags[tag] = tuple(np.where(den == 0, np.float32(0), num / np.where(
                den == 0, np.float32(1), den)))
        else:
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


def _inflate(chunk, size, compression, width, rows, t4options,
             short=False):
    """One strip's or tile's bytes -> `size` bytes of samples (rows
    padded to a byte), or for CCITT (rows, width) 0/1 pixels. `short`:
    a chunk that decodes short gives its bytes, then zeros."""
    from origami_tpu_torch.geometry.native_bindings import _U8P
    src = np.frombuffer(chunk, np.uint8)
    if compression == 1:
        out = np.zeros(size, np.uint8)
        out[: min(size, src.size)] = src[: size]
        return out
    # libtiff refuses a chunk that decodes short ("Not enough data")
    if compression in (8, 32946):
        try:
            raw = zlib.decompressobj().decompress(chunk, size)
        except zlib.error as e:
            raise ValueError("corrupt TIFF: Deflate data: %s" % e) from None
        if len(raw) < size and not short:
            raise ValueError("corrupt TIFF: Deflate data ends early")
        out = np.zeros(size, np.uint8)
        out[: len(raw)] = np.frombuffer(raw, np.uint8)
        return out
    if compression in (5, 32773):
        out = np.zeros(size, np.uint8)
        fn = _lib().tiff_packbits
        if compression == 5:
            # libtiff takes a chunk whose first code (CLEAR) reads LSB
            # first for old-style LZW (LZWDecodeCompat)
            old = src.size >= 2 and src[0] == 0 and src[1] & 1
            fn = _lib().tiff_lzw_compat if old else _lib().tiff_lzw
        got = fn(src.ctypes.data_as(_U8P), src.size,
                 out.ctypes.data_as(_U8P), size)
        if got < 0:
            raise ValueError("corrupt TIFF: bad LZW code")
        if got < size and not short:
            raise ValueError("corrupt TIFF: %s data ends early"
                             % _COMPRESSION[compression])
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
    12 and 16 bits; bits below 8 and 12-bit samples (packed most
    significant bit first, as Pillow's "I;12" unpacks them) unpacked per
    row."""
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
    dtype = np.uint16 if bps > 8 else np.uint8
    bits = np.unpackbits(buf, axis=1)[:, : width * spp * bps]
    weights = (1 << np.arange(bps - 1, -1, -1)).astype(dtype)
    px = (bits.reshape(rows, width * spp, bps) * weights).sum(
        axis=-1, dtype=dtype)
    return px.reshape(rows, width, spp)


def _typed_samples(buf, rows, width, dtype, bo, predictor):
    """A chunk of one 16- or 32-bit signed or float sample a pixel ->
    (rows, width, 1) values of `dtype`: predictor 2 adds the integer
    words along the row, predictor 3 is libtiff's fpAcc (bytes added
    along the row, then each value's bytes gathered from byte planes,
    the most significant plane first)."""
    size = np.dtype(dtype).itemsize
    buf = buf[: rows * width * size].reshape(rows, width * size)
    if predictor == 3:
        planes = np.cumsum(buf, axis=1, dtype=np.uint8)
        words = planes.reshape(rows, size, width).transpose(0, 2, 1)
        return np.ascontiguousarray(words).view(">" + dtype).astype(
            dtype).reshape(rows, width, 1)
    px = buf.view(bo + "u%d" % size).astype("u%d" % size)
    if predictor == 2:
        px = np.cumsum(px, axis=1, dtype=px.dtype)
    return px.view(dtype).reshape(rows, width, 1)


def _typed(tags, spp, bps):
    """The numpy dtype of the samples PIL reads as mode I or F (signed 16
    or 32 bits, float32, unsigned 32 bits as "I;32N"; `_pil_layout` has
    refused the rest), or None."""
    if spp != 1 or bps not in (16, 32):
        return None
    fmt = tags.get(339, (1,))[0]
    if bps == 32:
        return "f4" if fmt == 3 else "i4"
    return "i2" if fmt == 2 else None


def _pil_layout(tags, photometric, bo):
    """Raises where TiffImagePlugin._setup finds no mode for the file's
    sample layout; its key as PIL builds it."""
    fmt = tags.get(339, (1,))
    if len(fmt) > 1 and min(fmt) == max(fmt) == 1:
        fmt = (1,)
    spp = _one(tags, 277, 1)
    bits = tags.get(258, (1,))
    if spp < len(bits):
        bits = bits[:spp]
    elif len(bits) == 1:
        bits = bits * spp
    key = (photometric, fmt, _one(tags, 266, 1), bits, tags.get(338, ()))
    if len(bits) != spp or bo not in _PIL_LAYOUTS.get(key, ""):
        raise ValueError(
            "unsupported TIFF: %s samples of %s bits, %d a pixel, "
            "photometric interpretation %d, extra samples %s, fill order %d, "
            "%s-endian (PIL has no mode for them)" % (
                "/".join({1: "unsigned", 2: "signed", 3: "float"}.get(
                    f, str(f)) for f in fmt),
                "/".join(map(str, sorted(set(bits)))), spp, photometric,
                ", ".join({0: "unspecified", 1: "associated alpha",
                           2: "alpha"}.get(e, str(e)) for e in key[4])
                or "none", key[2], "little" if bo == "<" else "big"))


def decode(data):
    """TIFF bytes -> uint8 (H, W) gray or (H, W, 3) RGB of frame 0."""
    tags, bo = _ifd0(data)
    width, height = _one(tags, 256), _one(tags, 257)
    compression = _one(tags, 259, 1)
    if compression not in _COMPRESSION:
        raise ValueError("unsupported TIFF compression: %s (the port reads "
                         "none, PackBits, LZW, Deflate, CCITT and JPEG)"
                         % compression)
    if compression == 7:
        return _jpeg_in_tiff(data, tags, _one(tags, 262, 1))
    if compression == 6:
        return _old_jpeg(data, tags, bo)
    photometric = _one(tags, 262, 0)    # PIL's default too
    _pil_layout(tags, photometric, bo)
    spp = _one(tags, 277, 1)
    bps = tags.get(258, (1,) * spp)[0]
    typed = _typed(tags, spp, bps)
    extra = tags.get(338, ())
    if photometric == 8:
        raise ValueError("unsupported TIFF: CIELab (photometric "
                         "interpretation 8): PIL opens it as mode LAB and "
                         "cannot convert that to L or RGB")
    if photometric not in (0, 1, 2, 3, 5, 6):
        raise ValueError("unsupported TIFF: photometric interpretation %d"
                         % photometric)
    if typed is None and bps not in (1, 2, 4, 8, 12, 16):
        raise ValueError("unsupported TIFF: %d bits a sample" % bps)
    if compression in _FAX and (bps != 1 or spp != 1):
        raise ValueError("corrupt TIFF: CCITT data of %d x %d bits"
                         % (spp, bps))
    if compression == 1 and _one(tags, 284, 1) == 2:
        return _raw_planar(data, tags, photometric, spp, bps, extra, typed,
                           width, height)
    planar = spp > 1 and _one(tags, 284, 1) == 2
    if photometric == 6 and compression != 1:
        # libtiff's RGBA reader (Pillow's route for YCbCr outside JPEG)
        # converts three samples, their planes at 1 x 1 only
        if spp != 3:
            raise ValueError("unsupported TIFF: compressed YCbCr of %d "
                             "samples (libtiff's RGBA reader, which PIL "
                             "takes for it, cannot read it)" % spp)
        if not planar:
            return _ycbcr(data, tags, compression, width, height)
        if _subsampling(tags) != (1, 1):
            raise ValueError("unsupported TIFF: planar YCbCr sub-sampled "
                             "%d x %d (libtiff's RGBA reader, which PIL "
                             "takes for it, cannot read it)"
                             % _subsampling(tags))
    elif photometric == 6 and spp == 3:
        return _raw_ycbcr(data, tags, width, height)
    reverse = _one(tags, 266, 1) == 2
    # Pillow has no unpacker for "L;IR", "P;1R", "P;2R" or "P;4R", which
    # it reads without libtiff
    if compression == 1 and reverse and (
            photometric == 0 and bps == 8 or photometric == 3 and bps < 8):
        raise ValueError("unsupported TIFF: uncompressed FillOrder 2 of %d "
                         "bits, photometric interpretation %d (PIL cannot "
                         "read it)" % (bps, photometric))
    # PIL's mode: RGBA where an alpha follows RGB (or a fourth sample
    # without ExtraSamples), PA after a palette
    alpha = extra[:1] in ((1,), (2,), (999,)) or spp == 4 and not extra
    bands = {2: 3 + alpha, 5: 4, 3: 1 + (extra[:1] == (2,))}.get(
        photometric, spp)
    # planes through libtiff: Pillow's strip decoder takes a plane a band,
    # its tile decoder the first planes; then, as after "RGBa", it
    # unpremultiplies RGBA whose first extra sample is associated or, as
    # libtiff defines a missing one, unspecified. A palette with an extra
    # plane (one band) it unpacks as "PX" from the first plane's tile,
    # past the end of each row: the port refuses that file.
    if planar and (bands == 1 or 322 not in tags and spp != bands):
        raise ValueError("unsupported TIFF: planar configuration 2 of %d "
                         "samples in %s, %d bands in PIL" % (
                             spp, "tiles" if 322 in tags else "strips",
                             bands))
    premultiplied = extra[:1] == (1,) or planar and photometric == 2 and \
        spp == 4 and not extra
    # libtiff's codecs but LZW and Deflate (and PIL) ignore the predictor
    predictor = _one(tags, 317, 1) if compression in (5, 8, 32946) else 1
    if predictor not in (1, 2, 3) or predictor == 3 and typed != "f4":
        raise ValueError("unsupported TIFF: predictor %d" % predictor)
    t4options = _one(tags, 292, 0)
    if 322 in tags:
        cw, ch = _one(tags, 322), _one(tags, 323)
        offsets, counts = tags.get(324), tags.get(325)
    else:
        cw, ch = width, min(_one(tags, 278, height), height)
        offsets, counts = tags.get(273), tags.get(279)
    if offsets is None or counts is None:
        raise ValueError("corrupt TIFF: no strip or tile offsets")
    across = -(-width // cw)
    per_plane = across * -(-height // ch)
    chunk_spp = 1 if planar else spp
    out = np.zeros((height, width, spp), typed or (
        np.uint16 if bps > 8 else np.uint8))
    row_bytes = (cw * bps * chunk_spp + 7) // 8
    for i, (off, cnt) in enumerate(zip(offsets, counts)):
        plane, j = divmod(i, per_plane) if planar else (0, i)
        y0, x0 = (j // across) * ch, (j % across) * cw
        if y0 >= height or plane >= spp:
            break
        rows = ch if 322 in tags else min(ch, height - y0)
        h, w = min(rows, height - y0), min(cw, width - x0)
        chunk = data[off: off + cnt]
        if compression == 1:    # PIL reads on from the offset, any count
            if off + (h - 1) * row_bytes + (
                    w * bps * chunk_spp + 7) // 8 > len(data):
                raise ValueError("corrupt TIFF: chunk %d runs past the "
                                 "file's end (PIL cannot read it)" % i)
            chunk = data[off: off + rows * row_bytes]
        if reverse:
            chunk = _REVERSE[np.frombuffer(chunk, np.uint8)].tobytes()
        buf = _inflate(chunk, rows * row_bytes, compression, cw, rows,
                       t4options)
        if compression in _FAX:
            px = buf[:, :, None]      # 1 = black: as 1-bit samples
        elif typed:
            px = _typed_samples(buf, rows, cw, typed, bo, predictor)
        else:
            px = _samples(buf, rows, cw, bps, chunk_spp, bo, predictor)
        out[y0: y0 + h, x0: x0 + w, plane: plane + chunk_spp] = px[:h, :w]
    if typed:
        return _clip_gray(out[..., 0], typed, bo == ">" and compression != 1)
    return _convert(out, photometric, bps, spp, tags, premultiplied)


def _raw_planar(data, tags, photometric, spp, bps, extra, typed, width,
                height):
    """An uncompressed file of PlanarConfiguration 2 as PIL reads it
    without libtiff (TiffImagePlugin._setup's tiles): a plane after
    another, each through the unpacker of the plane's letter in the
    rawmode ("R", "G", ...; "L" and "P" at 8 bits whatever the file's
    bits, "1" at 1, "I" and "F" at 32 in native order), its rows read
    from the file at the chunk's offset on whatever bytes follow it, a
    chunk past the right edge with a stride of the tile width times the
    bits of all samples over the colour and extra samples PIL counts."""
    if spp == 1:
        letters = ("F" if typed == "f4" else "I" if typed else
                   "P" if photometric == 3 else "1" if bps == 1 else
                   "L" if bps <= 8 else "I;16")     # no unpacker
    else:
        letters = {2: "RGB", 3: "P", 5: "CMYK", 6: "RGB"}.get(
            photometric, "L") + (
            "A" if photometric == 2 and spp == 4 and not extra else "") + \
            "".join({0: "X", 1: "a"}.get(e, "A") for e in extra)
    if letters not in ("1", "L", "P", "I", "F", "RGB", "RGBA", "CMYK"):
        raise ValueError("unsupported TIFF: uncompressed planar "
                         "configuration 2, its planes read as %r (PIL has "
                         "no unpacker for some of those letters)" % letters)
    nbits = {"1": 1, "I": 32, "F": 32}.get(letters, 8)
    count = {2: 3, 5: 4, 6: 3}.get(photometric, 1) + len(extra)
    if 322 in tags:
        cw, ch, offsets = _one(tags, 322), _one(tags, 323), tags.get(324)
    else:
        cw, ch, offsets = width, _one(tags, 278, height), tags.get(273)
    dtype = {"I": "<i4", "F": "<f4"}.get(letters, np.uint8)
    out = np.zeros((height, width, len(letters)), dtype)
    src = np.frombuffer(data, np.uint8)
    x = y = layer = 0
    for off in offsets or ():
        if layer >= len(letters):
            break
        cols, rows = min(cw, width - x), min(ch, height - y)
        size = (cols * nbits + 7) // 8
        stride = int(cw * bps * spp / 8 / count) if x + cw > width else 0
        # one chunk of "L" or "P" PIL maps from the file (ImageFile.load's
        # mmap): its rows `stride` apart even where they overlap
        mapped = len(offsets) == 1 and letters in ("L", "P") and \
            off + rows * stride <= len(data)
        step = stride or size
        if step < size and not mapped or \
                off + (rows - 1) * step + size > len(data):
            raise ValueError("unsupported TIFF: uncompressed plane %d as "
                             "PIL reads it runs past its rows or the "
                             "file's end (PIL cannot read it)" % layer)
        raw = src[off + np.arange(rows)[:, None] * step + np.arange(size)]
        out[y: y + rows, x: x + cols, layer] = (
            np.unpackbits(raw, axis=1)[:, :cols] * 255 if nbits == 1 else
            raw.view(dtype) if nbits == 32 else raw)
        x += cw
        if x >= width:
            x, y = 0, y + ch
            if y >= height:
                y, layer = 0, layer + 1
    if letters in ("I", "F"):
        return _clip_gray(out[..., 0], typed, False)
    if letters in ("1", "L"):
        return out[..., 0]
    return _convert(out, 2 if photometric == 6 else photometric,
                    bps if photometric == 3 else 8, len(letters), tags)


def _clip_gray(values, dtype, swapped):
    """PIL's convert("L") of mode I (i2l) or F (f2l): clipped to 0-255,
    floats truncated, NaN to 0. `swapped`: the values PIL unpacks from
    libtiff's host-order samples of a big-endian file."""
    if swapped:
        values = values.byteswap()
    if dtype == "f4":
        with np.errstate(invalid="ignore"):     # signalling NaNs
            v = np.nan_to_num(values.astype(np.float64), nan=0.0)
        return np.clip(v, 0, 255).astype(np.uint8)
    return np.clip(values, 0, 255).astype(np.uint8)


# ------------------------------------------------------------- YCbCr

# the sub-samplings (h, v) that libtiff's RGBA reader has a put routine
# for (tif_getimage.c putcontig8bitYCbCr{44,42,41,22,21,12,11}tile)
_YCC_PUT = ((4, 4), (4, 2), (4, 1), (2, 2), (2, 1), (1, 2), (1, 1))


def _subsampling(tags):
    v = tags.get(530, (2, 2))
    return (v[0], v[1]) if len(v) > 1 else (v[0], 2)


def _ycbcr_rgb(y, cb, cr, tags, hs=1, vs=1):
    """Y samples and the Cb and Cr of each `hs` x `vs` block of them ->
    RGB as libtiff's TIFFYCbCrToRGB (tif_getimage.c), its tables from
    YCbCrCoefficients and ReferenceBlackWhite (libtiff's defaults where
    missing) in float32 and 16-bit fixed point."""
    f = np.float32
    luma = tags.get(529, ())
    luma = [f(v) for v in luma] if len(luma) == 3 else \
        [f(0.299), f(0.587), f(0.114)]
    rbw = tags.get(532, ())
    rbw = [f(v) for v in rbw] if len(rbw) == 6 else \
        [f(0), f(255), f(128), f(255), f(128), f(255)]
    if not all(np.isfinite(luma)) or abs(luma[1]) < 1e-7:
        raise ValueError("corrupt TIFF: YCbCrCoefficients %s" % luma)

    def fix(x):       # FIX(CLAMP(x, 0, 2)) of SHIFT 16
        return int(float(min(max(x, f(0)), f(2)) * f(65536)) + 0.5)

    def code2v(c, rb, rw, cr):
        span = f(rw - rb)
        return np.clip((c - int(rb)).astype(f) * f(cr) / (
            span if span != 0 else f(1)), f(-4096), f(4096)).astype(np.int64)
    f1, f3 = f(2) - f(2) * luma[0], f(2) - f(2) * luma[2]
    d1, d3 = fix(f1), fix(f3)
    d2, d4 = -fix(luma[0] * f1 / luma[1]), -fix(luma[2] * f3 / luma[1])
    x = np.arange(256) - 128
    cr_v = code2v(x, rbw[4] - f(128), rbw[5] - f(128), 127)
    cb_v = code2v(x, rbw[2] - f(128), rbw[3] - f(128), 127)
    y_t = code2v(x + 128, rbw[0], rbw[1], 255)
    # every term within +-2^13: int16; the chroma terms a block each
    yy = y_t.astype(np.int16)[y]
    rgb = np.empty(y.shape + (3,), np.uint8)
    for k, term in enumerate((
            ((d1 * cr_v + 32768) >> 16)[cr],
            (d4 * cb_v + 32768)[cb] + (d2 * cr_v)[cr] >> 16,
            ((d3 * cb_v + 32768) >> 16)[cb])):
        up = np.repeat(np.repeat(term.astype(np.int16), vs, 0), hs, 1)
        rgb[..., k] = np.clip(yy + up[: y.shape[0], : y.shape[1]], 0, 255)
    return rgb


def _blocks_rgb(buf, stride, nbx, rows, cols, hs, vs, tags):
    """libtiff's sub-sampled YCbCr layout (each block: hs x vs Y samples
    row by row, then Cb and Cr; block rows `stride` bytes apart) -> RGB of `rows` x `cols` pixels, each block's Cb and Cr on
    each of its pixels."""
    n = hs * vs + 2
    nby = -(-rows // vs)
    at = np.arange(nby)[:, None] * stride + np.arange(nbx) * n
    blk = buf[at[..., None] + np.arange(n)]
    y = blk[..., : n - 2].reshape(nby, nbx, vs, hs).transpose(
        0, 2, 1, 3).reshape(nby * vs, nbx * hs)[:rows, :cols]
    return _ycbcr_rgb(y, blk[..., n - 2], blk[..., n - 1], tags, hs, vs)


def _ycbcr(data, tags, compression, width, height):
    """YCbCr of three chunky samples, compressed: as Pillow reads it,
    through libtiff's RGBA reader (TIFFRGBAImageGet, a strip or a row of
    tiles a call). A strip is read as TIFFScanlineSize (a row of blocks
    over vs, rounded down) times its rows rounded up to vs into a zeroed
    buffer: at vs 4 and an odd count of blocks across, each strip's last
    bytes stay zero. In a tile past the right edge,
    putcontig8bitYCbCr44tile skips (tile width - its pixels) / 4 x 10
    bytes a row of blocks, not x 18."""
    hs, vs = _subsampling(tags)
    if (hs, vs) not in _YCC_PUT:
        raise ValueError("unsupported TIFF: YCbCr sub-sampled %d x %d "
                         "(libtiff's RGBA reader, which PIL takes for it, "
                         "cannot read it)" % (hs, vs))
    predictor = _one(tags, 317, 1) if compression in (5, 8, 32946) else 1
    if predictor not in (1, 2):
        raise ValueError("unsupported TIFF: predictor %d" % predictor)
    n = hs * vs + 2
    tiled = 322 in tags
    if tiled:
        cw, ch = _one(tags, 322), _one(tags, 323)
        offsets, counts = tags.get(324), tags.get(325)
    else:
        cw, ch = width, min(_one(tags, 278, height), height)
        offsets, counts = tags.get(273), tags.get(279)
    if offsets is None or counts is None:
        raise ValueError("corrupt TIFF: no strip or tile offsets")
    row = -(-cw // hs) * n               # the bytes of a row of blocks
    scanline = row // vs
    # libtiff's predictor undoes rows of TIFFScanlineSize bytes, of a
    # tile's width x 3 in tiles
    pred_row = cw * 3 if tiled else scanline
    full = row * -(-ch // vs)
    out = np.zeros((height, width, 3), np.uint8)
    across = -(-width // cw)
    for i, (off, cnt) in enumerate(zip(offsets, counts)):
        y0, x0 = (i // across) * ch, (i % across) * cw
        if y0 >= height:
            break
        rows, cols = min(ch, height - y0), min(cw, width - x0)
        size = full if tiled else -(-rows // vs) * vs * scanline
        # a chunk that decodes short is an error that Pillow's RGBA reader,
        # which does not stop on errors, passes over: its bytes, then zeros
        raw = _inflate(data[off: off + cnt], size, compression, cw, rows, 0,
                       short=True)
        # libtiff fails a predictor whose rows do not divide the chunk or
        # 3 bytes: Pillow's RGBA reader, which does not stop on errors,
        # then shows the bytes as decoded
        if predictor == 2 and not size % pred_row and not pred_row % 3:
            raw = np.cumsum(raw.reshape(-1, pred_row // 3, 3), axis=1,
                            dtype=np.uint8).ravel()
        buf = np.zeros(full, np.uint8)
        buf[:size] = raw
        nbx = -(-cols // hs)
        skip = (cw - cols) // hs * (10 if (hs, vs) == (4, 4) else n)
        out[y0: y0 + rows, x0: x0 + cols] = _blocks_rgb(
            buf, nbx * n + skip, nbx, rows, cols, hs, vs, tags)
    return out


def _raw_ycbcr(data, tags, width, height):
    """Uncompressed YCbCr of three chunky samples as PIL reads it without
    libtiff: rawmode "RGBX", each pixel four bytes of the file from a
    strip's or tile's offset on, the first three taken as R, G and B,
    whatever the sub-sampling; a tile past the right edge has rows its
    width x 3 bytes apart, which PIL's decoder refuses where that is
    fewer than its pixels' bytes."""
    src = np.frombuffer(data, np.uint8)
    if 322 in tags:
        cw, ch, offsets = _one(tags, 322), _one(tags, 323), tags.get(324)
    else:
        cw, ch, offsets = width, _one(tags, 278, height), tags.get(273)
    out = np.zeros((height, width, 3), np.uint8)
    x = y = 0
    for off in offsets or ():
        if y >= height:
            break
        cols, rows = min(cw, width - x), min(ch, height - y)
        step = cw * 3 if x + cw > width else cols * 4
        if step < cols * 4 or off + (rows - 1) * step + cols * 4 > src.size:
            raise ValueError("unsupported TIFF: uncompressed YCbCr chunk at "
                             "%d as PIL reads it (4 bytes a pixel) runs "
                             "past its rows or the file's end (PIL cannot "
                             "read it)" % off)
        at = off + np.arange(rows)[:, None] * step + np.arange(cols * 4)
        out[y: y + rows, x: x + cols] = src[at].reshape(rows, cols, 4)[
            ..., :3]
        x += cw
        if x >= width:
            x, y = 0, y + ch
    return out


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


# the markers libtiff's OJPEG codec reads in a JPEGInterchangeFormat
# stream up to its SOS (tif_ojpeg.c OJPEGReadHeaderInfoSec): SOI, APPn and
# COM skipped, DRI, DQT, DHT and SOF0, SOF1 or SOF3 taken; any other fails
_OJPEG_SKIP = {0xD8, 0xFE} | set(range(0xE0, 0xF0))
_OJPEG_TAKE = {0xDD, 0xDB, 0xC4, 0xC0, 0xC1, 0xC3}


def _jif_header(data, off, length):
    """The JPEGInterchangeFormat stream's marker segments up to and with
    its SOS as libtiff reads them -> (segments to re-emit, DRI's restart
    interval or None, the SOF body, the position after the SOS)."""
    end = min(off + length, len(data))
    pos, segs, dri, sof = off, [], None, None
    while True:
        if pos + 2 > end or data[pos] != 0xFF:
            raise ValueError("corrupt TIFF: old-style JPEG stream without "
                             "SOS")
        while pos < end and data[pos] == 0xFF:
            pos += 1
        m = data[pos]
        pos += 1
        if m == 0xD8:
            continue
        if m not in _OJPEG_SKIP and m not in _OJPEG_TAKE and m != 0xDA:
            raise ValueError("unsupported TIFF: old-style JPEG with a 0x%02X "
                             "marker (libtiff reads baseline, extended and "
                             "lossless frames only: PIL cannot read it)" % m)
        (n,) = struct.unpack(">H", data[pos: pos + 2])
        seg = data[pos - 2: pos + n]
        if m == 0xDD:
            dri = struct.unpack(">H", seg[4:6])[0]
        elif m in (0xC0, 0xC1, 0xC3):
            if sof is not None:
                raise ValueError("corrupt TIFF: old-style JPEG with two "
                                 "frames")
            sof = seg
        elif m in (0xDB, 0xC4, 0xDA):
            segs.append(seg)
        pos += n
        if m == 0xDA:
            if sof is None:
                raise ValueError("corrupt TIFF: old-style JPEG without a "
                                 "frame")
            return segs, dri, sof, pos


def _ojpeg_tables(data, tags, spp, hs, vs, width, height):
    """Form (b), no JPEGInterchangeFormat: libtiff's JPEG header from the
    tables tags (JPEGQTables, JPEGDCTables, JPEGACTables: an offset a
    sample; a sample whose offset repeats the last one's shares its
    table), a baseline frame of the image's size with component ids 0,
    1, 2 and the Y sampling `hs` x `vs`."""
    segs, sel = [], []
    for kind, tag in enumerate((519, 520, 521)):
        offs = list(tags.get(tag, ())) + [0] * spp
        if not offs[0]:
            raise ValueError("corrupt TIFF: old-style JPEG without JPEG "
                             "tables")
        ids = []
        for m in range(spp):
            o = offs[m]
            if not o or m and o == offs[m - 1]:
                ids.append(ids[-1])
                continue
            if o in offs[: max(m - 1, 0)]:
                raise ValueError("corrupt TIFF: old-style JPEG tables tag "
                                 "%d" % tag)
            ids.append(m)
            # a quantization table: 64 bytes in zigzag order; a Huffman
            # table: 16 counts, then the values
            size = 64 if kind == 0 else 16 + sum(data[o: o + 16])
            body = data[o: o + size]
            if len(body) < max(size, 16):
                raise ValueError("corrupt TIFF: old-style JPEG table past "
                                 "the file's end")
            segs.append(b"\xff\xdb\x00\x43" + bytes([m]) + body
                        if kind == 0 else b"\xff\xc4" + struct.pack(
                            ">HB", 3 + size, m | (kind - 1) << 4) + body)
        sel.append(ids)
    tq, tda = sel[0], [sel[1][m] << 4 | sel[2][m] for m in range(spp)]
    sof = b"\xff\xc0" + struct.pack(">HBHHB", 8 + 3 * spp, 8, height,
                                     width, spp) + b"".join(
        bytes([m, (hs << 4 | vs) if m == 0 else 0x11, tq[m]])
        for m in range(spp))
    return segs, sof, _sos([(m, tda[m]) for m in range(spp)])


def _sos(comps):
    """The scan header libtiff writes: each (component id, table
    selectors), then Ss 0, Se 63, Ah Al 0."""
    return b"\xff\xda" + struct.pack(">HB", 6 + 2 * len(comps), len(
        comps)) + b"".join(bytes(c) for c in comps) + b"\x00\x3f\x00"


def _old_jpeg(data, tags, bo):
    """Compression 6 as libtiff's OJPEG codec gives it to PIL: the stream
    it builds (the JPEGInterchangeFormat stream's tables, frame and scan
    header, or form (b)'s from the tables tags; its DRI, or one a strip
    where there are several; the JPEGInterchangeFormat stream's rest,
    then the strips' or tiles' data, an RST marker between two) decoded
    as libjpeg's raw data: one component as its decoded gray, three as
    each plane at its own sampling, Cb and Cr on each pixel of their
    block, through TIFFYCbCrToRGB (`_ycbcr_rgb`)."""
    from origami_tpu_torch.core import _jpeg
    width, height = _one(tags, 256), _one(tags, 257)
    # libtiff's OJPEG guesses: YCbCr where the photometric tag is missing,
    # then three samples where that tag is missing; PIL's mode is RGB
    # unless the file says one sample
    photometric = _one(tags, 262, 6)
    spp = _one(tags, 277, 3 if photometric in (2, 6) else 1)
    pil_spp = _one(tags, 277, 3)
    if (spp, photometric) not in ((1, 0), (1, 1), (3, 2), (3, 6)) or \
            spp != pil_spp or tags.get(258, (8,))[0] != 8:
        raise ValueError("unsupported TIFF: old-style JPEG of %d samples, "
                         "photometric interpretation %d (PIL cannot read it)"
                         % (spp, photometric))
    if spp > 1 and _one(tags, 284, 1) != 1:
        raise ValueError("unsupported TIFF: old-style JPEG in planar "
                         "configuration 2")
    if 322 in tags:
        cw, ch = _one(tags, 322), _one(tags, 323)
        offsets, counts = tags.get(324, ()), tags.get(325, ())
        if cw < width:
            raise ValueError("unsupported TIFF: old-style JPEG in more than "
                             "one column of tiles")
        total = -(-height // ch) * ch
    else:
        cw, ch = width, min(_one(tags, 278, height), height)
        offsets, counts = tags.get(273, ()), tags.get(279, ())
        total = height
    restart = _one(tags, 515, 0)
    if 513 in tags:
        off = _one(tags, 513)
        segs, dri, sof, rest = _jif_header(
            data, off, _one(tags, 514, 0) or len(data) - off)
        hs, vs = (sof[11] >> 4, sof[11] & 15) if spp == 3 else (1, 1)
        tail = data[rest: off + (_one(tags, 514, 0) or len(data) - off)]
        sos = segs.pop()
        if sos[4] != spp:
            raise ValueError("unsupported TIFF: old-style JPEG scan of %d "
                             "components (libtiff reads one scan of all "
                             "%d)" % (sos[4], spp))
        sos = _sos([(sos[5 + 2 * k], sos[6 + 2 * k]) for k in range(spp)])
    else:
        hs, vs = _subsampling(tags) if spp == 3 else (1, 1)
        segs, sof, sos = _ojpeg_tables(data, tags, spp, hs, vs, cw, total)
        dri, tail = None, b""
    if ch < total:
        # libtiff: a restart interval a strip or tile
        if hs not in (1, 2, 4) or vs not in (1, 2, 4) or ch % (8 * vs):
            raise ValueError("unsupported TIFF: old-style JPEG in strips or "
                             "tiles of %d rows at sampling %d x %d (libtiff "
                             "cannot read it)" % (ch, hs, vs))
        restart = -(-cw // (8 * hs)) * (ch // (8 * vs))
    if dri is not None:
        restart = dri
    fh, fw = struct.unpack(">HH", sof[5:9])
    if fw != cw or fh < min(height, total) or sof[4] != 8 or \
            sof[9] != spp:
        raise ValueError("unsupported TIFF: old-style JPEG of %d x %d, %d "
                         "components in a %d x %d image of %d samples (PIL "
                         "cannot read it)" % (fw, fh, sof[9], cw, height, spp))
    chunks = [data[o: o + c] for o, c in zip(offsets, counts)]
    if bo == ">" and len(chunks) > 1:
        # libtiff reads BitsPerSample after Compression, and in a
        # byte-swapped file that drops the OJPEG codec's post-decode step:
        # each strip read then skips one more strip of the stream, and
        # strips past its end repeat the last rows decoded
        raise ValueError("unsupported TIFF: big-endian old-style JPEG in "
                         "%d strips or tiles (libtiff gives strip k of the "
                         "stream's strip 2k: the port does not read it)"
                         % len(chunks))
    body = b"".join(c + (b"\xff" + bytes([0xD0 + k % 8])
                         if k < len(chunks) - 1 else b"")
                    for k, c in enumerate(chunks))
    stream = b"\xff\xd8" + b"".join(segs) + (
        b"\xff\xdd\x00\x04" + struct.pack(">H", restart) if restart
        else b"") + sof + sos + tail + body + b"\xff\xd9"
    if spp == 1:
        return _jpeg.decode(stream)[:height, :width]
    planes = _jpeg.planes(stream)
    if [(h, v) for h, v, _ in planes] != [(hs, vs), (1, 1), (1, 1)] or \
            (hs, vs) not in _YCC_PUT:
        raise ValueError("unsupported TIFF: old-style JPEG sampled %s "
                         "(libtiff reads only Cb and Cr at 1 x 1 and Y at "
                         "1, 2 or 4: PIL cannot read it)"
                         % [(h, v) for h, v, _ in planes])
    y, cb, cr = (p for _, _, p in planes)
    return _ycbcr_rgb(y[:height, :width], cb, cr, tags, hs, vs)


def _muldiv255(a, b):
    t = a * b + 128
    return ((t >> 8) + t) >> 8


# Pillow's cmyk2rgb of a channel, nk - MULDIV255(v, nk) with nk = 255 - k,
# at [k << 8 | v]
_CMYK = (255 - np.arange(256)[:, None] - _muldiv255(
    np.arange(256)[None, :], 255 - np.arange(256)[:, None])).astype(
        np.uint8).ravel()


def _convert(px, photometric, bps, spp, tags, premultiplied=False):
    """Samples -> what PIL's convert("L") / convert("RGB") gives."""
    if photometric == 3:
        cmap = np.asarray(tags.get(320, ()), np.uint16)
        n = 1 << bps
        if cmap.size != 3 * n:
            raise ValueError("corrupt TIFF: colour map of %d values"
                             % cmap.size)
        palette = np.zeros((256, 3), np.uint8)    # black past the map
        palette[:n] = cmap.reshape(3, n).T >> 8
        return palette[px[..., 0]]
    if photometric == 5:      # Pillow's cmyk2rgb
        cmyk = ((px[..., :4] >> 8) if bps == 16 else px[..., :4]).astype(
            np.uint16)
        return _CMYK[(cmyk[..., 3:] << 8) | cmyk[..., :3]]
    if photometric == 2:
        if spp < 3:
            raise ValueError("corrupt TIFF: RGB with %d samples" % spp)
        rgb = px[..., :3]
        rgb = (rgb >> 8).astype(np.uint8) if bps == 16 else rgb
        if premultiplied:     # Pillow's unpackRGBa: v * 255 / a
            a = ((px[..., 3:4] >> 8) if bps == 16 else px[..., 3:4]).astype(
                np.int32)
            v = np.minimum(rgb.astype(np.int32) * 255 // np.maximum(a, 1),
                           255)
            rgb = np.where(a == 255, rgb, np.where(a == 0, 0, v)).astype(
                np.uint8)
        return np.ascontiguousarray(rgb)
    if photometric == 6 and spp == 3:   # planes through libtiff's reader
        return _ycbcr_rgb(px[..., 0], px[..., 1], px[..., 2], tags)
    g = px[..., 0]
    if bps > 8:              # "I;16" (and "I;12") -> "L"; PIL reads
        return np.minimum(g, 255).astype(np.uint8)   # MinIsWhite as is
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
