"""The port's page readers (core/_image.py and the JPEG, TIFF, BMP and PNG
decoders under it) against PIL, which reads pages for the JAX package.

Every case is seeded and written into tmp_path, by PIL where it writes
the variant, else by the small writers below (stdlib + numpy), and the
port must give PIL's `convert("L")` pixels on every pixel and PIL's
`.size`. Tolerance: none.
"""

import io
import json
import struct
import zipfile
import zlib
from pathlib import Path

import numpy as np
import PIL.Image
import pytest
from scipy.fft import dctn

from origami_tpu.core.page import Page as JaxPage
from origami_tpu_torch.batch.detect import segment as stage
from origami_tpu_torch.core import _image, _png
from origami_tpu_torch.core.page import Page

ROOT = Path(__file__).resolve().parent.parent
FULL = ROOT / "tests/data/torch_ocr/full"


def texture(h, w, c, seed):
    """A seeded image with flat patches, edges and noise."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h // 5 + 2, w // 5 + 2, c)).astype(float)
    x = np.kron(base, np.ones((5, 5, 1)))[:h, :w]
    x += rng.normal(0, 12, x.shape)
    px = np.clip(x, 0, 255).astype(np.uint8)
    return px[..., 0] if c == 1 else px


# ---------------------------------------------------------------- JPEG

def pil_bytes(px, fmt, mode=None, palette=False, **kw):
    """`px` saved by PIL as `fmt`; `palette`: as a "P" image with a
    seeded palette."""
    im = PIL.Image.fromarray(px, mode)
    if palette:
        im = im.convert("P")
        im.putpalette(np.random.default_rng(37).integers(
            0, 256, 768).astype(np.uint8).tobytes())
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


def jpeg_bytes(px, **kw):
    return pil_bytes(px, "JPEG", **kw)


def segments(data):
    """[(marker, start, end)] of a JPEG's marker segments, each scan's
    entropy-coded data counted into its SOS segment."""
    out, i = [], 2
    while i < len(data) - 1:
        m = data[i + 1]
        if m == 0xD9:
            break
        (n,) = struct.unpack(">H", data[i + 2: i + 4])
        j = i + 2 + n
        if m == 0xDA:
            while not (data[j] == 0xFF and data[j + 1] not in (0,)
                       and not 0xD0 <= data[j + 1] <= 0xD7):
                j += 1
        out.append((m, i, j))
        i = j
    return out


def truncated_progressive(px, scans, **kw):
    """A progressive file cut after its first `scans` scans: coefficients
    left unrefined, so libjpeg smooths blocks."""
    data = jpeg_bytes(px, progressive=True, **kw)
    sos = [s for s in segments(data) if s[0] == 0xDA]
    return data[: sos[scans - 1][2]] + b"\xff\xd9"


def with_extras(data):
    """APPn, COM and fill bytes that a decoder must skip."""
    app1 = b"Exif\x00\x00" + bytes(range(40))
    extra = (b"\xff\xe1" + struct.pack(">H", len(app1) + 2) + app1
             + b"\xff\xfe\x00\x07hello" + b"\xff\xe2\x00\x04\x01\x02")
    body = data[2:].replace(b"\xff\xda", b"\xff\xff\xff\xda", 1)
    return data[:2] + extra + body


def huffman_codes(data):
    """{(class, id): {symbol: (code, length)}} from a file's DHT
    segments."""
    tables = {}
    for m, a, b in segments(data):
        if m != 0xC4:
            continue
        i = a + 4
        while i < b:
            tc = data[i]
            bits = data[i + 1: i + 17]
            vals = data[i + 17: i + 17 + sum(bits)]
            codes, code, k = {}, 0, 0
            for length in range(1, 17):
                for _ in range(bits[length - 1]):
                    codes[vals[k]] = (code, length)
                    code += 1
                    k += 1
                code <<= 1
            tables[(tc >> 4, tc & 15)] = codes
            i += 17 + sum(bits)
    return tables


class BitWriter:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, code, length):
        for i in range(length - 1, -1, -1):
            self.acc = (self.acc << 1) | ((code >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc, self.n = 0, 0

    def flush(self):
        while self.n:
            self.put(1, 1)
        return bytes(self.out)


ZIGZAG = np.array([0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
                   12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21,
                   28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30,
                   37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61,
                   54, 47, 55, 62, 63])


def crafted_jpeg(h, w, sampling, seed, ids=(1, 2, 3), marker="jfif",
                 restart=0):
    """A baseline JPEG with any sampling factors: PIL's quantization and
    Huffman tables, our forward DCT and entropy coder."""
    template = jpeg_bytes(texture(16, 16, 3, 0), quality=75, subsampling=0)
    segs = segments(template)
    dqt = b"".join(template[a:b] for m, a, b in segs if m == 0xDB)
    dht = b"".join(template[a:b] for m, a, b in segs if m == 0xC4)
    qt = {}
    for m, a, b in segs:
        if m == 0xDB:
            i = a + 4
            while i < b:
                q = np.zeros(64, int)
                q[ZIGZAG] = list(template[i + 1: i + 65])
                qt[template[i] & 15] = q.reshape(8, 8)
                i += 65
    codes = huffman_codes(template)
    hmax = max(s[0] for s in sampling)
    vmax = max(s[1] for s in sampling)
    mx, my = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    rng = np.random.default_rng(seed)
    blocks = []
    for ci, (hs, vs) in enumerate(sampling):
        dh, dw = -(-h * vs // vmax), -(-w * hs // hmax)
        plane = texture(dh, dw, 1, seed + ci).astype(float) - 128
        plane = np.pad(plane, ((0, my * vs * 8 - dh), (0, mx * hs * 8 - dw)),
                       mode="edge")
        q = qt[0 if ci == 0 else 1]
        coef = np.zeros((my * vs, mx * hs, 64), int)
        for by in range(my * vs):
            for bx in range(mx * hs):
                blk = plane[by * 8: by * 8 + 8, bx * 8: bx * 8 + 8]
                f = dctn(blk, norm="ortho") + rng.normal(0, 0.3, (8, 8))
                coef[by, bx] = np.round(f / q).astype(int).reshape(64)[
                    ZIGZAG]
        blocks.append(coef)

    def bits_of(v):
        n = int(abs(v)).bit_length()
        return n, (v if v >= 0 else v + (1 << n) - 1)

    bw = BitWriter()
    preds = [0] * len(sampling)
    data = bytearray()
    mcu, rst = 0, 0
    for y in range(my):
        for x in range(mx):
            if restart and mcu and mcu % restart == 0:
                data += bw.flush() + bytes((0xFF, 0xD0 + rst % 8))
                bw, rst, preds = BitWriter(), rst + 1, [0] * len(sampling)
            mcu += 1
            for ci, (hs, vs) in enumerate(sampling):
                t = 0 if ci == 0 else 1
                for yy in range(vs):
                    for xx in range(hs):
                        z = blocks[ci][y * vs + yy, x * hs + xx]
                        n, v = bits_of(z[0] - preds[ci])
                        preds[ci] = z[0]
                        bw.put(*codes[(0, t)][n])
                        bw.put(v, n)
                        run = 0
                        for k in range(1, 64):
                            if z[k] == 0:
                                run += 1
                                continue
                            while run > 15:
                                bw.put(*codes[(1, t)][0xF0])
                                run -= 16
                            n, v = bits_of(z[k])
                            bw.put(*codes[(1, t)][(run << 4) | n])
                            bw.put(v, n)
                            run = 0
                        if run:
                            bw.put(*codes[(1, t)][0x00])
    data += bw.flush()
    nc = len(sampling)
    sof = struct.pack(">BHHB", 8, h, w, nc) + b"".join(
        struct.pack(">BBB", ids[ci], (hs << 4) | vs, 0 if ci == 0 else 1)
        for ci, (hs, vs) in enumerate(sampling))
    sos = struct.pack(">B", nc) + b"".join(
        struct.pack(">BB", ids[ci], 0 if ci == 0 else 0x11)
        for ci in range(nc)) + b"\x00\x3f\x00"
    head = b"\xff\xd8"
    if marker == "jfif":
        app = b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"
        head += b"\xff\xe0" + struct.pack(">H", len(app) + 2) + app
    elif marker == "adobe-rgb":
        app = b"Adobe\x00\x64\x00\x00\x00\x00\x00"
        head += b"\xff\xee" + struct.pack(">H", len(app) + 2) + app
    head += dqt + b"\xff\xc0" + struct.pack(">H", len(sof) + 2) + sof + dht
    if restart:
        head += b"\xff\xdd\x00\x04" + struct.pack(">H", restart)
    head += b"\xff\xda" + struct.pack(">H", len(sos) + 2) + sos
    return head + bytes(data) + b"\xff\xd9"


def jpeg_cases():
    cases = {}
    for q in (50, 75, 95):
        for ss, name in ((0, "444"), (1, "422"), (2, "420")):
            cases["jpeg-q%d-%s" % (q, name)] = lambda q=q, ss=ss: jpeg_bytes(
                texture(47, 61, 3, q + ss), quality=q, subsampling=ss)
        cases["jpeg-gray-q%d" % q] = lambda q=q: jpeg_bytes(
            texture(61, 47, 1, q), quality=q)
    for h, w in ((1, 1), (2, 3), (8, 8), (9, 17), (16, 16), (17, 23),
                 (33, 40), (61, 47), (3, 130)):
        cases["jpeg-420-%dx%d" % (h, w)] = lambda h=h, w=w: jpeg_bytes(
            texture(h, w, 3, h * w), quality=80, subsampling=2)
        cases["jpeg-gray-%dx%d" % (h, w)] = lambda h=h, w=w: jpeg_bytes(
            texture(h, w, 1, h + w), quality=80)
    cases["jpeg-optimized"] = lambda: jpeg_bytes(
        texture(47, 61, 3, 3), quality=75, optimize=True)
    cases["jpeg-restart-blocks"] = lambda: jpeg_bytes(
        texture(47, 61, 3, 4), quality=75, subsampling=2,
        restart_marker_blocks=1)
    cases["jpeg-restart-rows"] = lambda: jpeg_bytes(
        texture(47, 61, 1, 5), quality=75, restart_marker_rows=1)
    cases["jpeg-app-com-fill"] = lambda: with_extras(jpeg_bytes(
        texture(40, 33, 3, 6), quality=75))
    for ss in (0, 2):
        cases["jpeg-progressive-%d" % ss] = lambda ss=ss: jpeg_bytes(
            texture(61, 47, 3, 7 + ss), quality=70, progressive=True,
            subsampling=ss)
    cases["jpeg-progressive-gray"] = lambda: jpeg_bytes(
        texture(47, 61, 1, 9), quality=70, progressive=True)
    cases["jpeg-progressive-restart"] = lambda: jpeg_bytes(
        texture(61, 47, 3, 10), quality=70, progressive=True,
        subsampling=2, restart_marker_blocks=3)
    # unrefined coefficients: the DC scan alone (DC interpolation), then
    # the first AC bands (AC estimates), gray and 4:2:0
    for scans in (1, 2, 3, 5):
        cases["jpeg-smooth-420-%d" % scans] = lambda s=scans: \
            truncated_progressive(texture(61, 47, 3, 11), s, quality=70,
                                  subsampling=2)
        cases["jpeg-smooth-gray-%d" % scans] = lambda s=scans: \
            truncated_progressive(texture(40, 35, 1, 12), s, quality=70)
    # sampling PIL does not write: h1v2 (4:4:0), int_upsample (4:1:1,
    # 3x1), and the colour spaces of the markers
    cases["jpeg-440"] = lambda: crafted_jpeg(37, 45, ((1, 2), (1, 1),
                                                      (1, 1)), 13)
    cases["jpeg-411"] = lambda: crafted_jpeg(29, 67, ((4, 1), (1, 1),
                                                      (1, 1)), 14)
    cases["jpeg-31"] = lambda: crafted_jpeg(21, 50, ((3, 1), (1, 1),
                                                     (1, 1)), 15)
    cases["jpeg-22-in-12"] = lambda: crafted_jpeg(
        30, 30, ((2, 2), (1, 2), (1, 2)), 16)
    cases["jpeg-adobe-rgb"] = lambda: crafted_jpeg(
        20, 27, ((1, 1), (1, 1), (1, 1)), 17, marker="adobe-rgb")
    cases["jpeg-ids-rgb"] = lambda: crafted_jpeg(
        20, 27, ((1, 1), (1, 1), (1, 1)), 18, ids=(82, 71, 66), marker=None)
    cases["jpeg-crafted-restart"] = lambda: crafted_jpeg(
        33, 41, ((2, 2), (1, 1), (1, 1)), 19, restart=2)
    # four components: PIL's CMYK save (an Adobe marker, transform 0, the
    # samples inverted), without its marker, and as YCCK (transform 2)
    for name, kw in (("", {}), ("-420", dict(quality=90, subsampling=2)),
                     ("-progressive", dict(quality=60, progressive=True))):
        cases["jpeg-cmyk" + name] = lambda kw=kw: cmyk_jpeg(
            texture(37, 45, 4, 64), **kw)
        cases["jpeg-ycck" + name] = lambda kw=kw: adobe_transform(cmyk_jpeg(
            texture(45, 37, 4, 65), **kw), 2)
    cases["jpeg-cmyk-16x16"] = lambda: cmyk_jpeg(texture(16, 16, 4, 64))
    cases["jpeg-cmyk-no-adobe"] = lambda: without_adobe(cmyk_jpeg(
        texture(23, 30, 4, 66), quality=85))
    cases["jpeg-ycck-flat"] = lambda: adobe_transform(cmyk_jpeg(
        np.full((17, 19, 4), (200, 30, 90, 10), np.uint8)), 2)
    return {k: ("jpg", v) for k, v in cases.items()}


def cmyk_jpeg(px, **kw):
    return pil_bytes(px, "JPEG", "CMYK", **kw)


def adobe_transform(data, transform):
    """`data` with its Adobe APP14 marker's transform byte set."""
    i = data.index(b"\xff\xee") + 4
    assert data[i: i + 5] == b"Adobe"
    return data[: i + 11] + bytes((transform,)) + data[i + 12:]


def without_adobe(data):
    """`data` without its Adobe APP14 segment."""
    i = data.index(b"\xff\xee")
    (n,) = struct.unpack(">H", data[i + 2: i + 4])
    return data[:i] + data[i + 2 + n:]


# ---------------------------------------------------------------- TIFF

def packbits(raw):
    out, i = bytearray(), 0
    while i < len(raw):
        j = i
        while j < len(raw) and j - i < 128 and raw[j] == raw[i]:
            j += 1
        if j - i >= 3:
            out += struct.pack("b", 1 - (j - i)) + raw[i:i + 1]
            i = j
        else:
            k = min(len(raw) - i, 5)
            out += struct.pack("b", k - 1) + raw[i: i + k]
            i += k
    return bytes(out)


def lzw(raw):
    """libtiff's LZW of `raw`, through PIL: the one strip of a one-row
    "L" image."""
    n = max(len(raw), 1)
    buf = io.BytesIO()
    PIL.Image.frombytes("L", (n, 1), raw.ljust(n, b"\x00")).save(
        buf, "TIFF", compression="tiff_lzw")
    with PIL.Image.open(buf) as t:
        off, cnt = t.tag_v2[273][0], t.tag_v2[279][0]
    return buf.getvalue()[off: off + cnt]


def tiff_file(px, photometric, bps=None, compression=1, bo="<", tile=None,
              rows_per_strip=None, predictor=1, colormap=None, extra=(),
              big=False, planar=False):
    """A TIFF of samples `px` ((H, W) or (H, W, spp)): at `bps` bits
    (below 8 packed MSB first), or with `bps` None the dtype's own
    samples (8-32 bits, SampleFormat from its kind: signed, float);
    classic or `big` (BigTIFF: 8-byte offsets, the chunk tables as
    LONG8), chunky or `planar` (one set of chunks a sample), strips or
    `tile` (w, h) chunks, compression none (1), LZW (5), Deflate (8) or
    PackBits (32773), predictor 1, 2 or 3 (libtiff's fpDiff: each
    value's bytes, most significant first, into byte planes, then byte
    differences along the row); `extra` more IFD entries."""
    px = np.asarray(px)
    if px.ndim == 2:
        px = px[..., None]
    h, w, spp = px.shape
    nbits = bps or 8 * px.dtype.itemsize

    def pack(a):
        rows = a.shape[0]
        if bps is None:
            return a.astype(a.dtype.newbyteorder(bo)).tobytes()
        if bps == 16:
            return a.astype(bo + "u2").tobytes()
        if bps == 8:
            return a.astype(np.uint8).tobytes()
        flat = a.reshape(rows, -1)
        bits = ((flat[..., None] >> np.arange(bps - 1, -1, -1)) & 1)
        return np.packbits(bits.reshape(rows, -1).astype(np.uint8),
                           axis=1).tobytes()

    def predicted(a):
        if predictor == 2:
            u = np.ascontiguousarray(a).view("u%d" % a.dtype.itemsize) \
                if bps is None else a
            d = np.diff(u.astype(np.int64), axis=1, prepend=0) % (1 << nbits)
            return pack(d.astype(u.dtype) if bps is None else d)
        if predictor == 3:
            rows, cols, n = a.shape
            planes = a.astype(a.dtype.newbyteorder(">")).view(
                np.uint8).reshape(rows, cols * n, -1).transpose(0, 2, 1)
            p = planes.reshape(rows, -1).astype(np.int64)
            p[:, n:] -= planes.reshape(rows, -1)[:, :-n]
            return (p % 256).astype(np.uint8).tobytes()
        return pack(a)

    compress = {5: lzw, 8: zlib.compress, 32773: packbits}.get(
        compression, lambda raw: raw)
    chunks = []
    for plane in ([px[..., s: s + 1] for s in range(spp)] if planar
                  else [px]):
        if tile:
            tw, th = tile
            for y in range(0, h, th):
                for x in range(0, w, tw):
                    t = np.zeros((th, tw, plane.shape[2]), px.dtype)
                    part = plane[y: y + th, x: x + tw]
                    t[: part.shape[0], : part.shape[1]] = part
                    chunks.append(compress(predicted(t)))
        else:
            rps = rows_per_strip or h
            for y in range(0, h, rps):
                chunks.append(compress(predicted(plane[y: y + rps])))
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [nbits] * spp),
               (259, 3, [compression]), (262, 3, [photometric]),
               (277, 3, [spp])]
    fmt = {"i": 2, "f": 3}.get(px.dtype.kind) if bps is None else None
    if fmt:
        entries.append((339, 3, [fmt] * spp))
    if planar:
        entries.append((284, 3, [2]))
    if predictor != 1:
        entries.append((317, 3, [predictor]))
    if colormap is not None:
        entries.append((320, 3, list(colormap)))
    entries += list(extra)
    off_tag, cnt_tag = (324, 325) if tile else (273, 279)
    if tile:
        entries += [(322, 3, [tile[0]]), (323, 3, [tile[1]])]
    else:
        entries.append((278, 4, [rows_per_strip or h]))
    data = bytearray(16 if big else 8)
    offsets = []
    for c in chunks:
        offsets.append(len(data))
        data += c
    long_t, field = (16, 8) if big else (4, 4)
    entries += [(off_tag, long_t, offsets),
                (cnt_tag, long_t, [len(c) for c in chunks])]
    entries.sort()
    code = {3: "H", 4: "I", 16: "Q"}
    blobs = {}
    for tag, typ, vals in entries:
        size = struct.calcsize(code[typ]) * len(vals)
        if size > field:
            if len(data) % 2:
                data += b"\x00"
            blobs[tag] = len(data)
            data += struct.pack(bo + code[typ] * len(vals), *vals)
    if len(data) % 2:
        data += b"\x00"
    ifd = len(data)
    if big:
        data[:16] = (b"II+\x00" if bo == "<" else b"MM\x00+") + \
            struct.pack(bo + "HHQ", 8, 0, ifd)
        data += struct.pack(bo + "Q", len(entries))
    else:
        data[:8] = (b"II*\x00" if bo == "<" else b"MM\x00*") + \
            struct.pack(bo + "I", ifd)
        data += struct.pack(bo + "H", len(entries))
    for tag, typ, vals in entries:
        data += struct.pack(bo + "HH" + code[long_t], tag, typ, len(vals))
        if tag in blobs:
            data += struct.pack(bo + code[long_t], blobs[tag])
        else:
            v = struct.pack(bo + code[typ] * len(vals), *vals)
            data += v + b"\x00" * (field - len(v))
    data += b"\x00" * field
    return bytes(data)


def jpeg_parts(data):
    """A JPEG's table segments (DQT, DHT) and its frame and scans, both
    without SOI; APPn segments dropped."""
    tables, rest, i = b"", b"", 2
    while i < len(data):
        m = data[i + 1]
        if m == 0xDA:
            rest += data[i:]
            break
        (n,) = struct.unpack(">H", data[i + 2: i + 4])
        seg = data[i: i + 2 + n]
        if m in (0xDB, 0xC4):
            tables += seg
        elif not 0xE0 <= m <= 0xEF:
            rest += seg
        i += 2 + n
    return tables, rest


def ifd_file(chunks, entries):
    """A little-endian TIFF of `chunks` (in order) and the IFD `entries`
    [(tag, type 3, 4 or 7, values or bytes)], the chunk offsets under
    the tags valued None."""
    data = bytearray(b"II*\x00\x00\x00\x00\x00")
    offsets = []
    for c in chunks:
        offsets.append(len(data))
        data += c + b"\x00" * (len(c) % 2)
    entries = sorted((tag, typ, offsets if vals is None else vals)
                     for tag, typ, vals in entries)

    def raw(typ, vals):
        if typ == 7:
            return bytes(vals)
        return struct.pack("<" + {3: "H", 4: "I"}[typ] * len(vals), *vals)

    blobs = {}
    for tag, typ, vals in entries:
        if len(raw(typ, vals)) > 4:
            blobs[tag] = len(data)
            data += raw(typ, vals) + b"\x00" * (len(raw(typ, vals)) % 2)
    data[4:8] = struct.pack("<I", len(data))
    data += struct.pack("<H", len(entries))
    for tag, typ, vals in entries:
        r = raw(typ, vals)
        data += struct.pack("<HHI", tag, typ, len(r) if typ == 7 else
                            len(vals))
        data += struct.pack("<I", blobs[tag]) if tag in blobs else \
            r + b"\x00" * (4 - len(r))
    return bytes(data + struct.pack("<I", 0))


def jpeg_tiff(px, photometric, quality, tile=None, rows_per_strip=None,
              subsampling=2):
    """A JPEG-compressed TIFF as libtiff writes one: each strip or `tile`
    (w, h) a JPEG of its own (PIL's) without tables, the tables in
    JPEGTables. Photometric 1 gray, 2 RGB (kept as RGB), 6 YCbCr."""
    px = np.asarray(px)
    h, w = px.shape[:2]
    spp = 1 if px.ndim == 2 else 3
    kw = dict(quality=quality)
    if spp == 3:
        kw["subsampling"] = 0 if photometric == 2 else subsampling
        kw["keep_rgb"] = photometric == 2
    if tile:
        tw, th = tile
        boxes = []
        for y in range(0, h, th):
            for x in range(0, w, tw):
                t = np.zeros((th, tw) + px.shape[2:], np.uint8)
                part = px[y: y + th, x: x + tw]
                t[: part.shape[0], : part.shape[1]] = part
                boxes.append(t)
    else:
        rps = rows_per_strip or h
        boxes = [px[y: y + rps] for y in range(0, h, rps)]
    chunks, tables = [], None
    for b in boxes:
        t, rest = jpeg_parts(pil_bytes(b, "JPEG", **kw))
        tables = tables or t
        chunks.append(b"\xff\xd8" + rest)
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [8] * spp),
               (259, 3, [7]), (262, 3, [photometric]), (277, 3, [spp]),
               (284, 3, [1]), (347, 7, b"\xff\xd8" + tables + b"\xff\xd9")]
    if photometric == 6:
        entries.append((530, 3, [2, 2] if subsampling == 2 else [1, 1]))
    if tile:
        entries += [(322, 3, [tile[0]]), (323, 3, [tile[1]]),
                    (324, 4, None), (325, 4, [len(c) for c in chunks])]
    else:
        entries += [(278, 4, [rows_per_strip or h]), (273, 4, None),
                    (279, 4, [len(c) for c in chunks])]
    return ifd_file(chunks, entries)


def old_jpeg_tiff(px, photometric):
    """Old-style JPEG (compression 6): JPEGInterchangeFormat points at a
    whole JFIF stream, which is also the one strip."""
    h, w = px.shape[:2]
    spp = 1 if px.ndim == 2 else 3
    jp = pil_bytes(px, "JPEG", quality=80)
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [8] * spp),
               (259, 3, [6]), (262, 3, [photometric]), (273, 4, None),
               (277, 3, [spp]), (278, 4, [h]), (279, 4, [len(jp)]),
               (513, 4, None), (514, 4, [len(jp)])]
    if spp == 3:
        entries.append((530, 3, [2, 2]))
    return ifd_file([jp], entries)


def pil_tiff(px, mode=None, **kw):
    return pil_bytes(px, "TIFF", mode, **kw)


def bilevel(h, w, seed):
    """A mask of text-like blobs and noise (runs of every length)."""
    rng = np.random.default_rng(seed)
    m = np.zeros((h, w), bool)
    for _ in range(40):
        y, x = rng.integers(0, h), rng.integers(0, w)
        m[y: y + rng.integers(1, 12), x: x + rng.integers(1, 90)] = True
    m ^= rng.random((h, w)) < 0.03
    m[h // 2] = True
    return m


def tiff_cases():
    cases = {}
    gray, rgb = texture(37, 45, 1, 20), texture(37, 45, 3, 21)
    mask = bilevel(53, 1800, 22)       # wider than one makeup code
    small = bilevel(37, 45, 23)
    for comp in (None, "tiff_lzw", "tiff_adobe_deflate", "packbits"):
        name = comp or "raw"
        cases["tiff-gray-" + name] = lambda c=comp: pil_tiff(
            gray, compression=c)
        cases["tiff-rgb-" + name] = lambda c=comp: pil_tiff(
            rgb, compression=c)
        cases["tiff-1bit-" + name] = lambda c=comp: pil_tiff(
            small, compression=c)
        cases["tiff-palette-" + name] = lambda c=comp: pil_tiff(
            (gray // 16).astype(np.uint8), compression=c)
    for comp in ("group3", "group4", "tiff_ccitt"):
        cases["tiff-" + comp] = lambda c=comp: pil_tiff(mask, compression=c)
        cases["tiff-%s-fillorder2" % comp] = lambda c=comp: pil_tiff(
            mask, compression=c, tiffinfo={266: 2})
        cases["tiff-%s-strips" % comp] = lambda c=comp: pil_tiff(
            mask, compression=c, tiffinfo={278: 8})
    cases["tiff-group3-2d"] = lambda: pil_tiff(
        mask, compression="group3", tiffinfo={292: 1})
    cases["tiff-group3-2d-fill"] = lambda: pil_tiff(
        mask, compression="group3", tiffinfo={292: 5})
    cases["tiff-group3-2d-fillorder2"] = lambda: pil_tiff(
        mask, compression="group3", tiffinfo={292: 1, 266: 2})
    cases["tiff-lzw-predictor"] = lambda: pil_tiff(
        gray, compression="tiff_lzw", tiffinfo={317: 2})
    cases["tiff-lzw-predictor-rgb"] = lambda: pil_tiff(
        rgb, compression="tiff_lzw", tiffinfo={317: 2})
    cases["tiff-lzw-large"] = lambda: pil_tiff(
        texture(80, 160, 1, 24), compression="tiff_lzw")
    cases["tiff-lzw-fillorder2"] = lambda: pil_tiff(
        gray, compression="tiff_lzw", tiffinfo={266: 2})
    cases["tiff-rgba-lzw"] = lambda: pil_tiff(
        texture(37, 45, 4, 25), compression="tiff_lzw")
    u16 = (texture(37, 45, 1, 26).astype(np.uint16) * 3)
    cases["tiff-16bit"] = lambda: pil_tiff(u16)
    cases["tiff-16bit-be-lzw"] = lambda: tiff_file(
        u16, 1, 16, bo=">", compression=8, predictor=2)
    cases["tiff-multipage"] = lambda: pil_tiff(
        gray, save_all=True, append_images=[PIL.Image.fromarray(rgb)],
        compression="tiff_lzw")
    cases["tiff-be-gray"] = lambda: tiff_file(gray, 1, 8, bo=">")
    cases["tiff-be-rgb-packbits"] = lambda: tiff_file(
        rgb, 2, 8, bo=">", compression=32773, rows_per_strip=5)
    cases["tiff-tiles-deflate"] = lambda: tiff_file(
        gray, 1, 8, compression=8, tile=(16, 16))
    cases["tiff-tiles-rgb-predictor"] = lambda: tiff_file(
        rgb, 2, 8, compression=8, tile=(32, 16), predictor=2)
    cases["tiff-miniswhite-1"] = lambda: tiff_file(small, 0, 1)
    cases["tiff-miniswhite-8"] = lambda: tiff_file(gray, 0, 8,
                                                   rows_per_strip=7)
    cases["tiff-miniswhite-16"] = lambda: tiff_file(u16, 0, 16)
    cases["tiff-gray-4bit"] = lambda: tiff_file(gray >> 4, 1, 4)
    cases["tiff-gray-2bit-miniswhite"] = lambda: tiff_file(gray >> 6, 0, 2)
    cases["tiff-rgb-16"] = lambda: tiff_file(
        rgb.astype(np.uint16) * 257 + 3, 2, 16)
    cases["tiff-palette-4bit"] = lambda: tiff_file(
        gray >> 4, 3, 4, colormap=np.random.default_rng(27).integers(
            0, 65536, 48))
    cases["tiff-gray-alpha"] = lambda: tiff_file(
        texture(37, 45, 2, 28), 1, 8, extra=((338, 3, [2]),))
    # JPEG-in-TIFF: strips of 16 rows (the last one short) and tiles
    jg, jc = texture(61, 97, 1, 29), texture(61, 97, 3, 30)
    for q in (50, 90):
        cases["tiff-jpeg-gray-q%d" % q] = lambda q=q: jpeg_tiff(
            jg, 1, q, rows_per_strip=16)
        cases["tiff-jpeg-gray-tiles-q%d" % q] = lambda q=q: jpeg_tiff(
            jg, 1, q, tile=(32, 32))
        cases["tiff-jpeg-ycbcr-q%d" % q] = lambda q=q: jpeg_tiff(
            jc, 6, q, rows_per_strip=16)
        cases["tiff-jpeg-ycbcr-tiles-q%d" % q] = lambda q=q: jpeg_tiff(
            jc, 6, q, tile=(32, 48))
    cases["tiff-jpeg-ycbcr-444"] = lambda: jpeg_tiff(
        jc, 6, 75, rows_per_strip=8, subsampling=0)
    cases["tiff-jpeg-rgb"] = lambda: jpeg_tiff(jc, 2, 75, rows_per_strip=24)
    cases["tiff-jpeg-rgb-tiles"] = lambda: jpeg_tiff(jc, 2, 90,
                                                     tile=(64, 16))
    cases["tiff-jpeg-pil-gray"] = lambda: pil_tiff(jg, compression="jpeg",
                                                   quality=60)
    cases["tiff-jpeg-pil-rgb"] = lambda: pil_tiff(jc, compression="jpeg")
    cases["tiff-old-jpeg-gray"] = lambda: old_jpeg_tiff(jg, 1)
    return {k: ("tif", v) for k, v in cases.items()}


# ----------------------------------------------------------------- BMP

def bmp_file(bits, rows, w, h, palette=None, compression=0, masks=None,
             header=40, top_down=False):
    """A BMP with pixel data `rows` (bytes, already in file order)."""
    pal = b""
    if palette is not None:
        pal = b"".join(bytes((b, g, r, 0)) if header != 12 else
                       bytes((b, g, r)) for r, g, b in palette)
    if header == 12:
        hdr = struct.pack("<IhhHH", 12, w, h, 1, bits)
    else:
        hh = -h if top_down else h
        hdr = struct.pack("<IiiHHIIiiII", header, w, hh, 1, bits,
                          compression, len(rows), 2835, 2835,
                          0 if palette is None else len(palette), 0)
        if masks is not None and header >= 52:
            hdr += struct.pack("<4I", *(tuple(masks) + (0,) * 4)[:4])
        hdr += bytes(header - len(hdr))
        if masks is not None and header == 40:
            hdr += struct.pack("<3I", *masks[:3])
    off = 14 + len(hdr) + len(pal)
    return b"BM" + struct.pack("<IHHI", off + len(rows), 0, 0, off) + hdr \
        + pal + rows


def bmp_rows(px, bits, top_down=False):
    """(H, W[, C]) samples -> padded rows, bottom-up unless `top_down`."""
    h = px.shape[0]
    flat = px.reshape(h, -1)
    if bits < 8:
        b = ((flat[..., None] >> np.arange(bits - 1, -1, -1)) & 1)
        flat = np.packbits(b.reshape(h, -1).astype(np.uint8), axis=1)
    elif bits == 16:
        flat = flat.astype("<u2").view(np.uint8).reshape(h, -1)
    stride = (flat.shape[1] + 3) & ~3
    out = np.zeros((h, stride), np.uint8)
    out[:, : flat.shape[1]] = flat
    return (out if top_down else out[::-1]).tobytes()


def rle_stream(rle4):
    """Encoded runs, absolute runs (odd and even), a delta, end of line,
    a run past the row's end and end of bitmap, for a 20 x 6 image (PIL
    reads a delta's two bytes after two more, and refuses a file that
    leaves pixels unset)."""
    def absolute(values):
        if rle4:
            body = bytes((a << 4) | b for a, b in zip(values[::2],
                                                      values[1::2]))
        else:
            body = bytes(values)
        return bytes((0, len(values))) + body + bytes(len(body) % 2)

    s = bytearray()
    s += bytes((5, 0x21 if rle4 else 7)) + absolute([1, 2, 3, 4])
    s += bytes((0, 0))                                      # end of line
    s += bytes((3, 0x43 if rle4 else 9))
    s += absolute([5, 6, 7, 8, 9, 10] if rle4 else [5, 6, 7])
    s += bytes((0, 2, 0, 0, 2, 1))                          # delta
    s += bytes((4, 0x5A if rle4 else 11))
    s += bytes((30, 0x3C if rle4 else 13))                  # past the row
    s += bytes((0, 0))
    for v in (0x12, 0x34, 0x56):
        s += bytes((20, v if rle4 else v >> 1, 0, 0))
    s += bytes((0, 1))
    return bytes(s)


def bmp_cases():
    rng = np.random.default_rng(30)
    gray, rgb = texture(19, 23, 1, 31), texture(19, 23, 3, 32)
    pal16 = [tuple(int(v) for v in rng.integers(0, 256, 3))
             for _ in range(16)]
    pal256 = [tuple(int(v) for v in rng.integers(0, 256, 3))
              for _ in range(256)]
    idx4 = (gray >> 4).astype(np.uint8)
    v565 = rng.integers(0, 65536, (19, 23))
    cases = {
        "bmp-1bit": lambda: pil_bytes(bilevel(19, 23, 33), "BMP"),
        "bmp-8bit-gray": lambda: pil_bytes(gray, "BMP"),
        "bmp-8bit-palette": lambda: pil_bytes(
            (gray // 16).astype(np.uint8), "BMP", palette=True),
        "bmp-24bit": lambda: pil_bytes(rgb, "BMP"),
        "bmp-32bit": lambda: pil_bytes(texture(19, 23, 4, 34), "BMP"),
        "bmp-4bit": lambda: bmp_file(4, bmp_rows(idx4, 4), 23, 19, pal16),
        "bmp-4bit-top-down": lambda: bmp_file(
            4, bmp_rows(idx4, 4, True), 23, 19, pal16, top_down=True),
        "bmp-1bit-colour": lambda: bmp_file(
            1, bmp_rows(bilevel(19, 23, 35).astype(np.uint8), 1), 23, 19,
            [(200, 10, 30), (5, 250, 90)]),
        "bmp-16bit-555": lambda: bmp_file(
            16, bmp_rows(v565 & 0x7FFF, 16), 23, 19),
        "bmp-16bit-565": lambda: bmp_file(
            16, bmp_rows(v565, 16), 23, 19, compression=3,
            masks=(0xF800, 0x7E0, 0x1F)),
        "bmp-32bit-bitfields-v5": lambda: bmp_file(
            32, bmp_rows(texture(19, 23, 4, 36), 32), 23, 19,
            compression=3, masks=(0xFF, 0xFF00, 0xFF0000, 0xFF000000),
            header=124),
        "bmp-os2-24bit": lambda: bmp_file(
            24, bmp_rows(rgb[..., ::-1], 24), 23, 19, header=12),
        "bmp-rle8": lambda: bmp_file(8, rle_stream(False), 20, 6, pal256,
                                     compression=1),
        "bmp-rle4": lambda: bmp_file(4, rle_stream(True), 20, 6, pal16,
                                     compression=2),
    }
    return {k: ("bmp", v) for k, v in cases.items()}


# ----------------------------------------------------------------- PNG

def png_file(px, depth, ctype, interlace=False, palette=None, seed=0):
    """A PNG of samples `px` ((H, W) or (H, W, C)), every row with a
    seeded filter type 0-4, Adam7 when `interlace`."""
    px = np.asarray(px)
    if px.ndim == 2:
        px = px[..., None]
    h, w, ch = px.shape
    rng = np.random.default_rng(seed)
    passes = [(0, 0, 1, 1)] if not interlace else \
        [(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)]
    bpp = max(1, depth * ch // 8)
    raw = bytearray()
    for x0, y0, dx, dy in passes:
        sub = px[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        rows = []
        for r in sub:
            flat = r.reshape(-1)
            if depth == 16:
                b = flat.astype(">u2").view(np.uint8)
            elif depth == 8:
                b = flat.astype(np.uint8)
            else:
                bits = ((flat[:, None] >> np.arange(depth - 1, -1, -1)) & 1)
                b = np.packbits(bits.reshape(-1).astype(np.uint8))
            rows.append(b.astype(np.int64))
        prev = np.zeros_like(rows[0])
        for r in rows:
            ft = int(rng.integers(0, 5))
            left = np.concatenate([np.zeros(bpp, np.int64), r[:-bpp]])
            upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
            if ft == 0:
                pred = 0
            elif ft == 1:
                pred = left
            elif ft == 2:
                pred = prev
            elif ft == 3:
                pred = (left + prev) // 2
            else:
                pa, pb = np.abs(prev - upleft), np.abs(left - upleft)
                pc = np.abs(left + prev - 2 * upleft)
                pred = np.where((pa <= pb) & (pa <= pc), left,
                                np.where(pb <= pc, prev, upleft))
            raw += bytes((ft,)) + ((r - pred) % 256).astype(
                np.uint8).tobytes()
            prev = r
    chunks = [(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                    int(interlace)))]
    if palette is not None:
        chunks.append((b"PLTE", np.asarray(palette, np.uint8).tobytes()))
    chunks += [(b"IDAT", zlib.compress(bytes(raw))), (b"IEND", b"")]
    return _png._SIG + b"".join(_png._chunk(k, v) for k, v in chunks)


def png_cases():
    rng = np.random.default_rng(40)
    gray, rgb = texture(23, 29, 1, 41), texture(23, 29, 3, 42)
    pal = rng.integers(0, 256, (256, 3))
    u16 = rng.integers(0, 700, (23, 29))
    cases = {
        "png-gray": lambda: pil_bytes(gray, "PNG"),
        "png-rgb-optimized": lambda: pil_bytes(rgb, "PNG", optimize=True),
        "png-1bit": lambda: pil_bytes(bilevel(23, 29, 43), "PNG"),
        "png-la": lambda: pil_bytes(texture(23, 29, 2, 44), "PNG"),
        "png-rgba": lambda: pil_bytes(texture(23, 29, 4, 45), "PNG"),
        "png-i16": lambda: pil_bytes(u16.astype(np.uint16), "PNG"),
        "png-gray-2bit": lambda: png_file(gray >> 6, 2, 0, seed=1),
        "png-gray-4bit": lambda: png_file(gray >> 4, 4, 0, seed=2),
        "png-gray-16bit": lambda: png_file(u16, 16, 0, seed=3),
        "png-rgb-16bit": lambda: png_file(
            rgb.astype(np.uint16) * 257 + 5, 16, 2, seed=4),
        "png-la-16bit": lambda: png_file(
            texture(23, 29, 2, 46).astype(np.uint16) * 251, 16, 4, seed=5),
        "png-rgba-16bit": lambda: png_file(
            texture(23, 29, 4, 47).astype(np.uint16) * 253, 16, 6, seed=6),
    }
    for bits in (1, 2, 4, 8):
        cases["png-palette-%dbit" % bits] = lambda b=bits: png_file(
            gray >> (8 - b), b, 3, palette=pal[: 1 << b], seed=7 + b)
    for name, args in (("gray", (gray, 8, 0)), ("rgb", (rgb, 8, 2)),
                       ("gray-16bit", (u16, 16, 0)),
                       ("palette-4bit", (gray >> 4, 4, 3)),
                       ("1bit", (gray >> 7, 1, 0)),
                       ("rgba-16bit", (texture(23, 29, 4, 48).astype(
                           np.uint16) * 255, 16, 6))):
        cases["png-adam7-" + name] = lambda a=args: png_file(
            *a, interlace=True, palette=pal[:16] if a[2] == 3 else None,
            seed=20)
    for h, w in ((1, 1), (1, 9), (7, 1), (5, 6), (13, 7)):
        cases["png-adam7-%dx%d" % (h, w)] = lambda h=h, w=w: png_file(
            texture(h, w, 3, h * 10 + w), 8, 2, interlace=True, seed=h)
    return {k: ("png", v) for k, v in cases.items()}


CASES = {**jpeg_cases(), **tiff_cases(), **bmp_cases(), **png_cases()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_reads_as_pil(tmp_path, name):
    suffix, make = CASES[name]
    path = tmp_path / ("page." + suffix)
    path.write_bytes(make())
    with PIL.Image.open(path) as im:
        size = im.size
        ref = np.asarray(im.convert("L"))
    assert _image.read_size(path) == size
    got = _image.read_gray(path)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    assert int((got != ref).sum()) == 0
    px = _image.read(path)
    if px.ndim == 3:
        with PIL.Image.open(path) as im:
            np.testing.assert_array_equal(px, np.asarray(im.convert("RGB")))


def test_magic_bytes_choose_the_reader(tmp_path):
    """PNG bytes in a file named .jpg (what the JAX package's binarize
    writes) read as PNG, as PIL reads them."""
    px = texture(20, 30, 1, 50)
    path = tmp_path / "page.jpg"
    path.write_bytes(pil_bytes(px, "PNG"))
    np.testing.assert_array_equal(_image.read_gray(path), px)
    assert _image.read_size(path) == (30, 20)


def test_page_reads_jpeg_and_g4_tiff_as_the_jax_page(tmp_path):
    page = np.asarray(PIL.Image.open(FULL / "synth0000.png"))[:400, :300]
    jpg, tif = tmp_path / "a.jpg", tmp_path / "b.tif"
    jpg.write_bytes(jpeg_bytes(page, quality=75))
    tif.write_bytes(pil_tiff(page > 128, compression="group4"))
    for path in (jpg, tif):
        port = Page(path, device="cpu")
        assert port.size() == JaxPage(path).size()
        np.testing.assert_array_equal(port.warped, JaxPage(path).warped)


def zip_entries(path):
    with zipfile.ZipFile(path) as zf:
        return {n: zf.read(n) for n in zf.namelist()}


def test_segment_stage_on_a_jpeg_page(tmp_path, capsys):
    """The heuristic segment stage on a JPEG crop writes the segment.zip
    of a PNG that holds the same decoded pixels."""
    page = np.asarray(PIL.Image.open(FULL / "synth0001.png"))[:640, :480]
    a, b = tmp_path / "jpeg", tmp_path / "png"
    a.mkdir()
    b.mkdir()
    (a / "crop.jpg").write_bytes(jpeg_bytes(page, quality=80))
    _png.write_gray(b / "crop.png", np.asarray(
        PIL.Image.open(a / "crop.jpg").convert("L")))
    for corpus in (a, b):
        stage.main(["-m", "heuristic", "--device", "cpu", "--lock-strategy",
                    "NONE", "--plain", str(corpus)])
        rt = json.loads((corpus / "crop.out/runtime.json").read_text())
        assert rt[stage.STAGE_NAME]["status"] == "COMPLETED", rt
    capsys.readouterr()
    assert zip_entries(a / "crop.out/segment.zip") == \
        zip_entries(b / "crop.out/segment.zip")


# the arithmetic-coded and lossless kinds PIL refuses, as genuine
# libjpeg-turbo files of the fixture (tests/test_torch_image_formats_more.py
# holds the ones it reads): a scan past PIL's 65536-byte read block, and
# lossless at 6 bits
MORE = ROOT / "tests/data/torch_formats/more"
UNSUPPORTED = {
    "arithmetic JPEG": ("jpg", lambda: (
        MORE / "jpeg-arith-block-past.jpg").read_bytes(),
        "arithmetic-coded scan"),
    "lossless JPEG": ("jpg", lambda: (
        MORE / "jpeg-lossless-6-bit.jpg").read_bytes(),
        "lossless at 6-bit precision"),
    "12-bit JPEG": ("jpg", lambda: twelve_bit(jpeg_bytes(
        texture(16, 16, 1, 62))), "12-bit"),
}


def twelve_bit(data):
    i = data.index(b"\xff\xc0")
    return data[: i + 4] + b"\x0c" + data[i + 5:]


@pytest.mark.parametrize("name", sorted(UNSUPPORTED))
def test_unsupported_kinds_raise(tmp_path, name):
    suffix, make, word = UNSUPPORTED[name]
    path = tmp_path / ("page." + suffix)
    path.write_bytes(make())
    with pytest.raises(ValueError, match=word):
        _image.read_gray(path)


def test_fixture_pages_read_as_pil(tmp_path):
    """The fixture's pages in the formats of a real corpus."""
    page = np.asarray(PIL.Image.open(FULL / "synth0000.png"))
    for name, data in (
            ("p.jpg", jpeg_bytes(page, quality=75)),
            ("q.jpg", jpeg_bytes(page, quality=75, progressive=True)),
            ("r.tif", pil_tiff(page > 128, compression="group4"))):
        path = tmp_path / name
        path.write_bytes(data)
        np.testing.assert_array_equal(
            _image.read_gray(path), np.asarray(PIL.Image.open(path).convert(
                "L")))
