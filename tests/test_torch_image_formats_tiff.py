"""The last TIFF kinds that PIL reads, against PIL: old-style JPEG
(compression 6) of one and three components, with a JPEGInterchangeFormat
stream or from the tables tags; YCbCr outside JPEG (none, LZW, Deflate,
PackBits; every sub-sampling libtiff reads; strips, tiles and planes;
ReferenceBlackWhite and YCbCrCoefficients); old-style LZW codes; 12-bit
gray. Every file is written here, seeded, little- and big-endian. Each file
PIL reads must give PIL's `convert("L")` on every pixel, its
`convert("RGB")` where the port reads RGB, and its `.size`; each kind PIL
refuses (CIELab among them) must raise in the JAX package, which reads
pages with PIL, and a ValueError that names it in the port. Tolerance:
none.
"""

import io
import struct
import zlib

import numpy as np
import PIL.Image
import pytest

from origami_tpu.core.page import Page as JaxPage
from origami_tpu_torch.core import _image
from test_torch_image_formats import (crafted_jpeg, jpeg_bytes, lzw,
                                      old_jpeg_tiff, packbits, texture)

_CODE = {3: "H", 4: "I"}


def tiff_bytes(chunks, entries, bo="<", pad=0):
    """A classic TIFF of `chunks` (after the header, in order, then `pad`
    zero bytes) and the IFD `entries` [(tag, type 3, 4, 5 or 7, values)]:
    values None are the chunks' offsets, "counts" their lengths; type 5
    (RATIONAL) values are (numerator, denominator) pairs, type 7 bytes."""
    data = bytearray(8)
    offsets = []
    for c in chunks:
        offsets.append(len(data))
        data += c + b"\x00" * (len(c) % 2)
    data += b"\x00" * pad
    entries = sorted((tag, typ, offsets if vals is None else
                      [len(c) for c in chunks] if vals == "counts" else vals)
                     for tag, typ, vals in entries)

    def raw(typ, vals):
        if typ == 7:
            return bytes(vals)
        if typ == 5:
            return b"".join(struct.pack(bo + "II", *v) for v in vals)
        return struct.pack(bo + _CODE[typ] * len(vals), *vals)

    blobs = {}
    for tag, typ, vals in entries:
        r = raw(typ, vals)
        if len(r) > 4:
            blobs[tag] = len(data)
            data += r + b"\x00" * (len(r) % 2)
    data[:8] = (b"II*\x00" if bo == "<" else b"MM\x00*") + struct.pack(
        bo + "I", len(data))
    data += struct.pack(bo + "H", len(entries))
    for tag, typ, vals in entries:
        r = raw(typ, vals)
        data += struct.pack(bo + "HHI", tag, typ,
                            len(r) if typ == 7 else len(vals))
        data += struct.pack(bo + "I", blobs[tag]) if tag in blobs else \
            r.ljust(4, b"\x00")
    return bytes(data + b"\x00" * 4)


# ----------------------------------------------------------- YCbCr

COMPRESS = {1: bytes, 5: lzw, 8: zlib.compress, 32773: packbits}
SUBSAMPLINGS = ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4))


def ycbcr_tiff(h, w, hs, vs, compression, rps=None, tile=None, bo="<",
               predictor=1, seed=0, extra=(), cut=1.0, pad=0):
    """Three chunky 8-bit samples, photometric YCbCr sub-sampled `hs` x
    `vs`: each strip (`rps` rows) or `tile` (w, h) libtiff's layout of
    seeded bytes (blocks of hs x vs Y samples, then Cb and Cr), under the
    horizontal predictor (differences of 3 bytes apart over rows of
    TIFFScanlineSize bytes: a row of blocks over vs) where asked; `cut`
    keeps that share of each compressed chunk."""
    rng = np.random.default_rng(seed)
    n = hs * vs + 2
    if tile:
        tw, th = tile
        sizes = [-(-tw // hs) * n * -(-th // vs)] * (
            -(-h // th) * -(-w // tw))
        rows = [tw * 3] * len(sizes)
        entries = [(322, 3, [tw]), (323, 3, [th]), (324, 4, None),
                   (325, 4, "counts")]
    else:
        rps = rps or h
        sizes = [-(-w // hs) * n * -(-min(rps, h - y) // vs)
                 for y in range(0, h, rps)]
        rows = [-(-w // hs) * n // vs] * len(sizes)
        entries = [(278, 4, [rps]), (273, 4, None), (279, 4, "counts")]
    chunks = []
    for size, row in zip(sizes, rows):
        raw = rng.integers(0, 256, size).astype(np.uint8)
        if predictor == 2 and not row % 3:
            k = size // row * row
            seg = raw[:k].reshape(-1, row // 3, 3).astype(np.int64)
            raw[:k] = (np.diff(seg, axis=1, prepend=0) % 256).astype(
                np.uint8).ravel()
        c = COMPRESS[compression](raw.tobytes())
        chunks.append(c[: int(len(c) * cut)])
    entries += [(256, 4, [w]), (257, 4, [h]), (258, 3, [8] * 3),
                (259, 3, [compression]), (262, 3, [6]), (277, 3, [3]),
                (530, 3, [hs, vs])] + list(extra)
    if predictor != 1:
        entries.append((317, 3, [predictor]))
    return tiff_bytes(chunks, entries, bo, pad)


def planar_ycbcr(h, w, compression, subsampling, tile=None, seed=0):
    """Three planes of seeded samples, photometric YCbCr."""
    px = texture(h, w, 3, seed)
    chunks = []
    for k in range(3):
        if tile:
            tw, th = tile
            for y in range(0, h, th):
                for x in range(0, w, tw):
                    t = np.zeros((th, tw), np.uint8)
                    part = px[y: y + th, x: x + tw, k]
                    t[: part.shape[0], : part.shape[1]] = part
                    chunks.append(COMPRESS[compression](t.tobytes()))
        else:
            chunks += [COMPRESS[compression](px[y: y + 8, :, k].tobytes())
                       for y in range(0, h, 8)]
    entries = [(322, 3, [tile[0]]), (323, 3, [tile[1]]), (324, 4, None),
               (325, 4, "counts")] if tile else [
        (278, 4, [8]), (273, 4, None), (279, 4, "counts")]
    entries += [(256, 4, [w]), (257, 4, [h]), (258, 3, [8] * 3),
                (259, 3, [compression]), (262, 3, [6]), (277, 3, [3]),
                (284, 3, [2]), (530, 3, list(subsampling))]
    return tiff_bytes(chunks, entries)


def gray_tiff(px, photometric, compression=1, bps=8, rps=None, bo="<",
              extra=()):
    """One sample a pixel (8 bits, or 12 packed most significant bit
    first)."""
    h, w = px.shape
    rps = rps or h

    def pack(a):
        if bps == 8:
            return a.astype(np.uint8).tobytes()
        bits = (a[..., None] >> np.arange(bps - 1, -1, -1)) & 1
        return np.packbits(bits.reshape(a.shape[0], -1).astype(np.uint8),
                           axis=1).tobytes()
    enc = COMPRESS[compression] if compression != 5 else old_lzw
    chunks = [enc(pack(px[y: y + rps])) for y in range(0, h, rps)]
    return tiff_bytes(chunks, [
        (256, 4, [w]), (257, 4, [h]), (258, 3, [bps]),
        (259, 3, [compression]), (262, 3, [photometric]), (277, 3, [1]),
        (278, 4, [rps]), (273, 4, None), (279, 4, "counts")] + list(extra),
        bo)


# ----------------------------------------------------- old-style LZW

def old_lzw(raw, clear_at=4093, freeze=False):
    """Old-style LZW (libtiff's LZWDecodeCompat reads it): CLEAR first,
    codes LSB first, one bit wider once the decoder has made entry
    (1 << width) - 1; CLEAR again when the table reaches `clear_at`, or
    with `freeze` no new entry past 4095 and no CLEAR (the decoder goes
    on making entries it cannot reach)."""
    out = bytearray()
    state = dict(acc=0, n=0, width=9, made=258, first=True)

    def put(code):
        state["acc"] |= code << state["n"]
        state["n"] += state["width"]
        while state["n"] >= 8:
            out.append(state["acc"] & 255)
            state["acc"] >>= 8
            state["n"] -= 8

    def emit(code):
        put(code)
        if state["first"]:
            state["first"] = False
            return
        state["made"] += 1
        if state["made"] > (1 << state["width"]) - 1 and state["width"] < 12:
            state["width"] += 1

    def clear():
        put(256)
        state.update(width=9, made=258, first=True)
        return {bytes([i]): i for i in range(256)}, 258

    table, nxt = clear()
    s = b""
    for b in raw:
        t = s + bytes([b])
        if t in table:
            s = t
            continue
        emit(table[s])
        if not freeze or nxt < 4096:
            table[t] = nxt
            nxt += 1
        s = bytes([b])
        if not freeze and nxt >= clear_at:
            emit(table[s])
            s = b""
            table, nxt = clear()
    if s:
        emit(table[s])
    put(257)
    if state["n"]:
        out.append(state["acc"] & 255)
    return bytes(out)


def old_lzw_rgb(px, bo="<"):
    """RGB under old-style LZW with the horizontal predictor."""
    h, w, _ = px.shape
    d = (np.diff(px.astype(int), axis=1, prepend=0) % 256).astype(np.uint8)
    return tiff_bytes([old_lzw(d.tobytes())], [
        (256, 4, [w]), (257, 4, [h]), (258, 3, [8] * 3), (259, 3, [5]),
        (262, 3, [2]), (277, 3, [3]), (278, 4, [h]), (273, 4, None),
        (279, 4, "counts"), (317, 3, [2])], bo)


# ------------------------------------------------- old-style JPEG

def pil_jpeg(px, **kw):
    buf = io.BytesIO()
    PIL.Image.fromarray(px).save(buf, "JPEG", **kw)
    return buf.getvalue()


def jpeg_layout(jp):
    """A baseline JPEG -> ({table id: DQT body}, {id: DC DHT body}, {id:
    AC DHT body}, the frame's [(id, hv, tq)], the scan's [(id, tda)],
    [(start, end)] of each restart interval's entropy-coded bytes)."""
    q, dc, ac, comps = {}, {}, {}, []
    i = 2
    while True:
        m = jp[i + 1]
        (n,) = struct.unpack(">H", jp[i + 2: i + 4])
        body = jp[i + 4: i + 2 + n]
        k = 0
        if m == 0xDB:
            while k < len(body):
                q[body[k] & 15] = body[k + 1: k + 65]
                k += 65
        elif m == 0xC4:
            while k < len(body):
                size = 17 + sum(body[k + 1: k + 17])
                (ac if body[k] >> 4 else dc)[body[k] & 15] = \
                    body[k + 1: k + size]
                k += size
        elif m == 0xC0:
            comps = [tuple(body[6 + 3 * c: 9 + 3 * c])
                     for c in range(body[5])]
        elif m == 0xDA:
            scan = [tuple(body[1 + 2 * c: 3 + 2 * c]) for c in range(body[0])]
            break
        i += 2 + n
    start, parts, j = i + 2 + n, [], i + 2 + n
    while True:
        j = jp.index(b"\xff", j)
        if jp[j + 1] == 0:
            j += 2
            continue
        parts.append((start, j))
        if jp[j + 1] == 0xD9:
            return q, dc, ac, comps, scan, parts
        start = j = j + 2


def ojpeg_interchange(px, rps, quality=40, subsampling=2, bo="<",
                      photometric=6, spp=3, sub_tag=True, tile=None):
    """Form (a): a whole JFIF stream in JPEGInterchangeFormat with a
    restart every `rps` rows, the strips (or a column of `tile` (w, h)
    tiles) pointing at its restart intervals."""
    h, w = px.shape[:2]
    kw = {} if px.ndim == 2 else dict(subsampling=subsampling)
    mcu = 16 if px.ndim == 3 and subsampling == 2 else 8
    jp = pil_jpeg(px, quality=quality, restart_marker_rows=rps // mcu
                  if rps < h else 0, **kw)
    parts = jpeg_layout(jp)[5]
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [8] * (spp or 3)),
               (259, 3, [6]), (513, 4, [8]), (514, 4, [len(jp)])]
    if tile:
        entries += [(322, 3, [tile[0]]), (323, 3, [tile[1]]),
                    (324, 4, [8 + a for a, _ in parts]),
                    (325, 4, [b - a for a, b in parts])]
    else:
        entries += [(278, 4, [rps]), (273, 4, [8 + a for a, _ in parts]),
                    (279, 4, [b - a for a, b in parts])]
    if photometric is not None:
        entries.append((262, 3, [photometric]))
    if spp is not None:
        entries.append((277, 3, [spp]))
    if px.ndim == 3 and sub_tag:
        entries.append((530, 3, [2, 2]))
    return tiff_bytes([jp], entries, bo)


def ojpeg_tables(px, rps, quality=40, subsampling=2, bo="<", own=False,
                 proc=1, restart_tag=None, blocks=None):
    """Form (b): no JPEGInterchangeFormat; the JPEG's tables in
    JPEGQTables, JPEGDCTables and JPEGACTables (the chroma tables shared
    by Cb and Cr, or written for each where `own`), each strip one
    restart interval of its entropy-coded data (or one strip holding
    restarts every `blocks` MCUs, JPEGRestartInterval `restart_tag`)."""
    h, w = px.shape[:2]
    spp = 1 if px.ndim == 2 else 3
    kw = {} if spp == 1 else dict(subsampling=subsampling)
    mcu = 16 if spp == 3 and subsampling == 2 else 8
    jp = pil_jpeg(px, quality=quality, **kw, **(
        dict(restart_marker_blocks=blocks) if blocks else
        dict(restart_marker_rows=rps // mcu if rps < h else 0)))
    q, dc, ac, comps, scan, parts = jpeg_layout(jp)
    strips = [jp[a: b] for a, b in parts]
    if blocks:
        strips = [jp[parts[0][0]: parts[-1][1]]]
    tables = []
    for k, (table, key) in enumerate(((q, 2), (dc, None), (ac, None))):
        picks = [table[comps[c][2]] if key else
                 table[scan[c][1] >> 4 if k == 1 else scan[c][1] & 15]
                 for c in range(spp)]
        if not own:
            picks = picks[:2]
        tables.append(picks)
    blobs = strips + [t for picks in tables for t in picks]
    offsets, pos = [], 8
    for b in blobs:
        offsets.append(pos)
        pos += len(b) + len(b) % 2
    at, refs = len(strips), []
    for picks in tables:
        ids = offsets[at: at + len(picks)]
        at += len(picks)
        refs.append(ids + [ids[-1]] * (spp - len(ids)))
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [8] * spp),
               (259, 3, [6]), (262, 3, [6 if spp == 3 else 1]),
               (277, 3, [spp]), (278, 4, [rps]),
               (273, 4, offsets[: len(strips)]),
               (279, 4, [len(s) for s in strips]), (512, 3, [proc]),
               (519, 4, refs[0]), (520, 4, refs[1]), (521, 4, refs[2])]
    if spp == 3:
        entries.append((530, 3, [comps[0][1] >> 4, comps[0][1] & 15]))
    if restart_tag is not None:
        entries.append((515, 3, [restart_tag]))
    return tiff_bytes(blobs, entries, bo)


def ojpeg_crafted(h, w, sampling, seed, tile=None):
    """Form (a) of a baseline JPEG of any sampling factors, one strip (or
    one `tile`)."""
    jp = crafted_jpeg(h if not tile else tile[1], w if not tile else
                      tile[0], sampling, seed)
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [8] * 3),
               (259, 3, [6]), (262, 3, [6]), (277, 3, [3]), (513, 4, [8]),
               (514, 4, [len(jp)])]
    entries += [(322, 3, [tile[0]]), (323, 3, [tile[1]]), (324, 4, [8]),
                (325, 4, [len(jp)])] if tile else [
        (278, 4, [h]), (273, 4, [8]), (279, 4, [len(jp)])]
    return tiff_bytes([jp], entries)


# ------------------------------------------------------------ cases

def rbw(*v):
    return [(round(x * 10), 10) for x in v]


def cases():
    c = {}
    for hs, vs in SUBSAMPLINGS:
        s = "%dx%d" % (hs, vs)
        for comp, name in ((5, "lzw"), (8, "deflate"), (32773, "packbits")):
            c["ycbcr-%s-%s" % (s, name)] = lambda hs=hs, vs=vs, comp=comp: \
                ycbcr_tiff(37, 45, hs, vs, comp, rps=8, seed=hs * 10 + vs)
        c["ycbcr-%s-deflate-be" % s] = lambda hs=hs, vs=vs: ycbcr_tiff(
            37, 45, hs, vs, 8, rps=12, bo=">", seed=hs + vs)
        # a tile past the right edge by 13 pixels (< 16: whole blocks
        # skipped but at 4 x 4) and by 29 (> 16)
        c["ycbcr-%s-tiles-deflate" % s] = lambda hs=hs, vs=vs: ycbcr_tiff(
            37, 45, hs, vs, 8, tile=(16, 16), seed=3)
        c["ycbcr-%s-tiles-lzw-be" % s] = lambda hs=hs, vs=vs: ycbcr_tiff(
            37, 35, hs, vs, 5, tile=(32, 16), bo=">", seed=4)
    # 4 x 4 across an odd count of blocks: each strip's last 2 bytes a row
    # of blocks short
    c["ycbcr-4x4-odd-blocks-strips"] = lambda: ycbcr_tiff(36, 44, 4, 4, 8,
                                                          rps=8)
    c["ycbcr-2x2-rows-per-strip-5"] = lambda: ycbcr_tiff(37, 45, 2, 2, 8,
                                                         rps=5)
    for s, (hs, vs) in (("2x2", (2, 2)), ("2x1", (2, 1)), ("4x4", (4, 4))):
        # 2 x 1: rows of 23 x 4 bytes, not a multiple of 3 (libtiff fails
        # the predictor, PIL shows the differences)
        c["ycbcr-%s-deflate-predictor" % s] = lambda hs=hs, vs=vs: \
            ycbcr_tiff(37, 45, hs, vs, 8, rps=8, predictor=2)
    c["ycbcr-2x2-tiles-lzw-predictor"] = lambda: ycbcr_tiff(
        37, 45, 2, 2, 5, tile=(16, 16), predictor=2)
    c["ycbcr-1x2-tiles-lzw-predictor"] = lambda: ycbcr_tiff(
        37, 45, 1, 2, 5, tile=(16, 16), predictor=2)
    for comp, name in ((8, "deflate"), (5, "lzw"), (32773, "packbits")):
        c["ycbcr-2x2-%s-short" % name] = lambda comp=comp: ycbcr_tiff(
            37, 45, 2, 2, comp, rps=16, cut=0.6)
    for bo, b in (("<", "le"), (">", "be")):
        c["ycbcr-reference-coefficients-" + b] = lambda bo=bo: ycbcr_tiff(
            37, 45, 2, 2, 8, rps=8, bo=bo, extra=(
                (532, 5, rbw(16, 235, 128, 240, 128, 240)),
                (529, 5, [(2126, 10000), (7152, 10000), (722, 10000)])))
    c["ycbcr-reference-odd"] = lambda: ycbcr_tiff(37, 45, 1, 1, 32773, extra=(
        (532, 5, [(7, 3), (2551, 10), (1281, 10), (2551, 11), (1289, 10),
                  (2001, 9)]),))
    c["ycbcr-positioning-2"] = lambda: ycbcr_tiff(
        37, 45, 2, 2, 8, rps=8, extra=((531, 3, [2]),))
    # uncompressed: PIL's "RGBX" of the file's bytes, whatever the
    # sub-sampling (the file padded so that the reads stay inside it)
    for s, (hs, vs) in (("1x1", (1, 1)), ("2x2", (2, 2)), ("4x2", (4, 2))):
        c["ycbcr-%s-raw" % s] = lambda hs=hs, vs=vs: ycbcr_tiff(
            37, 45, hs, vs, 1, pad=7000)
        c["ycbcr-%s-raw-strips-be" % s] = lambda hs=hs, vs=vs: ycbcr_tiff(
            37, 45, hs, vs, 1, rps=8, bo=">", pad=7000)
    c["ycbcr-2x2-raw-tiles"] = lambda: ycbcr_tiff(37, 44, 2, 2, 1,
                                                  tile=(16, 16), pad=5000)
    c["ycbcr-gray-raw"] = lambda: gray_tiff(texture(19, 23, 1, 5), 6)
    c["ycbcr-planar-raw"] = lambda: planar_ycbcr(20, 30, 1, (2, 2))
    c["ycbcr-planar-deflate"] = lambda: planar_ycbcr(20, 30, 8, (1, 1))
    c["ycbcr-planar-lzw-tiles"] = lambda: planar_ycbcr(20, 30, 5, (1, 1),
                                                       tile=(16, 16))
    # old-style LZW
    gray, noise = texture(61, 70, 1, 11), np.random.default_rng(3).integers(
        0, 256, (100, 120)).astype(np.uint8)
    for bo, b in (("<", "le"), (">", "be")):
        c["lzw-old-gray-" + b] = lambda bo=bo: gray_tiff(gray, 1, 5, bo=bo)
        c["lzw-old-gray-strips-" + b] = lambda bo=bo: gray_tiff(
            gray, 1, 5, rps=9, bo=bo)
    c["lzw-old-noise-clears"] = lambda: gray_tiff(noise, 1, 5)
    c["lzw-old-rgb-predictor"] = lambda: old_lzw_rgb(texture(30, 40, 3, 12))
    c["lzw-old-table-past-4095"] = lambda: tiff_bytes([old_lzw(
        noise[:40].tobytes(), freeze=True)], [
        (256, 4, [120]), (257, 4, [40]), (258, 3, [8]), (259, 3, [5]),
        (262, 3, [1]), (277, 3, [1]), (278, 4, [40]), (273, 4, None),
        (279, 4, "counts")])
    # 12-bit gray ("I;12" -> "I;16" -> "L": clipped at 255)
    v = texture(25, 31, 1, 13).astype(np.uint16) * 16 + \
        np.random.default_rng(4).integers(0, 16, (25, 31)).astype(np.uint16)
    v[0, :6] = [0, 1, 254, 255, 256, 4095]
    for comp, name in ((1, "raw"), (8, "deflate"), (5, "lzw-old"),
                       (32773, "packbits")):
        c["gray12-" + name] = lambda comp=comp: gray_tiff(v, 1, comp, 12)
        c["gray12-%s-strips" % name] = lambda comp=comp: gray_tiff(
            v, 1, comp, 12, rps=4)
    c["gray12-lzw"] = lambda: tiff_bytes([lzw(np.packbits(
        ((v[..., None] >> np.arange(11, -1, -1)) & 1).reshape(25, -1).astype(
            np.uint8), axis=1).tobytes())], [
        (256, 4, [31]), (257, 4, [25]), (258, 3, [12]), (259, 3, [5]),
        (262, 3, [1]), (277, 3, [1]), (278, 4, [25]), (273, 4, None),
        (279, 4, "counts")])
    # old-style JPEG
    rgb, g = texture(61, 97, 3, 3), texture(61, 97, 1, 4)
    # subsampling 0, 1, 2: 4:4:4, 4:2:2, 4:2:0; big-endian in one strip
    # (test_port_refuses_what_pil_misreads holds more)
    for ss in (0, 1, 2):
        rps = 16 if ss == 2 else 8
        c["ojpeg-interchange-%d-le" % ss] = lambda ss=ss, rps=rps: \
            ojpeg_interchange(rgb, rps, 80, ss)
        c["ojpeg-tables-%d-le" % ss] = lambda ss=ss, rps=rps: ojpeg_tables(
            rgb, rps * 2, 80, ss)
        c["ojpeg-interchange-%d-be" % ss] = lambda ss=ss: ojpeg_interchange(
            rgb, 64, 80, ss, ">")
        c["ojpeg-tables-%d-be" % ss] = lambda ss=ss: ojpeg_tables(
            rgb, 61, 80, ss, ">")
    c["ojpeg-moved"] = lambda: old_jpeg_tiff(texture(16, 16, 3, 63), 6)
    c["ojpeg-interchange-one-strip"] = lambda: ojpeg_interchange(rgb, 64)
    c["ojpeg-interchange-no-photometric-no-spp"] = lambda: ojpeg_interchange(
        rgb, 32, photometric=None, spp=None, sub_tag=False)
    c["ojpeg-interchange-rgb-photometric"] = lambda: ojpeg_interchange(
        rgb, 32, subsampling=1, photometric=2)
    c["ojpeg-interchange-shorter-image"] = lambda: tiff_bytes(
        [pil_jpeg(rgb, quality=60)], [
            (256, 4, [97]), (257, 4, [50]), (258, 3, [8] * 3), (259, 3, [6]),
            (262, 3, [6]), (277, 3, [3]), (278, 4, [50]), (273, 4, None),
            (279, 4, "counts"), (513, 4, None), (514, 4, "counts")])
    c["ojpeg-interchange-tiles-one-column"] = lambda: ojpeg_crafted(
        61, 57, [(2, 2), (1, 1), (1, 1)], 7, tile=(64, 64))
    c["ojpeg-tables-own"] = lambda: ojpeg_tables(rgb, 32, own=True)
    c["ojpeg-tables-one-strip"] = lambda: ojpeg_tables(rgb, 61)
    c["ojpeg-tables-proc-14"] = lambda: ojpeg_tables(rgb, 32, proc=14)
    c["ojpeg-tables-restart-tag"] = lambda: ojpeg_tables(
        rgb, 61, blocks=5, restart_tag=5)
    for samp in ([(2, 1), (1, 1), (1, 1)], [(1, 2), (1, 1), (1, 1)],
                 [(4, 1), (1, 1), (1, 1)], [(4, 2), (1, 1), (1, 1)]):
        c["ojpeg-crafted-%dx%d" % samp[0]] = lambda samp=samp: ojpeg_crafted(
            61, 97, samp, 5)
    c["ojpeg-gray-interchange"] = lambda: ojpeg_interchange(g, 16, spp=1,
                                                            photometric=1)
    c["ojpeg-gray-interchange-miniswhite"] = lambda: ojpeg_interchange(
        g, 64, spp=1, photometric=0, bo=">")
    c["ojpeg-gray-tables"] = lambda: ojpeg_tables(g, 16)
    c["ojpeg-gray-tables-one-strip"] = lambda: ojpeg_tables(g, 61)
    return c


def refused():
    """name -> (bytes, a word of the port's ValueError)."""
    rgb = texture(61, 97, 3, 3)
    lab = tiff_bytes([texture(20, 30, 3, 6).tobytes()], [
        (256, 4, [30]), (257, 4, [20]), (258, 3, [8] * 3), (259, 3, [1]),
        (262, 3, [8]), (277, 3, [3]), (278, 4, [20]), (273, 4, None),
        (279, 4, "counts")])
    big12 = gray_tiff(texture(9, 11, 1, 7).astype(np.uint16) * 16, 1, 1, 12,
                      bo=">")
    return {
        "CIELab": (lambda: lab, "CIELab"),
        "CIELab deflate": (lambda: tiff_bytes([zlib.compress(texture(
            20, 30, 3, 6).tobytes())], [
            (256, 4, [30]), (257, 4, [20]), (258, 3, [8] * 3), (259, 3, [8]),
            (262, 3, [8]), (277, 3, [3]), (278, 4, [20]), (273, 4, None),
            (279, 4, "counts")]), "CIELab"),
        "YCbCr 1x4": (lambda: ycbcr_tiff(37, 45, 1, 4, 8), "sub-sampled"),
        "YCbCr 2x4": (lambda: ycbcr_tiff(37, 45, 2, 4, 5), "sub-sampled"),
        "YCbCr 3x3": (lambda: ycbcr_tiff(37, 45, 3, 3, 8), "sub-sampled"),
        "YCbCr one sample compressed": (lambda: gray_tiff(
            texture(19, 23, 1, 5), 6, 8), "YCbCr of 1 samples"),
        "planar YCbCr 2x2 compressed": (lambda: planar_ycbcr(
            20, 30, 8, (2, 2)), "planar YCbCr"),
        "uncompressed YCbCr past the end": (lambda: ycbcr_tiff(
            37, 45, 2, 2, 1), "past"),
        "uncompressed YCbCr tile rows overlap": (lambda: ycbcr_tiff(
            37, 45, 2, 2, 1, tile=(16, 16), pad=9000), "past its rows"),
        "old-style JPEG progressive": (lambda: tiff_bytes(
            [pil_jpeg(rgb, quality=60, progressive=True)], [
                (256, 4, [97]), (257, 4, [61]), (258, 3, [8] * 3),
                (259, 3, [6]), (262, 3, [6]), (277, 3, [3]), (278, 4, [61]),
                (273, 4, None), (279, 4, "counts"), (513, 4, None),
                (514, 4, "counts")]), "0xC2 marker"),
        "old-style JPEG chroma sub-sampled": (lambda: ojpeg_crafted(
            61, 97, [(2, 2), (1, 1), (2, 2)], 5), "sampled"),
        "old-style JPEG narrower image": (lambda: tiff_bytes(
            [pil_jpeg(rgb, quality=60)], [
                (256, 4, [90]), (257, 4, [61]), (258, 3, [8] * 3),
                (259, 3, [6]), (262, 3, [6]), (277, 3, [3]), (278, 4, [61]),
                (273, 4, None), (279, 4, "counts"), (513, 4, None),
                (514, 4, "counts")]), "components in a"),
        "old-style JPEG gray as YCbCr": (lambda: ojpeg_interchange(
            texture(61, 97, 1, 4), 16, spp=1, photometric=6),
            "old-style JPEG of 1 samples"),
        "old-style JPEG gray without SamplesPerPixel": (
            lambda: ojpeg_interchange(texture(61, 97, 1, 4), 16, spp=None,
                                      photometric=1),
            "old-style JPEG of 1 samples"),
        "old-style JPEG strips of 24 rows at 2x2": (lambda: ojpeg_tables(
            rgb, 24), "rows at"),
        "old-style LZW that ends early": (lambda: tiff_bytes(
            [old_lzw(texture(20, 30, 1, 8).tobytes())[:200]], [
                (256, 4, [30]), (257, 4, [20]), (258, 3, [8]), (259, 3, [5]),
                (262, 3, [1]), (277, 3, [1]), (278, 4, [20]), (273, 4, None),
                (279, 4, "counts")]), "ends early"),
        "old-style LZW table past 5118": (lambda: tiff_bytes([old_lzw(
            np.random.default_rng(5).integers(0, 256, 7200).astype(
                np.uint8).tobytes(), freeze=True)], [
            (256, 4, [120]), (257, 4, [60]), (258, 3, [8]), (259, 3, [5]),
            (262, 3, [1]), (277, 3, [1]), (278, 4, [60]), (273, 4, None),
            (279, 4, "counts")]), "bad LZW code"),
        "12-bit big-endian": (lambda: big12, "PIL has no mode"),
        "12-bit predictor": (lambda: gray_tiff(
            texture(9, 11, 1, 7).astype(np.uint16) * 16, 1, 8, 12,
            extra=((317, 3, [2]),)), "predictor"),
        "12-bit MinIsWhite": (lambda: gray_tiff(
            texture(9, 11, 1, 7).astype(np.uint16) * 16, 0, 1, 12),
            "PIL has no mode"),
    }


def misread():
    """Files that PIL reads through a libtiff fault and the port refuses
    (ROADMAP C8): big-endian old-style JPEG in several strips, where PIL
    gives strip k the stream's strip 2k. -> name -> (bytes, word)."""
    rgb, g = texture(61, 97, 3, 3), texture(61, 97, 1, 4)
    return {
        "old-style JPEG big-endian strips": (lambda: ojpeg_interchange(
            rgb, 16, bo=">"), "big-endian old-style JPEG"),
        "old-style JPEG big-endian tables strips": (lambda: ojpeg_tables(
            rgb, 32, bo=">"), "big-endian old-style JPEG"),
        "old-style JPEG big-endian gray strips": (lambda: ojpeg_interchange(
            g, 16, spp=1, photometric=1, bo=">"),
            "big-endian old-style JPEG"),
    }


CASES = {k: ("tif", v) for k, v in cases().items()}
REFUSED = {k: ("tif",) + v for k, v in refused().items()}
MISREAD = {k: ("tif",) + v for k, v in misread().items()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_reads_as_pil(tmp_path, name):
    path = tmp_path / "page.tif"
    path.write_bytes(CASES[name][1]())
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


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_both_refuse(tmp_path, name):
    """PIL (so the JAX package's page reader) fails; the port raises a
    ValueError naming the kind, and still gives PIL's size where PIL opens
    the header."""
    _, make, word = REFUSED[name]
    path = tmp_path / "page.tif"
    path.write_bytes(make())
    with pytest.raises(Exception):
        with PIL.Image.open(path) as im:
            im.convert("L")
    with pytest.raises(ValueError, match=word):
        _image.read_gray(path)
    try:
        with PIL.Image.open(path) as im:
            size = im.size
    except Exception:
        return
    assert _image.read_size(path) == size


@pytest.mark.parametrize("name", sorted(MISREAD))
def test_port_refuses_what_pil_misreads(tmp_path, name):
    """PIL reads the file, other rows than the stream's own in the strips
    after the first; the port raises a ValueError naming the kind."""
    _, make, word = MISREAD[name]
    path = tmp_path / "page.tif"
    path.write_bytes(make())
    with PIL.Image.open(path) as im:
        im.convert("L")
    with pytest.raises(ValueError, match=word):
        _image.read_gray(path)


def test_cielab_raises_in_both_packages(tmp_path):
    """The JAX package's Page decodes with PIL's convert("L"), which
    refuses mode LAB; the port's Page raises too, and both give the
    header's size."""
    from origami_tpu_torch.core.page import Page
    path = tmp_path / "lab.tif"
    path.write_bytes(REFUSED["CIELab"][1]())
    assert JaxPage(path).size() == Page(path, device="cpu").size() == (30, 20)
    with pytest.raises(ValueError, match="LAB"):
        JaxPage(path).warped
    with pytest.raises(ValueError, match="CIELab"):
        Page(path, device="cpu").warped
