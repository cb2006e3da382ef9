"""Build the page-format fixture that the PyTorch port's image readers are
held against (chip_smoke.py phases 21, 22, 24 and 25), with PIL and the JAX
package on the CPU:

    tests/data/torch_formats/files/<case>.<ext>   every case of
        tests/test_torch_image_formats.py and tests/test_torch_jpeg2000.py
        (seeded, small: JPEG qualities, samplings, restarts, progressive
        and truncated progressive files, TIFF compressions with JPEG
        strips and tiles, fill orders, tiles, byte orders, BMP depths and
        RLE, PNG depths and Adam7, JPEG 2000 with every writer option of
        Pillow), and the kinds that must raise
    tests/data/torch_formats/files/jp2-opj-<kind>.j2k (or .jp2)   the
        JPEG 2000 kinds PIL's writer cannot make (code-block styles,
        SOP/EPH, RGN, POC, tile-parts, sub-sampled components, sYCC,
        packed packet headers moved into PPT and PPM segments; a
        sub-sampled gray file and five components, which raise), written
        by the libopenjp2 that PIL bundles through ctypes; each file's
        markers are checked before it is kept
    tests/data/torch_formats/more/jpeg-<kind>.jpg   lossless (SOF3: every
        predictor, point transforms, restarts, gray, RGB, CMYK) and
        arithmetic-coded JPEG (SOF9 and SOF10: samplings, restarts, DAC
        conditioning, progressive with successive approximation,
        truncated progressive files that libjpeg smooths, the files on
        both sides of PIL's 65536-byte read block) written by the
        libjpeg-turbo 3.1 that PIL bundles (a small C writer built with
        gcc against the system's jpeglib.h), and the kinds both PIL and
        the port refuse (12-bit, lossless at 6 bits, lossless YCbCr and
        YCCK, SOF11)
    tests/data/torch_formats/more/<case>.{tif,bmp,jpg}   the cases of
        tests/test_torch_image_formats_more.py: BigTIFF, planar, CMYK,
        float and signed, associated-alpha TIFF, the BMP palettes PIL
        drops, sub-sampled lossless JPEG, and the kinds both refuse
    tests/data/torch_formats/tiff/<case>.tif   the cases of
        tests/test_torch_image_formats_tiff.py: old-style JPEG (both
        forms), YCbCr outside JPEG, old-style LZW and 12-bit gray, the
        kinds both refuse (CIELab among them) and those PIL misreads
    tests/data/torch_formats/pages/synth000{0,1}.jpg   the two pages of
        tests/data/torch_ocr/full as baseline gray JPEG (quality PAGE_Q),
        synth0000.progressive.jpg, synth0001.g4.tif (the page > 128),
        synth0000.jp2 (an archive profile: 9/7, RPCL, 6 resolutions,
        256 x 256 precincts, 64 x 64 code-blocks, 3 layers at rates
        80/40/JP2_RATE), synth0001.jp2 (9/7 in 512 x 512 tiles at rate
        JP2_RATE), synth0001.jpeg.tif (JPEG-in-TIFF at quality TIFF_Q,
        strips of 64 rows), synth000{0,1}.lossless.jpg (lossless JPEG by
        libjpeg-turbo: predictor 1; predictor 6 with a restart every 32
        rows), whose pixels are the PNG pages';
        synth000{0,1}.ojpeg.tif (the pages as RGB, old-style JPEG at
        quality PAGE_Q, 2 x 2 sub-sampling, strips of 64 rows:
        synth0000 a whole JFIF stream in JPEGInterchangeFormat, synth0001
        the tables tags with a restart interval a strip)
    tests/data/torch_formats/manifest.json   {path: {"size": PIL's
        .size, "sha256": of PIL's convert("L") bytes} or {"raises": a
        word of the ValueError}}
    tests/data/torch_formats/chain/synth000{0,1}.out/   the JAX chain on
        the two JPEG pages: the students (target quality) up to order as
        scripts/make_torch_ocr_fixture.py runs them, the OCR stage with
        models_pretrained/recognizer, compose: compose.zip, and the
        segment.zip, contours.1.zip, contours.2.zip, dewarp.zip and
        tables.json that the port's runs from the JAX segmentation and
        from the JAX layout read
    tests/data/torch_formats/chain_jp2/synth000{0,1}.out/compose.zip
        the same chain on the two JP2 pages
    tests/data/torch_formats/chain_ojpeg/synth000{0,1}.ojpeg.out/
        compose.zip   the same chain on the two old-style JPEG pages

    JAX_PLATFORMS=cpu python scripts/make_torch_formats_fixture.py [--only files,chain]

`files` takes seconds, `chain` several minutes. `--only tiff` writes
tiff/ and the old-style JPEG pages into the existing manifest alone,
`--only chain_ojpeg` runs the JAX chain on those pages alone.
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import hashlib
import json
import os
import shutil
import struct
import sys
import tempfile
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("ORIGAMI_TPU_PLATFORM", "cpu")

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))
sys.path.insert(0, str(ROOT / "scripts"))

OUT = ROOT / "tests" / "data" / "torch_formats"
PAGES = ROOT / "tests" / "data" / "torch_ocr" / "full"
STEMS = ("synth0000", "synth0001")
PAGE_Q = 40          # keeps the fixture under 1.5 MB
TIFF_Q = 15          # the JPEG-in-TIFF page's quality (its size)
# the JP2 pages' last layer (compression ratio): at 20-25 the JAX chain's
# text fell to 229 of the PNG chain's 606 lines, at 10 it keeps 532 (the
# JPEG pages at PAGE_Q keep 536); 10.5 keeps a page under 250 KB
JP2_RATE = 10.5
# the JAX chain's artifacts that the port's runs from the JAX segmentation
# and from the JAX layout read (chip_smoke.py phase 22)
CHAIN_KEEP = ("compose.zip", "segment.zip", "contours.1.zip",
              "contours.2.zip", "dewarp.zip", "tables.json")


def pil_entry(path):
    import PIL.Image
    with PIL.Image.open(path) as im:
        size = list(im.size)
        px = np.ascontiguousarray(np.asarray(im.convert("L")))
    return {"size": size, "sha256": hashlib.sha256(px.tobytes()).hexdigest()}


# ---------------------------------------------------------------- libopenjp2

# opj_cparameters_t of OpenJPEG 2.5 (x86-64): byte offsets of the fields set
# here, and of opj_poc_t within POC[32]
_P = dict(tile_size_on=0, cp_tdx=12, cp_disto_alloc=20, csty=48,
          prog_order=52, poc=56, numpocs=4792, tcp_numlayers=4796,
          tcp_rates=4800, numresolution=5600, cblockw=5604, mode=5612,
          irreversible=5616, roi_compno=5620, tp_on=18696, tcp_mct=18698)
_POC_SIZE = 148


def openjpeg():
    """The libopenjp2 that PIL bundles."""
    import PIL
    libs = os.path.join(os.path.dirname(PIL.__file__), "..", "pillow.libs")
    found = glob.glob(os.path.join(libs, "libopenjp2-*.so*"))
    if not found:
        raise RuntimeError("no libopenjp2 beside PIL in %s" % libs)
    lib = ctypes.CDLL(found[0])
    lib.opj_version.restype = ctypes.c_char_p
    if not lib.opj_version().startswith(b"2.5"):
        raise RuntimeError("libopenjp2 %s, the offsets are 2.5's"
                           % lib.opj_version())
    vp = ctypes.c_void_p
    lib.opj_set_default_encoder_parameters.restype = None
    lib.opj_set_default_encoder_parameters.argtypes = [vp]
    lib.opj_image_create.restype = vp
    lib.opj_image_create.argtypes = [ctypes.c_uint32, vp, ctypes.c_int]
    lib.opj_create_compress.argtypes = [ctypes.c_int]
    lib.opj_create_compress.restype = vp
    lib.opj_setup_encoder.argtypes = [vp, vp, vp]
    lib.opj_stream_create_default_file_stream.restype = vp
    lib.opj_stream_create_default_file_stream.argtypes = [ctypes.c_char_p,
                                                          ctypes.c_int]
    lib.opj_start_compress.argtypes = [vp, vp, vp]
    lib.opj_encode.argtypes = [vp, vp]
    lib.opj_end_compress.argtypes = [vp, vp]
    for f in ("opj_setup_encoder", "opj_start_compress", "opj_encode",
              "opj_end_compress"):
        getattr(lib, f).restype = ctypes.c_int
    for f in ("opj_stream_destroy", "opj_destroy_codec", "opj_image_destroy"):
        getattr(lib, f).argtypes = [vp]
        getattr(lib, f).restype = None
    return lib


class _Cmpt(ctypes.Structure):
    _fields_ = [(n, ctypes.c_uint32) for n in
                ("dx", "dy", "w", "h", "x0", "y0", "prec", "bpp", "sgnd")]


# OPJ_COLOR_SPACE
_SRGB, _GRAY, _SYCC = 1, 2, 3


def opj_encode(path, px, jp2=False, irreversible=False, layers=(0,),
               mode=0, csty=0, roi=None, pocs=(), tile_parts=None, sub=None,
               colour=None, tile=None):
    """`px` ((H, W) or (H, W, C) uint8) through opj_compress's parameters:
    code-block `mode` bits, COD `csty` (2 SOP, 4 EPH), `roi` (component,
    shift), `pocs` [(res0, comp0, layer1, res1, comp1, progression)],
    `tile_parts` ("R", "L" or "C"), `sub` [(dx, dy)] per component,
    `colour` the JP2 colour space (sYCC: the samples are Y, Cb, Cr and no
    component transform runs), `tile` (w, h)."""
    lib = openjpeg()
    px = np.asarray(px)
    h, w = px.shape[:2]
    nc = 1 if px.ndim == 2 else px.shape[2]
    params = (ctypes.c_uint8 * 20000)()
    lib.opj_set_default_encoder_parameters(params)

    def put(name, fmt, *v, at=0):
        struct.pack_into(fmt, params, _P[name] + at, *v)
    put("numresolution", "<i", 6)
    put("cblockw", "<iii", 64, 64, mode)
    put("irreversible", "<i", int(irreversible))
    put("csty", "<i", csty)
    put("tcp_numlayers", "<i", len(layers))
    for i, r in enumerate(layers):
        put("tcp_rates", "<f", r, at=4 * i)
    put("cp_disto_alloc", "<i", 1)
    if roi:
        put("roi_compno", "<ii", *roi)
    if tile_parts:
        put("tp_on", "<bb", 1, ord(tile_parts))
    if tile:
        put("tile_size_on", "<i", 1)
        put("cp_tdx", "<ii", *tile)
    if colour is None:
        colour = _GRAY if nc < 3 else _SRGB
    put("tcp_mct", "<b", 1 if nc == 3 and colour == _SRGB else 0)
    for i, (r0, c0, l1, r1, c1, prg) in enumerate(pocs):
        put("poc", "<IIIII", r0, c0, l1, r1, c1, at=_POC_SIZE * i)
        put("poc", "<i", prg, at=_POC_SIZE * i + 32)      # prg1
        put("poc", "<I", 1, at=_POC_SIZE * i + 48)        # tile 1
    put("numpocs", "<I", len(pocs))
    sub = sub or [(1, 1)] * nc
    cm = (_Cmpt * nc)()
    for c, (dx, dy) in enumerate(sub):
        cm[c].dx, cm[c].dy = dx, dy
        cm[c].w, cm[c].h = -(-w // dx), -(-h // dy)
        cm[c].prec = cm[c].bpp = 8
    img = lib.opj_image_create(nc, cm, colour)
    (ctypes.c_uint32 * 4).from_address(img)[:] = [0, 0, w, h]
    comps = ctypes.c_void_p.from_address(img + 24).value
    flat = px.reshape(h, w, nc)
    for c, (dx, dy) in enumerate(sub):
        src = np.ascontiguousarray(flat[::dy, ::dx, c], np.int32)
        data = ctypes.c_void_p.from_address(comps + 64 * c + 48).value
        ctypes.memmove(data, src.ctypes.data, src.nbytes)
    codec = lib.opj_create_compress(2 if jp2 else 0)
    stream = None
    try:
        if not lib.opj_setup_encoder(codec, params, img):
            raise RuntimeError("opj_setup_encoder failed for %s" % path)
        stream = lib.opj_stream_create_default_file_stream(
            str(path).encode(), 0)
        if not (lib.opj_start_compress(codec, img, stream)
                and lib.opj_encode(codec, stream)
                and lib.opj_end_compress(codec, stream)):
            raise RuntimeError("libopenjp2 failed to encode %s" % path)
    finally:
        if stream:
            lib.opj_stream_destroy(stream)
        lib.opj_destroy_codec(codec)
        lib.opj_image_destroy(img)


def marker_segments(cs):
    """[(marker, body)] of a codestream's main and tile-part headers."""
    out, i = [], 2
    while i + 4 <= len(cs):
        m = struct.unpack(">H", cs[i: i + 2])[0]
        if m == 0xFFD9:
            break
        n = struct.unpack(">H", cs[i + 2: i + 4])[0]
        out.append((m, cs[i + 4: i + 2 + n]))
        if m == 0xFF90:                   # skip the tile-part's data
            psot = struct.unpack(">I", cs[i + 6: i + 10])[0]
            j = i + 2 + n
            while struct.unpack(">H", cs[j: j + 2])[0] != 0xFF93:
                m2, n2 = struct.unpack(">HH", cs[j: j + 4])
                out.append((m2, cs[j + 4: j + 2 + n2]))
                j += 2 + n2
            i += psot
        else:
            i += 2 + n
    return out


def with_packed_headers(data, where):
    """A raw codestream written with SOP and EPH markers, its packet
    headers moved into PPT segments of each tile-part header (`where`
    "ppt") or into PPM segments of the main header ("ppm"); the bodies
    stay, each after its SOP. Neither marker byte pair can occur inside a
    packet header or body, so they delimit the packets."""
    i = data.index(b"\xff\x90")
    main, tparts = data[:i], []
    while data[i: i + 2] == b"\xff\x90":
        psot = struct.unpack(">I", data[i + 6: i + 10])[0]
        end = i + psot if psot else len(data) - 2
        j = i + 12
        while data[j: j + 2] != b"\xff\x93":
            j += 2 + struct.unpack(">H", data[j + 2: j + 4])[0]
        body, headers, bodies = data[j + 2: end], [], []
        starts = [k for k in range(len(body) - 1)
                  if body[k: k + 2] == b"\xff\x91"]
        for n, k in enumerate(starts):
            pkt = body[k: starts[n + 1] if n + 1 < len(starts) else None]
            cut = pkt.index(b"\xff\x92") + 2
            headers.append(pkt[6: cut])
            bodies.append(pkt[:6] + pkt[cut:])
        tparts.append((data[i: i + 12], data[i + 12: j], b"".join(headers),
                       b"".join(bodies)))
        i = end

    def segments(marker, blob):
        return b"".join(
            marker + struct.pack(">HB", 3 + len(blob[k: k + 60000]), n)
            + blob[k: k + 60000]
            for n, k in enumerate(range(0, len(blob), 60000)))
    out = bytearray(main)
    if where == "ppm":
        out += segments(b"\xff\x60", b"".join(
            struct.pack(">I", len(h)) + h for _, _, h, _ in tparts))
    for sot, markers, headers, bodies in tparts:
        extra = segments(b"\xff\x61", headers) if where == "ppt" else b""
        psot = 12 + len(markers) + len(extra) + 2 + len(bodies)
        out += sot[:6] + struct.pack(">I", psot) + sot[10:]
        out += markers + extra + b"\xff\x93" + bodies
    return bytes(out + data[i:])


def opj_kinds():
    """name -> (encode kwargs with "comps", the component count, a check
    of the file's codestream marker segments and bytes, the word of the
    ValueError or None)."""
    def style(bits):
        return lambda segs, data: any(m == 0xFF52 and b[8] == bits
                                      for m, b in segs)

    def has(marker):
        return lambda segs, data: any(m == marker for m, _ in segs)

    def scod(bits):
        return lambda segs, data: any(m == 0xFF52 and b[0] & bits == bits
                                      for m, b in segs)

    def parts(segs, data):
        tiles = [struct.unpack(">HIBB", b[:8]) for m, b in segs
                 if m == 0xFF90]
        return len(tiles) > len({t[0] for t in tiles}) and \
            sorted(t[2] for t in tiles if t[0] == 0)[-1] > 0

    def sub(pairs, enumcs=None):
        def check(segs, data):
            siz = next(b for m, b in segs if m == 0xFF51)
            got = [(siz[37 + 3 * c], siz[38 + 3 * c])
                   for c in range(len(pairs))]
            return got == list(pairs) and (enumcs is None or struct.pack(
                ">BBBI", 1, 0, 0, enumcs) in data)
        return check
    kinds = {}
    for name, bits in (("bypass", 1), ("reset", 2), ("termall", 4),
                       ("vsc", 8), ("pterm", 16), ("segsym", 32)):
        kinds[name] = (dict(mode=bits), style(bits), None)
        kinds[name + "-97"] = (dict(mode=bits, irreversible=True,
                                    layers=(20, 6)), style(bits), None)
    kinds["all-styles"] = (dict(mode=63), style(63), None)
    kinds["all-styles-97"] = (dict(mode=63, irreversible=True,
                                   layers=(30, 12, 4)), style(63), None)
    kinds["sop"] = (dict(csty=2, layers=(20, 5)), scod(2), None)
    kinds["eph"] = (dict(csty=4, irreversible=True, layers=(20, 5)),
                    scod(4), None)
    kinds["sop-eph"] = (dict(csty=6, mode=1, layers=(16, 0)), scod(6),
                        None)
    kinds["rgn"] = (dict(roi=(0, 4)), has(0xFF5E), None)
    kinds["rgn-97"] = (dict(roi=(0, 6), irreversible=True, layers=(10,)),
                       has(0xFF5E), None)
    kinds["poc"] = (dict(pocs=[(0, 0, 2, 3, 1, 1), (0, 0, 2, 6, 1, 0)],
                         layers=(30, 10)), has(0xFF5F), None)
    kinds["tile-parts-r"] = (dict(tile_parts="R", irreversible=True),
                             parts, None)
    kinds["tile-parts-l"] = (dict(tile_parts="L", layers=(40, 20, 10)),
                             parts, None)
    # sub-sampling: a raw codestream whose component 0 is whole and 1 or 2
    # sub-sampled reads as sYCC in PIL, the others as sRGB
    s420, s422 = [(1, 1), (2, 2), (2, 2)], [(1, 1), (2, 1), (2, 1)]
    for name, pairs, extra in (
            ("subsampled-420", s420, {}),
            ("subsampled-422", s422, dict(irreversible=True, layers=(8,))),
            ("subsampled-c0", [(2, 2), (1, 1), (1, 1)], {}),
            ("subsampled-rgba", s420 + [(1, 1)], dict(comps=4)),
            ("subsampled-srgb", s420, dict(jp2=True)),
            ("sycc", [(1, 1)] * 3, dict(jp2=True, colour=_SYCC)),
            ("sycc-420-97", s420, dict(jp2=True, colour=_SYCC,
                                       irreversible=True, layers=(10,)))):
        kw = dict(dict(comps=3), sub=pairs, **extra)
        kinds[name] = (kw, sub(pairs, 18 if "sycc" in name else
                               16 if extra.get("jp2") else None), None)
    # packed packet headers, moved out of SOP + EPH files
    kinds["ppt"] = (dict(csty=6, layers=(20, 5), packed="ppt"),
                    has(0xFF61), None)
    kinds["ppm"] = (dict(csty=6, irreversible=True, layers=(12,),
                         tile=(32, 32), tile_parts="R", packed="ppm"),
                    has(0xFF60), None)
    kinds["subsampled-gray"] = (dict(sub=[(2, 2)]), sub([(2, 2)]),
                                "component sub-sampling in mode L")
    kinds["5-components"] = (dict(comps=5), lambda segs, data: True,
                             "5 components")
    return kinds


def write_opj_kinds(files, manifest, out):
    import test_torch_image_formats as cases
    for i, (name, (kw, check, raises)) in enumerate(sorted(
            opj_kinds().items())):
        kw = dict(kw)
        c = kw.pop("comps", 1)
        packed = kw.pop("packed", None)
        px = cases.texture(61, 97, c, 140 + i)
        px = px[:33, :47] if c > 1 else px
        path = files / ("jp2-opj-%s.%s" % (name, "jp2" if kw.get("jp2")
                                           else "j2k"))
        opj_encode(path, px, **kw)
        data = path.read_bytes()
        if packed:
            source = pil_entry(path)
            data = with_packed_headers(data, packed)
            path.write_bytes(data)
            if pil_entry(path) != source:
                raise RuntimeError("%s: PIL reads the packed headers to "
                                   "other pixels" % path)
        segs = marker_segments(data[data.index(b"\xff\x4f\xff\x51"):])
        if not check(segs, data):
            raise RuntimeError("%s: the markers %s do not show the kind"
                               % (path, [hex(m) for m, _ in segs]))
        rel = str(path.relative_to(out))
        manifest[rel] = {"raises": raises} if raises else pil_entry(path)


# ---------------------------------------------------------- libjpeg-turbo

# A writer of the JPEG kinds PIL's encoder does not write (lossless,
# arithmetic, 12-bit, DAC conditioning, restart intervals in rows), built
# at run time against the system's jpeglib.h (libjpeg-turbo 2.1, the v62
# ABI) and linked to the libjpeg-turbo 3.1 that PIL bundles, which also
# exports jpeg_enable_lossless and jpeg12_write_scanlines.
#   jpegw OUT W H COMPONENTS RAW [option ...]
JPEGW_C = r"""
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <jpeglib.h>

extern void jpeg_enable_lossless(j_compress_ptr, int, int);
extern JDIMENSION jpeg12_write_scanlines(j_compress_ptr, void **, JDIMENSION);

int main(int argc, char **argv) {
  if (argc < 6) return 2;
  int w = atoi(argv[2]), h = atoi(argv[3]), nc = atoi(argv[4]), prec = 8;
  for (int i = 6; i < argc; i++)
    if (!strncmp(argv[i], "prec=", 5)) prec = atoi(argv[i] + 5);
  size_t bps = prec > 8 ? 2 : 1, n = (size_t)w * h * nc * bps;
  unsigned char *px = malloc(n);
  FILE *f = fopen(argv[5], "rb");
  if (!f || fread(px, 1, n, f) != n) return 3;
  fclose(f);
  struct jpeg_compress_struct c;
  struct jpeg_error_mgr e;
  c.err = jpeg_std_error(&e);
  jpeg_create_compress(&c);
  FILE *o = fopen(argv[1], "wb");
  jpeg_stdio_dest(&c, o);
  c.image_width = w;
  c.image_height = h;
  c.input_components = nc;
  c.in_color_space = nc == 1 ? JCS_GRAYSCALE : nc == 3 ? JCS_RGB : JCS_CMYK;
  c.data_precision = prec;
  jpeg_set_defaults(&c);
  c.data_precision = prec;
  int app = 0;
  for (int i = 6; i < argc; i++) {
    char *a = argv[i];
    int v[6] = {1, 1, 1, 1, 1, 1};
    if (!strncmp(a, "q=", 2)) jpeg_set_quality(&c, atoi(a + 2), TRUE);
    else if (!strcmp(a, "arith")) c.arith_code = TRUE;
    else if (!strcmp(a, "prog")) jpeg_simple_progression(&c);
    else if (!strncmp(a, "lossless=", 9)) {
      sscanf(a + 9, "%d,%d", v, v + 1);
      jpeg_enable_lossless(&c, v[0], v[1]);
    } else if (!strncmp(a, "restart=", 8)) c.restart_interval = atoi(a + 8);
    else if (!strncmp(a, "rows=", 5)) c.restart_in_rows = atoi(a + 5);
    else if (!strncmp(a, "samp=", 5)) {
      sscanf(a + 5, "%d,%d,%d,%d,%d,%d", v, v + 1, v + 2, v + 3, v + 4, v + 5);
      for (int k = 0; k < c.num_components && k < 3; k++) {
        c.comp_info[k].h_samp_factor = v[2 * k];
        c.comp_info[k].v_samp_factor = v[2 * k + 1];
      }
    } else if (!strncmp(a, "dc=", 3)) {
      sscanf(a + 3, "%d,%d", v, v + 1);
      for (int k = 0; k < 16; k++) { c.arith_dc_L[k] = v[0]; c.arith_dc_U[k] = v[1]; }
    } else if (!strncmp(a, "ack=", 4)) {
      for (int k = 0; k < 16; k++) c.arith_ac_K[k] = atoi(a + 4);
    } else if (!strncmp(a, "app=", 4)) app = atoi(a + 4);
    else if (strncmp(a, "prec=", 5)) { fprintf(stderr, "bad option %s\n", a); return 2; }
  }
  jpeg_start_compress(&c, TRUE);
  for (; app > 0; app -= 65533) {   /* APP9 segments of filler bytes */
    int k, m = app > 65533 ? 65533 : app;
    unsigned char *buf = malloc(m);
    for (k = 0; k < m; k++) buf[k] = (unsigned char)(k * 7);
    jpeg_write_marker(&c, JPEG_APP0 + 9, buf, m);
    free(buf);
  }
  size_t stride = (size_t)w * nc * bps;
  while (c.next_scanline < c.image_height) {
    void *row = px + c.next_scanline * stride;
    if (prec > 8) jpeg12_write_scanlines(&c, &row, 1);
    else jpeg_write_scanlines(&c, (JSAMPARRAY)&row, 1);
  }
  jpeg_finish_compress(&c);
  fclose(o);
  jpeg_destroy_compress(&c);
  return 0;
}
"""


class LibJpeg:
    """`jpegw` built in a temporary directory; `write(path, px, *opts)`."""

    def __init__(self, tmp):
        import subprocess

        import PIL
        libs = os.path.join(os.path.dirname(PIL.__file__), "..",
                            "pillow.libs")
        found = glob.glob(os.path.join(libs, "libjpeg-*.so*"))
        if not found:
            raise RuntimeError("no libjpeg beside PIL in %s" % libs)
        self.tmp = Path(tmp)
        src = self.tmp / "jpegw.c"
        src.write_text(JPEGW_C)
        self.exe = self.tmp / "jpegw"
        subprocess.run(["gcc", "-O1", "-o", str(self.exe), str(src),
                        os.path.realpath(found[0]), "-Wl,-rpath,"
                        + os.path.realpath(libs)], check=True)

    def write(self, path, px, *opts, prec=8):
        import subprocess
        px = np.asarray(px)
        h, w = px.shape[:2]
        nc = 1 if px.ndim == 2 else px.shape[2]
        raw = self.tmp / "px.raw"
        (px.astype("<u2") if prec > 8 else px.astype(np.uint8)).tofile(raw)
        subprocess.run([str(self.exe), str(path), str(w), str(h), str(nc),
                        str(raw)] + list(opts) + ["prec=%d" % prec],
                       check=True)
        return Path(path).read_bytes()


def without_segment(data, marker):
    """`data` without its first marker segment `marker` (0xE0-0xFE)."""
    i = data.index(bytes((0xFF, marker)))
    (n,) = struct.unpack(">H", data[i + 2: i + 4])
    return data[:i] + data[i + 2 + n:]


def with_adobe_transform(data, transform):
    i = data.index(b"\xff\xee") + 4
    assert data[i: i + 5] == b"Adobe"
    return data[: i + 11] + bytes((transform,)) + data[i + 12:]


_JFIF = b"\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"


def libjpeg_kinds():
    """[(name, pixels, writer options, post-processing of the bytes or
    None, the word of the ValueError where both PIL and the port refuse
    the file, the sample precision)]: the genuine files of more/."""
    import test_torch_image_formats as cases
    t = cases.texture
    kinds = []

    def kind(name, px, *opts, post=None, raises=None, prec=8):
        kinds.append((name, px, opts, post, raises, prec))
    for p in range(1, 8):
        kind("lossless-gray-p%d" % p, t(61, 83, 1, 70 + p),
             "lossless=%d,0" % p)
        kind("lossless-rgb-p%d" % p, t(47, 61, 3, 80 + p),
             "lossless=%d,%d" % (p, p % 3))
    for p, pt in ((1, 2), (4, 5), (7, 7)):
        kind("lossless-gray-p%d-pt%d" % (p, pt), t(61, 83, 1, 90 + p),
             "lossless=%d,%d" % (p, pt))
    kind("lossless-gray-restart", t(61, 83, 1, 100), "lossless=5,0",
         "restart=166")
    kind("lossless-rgb-restart-rows", t(47, 61, 3, 101), "lossless=6,1",
         "rows=3")
    kind("lossless-cmyk", t(30, 41, 4, 102), "lossless=3,0")
    kind("lossless-1x1", t(1, 1, 1, 103), "lossless=1,0")
    kind("lossless-rgb-2x3", t(2, 3, 3, 104), "lossless=7,0")
    # without JFIF or Adobe marker libjpeg-turbo 3 takes a lossless file
    # for RGB; with JFIF (YCbCr) or Adobe transform 2 (YCCK) it would
    # have to convert colour, which it does not do in lossless mode
    kind("lossless-rgb-no-marker", t(47, 61, 3, 105), "lossless=4,0",
         post=lambda d: without_segment(d, 0xEE))
    kind("lossless-jfif", t(47, 61, 3, 106), "lossless=2,0",
         post=lambda d: d[:2] + _JFIF + without_segment(d, 0xEE)[2:],
         raises="lossless YCbCr")
    kind("lossless-ycck", t(30, 41, 4, 107), "lossless=3,0",
         post=lambda d: with_adobe_transform(d, 2), raises="lossless YCCK")
    # no writer makes lossless arithmetic coding (SOF11): one byte patched
    kind("lossless-arithmetic", t(37, 45, 1, 108), "lossless=1,0",
         post=lambda d: d.replace(b"\xff\xc3", b"\xff\xcb", 1),
         raises="SOF11")
    kind("lossless-6-bit", t(37, 45, 1, 109) >> 2, "lossless=1,0", prec=6,
         raises="6-bit precision")
    kind("12-bit", t(37, 45, 1, 110).astype(np.uint16) * 16, prec=12,
         raises="12-bit")
    # arithmetic coding
    for q in (50, 90):
        kind("arith-gray-q%d" % q, t(61, 83, 1, 111 + q), "arith",
             "q=%d" % q)
    for name, samp in (("420", "2,2"), ("422", "2,1"), ("440", "1,2"),
                       ("444", "1,1")):
        kind("arith-" + name, t(47, 61, 3, 120 + len(kinds)), "arith",
             "samp=%s,1,1,1,1" % samp)
        kind("arith-prog-" + name, t(47, 61, 3, 130 + len(kinds)), "arith",
             "prog", "samp=%s,1,1,1,1" % samp)
    kind("arith-restart", t(47, 61, 3, 140), "arith", "restart=3")
    kind("arith-restart-rows", t(47, 61, 1, 141), "arith", "rows=1")
    kind("arith-prog-restart", t(61, 47, 3, 142), "arith", "prog",
         "restart=5")
    for L, U, K in ((2, 5, 20), (0, 0, 1), (5, 15, 63), (1, 3, 0)):
        kind("arith-dac-%d-%d-%d" % (L, U, K), t(47, 61, 3, 150 + K),
             "arith", "q=90", "dc=%d,%d" % (L, U), "ack=%d" % K)
    kind("arith-prog-dac", t(47, 61, 3, 160), "arith", "prog", "q=90",
         "dc=1,3", "ack=0")
    kind("arith-cmyk", t(30, 41, 4, 161), "arith")
    kind("arith-prog-cmyk", t(30, 41, 4, 162), "arith", "prog")
    kind("arith-1x1", t(1, 1, 3, 163), "arith")
    kind("arith-prog-17x23", t(17, 23, 3, 164), "arith", "prog")
    # unrefined coefficients: block smoothing, as for Huffman files
    for scans in (1, 2, 3, 5):
        kind("arith-prog-smooth-%d" % scans, t(61, 47, 3, 11), "arith",
             "prog", "q=70", post=lambda d, s=scans: truncated(d, s))
    return kinds


def truncated(data, scans):
    """`data` cut after its first `scans` scans, EOI appended."""
    import test_torch_image_formats as cases
    sos = [s for s in cases.segments(data) if s[0] == 0xDA]
    return data[: sos[scans - 1][2]] + b"\xff\xd9"


def block_kinds(w):
    """Arithmetic-coded files on both sides of PIL's 65536-byte read
    block, sized by an APP9 segment: a file of 65536 bytes (its scan ends
    in the block) and one of 65537, sequential and progressive; a header
    that ends past 65536 with its scan inside the next block (PIL reads
    it), and a scan that starts in the first block and ends in the next
    (PIL refuses it)."""
    import test_torch_image_formats as cases
    t = cases.texture
    out = []
    for name, px, opts in (("arith", t(60, 100, 1, 170), ("arith", "q=92")),
                           ("arith-prog", t(60, 100, 3, 171),
                            ("arith", "prog", "q=92"))):
        base = len(w.write(w.tmp / "base.jpg", px, *opts))
        for what, size in (("fits", 65536), ("past", 65537)):
            app = size - base - 4
            out.append(("%s-block-%s" % (name, what), px,
                        opts + ("app=%d" % app,), size,
                        "PIL cannot read it" if what == "past" else None))
    px = t(120, 200, 1, 172)
    out.append(("arith-sos-past-block", px, ("arith", "q=92", "app=66000"),
                None, None))
    out.append(("arith-sos-block-past", px, ("arith", "q=92", "app=60000"),
                None, "PIL cannot read it"))
    return out


def pil_refuses(path):
    import PIL.Image
    try:
        with PIL.Image.open(path) as im:
            im.convert("L")
    except Exception:
        return True
    return False


def write_more(out, manifest):
    """more/: the genuine libjpeg-turbo files, and the TIFF and BMP cases
    of tests/test_torch_image_formats_more.py (those PIL reads and those
    both refuse); their manifest entries."""
    import test_torch_image_formats_more as more_cases
    more = out / "more"
    if more.exists():
        shutil.rmtree(more)
    more.mkdir(parents=True)

    def entry(path, raises):
        rel = str(path.relative_to(out))
        if raises:
            if not pil_refuses(path):
                raise RuntimeError("%s: PIL reads it" % rel)
            manifest[rel] = {"raises": raises}
        else:
            manifest[rel] = pil_entry(path)
    with tempfile.TemporaryDirectory() as tmp:
        w = LibJpeg(tmp)
        for name, px, opts, post, raises, prec in libjpeg_kinds():
            path = more / ("jpeg-%s.jpg" % name)
            data = w.write(path, px, *opts, prec=prec)
            if post:
                path.write_bytes(post(data))
            entry(path, raises)
        for name, px, opts, size, raises in block_kinds(w):
            path = more / ("jpeg-%s.jpg" % name)
            data = w.write(path, px, *opts)
            if size is not None and len(data) != size:
                raise RuntimeError("%s: %d bytes, not %d" % (
                    path.name, len(data), size))
            entry(path, raises)
    for name, (suffix, make) in sorted(more_cases.CASES.items()):
        path = more / ("%s.%s" % (name, suffix))
        path.write_bytes(make())
        entry(path, None)
    for name, (suffix, make, word) in sorted(more_cases.REFUSED.items()):
        path = more / ("%s.%s" % (name, suffix))
        path.write_bytes(make())
        entry(path, word)


def write_tiff_kinds(out, manifest):
    """tiff/: the cases of tests/test_torch_image_formats_tiff.py (those
    PIL reads, those both refuse, those PIL misreads and the port
    refuses), and the two old-style JPEG pages; their manifest
    entries."""
    import PIL.Image
    import test_torch_image_formats_tiff as tiff_cases
    folder = out / "tiff"
    if folder.exists():
        shutil.rmtree(folder)
    folder.mkdir(parents=True)
    for name in [k for k in manifest if k.startswith("tiff/") or
                 k.endswith(".ojpeg.tif")]:
        del manifest[name]
    groups = ((tiff_cases.CASES, False), (tiff_cases.REFUSED, True),
              (tiff_cases.MISREAD, False))
    for cases, pil_fails in groups:
        for name, (suffix, make, *word) in sorted(cases.items()):
            path = folder / ("%s.%s" % (name.replace(" ", "-"), suffix))
            path.write_bytes(make())
            rel = str(path.relative_to(out))
            if pil_refuses(path) != pil_fails:
                raise RuntimeError("%s: PIL %s it" % (
                    rel, "reads" if pil_fails else "refuses"))
            manifest[rel] = {"raises": word[0]} if word else pil_entry(path)
    for stem, make in ((STEMS[0], tiff_cases.ojpeg_interchange),
                       (STEMS[1], tiff_cases.ojpeg_tables)):
        page = np.asarray(PIL.Image.open(PAGES / (stem + ".png")).convert(
            "RGB"))
        path = out / "pages" / (stem + ".ojpeg.tif")
        path.write_bytes(make(page, 64, quality=PAGE_Q))
        manifest[str(path.relative_to(out))] = pil_entry(path)


def lossless_pages(pages):
    """The two pages as lossless JPEG: synth0000 through predictor 1,
    synth0001 through predictor 6 with a restart every 32 rows (the
    interval, 32 x 1312 MCUs, must stay below 65536)."""
    import PIL.Image
    with tempfile.TemporaryDirectory() as tmp:
        w = LibJpeg(tmp)
        for stem, opts in ((STEMS[0], ("lossless=1,0",)),
                           (STEMS[1], ("lossless=6,0", "rows=32"))):
            px = np.asarray(PIL.Image.open(PAGES / (stem + ".png")).convert(
                "L"))
            w.write(pages / (stem + ".lossless.jpg"), px, *opts)


def write_files(out):
    """The small cases, the unsupported kinds and the pages; the
    manifest. -> manifest."""
    import PIL.Image
    import test_torch_image_formats as cases
    import test_torch_jpeg2000 as jp2
    files = out / "files"
    pages = out / "pages"
    for d in (files, pages):
        if d.exists():
            shutil.rmtree(d)
        d.mkdir(parents=True)
    manifest = {}
    write_more(out, manifest)
    for name, (suffix, make) in sorted({**cases.CASES,
                                        **jp2.CASES}.items()):
        path = files / ("%s.%s" % (name, suffix))
        path.write_bytes(make())
        manifest[str(path.relative_to(out))] = pil_entry(path)
    write_tiff_kinds(out, manifest)
    for name, (suffix, make, word) in sorted(cases.UNSUPPORTED.items()):
        path = files / ("%s.%s" % (name.replace(" ", "-"), suffix))
        path.write_bytes(make())
        manifest[str(path.relative_to(out))] = {"raises": word}
    for name, (make, word) in sorted(jp2.UNSUPPORTED.items()):
        path = files / ("jp2-%s.jp2" % name.replace(" ", "-"))
        path.write_bytes(make())
        manifest[str(path.relative_to(out))] = {"raises": word}
    write_opj_kinds(files, manifest, out)
    for stem in STEMS:
        page = PIL.Image.open(PAGES / (stem + ".png")).convert("L")
        page.save(pages / (stem + ".jpg"), "JPEG", quality=PAGE_Q)
    page = PIL.Image.open(PAGES / (STEMS[0] + ".png")).convert("L")
    page.save(pages / (STEMS[0] + ".progressive.jpg"), "JPEG",
              quality=PAGE_Q, progressive=True)
    page = np.asarray(PIL.Image.open(PAGES / (STEMS[1] + ".png")))
    PIL.Image.fromarray(page > 128).save(pages / (STEMS[1] + ".g4.tif"),
                                         "TIFF", compression="group4")
    (pages / (STEMS[1] + ".jpeg.tif")).write_bytes(cases.jpeg_tiff(
        page, 1, TIFF_Q, rows_per_strip=64))
    PIL.Image.open(PAGES / (STEMS[0] + ".png")).convert("L").save(
        pages / (STEMS[0] + ".jp2"), "JPEG2000", irreversible=True,
        progression="RPCL", num_resolutions=6, precinct_size=(256, 256),
        codeblock_size=(64, 64), quality_mode="rates",
        quality_layers=[80, 40, JP2_RATE])
    PIL.Image.fromarray(page).save(
        pages / (STEMS[1] + ".jp2"), "JPEG2000", irreversible=True,
        tile_size=(512, 512), quality_mode="rates",
        quality_layers=[JP2_RATE])
    lossless_pages(pages)
    for path in sorted(pages.iterdir()):
        manifest[str(path.relative_to(out))] = pil_entry(path)
    write_manifest(out, manifest)
    return manifest


def write_manifest(out, manifest):
    (out / "manifest.json").write_text(json.dumps(manifest, indent=1,
                                                  sort_keys=True))


def update_tiff_kinds(out):
    """tiff/ and the old-style JPEG pages into the existing manifest; the
    file of the old-style JPEG YCbCr case that the port refused before it
    read that kind goes."""
    manifest = json.loads((out / "manifest.json").read_text())
    moved = "files/old-style-JPEG-YCbCr-TIFF.tif"
    manifest.pop(moved, None)
    if (out / moved).exists():
        (out / moved).unlink()
    write_tiff_kinds(out, manifest)
    write_manifest(out, manifest)
    return manifest




def run_chain(out, suffix, folder, keep):
    """The JAX chain on the two pages of `suffix`; keeps `keep` of each
    page's artifacts in `folder`."""
    from make_torch_ocr_fixture import run_to_order
    from origami_tpu.batch.detect.compose import ComposeProcessor
    from origami_tpu.batch.detect.ocr import OCRProcessor
    opts = dict(lock_strategy="NONE", plain=True)
    chain = out / folder
    if chain.exists():
        shutil.rmtree(chain)
    with tempfile.TemporaryDirectory() as tmp:
        corpus = Path(tmp) / "corpus"
        corpus.mkdir()
        for stem in STEMS:
            shutil.copy(out / "pages" / (stem + suffix), corpus)
        run_to_order(corpus, ROOT / "models_pretrained" / "students")
        OCRProcessor(dict(opts, model=str(
            ROOT / "models_pretrained" / "recognizer"))).traverse(str(corpus))
        ComposeProcessor(dict(opts)).traverse(str(corpus))
        for stem in STEMS:
            out_dir = Path(stem + suffix).stem + ".out"   # the page's stem
            src = corpus / out_dir
            rt = json.loads((src / "runtime.json").read_text())
            for stage, entry in sorted(rt.items()):
                if entry.get("status") != "COMPLETED":
                    raise RuntimeError("%s %s: %s" % (stem, stage, entry))
            (chain / out_dir).mkdir(parents=True)
            for name in keep:
                shutil.copy(src / name, chain / out_dir)
            print(stem + suffix, "stages", sorted(rt))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="files,chain")
    args = ap.parse_args()
    only = set(args.only.split(","))
    OUT.mkdir(parents=True, exist_ok=True)
    if "files" in only:
        manifest = write_files(OUT)
        print("%d files" % len(manifest))
    elif "tiff" in only:
        manifest = update_tiff_kinds(OUT)
        print("%d files" % len(manifest))
    if "chain" in only:
        run_chain(OUT, ".jpg", "chain", CHAIN_KEEP)
        run_chain(OUT, ".jp2", "chain_jp2", ("compose.zip",))
    if "chain" in only or "chain_ojpeg" in only:
        run_chain(OUT, ".ojpeg.tif", "chain_ojpeg", ("compose.zip",))
    total = sum(p.stat().st_size for p in OUT.rglob("*") if p.is_file())
    print("tests/data/torch_formats: %d bytes" % total)


if __name__ == "__main__":
    main()
