"""Build the page-format fixture that the PyTorch port's image readers are
held against (chip_smoke.py phases 21 and 22), with PIL and the JAX
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
    tests/data/torch_formats/pages/synth000{0,1}.jpg   the two pages of
        tests/data/torch_ocr/full as baseline gray JPEG (quality PAGE_Q),
        synth0000.progressive.jpg, synth0001.g4.tif (the page > 128),
        synth0000.jp2 (an archive profile: 9/7, RPCL, 6 resolutions,
        256 x 256 precincts, 64 x 64 code-blocks, 3 layers at rates
        80/40/JP2_RATE), synth0001.jp2 (9/7 in 512 x 512 tiles at rate
        JP2_RATE), synth0001.jpeg.tif (JPEG-in-TIFF at quality TIFF_Q,
        strips of 64 rows)
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

    JAX_PLATFORMS=cpu python scripts/make_torch_formats_fixture.py [--only files,chain]

`files` takes seconds, `chain` several minutes.
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
    for name, (suffix, make) in sorted({**cases.CASES,
                                        **jp2.CASES}.items()):
        path = files / ("%s.%s" % (name, suffix))
        path.write_bytes(make())
        manifest[str(path.relative_to(out))] = pil_entry(path)
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
    for path in sorted(pages.iterdir()):
        manifest[str(path.relative_to(out))] = pil_entry(path)
    (out / "manifest.json").write_text(json.dumps(manifest, indent=1,
                                                  sort_keys=True))
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
            src = corpus / (stem + ".out")
            rt = json.loads((src / "runtime.json").read_text())
            for stage, entry in sorted(rt.items()):
                if entry.get("status") != "COMPLETED":
                    raise RuntimeError("%s %s: %s" % (stem, stage, entry))
            (chain / (stem + ".out")).mkdir(parents=True)
            for name in keep:
                shutil.copy(src / name, chain / (stem + ".out"))
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
    if "chain" in only:
        run_chain(OUT, ".jpg", "chain", CHAIN_KEEP)
        run_chain(OUT, ".jp2", "chain_jp2", ("compose.zip",))
    total = sum(p.stat().st_size for p in OUT.rglob("*") if p.is_file())
    print("tests/data/torch_formats: %d bytes" % total)


if __name__ == "__main__":
    main()
