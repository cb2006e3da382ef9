"""The port's JPEG 2000 reader (core/_jp2.py over core/jp2.cpp) against
PIL, which reads pages for the JAX package through OpenJPEG 2.5.

Every case is seeded and small (1x1 to 97x61), written by PIL with each of
Pillow 12's writer options, and the port must give PIL's `convert("L")`
and `convert("RGB")` pixels on every pixel and PIL's `.size`. Tolerance:
none, for the 9/7 wavelet too (the port repeats OpenJPEG's float32
operations in their order). The kinds PIL's writer cannot make (code-block
styles, SOP/EPH markers, ROI shifts, progression order changes,
tile-parts, sub-sampled components, sYCC, PPM/PPT) are the files
tests/data/torch_formats/files/jp2-opj-*, which
scripts/make_torch_formats_fixture.py writes through the libopenjp2 that
PIL bundles; the palette and sYCC files are built here from PIL's.
"""

import json
import struct
import zipfile
from pathlib import Path

import numpy as np
import PIL.Image
import pytest

from origami_tpu.core.page import Page as JaxPage
from origami_tpu_torch.batch.detect import segment as stage
from origami_tpu_torch.core import _image, _png
from origami_tpu_torch.core.page import Page
from test_torch_image_formats import pil_bytes, texture

ROOT = Path(__file__).resolve().parent.parent
FULL = ROOT / "tests/data/torch_ocr/full"
FORMATS = ROOT / "tests/data/torch_formats"
PROGRESSIONS = ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL")


def jp2_bytes(px, mode=None, **kw):
    return pil_bytes(px, "JPEG2000", mode, **kw)


def box(kind, body):
    return struct.pack(">I", 8 + len(body)) + kind + body


def palette_jp2(idx, palette):
    """A JP2 of one index component with a `pclr` box of `palette` ((N, 3)
    uint8) and its `cmap`, around PIL's lossless codestream of `idx`."""
    h, w = idx.shape
    cs = jp2_bytes(idx, no_jp2=True)
    header = (box(b"ihdr", struct.pack(">IIHBBBB", h, w, 1, 7, 7, 0, 0))
              + box(b"colr", struct.pack(">BBBI", 1, 0, 0, 16))
              + box(b"pclr", struct.pack(">HB", len(palette), 3)
                    + bytes((7, 7, 7)) + palette.tobytes())
              + box(b"cmap", b"".join(struct.pack(">HBB", 0, 1, i)
                                      for i in range(3))))
    return (b"\x00\x00\x00\x0cjP  \r\n\x87\n"
            + box(b"ftyp", b"jp2 \x00\x00\x00\x00jp2 ")
            + box(b"jp2h", header) + box(b"jp2c", cs))


def palette_case():
    rng = np.random.default_rng(130)
    palette = rng.integers(0, 256, (40, 3)).astype(np.uint8)
    palette[7] = palette[20] = palette[3]     # PIL's palette skips repeats
    return palette_jp2(rng.integers(0, 40, (23, 31)).astype(np.uint8),
                       palette)


def jp2_cases():
    """name -> (suffix, bytes maker): every writer option of Pillow 12."""
    c = {}
    sizes = ((1, 1), (2, 3), (5, 7), (17, 23), (61, 97), (97, 61), (33, 40),
             (64, 64))
    for i, (h, w) in enumerate(sizes):
        for irr in (False, True):
            c["jp2-%s-%dx%d" % ("97" if irr else "53", h, w)] = (
                lambda h=h, w=w, i=i, irr=irr: jp2_bytes(
                    texture(h, w, 1, 100 + i), irreversible=irr))
    g = texture(61, 97, 1, 110)
    rgb = texture(61, 97, 3, 111)
    for n in (1, 2, 3, 4):
        for irr in (False, True):
            c["jp2-%s-levels-%d" % ("97" if irr else "53", n - 1)] = (
                lambda n=n, irr=irr: jp2_bytes(g, irreversible=irr,
                                               num_resolutions=n))
    for cb in ((4, 4), (16, 64), (64, 16), (8, 32)):
        c["jp2-codeblocks-%dx%d" % cb] = lambda cb=cb: jp2_bytes(
            g, irreversible=True, codeblock_size=cb)
    for k, prog in enumerate(PROGRESSIONS):
        c["jp2-" + prog.lower()] = lambda prog=prog, k=k: jp2_bytes(
            g, irreversible=k % 2 == 0, progression=prog,
            precinct_size=(32, 32), quality_mode="rates",
            quality_layers=[40, 20, 10])
        c["jp2-rgb-" + prog.lower()] = lambda prog=prog, k=k: jp2_bytes(
            rgb, irreversible=k % 2 == 1, progression=prog,
            precinct_size=(32, 64), codeblock_size=(16, 16),
            quality_mode="rates", quality_layers=[30, 8])
    c["jp2-quality-db"] = lambda: jp2_bytes(
        g, irreversible=True, quality_mode="dB", quality_layers=[25, 35, 45])
    c["jp2-tiles"] = lambda: jp2_bytes(g, tile_size=(16, 16))
    c["jp2-tiles-offsets"] = lambda: jp2_bytes(
        g, tile_size=(32, 16), tile_offset=(1, 2), offset=(3, 5))
    c["jp2-tiles-rgb"] = lambda: jp2_bytes(
        rgb, irreversible=True, tile_size=(32, 32), quality_mode="rates",
        quality_layers=[20])
    # an image offset needs a tile that reaches past it (OpenJPEG)
    c["jp2-offset"] = lambda: jp2_bytes(g, offset=(1, 4),
                                        tile_size=(64, 64))
    c["jp2-offset-97"] = lambda: jp2_bytes(g, irreversible=True,
                                           offset=(6, 3),
                                           tile_size=(128, 128))
    small_rgb = texture(37, 45, 3, 116)
    for mct in (0, 1):
        for irr in (False, True):
            c["jp2-rgb-%s-mct%d" % ("97" if irr else "53", mct)] = (
                lambda mct=mct, irr=irr: jp2_bytes(
                    small_rgb, irreversible=irr, mct=mct))
    c["jp2-signed"] = lambda: jp2_bytes(g, signed=True)
    c["jp2-signed-97"] = lambda: jp2_bytes(g, irreversible=True, signed=True)
    c["jp2-rgb-signed"] = lambda: jp2_bytes(small_rgb, signed=True, mct=1)
    c["jp2-comment"] = lambda: jp2_bytes(g, comment="a page of 1872")
    c["jp2-plt"] = lambda: jp2_bytes(g, irreversible=True, plt=True,
                                     quality_mode="rates",
                                     quality_layers=[30, 10])
    c["jp2-la"] = lambda: jp2_bytes(texture(37, 45, 2, 112), "LA",
                                    irreversible=True)
    c["jp2-rgba"] = lambda: jp2_bytes(texture(37, 45, 4, 113), "RGBA")
    c["jp2-i16"] = lambda: jp2_bytes(texture(37, 45, 1, 114).astype(
        np.uint16) * 3, "I;16")
    c["jp2-i16-97"] = lambda: jp2_bytes(texture(37, 45, 1, 115).astype(
        np.uint16) * 257, "I;16", irreversible=True)
    c["jp2-palette"] = palette_case
    # PIL's RGB file relabelled sYCC: PIL's own YCbCr -> RGB tables
    c["jp2-sycc"] = lambda: patch_colr(jp2_bytes(small_rgb), 18)
    # an ICC profile (not applied) or an unknown enumeration: unspecified
    c["jp2-icc"] = lambda: jp2_bytes(g).replace(b"colr\x01", b"colr\x02",
                                                1)
    c["jp2-rgb-unknown-colour"] = lambda: patch_colr(jp2_bytes(small_rgb), 99)
    # PIL's RGBA relabelled CMYK: Pillow's mode "CMYK" and its cmyk2rgb
    for irr in (False, True):
        c["jp2-cmyk" + ("-97" if irr else "")] = lambda irr=irr: patch_colr(
            jp2_bytes(texture(37, 45, 4, 117), "RGBA", irreversible=irr), 12)
    cases = {k: ("jp2", v) for k, v in c.items()}
    cases["j2k-gray"] = ("j2k", lambda: jp2_bytes(g, no_jp2=True))
    cases["j2k-rgb-97"] = ("j2k", lambda: jp2_bytes(
        rgb, no_jp2=True, irreversible=True, quality_mode="rates",
        quality_layers=[12]))
    return cases


CASES = jp2_cases()


def check_as_pil(path):
    with PIL.Image.open(path) as im:
        size = im.size
        ref = np.asarray(im.convert("L"))
        ref_rgb = np.asarray(im.convert("RGB"))
    assert _image.read_size(path) == size
    got = _image.read_gray(path)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    assert int((got != ref).sum()) == 0
    px = _image.read(path)
    if px.ndim == 3:
        np.testing.assert_array_equal(px, ref_rgb)
    else:
        np.testing.assert_array_equal(px, ref)


@pytest.mark.parametrize("name", sorted(CASES))
def test_reads_as_pil(tmp_path, name):
    suffix, make = CASES[name]
    path = tmp_path / ("page." + suffix)
    path.write_bytes(make())
    check_as_pil(path)


def sweep_case(seed):
    """A seeded lossy 9/7 file: size, levels, code-blocks, layers and
    progression drawn from `seed`."""
    rng = np.random.default_rng(seed)
    h, w = (int(v) for v in rng.integers(8, 98, 2))
    levels = int(rng.integers(1, min(6, int(np.log2(min(h, w)))) + 2))
    c = 3 if seed % 3 == 0 else 1
    kw = dict(irreversible=True, num_resolutions=levels,
              progression=PROGRESSIONS[seed % 5],
              codeblock_size=[(64, 64), (32, 32), (16, 16), (8, 64)][seed % 4],
              quality_mode="rates",
              quality_layers=sorted((float(v) for v in rng.choice(
                  [60, 30, 15, 6, 3], int(rng.integers(1, 4)), False)),
                  reverse=True))
    if c == 3:
        kw["mct"] = 1
    return jp2_bytes(texture(h, w, c, 1000 + seed), **kw)


@pytest.mark.parametrize("seed", range(24))
def test_97_sweep_reads_as_pil(tmp_path, seed):
    """OpenJPEG's float32 9/7 and ICT, bit for bit, over seeds, sizes,
    level counts and layer truncations."""
    path = tmp_path / "page.jp2"
    path.write_bytes(sweep_case(seed))
    check_as_pil(path)


def manifest():
    return json.loads((FORMATS / "manifest.json").read_text())


OPJ_FILES = sorted(k for k in manifest() if "/jp2-opj-" in k)


@pytest.mark.parametrize("rel", OPJ_FILES)
def test_opj_kinds(rel):
    """The kinds PIL's writer cannot make: PIL's pixels and the
    manifest's digest, or the ValueError that names a kind PIL does not
    read either."""
    want = manifest()[rel]
    path = FORMATS / rel
    if "raises" in want:
        with pytest.raises(ValueError, match=want["raises"]):
            _image.read_gray(path)
        return
    check_as_pil(path)


def patch_colr(data, enumcs):
    i = data.index(b"colr") + 4
    return data[: i + 3] + struct.pack(">I", enumcs) + data[i + 7:]


def patch_cod(data, offset, value):
    """The COD segment's byte at `offset` past its marker set to `value`
    (8: the multiple component transform, 12: the code-block style, 13:
    the wavelet)."""
    i = data.index(b"\xff\x52") + offset
    return data[:i] + bytes((value,)) + data[i + 1:]


def small(**kw):
    return jp2_bytes(texture(16, 16, 1, 120), **kw)


def small_rgb(**kw):
    return jp2_bytes(texture(16, 16, 3, 121), **kw)


UNSUPPORTED = {
    "e-sYCC": (lambda: patch_colr(small_rgb(), 24), "e-sYCC"),
    "CMYK of 3 components": (lambda: patch_colr(small_rgb(), 12),
                             "colour space 4"),
    "sYCC of 1 component": (lambda: patch_colr(small(), 18),
                            "colour space 3"),
    "HTJ2K": (lambda: patch_cod(small(no_jp2=True), 12, 0x40), "HTJ2K"),
    "Part 2 transform": (lambda: patch_cod(small_rgb(no_jp2=True), 8, 2),
                         "Part 2 multiple component transform"),
    "Part 2 wavelet": (lambda: patch_cod(small(no_jp2=True), 13, 2),
                       "Part 2 wavelet"),
}


@pytest.mark.parametrize("name", sorted(UNSUPPORTED))
def test_unsupported_kinds_raise(tmp_path, name):
    make, word = UNSUPPORTED[name]
    path = tmp_path / "page.jp2"
    path.write_bytes(make())
    with pytest.raises(ValueError, match=word):
        _image.read_gray(path)


def test_read_size_parses_only_the_header(tmp_path):
    """PIL's size (from ihdr, or SIZ less its offsets) from a file cut
    after its main header."""
    g = texture(61, 97, 1, 123)
    for name, data in (("a.jp2", jp2_bytes(g, offset=(3, 5),
                                           tile_size=(64, 64))),
                       ("b.j2k", jp2_bytes(g, no_jp2=True, offset=(7, 2),
                                           tile_size=(128, 128)))):
        path = tmp_path / name
        path.write_bytes(data[: data.index(b"\xff\x90") + 2])
        assert _image.read_size(path) == (97, 61)
        with pytest.raises(ValueError, match="JPEG 2000"):
            _image.read_gray(path)


def test_page_reads_jp2_as_the_jax_page(tmp_path):
    page = np.asarray(PIL.Image.open(FULL / "synth0000.png"))[:400, :300]
    path = tmp_path / "a.jp2"
    path.write_bytes(jp2_bytes(page, irreversible=True, progression="RPCL",
                               precinct_size=(128, 128),
                               quality_mode="rates",
                               quality_layers=[80, 40, 20]))
    port = Page(path, device="cpu")
    assert port.size() == JaxPage(path).size()
    np.testing.assert_array_equal(port.warped, JaxPage(path).warped)


def zip_entries(path):
    with zipfile.ZipFile(path) as zf:
        return {n: zf.read(n) for n in zf.namelist()}


def test_segment_stage_on_a_jp2_page(tmp_path, capsys):
    """The heuristic segment stage on a JP2 crop writes the segment.zip of
    a PNG that holds the same decoded pixels."""
    page = np.asarray(PIL.Image.open(FULL / "synth0001.png"))[:640, :480]
    a, b = tmp_path / "jp2", tmp_path / "png"
    a.mkdir()
    b.mkdir()
    (a / "crop.jp2").write_bytes(jp2_bytes(
        page, irreversible=True, quality_mode="rates", quality_layers=[20]))
    _png.write_gray(b / "crop.png", np.asarray(
        PIL.Image.open(a / "crop.jp2").convert("L")))
    for corpus in (a, b):
        stage.main(["-m", "heuristic", "--device", "cpu", "--lock-strategy",
                    "NONE", "--plain", str(corpus)])
        rt = json.loads((corpus / "crop.out/runtime.json").read_text())
        assert rt[stage.STAGE_NAME]["status"] == "COMPLETED", rt
    capsys.readouterr()
    assert zip_entries(a / "crop.out/segment.zip") == \
        zip_entries(b / "crop.out/segment.zip")


def test_fixture_pages_read_as_pil():
    """The fixture's JP2 pages (the archive profile and 512 x 512 tiles)."""
    for name in ("synth0000.jp2", "synth0001.jp2"):
        path = FORMATS / "pages" / name
        np.testing.assert_array_equal(
            _image.read_gray(path),
            np.asarray(PIL.Image.open(path).convert("L")))
