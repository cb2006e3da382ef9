"""The port's corpus utilities (origami_tpu_torch/batch/utils: dewarp,
thumbnail, signature, rtext, stats, reset, cleanup) and Page.dewarped
against the JAX package's, on the CPU (`--device cpu`).

The JAX modules save JPEGs through PIL; their images and files are
captured (the make_torch_inspect_fixture helpers wrap PIL's JPEG save).

Bars:
  * Page.dewarped: equal to JAX's Page.dewarped on every pixel (ROADMAP
    C3), and to the fixture's digest; utils.dewarp's dewarped.jpg and
    <stem>.dewarped.jpg byte-equal to the JAX module's files;
  * thumbnails: equal to PIL's Image.thumbnail((1024, 1024)) on every
    pixel, for the fixture page, the real scans and seeded pages that
    take Image.reduce first; resize and reduce alone equal to PIL's;
    thumbnail.jpg byte-equal to the JAX module's file, also for pages
    with a comment (JPEG, JPEG 2000, a PNG text chunk), which PIL carries
    into it, and core/_image.comment that comment;
  * signature.zip: its PNGs decode to JAX's pixels, signature.json equal;
  * rtext: the same files with the same texts;
  * stats: the same report and errors.csv; reset and cleanup: the same
    files left and the same runtime.json entries.
"""

import contextlib
import hashlib
import importlib.util
import io
import json
import os
import shutil
from pathlib import Path

import numpy as np
import PIL.Image
import pytest

import chip_smoke
from origami_tpu_torch.batch.utils import (cleanup, dewarp, reset,
                                           signature, stats, thumbnail)
from origami_tpu_torch.batch.utils import rtext as rtext_cli
from origami_tpu_torch.core import _png

ROOT = chip_smoke.ROOT
REF = json.loads((chip_smoke.INSPECT_REF / "inspect.json").read_text())
PAGE = "synth0000"
CPU = ["--device", "cpu", "--lock-strategy", "NONE", "--plain"]
OPTIONS = dict(lock_strategy="NONE", plain=True)


def _script():
    spec = importlib.util.spec_from_file_location(
        "make_torch_inspect_fixture",
        ROOT / "scripts" / "make_torch_inspect_fixture.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _corpus(dst, stems=(PAGE,)):
    corpus = chip_smoke.inspect_corpus(dst)
    for png in corpus.glob("*.png"):
        if png.stem not in stems:
            png.unlink()
            shutil.rmtree(corpus / (png.stem + ".out"))
    return corpus


def _jax(name):
    import importlib
    return importlib.import_module("origami_tpu.batch.utils." + name)


def test_page_dewarped_equals_jax():
    from origami_tpu.core.page import Page as JaxPage
    from origami_tpu_torch.core.dewarp import Grid
    from origami_tpu_torch.core.page import Page
    png = chip_smoke.FIXTURE / (PAGE + ".png")
    zip_path = chip_smoke.FIXTURE / (PAGE + ".out") / "dewarp.zip"
    page = Page(png, Grid.open(zip_path), device="cpu")
    got = page.dewarped
    assert got.dtype == np.uint8
    from origami_tpu.core.dewarp import Grid as JaxGrid
    with open(zip_path, "rb") as f:
        want = JaxPage(png, JaxGrid.open(f)).dewarped
    assert got.shape == want.shape
    assert int((got != want).sum()) == 0
    assert page.pixels(True) is got and page.pixels(False) is page.warped
    assert Page(png, device="cpu").dewarped is None
    assert chip_smoke.masked_digest(got) \
        == REF["renders"][PAGE]["dewarped.jpg"]["digest"]


def _sha(path):
    return hashlib.sha256(Path(path).read_bytes()).hexdigest()


def test_dewarp_cli_writes_the_dewarped_page(tmp_path):
    jax_corpus, corpus = _corpus(tmp_path / "j"), _corpus(tmp_path / "c")
    _jax("dewarp").DewarpImageProcessor(dict(OPTIONS)) \
        .traverse(str(jax_corpus))
    _jax("dewarp").DewarpImageProcessor(dict(
        OPTIONS, output=str(tmp_path / "jo"))).traverse(str(jax_corpus))
    dewarp.main(CPU + [str(corpus)])
    dewarp.main(CPU + ["-o", str(tmp_path / "o"), str(corpus)])
    want = _sha(jax_corpus / (PAGE + ".out") / "dewarped.jpg")
    assert want == _sha(tmp_path / "jo" / (PAGE + ".dewarped.jpg")) \
        == REF["renders"][PAGE]["dewarped.jpg"]["sha256"]
    for path in (corpus / (PAGE + ".out") / "dewarped.jpg",
                 tmp_path / "o" / (PAGE + ".dewarped.jpg")):
        assert _sha(path) == want
    assert not list(corpus.rglob("*dewarped.png"))


def test_thumbnail_cli_equals_jax(tmp_path):
    jax_corpus, corpus = _corpus(tmp_path / "j"), _corpus(tmp_path / "p")
    with _script().captured_jpegs() as saved:
        _jax("thumbnail").ThumbnailProcessor(dict(OPTIONS)) \
            .traverse(str(jax_corpus))
    want, data = saved["thumbnail.jpg"][PAGE]
    thumbnail.main(CPU + [str(corpus)])
    got = thumbnail.thumbnail(_png.read_gray(corpus / (PAGE + ".png")))
    assert got.shape == want.shape == (1024, 700)
    assert int((got != want).sum()) == 0
    assert chip_smoke.digest(want) == REF["thumbnail"][PAGE]["digest"]
    path = corpus / (PAGE + ".out") / "thumbnail.jpg"
    assert path.read_bytes() == data
    assert _sha(path) == REF["thumbnail"][PAGE]["sha256"]


def _png_chunk(kind, body):
    import struct
    import zlib
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def commented_png(px, before=(), after=()):
    """PIL's PNG of `px` with the chunks `before` IDAT and `after` it."""
    buf = io.BytesIO()
    PIL.Image.fromarray(px).save(buf, "PNG")
    d = buf.getvalue()
    i, j = d.index(b"IDAT") - 4, d.index(b"IEND") - 4
    return d[:i] + b"".join(before) + d[i:j] + b"".join(after) + d[j:]


def commented_page(path, px, kind):
    """`px` written as a page of `kind` that carries a comment."""
    import zlib
    if kind == "jpg":
        PIL.Image.fromarray(px).save(path, "JPEG", quality=90,
                                     comment=b"a scan of 1872")
    elif kind == "jp2":
        PIL.Image.fromarray(px).save(path, "JPEG2000")
    elif kind == "png-text":
        path.write_bytes(commented_png(px, [_png_chunk(
            b"tEXt", b"comment\0Gr\xfc\xdfe aus 1872")]))
    elif kind == "png-late":
        # the last of a tEXt, a zTXt and an iTXt (compressed, after IDAT)
        path.write_bytes(commented_png(
            px, [_png_chunk(b"tEXt", b"comment\0early"),
                 _png_chunk(b"zTXt", b"comment\0\0" + zlib.compress(b"z"))],
            [_png_chunk(b"iTXt", b"comment\0\1\0de\0\0" + zlib.compress(
                "naïve – spät".encode()))]))
    else:
        path.write_bytes(commented_png(px, [_png_chunk(
            b"tEXt", b"Comment\0not the key")]))


@pytest.mark.parametrize("kind", ["jpg", "jp2", "png-text", "png-late",
                                  "png-other-key"])
def test_page_comment_is_the_one_pil_writes(tmp_path, kind):
    """_image.comment gives the comment PIL writes into a JPEG saved from
    the opened page."""
    from origami_tpu_torch.core import _image, _jpeg
    px = np.random.default_rng(3).integers(0, 256, (40, 30), np.uint8)
    path = tmp_path / ("page." + kind.split("-")[0])
    commented_page(path, px, kind)
    im = PIL.Image.open(path).convert("L")
    buf = io.BytesIO()
    im.save(buf, "JPEG", quality=80)
    got = _jpeg.encode(np.asarray(im), 80, comment=_image.comment(path))
    assert got == buf.getvalue()
    assert (_image.comment(path) is None) == (kind == "png-other-key")


@pytest.mark.parametrize("kind", ["jpg", "jp2", "png-late"])
def test_thumbnail_of_a_commented_page_equals_jax(tmp_path, kind):
    """A page's comment goes into the thumbnail, as PIL carries
    info["comment"] into the JPEG it saves."""
    rng = np.random.default_rng(len(kind))
    px = rng.integers(0, 256, (1300, 700), dtype=np.uint8)
    px[200:900, 100:600] //= 4
    out = {}
    for side in ("j", "p"):
        corpus = tmp_path / side
        corpus.mkdir()
        commented_page(corpus / ("page." + kind.split("-")[0]), px, kind)
        if side == "j":
            _jax("thumbnail").ThumbnailProcessor(dict(OPTIONS)) \
                .traverse(str(corpus))
        else:
            thumbnail.main(CPU + [str(corpus)])
        out[side] = (corpus / "page.out" / "thumbnail.jpg").read_bytes()
    assert out["p"] == out["j"]
    assert b"\xff\xfe" in out["p"][:64]


@pytest.mark.parametrize("shape", [
    "real_scan_1872", "real_scan_bbz_1925", (4500, 3000), (2049, 5000),
    (9000, 6100), (333, 4099), (1025, 1024), (300, 200)])
def test_thumbnail_equals_pil(shape):
    if isinstance(shape, str):
        px = _png.read_gray(ROOT / "tests" / "data" / (shape + ".png"))
    else:
        px = np.random.default_rng(sum(shape)).integers(
            0, 256, shape, dtype=np.uint8)
    im = PIL.Image.fromarray(px)
    im.thumbnail((1024, 1024))
    want = np.asarray(im)
    got = thumbnail.thumbnail(px)
    assert got.shape == want.shape
    assert int((got != want).sum()) == 0


@pytest.mark.parametrize("shape,size", [
    ((389, 245), (128, 128)), ((50, 130), (128, 128)),
    ((1000, 17), (128, 128)), ((133, 133), (128, 40))])
def test_resize_bicubic_equals_pil(shape, size):
    rng = np.random.default_rng(shape[0])
    for px in ((rng.random(shape) > 0.7).astype(np.uint8) * 255,
               rng.integers(0, 256, shape, dtype=np.uint8)):
        want = np.asarray(PIL.Image.fromarray(px).resize(size))
        assert int((thumbnail.resize_bicubic(px, size) != want).sum()) == 0
    box = (3.25, 1.5, shape[1] - 2.75, shape[0] - 0.5)
    want = np.asarray(PIL.Image.fromarray(px).resize(size, box=box))
    assert int((thumbnail.resize_bicubic(px, size, box) != want).sum()) == 0


@pytest.mark.parametrize("factor", [(2, 2), (3, 2), (1, 3), (5, 4), (7, 7)])
def test_reduce_equals_pil(factor):
    px = np.random.default_rng(5).integers(0, 256, (101, 97), np.uint8)
    want = np.asarray(PIL.Image.fromarray(px).reduce(factor))
    np.testing.assert_array_equal(thumbnail.reduce(px, *factor), want)


def test_signature_equals_jax(tmp_path):
    jax_corpus, corpus = _corpus(tmp_path / "j"), _corpus(tmp_path / "p")
    _jax("signature").SignatureProcessor(dict(OPTIONS)) \
        .traverse(str(jax_corpus))
    signature.main(CPU + [str(corpus)])
    want = chip_smoke.signature_digests(
        jax_corpus / (PAGE + ".out") / "signature.zip")
    got = chip_smoke.signature_digests(
        corpus / (PAGE + ".out") / "signature.zip")
    assert len(got[0]) >= 3
    assert got == want
    assert list(want) == [REF["signature"][PAGE]["png"],
                          REF["signature"][PAGE]["json"]]


def test_rtext_equals_jax(tmp_path):
    jax_corpus, corpus = _corpus(tmp_path / "j"), _corpus(tmp_path / "p")
    _jax("rtext").RegionTextProcessor(dict(
        OPTIONS, output=str(tmp_path / "jo"))).traverse(str(jax_corpus))
    rtext_cli.main(CPU + ["-o", str(tmp_path / "po"), str(corpus)])
    want = chip_smoke.text_digests(tmp_path / "jo" / PAGE)
    assert len(want) > 10
    assert chip_smoke.text_digests(tmp_path / "po" / PAGE) == want
    assert want == REF["rtext"][PAGE]


def _plant(corpus):
    """A FAILED stage, a temporary file, a broken JSON, an annotation
    and a thumbnail (the packages' names, .jpg, and decoys named .png)
    in every page."""
    for out in sorted(corpus.glob("*.out")):
        rt = json.loads((out / "runtime.json").read_text())
        rt["origami_tpu.batch.detect.ocr"] = dict(
            status="FAILED", traceback="Traceback\nValueError: planted")
        (out / "runtime.json").write_text(json.dumps(rt))
        (out / "tmpx.json").write_text("{}")
        (out / "broken.json").write_text("{")
        for ext in ("jpg", "png"):
            (out / ("annotation.layout." + ext)).write_text("x")
            (out / ("thumbnail." + ext)).write_text("x")


def _state(corpus):
    """Each page's files and runtime.json entries but the utilities'
    own."""
    out = {}
    for d in sorted(corpus.glob("*.out")):
        names = sorted(p.name for p in d.iterdir()
                       if p.name != "runtime.json")
        rt = json.loads((d / "runtime.json").read_text())
        out[d.name] = (names, sorted(k for k in rt if "Processor" not in k))
    return out


def test_stats_reports_what_jax_reports(tmp_path):
    corpora = {}
    for name in ("jax", "port"):
        corpora[name] = _corpus(tmp_path / name, stems=("synth0000",
                                                        "synth0001"))
        _plant(corpora[name])
    printed, csvs = {}, {}
    cwd = os.getcwd()
    try:
        for name in corpora:
            work = tmp_path / (name + "_cwd")
            work.mkdir()
            os.chdir(work)
            if name == "jax":
                p = _jax("stats").StatsProcessor(dict(
                    OPTIONS, list_names=True, list_errors=True))
                p.traverse(str(corpora[name]))
            else:
                p = stats.StatsProcessor(dict(
                    OPTIONS, device="cpu", list_names=True,
                    list_errors=True))
                p.traverse(str(corpora[name]))
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                p.print()
            printed[name] = buf.getvalue().replace(str(corpora[name]), "C")
            csvs[name] = (work / "errors.csv").read_text() \
                .replace(str(corpora[name]), "C")
    finally:
        os.chdir(cwd)
    assert "ValueError: planted" in printed["port"]
    assert printed["port"] == printed["jax"]
    assert csvs["port"] == csvs["jax"]


@pytest.mark.parametrize("dry", [False, True])
def test_reset_and_cleanup_leave_what_jax_leaves(tmp_path, dry):
    states, counts = {}, {}
    for name in ("jax", "port"):
        corpus = _corpus(tmp_path / name)
        _plant(corpus)
        opts = dict(OPTIONS, artifacts="annotation/layout, thumbnail, "
                    "contours/aggregate, ocr", dry_run=dry)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            if name == "jax":
                r = _jax("reset").ResetProcessor(opts)
                r.traverse(str(corpus))
                c = _jax("cleanup").CleanupProcessor(dict(opts))
                c.traverse(str(corpus))
                counts[name] = (r._n_removed, c._removed, c._fixed)
            else:
                r = reset.main(CPU + ["-a", opts["artifacts"]]
                               + (["--dry-run"] if dry else [])
                               + [str(corpus)])
                c = cleanup.main(CPU + (["--dry-run"] if dry else [])
                                 + [str(corpus)])
                counts[name] = (r.n_removed, c.removed, c.fixed)
        states[name] = _state(corpus)
    assert counts["port"] == counts["jax"]
    assert counts["port"] == ((3, 2, 0) if dry else (3, 2, 1))
    assert states["port"] == states["jax"]
