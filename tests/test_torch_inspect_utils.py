"""The port's corpus utilities (origami_tpu_torch/batch/utils: dewarp,
thumbnail, signature, rtext, stats, reset, cleanup) and Page.dewarped
against the JAX package's, on the CPU (`--device cpu`).

The JAX modules save JPEGs through PIL; their images are captured before
encoding (the make_torch_inspect_fixture helpers wrap PIL's JPEG save).

Bars:
  * Page.dewarped and utils.dewarp's page: equal to JAX's Page.dewarped
    on every pixel (ROADMAP C3), and to the fixture's digest;
  * thumbnails: equal to PIL's Image.thumbnail((1024, 1024)) on every
    pixel, for the fixture page, the real scans and seeded pages that
    take Image.reduce first; resize and reduce alone equal to PIL's;
  * signature.zip: its PNGs decode to JAX's pixels, signature.json equal;
  * rtext: the same files with the same texts;
  * stats: the same report and errors.csv; reset and cleanup: the same
    files left and the same runtime.json entries (the port's annotation
    and thumbnail names are PNG).
"""

import contextlib
import importlib.util
import io
import json
import os
import shutil

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
        == REF["renders"][PAGE]["dewarped.png"]["digest"]


def test_dewarp_cli_writes_the_dewarped_page(tmp_path):
    corpus = _corpus(tmp_path / "c")
    dewarp.main(CPU + [str(corpus)])
    dewarp.main(CPU + ["-o", str(tmp_path / "o"), str(corpus)])
    want = REF["renders"][PAGE]["dewarped.png"]["digest"]
    for path in (corpus / (PAGE + ".out") / "dewarped.png",
                 tmp_path / "o" / (PAGE + ".dewarped.png")):
        assert chip_smoke.masked_digest(_png.read(path)) == want


def test_thumbnail_cli_equals_jax(tmp_path):
    jax_corpus, corpus = _corpus(tmp_path / "j"), _corpus(tmp_path / "p")
    with _script().captured_jpegs() as saved:
        _jax("thumbnail").ThumbnailProcessor(dict(OPTIONS)) \
            .traverse(str(jax_corpus))
    want = saved["thumbnail.png"][PAGE]
    thumbnail.main(CPU + [str(corpus)])
    got = _png.read(corpus / (PAGE + ".out") / "thumbnail.png")
    assert got.shape == want.shape == (1024, 700)
    assert int((got != want).sum()) == 0
    assert chip_smoke.digest(want) == REF["thumbnail"][PAGE]


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


def _plant(corpus, jpeg):
    """A FAILED stage, a temporary file, a broken JSON, an annotation
    and a thumbnail (the package's own extension) in every page."""
    ext = "jpg" if jpeg else "png"
    for out in sorted(corpus.glob("*.out")):
        rt = json.loads((out / "runtime.json").read_text())
        rt["origami_tpu.batch.detect.ocr"] = dict(
            status="FAILED", traceback="Traceback\nValueError: planted")
        (out / "runtime.json").write_text(json.dumps(rt))
        (out / "tmpx.json").write_text("{}")
        (out / "broken.json").write_text("{")
        (out / ("annotation.layout." + ext)).write_text("x")
        (out / ("thumbnail." + ext)).write_text("x")


def _state(corpus):
    """Each page's files (annotation and thumbnail names without their
    extension) and runtime.json entries but the utilities' own."""
    out = {}
    for d in sorted(corpus.glob("*.out")):
        names = sorted(p.name.replace(".jpg", "").replace(".png", "")
                       for p in d.iterdir() if p.name != "runtime.json")
        rt = json.loads((d / "runtime.json").read_text())
        out[d.name] = (names, sorted(k for k in rt if "Processor" not in k))
    return out


def test_stats_reports_what_jax_reports(tmp_path):
    corpora = {}
    for name, jpeg in (("jax", True), ("port", False)):
        corpora[name] = _corpus(tmp_path / name, stems=("synth0000",
                                                        "synth0001"))
        _plant(corpora[name], jpeg)
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
            # the planted annotation and thumbnail: .jpg in JAX's corpus
            printed[name] = buf.getvalue().replace(str(corpora[name]), "C") \
                .replace(".jpg", ".png")
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
    for name, jpeg in (("jax", True), ("port", False)):
        corpus = _corpus(tmp_path / name)
        _plant(corpus, jpeg)
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
