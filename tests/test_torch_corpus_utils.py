"""The port's corpus utilities (origami_tpu_torch/batch/utils/{sample,
compare,segment,pdf}.py) and tool/migrate.py against the JAX package's,
on a corpus planted from the fixture pages' JAX artifacts
(tests/data/torch_ocr/full, torch_compose, torch_segment) and a legacy
pickle built here.

Bars: sample copies the same pages and files (the same bytes; the same
zip members), in each output form; compare returns the same numbers and
prints the same lines; segment and migrate write segment.zip files that
read back equal (label maps and classes) and the same meta.json keys;
pdf raises and names `fitz`.
"""

import contextlib
import io
import json
import pickle
import random
import shutil
import sys
import zipfile

import numpy as np
import pytest

import chip_smoke
from origami_tpu.batch.utils import compare as jax_compare
from origami_tpu.batch.utils import sample as jax_sample
from origami_tpu.batch.utils import segment as jax_segment
from origami_tpu.tool import migrate as jax_migrate
from origami_tpu_torch.batch.utils import compare, pdf, sample, segment
from origami_tpu_torch.core.segment import Prediction, Segmentation
from origami_tpu_torch.tool import migrate

FULL = chip_smoke.FIXTURE
COMPOSE = chip_smoke.ROOT / "tests" / "data" / "torch_compose"
SEG_REF = chip_smoke.SEG_REF
CPU = ["--device", "cpu", "--lock-strategy", "NONE", "--plain"]
OPTIONS = dict(lock_strategy="NONE", plain=True)
# four pages, each a copy of a fixture page with its JAX artifacts
PAGES = {"p%d" % i: "synth000%d" % (i % 2) for i in range(4)}


def plant(dst, ocr="single", seg=None):
    """PAGES in `dst` with segment.zip (the fixture's, or SEG_REF's
    `<stem>.<seg>.segment.zip`), the `ocr` run's ocr.zip and
    compose.zip."""
    dst.mkdir(parents=True)
    for name, stem in PAGES.items():
        shutil.copy(FULL / (stem + ".png"), dst / (name + ".png"))
        out = dst / (name + ".out")
        out.mkdir()
        shutil.copy(SEG_REF / ("%s.%s.segment.zip" % (stem, seg)) if seg
                    else FULL / (stem + ".out") / "segment.zip",
                    out / "segment.zip")
        shutil.copy(FULL / "ref" / ("%s.%s.ocr.zip" % (stem, ocr)),
                    out / "ocr.zip")
        shutil.copy(COMPOSE / (stem + ".out") / "compose.zip",
                    out / "compose.zip")
    return dst


def tree(root):
    """{relative path: bytes} of every file under root."""
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def quiet(fn, *a):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*a)
    return buf.getvalue()


@pytest.mark.parametrize("form", ["dir", "unpack", "zip"])
def test_sample_exports_what_jax_exports(tmp_path, form):
    corpus = plant(tmp_path / "corpus")
    got = {}
    for name in ("jax", "port"):
        out = tmp_path / (name + (".zip" if form == "zip" else ""))
        if name == "jax":
            p = jax_sample.SampleProcessor(dict(
                OPTIONS, artifacts="segmentation, ocr, compose",
                output=str(out), n=2, unpack=form == "unpack"))
            printed = quiet(lambda: (p.traverse(str(corpus)), p.export()))
        else:
            printed = quiet(sample.main, CPU + [
                "-a", "segmentation, ocr, compose", "-o", str(out), "-n", "2"]
                + (["--unpack"] if form == "unpack" else []) + [str(corpus)])
        if form == "zip":
            with zipfile.ZipFile(out) as zf:
                files = {n: zf.read(n) for n in zf.namelist()}
        else:
            files = tree(out)
        got[name] = (files, printed.splitlines()[-1])
    assert got["port"] == got["jax"]
    files, printed = got["port"]
    # the page and its 3 artifacts, 2 pages
    assert printed == "exported 8 files from 2 pages."
    # random.Random(0) over the four pages in the processor's order
    assert {f.split("/")[0] for f in files} == {
        p.stem for p in random.Random(0).sample(
            sorted(corpus.glob("*.png")), 2)}


def test_compare_reports_what_jax_reports(tmp_path):
    """A: the fixture's bf16 segment.zip, the single run's text; B:
    JAX's float32 maps at a third of the size (resized nearest to A's)
    and the ensemble run's text."""
    a = plant(tmp_path / "a")
    b = plant(tmp_path / "b", ocr="ensemble", seg="f32")
    for out in b.glob("*.out"):
        seg = Segmentation.open(out / "segment.zip")
        Segmentation([Prediction(p.type, p.name, p.labels[::3, ::3],
                                 p.classes) for p in seg.predictions]) \
            .save(out / "segment.zip")
    out_a, out_b = a / "p0.out", b / "p0.out"
    for fn in ("compare_segmentation", "compare_ocr", "compare_compose"):
        name = {"compare_segmentation": "segment.zip",
                "compare_ocr": "ocr.zip",
                "compare_compose": "compose.zip"}[fn]
        want = getattr(jax_compare, fn)(out_a / name, out_b / name)
        got = getattr(compare, fn)(out_a / name, out_b / name)
        assert json.dumps(got, sort_keys=True) \
            == json.dumps(want, sort_keys=True), fn
    # two pages a corpus, the second missing in B
    for corpus in (a, b):
        for name in ("p2", "p3"):
            shutil.rmtree(corpus / (name + ".out"))
    shutil.rmtree(b / "p1.out")
    want = quiet(jax_compare.compare.callback, str(a), str(b))
    got = quiet(compare.main, [str(a), str(b)])
    assert got == want
    assert "p1.out: missing in B" in got and "mean OCR CER" in got


def legacy_pickle(path, seg_zip):
    """A legacy segmentation.pickle holding seg_zip's predictors:
    [(key, (enum name, classes, npz bytes of the labels))]."""
    seg = Segmentation.open(seg_zip)
    data = []
    for p in seg.predictions:
        buf = io.BytesIO()
        np.savez(buf, p.labels)
        enum = "BBZRegion" if p.name == "regions" else "BBZSeparator"
        data.append((p.name, (enum, p.classes.as_dict(), buf.getvalue())))
    path.write_bytes(pickle.dumps(data))
    return seg


def read_back(path):
    seg = Segmentation.open(path)
    return {p.name: (p.type.name, p.classes.as_dict(), p.labels.tolist())
            for p in seg.predictions}


def test_convert_legacy_segmentation_equals_jax(tmp_path):
    seg = legacy_pickle(tmp_path / "segmentation.pickle",
                        FULL / "synth0000.out" / "segment.zip")
    jax_migrate.convert_legacy_segmentation(tmp_path / "segmentation.pickle",
                                            tmp_path / "jax.zip")
    migrate.convert_legacy_segmentation(tmp_path / "segmentation.pickle",
                                        tmp_path / "port.zip")
    assert read_back(tmp_path / "port.zip") == read_back(tmp_path / "jax.zip")
    for p in seg.predictions:
        np.testing.assert_array_equal(
            Segmentation.open(tmp_path / "port.zip").by_name(p.name).labels,
            p.labels)


def legacy_corpus(dst):
    """PAGES with legacy artifacts: a segmentation.pickle and no
    segment.zip on p0 and p1, and the old names of contours and lines
    zips on p1."""
    corpus = plant(dst)
    for name in ("p0", "p1"):
        out = corpus / (name + ".out")
        legacy_pickle(out / "segmentation.pickle", out / "segment.zip")
        (out / "segment.zip").unlink()
    (corpus / "p1.out" / "contours.zip").write_bytes(b"c")
    (corpus / "p1.out" / "lines.zip").write_bytes(b"l")
    return corpus


def test_utils_segment_and_migrate_equal_jax(tmp_path):
    states = {}
    for name in ("jax", "port"):
        corpus = legacy_corpus(tmp_path / ("seg_" + name))
        if name == "jax":
            p = jax_segment.SegmentConverterProcessor(OPTIONS)
            p.traverse(str(corpus))
            n = p._n
        else:
            n = segment.main(CPU + [str(corpus)]).n_converted
        assert n == 2
        corpus2 = legacy_corpus(tmp_path / ("mig_" + name))
        dry = quiet(jax_migrate.migrate.callback, str(corpus2), True, None) \
            if name == "jax" else quiet(migrate.main,
                                        [str(corpus2), "--dry-run"])
        done = quiet(jax_migrate.migrate.callback, str(corpus2), False,
                     None) if name == "jax" \
            else quiet(migrate.main, [str(corpus2)])
        states[name] = (
            {k: read_back(corpus / k / "segment.zip")
             for k in sorted(p.name for p in corpus.glob("*.out"))},
            sorted(str(p.relative_to(corpus2))
                   for p in corpus2.rglob("*") if p.is_file()),
            {k: read_back(corpus2 / k / "segment.zip")
             for k in sorted(p.name for p in corpus2.glob("*.out"))},
            dry.replace(str(corpus2), "C"), done)
    assert states["port"] == states["jax"]
    assert states["port"][4] == "migrated 4 artifacts.\n"


def test_import_model_meta_has_jax_keys(tmp_path, monkeypatch):
    """A reference model directory (meta.json and an unreadable
    model.h5): the same meta.json, the h5 summary an error, parameters
    of the shapes JAX's net has (its init traced for the shapes alone),
    freshly initialized."""
    import jax
    from origami_tpu.models import registry as jax_registry
    from origami_tpu_torch.models import registry
    init = jax_registry._init_params
    monkeypatch.setattr(jax_registry, "_init_params", lambda meta, seed=0: (
        jax.tree.map(lambda x: np.zeros(x.shape, x.dtype),
                     jax.eval_shape(lambda: init(meta, seed)))))
    src = tmp_path / "ref"
    src.mkdir()
    (src / "meta.json").write_text(json.dumps(dict(
        type="SEPARATOR", classes=["H", "V", "T", "BACKGROUND"],
        full_size=[64, 128], tile_size=[64, 64], tile_beta=50,
        model="unet", backbone="resnet34")))
    (src / "model.h5").write_bytes(b"not an hdf5 file")
    metas, trees = {}, {}
    for name, mod in (("jax", jax_migrate), ("port", migrate)):
        out = tmp_path / name
        mod.import_model_meta(src, out, width=0.25, s2d=2)
        metas[name] = json.loads((out / "meta.json").read_text())
        tree, _ = registry.load_params(out)
        trees[name] = {"/".join(k): np.shape(v) for k, v in _flat(tree)}
    assert metas["port"] == metas["jax"]
    assert set(metas["port"]["imported_from"]["h5"]) == {"error"}
    assert trees["port"] == trees["jax"]
    printed = quiet(migrate.main, [str(tmp_path / "cli"), "--import-model",
                                   str(src)])
    assert printed.startswith("imported ") and "H,V,T,BACKGROUND" in printed


def _flat(tree, prefix=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), tree[k]


def test_pdf_raises_and_names_fitz(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "fitz", None)
    (tmp_path / "a.pdf").write_bytes(b"%PDF-1.4\n")
    with pytest.raises(RuntimeError, match="fitz"):
        pdf.convert_pdf(tmp_path / "a.pdf", tmp_path / "out")
    with pytest.raises(SystemExit, match="fitz"):
        pdf.main([str(tmp_path / "a.pdf"), "-o", str(tmp_path / "out")])
