"""The port's operator tools (origami_tpu_torch/tool: lineload, harmonize,
export, split, merge, pick, annotate, sample, cluster, xycut) against the
JAX package's, on the CPU (`--device cpu`).

Bars:
  * the annotation DB: the same PRAGMA table_info, and a DB written by
    either package reads the same rows in the other;
  * harmonize: both schemas' self-tests pass; on seeded strings every
    channel's output, or the IllegalCharacter's index, equals JAX's;
  * sample: the same rows (page paths relative to the corpus), with and
    without --import-transcriptions;
  * load_line_image on 6 lines of synth0000: the same shapes, within 1
    gray level;
  * the sample -> annotate set -> harmonize -> export chain (chip_smoke
    phase 20a on the CPU, against tests/data/torch_tools): rows, texts,
    names and sets.json equal, strips within 1 gray level, binarized
    strips equal on >= 99.9 % of their pixels;
  * split: kmeans and optimal_split assignments equal; line_signature and
    cluster.load_signatures within 1e-12;
  * merge, pick and annotate give the same DB; xycut prints the same
    tree;
  * annotate export-image writes the format its suffix names, PIL's
    bytes of the strip for .jpg/.jpeg (quality 75), .tif/.tiff and .bmp,
    a PNG of it for .png, and raises naming any other suffix.
"""

import contextlib
import io
import random
import sqlite3
import unicodedata

import numpy as np
import pytest

import chip_smoke
from origami_tpu_torch.tool import (annotate, cluster, harmonize, lineload,
                                    merge, pick, sample, split, xycut)

CPU = ["--device", "cpu"]
PAGE = "synth0000"


def _rows(db, corpus):
    return chip_smoke.db_rows(db, corpus)


def _quiet(fn, *args, **kw):
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        fn(*args, **kw)
    return buf.getvalue()


def _click(cmd, args):
    return _quiet(cmd.main, [str(a) for a in args], standalone_mode=False)


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """Two copies of the OCR fixture pages: one for each package."""
    base = tmp_path_factory.mktemp("tools")
    return (chip_smoke.tools_corpus(base / "jax"),
            chip_smoke.tools_corpus(base / "port"))


def test_annotation_db_schema_and_cross_reading(tmp_path):
    from origami_tpu.tool.lineload import AnnotationDB as JaxDB
    a, b = tmp_path / "jax.db", tmp_path / "port.db"
    for db, cls in ((a, JaxDB), (b, lineload.AnnotationDB)):
        d = cls(db)
        d.add_line("p.png", "regions/TEXT/1/0", "text", "me", 1, 0)
        d.add_line("p.png", "regions/TEXT/1/1")
        d.update_annotation("p.png", "regions/TEXT/1/1", "other")
        d.set_split("p.png", "regions/TEXT/1/0", 0, 1)
        d.add_line("q.png", "regions/TEXT/2/0")
        d.remove_line("q.png", "regions/TEXT/2/0")
        d.close()
    assert chip_smoke.db_schema(a) == chip_smoke.db_schema(b)
    for db in (a, b):
        got = lineload.AnnotationDB(db)
        want = JaxDB(db)
        assert got.all_lines() == want.all_lines()
        assert got.all_lines(True) == want.all_lines(True)
        assert got.lines_for_page("p.png") == want.lines_for_page("p.png")
        assert len(got) == len(want) == 2


@pytest.mark.parametrize("name", ["default", "bbz"])
def test_schema_self_tests_pass(name):
    from origami_tpu.tool.harmonize import Schema as JaxSchema
    assert harmonize.Schema.load(name).run_tests(verbose=False)
    assert JaxSchema.load(name).run_tests(verbose=False)
    code = None
    try:
        _quiet(harmonize.main, [name, "--test"] + CPU)
    except SystemExit as e:
        code = e.code
    assert code == 0


def _seeded_strings(schema_data, n=300, seed=5):
    """The schema's test inputs and seeded strings over their characters,
    the alphabets' and some outside any alphabet."""
    inputs = [i for cases in schema_data["tests"].values()
              for i, _ in cases]
    chars = set("".join(inputs)) | set(" ,.;:-—–⸗()%\t\n'\"&ſ€æ")
    for ch in schema_data["channels"].values():
        alpha = ch.get("alphabet")
        if isinstance(alpha, dict):
            chars |= set("".join(alpha.values()))
        elif alpha:
            chars |= set(alpha)
    chars = sorted(chars)
    rng = random.Random(seed)
    out = list(inputs)
    for _ in range(n):
        s = "".join(rng.choice(chars) for _ in range(rng.randint(0, 24)))
        out.append(s if rng.random() < 0.8
                   else unicodedata.normalize("NFD", s))
    return out


def _apply(channel, text, illegal):
    try:
        return ("ok", channel.transform(text))
    except illegal as e:
        return ("illegal", e.index, e.text)


@pytest.mark.parametrize("name", ["default", "bbz"])
def test_harmonize_equals_jax(name):
    import importlib

    from origami_tpu.tool import harmonize as jax_harmonize
    data = importlib.import_module(
        "origami_tpu_torch.custom.harmonizations." + name).SCHEMA
    port = harmonize.Schema.load(name)
    ref = jax_harmonize.Schema.load(name)
    assert port.channels.keys() == ref.channels.keys()
    strings = _seeded_strings(data)
    illegal = 0
    for channel in port.channels:
        for s in strings:
            got = _apply(port.channels[channel], s,
                         harmonize.IllegalCharacter)
            want = _apply(ref.channels[channel], s,
                          jax_harmonize.IllegalCharacter)
            assert got == want, (channel, s)
            illegal += got[0] == "illegal"
    # the alphabets are exercised where a schema has them
    assert illegal > 0 or name == "default"
    assert _quiet(harmonize.main, [name, "--text", strings[0], "--channel",
                                   list(port.channels)[0]] + CPU) \
        == _click(jax_harmonize.harmonize, [name, "--text", strings[0],
                                            "--channel",
                                            list(port.channels)[0]])


def _gt_xml(corpus):
    """The JAX compose stage's page.xml of each page as its
    <page>.gt.page.xml."""
    import zipfile
    for png in chip_smoke.tools_pages(corpus):
        with zipfile.ZipFile(chip_smoke.COMPOSE_REF / (png.stem + ".out")
                             / "compose_xml.zip") as zf:
            png.with_suffix(".gt.page.xml").write_bytes(zf.read("page.xml"))


@pytest.mark.parametrize("gt", [False, True])
def test_sampled_rows_equal_jax(tmp_path, gt):
    from origami_tpu.tool.sample import SampleLinesProcessor
    a = chip_smoke.tools_corpus(tmp_path / "jax")
    b = chip_smoke.tools_corpus(tmp_path / "port")
    if gt:
        _gt_xml(a)
        _gt_xml(b)
    _quiet(SampleLinesProcessor(dict(
        db_path=str(a / "a.db"), per_type=3, seed=4, plain=True,
        import_transcriptions=gt)).traverse, str(a))
    _quiet(sample.main, [str(b), "--db-path", str(b / "a.db"),
                         "--per-type", "3", "--seed", "4", "--plain"]
           + ["--import-transcriptions"] * gt + CPU)
    want = _rows(a / "a.db", a)
    assert _rows(b / "a.db", b) == want
    assert len(want) >= 8
    assert sum(r[2] is not None for r in want) >= (4 if gt else 0)


def test_load_line_image_equals_jax(corpora):
    from origami_tpu.batch.core.io import Artifact, Input, Stage
    from origami_tpu.tool.lineload import load_line_image as jax_load
    a, b = corpora
    reader = Input(Artifact.LINES, stage=Stage.RELIABLE).instantiate(
        page_path=a / (PAGE + ".png"))
    paths = sorted("/".join(p) for p in reader.lines.by_path)
    chosen = paths[:: max(1, len(paths) // 6)][:6]
    assert len(chosen) == 6
    for path in chosen:
        want = jax_load(a / (PAGE + ".png"), path)
        got = lineload.load_line_image(b / (PAGE + ".png"), path,
                                       device="cpu")
        assert got.dtype == np.uint8 and got.shape == want.shape
        assert np.abs(got.astype(int) - want).max() <= 1, path
    with pytest.raises(KeyError):
        lineload.load_line_image(b / (PAGE + ".png"), "regions/X/0",
                                 device="cpu")


def test_export_chain_equals_jax_fixture(tmp_path):
    """chip_smoke phase 20a on the CPU against the JAX tools' outputs."""
    import json
    ref = json.loads((chip_smoke.TOOLS_REF / "tools.json").read_text())
    corpus = chip_smoke.tools_corpus(tmp_path / "corpus")
    out = chip_smoke.check_tool_chain(corpus, tmp_path, ref, "cpu")
    assert len(out["export"]["names"]) == len(ref["rows"]) == 8
    assert out["export_bin"]["sets"]["valid"] and \
        out["export_bin"]["sets"]["train"]


def test_export_image_writes_png_only(corpora, tmp_path):
    """.png writes a PNG of the strip; a suffix PIL would take for another
    format the port does not write raises, naming it, and writes
    nothing."""
    from origami_tpu_torch.core import _png
    _, b = corpora
    strip = annotate.export_image(b / (PAGE + ".png"), "regions/TEXT/2/0",
                                  tmp_path / "line.png", device="cpu")
    np.testing.assert_array_equal(_png.read(tmp_path / "line.png"), strip)
    for name in ("line.gif", "line.webp", "line"):
        with pytest.raises(ValueError, match="suffix '%s'"
                           % name[4:].lower()):
            annotate.export_image(b / (PAGE + ".png"), "regions/TEXT/2/0",
                                  tmp_path / name, device="cpu")
        assert not (tmp_path / name).exists()


@pytest.mark.parametrize("suffix", [".jpg", ".jpeg", ".JPG", ".tif",
                                    ".tiff", ".bmp"])
def test_export_image_by_suffix_writes_pil_bytes(corpora, tmp_path, suffix):
    import PIL.Image
    _, b = corpora
    out = tmp_path / ("line" + suffix)
    strip = annotate.export_image(b / (PAGE + ".png"), "regions/TEXT/2/0",
                                  out, device="cpu")
    want = tmp_path / ("pil" + suffix)
    PIL.Image.fromarray(strip).save(want)
    assert out.read_bytes() == want.read_bytes()


def test_split_equals_jax():
    from origami_tpu.tool import split as jax_split
    rng = np.random.default_rng(11)
    strips = [rng.integers(0, 256, (48, int(w)), dtype=np.uint8)
              for w in rng.integers(40, 400, 23)]
    strips.append(np.zeros((48, 50), np.uint8))
    got = np.array([split.line_signature(s) for s in strips])
    want = np.array([jax_split.line_signature(s) for s in strips])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    for k, seed in ((3, 0), (5, 2), (40, 1)):
        ga, gc = split.kmeans(got, k, seed=seed)
        wa, wc = jax_split.kmeans(want, k, seed=seed)
        np.testing.assert_array_equal(ga, wa)
        np.testing.assert_allclose(gc, wc, rtol=0, atol=1e-12)
    names = ["line%02d" % i for i in range(len(strips))]
    for n, ratio, seed in ((24, 0.2, 0), (24, 0.35, 3), (4, 0.2, 0)):
        assert split.optimal_split(names[:n], got[:n], ratio, seed=seed) \
            == jax_split.optimal_split(names[:n], want[:n], ratio,
                                       seed=seed)


def test_load_signatures_and_cluster_equal_jax(tmp_path):
    from origami_tpu.batch.utils.signature import SignatureProcessor
    from origami_tpu.tool import cluster as jax_cluster
    corpus = chip_smoke.tools_corpus(tmp_path / "corpus")
    _quiet(SignatureProcessor(dict(lock_strategy="NONE", plain=True))
           .traverse, str(corpus))
    (corpus / "broken.out").mkdir()
    (corpus / "broken.out" / "signature.zip").write_bytes(b"not a zip")
    names, mat = cluster.load_signatures(corpus)
    want_names, want = jax_cluster.load_signatures(corpus)
    assert names == want_names and len(names) == 2
    np.testing.assert_allclose(mat, want, rtol=0, atol=1e-12)
    out = tmp_path / "groups.json"
    printed = _quiet(cluster.main, [str(corpus), "-k", "2", "-o", str(out)]
                     + CPU)
    assert printed == _click(jax_cluster.cluster,
                             [corpus, "-k", 2, "-o", tmp_path / "j.json"])
    assert out.read_text() == (tmp_path / "j.json").read_text()


def _db_ops(tmp_path, tag, set_cmd, pick_cmd, merge_cmd):
    """The same annotate set / pick add, remove / merge sequence on
    tag's DBs -> their rows."""
    a, src = tmp_path / ("%s.db" % tag), tmp_path / ("%s_src.db" % tag)
    pick_cmd(["add", "--db-path", a, "--page", "p.png", "--line",
              "r/T/1/1"])
    pick_cmd(["add", "--db-path", a, "--page", "p.png", "--line",
              "r/T/1/2"])
    pick_cmd(["remove", "--db-path", a, "--page", "p.png", "--line",
              "r/T/1/2"])
    set_cmd(["set", "--db-path", a, "--page", "p.png", "--line", "r/T/1/0",
             "--text", "one", "--author", "x"])
    pick_cmd(["add", "--db-path", src, "--page", "p.png", "--line",
              "r/T/1/1"])
    set_cmd(["set", "--db-path", src, "--page", "p.png", "--line",
             "r/T/1/1", "--text", "two"])
    set_cmd(["set", "--db-path", src, "--page", "q.png", "--line",
             "r/T/2/0", "--text", "three"])
    set_cmd(["set", "--db-path", src, "--page", "p.png", "--line",
             "r/T/1/0", "--text", "four"])
    merge_cmd([a, "--with-db", src, "--prefer", "dst"])
    out = [set_cmd(["list", "--db-path", a]),
           set_cmd(["list", "--db-path", a, "--unannotated"]),
           set_cmd(["list", "--db-path", a, "--search", "t"]),
           set_cmd(["stats", "--db-path", a])]
    conn = sqlite3.connect(str(a))
    rows = conn.execute("SELECT * FROM lines ORDER BY rowid").fetchall()
    conn.close()
    return rows, out


def test_merge_pick_annotate_same_db(tmp_path):
    from origami_tpu.tool import annotate as ja, merge as jm, pick as jp
    jax = _db_ops(tmp_path, "jax", lambda a: _click(ja.annotate, a),
                  lambda a: _click(jp.pick, a),
                  lambda a: _click(jm.merge_db, a))
    port = _db_ops(tmp_path, "port",
                   lambda a: _quiet(annotate.main, [str(x) for x in a]
                                    + CPU),
                   lambda a: _quiet(pick.main, [str(x) for x in a] + CPU),
                   lambda a: _quiet(merge.main, [str(x) for x in a] + CPU))
    assert port == jax
    assert merge.merge_dbs(tmp_path / "port.db", tmp_path / "port_src.db") \
        == 3


def test_xycut_prints_the_same_tree(corpora):
    from origami_tpu.tool.xycut import xycut_debug as jax_xycut
    import shutil
    a, b = corpora
    for corpus in corpora:
        for png in chip_smoke.tools_pages(corpus):
            shutil.copy(chip_smoke.FLOW_REF / (png.stem + ".out")
                        / "contours.0.zip", corpus / (png.stem + ".out"))
    for stage in ("reliable", "warped"):
        for png in chip_smoke.tools_pages(b):
            args = ["--stage", stage]
            got = _quiet(xycut.main, [str(png)] + args + CPU)
            want = _click(jax_xycut, [a / png.name] + args)
            assert got == want and "final order:" in got


def test_tool_entry_points_need_cuda_unless_told_cpu(corpora, tmp_path):
    """Without a card, every tool CLI raises unless told --device cpu;
    nothing falls back quietly."""
    import torch

    from origami_tpu_torch.batch.remote import runner
    from origami_tpu_torch.tool import (annotate_web, cluster_web, export,
                                        pick_web, xycut_web)
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a card")
    _, b = corpora
    page = str(b / (PAGE + ".png"))
    db = tmp_path / "a.db"
    lineload.AnnotationDB(db).add_line(page, "regions/TEXT/2/0", "x")
    calls = [
        (harmonize.main, ["default", "--test"]),
        (export.main, ["--db-path", str(db), "-o", str(tmp_path / "o")]),
        (sample.main, [str(b), "--db-path", str(db)]),
        (merge.main, [str(db), "--with-db", str(db)]),
        (pick.main, ["add", "--db-path", str(db), "--page", page, "--line",
                     "x"]),
        (annotate.main, ["stats", "--db-path", str(db)]),
        (annotate.main, ["export-image", "--db-path", str(db), "--page",
                         page, "--line", "regions/TEXT/2/0", "-o",
                         str(tmp_path / "l.png")]),
        (cluster.main, [str(b)]),
        (xycut.main, [page]),
        (runner.main, ["--host", "h", "--remote-dir", "/nowhere"]),
    ]
    for main, args in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _quiet(main, args)
    for make in (lambda: annotate_web.make_handler(str(db), 48),
                 lambda: pick_web.make_handler(str(db), [page], "reliable"),
                 lambda: xycut_web.make_handler([page], "reliable", 0.005),
                 lambda: lineload.load_line_image(page, "regions/TEXT/2/0"),
                 lambda: cluster_web.main([str(b), "--port", "0"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
