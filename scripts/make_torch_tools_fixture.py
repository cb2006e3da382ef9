#!/usr/bin/env python3
"""Build tests/data/torch_tools/: the JAX package's operator tools on the
OCR fixture pages, which chip_smoke.py phase 20 and
tests/test_torch_tools.py and tests/test_torch_tool_web.py hold the port
to.

    JAX_PLATFORMS=cpu python scripts/make_torch_tools_fixture.py

Runs, on a copy of the two fixture pages with their reliable artifacts
(chip_smoke.tools_corpus), what phase 20a runs through the port: the
JAX tool.sample (seed 0, 2 lines a type), annotate set with seeded raw
texts (each line's text in the JAX OCR reference, its spacing and
punctuation roughened), two rows' split flags, harmonize default,
export at 48 px plain and with --binarize sauvola, annotate
export-image; then utils.signature and the four web tools, each on a
copy of that DB, driven through chip_smoke.web_routes. Writes tools.json:

    rows, schema, harmonized   the DB's rows after sampling (page paths
                               relative to the corpus), PRAGMA
                               table_info(lines), the rows after
                               harmonize
    raw_texts, splits          what phase 20a sets, by "page:line"
    export, export_bin         the exported names, .gt.txt texts and
                               sets.json
    web                        per tool, chip_smoke.web_record of each
                               response, the digests of the arrays the
                               tool hands PIL's encoder and the sha256
                               of each JPEG body, by route
    xycut, cluster             the xycut printout of each page and the
                               cluster -k 2 printout

    export_image               the name of the exported strip that
                               annotate export-image and annotate_web's
                               /strip equal

and strips.npz: strip/<name>, bin/<name> (the exported PNGs), each as
its row differences modulo 256. About 15 s on a CPU.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import random
import sys
import tempfile
import zipfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

OUT = ROOT / "tests" / "data" / "torch_tools"
SPACES = (" ", "  ", " \t ")
ENDINGS = ("", " .", "⸗", " ;", " ( a )", " 12 - 34", " 5 %")


def raw_texts(rows):
    """{"page:line": the JAX OCR reference's text of the line (or, for a
    line that reference skips, "Zeile" and its path's last part), joined
    by seeded runs of spaces, commas spaced, a seeded ending}."""
    rng = random.Random(7)
    out = {}
    for page, line, *_ in rows:
        stem = Path(page).stem
        with zipfile.ZipFile(cs.FIXTURE / "ref" /
                             (stem + ".single.ocr.zip")) as zf:
            name = line + ".txt"
            text = zf.read(name).decode("utf8") \
                if name in zf.namelist() else \
                "Zeile, %s" % line.rsplit("/", 1)[-1]
        words = text.split()
        text = words[0] if words else ""
        for w in words[1:]:
            text += rng.choice(SPACES) + w
        out[page + ":" + line] = text.replace(",", " ,") \
            + rng.choice(ENDINGS)
    return out


def click(cmd, args):
    """A JAX click command's main on args, its printout captured."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cmd.main([str(a) for a in args], standalone_mode=False)
    return buf.getvalue()


def read_pngs(folder):
    import PIL.Image
    return {p.stem: np.asarray(PIL.Image.open(p))
            for p in sorted(folder.glob("*.png"))}


@contextlib.contextmanager
def encoded_arrays(seen):
    """Record np.asarray of every PIL image saved meanwhile."""
    import PIL.Image
    save = PIL.Image.Image.save

    def recording(self, *a, **kw):
        seen.append(np.asarray(self))
        return save(self, *a, **kw)

    PIL.Image.Image.save = recording
    try:
        yield
    finally:
        PIL.Image.Image.save = save


def jax_chain(corpus, work):
    """The JAX side of phase 20a -> (ref entries, strips)."""
    from origami_tpu.tool import annotate, export, harmonize
    from origami_tpu.tool.lineload import AnnotationDB
    from origami_tpu.tool.sample import SampleLinesProcessor
    db = work / "annotations.db"
    with contextlib.redirect_stdout(io.StringIO()):
        SampleLinesProcessor(dict(
            db_path=str(db), per_type=cs.TOOLS_PER_TYPE,
            seed=cs.TOOLS_SEED, plain=True)).traverse(str(corpus))
    ref = dict(rows=cs.db_rows(db, corpus), schema=cs.db_schema(db))
    ref["raw_texts"] = raw_texts(ref["rows"])
    keys = [r[0] + ":" + r[1] for r in ref["rows"]]
    ref["splits"] = {keys[0]: [0, 1], keys[1]: [1, 0]}
    for key, text in ref["raw_texts"].items():
        page, line = key.split(":")
        click(annotate.annotate, ["set", "--db-path", db, "--page",
                                  corpus / page, "--line", line, "--text",
                                  text])
    for key, (training, validation) in ref["splits"].items():
        page, line = key.split(":")
        AnnotationDB(db).set_split(corpus / page, line, training,
                                   validation)
    click(harmonize.harmonize, ["default", "--db-path", db])
    ref["harmonized"] = cs.db_rows(db, corpus)
    strips = {}
    for name, extra, prefix in (
            ("export", [], "strip/"),
            ("export_bin", ["--binarize", cs.TOOLS_BINARIZE], "bin/")):
        click(export.export, ["--db-path", db, "-o", work / name,
                              "--line-height", cs.TOOLS_HEIGHT] + extra)
        names, texts, sets = cs.exported(work / name)
        ref[name] = dict(names=names, texts=texts, sets=sets)
        strips.update({prefix + k: v
                       for k, v in read_pngs(work / name).items()})
    page, line = ref["rows"][0][:2]
    click(annotate.annotate, ["export-image", "--db-path", db, "--page",
                              corpus / page, "--line", line, "-o",
                              work / "line.png", "--line-height",
                              cs.TOOLS_HEIGHT])
    ref["export_image"] = Path(page).stem + "-" + line.replace("/", "-")
    assert np.array_equal(read_pngs(work)["line"],
                          strips["strip/" + ref["export_image"]])
    return ref, strips, db


def jax_web(corpus, db, ref, strips):
    """The JAX web tools through chip_smoke.web_routes."""
    from origami_tpu.batch.utils.signature import SignatureProcessor
    from origami_tpu.tool import annotate_web, cluster_web, pick_web, \
        xycut_web
    with contextlib.redirect_stdout(io.StringIO()):
        SignatureProcessor(dict(lock_strategy="NONE", plain=True)) \
            .traverse(str(corpus))
    pages = cs.tools_pages(corpus)
    line = (str(corpus / ref["rows"][0][0]), ref["rows"][0][1])
    handlers = {
        "annotate_web": lambda db: annotate_web.make_handler(
            str(db), cs.TOOLS_HEIGHT),
        "pick_web": lambda db: pick_web.make_handler(
            str(db), pages, "reliable"),
        "cluster_web": lambda db: cluster_web.make_handler(
            cluster_web.compute_clusters(corpus, 8)),
        "xycut_web": lambda db: xycut_web.make_handler(
            pages, "reliable", 0.005),
    }
    assert tuple(handlers) == cs.WEB_TOOLS
    ref["web"] = {}
    for tool, make in handlers.items():
        routes = cs.web_routes(tool, corpus, line)
        seen, by_route = [], {}

        def collect(i):
            if seen:
                by_route[i] = seen[-1]
            seen.clear()

        with encoded_arrays(seen):
            got = cs.drive_web(make(cs.tool_db(db.parent, db, tool)),
                               routes, collect)
        images, bodies = {}, {}
        for i, (_, ctype, body) in enumerate(got):
            if ctype == "image/jpeg":
                bodies[str(i)] = hashlib.sha256(body).hexdigest()
        for i, px in by_route.items():
            if tool == "annotate_web":
                # the strip of the line that export wrote
                images[str(i)] = ref["export_image"]
                assert np.array_equal(px, strips["strip/" + images[str(i)]])
            else:
                images[str(i)] = cs.digest(px)
        ref["web"][tool] = dict(records=cs.web_record(got, corpus),
                                images=images, bodies=bodies)


def jax_printouts(corpus, ref):
    from origami_tpu.tool.cluster import cluster
    from origami_tpu.tool.xycut import xycut_debug
    ref["xycut"] = {p.stem: click(xycut_debug, [p])
                    for p in cs.tools_pages(corpus)}
    ref["cluster"] = cs.placeholder(
        click(cluster, [corpus, "-k", 2]), corpus)


def build(work):
    corpus = cs.tools_corpus(work / "corpus")
    ref, strips, db = jax_chain(corpus, work)
    jax_web(corpus, db, ref, strips)
    jax_printouts(corpus, ref)
    return ref, strips


def main():
    with tempfile.TemporaryDirectory() as t:
        ref, strips = build(Path(t))
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "tools.json").write_text(json.dumps(ref, indent=1,
                                               ensure_ascii=False) + "\n")
    # row differences modulo 256 (chip_smoke.tools_strips sums them)
    np.savez_compressed(OUT / "strips.npz", **{
        k: np.diff(v, axis=0, prepend=np.uint8(0)) for k, v in strips.items()})
    print("wrote %s: %d rows, %d strips" % (OUT, len(ref["rows"]),
                                            len(strips)))


if __name__ == "__main__":
    main()
