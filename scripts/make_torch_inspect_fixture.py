#!/usr/bin/env python3
"""Build tests/data/torch_inspect/: the JAX package's corpus-inspection
outputs, which chip_smoke.py phase 17 and tests/test_torch_annotate.py,
tests/test_torch_inspect_utils.py and tests/test_torch_host_helpers.py
hold the port to.

    JAX_PLATFORMS=cpu python scripts/make_torch_inspect_fixture.py

Runs the JAX package's processors on the CPU over chip_smoke's
inspect_corpus (the two fixture pages with the JAX artifacts the renders
read), captures each image where the JAX module saves it as a JPEG
(annotate's save_jpeg, PIL's JPEG save) and the file it writes, and
writes inspect.json:

    renders    for each page and render (annotate grid, flow, contours
               warped and reliable, lines, layout; utils.dewarp's page),
               by the JAX file's name: the canvas's shape, its label
               boxes (the port's annotate.utils.label_box at each
               cv2.putText origin), chip_smoke.masked_digest of the BGR
               canvas with the boxes set to 0, the sha256 of the JPEG
               file, the boxes grown to the MCU lattice and one MCU more
               (chip_smoke.mcu_box) and the masked digest of PIL's RGB
               decode of the file with the grown boxes set to 0; every
               pixel cv2.putText inks lies in its box
    thumbnail  the digest of utils.thumbnail's pixels (PIL's thumbnail)
               and the sha256 of its JPEG file
    signature  the digests of signature.zip's decoded PNGs and its
               signature.json text
    rtext      the digest of each region text utils.rtext writes
    skew       patch_skew_samples of the JAX binarized synth0000 (saved
               beside it as synth0000.binarized.png, 1-bit) at patches
               256 and 128

About 15 s on a CPU.
"""

from __future__ import annotations

import contextlib
import json
import shutil
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

OUT = ROOT / "tests" / "data" / "torch_inspect"
OPTIONS = dict(lock_strategy="NONE", plain=True, overwrite=True)
SKEW_PAGE = "synth0000"
# (JAX processor's module under origami_tpu.batch, class, options):
# chip_smoke.INSPECT_RENDERS' annotate renders, in its order
RENDERS = (
    ("annotate.grid", "AnnotateGridProcessor", {}),
    ("annotate.flow", "AnnotateFlowProcessor", {}),
    ("annotate.contours", "AnnotateContoursProcessor", {"stage": "warped"}),
    ("annotate.contours", "AnnotateContoursProcessor",
     {"stage": "reliable"}),
    ("annotate.lines", "AnnotateLinesProcessor", {}),
    ("annotate.layout", "AnnotateLayoutProcessor", {}),
)


def _jax(name):
    import importlib
    return importlib.import_module("origami_tpu.batch." + name)


@contextlib.contextmanager
def captured_renders():
    """{file name: {page stem: (BGR canvas, [(label, org)], JPEG bytes)}}
    of the JAX annotate renders run inside the block:
    annotate.utils.save_jpeg and cv2.putText are wrapped while it
    runs."""
    ju = _jax("annotate.utils")
    cv2 = ju.cv2
    saved, labels = {}, []
    real_save, real_put = ju.save_jpeg, cv2.putText

    def save(canvas, path):
        path = Path(path)
        real_save(canvas, path)
        saved.setdefault(path.name, {})[path.parent.name[:-4]] = (
            canvas.copy(), list(labels), path.read_bytes())
        labels.clear()

    def put(img, text, org, *args, **kw):
        labels.append((str(text), tuple(int(v) for v in org)))
        return real_put(img, text, org, *args, **kw)

    ju.save_jpeg, cv2.putText = save, put
    try:
        yield saved
    finally:
        ju.save_jpeg, cv2.putText = real_save, real_put


@contextlib.contextmanager
def captured_jpegs():
    """{file name: {page stem or file stem: (gray pixels, JPEG bytes)}}
    of the PIL images saved as JPEG files inside the block."""
    import PIL.Image
    saved = {}
    real = PIL.Image.Image.save

    def save(im, fp, format=None, **kw):
        out = real(im, fp, format, **kw)
        if format == "JPEG":
            p = Path(fp)
            key = p.parent.name[:-4] if p.parent.name.endswith(".out") \
                else p.name.split(".")[0]
            saved.setdefault(p.name, {})[key] = (np.asarray(im).copy(),
                                                 p.read_bytes())
        return out

    PIL.Image.Image.save = save
    try:
        yield saved
    finally:
        PIL.Image.Image.save = real


def label_boxes(labels):
    from origami_tpu_torch.batch.annotate.utils import label_box
    return [list(label_box(t, org)) for t, org in labels]


def ink_outside_boxes(shape, labels):
    """Pixels cv2.putText (FONT_HERSHEY_SIMPLEX, 0.6, thickness 2, as the
    JAX renders call it) inks outside the label's box, summed."""
    import cv2
    from origami_tpu_torch.batch.annotate.utils import label_box
    n = 0
    for text, org in labels:
        m = np.zeros(shape[:2], np.uint8)
        cv2.putText(m, text, org, cv2.FONT_HERSHEY_SIMPLEX, 0.6, 255, 2)
        x0, y0, x1, y1 = label_box(text, org)
        m[max(y0, 0):max(y1, 0), max(x0, 0):max(x1, 0)] = 0
        n += int(np.count_nonzero(m))
    return n


def jax_renders(corpus):
    """{file name: {stem: (canvas, labels, JPEG bytes)}} of the JAX
    renders."""
    with captured_renders() as saved:
        for mod, cls, extra in RENDERS:
            getattr(_jax(mod), cls)(dict(OPTIONS, **extra)) \
                .traverse(str(corpus))
    return saved


def jax_dewarped_and_thumbnails(corpus):
    """{"dewarped.jpg": {stem: (px, bytes)}, "thumbnail.jpg": {stem: (px,
    bytes)}} from the JAX utils.dewarp and utils.thumbnail."""
    with captured_jpegs() as saved:
        _jax("utils.dewarp").DewarpImageProcessor(dict(OPTIONS)) \
            .traverse(str(corpus))
        _jax("utils.thumbnail").ThumbnailProcessor(dict(OPTIONS)) \
            .traverse(str(corpus))
    return saved


def jax_signatures(corpus):
    _jax("utils.signature").SignatureProcessor(dict(OPTIONS)) \
        .traverse(str(corpus))
    return {p.stem: cs.signature_digests(
        corpus / (p.stem + ".out") / "signature.zip")
        for p in sorted(corpus.glob("*.png"))}


def jax_rtext(corpus, out):
    _jax("utils.rtext").RegionTextProcessor(dict(OPTIONS, output=str(out))) \
        .traverse(str(corpus))
    return {p.stem: cs.text_digests(out / p.stem)
            for p in sorted(corpus.glob("*.png"))}


def jax_binarized(png):
    from origami_tpu.core.page import Page
    return np.asarray(Page(png).binarized)


def jax_skew(mask, patch):
    from origami_tpu.core.flow import patch_skew_samples
    return cs.skew_rows(patch_skew_samples(mask, patch=patch))


def build(work):
    """inspect.json's content and the binarized page's PNG bytes."""
    import hashlib
    import io

    import PIL.Image
    from origami_tpu_torch.core import _png

    def sha(data):
        return hashlib.sha256(data).hexdigest()
    corpus = cs.inspect_corpus(work / "corpus")
    pages = sorted(p.stem for p in corpus.glob("*.png"))
    renders = {stem: {} for stem in pages}
    outside = 0
    for name, by_page in jax_renders(corpus).items():
        for stem, (canvas, labels, data) in by_page.items():
            boxes = label_boxes(labels)
            outside += ink_outside_boxes(canvas.shape, labels)
            grown = [list(cs.mcu_box(b)) for b in boxes]
            decoded = np.asarray(PIL.Image.open(io.BytesIO(data)))
            renders[stem][name] = dict(
                shape=list(canvas.shape), boxes=boxes,
                digest=cs.masked_digest(canvas, boxes), sha256=sha(data),
                grown=grown, decoded=cs.masked_digest(decoded, grown))
    if outside:
        raise SystemExit("cv2.putText inks %d pixels outside the label "
                         "boxes" % outside)
    images = jax_dewarped_and_thumbnails(corpus)
    for stem, (px, data) in images["dewarped.jpg"].items():
        renders[stem]["dewarped.jpg"] = dict(
            shape=list(px.shape), boxes=[], digest=cs.masked_digest(px),
            sha256=sha(data))
    sigs = jax_signatures(corpus)
    mask = jax_binarized(corpus / (SKEW_PAGE + ".png"))
    return dict(
        pages=pages, renders=renders,
        thumbnail={s: dict(digest=cs.digest(px), sha256=sha(data))
                   for s, (px, data) in images["thumbnail.jpg"].items()},
        signature={s: dict(png=p, json=j) for s, (p, j) in sigs.items()},
        rtext=jax_rtext(corpus, work / "rtext"),
        skew={"page": SKEW_PAGE, "mask": SKEW_PAGE + ".binarized.png",
              **{str(p): jax_skew(mask, p) for p in cs.SKEW_PATCHES}},
    ), _png.encode_bilevel(mask)


def main():
    work = Path(tempfile.mkdtemp(prefix="inspect_fixture_"))
    try:
        ref, mask_png = build(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / ref["skew"]["mask"]).write_bytes(mask_png)
    (OUT / "inspect.json").write_text(json.dumps(ref, indent=1) + "\n")
    print("wrote %s (%d renders)" % (OUT, sum(
        len(v) for v in ref["renders"].values())))


if __name__ == "__main__":
    main()
