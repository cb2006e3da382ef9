"""Build the page-format fixture that the PyTorch port's image readers are
held against (chip_smoke.py phase 21), with PIL and the JAX package on
the CPU:

    tests/data/torch_formats/files/<case>.<ext>   every case of
        tests/test_torch_image_formats.py (seeded, small: JPEG qualities,
        samplings, restarts, progressive and truncated progressive files,
        TIFF compressions, fill orders, tiles, byte orders, BMP depths and
        RLE, PNG depths and Adam7), and the kinds that must raise
    tests/data/torch_formats/pages/synth000{0,1}.jpg   the two pages of
        tests/data/torch_ocr/full as baseline gray JPEG (quality PAGE_Q),
        synth0000.progressive.jpg, synth0001.g4.tif (the page > 128)
    tests/data/torch_formats/manifest.json   {path: {"size": PIL's
        .size, "sha256": of PIL's convert("L") bytes} or {"raises": a
        word of the ValueError}}
    tests/data/torch_formats/chain/synth000{0,1}.out/compose.zip   the
        JAX chain on the two JPEG pages: the students (target quality)
        up to order as scripts/make_torch_ocr_fixture.py runs them, the
        OCR stage with models_pretrained/recognizer, compose

    JAX_PLATFORMS=cpu python scripts/make_torch_formats_fixture.py [--only files,chain]

`files` takes seconds, `chain` a few minutes.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import sys
import tempfile
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("ORIGAMI_TPU_PLATFORM", "cpu")

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))
sys.path.insert(0, str(ROOT / "scripts"))

OUT = ROOT / "tests" / "data" / "torch_formats"
PAGES = ROOT / "tests" / "data" / "torch_ocr" / "full"
STEMS = ("synth0000", "synth0001")
PAGE_Q = 40          # keeps the fixture under 1.5 MB


def pil_entry(path):
    import numpy as np
    import PIL.Image
    with PIL.Image.open(path) as im:
        size = list(im.size)
        px = np.ascontiguousarray(np.asarray(im.convert("L")))
    return {"size": size, "sha256": hashlib.sha256(px.tobytes()).hexdigest()}


def write_files(out):
    """The small cases, the unsupported kinds and the pages; the
    manifest. -> manifest."""
    import numpy as np
    import PIL.Image
    import test_torch_image_formats as cases
    files = out / "files"
    pages = out / "pages"
    for d in (files, pages):
        if d.exists():
            shutil.rmtree(d)
        d.mkdir(parents=True)
    manifest = {}
    for name, (suffix, make) in sorted(cases.CASES.items()):
        path = files / ("%s.%s" % (name, suffix))
        path.write_bytes(make())
        manifest[str(path.relative_to(out))] = pil_entry(path)
    for name, (suffix, make, word) in sorted(cases.UNSUPPORTED.items()):
        path = files / ("%s.%s" % (name.replace(" ", "-"), suffix))
        path.write_bytes(make())
        manifest[str(path.relative_to(out))] = {"raises": word}
    for stem in STEMS:
        page = PIL.Image.open(PAGES / (stem + ".png")).convert("L")
        page.save(pages / (stem + ".jpg"), "JPEG", quality=PAGE_Q)
    page = PIL.Image.open(PAGES / (STEMS[0] + ".png")).convert("L")
    page.save(pages / (STEMS[0] + ".progressive.jpg"), "JPEG",
              quality=PAGE_Q, progressive=True)
    page = np.asarray(PIL.Image.open(PAGES / (STEMS[1] + ".png")))
    PIL.Image.fromarray(page > 128).save(pages / (STEMS[1] + ".g4.tif"),
                                         "TIFF", compression="group4")
    for path in sorted(pages.iterdir()):
        manifest[str(path.relative_to(out))] = pil_entry(path)
    (out / "manifest.json").write_text(json.dumps(manifest, indent=1,
                                                  sort_keys=True))
    return manifest


def run_chain(out):
    """The JAX chain on the two JPEG pages; keeps each compose.zip."""
    from make_torch_ocr_fixture import run_to_order
    from origami_tpu.batch.detect.compose import ComposeProcessor
    from origami_tpu.batch.detect.ocr import OCRProcessor
    opts = dict(lock_strategy="NONE", plain=True)
    chain = out / "chain"
    if chain.exists():
        shutil.rmtree(chain)
    with tempfile.TemporaryDirectory() as tmp:
        corpus = Path(tmp) / "corpus"
        corpus.mkdir()
        for stem in STEMS:
            shutil.copy(out / "pages" / (stem + ".jpg"), corpus)
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
            shutil.copy(src / "compose.zip", chain / (stem + ".out"))
            print(stem, "stages", sorted(rt))


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
        run_chain(OUT)
    total = sum(p.stat().st_size for p in OUT.rglob("*") if p.is_file())
    print("tests/data/torch_formats: %d bytes" % total)


if __name__ == "__main__":
    main()
