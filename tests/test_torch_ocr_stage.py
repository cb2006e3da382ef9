"""The port's OCR stage end to end on the CPU against the JAX stage.

`python -m origami_tpu_torch.batch.detect.ocr --device cpu` (called
in-process through its `main`) on a copy of the `small` fixture — one
synthetic page trimmed to 24 lines that the JAX chain carried up to
`order` (scripts/make_torch_ocr_fixture.py) — with the real
models_pretrained weights in the default numeric mode (bf16
convolutions, f32 LSTM), compared with the ocr.zip the JAX stage wrote.

Tolerance: at most one line per run may differ and the CER over all
lines must stay <= 1 %: bf16 convolutions round at other places in
PyTorch and XLA, which can flip a low-margin frame of the CTC path; the
differing lines are printed.
"""

import json
import shutil
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

from origami_tpu_torch.batch.detect import ocr

ROOT = Path(__file__).resolve().parent.parent
SMALL = ROOT / "tests/data/torch_ocr/small"
MODES = {
    "single": ["-m", str(ROOT / "models_pretrained/recognizer")],
    "ensemble": ["-m", str(ROOT / "models_pretrained")],
    "gather": ["-m", str(ROOT / "models_pretrained/recognizer"),
               "--extract-mode", "gather"],
    "binarize": ["-m", str(ROOT / "models_pretrained/recognizer"),
                 "--binarize", "sauvola"],
}


def _read(path):
    with zipfile.ZipFile(path) as zf:
        return {n: zf.read(n).decode("utf8") for n in zf.namelist()}


def _levenshtein(a, b):
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


@pytest.mark.parametrize("mode", list(MODES))
def test_ocr_cli_matches_jax_reference(tmp_path, mode, capsys):
    corpus = tmp_path / "corpus"
    shutil.copytree(SMALL, corpus, ignore=shutil.ignore_patterns("ref"))
    ocr.main(MODES[mode] + ["--device", "cpu", "--lock-strategy", "NONE",
                            "--plain", str(corpus)])
    launches = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    # on the CPU the wrappers run the plain versions: no kernel launched
    assert set(launches["kernel_launches"].values()) == {0}
    pages = sorted(corpus.glob("*.png"))
    assert pages
    n = differ = errs = chars = 0
    for png in pages:
        out = corpus / (png.stem + ".out")
        rt = json.loads((out / "runtime.json").read_text())
        assert rt[ocr.STAGE_NAME]["status"] == "COMPLETED", rt
        got = _read(out / "ocr.zip")
        ref = _read(SMALL / "ref" / ("%s.%s.ocr.zip" % (png.stem, mode)))
        assert set(got) == set(ref)
        assert rt[ocr.STAGE_NAME]["n_lines"] == len(ref)
        for k, t in sorted(ref.items()):
            n += 1
            errs += _levenshtein(got[k], t)
            chars += len(t)
            if got[k] != t:
                differ += 1
                print("%s %s: port %r, JAX %r" % (mode, k, got[k], t))
    assert n >= 24
    assert differ <= 1
    assert errs / chars <= 0.01


def test_second_run_finds_nothing_to_process(tmp_path, capsys):
    corpus = tmp_path / "corpus"
    shutil.copytree(SMALL, corpus, ignore=shutil.ignore_patterns("ref"))
    args = ["-m", "FAKE", "--device", "cpu", "--lock-strategy", "NONE",
            str(corpus)]
    ocr.main(args)
    names = _read(next(corpus.glob("*.out")) / "ocr.zip")
    assert all(t.startswith("text for ") for t in names.values())
    capsys.readouterr()
    ocr.main(args)
    assert "nothing to process" in capsys.readouterr().out


def test_processor_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        ocr.OCRProcessor(dict(model="FAKE"))
    with pytest.raises(RuntimeError, match="CUDA"):
        ocr.main(["-m", "FAKE", str(SMALL)])
    # an explicit CPU device is the only way onto the CPU
    assert ocr.OCRProcessor(dict(model="FAKE", device="cpu")).device \
        == torch.device("cpu")


def test_page_and_reader_without_device_need_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from origami_tpu_torch.batch.core.io import Artifact, Input, Stage
    from origami_tpu_torch.core.page import Page
    png = next(SMALL.glob("*.png"))
    with pytest.raises(RuntimeError, match="CUDA"):
        Page(png)
    reader = Input(Artifact.LINES, stage=Stage.RELIABLE).instantiate(png)
    with pytest.raises(RuntimeError, match="CUDA"):
        reader.page
    reader = Input(Artifact.LINES, stage=Stage.RELIABLE).instantiate(
        png, device="cpu")
    assert reader.page.device == torch.device("cpu")
    assert Page(png, device="cpu").device_pixels.device.type == "cpu"


@pytest.mark.parametrize("spec", ["sauvola", "sauvola(window_size=16)",
                                  "otsu"])
def test_binarized_strips_match_jax_from_string(spec):
    """The --binarize host path's strips: the port's extractor binarizes
    each strip with its from_string; on the same strips JAX's from_string
    (the XLA ops/binarize functions) gives the same pixels but where its
    float32 integral images round a Sauvola sum (a few pixels a page:
    ROADMAP C10). An even window takes the XLA route's odd box."""
    from origami_tpu.core.binarize import from_string as jax_from_string
    from origami_tpu_torch.batch.core.io import Artifact, Input, Stage
    from origami_tpu_torch.batch.core.lines import LineExtractor
    png = SMALL / "synth0000.png"
    reader = Input(Artifact.LINES, Artifact.TABLES,
                   stage=Stage.RELIABLE).instantiate(png, device="cpu")
    opts = {"binarize": spec, "device": "cpu"}
    ext = LineExtractor(reader.tables, 48, opts,
                        min_confidence=reader.lines.min_confidence,
                        max_width=2048)
    plain = LineExtractor(reader.tables, 48, {"device": "cpu"},
                          min_confidence=reader.lines.min_confidence,
                          max_width=2048)
    assert plain.binarizer is None and ext.binarizer is not None
    # the first 8 of the page's 24 lines: the plain Sauvola takes about
    # 0.2 s a strip on the CPU
    parts = ext.parts(reader.lines.by_path)[:8]
    got = ext.extract(parts)
    strips = plain.extract(parts)
    assert [p for p, _ in got] == [p for p, _ in strips]
    assert len(got) == 8
    jax_fn = jax_from_string(spec)
    differ = total = 0
    for (_, b), (_, s) in zip(got, strips):
        want = jax_fn(s)
        assert b.dtype == want.dtype == np.uint8 and b.shape == want.shape
        assert set(np.unique(b)) <= {0, 255}
        differ += int((b != want).sum())
        total += b.size
    assert differ <= 1e-5 * total, (differ, total)
