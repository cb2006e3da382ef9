"""The port's segment stage (`python -m
origami_tpu_torch.batch.detect.segment --device cpu`) against the JAX
stage, on the CPU.

Tolerances: label maps >= 99.9 % of pixels equal, for the heuristic
segmenter against the JAX stage run here (exact Sauvola sums against
float32 integral images) and for the full-width students in float32
against the stored JAX float32 reference
(scripts/make_torch_segment_fixture.py; convolutions sum in another
order); class dicts and runtime.json entries equal.
"""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest

from origami_tpu.batch.detect.contours import ContoursProcessor
from origami_tpu.batch.detect.segment import \
    SegmentationProcessor as JaxSegmentationProcessor
from origami_tpu.core.segment import Segmentation as JaxSegmentation
from origami_tpu_torch.batch.detect import segment as stage
from origami_tpu_torch.core.page import Page
from origami_tpu_torch.core.segment import Segmentation
from origami_tpu_torch.ops import binarize

ROOT = Path(__file__).resolve().parent.parent
SMALL = ROOT / "tests/data/torch_ocr/small"
FULL = ROOT / "tests/data/torch_ocr/full"
REF = ROOT / "tests/data/torch_segment/ref"
COMMON = ["--device", "cpu", "--lock-strategy", "NONE", "--plain"]


def corpus_of(src, dst, names=None):
    dst.mkdir()
    for png in sorted(src.glob("*.png")):
        if names is None or png.stem in names:
            shutil.copy(png, dst / png.name)
    return dst


def runtime(corpus, stem, key=stage.STAGE_NAME):
    return json.loads(
        (corpus / (stem + ".out") / "runtime.json").read_text())[key]


def assert_close(port_zip, jax_seg, min_equal=0.999):
    got = JaxSegmentation.open(port_zip)    # the JAX reader takes it
    assert [p.name for p in got.predictions] == ["regions", "separators"]
    for pa in got.predictions:
        pb = jax_seg.by_name(pa.name)
        assert pa.type == pb.type
        assert pa.classes.as_dict() == pb.classes.as_dict()
        assert pa.labels.shape == pb.labels.shape
        assert (pa.labels == pb.labels).mean() >= min_equal, pa.name


def test_heuristic_stage_matches_jax_and_feeds_contours(tmp_path, capsys):
    port = corpus_of(SMALL, tmp_path / "port")
    ref = corpus_of(SMALL, tmp_path / "jax")
    stage.main(["-m", "heuristic", *COMMON, str(port)])
    out = capsys.readouterr().out.strip().splitlines()
    # on the CPU the wrappers run their plain versions: no launches
    assert json.loads(out[-1]) == {"kernel_launches": {
        "sauvola": 0, "sauvola_packed": 0}}
    JaxSegmentationProcessor("heuristic", dict(
        lock_strategy="NONE", plain=True)).traverse(str(ref))
    assert runtime(port, "synth0000")["status"] == "COMPLETED"
    assert runtime(ref, "synth0000")["status"] == "COMPLETED"
    assert_close(port / "synth0000.out/segment.zip",
                 JaxSegmentation.open(ref / "synth0000.out/segment.zip"))
    # the stage left the page's Sauvola mask in the process-wide LRU
    launches = dict(binarize.launches)
    assert Page(port / "synth0000.png", device="cpu").binarized.shape \
        == (1920, 1312)
    assert binarize.launches == launches
    # the next JAX stage accepts the port's segment.zip
    ContoursProcessor(dict(lock_strategy="NONE", plain=True)) \
        .traverse(str(port))
    entry = runtime(port, "synth0000", "origami_tpu.batch.detect.contours")
    assert entry["status"] == "COMPLETED", entry
    assert (port / "synth0000.out/contours.0.zip").exists()
    # a second run finds nothing to do
    capsys.readouterr()
    stage.main(["-m", "heuristic", *COMMON, str(port)])
    assert "[1/1]" not in capsys.readouterr().out


def test_students_full_width_f32_match_stored_jax_reference(tmp_path):
    corpus = corpus_of(FULL, tmp_path / "c", names={"synth0001"})
    stage.main(["-m", str(ROOT / "models_pretrained/students"),
                "--dtype", "float32", *COMMON, str(corpus)])
    assert runtime(corpus, "synth0001")["status"] == "COMPLETED"
    assert_close(corpus / "synth0001.out/segment.zip",
                 JaxSegmentation.open(REF / "synth0001.f32.segment.zip"))
    seg = Segmentation.open(corpus / "synth0001.out/segment.zip")
    # 1920x1312 pads to 1920x1344; the 2432x1280 canvas crops to 1250
    assert seg.size == (1250, 2432)
    assert 0.05 < seg.by_name("regions").class_mask("TEXT").mean() < 0.95


def test_heuristic_matches_stored_reference_on_fixture_page(tmp_path):
    corpus = corpus_of(FULL, tmp_path / "c", names={"synth0001"})
    stage.SegmentationProcessor("heuristic", dict(
        device="cpu", lock_strategy="NONE", plain=True)).traverse(
        str(corpus))
    assert_close(corpus / "synth0001.out/segment.zip", JaxSegmentation.open(
        REF / "synth0001.heuristic.segment.zip"))


def test_failed_batch_is_recorded_and_auto_is_not_ported(tmp_path):
    corpus = corpus_of(SMALL, tmp_path / "c")
    (tmp_path / "empty").mkdir()
    stage.main(["-m", str(tmp_path / "empty"), *COMMON, str(corpus)])
    entry = runtime(corpus, "synth0000")
    assert entry["status"] == "FAILED"
    assert "FileNotFoundError" in entry["traceback"]
    assert not (corpus / "synth0000.out/segment.zip").exists()
    with pytest.raises(NotImplementedError, match="auto"):
        stage.main(["-m", "auto:" + str(tmp_path), *COMMON, str(corpus)])
    with pytest.raises(SystemExit):
        stage.main(["-m", "heuristic", *COMMON, str(tmp_path / "missing")])


def test_preload_feeds_batches_in_order(tmp_path):
    """Three pages in batches of two: every page is preloaded once on
    the pool and arrives with its own batch."""
    corpus = tmp_path / "c"
    corpus.mkdir()
    src = SMALL / "synth0000.png"
    for name in ("a", "b", "c"):
        shutil.copy(src, corpus / (name + ".png"))
    seen = []

    class Probe(stage.SegmentationProcessor):
        def preload(self, page_path):
            return Path(page_path).stem

        def process_batch(self, pages):
            seen.append([kw["_preloaded"] for _, kw in pages])
            return {}

    Probe("heuristic", dict(device="cpu", lock_strategy="NONE", plain=True,
                            batch_size=2)).traverse(str(corpus))
    assert seen == [["a", "b"], ["c"]]
    assert runtime(corpus, "c")["status"] == "COMPLETED"
