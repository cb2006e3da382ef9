"""The port's PipelinedRunner against the JAX runner's contract.

Checks, each exact: corpus_pages lists the same pages in the same order
as the JAX corpus_pages; the nine port stages through the runner, in
waves of one page so that segment, the host stages and ocr + compose of
neighbouring pages overlap, complete every stage on both fixture pages
(the model-free `-m heuristic` segmenter and the FAKE recognizer keep
this CPU run short; chip_smoke.py's phase 12 drives the students and the
recognizer on the card), and the "*" order ranks every region of
contours.3.zip that the order stage ranks; a stage that raises in a side
thread is raised again by run().
"""

import json
import shutil
from pathlib import Path

import pytest

import chip_smoke
from origami_tpu.batch.runner import corpus_pages as jax_corpus_pages
from origami_tpu_torch.batch.detect.ocr import OCRProcessor
from origami_tpu_torch.batch.runner import PipelinedRunner, corpus_pages

ROOT = Path(__file__).resolve().parent.parent
FULL = ROOT / "tests/data/torch_ocr/full"


def test_corpus_pages_match_jax(tmp_path):
    for rel in ("b/2.png", "b/1.jpg", "a.png", "a.out/x.png", "c/d/e.tif",
                "notes.txt", "z.PNG"):
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_bytes(b"")
    got = corpus_pages(tmp_path)
    assert got == jax_corpus_pages(tmp_path) and len(got) == 5


def test_whole_chain_through_runner_on_cpu(tmp_path):
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    for png in sorted(FULL.glob("*.png")):
        shutil.copy(png, corpus / png.name)
    stages = chip_smoke.chain_stages("cpu", "heuristic", "banded")
    assert [n for n, _ in stages] == [
        "segment", "contours", "flow", "dewarp", "layout", "lines", "order",
        "ocr", "compose"]
    stages[7] = ("ocr", OCRProcessor(dict(
        device="cpu", lock_strategy="NONE", plain=True, model="FAKE")))
    PipelinedRunner(stages, wave_size=1).run(corpus)
    for png in sorted(corpus.glob("*.png")):
        out = corpus / (png.stem + ".out")
        rt = json.loads((out / "runtime.json").read_text())
        assert {chip_smoke.STAGE_KEYS[n] for n, _ in stages} == set(rt)
        assert {v["status"] for v in rt.values()} == {"COMPLETED"}, rt
        assert chip_smoke.unordered_regions(out) == []
        assert chip_smoke.page_text(out / "compose.zip")


class _Raises:
    def traverse(self, pages):
        raise RuntimeError("stage failed")


class _Records:
    def __init__(self):
        self.seen = []

    def traverse(self, pages):
        self.seen.append(list(pages))


def test_runner_raises_a_side_thread_failure(tmp_path):
    for name in ("p1.png", "p2.png"):
        (tmp_path / name).write_bytes(b"")
    seg = _Records()
    with pytest.raises(RuntimeError, match="stage failed"):
        PipelinedRunner([("segment", seg), ("ocr", _Raises())],
                        wave_size=1).run(tmp_path)
    assert seg.seen[0] == [tmp_path / "p1.png"]
    with pytest.raises(ValueError):
        PipelinedRunner([("segment", seg)])
