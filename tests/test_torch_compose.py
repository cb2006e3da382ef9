"""The port's compose stage and Page-XML writer against the JAX package.

Tolerances, each with its reason:
  * pagexml: the same XML bytes as the JAX writer's for the same calls,
    apart from the Metadata timestamps (the port serializes with its own
    writer of lxml's layout); the port's XML is valid under the vendored
    PAGE schema (origami_tpu/pagexml/pagecontent.xsd, checked with lxml
    here: the port has no lxml and keeps the structural checks only);
  * _line_sort_key and _rewarp: exactly JAX's (the same host code);
  * the stage on the JAX order.json and single-model ocr.zip: page.txt
    byte-equal, page.xml equal apart from the timestamps;
  * the chain lines -> order -> ocr (single) -> compose on one fixture
    page from the JAX contours.2.zip: page.txt lines identical to the
    JAX chain's on >= 99 %, CER <= 0.5 % (the OCR bar: the port's dewarp
    is hard-edged and its bf16 convolutions round otherwise, ROADMAP C2).
"""

import json
import zipfile
from pathlib import Path

import numpy as np
import pytest
from lxml import etree

import chip_smoke
from origami_tpu.batch.detect import compose as jax_compose
from origami_tpu.core.dewarp import Grid as JGrid
from origami_tpu.pagexml import pagexml as jax_pagexml
from origami_tpu_torch import geometry as G
from origami_tpu_torch.batch.detect import compose as stage
from origami_tpu_torch.batch.detect.lines import LineDetectionProcessor
from origami_tpu_torch.batch.detect.ocr import OCRProcessor
from origami_tpu_torch.batch.detect.order import ReadingOrderProcessor
from origami_tpu_torch.core.dewarp import Grid
from origami_tpu_torch.pagexml import pagexml

ROOT = Path(__file__).resolve().parent.parent
FULL = ROOT / "tests/data/torch_ocr/full"
COMPOSE = ROOT / "tests/data/torch_compose"
CPU = dict(device="cpu", lock_strategy="NONE", plain=True)


def _build(module, rng):
    """The same seeded calls on one package's writer."""
    doc = module.Page("page 1 & 2.png", (1312, 1920))
    ids = []
    for r in range(int(rng.integers(2, 6))):
        kind = ["TextRegion", "TableRegion", "GraphicRegion"][r % 3]
        rid = "r_regions_%s_%d" % (kind, r)
        reg = doc.append_region(kind, rid, region_type="paragraph")
        reg.append_coords(rng.uniform(-3, 1500, (int(rng.integers(3, 9)), 2)))
        ids.append(rid)
        if kind == "TextRegion":
            for k in range(int(rng.integers(0, 4))):
                tl = reg.append_text_line("l_%s_%d" % (rid, k))
                tl.append_coords(rng.uniform(0, 1500, (4, 2)))
                tl.append_baseline(rng.uniform(0, 1500, (2, 2)))
                tl.append_text_equiv(["a <b> & \"c\" é", "", "x\ny"][k % 3])
            reg.append_text_equiv("text\n<of> the & region",
                                  confidence=0.5 if r else None)
        elif kind == "TableRegion":
            cell = reg.append_table_cell(1, 2, cell_id=rid + "_c",
                                         row_span=1)
            cell.append_coords(rng.uniform(0, 99, (4, 2)))
            cell.append_text_equiv("cell")
    doc.append_reading_order(ids)
    return doc


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pagexml_matches_jax(seed):
    port = _build(pagexml, np.random.default_rng(seed))
    jax = _build(jax_pagexml, np.random.default_rng(seed))
    jax.validate()
    assert port.validate()
    got = port.tostring()
    untimed = chip_smoke.strip_xml_times
    assert untimed(got) == untimed(jax.tostring())
    assert jax_pagexml.xml_schema().validate(etree.fromstring(got))


def test_pagexml_structural_checks_match_jax():
    for module in (pagexml, jax_pagexml):
        for break_it in ("duplicate", "dangling", "degenerate"):
            doc = module.Page("p.png", (10, 10))
            reg = doc.append_region("TextRegion", "r1")
            reg.append_coords([(0, 0), (5, 0), (5, 5)] if break_it !=
                              "degenerate" else [(0, 0), (5, 0)])
            if break_it == "duplicate":
                doc.append_region("GraphicRegion", "r1").append_coords(
                    [(0, 0), (5, 0), (5, 5)])
            doc.append_reading_order(["r1", "r2"] if break_it == "dangling"
                                     else ["r1"])
            with pytest.raises(ValueError):
                doc.validate() if module is pagexml else \
                    doc.validate(xsd=False)


def test_line_sort_key_and_rewarp_match_jax():
    rng = np.random.default_rng(5)
    keys = [(str(int(rng.integers(0, 30))),) for _ in range(50)] + \
        [("%d.%d" % tuple(rng.integers(0, 9, 2)),) for _ in range(50)] + \
        [("x%d" % i,) for i in range(5)] + [("-3",)]
    assert sorted(keys, key=stage._line_sort_key) == \
        sorted(keys, key=jax_compose._line_sort_key)
    dewarp = FULL / "synth0001.out" / "dewarp.zip"
    shape = G.Polygon(rng.uniform(10, 1500, (12, 2))).convex_hull
    got = stage._rewarp(Grid.open(dewarp), shape)
    from origami_tpu import geometry as J
    want = jax_compose._rewarp(JGrid.open(dewarp), J.wkt.loads(shape.wkt))
    assert got.wkt == want.wkt


@pytest.mark.parametrize("xml", [False, True], ids=["text", "page_xml"])
def test_compose_stage_on_jax_inputs(tmp_path, xml):
    corpus = chip_smoke.compose_corpus(tmp_path / "corpus")
    stage.main(["--device", "cpu", "--lock-strategy", "NONE", "--plain",
                str(corpus)] + (["--page-xml"] if xml else []))
    ref = "compose_xml.zip" if xml else "compose.zip"
    for png in sorted(corpus.glob("*.png")):
        out = corpus / (png.stem + ".out")
        rt = json.loads((out / "runtime.json").read_text())
        assert rt[stage.STAGE_NAME]["status"] == "COMPLETED"
        with zipfile.ZipFile(out / "compose.zip") as a, \
                zipfile.ZipFile(COMPOSE / (png.stem + ".out") / ref) as b:
            assert a.namelist() == b.namelist()
            for name in b.namelist():
                assert chip_smoke.strip_xml_times(a.read(name)) == \
                    chip_smoke.strip_xml_times(b.read(name))


def test_chain_lines_order_ocr_compose_on_one_page(tmp_path):
    corpus = chip_smoke.lines_corpus(tmp_path / "corpus", ["synth0000"])
    for proc in (LineDetectionProcessor(dict(CPU)),
                 ReadingOrderProcessor(dict(CPU)),
                 OCRProcessor(dict(CPU, model=str(
                     ROOT / "models_pretrained" / "recognizer"))),
                 stage.ComposeProcessor(dict(CPU))):
        proc.traverse(str(corpus))
    rt = json.loads((corpus / "synth0000.out" / "runtime.json").read_text())
    assert sorted(v["status"] for v in rt.values()) == ["COMPLETED"] * 4
    same, n, errs, chars = chip_smoke.text_diff(
        chip_smoke.page_text(corpus / "synth0000.out" / "compose.zip"),
        chip_smoke.page_text(COMPOSE / "synth0000.out" / "compose.zip"))
    assert n > 100
    assert same / n >= chip_smoke.MIN_IDENTICAL
    assert errs / chars <= chip_smoke.MAX_CER
