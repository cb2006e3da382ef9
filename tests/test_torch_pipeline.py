"""The whole slice: the port's PagePipeline (origami_tpu_torch/pipeline.py,
the nine port stages in one call) against the JAX package's
(origami_tpu/pipeline.py), both with the heuristic segmenter and the FAKE
recognizer on the CPU, on tests/conftest.py's synthetic page and on a
fixture page.

Tolerance: `text` byte-equal; the keys of `regions`, `lines` and
`tables` equal; `order` equal; `page_xml` the same elements, ids and
texts apart from its timestamps, and its polygons (Coords rings, as
point sets: where a ring starts is left out) equal on every ring of the
synthetic page and on all but 1 % of the fixture page's. The heuristic
label maps are equal on every pixel on these pages, and every stage
after them is host code with the JAX package's arithmetic, but the
dewarp grid is float32 summed in another order (within 2e-6 px): a
contour vertex the grid carries to 89.9999992 in JAX lands on 90.0 in
the port, so a hull or rectangle may start its ring at another vertex,
or keep a vertex at a corner that JAX's drops (4 rings of synth0001;
ROADMAP C2). Overlapped (segmentation in a thread) and sequential runs
give the same result.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from origami_tpu.pipeline import PagePipeline as JaxPagePipeline
from origami_tpu_torch import pipeline
from origami_tpu_torch.core import _png

ROOT = Path(__file__).resolve().parent.parent
FULL = ROOT / "tests/data/torch_ocr/full"


@pytest.fixture(scope="module")
def pages(synthetic_page):
    return {"synthetic": np.asarray(synthetic_page),
            "synth0001": _png.read_gray(FULL / "synth0001.png")}


@pytest.fixture(scope="module")
def jax_results(pages):
    pipe = JaxPagePipeline(segmentation_model="heuristic", ocr_model="FAKE",
                           page_xml=True)
    return {name: pipe.process_batch([img], names=[name], overlap=False)[0]
            for name, img in pages.items()}


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("name", ["synthetic", "synth0001"])
def test_page_pipeline_matches_jax(name, overlap, pages, jax_results):
    pipe = pipeline.PagePipeline(segmentation_model="heuristic",
                                 ocr_model="FAKE", page_xml=True,
                                 device="cpu")
    got = pipe.process_batch([pages[name]], names=[name],
                             overlap=overlap)[0]
    want = jax_results[name]
    assert want.text and want.regions and want.lines and want.order
    assert got.text == want.text
    assert sorted(got.regions) == sorted(want.regions)
    assert sorted(got.lines) == sorted(want.lines)
    assert sorted(got.tables) == sorted(want.tables)
    assert got.order == want.order
    g_xml, g_rings = _split_xml(got.page_xml)
    w_xml, w_rings = _split_xml(want.page_xml)
    assert g_xml == w_xml
    assert len(g_rings) == len(w_rings) > 10
    differ = sum(a != b for a, b in zip(g_rings, w_rings))
    assert differ <= (0 if name == "synthetic" else 0.01 * len(w_rings))
    assert got.artifacts_dir is None


def _split_xml(xml):
    """(Page-XML without its timestamps and point lists, each Coords
    ring as a sorted point list)."""
    xml = chip_smoke.strip_xml_times(xml)
    rings = [sorted(m.split(b" ")) for m in
             re.findall(rb'<Coords points="([^"]*)"/>', xml)]
    return re.sub(rb'points="[^"]*"', b'points=""', xml), rings


def test_pipeline_cli_reads_png_only(tmp_path, capsys, synthetic_page):
    png = tmp_path / "page.png"
    _png.write_gray(png, np.asarray(synthetic_page))
    xml = tmp_path / "page.xml"
    pipeline.main([str(png), "--device", "cpu", "--xml", str(xml)])
    out = capsys.readouterr().out
    assert "text for" in out and xml.read_bytes().startswith(b"<?xml")
    other = tmp_path / "page.jpg"
    other.write_bytes(b"\xff\xd8\xff\xe0 not a png")
    with pytest.raises(ValueError):
        pipeline.main([str(other), "--device", "cpu"])


def test_pipeline_needs_cuda_unless_told_cpu(synthetic_page):
    assert pipeline.parser().parse_args(["x.png"]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.PagePipeline().process(np.asarray(synthetic_page))
