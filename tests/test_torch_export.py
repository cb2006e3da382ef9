"""The export CLIs (origami_tpu_torch/batch/export) against the JAX
package's (origami_tpu/batch/export), on the CPU.

Tolerances, each with its reason:
  * export.lines: the same file names; each strip within 1 gray level of
    the JAX strip (strip mode (a) against the JAX banded route, which
    the fixture's flat lines keep within a level: ROADMAP C4), decoded
    with PIL from the port's own gray PNG encoder; with `--binarize
    sauvola` the same names, the pixels {0, 255} and >= 99.5 % of them
    equal (a strip a level off may cross Sauvola's threshold on an
    edge pixel; ROADMAP C10 for the sums);
  * export.pagexml: the JAX export's XML apart from its timestamps (the
    same host code and the writer of tests/test_torch_compose.py).
"""

import shutil
from pathlib import Path

import numpy as np
import PIL.Image
import pytest

import chip_smoke
from origami_tpu.batch.export.lines import LineExportProcessor as JaxLines
from origami_tpu.batch.export.pagexml import \
    PageXMLExportProcessor as JaxPageXML
from origami_tpu_torch.batch.export import lines, pagexml

ROOT = Path(__file__).resolve().parent.parent
SMALL = ROOT / "tests/data/torch_ocr/small"
FULL = ROOT / "tests/data/torch_ocr/full"
FLOW = ROOT / "tests/data/torch_flow"
OPTS = dict(lock_strategy="NONE", plain=True)


def _pngs(out):
    return {p.relative_to(out).as_posix(): np.asarray(PIL.Image.open(p))
            for p in sorted(out.rglob("*.png"))}


@pytest.mark.parametrize("binarize", ["", "sauvola"])
def test_export_lines_matches_jax(tmp_path, binarize, capsys):
    corpus = tmp_path / "corpus"
    shutil.copytree(SMALL, corpus, ignore=shutil.ignore_patterns("ref"))
    args = ["--device", "cpu", "--lock-strategy", "NONE", "--plain"]
    if binarize:
        args += ["--binarize", binarize]
    lines.main([str(corpus), "-o", str(tmp_path / "port")] + args)
    capsys.readouterr()
    JaxLines(dict(OPTS, output=str(tmp_path / "jax"),
                  binarize=binarize)).traverse(str(corpus))
    got, want = _pngs(tmp_path / "port"), _pngs(tmp_path / "jax")
    assert sorted(got) == sorted(want)
    assert len(got) >= 20
    assert all(n.startswith("synth0000/dw1-ds1-h48/") for n in got)
    equal = total = 0
    for name, w in want.items():
        g = got[name]
        assert g.dtype == w.dtype == np.uint8 and g.shape == w.shape, name
        if binarize:
            assert set(np.unique(g)) <= {0, 255}
            equal += int((g == w).sum())
            total += g.size
        else:
            assert np.abs(g.astype(int) - w.astype(int)).max() <= 1, name
    if binarize:
        assert equal >= 0.995 * total, equal / total


def test_export_pagexml_matches_jax(tmp_path):
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    for png in sorted(FULL.glob("*.png")):
        shutil.copy(png, corpus / png.name)
        out = corpus / (png.stem + ".out")
        out.mkdir()
        for name in ("contours.0.zip", "lines.0.zip", "runtime.json"):
            shutil.copy(FLOW / (png.stem + ".out") / name, out / name)
        shutil.copy(FULL / (png.stem + ".out") / "segment.zip", out)
    pagexml.main([str(corpus), "-o", str(tmp_path / "port"), "--device",
                  "cpu", "--lock-strategy", "NONE", "--plain"])
    JaxPageXML(dict(OPTS, output=str(tmp_path / "jax"))).traverse(
        str(corpus))
    for png in sorted(FULL.glob("*.png")):
        got = (tmp_path / "port" / (png.stem + ".xml")).read_bytes()
        want = (tmp_path / "jax" / (png.stem + ".xml")).read_bytes()
        assert b"<TextLine" in want
        assert chip_smoke.strip_xml_times(got) == \
            chip_smoke.strip_xml_times(want)


def test_export_entry_points_need_cuda_unless_told_cpu():
    import torch
    for mod in (lines, pagexml):
        assert mod.parser().parse_args(["x", "-o", "y"]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lines.LineExportProcessor(dict(output="y"))
