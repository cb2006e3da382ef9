"""The port's line modules against the JAX package: line extraction
(artifact readers, table rewriting, strip frames, width buckets and the
p1/p2/gather partition) on the fixture pages, and the lines stage
(TableRegionCombinator, reliable_contours, the Line confidence members,
ConfidenceSampler and the stage itself).

Tolerances, each with its reason:
  * paths, columns, widths and groups: none; frames agree to float32
    rounding (1e-4 px) — both build them in float64 and round once;
  * TableRegionCombinator, reliable_contours, the Line confidence members
    and the sample grid: exactly the JAX results (the same host code and
    geometry in the same order);
  * ConfidenceSampler's evidence: exactly JAX's (the same float64 grid
    inversion and nearest samples);
  * the stage on the JAX inputs of the same run: contours.3.zip with the
    JAX keys and vertex counts within 0.01 px, lines.3.zip with the same
    keys and meta.json, frames within 0.5 px and evidence within 1e-3
    (chip_smoke.py's phase 11 bars: lines follow the Sauvola mask of the
    dewarped page, whose exact integer sums may set a few pixels
    otherwise than JAX's float32 integral images). On the fixture page
    every entry comes out byte-equal.
"""

import json
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from origami_tpu import geometry as J
from origami_tpu.batch.core import lines as jax_lines
from origami_tpu.batch.core import utils as jax_utils
from origami_tpu.batch.detect.lines import ConfidenceSampler as \
    JConfidenceSampler
from origami_tpu.core.block import Line as JLine
from origami_tpu_torch import geometry as G
from origami_tpu_torch.batch.core import lines as port_lines
from origami_tpu_torch.batch.core import utils as port_utils
from origami_tpu_torch.batch.detect import lines as stage
from origami_tpu_torch.core.block import Line

from origami_tpu.batch.core.io import Artifact as JArtifact
from origami_tpu.batch.core.io import Input as JInput
from origami_tpu.batch.core.io import Stage as JStage
from origami_tpu.batch.core.lines import LineExtractor as JLineExtractor
from origami_tpu.batch.core.utils import RegionsFilter as JRegionsFilter
from origami_tpu_torch.batch.core.io import Artifact, Input, Stage
from origami_tpu_torch.batch.core.lines import LineExtractor
from origami_tpu_torch.batch.core.utils import RegionsFilter

ROOT = Path(__file__).resolve().parent.parent
FULL = ROOT / "tests/data/torch_ocr/full"
PAGES = sorted(FULL.glob("*.png"))
CLI = ["--device", "cpu", "--lock-strategy", "NONE", "--plain"]


class _Proc:
    device = torch.device("cpu")

    @staticmethod
    def lock_or_open(path, mode):
        return open(path, mode)


def _extractors(page, mode="banded"):
    jr = JInput(JArtifact.LINES, JArtifact.TABLES,
                stage=JStage.RELIABLE).instantiate(page)
    je = JLineExtractor(jr.tables, 48, {"extract_mode": mode},
                        min_confidence=jr.lines.min_confidence,
                        max_width=2048)
    jparts = je.parts(jr.lines.by_path,
                      ignored=JRegionsFilter("regions/ILLUSTRATION"))
    tr = Input(Artifact.LINES, Artifact.TABLES,
               stage=Stage.RELIABLE).instantiate(page, processor=_Proc())
    te = LineExtractor(tr.tables, 48, {"extract_mode": mode},
                       min_confidence=tr.lines.min_confidence,
                       max_width=2048)
    tparts = te.parts(tr.lines.by_path,
                      ignored=RegionsFilter("regions/ILLUSTRATION"))
    return jr, je, jparts, tr, te, tparts


@pytest.mark.parametrize("page", PAGES, ids=lambda p: p.stem)
def test_parts_and_frames_match_jax(page):
    jr, je, jparts, tr, te, tparts = _extractors(page)
    assert len(tr.regions) == len(jr.regions)
    assert set(tr.lines.by_path) == set(jr.lines.by_path)
    assert [p for p, _, _ in tparts] == [p for p, _, _ in jparts]
    assert [c for _, _, c in tparts] == [c for _, _, c in jparts]
    assert len(tparts) > 100
    from origami_tpu.core.block import BAND_PAD as JBAND_PAD
    for (_, jl, col), (path, tl, _) in zip(jparts, tparts):
        band_h = float(np.linalg.norm(jl._up)) * (1 + sum(JBAND_PAD))
        jf, jw = jl.dewarped_frame(48, xres=48 / max(band_h, 1.0),
                                   column=col, pad=JBAND_PAD)
        tf, tw = te._frame(path, tl, col)
        if jw > 2048:                       # the squeeze, as JAX does it
            jf, jw = jl.dewarped_frame(
                48, xres=48 / max(band_h, 1.0) * 2048 / jw, column=col,
                pad=JBAND_PAD)
            jw = min(jw, 2048)
        assert tw == jw
        np.testing.assert_allclose(tf, jf, atol=1e-4)


@pytest.mark.parametrize("mode", ["banded", "gather"])
def test_device_groups_match_jax(mode):
    """The same lines in the same (bucket, profile) groups, padded to
    the same row counts, in the same order."""
    page = PAGES[0]
    jr, je, jparts, tr, te, tparts = _extractors(page, mode)
    jg = [(p, tuple(np.asarray(s).shape), list(w), wmax)
          for p, s, w, wmax in je.device_groups(jparts)]
    tg = [(p, tuple(s.shape), list(w), wmax)
          for p, s, w, wmax in te.device_groups(tparts)]
    assert [g[0] for g in tg] == [g[0] for g in jg]
    assert [g[1:] for g in tg] == [g[1:] for g in jg]


# -- the lines stage -----------------------------------------------------

def _seeded_table_paths(rng):
    paths = []
    for label in ("TEXT", "TABULAR", "ILLUSTRATION"):
        for i in rng.choice(40, int(rng.integers(2, 8)), replace=False):
            if label == "TABULAR" and rng.random() < 0.7:
                for r in range(int(rng.integers(1, 3))):
                    for c in range(int(rng.integers(1, 4))):
                        paths.append(("regions", label,
                                      "%d.%d.%d.1" % (i, r + 1, c + 1)))
            else:
                paths.append(("regions", label, str(i)))
    return paths


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_table_region_combinator_matches_jax(seed):
    rng = np.random.default_rng(seed)
    paths = _seeded_table_paths(rng)
    boxes = {p: rng.uniform(0, 800, 2) for p in paths}
    port = port_utils.TableRegionCombinator(paths)
    jax = jax_utils.TableRegionCombinator(paths)
    assert port.mapping == jax.mapping
    assert [port.combined_path(p) for p in paths] == \
        [jax.combined_path(p) for p in paths]
    assert [port_utils.base_block_id(p[2]) for p in paths] == \
        [jax_utils.base_block_id(p[2]) for p in paths]
    # adjacent cells of a split table overlap, others stand apart
    wh = rng.uniform(20, 60, 2)
    got = port.contours({p: G.box(*b, *(b + wh)) for p, b in boxes.items()})
    want = jax.contours({p: J.box(*b, *(b + wh)) for p, b in boxes.items()})
    assert list(got) == list(want)
    assert [g.wkt for g in got.values()] == [w.wkt for w in want.values()]
    lines = {p + (str(k),): "%s/%d" % ("/".join(p), k)
             for p in paths for k in range(int(rng.integers(0, 4)))}
    assert port.lines(lines) == jax.lines(lines)


def _evidence(rng):
    names = ["regions/TEXT", "regions/TABULAR", "regions/ILLUSTRATION",
             "regions/BACKGROUND"]
    v = rng.dirichlet(np.ones(len(names)))
    if rng.random() < 0.3:
        v[1] = v[0]                      # a tie: the first one wins
    return {n: float(x) for n, x in zip(names, v)}


def test_line_confidence_members_match_jax():
    rng = np.random.default_rng(4)
    for _ in range(200):
        p, right, up = rng.uniform(0, 900, 2), rng.uniform(-5, 300, 2), \
            rng.uniform(-3, 30, 2)
        port = Line(None, p, right, up)
        jax = JLine(None, p, right, up)
        for k in range(3):
            ev = _evidence(rng) if k else {}
            port.update_confidence(ev)
            jax.update_confidence(ev)
            assert port.confidence == jax.confidence
            assert port.predicted_path == jax.predicted_path
            for path in (("regions", "TEXT"), ("regions", "TABULAR"),
                         ("regions", "NONE")):
                assert port.predicted_path_error(path) == \
                    jax.predicted_path_error(path)
        port.update_confidence(0.75)
        jax.update_confidence(0.75)
        assert port.predicted_path is None is jax.predicted_path
        assert port.predicted_path_error(("regions", "TEXT")) == 0.0
        h, xres = int(rng.integers(2, 30)), float(rng.uniform(0.2, 1.5))
        np.testing.assert_array_equal(
            port.dewarped_grid_coords(h, xres=xres),
            jax.dewarped_grid_coords(h, xres=xres))


def _aggregate_readers(tmp_path, stem="synth0000"):
    corpus = chip_smoke.lines_corpus(tmp_path / "corpus", [stem])
    png = corpus / (stem + ".png")
    jr = JInput(JArtifact.CONTOURS, JArtifact.TABLES,
                stage=JStage.AGGREGATE).instantiate(png)
    tr = Input(Artifact.CONTOURS, Artifact.TABLES,
               stage=Stage.AGGREGATE).instantiate(png, processor=_Proc())
    return jr, tr


def _fixture_lines(reader, cls_lines, stem="synth0000"):
    """The JAX stage's lines.3.zip of a page, read by one package's
    Lines against the layout stage's regions, keyed as the stage keys
    them (the line id an int)."""
    lines = cls_lines.open(FULL / (stem + ".out") / "lines.3.zip",
                           reader.regions)
    return {k[:3] + (int(k[3]),): v for k, v in lines.by_path.items()}


def test_reliable_contours_match_jax(tmp_path):
    from origami_tpu.core.block import Lines as JLines
    from origami_tpu_torch.core.block import Lines
    jr, tr = _aggregate_readers(tmp_path)
    jlines, tlines = _fixture_lines(jr, JLines), _fixture_lines(tr, Lines)
    assert list(jlines) == list(tlines) and len(tlines) > 100
    # promote two lines to new regions, as a reclassification does
    keys = list(tlines)[5:7]
    jfree = [(("regions", "TABULAR"), jlines.pop(k)) for k in keys]
    tfree = [(("regions", "TABULAR"), tlines.pop(k)) for k in keys]
    want = jax_lines.reliable_contours(jr.regions.by_path, jfree, jlines)
    got = port_lines.reliable_contours(tr.regions.by_path, tfree, tlines)
    assert list(got) == list(want)
    assert [g.wkt for g in got.values()] == [w.wkt for w in want.values()]
    assert list(tlines) == list(jlines)


def test_confidence_sampler_matches_jax(tmp_path):
    from origami_tpu.core.block import Lines as JLines
    from origami_tpu_torch.core.block import Lines
    jr, tr = _aggregate_readers(tmp_path)
    jw = JInput(JArtifact.SEGMENTATION, stage=JStage.WARPED).instantiate(
        tr.page_path)
    tw = Input(Artifact.SEGMENTATION, stage=Stage.WARPED).instantiate(
        tr.page_path, processor=_Proc())
    jlines, tlines = _fixture_lines(jr, JLines), _fixture_lines(tr, Lines)
    want = JConfidenceSampler(jr.regions.by_path, jw.segmentation,
                              jr.grid).batch(list(jlines.items()))
    got = stage.ConfidenceSampler(tr.regions.by_path, tw.segmentation,
                                  tr.grid).batch(list(tlines.items()))
    assert got == want and len(got) > 100


def test_lines_stage_on_jax_inputs(tmp_path):
    """The stage's CLI on the JAX inputs of the same run (one fixture
    page) against the JAX stage's contours.3.zip and lines.3.zip."""
    corpus = chip_smoke.lines_corpus(tmp_path / "corpus", ["synth0000"])
    stage.main(CLI + [str(corpus)])
    out = corpus / "synth0000.out"
    rt = json.loads((out / "runtime.json").read_text())[stage.STAGE_NAME]
    assert rt["status"] == "COMPLETED", rt
    px, conf, same = chip_smoke.compare_lines_outputs(
        out, FULL / "synth0000.out")
    assert px["contours.3.zip"] <= chip_smoke.CONTOUR_PX
    assert px["lines.3.zip"] <= chip_smoke.LINES_PX
    assert conf <= chip_smoke.LINE_CONF
    assert same == 1.0                       # every entry byte-equal
    with zipfile.ZipFile(out / "lines.3.zip") as zf:
        assert json.loads(zf.read("meta.json")) == dict(
            version=1, min_confidence=0)
