"""Line extraction of the port (artifact readers, table rewriting, strip
frames, width buckets and the p1/p2/gather partition) against the JAX
LineExtractor on the fixture pages.

Tolerance: none for paths, columns, widths and groups; frames agree to
float32 rounding (1e-4 px) — both build them in float64 and round once.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from origami_tpu.batch.core.io import Artifact as JArtifact
from origami_tpu.batch.core.io import Input as JInput
from origami_tpu.batch.core.io import Stage as JStage
from origami_tpu.batch.core.lines import LineExtractor as JLineExtractor
from origami_tpu.batch.core.utils import RegionsFilter as JRegionsFilter
from origami_tpu_torch.batch.core.io import Artifact, Input, Stage
from origami_tpu_torch.batch.core.lines import LineExtractor
from origami_tpu_torch.batch.core.utils import RegionsFilter

ROOT = Path(__file__).resolve().parent.parent
PAGES = sorted((ROOT / "tests/data/torch_ocr/full").glob("*.png"))


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
