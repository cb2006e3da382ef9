"""The port's order stage and its gap scorer against the JAX package.

Tolerances, each with its reason:
  * ObstacleSampler.score_many on the fixture pages' separators and
    seeded gaps, with and without the thickness bias: scores within
    1e-9 (the same numpy arithmetic in the same order);
  * the stage on the JAX stages' artifacts of the same run: order.json
    byte-equal to the JAX stage's (tests/data/torch_compose), host
    geometry with exact arithmetic.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from origami_tpu.batch.core.io import Artifact as JArtifact
from origami_tpu.batch.core.io import Input as JInput
from origami_tpu.batch.core.io import Stage as JStage
from origami_tpu.core import xycut as jax_xycut
from origami_tpu.core.separate import ObstacleSampler as JObstacleSampler
from origami_tpu_torch.batch.core.io import Artifact, Input, Stage
from origami_tpu_torch.batch.detect import order as stage
from origami_tpu_torch.core import xycut
from origami_tpu_torch.core.separate import ObstacleSampler

ROOT = Path(__file__).resolve().parent.parent
FULL = ROOT / "tests/data/torch_ocr/full"
COMPOSE = ROOT / "tests/data/torch_compose"


class _Proc:
    device = torch.device("cpu")

    @staticmethod
    def lock_or_open(path, mode):
        return open(path, mode)


def _gaps(rng, n, w, h):
    out = []
    for _ in range(n):
        axis = int(rng.integers(0, 2))
        ext = (w, h) if axis == 0 else (h, w)
        minu = rng.uniform(0, ext[0])
        minv = rng.uniform(0, ext[1])
        du = rng.choice([0.2, rng.uniform(0.5, 40), rng.uniform(40, 400)])
        dv = rng.choice([0.3, rng.uniform(10, 900)])
        out.append((axis, minu, minu + du, minv, minv + dv))
    return out


@pytest.mark.parametrize("stem", ["synth0000", "synth0001"])
@pytest.mark.parametrize("bias", [False, True])
def test_obstacle_sampler_score_many_matches_jax(tmp_path, stem, bias):
    corpus = chip_smoke.order_corpus(tmp_path / "corpus", [stem])
    png = corpus / (stem + ".png")
    jseps = JInput(JArtifact.CONTOURS, stage=JStage.DEWARPED).instantiate(
        png).separators
    tseps = Input(Artifact.CONTOURS, stage=Stage.DEWARPED).instantiate(
        png, processor=_Proc()).separators
    delta = (lambda width: 2 if width > 2 else 0) if bias else None
    port, jax = ObstacleSampler(tseps, delta), JObstacleSampler(jseps, delta)
    assert len(port._segs) == len(jax._segs) > 0
    rng = np.random.default_rng(7)
    gaps = _gaps(rng, 600, 1700, 2300)
    got = port.score_many([xycut.GapInfo(*g) for g in gaps])
    want = jax.score_many([jax_xycut.GapInfo(*g) for g in gaps])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    assert (got > 0).sum() > 100 and (got != np.array(
        [g[2] - g[1] for g in gaps]) * [g[4] - g[3] for g in gaps]).sum() > 10
    assert port.score_many([xycut.GapInfo(*gaps[3])])[0] == got[3]


def test_order_stage_on_jax_inputs(tmp_path):
    corpus = chip_smoke.order_corpus(tmp_path / "corpus")
    stage.main(["--device", "cpu", "--lock-strategy", "NONE", "--plain",
                str(corpus)])
    for png in sorted(corpus.glob("*.png")):
        got = (corpus / (png.stem + ".out") / "order.json").read_bytes()
        want = (COMPOSE / (png.stem + ".out") / "order.json").read_bytes()
        assert got == want, png.stem
