"""The port's line detection (core/baselines.py, the flow stage's
detect_block_lines, core/block.TextAreaFactory and Line) against the JAX
package, on the CPU.

Fed the JAX Sauvola mask of each fixture page
(tests/data/torch_segment/ref/<page>.sauvola15.npz), detect_block_lines
must give the JAX flow stage's lines exactly: every lines.0.zip entry of
tests/data/torch_flow, JSON for JSON (p, right, up, polygon WKT,
detection data). The host code is a copy, so nothing may differ.
"""

import json
import shutil
import zipfile
from pathlib import Path

import numpy as np
import pytest

from origami_tpu.core import baselines as jax_baselines
from origami_tpu_torch.batch.core.io import Artifact, Input, Stage
from origami_tpu_torch.batch.detect.flow import detect_block_lines
from origami_tpu_torch.core import baselines

ROOT = Path(__file__).resolve().parent.parent
FULL = ROOT / "tests/data/torch_ocr/full"
FLOW = ROOT / "tests/data/torch_flow"
SEG_REF = ROOT / "tests/data/torch_segment/ref"
PAGES = ["synth0000", "synth0001"]


def jax_mask(page, width):
    packed = np.load(SEG_REF / (page + ".sauvola15.npz"))["packed"]
    return np.unpackbits(packed, axis=1)[:, :width].astype(bool)


@pytest.fixture(scope="module")
def readers(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("flow_in")
    out = {}
    for page in PAGES:
        shutil.copy(FULL / (page + ".png"), tmp)
        d = tmp / (page + ".out")
        d.mkdir()
        shutil.copy(FULL / (page + ".out") / "segment.zip", d)
        shutil.copy(FLOW / (page + ".out") / "contours.0.zip", d)
        out[page] = Input(Artifact.CONTOURS, stage=Stage.WARPED) \
            .instantiate(tmp / (page + ".png"), device="cpu")
    return out


@pytest.mark.parametrize("page", PAGES)
def test_detect_block_lines_on_jax_mask_equals_jax_lines(readers, page):
    r = readers[page]
    mask = jax_mask(page, r.page.size()[0])
    lines = detect_block_lines(r.page, r.regions, separators=r.separators,
                               binarized=mask)
    got = {"/".join(parts) + "/%d.json" % i: line.info
           for parts, ls in lines.items() for i, line in enumerate(ls)}
    with zipfile.ZipFile(FLOW / (page + ".out") / "lines.0.zip") as zf:
        want = {n: json.loads(zf.read(n)) for n in zf.namelist()
                if n != "meta.json"}
    assert len(want) > 100
    assert got.keys() == want.keys()
    for k in want:
        assert json.loads(json.dumps(got[k])) == want[k], k


@pytest.mark.parametrize("page", PAGES)
def test_skew_and_baselines_equal_jax_per_block(readers, page):
    r = readers[page]
    mask = jax_mask(page, r.page.size()[0])
    ink = (~mask).astype(np.float32)
    assert baselines.estimate_skew(ink, max_ds=8) == \
        jax_baselines.estimate_skew(ink, max_ds=8)
    for path, block in list(r.regions.by_path.items())[:8]:
        x0, y0, x1, y1 = [int(v) for v in block.bounds]
        crop = mask[max(y0, 0):y1 + 1, max(x0, 0):x1 + 1]
        got = baselines.detect_baselines(crop, origin=(x0, y0),
                                         skew_hint=0.0)
        want = jax_baselines.detect_baselines(crop, origin=(x0, y0),
                                              skew_hint=0.0)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.p, b.p)
            np.testing.assert_array_equal(a.right, b.right)
            np.testing.assert_array_equal(a.up, b.up)
            assert a.data == b.data
            u, v = (baselines.unclip_band(a, 30.0),
                    jax_baselines.unclip_band(b, 30.0))
            np.testing.assert_array_equal(u.p, v.p)
            np.testing.assert_array_equal(u.up, v.up)
