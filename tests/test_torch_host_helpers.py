"""The last host helpers of the port against the JAX package's, on the
CPU: core/lingrid.py, pagexml/transcriptions.py and
core/flow.patch_skew_samples.

Bars:
  * lingrid: within 1e-9 of JAX's (both are scipy's interpolators);
  * transcriptions: the same matches (detected line -> GT text) from the
    JAX compose stage's page.xml and the JAX lines.3.zip;
  * patch_skew_samples on the JAX binarized page
    (tests/data/torch_inspect): the same points, the angles equal on at
    least 99 % of the tiles and the rest within one step of the 33-angle
    sweep, each count stated below; shear_angles and their tangents
    equal to XLA's bit for bit.
"""

import json
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from origami_tpu.core import flow as jax_flow
from origami_tpu.core import lingrid as jax_lingrid
from origami_tpu_torch.core import _png, flow, lingrid

REF = json.loads((chip_smoke.INSPECT_REF / "inspect.json").read_text())
PAGE = "synth0000"


@pytest.mark.parametrize("case", ["scalar", "vector", "few", "dupes",
                                  "grid"])
def test_lingrid_equals_jax(case):
    rng = np.random.default_rng(["scalar", "vector", "few", "dupes",
                                 "grid"].index(case))
    n = {"few": 3}.get(case, 40)
    pts = rng.uniform(0, 100, (n, 2))
    if case == "dupes":
        pts[10:20] = pts[:10] + 1e-8
    values = rng.normal(size=(n, 2) if case == "vector" else n)
    query = rng.uniform(-20, 120, (500, 2))
    if case == "grid":
        got = lingrid.lingrid(pts, values, 37, 23)
        want = jax_lingrid.lingrid(pts, values, 37, 23)
    else:
        got = lingrid.lininterp(pts, values, (0, 0, 100, 100))(query)
        want = jax_lingrid.lininterp(pts, values, (0, 0, 100, 100))(query)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    assert np.isfinite(got).all()


def test_lingrid_without_points_is_zero():
    got = lingrid.Interpolator(np.zeros((0, 2)), np.zeros(0), None)(
        [[1.0, 2.0]])
    np.testing.assert_array_equal(
        got, jax_lingrid.Interpolator(np.zeros((0, 2)), np.zeros(0),
                                      None)([[1.0, 2.0]]))


def _lines(pkg, page_png):
    import importlib
    io = importlib.import_module(pkg + ".batch.core.io")
    spec = io.Input(io.Artifact.CONTOURS, io.Artifact.LINES,
                    stage=io.Stage.RELIABLE)
    kw = dict(device="cpu") if pkg.endswith("torch") else {}
    return spec.instantiate(page_png, **kw).lines.by_path


@pytest.mark.parametrize("stem", ["synth0000", "synth0001"])
def test_transcriptions_match_jax(tmp_path, stem):
    from origami_tpu.pagexml.transcriptions import \
        TranscriptionReader as JaxReader
    from origami_tpu_torch.pagexml.transcriptions import TranscriptionReader
    with zipfile.ZipFile(chip_smoke.COMPOSE_REF / (stem + ".out")
                         / "compose_xml.zip") as zf:
        xml = tmp_path / "page.xml"
        xml.write_bytes(zf.read("page.xml"))
    png = chip_smoke.FIXTURE / (stem + ".png")
    got = TranscriptionReader(xml, _lines("origami_tpu_torch", png))
    want = JaxReader(xml, _lines("origami_tpu", png))
    assert len(want.matched) == {"synth0000": 44, "synth0001": 104}[stem]
    assert got.matched == want.matched
    key = next(iter(want.matched))
    assert got.text_for(key) == want.text_for(key)


def _jax_angles(n_angles=33, max_angle=0.12):
    """jnp.linspace as flow.py:_patch_skews builds it: max_angle traced."""
    return np.asarray(jax.jit(lambda m: jnp.linspace(-m, m, n_angles))(
        max_angle))


def test_shear_angles_match_xla():
    angles, tans = flow.shear_angles()
    want = _jax_angles()
    assert angles.dtype == tans.dtype == np.float32
    np.testing.assert_array_equal(angles.view(np.uint32),
                                  want.view(np.uint32))
    np.testing.assert_array_equal(tans, np.asarray(jnp.tan(want)))
    for n, m in ((9, 0.3), (65, 0.05)):
        np.testing.assert_array_equal(flow.shear_angles(n, m)[0],
                                      _jax_angles(n, m))


def _mask():
    return _png.read(chip_smoke.INSPECT_REF / REF["skew"]["mask"]) > 0


@pytest.mark.parametrize("patch,turn,tiles", [
    (256, 0, 35), (128, 0, 141), (256, 1, 35), (128, 1, 141)])
def test_patch_skew_samples_equal_jax(patch, turn, tiles):
    """The JAX binarized page, and the same turned by 90 degrees (tiles
    of vertical strokes, whose profiles are flat and tie). Every one of
    the `tiles` tiles with ink gives JAX's angle."""
    mask = np.ascontiguousarray(np.rot90(_mask(), turn))
    want = chip_smoke.skew_rows(jax_flow.patch_skew_samples(mask, patch))
    got = chip_smoke.skew_rows(flow.patch_skew_samples(mask, patch,
                                                       device="cpu"))
    bad, n, same = chip_smoke.skew_errors(got, want, "patch %d" % patch)
    assert bad == []
    assert same == n == tiles
    if turn == 0:
        assert want == REF["skew"][str(patch)]
    # a bool tensor runs on its own device and gives the same samples
    assert chip_smoke.skew_rows(flow.patch_skew_samples(
        torch.from_numpy(mask), patch)) == got


def test_patch_skew_samples_need_cuda_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flow.patch_skew_samples(np.ones((256, 256), bool))
