"""The port's affine-warp helpers against the JAX package's:
ops.remap.affine_warp and invert_affine, core/math's rotation_matrix and
to_affine_coeffs, geometry.affinity, batch/core/deskew.Deskewer, and
core/block's Line.deskewed_frame, Line.image (both routes) and Line.ink
on a crop of a fixture page, on the CPU (the plain remap).

Tolerances. affine_warp in float32: XLA's CPU backend evaluates the
source planes m00 x + m01 y + m02 with m00 x fused into m01 y (the port's
affine_planes does the same), but not at every column: where it does
not, a coordinate moves by one float32 step, and the sample by at most
that step times the gray step between two taps. So at least 99.9 % of
the samples are within 1e-3 and every one within
2 * 255 * spacing(max coordinate) (ROADMAP C13). The u8 results
(Deskewer.image, Line.image) within 1 gray level: the deskewed route
samples the dewarped crop, which the JAX banded dewarp rounds otherwise
than the port's direct sample on a few pixels of a warped grid (ROADMAP
C3). Line.ink within 1e-6, the angles and geometries within 1e-12;
invert_affine (float32 LU solves of two libraries) within 1e-6
relative.
"""

import numpy as np
import PIL.Image
import pytest
import torch

from origami_tpu_torch import geometry as G
from origami_tpu_torch.batch.core.deskew import Deskewer, weighted_median
from origami_tpu_torch.core import math as M
from origami_tpu_torch.ops import remap as T

FIXTURE_PAGE = "tests/data/torch_ocr/full/synth0000.png"


def _affine_cases():
    rng = np.random.default_rng(0)
    for _ in range(6):
        h, w = (int(v) for v in rng.integers(20, 300, 2))
        oh, ow = (int(v) for v in rng.integers(20, 300, 2))
        m = M.rotation_matrix(float(rng.normal(0, 0.3)), (w / 2, h / 2))
        m[:, 2] += rng.normal(0, 10, 2)
        yield rng.uniform(0, 255, (h, w)).astype(np.float32), m, (oh, ow)


@pytest.mark.parametrize("case", range(6))
def test_affine_warp_equal_jax(case):
    import jax.numpy as jnp
    from origami_tpu.ops import remap as R
    img, m, out_hw = list(_affine_cases())[case]
    want = np.asarray(R.affine_warp(jnp.asarray(img), jnp.asarray(m),
                                    out_hw, fill=255.0))
    got = T.affine_warp(torch.from_numpy(img), m, out_hw, 255.0).numpy()
    # the six coefficients as float32 values, from numpy or a tensor: the
    # kernel takes them by value, the plain version builds its planes
    for mat in (m, torch.from_numpy(m.astype(np.float32))):
        np.testing.assert_array_equal(
            got, T.affine_warp_plain(torch.from_numpy(img), mat, out_hw,
                                     255.0).numpy())
    d = np.abs(got - want)
    sx, sy = T.affine_planes(m, out_hw)
    step = np.spacing(np.float32(max(np.abs(sx).max(), np.abs(sy).max())))
    assert (d <= 1e-3).mean() >= 0.999, d.max()
    assert d.max() <= 2 * 255 * step


def test_affine_warp_translation():
    img = np.zeros((10, 10), np.float32)
    img[2, 3] = 1.0
    m = np.array([[1.0, 0.0, 1.0], [0.0, 1.0, 0.0]])
    out = T.affine_warp(torch.from_numpy(img), m, (10, 10)).numpy()
    assert out[2, 2] == 1.0 and out.sum() == 1.0


def test_invert_affine_equal_jax():
    from origami_tpu.ops import remap as R
    m = M.rotation_matrix(0.3, (40.0, 25.0))
    # float32 LU solves of two libraries: within a few float32 steps
    np.testing.assert_allclose(T.invert_affine(m).numpy(),
                               np.asarray(R.invert_affine(m)),
                               rtol=1e-6, atol=1e-5)


def _fma_operands(kind):
    """400 random float32 triples, or 4000 whose a * b + c lies on a
    float32 midpoint of a * b or one step off it (where rounding the
    float64 sum again would round twice)."""
    n = 400 if kind == "random" else 4000
    rng = np.random.default_rng(1 if kind == "random" else 2)
    a = rng.normal(0, 1, n).astype(np.float32)
    b = rng.integers(0, 3000, n).astype(np.float32)
    if kind == "random":
        return a, b, rng.normal(0, 200, n).astype(np.float32)
    t = (a.astype(np.float64) * b).astype(np.float32)
    half = (np.nextafter(t, np.float32(np.inf)).astype(np.float64) - t) / 2
    return a, b, (half * rng.integers(-1, 2, n)).astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "midpoint"])
def test_fma_planes_are_correctly_rounded(kind):
    """core/math.fma_f32 (affine_planes' and cv2 warpAffine's fused
    multiply-add) against exact rationals."""
    from fractions import Fraction
    a, b, c = _fma_operands(kind)
    got = M.fma_f32(a, b, c)
    for x, y, z, r in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        lo, hi = np.nextafter(r, np.float32(-np.inf)), \
            np.nextafter(r, np.float32(np.inf))
        err = abs(Fraction(float(r)) - exact)
        assert err <= abs(Fraction(float(lo)) - exact)
        assert err <= abs(Fraction(float(hi)) - exact)


def test_math_and_affinity_equal_jax():
    from origami_tpu import geometry as JG
    from origami_tpu.core import math as JM
    m = M.rotation_matrix(-0.2, (13.0, 7.5))
    np.testing.assert_array_equal(m, JM.rotation_matrix(-0.2, (13.0, 7.5)))
    assert M.to_affine_coeffs(m) == JM.to_affine_coeffs(m)
    shell = [(0, 0), (30, 2), (28, 20), (3, 18)]
    p, jp = G.Polygon(shell), JG.Polygon(shell)
    for fn, args in (("rotate", (17.0,)), ("scale", (1.5, 0.5)),
                     ("translate", (3.0, -2.0)),
                     ("affine_transform", (M.to_affine_coeffs(m),))):
        got = getattr(G.affinity, fn)(p, *args)
        want = getattr(JG.affinity, fn)(jp, *args)
        np.testing.assert_array_equal(got.np_shell, want.np_shell)
    got = G.affinity.rotate(p, 0.4, origin="centroid", use_radians=True)
    want = JG.affinity.rotate(jp, 0.4, origin="centroid", use_radians=True)
    np.testing.assert_allclose(got.np_shell, want.np_shell, atol=1e-12)


def test_weighted_median():
    assert weighted_median([3.0, 1.0, 2.0], [1.0, 1.0, 5.0]) == 2.0
    assert weighted_median([1.0, 2.0], [0.0, 0.0]) == 1.5


def _crop_page(tmp_path):
    """A 320 x 480 crop of a fixture page and a smooth dewarping grid
    over it (res 16): (path, hv)."""
    px = np.asarray(PIL.Image.open(FIXTURE_PAGE).convert("L"))[
        300:620, 200:680]
    path = tmp_path / "crop.png"
    PIL.Image.fromarray(px).save(path)
    res, h, w = 16, 320, 480
    gh, gw = h // res + 2, w // res + 2
    j, i = np.meshgrid(np.arange(gw), np.arange(gh))
    hv = np.stack([j * res + 1.0 * np.sin(i / 9.0),
                   i * res + 0.5 * np.cos(j / 11.0)], -1).astype(np.float32)
    return path, hv, res


def _lines(pkg, path, hv, res, device):
    """A block over the crop at the dewarped stage and three lines on
    it, through package `pkg`."""
    import importlib
    block_m = importlib.import_module(pkg + ".core.block")
    page_m = importlib.import_module(pkg + ".core.page")
    dewarp_m = importlib.import_module(pkg + ".core.dewarp")
    io = importlib.import_module(pkg + ".batch.core.io")
    geom = importlib.import_module(pkg + ".geometry")
    on = {} if device is None else dict(device=device)
    page = page_m.Page(path, dewarp_m.Grid(hv, res), **on)
    block = block_m.Block(page, geom.box(10, 10, 470, 310),
                          io.Stage.RELIABLE)
    frames = [((30, 80), (400, 6), (-0.4, -22)),
              ((40, 160), (380, -9), (0.5, -25)),
              ((25, 250), (300, 2), (0.0, -20))]
    return [block_m.Line(block, p, r, u) for p, r, u in frames], page


def test_line_image_and_ink_equal_jax(tmp_path):
    path, hv, res = _crop_page(tmp_path)
    jlines, _ = _lines("origami_tpu", path, hv, res, None)
    plines, page = _lines("origami_tpu_torch", path, hv, res, "cpu")
    for jl, pl in zip(jlines, plines):
        jf, jw = jl.deskewed_frame(48)
        pf, pw = pl.deskewed_frame(48)
        np.testing.assert_array_equal(pf, jf)
        assert pw == jw
        for kw in (dict(), dict(dewarped=False)):
            want = jl.image(48, **kw)
            got = pl.image(48, **kw)
            assert got.shape == want.shape and got.dtype == np.uint8
            assert np.abs(got.astype(int) - want).max() <= 1, kw
        np.testing.assert_allclose(pl.ink, jl.ink, rtol=0, atol=1e-6)
    # the Deskewer of these lines: angle, page image, a geometry
    from origami_tpu.batch.core.deskew import Deskewer as JDeskewer
    from origami_tpu import geometry as JG
    jd, pd = JDeskewer(jlines), Deskewer(plines)
    assert abs(pd.angle - jd.angle) <= 1e-12 and pd.angle != 0.0
    px = page.warped
    d = np.abs(pd.image(px, device="cpu").astype(int) - jd.image(px))
    assert d.max() <= 1
    shell = [(10, 10), (470, 12), (468, 300), (12, 305)]
    got = pd.geometry(G.Polygon(shell), (480, 320))
    want = jd.geometry(JG.Polygon(shell), (480, 320))
    np.testing.assert_allclose(got.np_shell, want.np_shell, atol=1e-12)
