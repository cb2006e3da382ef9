"""The dewarp and strip kernels' plain versions (what the wrappers run on
the CPU) against the JAX functions they port, on a ~200x300 crop of a
fixture page with a seeded smooth warp grid.

Tolerances, each with its reason:
  * dewarp vs the JAX dense route: <= 1 gray level — the hard border
    truncates as the dense route does (core/dewarp.py:477); the grid is
    upsampled by another formula, so an ulp can cross an integer;
  * dewarp vs dewarp_banded_u8: <= 1 on >= 99.9 % of interior pixels —
    the banded route is a two-pass (Catmull-Smith) approximation of the
    direct bilinear sample, exact only for separable maps;
  * remap vs remap_pallas(interpret=True): <= 1e-3 — both are float32
    bilinear, the Pallas kernel sums its row band in another order; the
    map sits on a 1/64-px lattice because the Pallas kernel shifts
    coordinates by its fill margin in float32, which would otherwise
    move a tap weight by an ulp of the shifted coordinate (up to ~4e-3
    of a gray level on text edges);
  * remap off that lattice vs a float64 bilinear of the same float32
    coordinates: <= 2**-15, float32 rounding (ROADMAP C5: the port is
    the exact one, see the test);
  * dewarp_f32 vs the upsampled grid through remap_plain: bit-equal
    (the layout stage's composition before the f32 dewarp kernel);
  * strip mode (a) vs extract_strips_banded: <= 1 on >= 99.9 % for
    lines as flat as the fixture's (|slope| <= 5e-4) — the banded route
    is a shear/scale decomposition of the same sample whose error grows
    with the slope (3 % of pixels > 1 off at slope 3e-3; ROADMAP.md,
    queue C);
  * strip mode (a) on skewed lines vs the direct affine bilinear sample
    (extract_line_strips) away from the page edge: <= 0.51 — the port
    rounds the same value (0.5); the two compute the float32 source
    coordinate by different formulas, an ulp apart (3e-5 px at x ~ 300,
    times a text edge's gradient);
  * strip mode (b) vs extract_dewarped_strips: <= 1 — the same
    arithmetic; float32 ulps can move a value across an integer before
    the truncating cast;
  * either mode vs extract_line_strips_pallas(interpret=True) where
    strips_frames_ok holds: <= 2.55, the 1e-2-of-range bound that
    module states for its two-shear decomposition (remap.py:19-23).
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from origami_tpu.core.dewarp import Grid as JaxGrid
from origami_tpu.core.dewarp import _jitted_dewarp_fns
from origami_tpu.ops import remap as jax_remap
from origami_tpu.ops.pallas.remap import (extract_line_strips_pallas,
                                          remap_pallas, strips_frames_ok)
from origami_tpu_torch.batch.core.lines import LineExtractor, identity_grid
from origami_tpu_torch.core import _png
from origami_tpu_torch.core.block import BAND_PAD, Line
from origami_tpu_torch.ops import remap as ops

ROOT = Path(__file__).resolve().parent.parent
RES = 25


@pytest.fixture(scope="module")
def crop():
    page = _png.read_gray(ROOT / "tests/data/torch_ocr/full/synth0001.png")
    return np.ascontiguousarray(page[700:900, 250:550])       # (200, 300)


@pytest.fixture(scope="module")
def grid():
    """A smooth dewarp grid over the crop: 2-cell pad, a sinusoidal warp
    of a few px whose shear (|d my / d x| <= 0.004) is that of measured
    real-scan grids (core/dewarp.py:254-257), so the banded JAX route
    applies."""
    rng = np.random.default_rng(7)
    gh, gw = 14, 18
    ph = rng.uniform(0, 2 * np.pi, 4)
    ii, jj = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
    x = -50.0 + RES * jj + 0.3 * np.sin(ii / 3.1 + ph[0]) \
        + 2.3 * np.sin(jj / 4.3 + ph[1])
    y = -50.0 + RES * ii + 0.3 * np.cos(jj / 3.7 + ph[2]) \
        + 1.9 * np.sin(ii / 2.9 + ph[3])
    return np.stack([x, y], -1).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_dewarp_matches_jax_dense_route(crop, grid):
    ref = np.asarray(_jitted_dewarp_fns()[1](
        jnp.asarray(crop), jnp.asarray(grid), jnp.ones(2, jnp.float32),
        RES))
    got = ops.dewarp_u8(_t(crop), _t(grid), RES).numpy()
    assert got.shape == ref.shape == (14 * RES, 18 * RES)
    d = np.abs(got.astype(int) - ref.astype(int))
    assert d.max() <= 1
    assert (got != 255).sum() > 0.5 * crop.size     # the page is there


def test_dewarp_matches_jax_banded_route(crop, grid):
    from origami_tpu.ops.remap import dewarp_banded_u8
    plan = JaxGrid(grid, RES).banded_plan(crop.shape, (1.0, 1.0))
    assert plan is not None
    ref = np.asarray(dewarp_banded_u8(
        jnp.asarray(crop), jnp.asarray(plan["lat_my"]),
        jnp.asarray(plan["lat_mx"]), plan["step"], plan["d1"], plan["n1"],
        plan["d2"], plan["n2"], plan["out_h"], plan["out_w"]))
    got = ops.dewarp_u8(_t(crop), _t(grid), RES).numpy()
    mx, my = (p.numpy() for p in ops._upsample_grid(_t(grid), RES))
    h, w = crop.shape
    interior = (mx >= 2) & (mx <= w - 3) & (my >= 2) & (my <= h - 3)
    d = np.abs(got.astype(int) - ref.astype(int))[interior]
    assert interior.sum() > 0.5 * crop.size
    assert (d <= 1).mean() >= 0.999, (d <= 1).mean()


def test_remap_matches_remap_pallas(crop):
    rng = np.random.default_rng(4)
    img = crop.astype(np.float32)
    yy, xx = np.meshgrid(np.arange(64, dtype=np.float32),
                         np.arange(256, dtype=np.float32), indexing="ij")
    a = rng.uniform(0, 2 * np.pi, 2)
    mx = 20.0 + 0.98 * xx + 0.05 * yy + 1.5 * np.sin(yy / 9.0 + a[0])
    my = 60.0 + 1.02 * yy - 0.03 * xx + 1.2 * np.sin(xx / 17.0 + a[1])
    m = np.round(np.stack([mx, my], -1) * 64.0).astype(np.float32) / 64
    assert mx.min() >= 0 and mx.max() <= img.shape[1] - 1
    assert my.min() >= 0 and my.max() <= img.shape[0] - 1
    ref = np.asarray(remap_pallas(jnp.asarray(img), jnp.asarray(m),
                                  fill=0.0, interpret=True))
    got = ops.remap(_t(img), _t(m), 0.0).numpy()
    assert np.abs(got - ref).max() <= 1e-3


def _bilinear64(img, m, fill):
    """remap_plain's fill_taps sample of `img` at the float32 map `m`,
    computed in float64."""
    h, w = img.shape
    x = np.clip(m[..., 0].astype(np.float64), -2, w + 1)
    y = np.clip(m[..., 1].astype(np.float64), -2, h + 1)
    fx, fy = np.floor(x), np.floor(y)
    tx, ty = x - fx, y - fy
    x0, y0 = fx.astype(int), fy.astype(int)

    def tap(yi, xi):
        inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        v = img[np.clip(yi, 0, h - 1), np.clip(xi, 0, w - 1)]
        return np.where(inside, v.astype(np.float64), fill)
    top = tap(y0, x0) * (1 - tx) + tap(y0, x0 + 1) * tx
    bot = tap(y0 + 1, x0) * (1 - tx) + tap(y0 + 1, x0 + 1) * tx
    return top * (1 - ty) + bot * ty


def test_remap_off_lattice_is_float64_bilinear_within_rounding(crop):
    """ROADMAP C5. The seeded map of test_remap_matches_remap_pallas
    without its 1/64-px rounding: remap is 2.84e-5 gray levels from the
    float64 bilinear of the same float32 coordinates, and
    remap_pallas(interpret=True) 4.21e-3 from it (both measured on this
    map). The Pallas kernel shifts each coordinate by its fill margin
    and tile origin in float32 (ops/pallas/remap.py:272-283, 373-374)
    and so loses low bits of the tap weights. The port's bound: below
    512 px a weight and its product with a u8 gray level are exact in
    float32, and the two sums, the two products of the second lerp and
    the last sum each round by at most half an ulp below 256 (2**-17),
    2**-15 in all."""
    rng = np.random.default_rng(4)
    img = crop.astype(np.float32)
    yy, xx = np.meshgrid(np.arange(64, dtype=np.float32),
                         np.arange(256, dtype=np.float32), indexing="ij")
    a = rng.uniform(0, 2 * np.pi, 2)
    mx = 20.0 + 0.98 * xx + 0.05 * yy + 1.5 * np.sin(yy / 9.0 + a[0])
    my = 60.0 + 1.02 * yy - 0.03 * xx + 1.2 * np.sin(xx / 17.0 + a[1])
    m = np.stack([mx, my], -1).astype(np.float32)
    assert (np.round(m * 64) != m * 64).mean() > 0.99    # off the lattice
    assert m.max() < 512
    got = ops.remap(_t(img), _t(m), 0.0).numpy()
    d = np.abs(got - _bilinear64(img, m, 0.0))
    assert d.max() <= 2.0 ** -15, d.max()
    assert d.max() > 0                  # float32, not float64, arithmetic


@pytest.mark.parametrize("case", ["crop", "smooth", "sheared"])
def test_dewarp_f32_is_the_upsampled_grid_through_remap(crop, grid, case):
    """dewarp_f32 (on the CPU its plain version) equals the composition
    the layout stage ran before it, _upsample_grid + remap_plain at the
    fill_taps border, bit for bit: on the fixture crop with its seeded
    grid, and on the crafted page's smooth and sheared grids
    (test_torch_layout.crafted_page)."""
    if case == "crop":
        img, hv, res = crop.astype(np.float32), grid, RES
    else:
        from test_torch_layout import crafted_page
        page, res, smooth, sheared, _ = crafted_page()
        img, hv = page.astype(np.float32), {"smooth": smooth,
                                            "sheared": sheared}[case]
    mx, my = ops._upsample_grid(_t(hv), res)
    want = ops.remap_plain(_t(img), torch.stack([mx, my], -1), 0.0,
                           "fill_taps")
    got = ops.dewarp_f32(_t(img), _t(hv), res, 0.0)
    assert got.shape == (hv.shape[0] * res, hv.shape[1] * res)
    assert torch.equal(got, want)
    assert (got > 0).float().mean() > 0.3          # the page is there


def _frames(specs, th=48):
    """(frames (N, 2, 3), widths (N,)) of the port's Line.dewarped_frame
    for line specs (x, y baseline-left, length, ink height, slope)."""
    frames, widths = [], []
    for x, y, length, height, slope in specs:
        right = np.array([length, length * slope])
        up = np.array([height * slope, -height])
        line = Line(None, p=[x, y], right=right, up=up)
        band_h = float(np.linalg.norm(up)) * (1 + sum(BAND_PAD))
        f, wid = line.dewarped_frame(th, xres=th / band_h, pad=BAND_PAD)
        frames.append(f)
        widths.append(wid)
    return np.stack(frames).astype(np.float32), np.asarray(widths, np.int32)


# baseline-left x, y, length, ink height, slope: inside the crop, some
# touching its edges (taps blend with fill there). Flat lines, as the
# fixture's dewarped lines are, for the banded route's parity...
P1_FLAT = [(20, 60, 100, 14, 0.0), (40, 120, 90, 18, -5e-4),
           (5, 190, 100, 16, 5e-4), (150, 40, 60, 20, 0.0),
           (-4, 100, 50, 15, 0.0), (240, 160, 62, 20, 5e-4)]
P2_FLAT = [(30, 110, 150, 40, 2e-4), (60, 170, 120, 46, 0.0)]
# ...and skewed ones
SKEWED = [(20, 60, 180, 14, 0.01), (40, 120, 200, 18, -0.008),
          (5, 190, 120, 16, 0.0), (100, 30, 190, 12, 0.02),
          (-4, 100, 80, 15, 0.004), (200, 160, 110, 20, -0.015),
          (30, 110, 150, 40, 0.005), (60, 170, 120, 46, -0.01)]


@pytest.mark.parametrize("prof,specs,slab", [
    ("p1", P1_FLAT, lambda w: (64, w + 8)),
    ("p2", P2_FLAT, lambda w: (128, 2 * w + 8))])
def test_strips_dewarped_matches_extract_strips_banded(crop, prof, specs,
                                                       slab):
    fr, wd = _frames(specs)
    out_w = 256
    assert wd.max() <= out_w
    for f, w in zip(fr, wd):
        assert LineExtractor._extract_profile(f, w, 48, True) == prof
    k, sw = slab(out_w)
    ref = np.asarray(jax_remap.extract_strips_banded(
        jnp.asarray(crop), jnp.asarray(fr), jnp.asarray(wd), 48, out_w,
        k, sw, 6, 255.0))
    got = ops.strips_dewarped(_t(crop), _t(fr), _t(wd), 48, out_w).numpy()
    d = np.abs(got.astype(int) - ref.astype(int))
    assert (d <= 1).mean() >= 0.999, (d <= 1).mean()
    assert (got < 128).sum() > 100                   # ink was sampled


def test_strips_dewarped_matches_direct_sample_on_skewed_lines(crop):
    fr, wd = _frames(SKEWED)
    out_w = 768
    ref = np.asarray(jax_remap.extract_line_strips(
        jnp.asarray(crop.astype(np.float32)), jnp.asarray(fr),
        jnp.asarray(wd), 48, out_w, 255.0))
    got = ops.strips_dewarped(_t(crop), _t(fr), _t(wd), 48, out_w).numpy()
    h, w = crop.shape
    xs = np.arange(out_w, dtype=np.float32)[None, None, :]
    ys = np.arange(48, dtype=np.float32)[None, :, None]
    px = fr[:, 0, 0, None, None] * xs + fr[:, 0, 1, None, None] * ys \
        + fr[:, 0, 2, None, None]
    py = fr[:, 1, 0, None, None] * xs + fr[:, 1, 1, None, None] * ys \
        + fr[:, 1, 2, None, None]
    inside = ((px >= 1) & (px <= w - 2) & (py >= 1) & (py <= h - 2)
              & (xs < wd[:, None, None]))
    assert inside.mean() > 0.2
    assert np.abs(got.astype(np.float32) - ref)[inside].max() <= 0.51


def test_strips_through_grid_matches_extract_dewarped_strips(crop, grid):
    fr, wd = _frames(SKEWED)
    fr[:, :, 2] += 50.0          # dewarped coords: the grid's 2-cell pad
    ref = np.asarray(jax_remap.extract_dewarped_strips(
        jnp.asarray(crop), jnp.asarray(grid), float(RES), jnp.asarray(fr),
        jnp.asarray(wd), 48, 768, 255.0, 0))
    got = ops.strips_through_grid(_t(crop), _t(grid), float(RES), _t(fr),
                                  _t(wd), 48, 768).numpy()
    d = np.abs(got.astype(int) - ref.astype(int))
    assert d.max() <= 1
    assert (got < 128).sum() > 100


def test_both_strip_modes_vs_pallas_strips_kernel(crop):
    # strips well inside the crop, so mode (a)'s hard page edge and
    # fill columns play no part; mode (b) through the identity grid
    specs = [(20, 70, 150, 14, 0.01), (60, 130, 170, 18, -0.008),
             (40, 180, 140, 16, 0.0)]
    fr, wd = _frames(specs)
    out_w = 256
    assert strips_frames_ok(fr, 48, out_w)
    ref = np.asarray(extract_line_strips_pallas(
        jnp.asarray(crop.astype(np.float32)), jnp.asarray(fr),
        jnp.asarray(np.full(len(fr), 48, np.int32)), 48, out_w, 255.0,
        interpret=True))
    hv, res = identity_grid(crop.shape[1], crop.shape[0])
    a = ops.strips_dewarped(_t(crop), _t(fr), _t(wd), 48, out_w).numpy()
    b = ops.strips_through_grid(_t(crop), _t(hv), res, _t(fr), _t(wd), 48,
                                out_w).numpy()
    cols = np.arange(out_w)[None, None, :] < wd[:, None, None]
    cols = np.broadcast_to(cols, ref.shape)
    for got in (a, b):
        assert np.abs(got.astype(np.float32) - ref)[cols].max() <= 2.55


def test_wrappers_run_plain_on_cpu_and_count_no_launch(crop, grid):
    fr, wd = _frames(P1_FLAT)
    before = dict(ops.launches)
    out = ops.strips_dewarped(_t(crop), _t(fr), _t(wd), 48, 256)
    np.testing.assert_array_equal(
        out.numpy(), ops.strips_dewarped_plain(_t(crop), _t(fr), _t(wd),
                                               48, 256).numpy())
    ops.dewarp_u8(_t(crop), _t(grid), RES)
    img = _t(crop).float()
    mx, my = ops._upsample_grid(_t(grid), RES)
    ops.remap(img, torch.stack([mx, my], -1)[:40, :50].contiguous())
    ops.remap_batch(img[None], (mx[None, :40, :50], my[None, :40, :50]))
    ops.dewarp_f32(img, _t(grid), RES)
    ops.affine_warp(img, np.eye(2, 3), (40, 50))
    assert ops.launches == before


def test_wrappers_check_their_inputs(crop, grid):
    fr, wd = _frames(P1_FLAT)
    with pytest.raises(TypeError):
        ops.dewarp_u8(_t(crop).float(), _t(grid), RES)
    with pytest.raises(TypeError):
        ops.strips_dewarped(_t(crop), _t(fr), _t(wd).long(), 48, 256)
    with pytest.raises(ValueError):
        ops.strips_dewarped(_t(crop), _t(fr[:, :1]), _t(wd), 48, 256)
    with pytest.raises(ValueError):
        ops.remap(_t(crop).float(), _t(grid[..., :1]), 0.0)
    img = _t(crop).float()
    with pytest.raises(TypeError, match="image must be torch.float32"):
        ops.dewarp_f32(_t(crop), _t(grid), RES)
    with pytest.raises(ValueError, match=r"hv must be \(gh, gw, 2\)"):
        ops.dewarp_f32(img, _t(grid), 0)
    with pytest.raises(ValueError, match="staged_tiles is a"):
        ops.dewarp_f32(img, _t(grid), RES,
                       staged_tiles=torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match=r"matrix must be \(2, 3\)"):
        ops.affine_warp(img, np.eye(2), (10, 10))
    with pytest.raises(TypeError, match="image must be a torch.Tensor"):
        ops._check(crop, "image", torch.float32, 2, img.device)
    with pytest.raises(ValueError, match="must have 3 dims"):
        ops.remap_batch(img, (img, img))
    with pytest.raises(ValueError, match="is on cpu, expected meta"):
        ops._check(img, "image", torch.float32, 2, torch.device("meta"))
