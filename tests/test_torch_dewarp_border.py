"""The page dewarp's two borders (ops/remap.dewarp_u8, border "hard" and
"fill_taps") against the live JAX Dewarper, which takes the banded route
(ops/remap.dewarp_banded_u8: its passes pad the page with the fill, and
it rounds) where Grid.banded_plan gives a plan, else the dense route
(taps clamped into the page, the sample the fill outside it; clipped and
truncated, core/dewarp.py:459-482).

Tolerances, each with its reason:
  * the fixture pages' own grids and a crafted separable grid that
    samples 0.7-1.5 px past every page edge (banded route): every pixel
    within 1 gray level, none beyond. The banded route is a two-pass
    resample, equal to the direct bilinear sample for a separable map
    but for float32 rounding (a non-separable grid twists the two
    passes apart: ROADMAP C3);
  * a sheared grid without a banded plan (dense route): within 1 gray
    level — the same bilinear sample, truncated the same way, with the
    grid upsampled by another formula (an ulp can cross an integer).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from origami_tpu.core.dewarp import Dewarper as JaxDewarper
from origami_tpu.core.dewarp import Grid as JaxGrid
from origami_tpu_torch.core import _png
from origami_tpu_torch.core.dewarp import Dewarper, Grid
from origami_tpu_torch.ops import remap as ops

ROOT = Path(__file__).resolve().parent.parent
FULL = ROOT / "tests/data/torch_ocr/full"
RES = 25


def _both(page, hv, res):
    want = np.asarray(JaxDewarper(page, JaxGrid(hv, res)).dewarped)
    got = Dewarper(torch.from_numpy(page), Grid(hv, res)).dewarped_dev
    return got.numpy().astype(int), want.astype(int)


@pytest.fixture(scope="module")
def crop():
    page = _png.read_gray(FULL / "synth0001.png")
    return np.ascontiguousarray(page[700:900, 250:550])       # (200, 300)


@pytest.mark.parametrize("stem", ["synth0000", "synth0001"])
def test_page_dewarp_is_the_jax_banded_route(stem):
    page = _png.read_gray(FULL / (stem + ".png"))
    grid = JaxGrid.open(FULL / (stem + ".out") / "dewarp.zip")
    assert grid.banded_plan(page.shape) is not None
    assert Grid(grid._hv, grid.resolution).has_banded_plan(page.shape)
    got, want = _both(page, grid._hv, grid.resolution)
    d = np.abs(got - want)
    assert d.max() <= 1
    assert (d > 1).sum() == 0            # 4,340 with the hard edge
    # the hard edge alone is what the port dewarped with before
    hard = ops.dewarp_u8(torch.from_numpy(page),
                         torch.from_numpy(grid._hv), grid.resolution,
                         255.0, "hard").numpy().astype(int)
    assert (np.abs(hard - want) > 1).sum() > 1000


def test_fill_taps_past_the_page_edge(crop):
    h, w = crop.shape
    u, v = np.linspace(0, 1, 14), np.linspace(0, 1, 10)
    x = -0.7 + u * (w - 1 + 0.7 + 1.5) + 3.0 * np.sin(np.pi * u)
    y = -1.5 + v * (h - 1 + 1.5 + 1.1) + 2.0 * np.sin(np.pi * v)
    hv = np.stack(np.meshgrid(x, y), -1).astype(np.float32)
    got, want = _both(crop, hv, RES)
    d = np.abs(got - want)
    assert d.max() <= 1
    assert (got != 255).sum() > 0.5 * crop.size     # the page is there
    # past the edge the hard border gives the fill; these taps blend
    hard = ops.dewarp_u8(torch.from_numpy(crop), torch.from_numpy(hv), RES,
                         255.0, "hard").numpy()
    assert ((hard == 255) & (got < 255)).sum() > 100


def test_hard_edge_is_the_dense_route_without_a_plan(crop):
    gh, gw = 14, 18
    ii, jj = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
    x = -40.0 + RES * jj + 0.6 * RES * ii + 3.1 * np.sin(ii / 2.3)
    y = -160.0 + RES * ii + 0.35 * RES * jj + 2.7 * np.cos(jj / 3.1)
    hv = np.stack([x, y], -1).astype(np.float32)
    assert JaxGrid(hv, RES).banded_plan(crop.shape) is None
    assert not Grid(hv, RES).has_banded_plan(crop.shape)
    got, want = _both(crop, hv, RES)
    d = np.abs(got - want)
    assert d.max() <= 1
    assert (d > 0).mean() < 1e-3


def test_fill_taps_semantics_and_checks():
    page = torch.arange(12, dtype=torch.uint8).reshape(3, 4) * 20
    # a one-node grid per 1-px cell: sample at (-0.5, 1) and (3.5, 1)
    hv = torch.tensor([[[-0.5, 1.0], [3.5, 1.0]]], dtype=torch.float32)
    out = ops.dewarp_u8(page, hv, 1, 255.0, "fill_taps")
    assert out.tolist() == [[round((255 + 80) / 2), round((140 + 255) / 2)]]
    assert ops.dewarp_u8(page, hv, 1, 255.0, "hard").tolist() == [[255, 255]]
    with pytest.raises(ValueError, match="border"):
        ops.dewarp_u8(page, hv, 1, 255.0, "zeros")
    with pytest.raises(ValueError, match="integer fill"):
        ops.dewarp_u8(page, hv, 1, 127.5, "fill_taps")
