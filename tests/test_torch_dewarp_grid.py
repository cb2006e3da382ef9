"""The port's dewarp grid build (ops/grid.grid_scan, GridFactory,
Grid) against the JAX package's build_grid_device, on the CPU.

Tolerances, each with its reason:
  * grid nodes: <= 1e-3 px. Both sides run float32; the IDW sums over
    1024 padded samples reduce in another order, and the two scans chain
    about 150 dependent steps on coordinates near 1e3 px (an ulp is
    6e-5 px there). Measured: 1.3e-4 px on the 400x300 pages below,
    3.7e-4 px at the fixture's 1312x1920 (scripts/torch_parity_gaps.py);
  * the grid's shape, Grid.warping on the same grid, transformer_points
    (host float64 Newton, a copy): exact.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from origami_tpu.core import dewarp as jax_dewarp
from origami_tpu.core.flow import Samples as JaxSamples
from origami_tpu.core.math import Geometry as JaxGeometry
from origami_tpu_torch.core import dewarp
from origami_tpu_torch.core.flow import Samples
from origami_tpu_torch.core.math import Geometry
from origami_tpu_torch.ops import gather, grid

TOL_PX = 1e-3


def seeded_samples(seed, w, h, n=60):
    """H samples near 0 rad and V samples near pi/2 with a smooth warp
    and noise, over a w x h page."""
    rng = np.random.default_rng(seed)
    out = []
    for base in (0.0, math.pi / 2):
        pts = np.c_[rng.uniform(0, w, n), rng.uniform(0, h, n)]
        phi = base + 0.03 * np.sin(pts[:, 0] / 70.0) \
            + rng.normal(0, 0.01, n)
        out.append((pts, phi))
    return out


def jax_grid(samples, w, h, res=25):
    (hp, hphi), (vp, vphi) = samples
    sh = JaxSamples(JaxGeometry(w, h), hp, hphi)
    sv = JaxSamples(JaxGeometry(w, h), vp, vphi)
    return jax_dewarp.GridFactory((w, h), sh, sv, grid_res=res)()


def port_grid(samples, w, h, res=25):
    (hp, hphi), (vp, vphi) = samples
    sh = Samples(Geometry(w, h), hp, hphi)
    sv = Samples(Geometry(w, h), vp, vphi)
    return dewarp.Grid.create((w, h), sh, sv, grid_res=res, device="cpu")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_build_grid_matches_build_grid_device(seed):
    s = seeded_samples(seed, 400, 300)
    want = jax_grid(s, 400, 300)
    got = port_grid(s, 400, 300)
    assert got.points("sample").shape == want.points("sample").shape \
        == (24, 24, 2)
    assert got.points("sample").dtype == np.float32
    diff = np.abs(got.points("sample") - want.points("sample")).max()
    assert diff <= TOL_PX, diff


def test_build_grid_without_samples_is_the_regular_lattice():
    """No samples: the fields fall back to 0 and pi/2, every step is a
    plain field step or a hit on the next row."""
    empty = Samples(Geometry(200, 150))
    grid = dewarp.Grid.create((200, 150), empty, empty, grid_res=25,
                              device="cpu")
    jempty = JaxSamples(JaxGeometry(200, 150))
    want = jax_dewarp.GridFactory((200, 150), jempty, jempty,
                                  grid_res=25)()
    np.testing.assert_allclose(grid.points("sample"),
                               want.points("sample"), atol=TOL_PX)
    ys, xs = np.mgrid[0:grid.points("sample").shape[0],
                      0:grid.points("sample").shape[1]]
    np.testing.assert_allclose(grid.points("sample")[..., 0],
                               xs * 25.0 - 50.0, atol=1e-3)
    np.testing.assert_allclose(grid.points("sample")[..., 1],
                               ys * 25.0 - 50.0, atol=1e-3)


@pytest.mark.parametrize("size", [(400, 300), (1312, 1920), (1000, 999)])
def test_grid_shape_and_padding_like_jax(size):
    w, h = size
    f = dewarp.GridFactory(size, Samples(Geometry(w, h)),
                           Samples(Geometry(w, h)), device="cpu")
    n_gy, n_gx = f.shape()
    assert n_gx % 8 == 0 and n_gy % 8 == 0
    assert n_gx == jax_dewarp._round_up(math.ceil(w / 25) + 6, 8)
    assert n_gy == jax_dewarp._round_up(math.ceil(h / 25) + 6, 8)
    pts, phi, mask = dewarp._pad_samples([(1.5, 2.5)], [0.25], 1024)
    jp = jax_dewarp._pad_samples([(1.5, 2.5)], [0.25], 1024)
    for a, b in zip((pts, phi, mask), jp):
        np.testing.assert_array_equal(a, b)


def test_grid_host_transforms_equal_jax():
    s = seeded_samples(4, 400, 300)
    hv = jax_grid(s, 400, 300).points("sample")
    mine = dewarp.Grid(hv, 25)
    ref = jax_dewarp.Grid(hv, 25)
    rng = np.random.default_rng(3)
    pts = rng.uniform(0, 400, (200, 2))
    np.testing.assert_array_equal(mine.transformer_points(pts),
                                  ref.transformer_points(pts))
    np.testing.assert_array_equal(mine.inverse_points(pts),
                                  ref.inverse_points(pts))
    assert mine.warping == ref.warping
    assert mine.geometry.size == ref.geometry.size
    xs, ys = mine.transformer(pts[:, 0], pts[:, 1])
    np.testing.assert_array_equal(np.c_[xs, ys],
                                  ref.transformer_points(pts))


def test_field_eval_matches_jax():
    rng = np.random.default_rng(9)
    pts = rng.uniform(0, 300, (40, 2)).astype(np.float32)
    sxy = rng.uniform(0, 300, (64, 2)).astype(np.float32)
    phi = rng.normal(0, 0.1, 64).astype(np.float32)
    mask = (rng.random(64) < 0.7).astype(np.float32)
    want = np.asarray(jax_dewarp._field_eval(
        jnp.asarray(pts), jnp.asarray(sxy), jnp.asarray(phi),
        jnp.asarray(mask), 0.0))
    got = grid._field_eval(*(torch.from_numpy(a) for a in
                               (pts, sxy, phi, mask)), 0.0).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6)


def test_cpu_build_launches_no_kernel():
    before = dict(gather.launches), dict(grid.launches)
    port_grid(seeded_samples(5, 200, 150, n=10), 200, 150)
    assert (gather.launches, grid.launches) == before
    assert grid.launches == {"grid_scan_h": 0, "grid_scan_v": 0}
