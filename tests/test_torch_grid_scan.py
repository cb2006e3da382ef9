"""The dewarp grid scans (ops/grid.py: grid_scan, whose CUDA kernels are
csrc/grid.cu, and build_grid_plain, which the wrapper runs on the CPU)
against the JAX package's build_grid_device, and the dewarp kernel's
plain version on a strongly sheared grid, on the CPU.

Tolerances, each with its reason:
  * grid nodes: <= 1e-3 px (the bar of tests/test_torch_dewarp_grid.py):
    both sides run float32 and sum the IDW weights over 1024 padded
    samples in another order; the scans chain ~40 dependent steps here;
  * the argmin and gather of t: exact (they choose and move values);
  * dewarp vs the JAX dense route: <= 1 gray level (the port rounds, the
    dense route truncates).
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from origami_tpu.core import dewarp as jax_dewarp
from origami_tpu.core.dewarp import _jitted_dewarp_fns
from origami_tpu_torch.ops import grid
from origami_tpu_torch.ops import remap as ops

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import grid_case  # noqa: E402  (phase 2's cases)

TOL_PX = 1e-3
RES = 25


def jax_build(padded, shape):
    n_gy, n_gx = shape
    return np.asarray(jax_dewarp.build_grid_device(
        *map(jnp.asarray, padded), n_gy=n_gy, n_gx=n_gx, res=RES))


def port_build(padded, shape, best=None):
    return grid.grid_scan(*map(torch.from_numpy, padded), *shape, RES,
                          best=best).numpy()


@pytest.fixture
def hits(monkeypatch):
    """Every t_best the plain V scan takes."""
    seen = []
    nearest = grid._nearest_hit

    def record(t_sel):
        best, t_best = nearest(t_sel)
        seen.append(t_best.clone())
        return best, t_best

    monkeypatch.setattr(grid, "_nearest_hit", record)
    return seen


@pytest.mark.parametrize("kind", ["seeded", "miss", "upward"])
def test_grid_scan_matches_build_grid_device(kind, hits):
    padded, shape = grid_case(kind, 400, 300)
    want = jax_build(padded, shape)
    got = port_build(padded, shape)
    assert got.shape == want.shape == (24, 24, 2)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= TOL_PX
    misses = int(sum((~torch.isfinite(t)).sum() for t in hits))
    assert len(hits) == shape[0] - 1
    # rays that find no hit on the next row take the field step
    want_misses = {"seeded": (0, 0), "miss": (20, 200),
                   "upward": ((shape[0] - 1) * shape[1],) * 2}[kind]
    assert want_misses[0] <= misses <= want_misses[1], misses


def test_empty_mask_gives_the_lattice_with_ties(hits):
    padded, shape = grid_case("empty", 200, 150)
    assert not any(a.any() for a in padded[2::3])     # no sample weighs
    best = torch.zeros((shape[0] - 1, shape[1]), dtype=torch.int32)
    got = port_build(padded, shape, best=best)
    np.testing.assert_allclose(got, jax_build(padded, shape), atol=TOL_PX)
    ys, xs = np.mgrid[0:shape[0], 0:shape[1]]
    np.testing.assert_allclose(got[..., 0], xs * 25.0 - 50.0, atol=1e-3)
    np.testing.assert_allclose(got[..., 1], ys * 25.0 - 50.0, atol=1e-3)
    # each ray passes through a vertex of the next row, the end of
    # segment j - 1 (u = 1) and the start of segment j (u = 0): the two
    # give the same t, and the lower index wins
    b = best.numpy()
    np.testing.assert_array_equal(b[:, 1:], np.tile(np.arange(shape[1] - 1),
                                                    (shape[0] - 1, 1)))
    assert all(torch.isfinite(t).all() for t in hits)


def test_nearest_hit_follows_jnp_argmin():
    """NaN before every number, lowest index on ties, index 0 when every
    t is inf; then the gather of t at that index."""
    inf, nan = np.inf, np.nan
    t = np.array([
        [3.0, 1.0, 2.0, 1.0, 5.0],       # tie: the first 1.0
        [3.0, nan, 0.5, nan, 1.0],       # the first NaN wins
        [inf, inf, inf, inf, inf],       # a ray with no hit
        [inf, 2.0, inf, 2.0, inf],
        [nan, 1.0, 1.0, 0.0, nan],
        [0.0, -0.0, 7.0, inf, 1e-7],     # -0 == 0: the lower index
    ], dtype=np.float32)
    want_best = np.asarray(jnp.argmin(jnp.asarray(t), axis=1))
    want_t = np.asarray(jnp.take_along_axis(
        jnp.asarray(t), jnp.asarray(want_best)[:, None], axis=1))[:, 0]
    best, t_best = grid._nearest_hit(torch.from_numpy(t))
    np.testing.assert_array_equal(best.numpy(), want_best)
    np.testing.assert_array_equal(best.numpy(), [1, 1, 0, 1, 0, 0])
    np.testing.assert_array_equal(t_best.numpy(), want_t)


def test_grid_scan_checks_its_arguments():
    padded, shape = grid_case("seeded", 200, 150, n=10)
    args = list(map(torch.from_numpy, padded))
    with pytest.raises(TypeError):
        grid.grid_scan(args[0].double(), *args[1:], *shape, RES)
    with pytest.raises(ValueError):                     # (S, 3) points
        grid.grid_scan(torch.zeros((1024, 3)), *args[1:], *shape, RES)
    with pytest.raises(ValueError):                     # S differs
        grid.grid_scan(*args[:5], args[5][:10], *shape, RES)
    with pytest.raises(ValueError):
        grid.grid_scan(*args, 1, shape[1], RES)
    with pytest.raises(TypeError):
        grid.grid_scan(*args, *shape, RES,
                       best=torch.zeros((shape[0] - 1, shape[1])))
    with pytest.raises(ValueError):
        grid.grid_scan(*args, *shape, RES,
                       best=torch.zeros(shape, dtype=torch.int32))


def test_cpu_build_counts_no_launch():
    padded, shape = grid_case("seeded", 200, 150, n=10)
    before = dict(grid.launches)
    port_build(padded, shape)
    assert grid.launches == before == {"grid_scan_h": 0, "grid_scan_v": 0}


@pytest.fixture(scope="module")
def crop():
    from origami_tpu_torch.core import _png
    page = _png.read_gray(Path(__file__).resolve().parent
                          / "data/torch_ocr/full/synth0001.png")
    return np.ascontiguousarray(page[700:900, 250:550])       # (200, 300)


def test_dewarp_plain_matches_jax_dense_route_on_a_sheared_grid(crop):
    """A grid sheared 0.6 px per px along x and 0.35 along y, with a
    wave: each 4x4-cell tile's source window is about twice its output
    (chip_smoke.py phase 2 holds the kernel to this plain version on
    both of its tile routes)."""
    gh, gw = 14, 18
    ii, jj = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
    x = -40.0 + RES * jj + 0.6 * RES * ii + 3.1 * np.sin(ii / 2.3)
    y = -160.0 + RES * ii + 0.35 * RES * jj + 2.7 * np.cos(jj / 3.1)
    hv = np.stack([x, y], -1).astype(np.float32)
    ref = np.asarray(_jitted_dewarp_fns()[1](
        jnp.asarray(crop), jnp.asarray(hv), jnp.ones(2, jnp.float32), RES))
    got = ops.dewarp_u8(torch.from_numpy(crop), torch.from_numpy(hv),
                        RES).numpy()
    assert got.shape == ref.shape == (gh * RES, gw * RES)
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    assert (got != 255).sum() > 0.3 * crop.size       # the page is there
    with pytest.raises(ValueError):                   # a card-only count
        ops.dewarp_u8(torch.from_numpy(crop), torch.from_numpy(hv), RES,
                      staged_tiles=torch.zeros(1, dtype=torch.int32))
