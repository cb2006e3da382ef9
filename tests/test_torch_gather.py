"""The port's take_along_axis (ops/gather.py) against the Pallas gather
helpers it ports, `_lane_gather` / `_sublane_gather` of
origami_tpu/ops/pallas/remap.py in their "tiled" mode, run inside
pl.pallas_call(interpret=True) as scripts/pallas_gather_repro.py runs
them, and against the XLA take_along_axis of the dewarp grid build.

On the CPU the wrapper runs its plain version (torch.gather on clamped
indices). Tolerance: none — a gather moves values, so every element must
be equal.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from origami_tpu.ops.pallas.remap import _lane_gather, _sublane_gather
from origami_tpu_torch.ops import gather

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import gather_probe_case  # noqa: E402  (the probe's inputs)


def pallas_gather(kind, arr, idx):
    f = _lane_gather if kind == "lane" else _sublane_gather

    def kernel(a_ref, i_ref, o_ref):
        o_ref[...] = f(a_ref[...], i_ref[...], "tiled")

    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(idx.shape, jnp.float32),
        interpret=True)(jnp.asarray(arr), jnp.asarray(idx)))


@pytest.mark.parametrize("kind", ["lane", "sublane"])
@pytest.mark.parametrize("pattern", ["identity", "affine", "random"])
@pytest.mark.parametrize("rwc", [(8, 128, 128), (8, 384, 256)])
def test_take_along_axis_equals_pallas_probe(kind, pattern, rwc):
    arr, idx, truth = gather_probe_case(kind, *rwc, pattern)
    want = pallas_gather(kind, arr, idx)
    axis = 1 if kind == "lane" else 0
    got = gather.take_along_axis(torch.from_numpy(arr),
                                 torch.from_numpy(idx), axis).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, truth)


@pytest.mark.parametrize("kind", ["lane", "sublane"])
def test_out_of_range_indices_clamp_like_pallas(kind):
    rng = np.random.default_rng(5)
    arr = rng.standard_normal((8, 256) if kind == "lane"
                              else (256, 128)).astype(np.float32)
    n = 256
    idx = rng.integers(-40, n + 40, size=(8, 128)).astype(np.int32)
    want = pallas_gather(kind, arr, idx)
    axis = 1 if kind == "lane" else 0
    got = gather.take_along_axis(torch.from_numpy(arr),
                                 torch.from_numpy(idx), axis).numpy()
    np.testing.assert_array_equal(got, want)


def test_grid_build_site_matches_xla_take_along_axis():
    """The dewarp V pass: t_sel (n_gx, n_gx - 1) with inf where a ray
    misses a segment, gathered at the argmin per row."""
    rng = np.random.default_rng(7)
    t = rng.uniform(0.0, 3.0, (64, 63)).astype(np.float32)
    t[rng.random(t.shape) < 0.7] = np.inf
    t[3] = np.inf                               # a ray with no hit
    best = np.asarray(jnp.argmin(jnp.asarray(t), axis=1))
    want = np.asarray(jnp.take_along_axis(
        jnp.asarray(t), jnp.asarray(best)[:, None], axis=1))
    tt = torch.from_numpy(t)
    got = gather.take_along_axis(
        tt, torch.argmin(tt, dim=1)[:, None].to(torch.int32), 1).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isinf(got[3, 0])


def test_wrapper_checks_its_arguments():
    src = torch.zeros((4, 8))
    idx = torch.zeros((4, 3), dtype=torch.int32)
    with pytest.raises(TypeError):
        gather.take_along_axis(src.double(), idx, 1)
    with pytest.raises(TypeError):
        gather.take_along_axis(src, idx.long(), 1)
    with pytest.raises(ValueError):
        gather.take_along_axis(src, idx, 2)
    with pytest.raises(ValueError):
        gather.take_along_axis(src, torch.zeros((5, 3), dtype=torch.int32),
                               1)
    assert gather.take_along_axis(src, idx, 1).shape == (4, 3)
    before = dict(gather.launches)
    gather.take_along_axis(src, idx, 1)
    assert gather.launches == before         # the CPU runs no kernel
