"""ops/tiling.py against origami_tpu/ops/tiling.py: the boxes are
Python integers and extraction and stitching only move values, so
everything must be equal."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from origami_tpu.ops import tiling as jax_tiling
from origami_tpu_torch.ops import tiling

# (full (W, H), tile (tw, th), beta0): the reference system's geometry,
# the students' single-tile canvas, and a small two-axis layout
GEOMETRIES = [((1280, 2400), (1280, 896), 50),
              ((1280, 2432), (1280, 2432), 50),
              ((200, 330), (96, 128), 20)]


@pytest.mark.parametrize("full,tile,beta", GEOMETRIES)
def test_boxes_equal(full, tile, beta):
    ref = jax_tiling.TileLayout(full, tile, beta0=beta)
    got = tiling.TileLayout(full, tile, beta0=beta)
    assert got.tiles == ref.tiles and len(got) == len(ref)
    np.testing.assert_array_equal(got.outer_origins, ref.outer_origins)


@pytest.mark.parametrize("full,tile,beta0",
                         [(2400, 896, 50), (100, 100, 50), (90, 100, 10),
                          (330, 128, 20), (1000, 300, 120)])
def test_axis_tiles_equal(full, tile, beta0):
    assert tiling._axis_tiles(full, tile, beta0) == \
        jax_tiling._axis_tiles(full, tile, beta0)


@pytest.mark.parametrize("full,tile,beta", GEOMETRIES)
def test_extract_and_stitch_equal(full, tile, beta):
    # a narrower canvas of the same layout keeps the big cases light
    if full[0] == 1280:
        full, tile = (full[0] // 8, full[1]), (tile[0] // 8, tile[1])
    rng = np.random.default_rng(0)
    ref_l = jax_tiling.TileLayout(full, tile, beta0=beta)
    got_l = tiling.TileLayout(full, tile, beta0=beta)
    img = rng.random((full[1], full[0], 2)).astype(np.float32)
    ref_t = np.asarray(ref_l.extract(jnp.asarray(img)))
    got_t = got_l.extract(torch.from_numpy(img))
    np.testing.assert_array_equal(got_t.numpy(), ref_t)

    logits = rng.random(ref_t.shape[:3] + (3,)).astype(np.float32)
    np.testing.assert_array_equal(
        got_l.stitch_logits(torch.from_numpy(logits), 3).numpy(),
        np.asarray(ref_l.stitch_logits(jnp.asarray(logits), 3)))
    labels = rng.integers(0, 4, ref_t.shape[:3]).astype(np.uint8)
    np.testing.assert_array_equal(
        got_l.stitch_labels(torch.from_numpy(labels)).numpy(),
        np.asarray(ref_l.stitch_labels(jnp.asarray(labels))))
