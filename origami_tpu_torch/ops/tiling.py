"""Overlapping tile layout + tile batch extraction/merging.

Port of origami_tpu/ops/tiling.py. The segmentation nets run on
fixed-size tiles cut from the resized page with a guaranteed minimum
overlap; each tile "owns" an inner region whose boundaries sit midway
between neighbouring tile edges, and the label map is stitched from the
inner regions. Tile boxes are static Python data; extraction and stitch
are plain slicing.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch


def _axis_tiles(full, tile, beta0):
    """1-D tile layout: [((outer0, outer1), (inner0, inner1))]: the
    fewest tiles such that consecutive tiles overlap by at least `beta0`
    pixels; inner boundaries are the midpoints of the overlaps."""
    if tile >= full:
        return [((0, full), (0, full))]
    n = math.ceil(full / tile)
    while n > 1:
        step = (full - tile) / (n - 1)
        if tile - step >= beta0:
            break
        n += 1
    starts = []
    for i in range(n):
        s = round(i * (full - tile) / max(n - 1, 1))
        starts.append(min(s, full - tile))
    out = []
    for i, s in enumerate(starts):
        o0, o1 = s, s + tile
        i0 = 0 if i == 0 else (starts[i - 1] + tile + s) // 2
        i1 = full if i == n - 1 else (o1 + starts[i + 1]) // 2
        out.append(((o0, o1), (i0, i1)))
    return out


class TileLayout:
    """Static tile layout over a (W, H) canvas with (tw, th) tiles."""

    def __init__(self, full_size, tile_size, beta0=50):
        self.full_size = tuple(full_size)    # (W, H)
        self.tile_size = tuple(tile_size)    # (tw, th)
        self.beta0 = beta0
        xs = _axis_tiles(full_size[0], tile_size[0], beta0)
        ys = _axis_tiles(full_size[1], tile_size[1], beta0)
        self.tiles = []
        for (yo, yi), (xo, xi) in itertools.product(ys, xs):
            self.tiles.append(dict(
                outer=(xo[0], yo[0], xo[1], yo[1]),
                inner=(xi[0], yi[0], xi[1], yi[1])))

    def __len__(self):
        return len(self.tiles)

    @property
    def outer_origins(self):
        return np.array([[t["outer"][1], t["outer"][0]] for t in self.tiles],
                        dtype=np.int32)  # (T, 2) as (y, x)

    def extract(self, image):
        """Cut the (H, W, C) image into a (T, th, tw, C) tile batch."""
        tw, th = self.tile_size
        return torch.stack([image[y: y + th, x: x + tw]
                            for y, x in self.outer_origins.tolist()])

    def _stitch(self, tiles, out):
        for i, t in enumerate(self.tiles):
            x0, y0, x1, y1 = t["inner"]
            ox0, oy0 = t["outer"][0], t["outer"][1]
            out[y0:y1, x0:x1] = tiles[i, y0 - oy0: y1 - oy0,
                                      x0 - ox0: x1 - ox0]
        return out

    def stitch_labels(self, tile_labels):
        """Merge per-tile label maps (T, th, tw) into the (H, W) label
        map, each tile writing only its inner region."""
        W, H = self.full_size
        return self._stitch(tile_labels, torch.zeros(
            (H, W), dtype=tile_labels.dtype, device=tile_labels.device))

    def stitch_logits(self, tile_logits, num_classes):
        """Merge per-tile logits (T, th, tw, C) into (H, W, C), inner
        regions only."""
        W, H = self.full_size
        return self._stitch(tile_logits, torch.zeros(
            (H, W, num_classes), dtype=tile_logits.dtype,
            device=tile_logits.device))
