"""Higher-level polygon surgery: margins, offsets, squeeze splitting.

Port of origami_tpu/core/geometry_ops.py without cv2: the distance
transforms, components and the elliptic opening come from
geometry/contour_trace.py and geometry/raster.py, which give cv2's
results. All of it is raster-based:

  offset_polygon   grow/shrink by a distance (round joins)
  largest_inscribed_rect  axis-aligned max rectangle inside a polygon
  squeeze_split    split a polygon at its narrowest pinch when the two
                   sides are substantial (dumbbell shapes from merged
                   regions)
"""

from __future__ import annotations

import math

import numpy as np

from origami_tpu_torch import geometry as G
from origami_tpu_torch.geometry import contour_trace as _ct
from origami_tpu_torch.geometry.raster import _dilate, _erode, ellipse_kernel


def offset_polygon(poly, distance):
    return poly.buffer(distance)


def largest_inscribed_rect(poly, n_probe=64):
    """Approximate largest axis-aligned rectangle inside the polygon
    (used for text margins). Returns a G.Polygon box."""
    frame = G.raster.RasterFrame(poly.bounds)
    mask = G.raster.rasterize(poly, frame)
    dist = _ct.distance_transform(mask)
    h, w = dist.shape
    best = None
    best_area = 0.0
    ys, xs = np.unravel_index(np.argsort(dist.flatten())[-n_probe:],
                              dist.shape)
    # deep-interior seeds cluster around one distance maximum; add a
    # sparse interior grid so elongated arms are probed too
    step = max(4, min(h, w) // 8)
    gy, gx = np.nonzero(dist[::step, ::step] > 1)
    ys = np.concatenate([ys, gy * step])
    xs = np.concatenate([xs, gx * step])
    for cy, cx in zip(ys, xs):
        # the inscribed square of the distance-r circle has half-side
        # r/sqrt(2) — start from a square guaranteed inside
        r = dist[cy, cx] / math.sqrt(2.0)
        if r < 1:
            continue
        x0, x1 = cx - r, cx + r
        y0, y1 = cy - r, cy + r
        for _ in range(32):
            grown = False
            for dx0, dy0, dx1, dy1 in ((-2, 0, 0, 0), (0, -2, 0, 0),
                                       (0, 0, 2, 0), (0, 0, 0, 2)):
                nx0, ny0 = x0 + dx0, y0 + dy0
                nx1, ny1 = x1 + dx1, y1 + dy1
                if nx0 < 0 or ny0 < 0 or nx1 >= w or ny1 >= h:
                    continue
                sub = mask[int(ny0):int(ny1) + 1, int(nx0):int(nx1) + 1]
                if sub.size and sub.all():
                    x0, y0, x1, y1 = nx0, ny0, nx1, ny1
                    grown = True
            if not grown:
                break
        area = (x1 - x0) * (y1 - y0)
        if area > best_area:
            best_area = area
            best = (x0, y0, x1, y1)
    if best is None:
        return poly.envelope
    p0 = frame.to_world([[best[0], best[1]]])[0]
    p1 = frame.to_world([[best[2], best[3]]])[0]
    return G.box(p0[0], p0[1], p1[0], p1[1])


def squeeze_split(poly, max_neck_ratio=0.3, min_part_ratio=0.2):
    """Split a pinched polygon at its narrowest neck.

    The neck is found by morphological opening with increasing radius:
    the smallest radius whose opening splits the mask into >= 2 large
    components defines the cut. Returns [poly] if no meaningful pinch
    exists, else the parts.
    """
    if poly.is_empty or poly.area <= 0:
        return [poly]
    frame = G.raster.RasterFrame(poly.bounds)
    mask = G.raster.rasterize(poly, frame)
    dist = _ct.distance_transform(mask)
    max_r = int(dist.max())
    if max_r < 3:
        return [poly]
    total = int(mask.sum())
    for r in range(2, int(max_r * max_neck_ratio) + 1):
        k = ellipse_kernel(r)
        opened = _dilate(_erode(mask, k), k)
        n, labels, stats = _ct.connected_components_with_stats(opened)
        big = [i for i in range(1, n)
               if stats[i, _ct.CC_STAT_AREA] >= total * min_part_ratio]
        if len(big) >= 2:
            # assign every original pixel to its nearest big component
            parts = []
            seeds = np.zeros_like(mask, dtype=np.int32)
            for idx, i in enumerate(big):
                seeds[labels == i] = idx + 1
            # nearest-seed via distance transform labels
            inv = (seeds == 0).astype(np.uint8)
            _, lab = _ct.distance_transform_with_labels(inv)
            # map pixel-labels back to seed ids
            seed_ids = np.zeros(int(lab.max()) + 1, dtype=np.int32)
            ys, xs = np.nonzero(seeds)
            seed_ids[lab[ys, xs]] = seeds[ys, xs]
            assigned = seed_ids[lab] * mask
            for idx in range(1, len(big) + 1):
                m = (assigned == idx).astype(np.uint8)
                geom = G.raster.vectorize(m, frame)
                if geom.is_empty:
                    continue
                if geom.geom_type == "MultiPolygon":
                    parts.extend(geom.geoms)
                else:
                    parts.append(geom)
            if len(parts) >= 2:
                return parts
    return [poly]
