"""GT separator segments: robust polyline fitting + merge strategies.

Port of origami_tpu/train/segment/segments.py, host code: one polyline
per 8-connected component of a GT separator mask (the components of
geometry/contour_trace.connected_components_with_stats, which numbers
them as cv2.connectedComponentsWithStats does), scored by its fit error,
then the four merge strategies (by_quality, by_distance with an obstacle
veto, parallel, by_length) as a config-driven pipeline. The output is
clean merged polylines per separator class, from which regions.py builds
the master annotations and the stopper geometry.
"""

from __future__ import annotations

import numpy as np

from origami_tpu_torch import geometry as G
from origami_tpu_torch.core.polyline import (
    Polyline, estimate_polyline, polyline_from_polygon)
from origami_tpu_torch.core.contours import find_contour_polygons
from origami_tpu_torch.geometry.contour_trace import (
    connected_components_with_stats)


def _fit_error(comp, pl, max_samples=400):
    """Mean distance of component pixels to the fitted polyline,
    normalized by stroke width (the reference scores segments the same
    way and filters on it, gen/merger.py filter_by_quality)."""
    ys, xs = np.nonzero(comp)
    if len(xs) == 0:
        return 0.0
    if len(xs) > max_samples:
        sel = np.linspace(0, len(xs) - 1, max_samples).astype(int)
        xs, ys = xs[sel], ys[sel]
    line = pl.line_string
    d = [line.distance(G.Point(float(x), float(y)))
         for x, y in zip(xs, ys)]
    return float(np.mean(d) / max(pl.width, 1.0))


def extract_segments(mask, orientation, min_px=12):
    """Fit one polyline per connected component of a GT separator mask."""
    m = (np.asarray(mask) > 0).astype(np.uint8)
    n, labels, stats = connected_components_with_stats(m)
    out = []
    for i in range(1, n):
        if stats[i, 4] < min_px:
            continue
        x0, y0, w, h = stats[i, 0], stats[i, 1], stats[i, 2], stats[i, 3]
        comp = np.pad(labels[y0:y0 + h, x0:x0 + w] == i, 2)
        pl = estimate_polyline(comp, orientation, simplify_tol=2.0)
        if pl is None:
            polys = find_contour_polygons(comp)
            if polys:
                pl = polyline_from_polygon(polys[0], orientation, 2.0)
        if pl is not None and not pl.is_empty:
            err = _fit_error(comp, pl)
            out.append(Polyline(
                pl.np_coords + np.array([x0 - 2, y0 - 2]), pl.width,
                error=err))
    return out


def _endpoints(pl):
    c = pl.np_coords
    return c[0], c[-1]


def _direction(pl):
    a, b = _endpoints(pl)
    d = b - a
    n = np.linalg.norm(d)
    return d / n if n > 1e-9 else np.array([1.0, 0.0])


def _join_blocked(a_pt, b_pt, obstacles, corridor=2):
    """True if the straight corridor between two join endpoints crosses
    obstacle pixels (the reference's SegmentJoiner consults the label
    raster the same way so e.g. a TABCOL never merges across body text,
    gen/segments.py SegmentJoiner.join)."""
    if obstacles is None:
        return False
    h, w = obstacles.shape
    n = max(2, int(np.linalg.norm(b_pt - a_pt)))
    ts = np.linspace(0.0, 1.0, n)
    pts = a_pt[None, :] * (1 - ts[:, None]) + b_pt[None, :] * ts[:, None]
    xs = np.clip(np.round(pts[:, 0]).astype(int), 0, w - 1)
    ys = np.clip(np.round(pts[:, 1]).astype(int), 0, h - 1)
    for dy in range(-corridor, corridor + 1):
        yy = np.clip(ys + dy, 0, h - 1)
        if obstacles[yy, xs].any():
            return True
    return False


def merge_by_distance(polylines, max_gap=20.0, max_angle=0.2,
                      obstacles=None):
    """Chain fragments whose endpoints nearly touch and whose directions
    agree (reference merger strategy 'by_distance'); an optional
    obstacle mask vetoes joins whose corridor crosses foreign ink."""
    polylines = list(polylines)
    merged = True
    while merged and len(polylines) > 1:
        merged = False
        for i in range(len(polylines)):
            for j in range(i + 1, len(polylines)):
                a, b = polylines[i], polylines[j]
                da, db = _direction(a), _direction(b)
                cross = da[0] * db[1] - da[1] * db[0]
                if abs(float(cross)) > max_angle:
                    continue
                # try all endpoint pairings
                ae = _endpoints(a)
                be = _endpoints(b)
                best = None
                for ai, ap in enumerate(ae):
                    for bi, bp in enumerate(be):
                        d = float(np.linalg.norm(ap - bp))
                        if d <= max_gap and (best is None or d < best[0]):
                            best = (d, ai, bi)
                if best is None:
                    continue
                _, ai, bi = best
                if _join_blocked(_endpoints(a)[ai], _endpoints(b)[bi],
                                 obstacles):
                    continue
                ca = a.np_coords if ai == 1 else a.np_coords[::-1]
                cb = b.np_coords if bi == 0 else b.np_coords[::-1]
                la = a.line_string.length
                lb = b.line_string.length
                w = (a.width * la + b.width * lb) / max(la + lb, 1e-9)
                err = (a.error * la + b.error * lb) / max(la + lb, 1e-9)
                polylines[i] = Polyline(np.vstack([ca, cb]), w, err)
                del polylines[j]
                merged = True
                break
            if merged:
                break
    return polylines


def merge_parallel(polylines, max_offset=8.0, overlap_frac=0.5):
    """Collapse near-duplicate parallel strokes (double-drawn GT lines)
    into the longer one (reference strategy 'parallel')."""
    out = []
    used = [False] * len(polylines)
    order = np.argsort([-p.line_string.length for p in polylines])
    for oi in order:
        if used[oi]:
            continue
        keeper = polylines[oi]
        used[oi] = True
        kl = keeper.line_string
        for j in range(len(polylines)):
            if used[j]:
                continue
            other = polylines[j]
            mid = other.line_string.interpolate(0.5, normalized=True)
            if kl.is_empty:
                continue
            d = kl.distance(mid)
            if d <= max_offset and other.line_string.length \
                    <= kl.length / max(overlap_frac, 1e-9):
                used[j] = True
        out.append(keeper)
    return out


def filter_by_length(polylines, min_length=25.0):
    """Drop specks (reference strategy 'by_length')."""
    return [p for p in polylines if p.line_string.length >= min_length]


def filter_by_quality(polylines, max_error=0.5, min_length=0.02,
                      shape=None):
    """Drop badly-fitting or short segments (reference strategy
    'by_quality', gen/merger.py:44-48): error is the normalized fit
    residual, min_length is relative to the page scale min(H, W) when
    `shape` is given, else absolute pixels."""
    scale = min(shape) if shape is not None else 1.0
    return [p for p in polylines
            if p.error < max_error
            and p.line_string.length >= min_length * scale]


STRATEGIES = dict(
    by_distance=merge_by_distance,
    parallel=merge_parallel,
    by_length=filter_by_length,
    by_quality=filter_by_quality,
)


def run_merge_pipeline(polylines, pipeline, obstacles=None, shape=None):
    """Config-driven merge pipeline (the reference's merge_spec
    ['segments']['pipeline'] form): a list of {'strategy': name,
    'args': {...}} stages applied in order. All four reference
    strategies are available; 'by_distance' consults the obstacle mask,
    'by_quality' the page shape."""
    for stage in pipeline:
        f = STRATEGIES[stage["strategy"]]
        args = dict(stage.get("args", {}))
        if stage["strategy"] == "by_distance" and obstacles is not None:
            args.setdefault("obstacles", obstacles)
        if stage["strategy"] == "by_quality" and shape is not None:
            args.setdefault("shape", shape)
        polylines = f(polylines, **args)
    return polylines


DEFAULT_PIPELINE = [
    dict(strategy="by_quality", args=dict(max_error=0.75,
                                          min_length=0.01)),
    dict(strategy="by_distance", args=dict(max_gap=20.0)),
    dict(strategy="parallel", args=dict()),
    dict(strategy="by_length", args=dict(min_length=25.0)),
]


def clean_separators(mask, orientation, max_gap=20.0, min_length=25.0,
                     obstacles=None):
    """Full GT cleanup pipeline: fit -> quality -> chain -> dedupe ->
    filter."""
    segs = extract_segments(mask, orientation)
    pipeline = [
        dict(strategy="by_quality",
             args=dict(max_error=0.75, min_length=0.0)),
        dict(strategy="by_distance", args=dict(max_gap=max_gap)),
        dict(strategy="parallel", args=dict()),
        dict(strategy="by_length", args=dict(min_length=min_length)),
    ]
    return run_merge_pipeline(segs, pipeline, obstacles=obstacles,
                              shape=np.asarray(mask).shape)
