"""Recursive XY-cut reading order.

Port of origami_tpu/core/xycut.py (host numpy, unchanged).

Implements the recursive XY-cut family (Ha, Haralick & Phillips 1995, as
used by the reference origami/core/xycut.py:187-319): sweep the sorted
interval endpoints on each axis, score candidate cut gaps (whitespace
area / width / cut length, or a caller-supplied scorer such as the
separator-aware ObstacleSampler), resolve overlapping boxes by splitting
them to the closer side, and recurse. `flat` mode yields a total order;
`grouped` mode keeps ambiguous overlap sets together so callers can
re-cut them at line level.

Pure NumPy on host — the candidate generation is vectorized over
endpoints rather than per-pair Python loops.
"""

from __future__ import annotations

import numpy as np


class _Item:
    __slots__ = ("name", "bounds")

    def __init__(self, name, bounds):
        self.name = name
        self.bounds = np.asarray(bounds, dtype=np.float64)  # minx,miny,maxx,maxy


class GapInfo:
    """A candidate cut gap handed to scorers.

    axis: 0 = vertical cut line sweeping x, 1 = horizontal sweeping y.
    (minu, maxu) = gap extent along the swept axis; (minv, maxv) = the
    perpendicular extent of the group being cut.
    """

    __slots__ = ("axis", "minu", "maxu", "minv", "maxv")

    def __init__(self, axis, minu, maxu, minv, maxv):
        self.axis = axis
        self.minu = minu
        self.maxu = maxu
        self.minv = minv
        self.maxv = maxv

    @property
    def du(self):
        return self.maxu - self.minu

    @property
    def dv(self):
        return self.maxv - self.minv

    @property
    def bounds(self):
        if self.axis == 0:
            return (self.minu, self.minv, self.maxu, self.maxv)
        return (self.minv, self.minu, self.maxv, self.maxu)


SCORES = dict(
    largest_area=lambda gap: gap.du * gap.dv,
    widest_gap=lambda gap: gap.du,
    longest_cut=lambda gap: gap.dv,
)


def _axis_candidates(bounds, idx, axis, score, eps, min_extent=0.1):
    """All candidate cuts on one axis: (score, cut_x, axis, is_overlap).

    bounds is the full (N, 4) matrix built once per reading_order call;
    idx selects the current recursion subset (the per-level list
    comprehensions + Python endpoint sweep were ~65% of the order
    stage's host time)."""
    lo = bounds[idx, axis]
    hi = bounds[idx, axis + 2]
    hi = np.where(hi <= lo, lo + min_extent, hi)
    vlo = bounds[idx, 1 - axis]
    vhi = bounds[idx, 3 - axis]
    vext = np.maximum(vhi - vlo, min_extent)
    vmin, vmax = float(vlo.min()), float(vhi.max())

    # endpoint sweep: starts sort before ends at equal x (stable sort,
    # starts first in the concatenation) — the active count therefore
    # never dips to zero between an end and a coincident start
    n = len(idx)
    xs = np.concatenate([lo, hi])
    delta = np.concatenate([np.ones(n, np.int64), -np.ones(n, np.int64)])
    order = np.argsort(xs, kind="stable")
    xs = xs[order]
    active = np.cumsum(delta[order])

    x0s, x1s = xs[:-1], xs[1:]
    act = active[:-1]
    valid = x0s > xs[0] + eps
    out = []
    gap_i = np.nonzero(valid & (act == 0) & (x1s > x0s))[0]
    if len(gap_i):
        gaps = [GapInfo(axis, float(x0s[i]), float(x1s[i]), vmin, vmax)
                for i in gap_i]
        if hasattr(score, "score_many"):
            # one vectorized pass over all candidate gaps (the per-gap
            # ObstacleSampler call dominated the order stage)
            for sv, i in zip(score.score_many(gaps), gap_i):
                out.append((float(sv), float(x0s[i]), axis, False))
        else:
            for g, i in zip(gaps, gap_i):
                out.append((score(g), float(x0s[i]), axis, False))
    # a usable cut boundary needs content STRICTLY on both sides —
    # the trailing edge (x0 = the subset's max end) slices nothing
    # and must not compete as a zero-error candidate
    ov = np.nonzero(valid & (act > 0) & (x0s < float(hi.max())))[0]
    if len(ov):
        # overlap error at boundary x0: sum over the items open there
        # of vext * distance to the nearer interval end. Openness via
        # strict inequalities matches the sweep's open_set semantics:
        # an interval touching x0 at either end contributes zero error
        # either way.
        x0v = x0s[ov][:, None]
        open_m = (lo[None, :] < x0v) & (hi[None, :] > x0v)
        err = (np.minimum(np.abs(x0v - lo[None, :]),
                          np.abs(x0v - hi[None, :]))
               * vext[None, :] * open_m).sum(axis=1)
        for k, i in enumerate(ov):
            # zero penetration = intervals merely TOUCH at x0 (the
            # sweep keeps coincident end/start boundaries active) — a
            # clean cut in everything but the sweep's bookkeeping.
            # Only a cut that actually slices into an item marks the
            # node ambiguous; flagging touch-cuts as overlap made
            # mode="grouped" flatten a whole 27-region page into one
            # y-sorted line group (composed CER 0.71 on that page).
            e = float(err[k])
            out.append((-e, float(x0s[i]), axis, e > 0.0))
    return out


def _split(bounds, idx, axis, cut, min_extent=0.1):
    lo = bounds[idx, axis]
    hi = bounds[idx, axis + 2]
    hi = np.where(hi <= lo, lo + min_extent, hi)
    left = hi <= cut
    right = lo > cut
    strad = ~(left | right)
    # straddles the cut: attach to the closer side
    closer_right = strad & (np.abs(cut - lo) < np.abs(cut - hi))
    a_m = left | (strad & ~closer_right)
    b_m = right | closer_right
    a = idx[a_m]
    b = idx[b_m]
    if not len(a):
        k = int(np.argmin(lo[b_m]))
        a = b[k: k + 1]
        b = np.delete(b, k)
    elif not len(b):
        k = int(np.argmax(hi[a_m]))
        b = a[k: k + 1]
        a = np.delete(a, k)
    return a, b


class _Node:
    __slots__ = ("a", "b", "overlap", "leaves")

    def __init__(self, a=None, b=None, overlap=False, leaves=None):
        self.a = a
        self.b = b
        self.overlap = overlap
        self.leaves = leaves


def _cut(items, score, eps, min_extent):
    bounds = np.array([it.bounds for it in items],
                      np.float64).reshape(-1, 4)
    return _cut_idx(items, bounds, np.arange(len(items)), score, eps,
                    min_extent)


def _cut_idx(items, bounds, idx, score, eps, min_extent):
    if len(idx) <= 1:
        return _Node(leaves=[items[i] for i in idx])
    cands = (_axis_candidates(bounds, idx, 0, score, eps, min_extent)
             + _axis_candidates(bounds, idx, 1, score, eps, min_extent))
    if not cands:
        return _Node(leaves=[items[i] for i in idx], overlap=True)
    s, x, axis, is_overlap = max(cands, key=lambda c: c[0])
    a, b = _split(bounds, idx, axis, x, min_extent)
    if max(len(a), len(b)) >= len(idx):
        return _Node(leaves=[items[i] for i in idx], overlap=is_overlap)
    # order the two sides: lower coordinate first (top/left first)
    return _Node(a=_cut_idx(items, bounds, a, score, eps, min_extent),
                 b=_cut_idx(items, bounds, b, score, eps, min_extent),
                 overlap=is_overlap)


def _flatten(node, out):
    if node.leaves is not None:
        out.extend(it.name for it in node.leaves)
    else:
        _flatten(node.a, out)
        _flatten(node.b, out)


def _groups(node, out):
    if node.leaves is not None:
        if node.leaves:
            out.append([it.name for it in node.leaves])
    elif node.overlap:
        flat = []
        _flatten(node, flat)
        out.append(flat)
    else:
        _groups(node.a, out)
        _groups(node.b, out)


def reading_order(named_bounds, mode="flat", score="widest_gap", eps=0.0,
                  min_extent=0.1):
    """Order (name, bounds) items. Returns a flat name list or, in
    'grouped' mode, a list of name groups (ambiguous overlaps together)."""
    if isinstance(score, str):
        score = SCORES[score]
    items = [_Item(n, b) for n, b in named_bounds]
    if not items:
        return []
    root = _cut(items, score, eps, min_extent)
    out = []
    if mode == "flat":
        _flatten(root, out)
    elif mode == "grouped":
        _groups(root, out)
    else:
        raise ValueError(mode)
    return out


def polygon_order(named_polygons, fringe=0.0, **kwargs):
    """Order (name, polygon) pairs by recursive XY-cut of their bounds,
    inset by `fringe` (reference origami/core/xycut.py:311-319)."""
    nb = []
    for name, poly in named_polygons:
        minx, miny, maxx, maxy = poly.bounds
        cx, cy = (minx + maxx) / 2, (miny + maxy) / 2
        minx = min(minx + fringe, cx)
        maxx = max(maxx - fringe, cx)
        miny = min(miny + fringe, cy)
        maxy = max(maxy - fringe, cy)
        nb.append((name, (minx, miny, maxx, maxy)))
    return reading_order(nb, **kwargs)
