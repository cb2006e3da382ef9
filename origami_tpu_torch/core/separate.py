"""Separator store: typed H/V/T separator polylines with spatial queries.

Port of origami_tpu/core/separate.py (`extract_segments`, `Separators`,
`ObstacleSampler`): per-separator labels and widths, an STRtree over the
geometries, obstacle checks within bounds, and the XY-cut gap scorer of
the order stage, which weighs a gap's whitespace by the separator length
that flows along the cut against the length that crosses it (:99-294).
"""

from __future__ import annotations

import numpy as np

from origami_tpu_torch import geometry as G
from origami_tpu_torch.core.segment import PredictorType


def extract_segments(geom):
    t = geom.geom_type
    if t in ("LineString", "LinearRing"):
        return [geom]
    if t == "MultiLineString":
        return list(geom.geoms)
    if t in ("Point", "MultiPoint"):
        return []
    if t == "GeometryCollection":
        out = []
        for g in geom.geoms:
            out.extend(extract_segments(g))
        return out
    if t in ("Polygon", "MultiPolygon"):
        # treat thin polygons as their exterior
        out = []
        for p in (geom.geoms if t == "MultiPolygon" else [geom]):
            out.append(p.exterior)
        return out
    return []


class Separators:
    def __init__(self, segmentation, separators, widths=None):
        self._predictions = {}
        for p in segmentation.predictions:
            if p.type == PredictorType.SEPARATOR:
                self._predictions[p.name] = p
        self._by_path = dict(separators)
        self._names = {}
        self._by_label = {}
        geoms = []
        for parts, geom in self._by_path.items():
            pred = self._predictions[parts[0]]
            label = pred.classes[parts[1]]
            self._by_label.setdefault(label, []).append(geom)
            self._names[id(geom)] = "/".join(parts)
            geoms.append(geom)
        self._geoms = geoms
        self._widths = widths or {}
        self._tree = G.STRtree(geoms)

    @property
    def by_path(self):
        return self._by_path

    @property
    def geoms(self):
        return self._geoms

    def name(self, geom):
        return self._names[id(geom)]

    def query(self, shape):
        return self._tree.query(shape)

    def label(self, name):
        pname, plabel = name.split("/")[:2]
        return self._predictions[pname].classes[plabel]

    def for_label(self, name):
        return self._by_label.get(self.label(name), [])

    def width(self, name):
        return self._widths.get(tuple(name.split("/")), 1)

    def check_obstacles(self, bounds, obstacles, fringe=0):
        minx, miny, maxx, maxy = bounds
        cx, cy = (minx + maxx) / 2, (miny + maxy) / 2
        minx = min(minx + fringe, cx)
        maxx = max(maxx - fringe, cx)
        miny = min(miny + fringe, cy)
        maxy = max(maxy - fringe, cy)
        labels = set(self.label(o) for o in obstacles)
        bx = G.box(minx, miny, maxx, maxy)
        for sep in self.query(bx):
            if self.label(self.name(sep)) in labels and bx.intersects(sep):
                return True
        return False


# the separator labels the gap scorer weighs, and the axis each runs
# along (0: horizontal, 1: vertical)
_DIRECTIONS = {"H": 0, "V": 1, "T": 1}


class ObstacleSampler:
    """Scores an XY-cut gap: whitespace area, boosted by separators
    running parallel to the cut (reading-flow evidence), penalized by
    separators crossing it; optionally biased by separator thickness."""

    def __init__(self, separators, thickness_delta=None):
        self._seps = separators
        self._thickness_delta = thickness_delta
        self._direction = {}
        for name, axis in _DIRECTIONS.items():
            try:
                self._direction[separators.label("separators/" + name)] = axis
            except KeyError:
                pass
        # flatten every scored separator polyline into ONE segment
        # array: the sampler runs for each of the hundreds of cut
        # candidates per page, and per-call STRtree queries + exact
        # polygon clips dominated the order stage; an axis-aligned
        # gap box clips all segments at once (Liang-Barsky below)
        segs, axes, widths = [], [], []
        for geom in separators.geoms:
            name = separators.name(geom)
            axis = self._direction.get(separators.label(name))
            if axis is None:
                continue
            w = separators.width(name)
            for ls in extract_segments(geom):
                c = np.asarray(ls.np_coords, np.float64)
                if len(c) < 2:
                    continue
                s = np.concatenate([c[:-1], c[1:]], axis=1)  # (m, 4)
                segs.append(s)
                axes.append(np.full(len(s), axis, np.int8))
                widths.append(np.full(len(s), w, np.float64))
        if segs:
            self._segs = np.concatenate(segs)
            self._axes = np.concatenate(axes)
            self._widths = np.concatenate(widths)
        else:
            self._segs = np.zeros((0, 4))
            self._axes = np.zeros(0, np.int8)
            self._widths = np.zeros(0)

    @staticmethod
    def _union_len_grouped(k_idx, lo, hi, n_groups):
        """Per-group total covered length of the union of [lo, hi]
        intervals, group k_idx[i] holding interval i."""
        out = np.zeros(n_groups)
        if not len(k_idx):
            return out
        order = np.lexsort((lo, k_idx))
        k = k_idx[order]
        lo = lo[order]
        hi = hi[order]
        # segmented running max of hi (groups are contiguous after the
        # lexsort; the +k*BIG shift makes accumulate reset per group)
        big = max(float(np.abs(hi).max()), 1.0) * 4.0 + 4.0
        run = np.maximum.accumulate(hi + k * big) - k * big
        same = k[1:] == k[:-1]
        gaps = np.where(same, np.maximum(lo[1:] - run[:-1], 0.0), 0.0)
        starts = np.flatnonzero(
            np.concatenate(([True], ~same)))
        ends = np.concatenate((starts[1:] - 1, [len(k) - 1]))
        totals = run[ends] - lo[starts]
        if len(gaps):
            gsum = np.add.reduceat(
                np.concatenate((gaps, [0.0])), starts)
            # reduceat over gaps[start..next_start-1]: the gap at index
            # i spans intervals i,i+1 which belong to the same group by
            # construction (same mask), so this bins correctly
            totals = totals - gsum
        out[k[starts]] = totals
        return out

    def score_many(self, gaps):
        """Scores of many gaps: one (K, M) Liang-Barsky clip + segmented
        union sweeps (a per-gap call was the order stage's hottest host
        path — thousands of candidate gaps per page)."""
        K = len(gaps)
        if K == 0:
            return np.zeros(0)
        du = np.array([g.du for g in gaps])
        dv = np.array([g.dv for g in gaps])
        base = du * dv
        small = (du < 0.5) | (dv < 0.5)
        if not len(self._segs):
            return np.where(small, 0.0, base)
        bounds = np.array([g.bounds for g in gaps], np.float64)
        gaxis = np.array([g.axis for g in gaps])
        pad = 5.0
        x0 = bounds[:, 0] - pad
        y0 = bounds[:, 1] - pad
        x1 = bounds[:, 2] + pad
        y1 = bounds[:, 3] + pad
        s = self._segs
        M = len(s)
        dx = (s[:, 2] - s[:, 0])[None, :]
        dy = (s[:, 3] - s[:, 1])[None, :]
        sx = s[:, 0][None, :]
        sy = s[:, 1][None, :]
        t0 = np.zeros((K, M))
        t1 = np.ones((K, M))
        ok = np.ones((K, M), bool)
        for p, q in ((-dx, sx - x0[:, None]), (dx, x1[:, None] - sx),
                     (-dy, sy - y0[:, None]), (dy, y1[:, None] - sy)):
            par = np.broadcast_to(p == 0, (K, M))
            ok &= ~(par & (q < 0))
            with np.errstate(divide="ignore", invalid="ignore"):
                r = q / np.where(p == 0, 1.0, p)
            ent = ~par & np.broadcast_to(p < 0, (K, M))
            ext = ~par & np.broadcast_to(p > 0, (K, M))
            t0 = np.where(ent, np.maximum(t0, r), t0)
            t1 = np.where(ext, np.minimum(t1, r), t1)
        ok &= t0 <= t1
        ax = sx + t0 * dx
        ay = sy + t0 * dy
        bx_ = sx + t1 * dx
        by = sy + t1 * dy
        # per-gap axis selection of the u (gap axis) / v coordinates
        ga = gaxis[:, None]
        au = np.where(ga == 0, ax, ay)
        bu = np.where(ga == 0, bx_, by)
        av = np.where(ga == 0, ay, ax)
        bv = np.where(ga == 0, by, bx_)
        # DEVIATION from the reference scorer (origami/core/
        # separate.py:111-162), which measured coverage over the
        # PADDED catchment box and let the thickness delta shift the
        # obstacle ratio by ±2: (a) a rule that merely TOUCHES or stops
        # AT a gutter (a masthead rule broken at the column separators)
        # counted as a crossing obstacle and drove full-height column
        # cuts negative; (b) a short thick rule could flip a cut that
        # three column separators CROSS to hugely positive. Here only
        # the portion strictly INSIDE the unpadded gap counts, both
        # ratios are clamped to [0, 1] (a fully crossed gap scores 0,
        # never negative), and the thickness bonus scales WITH flow
        # coverage so it cannot rescue a crossed cut.
        umin = np.array([g.minu for g in gaps])
        umax = np.array([g.maxu for g in gaps])
        vmin_ = np.array([g.minv for g in gaps])
        vmax_ = np.array([g.maxv for g in gaps])
        olo = np.clip(np.minimum(au, bu), umin[:, None], umax[:, None])
        ohi = np.clip(np.maximum(au, bu), umin[:, None], umax[:, None])
        um = ok & (self._axes[None, :] == ga) & (ohi > olo)
        flo = np.clip(np.minimum(av, bv), vmin_[:, None], vmax_[:, None])
        fhi = np.clip(np.maximum(av, bv), vmin_[:, None], vmax_[:, None])
        vm = ok & ~(self._axes[None, :] == ga) & (fhi > flo)
        ku, su_ = np.nonzero(um)
        obst_cov = self._union_len_grouped(ku, olo[um], ohi[um], K)
        kv, sv_ = np.nonzero(vm)
        vlo = flo[vm]
        vhi = fhi[vm] + 1
        flow_cov = self._union_len_grouped(kv, vlo, vhi, K)
        flow_score = np.clip(flow_cov / np.maximum(dv, 1e-12), 0.0, 1.0)
        obst_score = np.clip(obst_cov / np.maximum(du, 1e-12), 0.0, 1.0)
        if self._thickness_delta is not None and len(kv):
            ws = self._widths[sv_]
            weights = vhi - vlo - 1
            wsum = np.bincount(kv, weights=weights, minlength=K)
            wmean = np.zeros(K)
            has = np.bincount(kv, minlength=K) > 0
            num = np.bincount(kv, weights=ws * weights, minlength=K)
            pos = wsum > 0
            wmean[pos] = num[pos] / wsum[pos]
            # zero-weight groups fall back to the plain mean
            zw = has & ~pos
            if zw.any():
                cnt = np.bincount(kv, minlength=K)
                msum = np.bincount(kv, weights=ws, minlength=K)
                wmean[zw] = msum[zw] / cnt[zw]
            dt = np.array([self._thickness_delta(w) if h else 0.0
                           for w, h in zip(wmean, has)])
        else:
            dt = 0.0
        out = base * (1 - obst_score) * (1 + flow_score * (1 + dt))
        return np.where(small, 0.0, out)
