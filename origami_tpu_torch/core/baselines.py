"""Tesseract-free text-line (baseline) detection.

Port of origami_tpu/core/baselines.py (host numpy; a copy with the
geometry imports pointed at origami_tpu_torch.geometry).

The reference delegates baseline detection to the Tesseract C++ API
(origami/core/block.py:504-567, AnalyseLayout with PSM SINGLE_BLOCK) —
identified in SURVEY.md §7 as the riskiest dependency to replace. This
module implements a projection-profile detector over device-binarized
block crops:

  1. estimate the block's text skew (shear sweep, same scoring as
     core.flow._patch_skews but over the whole crop);
  2. build the sheared row ink profile, smooth it, and segment it into
     text bands at an adaptive threshold;
  3. per band: column extent from the column ink profile, baseline from
     the per-column lowest-ink-pixel distribution, x-height/ascent/
     descent from band shape.

Emits the same detection payload the pipeline stores in lines zips
(baseline endpoints, ascent/descent/height — docs/formats.md#lineszip).
A forced "fake line" covering the whole block is produced when nothing is
detected (reference behavior: origami/core/block.py:484-502).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


@dataclass
class DetectedLine:
    p: np.ndarray          # bottom-left of the line rectangle
    right: np.ndarray      # along-baseline vector
    up: np.ndarray         # height vector
    baseline: tuple        # ((x0, y0), (x1, y1))
    ascent: float
    descent: float
    height: float
    fake: bool = False
    clipped_top: bool = False     # band touched the crop's top edge
    clipped_bottom: bool = False  # band touched the crop's bottom edge

    @property
    def data(self):
        return dict(
            baseline=[list(map(float, self.baseline[0])),
                      list(map(float, self.baseline[1]))],
            ascent=float(self.ascent),
            descent=float(self.descent),
            height=float(self.height))


def _smooth(x, k):
    if k <= 1 or len(x) < 3:
        return x
    kernel = np.ones(k) / k
    return np.convolve(x, kernel, mode="same")


def estimate_skew(ink, max_angle=0.12, n_angles=25, hint=None,
                  max_ds=4):
    """Skew angle maximizing sheared-projection variance. ink: (H, W)
    float mask (1 = ink).

    Evaluated from per-column profiles: shearing shifts whole columns,
    so each candidate angle is a bincount over (row + shift[col]) with
    column-profile weights — O(n_angles * H * W) via np.bincount.

    With `hint` (e.g. the page-level skew), only a fine-pitch window
    around it is scored, hill-climbing outward while a window edge
    wins — typically 7 evaluations instead of a full sweep (the lines
    stage estimates skew for every region crop)."""
    h, w = ink.shape
    if h < 4 or w < 4 or ink.sum() < 4:
        return 0.0
    # estimate on a downsampled crop — small angles survive 2-4x
    # decimation and the bincounts get proportionally cheaper
    ds = 1
    while (h // ds) * (w // ds) > 256 * 512 and ds < max_ds:
        ds *= 2
    if ds > 1:
        hh, ww = (h // ds) * ds, (w // ds) * ds
        ink = ink[:hh, :ww].reshape(h // ds, ds, w // ds, ds) \
            .sum(axis=(1, 3))
        h, w = ink.shape
    xs = np.arange(w) - w / 2.0
    rows = np.arange(h)
    # score every candidate over the SAME profile length: variance over
    # per-angle-sized profiles is biased toward larger shears (more
    # zero bins), which systematically picked one grid step off zero
    span = int(np.ceil(np.tan(max_angle) * (w / 2.0))) + 1
    length = h + 2 * span
    # the rounded shift is a monotone step function of the column, so
    # columns group into <= 2*span+1 runs per angle; one column-prefix
    # sum turns each run's row profile into two lookups — O(#runs * h)
    # per angle instead of O(h * w)
    cum = np.concatenate(
        [np.zeros((h, 1), ink.dtype), np.cumsum(ink, axis=1)], axis=1)
    prof = np.empty(length, np.float64)

    def score(a):
        shift = np.round(np.tan(a) * xs).astype(np.int64)
        change = np.flatnonzero(np.diff(shift)) + 1
        starts = np.concatenate(([0], change))
        ends = np.concatenate((change, [w]))
        prof[:] = 0.0
        for c0, c1 in zip(starts, ends):
            s = int(shift[c0]) + span
            prof[s:s + h] += cum[:, c1]
            prof[s:s + h] -= cum[:, c0]
        return prof.var()

    def search(angles):
        # candidates by increasing |angle| so score ties (common after
        # decimation, where neighboring shears round to identical
        # shifts) resolve toward zero skew, not the most negative
        angles = angles[np.argsort(np.abs(angles), kind="stable")]
        best_a, best_s = 0.0, -1.0
        for a in angles:
            sc = score(a)
            if sc > best_s:
                best_s, best_a = sc, float(a)
        return best_a

    fine_pitch = 2 * max_angle / (n_angles - 1)
    if hint is not None:
        # windowed hill-climb around the hint: evaluate hint +- 2
        # steps, then extend past whichever edge keeps winning
        cache = {}

        def ev(a):
            a = round(min(max_angle, max(-max_angle, a)), 12)
            if a not in cache:
                cache[a] = score(a)
            return a

        for k in range(-2, 3):
            ev(hint + k * fine_pitch)
        while True:
            best = max(cache, key=lambda a: (cache[a], -abs(a)))
            grew = False
            for nb in (best - fine_pitch, best + fine_pitch):
                nb = round(min(max_angle, max(-max_angle, nb)), 12)
                if nb not in cache:
                    cache[nb] = score(nb)
                    grew = True
            if not grew:
                return best

    # coarse-to-fine: a coarse sweep then a local refinement around the
    # winner evaluates ~half the candidates of a flat n_angles sweep
    # at the same final resolution (the variance objective is smooth
    # at the coarse pitch)
    n_coarse = max(5, (n_angles + 1) // 2)
    pitch = 2 * max_angle / (n_coarse - 1)
    coarse = search(np.linspace(-max_angle, max_angle, n_coarse))
    offs = np.arange(-2, 3) * fine_pitch
    cand = np.clip(coarse + offs, -max_angle, max_angle)
    cand = cand[np.abs(offs) < pitch]
    return search(np.unique(cand))


def detect_baselines(crop_binarized, origin=(0, 0), min_line_height=4,
                     force_one=False, max_angle=0.12, skew_hint=None):
    """Detect text lines in a binarized crop (True = paper).

    Returns a list of DetectedLine in page coordinates (crop offset by
    `origin`).
    """
    ink = (~np.asarray(crop_binarized, dtype=bool)).astype(np.float32)
    h, w = ink.shape
    origin = np.asarray(origin, dtype=np.float64)
    if h < min_line_height or w < 2 or ink.sum() < min_line_height:
        return [_fake_line(origin, w, h)] if force_one else []

    angle = estimate_skew(ink, max_angle=max_angle, hint=skew_hint)
    tan_a = math.tan(angle)
    xs = np.arange(w) - w / 2.0
    shift = tan_a * xs
    # integer per-column shear shift; round(r + shift) == r + round(shift)
    # for integer r, so band membership reduces to a per-column row range
    rs = np.round(shift).astype(np.int64)

    # sheared row profile: rs is monotone in the column index, so the
    # shift groups are contiguous runs — one column-prefix sum turns
    # each run's column-sum into two lookups (the per-unique-shift
    # boolean mask + masked sum was ~30% of detect_baselines)
    cum1 = np.concatenate(
        [np.zeros((h, 1), np.float32), np.cumsum(ink, axis=1)], axis=1)
    change = np.flatnonzero(np.diff(rs)) + 1
    starts = np.concatenate(([0], change))
    ends = np.concatenate((change, [w]))
    prof = np.zeros(h, np.float64)
    for c0, c1 in zip(starts, ends):
        colsum = cum1[:, c1] - cum1[:, c0]
        s = int(rs[c0])
        if s == 0:
            prof += colsum
        elif s > 0:                      # rows clipped into h-1
            s = min(s, h)
            prof[s:] += colsum[: h - s]
            prof[h - 1] += colsum[h - s:].sum()
        else:                            # rows clipped into 0
            s = max(s, -h)
            prof[: h + s] += colsum[-s:]
            prof[0] += colsum[: -s].sum()
    sm = _smooth(prof, 3)

    thresh = max(0.08 * sm.max(), 0.5)
    on = sm > thresh

    # segment into bands: transitions of the on/off mask (the per-row
    # Python scan was ~1 ms per 1000-row crop)
    edges = np.flatnonzero(np.diff(on.astype(np.int8)))
    ups = list(edges[~on[edges]] + 1)       # off -> on at index+1
    downs = list(edges[on[edges]] + 1)      # on -> off at index+1
    if on[0]:
        ups.insert(0, 0)
    if on[h - 1]:
        downs.append(h)
    bands = list(zip(ups, downs))

    # merge bands separated by tiny gaps, drop dwarf bands
    merged = []
    for b in bands:
        if merged and b[0] - merged[-1][1] <= max(1, min_line_height // 4):
            merged[-1] = (merged[-1][0], b[1])
        else:
            merged.append(list(b))
    med_h = np.median([b[1] - b[0] for b in merged]) if merged else 0
    bands = [b for b in merged
             if b[1] - b[0] >= max(min_line_height, 0.3 * med_h)]

    if not bands:
        return [_fake_line(origin, w, h)] if force_one else []

    # one-time prefix structures, then ONE vectorized pass over ALL
    # bands (the per-band loop with its per-band reduces and quantile
    # calls was ~60% of detect_baselines on a 35-line column block)
    col_arange = np.arange(w)
    cum0 = np.zeros((h + 1, w), np.float32)
    np.cumsum(ink, axis=0, out=cum0[1:])        # cum0[r] = sum of rows < r
    rows_or_neg = np.where(ink > 0, np.arange(h)[:, None], -1)
    last_ink = np.maximum.accumulate(rows_or_neg, axis=0)

    y0s = np.asarray([b[0] for b in bands])
    y1s = np.asarray([b[1] for b in bands])
    # per-column row range of each sheared band: profile row
    # p = r + rs[c]  =>  r in [y0 - rs, y1 - rs), clipped to the crop
    r0 = np.clip(y0s[:, None] - rs[None, :], 0, h)      # (B, w)
    r1 = np.clip(y1s[:, None] - rs[None, :], 0, h)
    col_ink = cum0[r1, col_arange] - cum0[r0, col_arange]
    has_ink = col_ink > 0
    any_ink = has_ink.any(axis=1)
    x0s = np.argmax(has_ink, axis=1)
    x1s = w - np.argmax(has_ink[:, ::-1], axis=1)
    # last ink row < r1, and the 0.85-quantile of the per-column
    # lowest ink position in profile (sheared) space: row + shift(x)
    li = last_ink[np.maximum(r1 - 1, 0), col_arange]
    has = has_ink & (li >= r0) & (r1 > r0)
    # per-band 0.85-quantile of the valid entries, vectorized: sort
    # valid-first (inf padding) and linearly interpolate — equivalent
    # to np.quantile(valid, 0.85) per band, but np.nanquantile routes
    # through a per-band Python apply_along_axis (~4 ms/35-line block)
    lowest = np.where(has, li + shift[None, :], np.inf)
    lowest.sort(axis=1)
    cnt = has.sum(axis=1)
    q = 0.85 * np.maximum(cnt - 1, 0)
    lo_i = np.floor(q).astype(np.int64)
    hi_i = np.minimum(lo_i + 1, np.maximum(cnt - 1, 0))
    frac = q - lo_i
    rows_b = np.arange(len(bands))
    with np.errstate(invalid="ignore"):
        base_ys = np.where(
            cnt > 0,
            lowest[rows_b, lo_i] * (1.0 - frac)
            + lowest[rows_b, hi_i] * frac,
            np.nan)

    out = []
    for bi, (y0, y1) in enumerate(bands):
        if not any_ink[bi] or x1s[bi] - x0s[bi] < 2 \
                or not np.isfinite(base_ys[bi]):
            continue
        x0, x1 = int(x0s[bi]), int(x1s[bi])
        base_y = float(base_ys[bi])
        band_h = max(float(y1 - y0), min_line_height)
        descent = max(0.0, min(0.35 * band_h, y1 - base_y))
        ascent = max(base_y - y0, min_line_height * 0.5)
        height = ascent

        def to_page(x, y_prof):
            # invert the shear: y_img = y_prof - tan(a) * (x - w/2)
            yy = y_prof - tan_a * (x - w / 2.0)
            return origin + np.array([x, yy])

        p1 = to_page(x0, base_y)
        p2 = to_page(x1, base_y)
        right = p2 - p1
        n = np.array([-right[1], right[0]])
        n = n / (math.hypot(right[0], right[1]) + 1e-9)
        if n[1] > 0:
            n = -n          # ensure "up" points to smaller y (image up)
        up_vec = n * (ascent + descent)
        p_bottom = p1 + (-n) * descent
        out.append(DetectedLine(
            p=p_bottom, right=right, up=up_vec,
            baseline=(tuple(p1), tuple(p2)),
            ascent=ascent, descent=descent, height=height,
            clipped_top=(y0 <= 0), clipped_bottom=(y1 >= h)))

    if not out and force_one:
        return [_fake_line(origin, w, h)]
    return out


def _fake_line(origin, w, h):
    p = origin + np.array([0.0, float(h)])
    return DetectedLine(
        p=p, right=np.array([float(w), 0.0]), up=np.array([0.0, -float(h)]),
        baseline=(tuple(origin + [0.0, h * 0.8]),
                  tuple(origin + [float(w), h * 0.8])),
        ascent=h * 0.8, descent=h * 0.2, height=float(h), fake=True)


def unclip_band(det, page_band_h):
    """Restore a crop-clipped band to page-typical height.

    A region contour crossing mid-row (e.g. segmentation
    under-covering a table title by a few px) clips the detected band
    at the crop edge; the over-magnified partial glyphs then decode to
    garbage. When a band touched the crop edge AND is well below the
    page's median band height, extend it outward past the crop — the
    extractor samples the page, not the crop, so the full glyphs are
    recovered."""
    from dataclasses import replace
    if det.fake or page_band_h <= 0:
        return det
    bh = det.ascent + det.descent
    if bh >= 0.7 * page_band_h:
        return det
    if not (det.clipped_top or det.clipped_bottom):
        return det
    n = det.up / (np.linalg.norm(det.up) + 1e-9)
    grow = min(page_band_h - bh, 0.8 * page_band_h)
    p, up = det.p, det.up
    ascent, descent = det.ascent, det.descent
    if det.clipped_top and det.clipped_bottom:
        p = p - n * (grow / 2)
        up = up + n * grow
        ascent += grow / 2
        descent += grow / 2
    elif det.clipped_top:
        up = up + n * grow
        ascent += grow
    else:
        p = p - n * grow
        up = up + n * grow
        descent += grow
    return replace(det, p=p, up=up, ascent=ascent, descent=descent,
                   height=ascent)


def extend_baselines(text_area, frames):
    """Batched extend_baseline over all of one block's detected lines.

    frames: [(p, right, up), ...] in page coordinates. Returns
    [(p, right), ...]. One _seg_intersections + one containment call
    for the whole block (the per-line probe clip was ~0.5 s/6 pages
    of flow+lines host time)."""
    import math as _math
    from origami_tpu_torch.geometry.ops import (_seg_intersections,
                                          _segments_of,
                                          _contains_points)
    n = len(frames)
    if n == 0:
        return []
    minx, miny, maxx, maxy = text_area.bounds
    span = _math.hypot(maxx - minx, maxy - miny) * 2
    a0 = np.empty((n, 2))
    a1 = np.empty((n, 2))
    dirs = np.empty((n, 2))
    for i, (p, right, up) in enumerate(frames):
        d = right / (np.linalg.norm(right) + 1e-9)
        mid = p + right / 2
        a0[i] = mid - d * span
        a1[i] = mid + d * span
        dirs[i] = d
    psegs = _segments_of(text_area)
    segs = np.c_[a0, a1]
    pts, ia, ib = _seg_intersections(segs, psegs)
    d_full = a1 - a0
    L2 = np.maximum((d_full * d_full).sum(axis=1), 1e-12)
    ts_by_probe = [[0.0, 1.0] for _ in range(n)]
    if len(pts):
        t_hit = np.clip(((pts - a0[ia]) * d_full[ia]).sum(axis=1)
                        / L2[ia], 0.0, 1.0)
        for k, i in enumerate(ia):
            ts_by_probe[i].append(float(t_hit[k]))
    # every candidate span midpoint of every probe in ONE containment
    mids = []
    spans_by_probe = []
    for i in range(n):
        ts = sorted(set(round(t, 12) for t in ts_by_probe[i]))
        spans = [(t0, t1) for t0, t1 in zip(ts[:-1], ts[1:])
                 if t1 - t0 >= 1e-12]
        spans_by_probe.append(spans)
        for t0, t1 in spans:
            mids.append(a0[i] + (t0 + t1) * 0.5 * d_full[i])
    ins = _contains_points(text_area, np.asarray(mids).reshape(-1, 2)) \
        if mids else np.zeros(0, bool)
    out = []
    off = 0
    for i, (p, right, up) in enumerate(frames):
        spans = spans_by_probe[i]
        k = len(spans)
        # merge runs of consecutive inside spans (they share endpoints
        # by construction) — matches _clip_line's piece stitching
        best = None
        best_len = -1.0
        run = None
        for (t0, t1), is_in in zip(
                list(spans) + [(None, None)],
                list(ins[off: off + k]) + [False]):
            if is_in:
                run = (run[0], t1) if run is not None else (t0, t1)
            elif run is not None:
                if run[1] - run[0] > best_len:
                    best_len = run[1] - run[0]
                    best = run
                run = None
        off += k
        if best is None:
            out.append((p, right))
            continue
        q0 = a0[i] + best[0] * d_full[i]
        q1 = a0[i] + best[1] * d_full[i]
        if np.dot(q1 - q0, right) < 0:
            q0, q1 = q1, q0
        out.append((q0, q1 - q0))
    return out


def extend_baseline(text_area, p, right, up):
    """Extend a line frame so `right` spans the full text area width at
    the line's vertical position (reference `_extended_baseline`,
    origami/core/block.py)."""
    from origami_tpu_torch import geometry as G
    minx, miny, maxx, maxy = text_area.bounds
    d = right / (np.linalg.norm(right) + 1e-9)
    span = math.hypot(maxx - minx, maxy - miny) * 2
    mid = p + right / 2
    probe = G.LineString([mid - d * span, mid + d * span])
    clipped = probe.intersection(text_area)
    if clipped.is_empty:
        return p, right
    best = None
    if clipped.geom_type == "LineString":
        best = clipped
    else:
        segs = [g for g in clipped.geoms if g.geom_type == "LineString"]
        if segs:
            best = max(segs, key=lambda s: s.length)
    if best is None:
        return p, right
    c = best.np_coords
    q0, q1 = c[0], c[-1]
    if np.dot(q1 - q0, right) < 0:
        q0, q1 = q1, q0
    return q0, q1 - q0
