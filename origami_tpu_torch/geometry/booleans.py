"""Exact boolean operations on general (non-convex, holed) polygons.

Overlay by arrangement + side classification, in three steps:

  1. subdivide: split every input edge at ALL its intersections with
     the other edges (vectorized pairwise segment intersection,
     including collinear-overlap endpoints) — afterwards edges meet
     only at shared endpoints;
  2. classify: walk the planar faces of the FULL arrangement
     (half-edges, angular successor) and label every face with one
     membership bit per input via parity BFS — crossing an edge
     toggles the inputs that traced it an odd number of times; one
     geometric probe per connected component seeds the propagation.
     An edge lies on the RESULT boundary iff its two faces differ
     under the operation (and/or/diff/xor, or any n-ary member
     function for union_all);
  3. reconstruct: re-walk the boundary-edge graph; cycles whose left
     face is in the result become shells (CCW) or holes (CW), and
     holes nest into the smallest containing shell.

Compared to a Martinez–Rueda sweep this does O(n^2) vectorized
intersection work instead of O((n+k) log n) — at document scale
(region polygons of tens to hundreds of vertices) that is fast, and
the classification is purely local and geometric, so collinear
overlaps, shared vertices, vertical edges and degree-4 crossings all
fall out correctly instead of being special cases.

This replaces the rasterize/vectorize fallback for polygon×polygon
overlays (geometry/raster.py keeps serving buffers and degenerate
inputs) — layout-stage region merges stop paying the raster
half-pixel error. Reference counterpart: shapely/GEOS overlay ops
used throughout origami/batch/detect/layout.py.
"""

from __future__ import annotations

import math

import numpy as np

INTERSECTION = "and"
UNION = "or"
DIFFERENCE = "diff"
XOR = "xor"

_EPS = 1e-9
_SNAP = 1e7    # vertex snap grid (1e-7 world units)


# ---------------------------------------------------------------------------
# membership
# ---------------------------------------------------------------------------

def _even_odd_contains(rings, p):
    """Even-odd membership of point p w.r.t. a list of rings."""
    x, y = p
    inside = False
    for c in rings:
        xs, ys = c[:, 0], c[:, 1]
        x1 = np.concatenate((xs[1:], xs[:1]))
        y1 = np.concatenate((ys[1:], ys[:1]))
        cond = (ys > y) != (y1 > y)
        with np.errstate(divide="ignore", invalid="ignore"):
            xint = xs + (y - ys) / (y1 - ys) * (x1 - xs)
        if np.sum(cond & (x < xint)) % 2:
            inside = not inside
    return inside


# ---------------------------------------------------------------------------
# subdivision
# ---------------------------------------------------------------------------

def _ring_segments(rings):
    segs = []
    for ring in rings:
        c = np.asarray(ring, float)
        if len(c) >= 2 and np.allclose(c[0], c[-1]):
            c = c[:-1]
        if len(c) < 2:
            continue
        nxt = np.concatenate((c[1:], c[:1]))
        keep = np.hypot(*(nxt - c).T) > _EPS
        segs.append(np.c_[c, nxt][keep])
    if not segs:
        return np.zeros((0, 4))
    return np.vstack(segs)


def _split_params(segs):
    """For each segment, the sorted parameters of every intersection
    with every other segment (crossings, T-junctions, collinear
    overlap endpoints)."""
    n = len(segs)
    a0 = segs[:, None, 0:2]
    a1 = segs[:, None, 2:4]
    b0 = segs[None, :, 0:2]
    b1 = segs[None, :, 2:4]
    r = a1 - a0
    s = b1 - b0
    denom = r[..., 0] * s[..., 1] - r[..., 1] * s[..., 0]
    qp = b0 - a0
    cross_qp_r = qp[..., 0] * r[..., 1] - qp[..., 1] * r[..., 0]
    cross_qp_s = qp[..., 0] * s[..., 1] - qp[..., 1] * s[..., 0]
    nonpar = np.abs(denom) > _EPS
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.where(nonpar, cross_qp_s / np.where(nonpar, denom, 1.0),
                     np.nan)
        u = np.where(nonpar, cross_qp_r / np.where(nonpar, denom, 1.0),
                     np.nan)
    tol = 1e-12
    hit = nonpar & (t >= -tol) & (t <= 1 + tol) \
        & (u >= -tol) & (u <= 1 + tol)
    np.fill_diagonal(hit, False)

    params = [[] for _ in range(n)]
    ia, ib = np.nonzero(hit)
    for i, tt in zip(ia, t[ia, ib]):
        params[i].append(min(max(float(tt), 0.0), 1.0))

    # collinear overlaps: project the other segment's endpoints
    rr = np.sum(r[:, 0] ** 2, axis=-1)
    par = (~nonpar) & (np.abs(cross_qp_r) < 1e-9)
    np.fill_diagonal(par, False)
    pa, pb = np.nonzero(par)
    for i, j in zip(pa, pb):
        L = rr[i]
        if L < _EPS:
            continue
        d = segs[i, 2:4] - segs[i, 0:2]
        for q in (segs[j, 0:2], segs[j, 2:4]):
            tt = float((q - segs[i, 0:2]) @ d) / L
            if tol < tt < 1 - tol:
                params[i].append(tt)
    return params


def _subdivided_edges(all_segs, origins, n_groups):
    """Split all segments at their intersections; dedup into undirected
    snapped edges carrying crossing parities: parity[k] is True when
    crossing this edge toggles membership in input group k (an edge
    traced an odd number of times by that group's rings)."""
    params = _split_params(all_segs)
    edges = {}
    for i, seg in enumerate(all_segs):
        a = seg[0:2]
        d = seg[2:4] - a
        ts = sorted(set([0.0, 1.0] + [round(t, 12) for t in params[i]]))
        pts = [a + t * d for t in ts]
        for p, q in zip(pts[:-1], pts[1:]):
            kp = (round(p[0] * _SNAP), round(p[1] * _SNAP))
            kq = (round(q[0] * _SNAP), round(q[1] * _SNAP))
            if kp == kq:
                continue
            key = (kp, kq) if kp < kq else (kq, kp)
            if key not in edges:
                edges[key] = [
                    (tuple(p), tuple(q)) if kp < kq
                    else (tuple(q), tuple(p)), [False] * n_groups]
            edges[key][1][origins[i]] ^= True
    return edges


# ---------------------------------------------------------------------------
# face reconstruction
# ---------------------------------------------------------------------------

class _FaceGraph:
    """Half-edge planar subdivision: every undirected edge becomes two
    half-edges; the successor of a half-edge is the angular neighbor of
    its reversal at the head vertex. Each face traces as one cycle with
    the face's interior on the LEFT — no figure-eight artifacts at
    degree-4 crossing vertices. (For a connected component, every face
    boundary is one cycle; bounded faces trace CCW.)"""

    def __init__(self, edge_points):
        self.verts = {}
        self.half = []     # half[i] = (from_key, to_key); i^1 reversal
        for (kp, kq), (p, q) in edge_points:
            self.verts.setdefault(kp, p)
            self.verts.setdefault(kq, q)
            self.half.append((kp, kq))
            self.half.append((kq, kp))

        out_edges = {}
        for hid, (ka, kb) in enumerate(self.half):
            pa, pb = self.verts[ka], self.verts[kb]
            ang = math.atan2(pb[1] - pa[1], pb[0] - pa[0])
            out_edges.setdefault(ka, []).append((ang, hid))
        pos_of = {}
        for k, lst in out_edges.items():
            lst.sort()
            for idx, (_, hid) in enumerate(lst):
                pos_of[hid] = (k, idx)
        self._out = out_edges
        self._pos = pos_of

        # trace all cycles; record each half-edge's cycle id
        n = len(self.half)
        self.cycle_of = [-1] * n
        self.cycles = []
        for hid in range(n):
            if self.cycle_of[hid] >= 0:
                continue
            cid = len(self.cycles)
            cyc = []
            h = hid
            while self.cycle_of[h] < 0:
                self.cycle_of[h] = cid
                cyc.append(self.verts[self.half[h][0]])
                h = self._next(h)
            self.cycles.append(np.asarray(cyc, float))

    def _next(self, hid):
        k, idx = self._pos[hid ^ 1]
        lst = self._out[k]
        return lst[(idx - 1) % len(lst)][1]


def _face_cycles(edges):
    """Cycles of the planar graph formed by {key: (p, q)} edges."""
    g = _FaceGraph(list(edges.items()))
    return [c for c in g.cycles if len(c) >= 3]


def _ring_area(c):
    x, y = c[:, 0], c[:, 1]
    s = float(x[:-1] @ y[1:] - y[:-1] @ x[1:])
    return 0.5 * (s + float(x[-1] * y[0] - y[-1] * x[0]))


def _point_in_ring(p, c):
    """Even-odd containment of point p in ring c."""
    x, y = p
    xs, ys = c[:, 0], c[:, 1]
    x1 = np.concatenate((xs[1:], xs[:1]))
    y1 = np.concatenate((ys[1:], ys[:1]))
    cond = (ys > y) != (y1 > y)
    with np.errstate(divide="ignore", invalid="ignore"):
        xint = xs + (y - ys) / (y1 - ys) * (x1 - xs)
    return bool(np.sum(cond & (x < xint)) % 2)


def _left_of_longest_edge(c, rel=1e-7):
    """A point just left of the cycle's longest edge — inside the face
    this cycle bounds (the face walk keeps its face on the left)."""
    d = np.concatenate((c[1:], c[:1])) - c
    lens = np.hypot(d[:, 0], d[:, 1])
    i = int(np.argmax(lens))
    mid = (c[i] + c[(i + 1) % len(c)]) / 2.0
    nx, ny = -d[i, 1] / lens[i], d[i, 0] / lens[i]
    eps = max(lens[i] * rel, 1e-9)
    return (mid[0] + nx * eps, mid[1] + ny * eps)


# ---------------------------------------------------------------------------
# the boolean
# ---------------------------------------------------------------------------

def _label_faces(graph, edges, groups):
    """Per-face membership tuple (one bool per input group), via parity
    BFS: crossing an edge toggles membership in the groups whose parity
    the edge carries — a purely combinatorial propagation. Each
    connected component needs ONE geometric seed: its unbounded cycle
    (the unique negative-area cycle) takes the membership of a probe
    just left of the component's leftmost vertex, evaluated even-odd
    against the ORIGINAL inputs."""
    ncyc = len(graph.cycles)
    k = len(groups)
    adj = [[] for _ in range(ncyc)]
    half_index = {(ka, kb): hid
                  for hid, (ka, kb) in enumerate(graph.half)}
    for key, ((p, q), parity) in edges.items():
        kp, kq = key
        c1 = graph.cycle_of[half_index[(kp, kq)]]
        c2 = graph.cycle_of[half_index[(kq, kp)]]
        if c1 != c2:
            adj[c1].append((c2, parity))
            adj[c2].append((c1, parity))

    labels = [None] * ncyc
    comp = [-1] * ncyc
    ncomp = 0
    for start in range(ncyc):
        if comp[start] >= 0:
            continue
        members = [start]
        comp[start] = ncomp
        stack = [start]
        while stack:
            c = stack.pop()
            for d, _ in adj[c]:
                if comp[d] < 0:
                    comp[d] = ncomp
                    members.append(d)
                    stack.append(d)
        # seed: the unbounded cycle of this component
        outer = min(members, key=lambda c: _ring_area(graph.cycles[c]))
        pts = np.vstack([graph.cycles[c] for c in members])
        i = int(np.argmin(pts[:, 0]))
        span = max(pts[:, 0].max() - pts[:, 0].min(), 1.0)
        probe = (pts[i, 0] - 1e-6 * span, pts[i, 1])
        labels[outer] = tuple(_even_odd_contains(g, probe)
                              for g in groups)
        stack = [outer]
        while stack:
            c = stack.pop()
            for d, parity in adj[c]:
                if labels[d] is None:
                    labels[d] = tuple(
                        l ^ p for l, p in zip(labels[c], parity))
                    stack.append(d)
        ncomp += 1
    return labels


def _apply_op(label, op):
    a, b = label
    if op == INTERSECTION:
        return a and b
    if op == UNION:
        return a or b
    if op == DIFFERENCE:
        return a and not b
    return a != b


USE_NATIVE = True


def _try_native(ring_groups, op):
    """The C++ overlay; raises when its library cannot be built or
    loaded. USE_NATIVE = False selects the Python reference below (the
    parity tests compare the two)."""
    if not USE_NATIVE:
        return None
    from origami_tpu_torch.geometry.native_bindings import (
        polygon_overlay_native)
    return polygon_overlay_native(ring_groups, op)


def polygon_boolean(subject_rings, clipping_rings, op):
    """Boolean of two ring-lists. Returns [(shell, holes), ...] with
    shells CCW (positive shoelace) and holes CW.

    op: "and" | "or" | "diff" | "xor" (geometry.ops vocabulary).

    The C++ kernel (geometry/native, polygon_overlay) implements the
    same arrangement algorithm and serves the hot path; this module is
    the reference implementation and fallback."""
    res = _try_native([subject_rings, clipping_rings], op)
    if res is not None:
        return res
    return overlay_arrangement(
        [subject_rings, clipping_rings], lambda l: _apply_op(l, op))


def union_all(ring_groups):
    """Exact union of MANY polygons in one arrangement pass: member =
    covered by at least one input. ring_groups: list of ring-lists."""
    res = _try_native(ring_groups, "any")
    if res is not None:
        return res
    return overlay_arrangement(ring_groups, any)


def overlay_arrangement(ring_groups, member_fn):
    """N-ary overlay: faces of the combined arrangement are labeled
    with one membership bit per input group; member_fn maps a label
    tuple to result membership. Returns [(shell, holes), ...]."""
    groups = [[np.asarray(r, float) for r in rings]
              for rings in ring_groups]
    seg_arrays = [_ring_segments(g) for g in groups]
    origins = []
    for gi, sa in enumerate(seg_arrays):
        origins += [gi] * len(sa)
    seg_arrays = [sa for sa in seg_arrays if len(sa)]
    if not seg_arrays:
        return []
    all_segs = np.vstack(seg_arrays)

    edges = _subdivided_edges(all_segs, origins, len(groups))
    graph = _FaceGraph([(k, pq) for k, (pq, _) in edges.items()])
    labels = _label_faces(graph, edges, groups)
    in_res = [bool(member_fn(l)) for l in labels]

    # result boundary: edges whose two adjacent faces differ in result
    half_index = {(ka, kb): hid
                  for hid, (ka, kb) in enumerate(graph.half)}
    boundary = []
    side = {}
    for key, ((p, q), _) in edges.items():
        kp, kq = key
        h1 = half_index[(kp, kq)]
        c1 = graph.cycle_of[h1]
        c2 = graph.cycle_of[h1 ^ 1]
        if in_res[c1] != in_res[c2]:
            boundary.append((key, (p, q)))
            side[(kp, kq)] = in_res[c1]
            side[(kq, kp)] = in_res[c2]

    out = _FaceGraph(boundary)
    shells, holes = [], []
    for cid, c in enumerate(out.cycles):
        if len(c) < 3:
            continue
        a = _ring_area(c)
        if abs(a) < _EPS:
            continue
        # the cycle's interior (left) side must be inside the result;
        # look the label up from the full arrangement — no probing
        hid = out.cycle_of.index(cid)
        if not side[out.half[hid]]:
            continue
        (shells if a > 0 else holes).append(c)

    polys = [(s, []) for s in shells]
    if holes and shells:
        order = sorted(range(len(shells)),
                       key=lambda i: abs(_ring_area(shells[i])))
        for h in holes:
            hp = _left_of_longest_edge(h)
            for i in order:
                if _point_in_ring(hp, shells[i]):
                    polys[i][1].append(h)
                    break
    return polys
