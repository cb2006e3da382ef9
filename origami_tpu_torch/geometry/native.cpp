// origami_tpu native geometry kernels.
//
// The origami_tpu_torch copy of origami_tpu/geometry/native/native.cpp,
// unchanged below this note: host C++, built with g++ at first use by
// origami_tpu_torch/geometry/native_bindings.py.
//
// Role of the reference's pybind11/cppimport concaveman module
// (925 LoC C++ behind origami/concaveman) plus the numba-JIT skeleton
// tracer (origami/core/skeleton.py): a small C library exposed through
// ctypes (pybind11 is not in this image).
//
// Algorithms are the ones implemented in the Python fallbacks
// (origami_tpu/core/hull.py, origami_tpu/core/skeleton.py); this file
// exists for speed on large inputs, not different behavior.
//
// Build: make (g++ -O3 -shared -fPIC).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <queue>
#include <algorithm>

extern "C" {

// ---------------------------------------------------------------------------
// concave hull
// ---------------------------------------------------------------------------
// Same performance class as the reference's r-tree concaveman
// (origami/concaveman): a static k-d tree answers nearest-unused-point-
// to-edge queries in O(log n), and edges are dug longest-first off a
// priority queue in a single pass (no O(rounds * E * n) re-scan).

static inline double seg_dist(double px, double py, double ax, double ay,
                              double bx, double by) {
    double abx = bx - ax, aby = by - ay;
    double l2 = abx * abx + aby * aby;
    double t = l2 < 1e-12 ? 0.0
        : ((px - ax) * abx + (py - ay) * aby) / l2;
    t = t < 0 ? 0 : (t > 1 ? 1 : t);
    double qx = ax + t * abx, qy = ay + t * aby;
    double dx = px - qx, dy = py - qy;
    return std::sqrt(dx * dx + dy * dy);
}

namespace {

struct KDNode {
    double minx, miny, maxx, maxy;
    int left, right;      // children, or -1
    int begin, end;       // leaf: range in perm
};

struct KDTree {
    const double* pts;
    std::vector<int> perm;
    std::vector<KDNode> nodes;

    int build(int begin, int end, int axis) {
        KDNode nd;
        nd.minx = nd.miny = 1e30; nd.maxx = nd.maxy = -1e30;
        for (int i = begin; i < end; i++) {
            double x = pts[2 * perm[i]], y = pts[2 * perm[i] + 1];
            nd.minx = std::min(nd.minx, x); nd.maxx = std::max(nd.maxx, x);
            nd.miny = std::min(nd.miny, y); nd.maxy = std::max(nd.maxy, y);
        }
        nd.begin = begin; nd.end = end; nd.left = nd.right = -1;
        int id = (int)nodes.size();
        nodes.push_back(nd);
        if (end - begin > 8) {
            int mid = (begin + end) / 2;
            std::nth_element(
                perm.begin() + begin, perm.begin() + mid,
                perm.begin() + end, [&](int a, int b) {
                    return pts[2 * a + axis] < pts[2 * b + axis];
                });
            int l = build(begin, mid, 1 - axis);
            int r = build(mid, end, 1 - axis);
            nodes[id].left = l;
            nodes[id].right = r;
        }
        return id;
    }

    // exact distance from segment (a, b) to the node's bbox (0 when the
    // segment touches the box) — tight pruning bound for the query
    static double seg_box_dist(double ax, double ay, double bx, double by,
                               const KDNode& nd) {
        // segment endpoint inside box -> 0
        auto inside = [&](double x, double y) {
            return x >= nd.minx && x <= nd.maxx &&
                   y >= nd.miny && y <= nd.maxy;
        };
        if (inside(ax, ay) || inside(bx, by)) return 0.0;
        double best = 1e30;
        // box corners to segment
        const double cx[4] = {nd.minx, nd.maxx, nd.maxx, nd.minx};
        const double cy[4] = {nd.miny, nd.miny, nd.maxy, nd.maxy};
        for (int k = 0; k < 4; k++) {
            best = std::min(best, seg_dist(cx[k], cy[k], ax, ay, bx, by));
            // box edge k -> k+1 vs segment endpoints
            int j = (k + 1) & 3;
            best = std::min(best, seg_dist(ax, ay, cx[k], cy[k], cx[j], cy[j]));
            best = std::min(best, seg_dist(bx, by, cx[k], cy[k], cx[j], cy[j]));
        }
        // crossing segments: if the segment crosses a box edge, distance
        // is 0 — covered by corner/endpoint distances unless a true
        // transversal crossing; test orientation signs cheaply
        auto cross = [](double ox, double oy, double ux, double uy,
                        double vx, double vy) {
            return (ux - ox) * (vy - oy) - (uy - oy) * (vx - ox);
        };
        for (int k = 0; k < 4; k++) {
            int j = (k + 1) & 3;
            double d1 = cross(ax, ay, bx, by, cx[k], cy[k]);
            double d2 = cross(ax, ay, bx, by, cx[j], cy[j]);
            double d3 = cross(cx[k], cy[k], cx[j], cy[j], ax, ay);
            double d4 = cross(cx[k], cy[k], cx[j], cy[j], bx, by);
            if (((d1 > 0) != (d2 > 0)) && ((d3 > 0) != (d4 > 0)))
                return 0.0;
        }
        return best;
    }

};

// incremental nearest-neighbor traversal: yields points in increasing
// distance-to-segment order (kd nodes and points share one best-first
// queue keyed by lower-bound distance)
struct NNEntry {
    double d;
    int node;       // kd node id, or -1 when a concrete point
    int point;
    bool operator<(const NNEntry& o) const { return d > o.d; }  // min-heap
};

struct SegNN {
    const KDTree& tree;
    double ax, ay, bx, by;
    const std::vector<char>& used;
    std::priority_queue<NNEntry> q;

    SegNN(const KDTree& t, double ax_, double ay_, double bx_, double by_,
          const std::vector<char>& used_)
        : tree(t), ax(ax_), ay(ay_), bx(bx_), by(by_), used(used_) {
        q.push({KDTree::seg_box_dist(ax, ay, bx, by, tree.nodes[0]), 0, -1});
    }

    // next unused point, or -1; *out_d gets its distance to the segment
    int next(double* out_d) {
        while (!q.empty()) {
            NNEntry e = q.top();
            q.pop();
            if (e.node < 0) { *out_d = e.d; return e.point; }
            const KDNode& nd = tree.nodes[e.node];
            if (nd.left < 0) {
                for (int i = nd.begin; i < nd.end; i++) {
                    int p = tree.perm[i];
                    if (used[p]) continue;
                    double d = seg_dist(tree.pts[2 * p], tree.pts[2 * p + 1],
                                        ax, ay, bx, by);
                    q.push({d, -1, p});
                }
            } else {
                q.push({KDTree::seg_box_dist(ax, ay, bx, by,
                                             tree.nodes[nd.left]),
                        nd.left, -1});
                q.push({KDTree::seg_box_dist(ax, ay, bx, by,
                                             tree.nodes[nd.right]),
                        nd.right, -1});
            }
        }
        return -1;
    }
};

static inline bool segs_intersect(double p0x, double p0y, double p1x,
                                  double p1y, double q0x, double q0y,
                                  double q1x, double q1y) {
    auto orient = [](double ox, double oy, double ux, double uy,
                     double vx, double vy) {
        return (ux - ox) * (vy - oy) - (uy - oy) * (vx - ox);
    };
    double d1 = orient(p0x, p0y, p1x, p1y, q0x, q0y);
    double d2 = orient(p0x, p0y, p1x, p1y, q1x, q1y);
    double d3 = orient(q0x, q0y, q1x, q1y, p0x, p0y);
    double d4 = orient(q0x, q0y, q1x, q1y, p1x, p1y);
    return ((d1 > 0) != (d2 > 0)) && ((d3 > 0) != (d4 > 0));
}

}  // namespace

// points: (n, 2) doubles; hull_idx: convex hull vertex indices (ccw);
// out_idx: result ring indices; returns ring length (<= max_out) or -1.
int concave_hull(const double* pts, int n,
                 const int* hull_idx, int hull_n,
                 double concavity, double length_threshold,
                 int* out_idx, int max_out) {
    if (n < 4 || hull_n < 3) return -1;

    KDTree tree;
    tree.pts = pts;
    tree.perm.resize(n);
    for (int i = 0; i < n; i++) tree.perm[i] = i;
    tree.nodes.reserve(2 * (n / 4 + 2));
    tree.build(0, n, 0);

    // ring of vertices as a doubly-linked list; edge i runs
    // vert[i] -> vert[nxt[i]]
    std::vector<int> vert, nxt, prv;
    vert.reserve(max_out + 4);
    nxt.reserve(max_out + 4);
    prv.reserve(max_out + 4);
    std::vector<char> used(n, 0);
    std::vector<int> fifo;          // edges to (re)examine, by ring node id
    fifo.reserve(4 * max_out);

    for (int i = 0; i < hull_n; i++) {
        vert.push_back(hull_idx[i]);
        nxt.push_back((i + 1) % hull_n);
        prv.push_back((i + hull_n - 1) % hull_n);
        used[hull_idx[i]] = 1;
        fifo.push_back(i);
    }

    auto px = [&](int ringnode) { return pts[2 * vert[ringnode]]; };
    auto py = [&](int ringnode) { return pts[2 * vert[ringnode] + 1]; };

    int ring_size = hull_n;
    size_t head = 0;
    while (head < fifo.size() && ring_size < max_out) {
        int ib = fifo[head++];                  // edge b -> c
        int ic = nxt[ib], ia = prv[ib], id_ = nxt[ic];
        double bxp = px(ib), byp = py(ib), cxp = px(ic), cyp = py(ic);
        double elen = std::hypot(cxp - bxp, cyp - byp);
        if (elen < length_threshold) continue;
        double max_d = elen / std::max(concavity, 1e-9);

        // candidates in increasing distance-to-edge order, stopping at
        // the concavity bound; accept the first that is closer to this
        // edge than to its ring neighbors and whose insertion keeps the
        // ring simple
        SegNN nn(tree, bxp, byp, cxp, cyp, used);
        int pick = -1;
        for (int tries = 0; tries < 64; tries++) {
            double dd;
            int p = nn.next(&dd);
            if (p < 0 || dd >= max_d) break;
            double qx = pts[2 * p], qy = pts[2 * p + 1];
            // closer to this edge than to the adjacent ring edges
            // (prevents spiraling digs, reference concaveman criterion);
            // the tolerance admits grid-aligned ties, which contour
            // point sets produce constantly
            double tol = 1e-9 * (1.0 + dd);
            if (dd > tol + seg_dist(qx, qy, px(ia), py(ia), bxp, byp))
                continue;
            if (dd > tol + seg_dist(qx, qy, cxp, cyp, px(id_), py(id_)))
                continue;
            // (b, p) and (p, c) must not cross any existing ring edge;
            // cheap bbox reject per edge
            double minx = std::min({bxp, cxp, qx});
            double maxx = std::max({bxp, cxp, qx});
            double miny = std::min({byp, cyp, qy});
            double maxy = std::max({byp, cyp, qy});
            bool crosses = false;
            for (int j = 0; j < (int)vert.size() && !crosses; j++) {
                int jn = nxt[j];
                double ux = px(j), uy = py(j), vx2 = px(jn), vy2 = py(jn);
                if (std::max(ux, vx2) < minx || std::min(ux, vx2) > maxx ||
                    std::max(uy, vy2) < miny || std::min(uy, vy2) > maxy)
                    continue;
                if (j != ia && j != ib &&
                    segs_intersect(bxp, byp, qx, qy, ux, uy, vx2, vy2))
                    crosses = true;
                if (j != ib && j != ic &&
                    segs_intersect(qx, qy, cxp, cyp, ux, uy, vx2, vy2))
                    crosses = true;
            }
            if (!crosses) { pick = p; break; }
        }
        if (pick < 0) continue;
        // dig: insert `pick` between ib and ic, re-examine both halves
        int im = (int)vert.size();
        vert.push_back(pick);
        nxt.push_back(ic);
        prv.push_back(ib);
        nxt[ib] = im;
        prv[ic] = im;
        used[pick] = 1;
        ring_size++;
        fifo.push_back(ib);
        fifo.push_back(im);
    }

    // emit the ring in order
    int m = 0, cur = 0;
    do {
        if (m >= max_out) break;
        out_idx[m++] = vert[cur];
        cur = nxt[cur];
    } while (cur != 0 && m <= (int)vert.size());
    return m;
}

// ---------------------------------------------------------------------------
// skeleton graph tracing
// ---------------------------------------------------------------------------

// skel: (h, w) uint8 mask of a 1-px skeleton. Outputs flattened edge
// paths: every edge is a run of pixel indices (y * w + x); edge k spans
// path_data[path_off[k] .. path_off[k+1]). Returns number of edges, or
// -1 on overflow.
int trace_skeleton(const uint8_t* skel, int h, int w,
                   int32_t* path_data, int path_cap,
                   int32_t* path_off, int off_cap) {
    const int dy[8] = {-1, -1, -1, 0, 0, 1, 1, 1};
    const int dx[8] = {-1, 0, 1, -1, 1, -1, 0, 1};
    auto at = [&](int y, int x) -> bool {
        return y >= 0 && y < h && x >= 0 && x < w && skel[y * w + x];
    };
    auto degree = [&](int y, int x) {
        int d = 0;
        for (int k = 0; k < 8; k++) d += at(y + dy[k], x + dx[k]);
        return d;
    };

    std::vector<int32_t> nodes;   // pixel ids of junctions/endpoints
    std::vector<char> is_node(h * w, 0);
    int32_t first_px = -1;
    for (int y = 0; y < h; y++)
        for (int x = 0; x < w; x++)
            if (skel[y * w + x]) {
                if (first_px < 0) first_px = y * w + x;
                if (degree(y, x) != 2) {
                    is_node[y * w + x] = 1;
                    nodes.push_back(y * w + x);
                }
            }
    if (first_px < 0) return 0;
    if (nodes.empty()) {         // pure cycle
        is_node[first_px] = 1;
        nodes.push_back(first_px);
    }

    // walk from each node through degree-2 pixels
    std::vector<char> edge_done(h * w, 0); // first step pixel marker
    int n_edges = 0, n_data = 0;
    if (off_cap < 1) return -1;
    path_off[0] = 0;
    for (int32_t node : nodes) {
        int ny = node / w, nx = node % w;
        for (int k = 0; k < 8; k++) {
            int cy = ny + dy[k], cx = nx + dx[k];
            if (!at(cy, cx)) continue;
            int32_t step = cy * w + cx;
            // dedupe: an edge is identified by its first step pixel
            // unless that pixel is itself a node (short edges)
            if (!is_node[step] && edge_done[step]) continue;
            std::vector<int32_t> path;
            path.push_back(node);
            int py = ny, px = nx;
            int guard = h * w;
            while (!is_node[cy * w + cx] && guard-- > 0) {
                path.push_back(cy * w + cx);
                int fy = -1, fx = -1;
                for (int j = 0; j < 8; j++) {
                    int qy = cy + dy[j], qx = cx + dx[j];
                    if (!at(qy, qx)) continue;
                    if (qy == py && qx == px) continue;
                    // avoid stepping back onto path start immediately
                    fy = qy; fx = qx;
                    if (is_node[qy * w + qx]) break;
                }
                if (fy < 0) break;
                py = cy; px = cx; cy = fy; cx = fx;
            }
            if (is_node[cy * w + cx]) path.push_back(cy * w + cx);
            // mark interior pixels
            for (size_t t = 1; t + 1 < path.size(); t++)
                edge_done[path[t]] = 1;
            // short node-node edges: dedupe by ordering
            if (path.size() == 2 && path[0] > path[1]) continue;
            if (n_data + (int)path.size() > path_cap) return -1;
            if (n_edges + 1 >= off_cap) return -1;
            std::memcpy(path_data + n_data, path.data(),
                        path.size() * sizeof(int32_t));
            n_data += (int)path.size();
            path_off[++n_edges] = n_data;
        }
    }
    return n_edges;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// polygon boolean overlay (C++ port of geometry/booleans.py):
// 1. subdivide every edge at all cross-group intersections,
// 2. walk the faces of the full arrangement (half-edges, angular
//    successor) and label them by parity BFS (one even-odd probe per
//    connected component),
// 3. re-walk the boundary edges of the requested operation into
//    shells (CCW) and holes (CW), nesting holes into shells.
// ---------------------------------------------------------------------------

#include <cmath>
#include <map>
#include <unordered_map>
#include <utility>

namespace ovl {

static const double kEps = 1e-9;
static const double kSnap = 1e7;

struct Seg { double x0, y0, x1, y1; int group; };
typedef std::pair<int64_t, int64_t> VKey;
typedef std::pair<VKey, VKey> DKey;   // directed edge key

struct VKeyHash {
    size_t operator()(const VKey& k) const {
        return std::hash<int64_t>()(k.first * 1000003ll ^ k.second);
    }
};

struct DKeyHash {
    size_t operator()(const DKey& k) const {
        VKeyHash h;
        return h(k.first) * 1000003ull ^ h(k.second);
    }
};

static inline VKey snap(double x, double y) {
    return VKey(llround(x * kSnap), llround(y * kSnap));
}

// even-odd membership of (x, y) against the rings of one group
static bool contains(const double* coords, const int* ring_sizes,
                     const int* ring_groups, int n_rings, int group,
                     double x, double y) {
    bool inside = false;
    const double* p = coords;
    for (int r = 0; r < n_rings; r++) {
        int n = ring_sizes[r];
        if (ring_groups[r] != group) { p += 2 * n; continue; }
        int cross = 0;
        for (int i = 0; i < n; i++) {
            double ax = p[2 * i], ay = p[2 * i + 1];
            int j = (i + 1) % n;
            double bx = p[2 * j], by = p[2 * j + 1];
            if ((ay > y) != (by > y)) {
                double xi = ax + (y - ay) / (by - ay) * (bx - ax);
                if (x < xi) cross++;
            }
        }
        if (cross & 1) inside = !inside;
        p += 2 * n;
    }
    return inside;
}

struct Overlay {
    std::vector<Seg> segs;
    int n_groups;
    int words;                       // label bitmask words

    // subdivided edges
    std::vector<VKey> everts;        // per edge: endpoints
    std::vector<std::pair<VKey, VKey>> edges;
    std::vector<std::vector<uint64_t>> parity;
    std::unordered_map<VKey, std::pair<double, double>, VKeyHash> vpos;

    void subdivide() {
        size_t n = segs.size();
        std::vector<std::vector<double>> params(n);
        // bbox prune + pairwise intersection (different groups only —
        // valid inputs have no self-crossings within a group)
        for (size_t i = 0; i < n; i++) {
            const Seg& a = segs[i];
            double aminx = std::min(a.x0, a.x1) - kEps;
            double amaxx = std::max(a.x0, a.x1) + kEps;
            double aminy = std::min(a.y0, a.y1) - kEps;
            double amaxy = std::max(a.y0, a.y1) + kEps;
            double rx = a.x1 - a.x0, ry = a.y1 - a.y0;
            double rr = rx * rx + ry * ry;
            for (size_t j = 0; j < n; j++) {
                if (i == j) continue;
                const Seg& b = segs[j];
                // no same-group skip: like the Python reference, a
                // self-intersecting (invalid) input still gets split
                // and labeled even-odd consistently
                if (std::max(b.x0, b.x1) < aminx ||
                    std::min(b.x0, b.x1) > amaxx ||
                    std::max(b.y0, b.y1) < aminy ||
                    std::min(b.y0, b.y1) > amaxy) continue;
                double sx = b.x1 - b.x0, sy = b.y1 - b.y0;
                double denom = rx * sy - ry * sx;
                double qpx = b.x0 - a.x0, qpy = b.y0 - a.y0;
                double cqr = qpx * ry - qpy * rx;
                double cqs = qpx * sy - qpy * sx;
                if (std::fabs(denom) > kEps) {
                    double t = cqs / denom;
                    double u = cqr / denom;
                    const double tol = 1e-12;
                    if (t >= -tol && t <= 1 + tol &&
                        u >= -tol && u <= 1 + tol) {
                        params[i].push_back(
                            std::min(std::max(t, 0.0), 1.0));
                    }
                } else if (std::fabs(cqr) < 1e-9 && rr > kEps) {
                    // collinear overlap: project b's endpoints
                    double t0 = ((b.x0 - a.x0) * rx +
                                 (b.y0 - a.y0) * ry) / rr;
                    double t1 = ((b.x1 - a.x0) * rx +
                                 (b.y1 - a.y0) * ry) / rr;
                    if (t0 > 1e-12 && t0 < 1 - 1e-12)
                        params[i].push_back(t0);
                    if (t1 > 1e-12 && t1 < 1 - 1e-12)
                        params[i].push_back(t1);
                }
            }
        }
        std::map<std::pair<VKey, VKey>, int> edge_idx;
        for (size_t i = 0; i < n; i++) {
            const Seg& a = segs[i];
            std::vector<double>& ts = params[i];
            ts.push_back(0.0);
            ts.push_back(1.0);
            std::sort(ts.begin(), ts.end());
            double rx = a.x1 - a.x0, ry = a.y1 - a.y0;
            double px = a.x0, py = a.y0;
            VKey pk = snap(px, py);
            vpos[pk] = std::make_pair(px, py);
            for (size_t s = 1; s < ts.size(); s++) {
                if (ts[s] - ts[s - 1] < 1e-12) continue;
                double qx = a.x0 + ts[s] * rx, qy = a.y0 + ts[s] * ry;
                VKey qk = snap(qx, qy);
                if (qk == pk) continue;
                vpos[qk] = std::make_pair(qx, qy);
                std::pair<VKey, VKey> key =
                    (pk < qk) ? std::make_pair(pk, qk)
                              : std::make_pair(qk, pk);
                auto it = edge_idx.find(key);
                int ei;
                if (it == edge_idx.end()) {
                    ei = (int)edges.size();
                    edge_idx[key] = ei;
                    edges.push_back(key);
                    parity.push_back(std::vector<uint64_t>(words, 0));
                } else {
                    ei = it->second;
                }
                parity[ei][a.group >> 6] ^= (1ull << (a.group & 63));
                pk = qk;
                px = qx; py = qy;
            }
        }
    }

    // face graph over a given edge list; returns cycles + half->cycle
    struct Faces {
        std::vector<std::vector<VKey>> cycles;   // vertex keys
        std::vector<int> cycle_of;               // per half-edge
        std::vector<std::pair<VKey, VKey>> half; // directed
        std::unordered_map<VKey, std::vector<std::pair<double, int>>,
                           VKeyHash> out;
        std::unordered_map<DKey, int, DKeyHash> half_of;
    };

    static DKey dirhash(const VKey& a, const VKey& b) {
        return DKey(a, b);
    }

    void build_faces(const std::vector<std::pair<VKey, VKey>>& es,
                     Faces& f) {
        f.half.reserve(es.size() * 2);
        for (auto& e : es) {
            f.half.push_back(std::make_pair(e.first, e.second));
            f.half.push_back(std::make_pair(e.second, e.first));
        }
        for (int h = 0; h < (int)f.half.size(); h++) {
            const VKey& a = f.half[h].first;
            const VKey& b = f.half[h].second;
            auto pa = vpos[a];
            auto pb = vpos[b];
            double ang = atan2(pb.second - pa.second,
                               pb.first - pa.first);
            f.out[a].push_back(std::make_pair(ang, h));
            f.half_of[dirhash(a, b)] = h;
        }
        std::unordered_map<int, std::pair<VKey, int>> pos_of;
        for (auto& kv : f.out) {
            std::sort(kv.second.begin(), kv.second.end());
        }
        // position of each half edge within its out-list
        std::unordered_map<int, int> idx_of;
        for (auto& kv : f.out)
            for (int k = 0; k < (int)kv.second.size(); k++)
                idx_of[kv.second[k].second] = k;

        f.cycle_of.assign(f.half.size(), -1);
        for (int h0 = 0; h0 < (int)f.half.size(); h0++) {
            if (f.cycle_of[h0] >= 0) continue;
            int cid = (int)f.cycles.size();
            f.cycles.push_back(std::vector<VKey>());
            int h = h0;
            while (f.cycle_of[h] < 0) {
                f.cycle_of[h] = cid;
                f.cycles[cid].push_back(f.half[h].first);
                // successor: angular predecessor of the reversal
                int rev = h ^ 1;
                const VKey& head = f.half[rev].first;
                auto& lst = f.out[head];
                int k = idx_of[rev];
                int k2 = (k - 1 + (int)lst.size()) % (int)lst.size();
                h = lst[k2].second;
            }
        }
    }

    double ring_area(const std::vector<VKey>& cyc) {
        double a = 0;
        int n = (int)cyc.size();
        for (int i = 0; i < n; i++) {
            auto p = vpos[cyc[i]];
            auto q = vpos[cyc[(i + 1) % n]];
            a += p.first * q.second - q.first * p.second;
        }
        return 0.5 * a;
    }
};

}  // namespace ovl

extern "C" {

// op: 0=and 1=or 2=diff 3=xor 4=any (n-ary union)
// returns #output rings, or -1 if capacities are insufficient.
// out_ring_poly[i]: polygon id of output ring i (shell first per id).
int polygon_overlay(const double* coords, const int* ring_sizes,
                    const int* ring_groups, int n_rings, int n_groups,
                    int op,
                    double* out_coords, int out_coords_cap,
                    int* out_ring_sizes, int* out_ring_poly,
                    int out_rings_cap) {
    using namespace ovl;
    Overlay ov;
    ov.n_groups = n_groups;
    ov.words = (n_groups + 63) / 64;

    const double* p = coords;
    for (int r = 0; r < n_rings; r++) {
        int n = ring_sizes[r];
        for (int i = 0; i < n; i++) {
            int j = (i + 1) % n;
            double x0 = p[2 * i], y0 = p[2 * i + 1];
            double x1 = p[2 * j], y1 = p[2 * j + 1];
            if (std::fabs(x1 - x0) < kEps && std::fabs(y1 - y0) < kEps)
                continue;
            ov.segs.push_back(Seg{x0, y0, x1, y1, ring_groups[r]});
        }
        p += 2 * n;
    }
    if (ov.segs.empty()) return 0;

    ov.subdivide();

    Overlay::Faces full;
    ov.build_faces(ov.edges, full);
    int ncyc = (int)full.cycles.size();

    // parity BFS over cycles
    std::vector<std::vector<uint64_t>> labels(
        ncyc, std::vector<uint64_t>());
    std::vector<std::vector<std::pair<int, int>>> adj(ncyc);
    for (int ei = 0; ei < (int)ov.edges.size(); ei++) {
        const VKey& a = ov.edges[ei].first;
        const VKey& b = ov.edges[ei].second;
        int h1 = full.half_of[Overlay::dirhash(a, b)];
        int h2 = full.half_of[Overlay::dirhash(b, a)];
        int c1 = full.cycle_of[h1], c2 = full.cycle_of[h2];
        if (c1 != c2) {
            adj[c1].push_back(std::make_pair(c2, ei));
            adj[c2].push_back(std::make_pair(c1, ei));
        }
    }
    std::vector<int> comp(ncyc, -1);
    for (int s = 0; s < ncyc; s++) {
        if (comp[s] >= 0) continue;
        std::vector<int> members;
        members.push_back(s);
        comp[s] = s;
        for (size_t qi = 0; qi < members.size(); qi++) {
            int c = members[qi];
            for (auto& dn : adj[c])
                if (comp[dn.first] < 0) {
                    comp[dn.first] = s;
                    members.push_back(dn.first);
                }
        }
        // seed: unbounded cycle (most negative area); probe just left
        // of the component's leftmost vertex
        int outer = members[0];
        double best = 1e300;
        double minx = 1e300, miny = 0, maxx = -1e300;
        for (int c : members) {
            double a = ov.ring_area(full.cycles[c]);
            if (a < best) { best = a; outer = c; }
            for (auto& vk : full.cycles[c]) {
                auto pp = ov.vpos[vk];
                if (pp.first < minx) { minx = pp.first;
                                       miny = pp.second; }
                if (pp.first > maxx) maxx = pp.first;
            }
        }
        double span = std::max(maxx - minx, 1.0);
        double px = minx - 1e-6 * span, py = miny;
        std::vector<uint64_t> seed(ov.words, 0);
        for (int g = 0; g < n_groups; g++)
            if (contains(coords, ring_sizes, ring_groups, n_rings, g,
                         px, py))
                seed[g >> 6] |= (1ull << (g & 63));
        labels[outer] = seed;
        std::vector<int> stack;
        stack.push_back(outer);
        while (!stack.empty()) {
            int c = stack.back(); stack.pop_back();
            for (auto& dn : adj[c]) {
                if (!labels[dn.first].empty()) continue;
                std::vector<uint64_t> lab = labels[c];
                for (int w = 0; w < ov.words; w++)
                    lab[w] ^= ov.parity[dn.second][w];
                labels[dn.first] = lab;
                stack.push_back(dn.first);
            }
        }
    }

    auto member = [&](const std::vector<uint64_t>& lab) -> bool {
        bool a = lab[0] & 1, b = lab[0] & 2;
        switch (op) {
            case 0: return a && b;
            case 1: return a || b;
            case 2: return a && !b;
            case 3: return a != b;
            default: {
                for (int w = 0; w < ov.words; w++)
                    if (lab[w]) return true;
                return false;
            }
        }
    };
    std::vector<char> in_res(ncyc);
    for (int c = 0; c < ncyc; c++)
        in_res[c] = labels[c].empty() ? 0 : (char)member(labels[c]);

    // boundary edges + result side per directed key
    std::vector<std::pair<VKey, VKey>> bedges;
    std::unordered_map<DKey, char, DKeyHash> side;
    for (int ei = 0; ei < (int)ov.edges.size(); ei++) {
        const VKey& a = ov.edges[ei].first;
        const VKey& b = ov.edges[ei].second;
        int h1 = full.half_of[Overlay::dirhash(a, b)];
        int c1 = full.cycle_of[h1];
        int c2 = full.cycle_of[full.half_of[Overlay::dirhash(b, a)]];
        if (in_res[c1] != in_res[c2]) {
            bedges.push_back(ov.edges[ei]);
            side[Overlay::dirhash(a, b)] = in_res[c1];
            side[Overlay::dirhash(b, a)] = in_res[c2];
        }
    }
    if (bedges.empty()) return 0;

    Overlay::Faces outf;
    ov.build_faces(bedges, outf);

    struct Ring { std::vector<VKey> cyc; double area; };
    std::vector<Ring> shells, holes;
    for (int cid = 0; cid < (int)outf.cycles.size(); cid++) {
        auto& cyc = outf.cycles[cid];
        if (cyc.size() < 3) continue;
        double a = ov.ring_area(cyc);
        if (std::fabs(a) < kEps) continue;
        // label lookup from the full arrangement via any half edge
        int h = -1;
        for (int hh = 0; hh < (int)outf.half.size(); hh++)
            if (outf.cycle_of[hh] == cid) { h = hh; break; }
        char lab = side[Overlay::dirhash(outf.half[h].first,
                                         outf.half[h].second)];
        if (!lab) continue;
        Ring r; r.cyc = cyc; r.area = a;
        if (a > 0) shells.push_back(r); else holes.push_back(r);
    }

    // nest holes into the smallest containing shell
    std::vector<int> order(shells.size());
    for (size_t i = 0; i < shells.size(); i++) order[i] = (int)i;
    std::sort(order.begin(), order.end(), [&](int i, int j) {
        return std::fabs(shells[i].area) < std::fabs(shells[j].area);
    });
    std::vector<std::vector<int>> shell_holes(shells.size());
    for (size_t hi = 0; hi < holes.size(); hi++) {
        // probe: a vertex of the hole nudged toward its interior is
        // fragile; use the hole's first vertex for containment since
        // shells and holes never cross (point-on-boundary is resolved
        // by even-odd consistently enough at snap precision)
        auto pp = ov.vpos[holes[hi].cyc[0]];
        // midpoint of the hole's longest edge, offset left
        double bx = 0, by = 0, blen = -1;
        int n = (int)holes[hi].cyc.size();
        for (int i = 0; i < n; i++) {
            auto p1 = ov.vpos[holes[hi].cyc[i]];
            auto p2 = ov.vpos[holes[hi].cyc[(i + 1) % n]];
            double dx = p2.first - p1.first;
            double dy = p2.second - p1.second;
            double L = std::hypot(dx, dy);
            if (L > blen) {
                blen = L;
                double eps = std::max(L * 1e-7, 1e-9);
                bx = (p1.first + p2.first) / 2 - dy / L * eps;
                by = (p1.second + p2.second) / 2 + dx / L * eps;
            }
        }
        (void)pp;
        for (int oi : order) {
            // even-odd point-in-shell
            auto& cyc = shells[oi].cyc;
            int m = (int)cyc.size();
            int cross = 0;
            for (int i = 0; i < m; i++) {
                auto p1 = ov.vpos[cyc[i]];
                auto p2 = ov.vpos[cyc[(i + 1) % m]];
                if ((p1.second > by) != (p2.second > by)) {
                    double xi = p1.first + (by - p1.second) /
                        (p2.second - p1.second) *
                        (p2.first - p1.first);
                    if (bx < xi) cross++;
                }
            }
            if (cross & 1) {
                shell_holes[oi].push_back((int)hi);
                break;
            }
        }
    }

    // emit
    int out_r = 0, out_c = 0;
    for (size_t si = 0; si < shells.size(); si++) {
        std::vector<std::vector<VKey>*> rings;
        rings.push_back(&shells[si].cyc);
        for (int hi : shell_holes[si]) rings.push_back(&holes[hi].cyc);
        for (auto* rg : rings) {
            int n = (int)rg->size();
            if (out_r >= out_rings_cap ||
                out_c + 2 * n > out_coords_cap)
                return -1;
            out_ring_sizes[out_r] = n;
            out_ring_poly[out_r] = (int)si;
            for (int i = 0; i < n; i++) {
                auto pp = ov.vpos[(*rg)[i]];
                out_coords[out_c++] = pp.first;
                out_coords[out_c++] = pp.second;
            }
            out_r++;
        }
    }
    return out_r;
}

}  // extern "C"

extern "C" {

// minimum distance between two segment sets (vertex-to-segment both
// ways suffices for non-crossing sets). Early-exits when a pair gets
// below `cutoff` (pass 0 for the exact minimum).
double min_seg_dist(const double* sa, int na, const double* sb, int nb,
                    double cutoff) {
    double best = 1e300;
    for (int pass = 0; pass < 2; pass++) {
        const double* va = pass == 0 ? sa : sb;
        const double* sg = pass == 0 ? sb : sa;
        int nv = pass == 0 ? na : nb;
        int ns = pass == 0 ? nb : na;
        for (int i = 0; i < nv; i++) {
            for (int e = 0; e < 2; e++) {
                double px = va[4 * i + 2 * e];
                double py = va[4 * i + 2 * e + 1];
                for (int j = 0; j < ns; j++) {
                    double d = seg_dist(px, py, sg[4 * j], sg[4 * j + 1],
                                        sg[4 * j + 2], sg[4 * j + 3]);
                    if (d < best) {
                        best = d;
                        if (best <= cutoff) return best;
                    }
                }
            }
        }
    }
    return best;
}

}  // extern "C"

extern "C" {

// Zhang-Suen thinning in place on a 0/1 uint8 mask (parallel
// subiteration update — identical conventions to the device kernel in
// ops/morphology._zs_subiter). Returns iterations used. Host-native
// because the while-loop device formulation cold-compiles in minutes
// through the remote TPU compiler and a page costs only ~10 ms here.
int thin_mask(uint8_t* img, int h, int w, int max_iter) {
    // worklist over set pixels: separator masks are ~2% dense, so a
    // full h*w scan per subiteration (the textbook formulation) does
    // ~50x the work. The parallel-update semantics are preserved —
    // removal decisions per subiteration read img before any of that
    // subiteration's removals are applied.
    std::vector<int> cur;
    for (int i = 0; i < h * w; i++)
        if (img[i]) cur.push_back(i);
    std::vector<int> rem;
    auto at = [&](int y, int x) -> int {
        return (y >= 0 && y < h && x >= 0 && x < w) ? img[y * w + x] : 0;
    };
    int it = 0;
    for (; it < max_iter; it++) {
        bool changed = false;
        for (int step = 0; step < 2; step++) {
            rem.clear();
            for (int idx : cur) {
                if (!img[idx]) continue;
                const int y = idx / w, x = idx % w;
                int p2 = at(y - 1, x), p3 = at(y - 1, x + 1);
                int p4 = at(y, x + 1), p5 = at(y + 1, x + 1);
                int p6 = at(y + 1, x), p7 = at(y + 1, x - 1);
                int p8 = at(y, x - 1), p9 = at(y - 1, x - 1);
                int b = p2 + p3 + p4 + p5 + p6 + p7 + p8 + p9;
                if (b < 2 || b > 6) continue;
                int ring[9] = {p2, p3, p4, p5, p6, p7, p8, p9, p2};
                int a = 0;
                for (int i = 0; i < 8; i++)
                    a += (ring[i] == 0 && ring[i + 1] == 1);
                if (a != 1) continue;
                bool c2 = step == 0
                    ? (p2 * p4 * p6 == 0 && p4 * p6 * p8 == 0)
                    : (p2 * p4 * p8 == 0 && p2 * p6 * p8 == 0);
                if (!c2) continue;
                rem.push_back(idx);
            }
            for (int idx : rem) { img[idx] = 0; changed = true; }
        }
        if (!changed) break;
        size_t k = 0;
        for (int idx : cur)
            if (img[idx]) cur[k++] = idx;
        cur.resize(k);
    }
    return it;
}

// City-block distance to the nearest set pixel of `src` (two-pass
// chamfer — the host twin of ops/morphology.label_edt).
void chamfer_edt(const uint8_t* src, int h, int w, float* out) {
    const float BIG = 1e6f;
    for (size_t i = 0; i < (size_t)h * w; i++)
        out[i] = src[i] ? 0.f : BIG;
    for (int y = 0; y < h; y++) {
        for (int x = 0; x < w; x++) {
            float v = out[y * w + x];
            if (y > 0) v = std::min(v, out[(y - 1) * w + x] + 1.f);
            if (x > 0) v = std::min(v, out[y * w + x - 1] + 1.f);
            out[y * w + x] = v;
        }
    }
    for (int y = h - 1; y >= 0; y--) {
        for (int x = w - 1; x >= 0; x--) {
            float v = out[y * w + x];
            if (y < h - 1) v = std::min(v, out[(y + 1) * w + x] + 1.f);
            if (x < w - 1) v = std::min(v, out[y * w + x + 1] + 1.f);
            out[y * w + x] = v;
        }
    }
}

// Douglas-Peucker on an open chain xy[(x0,y0),(x1,y1),...]; sets
// keep[i]=1 for retained vertices (endpoints always kept). Segment
// distance uses the clamped projection, matching the numpy
// implementation in geometry/poly._douglas_peucker (host twin: the
// Python version's per-split numpy temporaries cost ~0.6 ms/ring,
// ~0.5 s of the contours stage per 6-page batch).
void douglas_peucker(const double* xy, int n, double tol,
                     uint8_t* keep) {
    if (n <= 0) return;
    std::fill(keep, keep + n, 0);
    keep[0] = keep[n - 1] = 1;
    if (n < 3) return;
    std::vector<std::pair<int, int>> stack;
    stack.push_back({0, n - 1});
    const double tol2 = tol * tol;
    while (!stack.empty()) {
        auto [i0, i1] = stack.back();
        stack.pop_back();
        if (i1 <= i0 + 1) continue;
        const double ax = xy[2 * i0], ay = xy[2 * i0 + 1];
        const double bx = xy[2 * i1], by = xy[2 * i1 + 1];
        const double abx = bx - ax, aby = by - ay;
        const double L2 = abx * abx + aby * aby;
        double dmax2 = -1.0;
        int imax = -1;
        for (int i = i0 + 1; i < i1; i++) {
            const double px = xy[2 * i], py = xy[2 * i + 1];
            double t = L2 > 1e-18
                ? ((px - ax) * abx + (py - ay) * aby) / L2 : 0.0;
            t = t < 0.0 ? 0.0 : (t > 1.0 ? 1.0 : t);
            const double dx = px - (ax + t * abx);
            const double dy = py - (ay + t * aby);
            const double d2 = dx * dx + dy * dy;
            if (d2 > dmax2) { dmax2 = d2; imax = i; }
        }
        if (dmax2 > tol2) {
            keep[imax] = 1;
            stack.push_back({i0, imax});
            stack.push_back({imax, i1});
        }
    }
}

}  // extern "C"
