// Raster vectorization, distance transforms and polygon fill with
// OpenCV's results, for the port, which has no cv2.
//
//   find_contours_*   cv2.findContours(mask, RETR_CCOMP, CHAIN_APPROX_SIMPLE):
//                     Suzuki-Abe border following as OpenCV writes it
//                     (contours.cpp: cvFindNextContour, icvFetchContourEx):
//                     the same vertices from the same start pixel, the
//                     contours in OpenCV's order (the tree walked depth
//                     first, each child list newest first) with its
//                     [next, prev, first_child, parent] hierarchy.
//   components8       cv2.connectedComponentsWithStats(mask, connectivity=8):
//                     labels numbered in the order of each component's
//                     first 2x2 block (OpenCV's block-based labelling
//                     numbers them so), and the five stats columns.
//   chamfer5          cv2.distanceTransform(mask, DIST_L2, 5) and, with
//                     labels, cv2.distanceTransformWithLabels(...,
//                     DIST_LABEL_PIXEL): the 5x5 chamfer with the weights
//                     1, 1.4 and 2.1969.
//   fill_poly         cv2.fillPoly(img, [pts], value) of one ring of
//                     integer points (drawing.cpp: the outline's 8-connected
//                     Bresenham lines, then FillEdgeCollection's scanlines
//                     in 16-bit fixed point, each span from the first pixel
//                     centre at or right of its left edge to the last at or
//                     left of its right edge); draw_line one such line
//                     (cv2.line, thickness 1).
//
// Built with native.cpp into the port's geometry library
// (native_bindings.py); a plain C interface for ctypes.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Contour {
  int is_hole;
  int parent;  // index of the parent contour, -1 for the frame
  std::vector<int32_t> pts;
};

struct Contours {
  std::vector<Contour> items;
  std::vector<int> order;       // output position -> contour index
  std::vector<int32_t> hier;    // 4 per output contour
};

// Chain-code steps: 0 right, 1 up-right, 2 up, ..., 7 down-right.
const int kDx[8] = {1, 1, 0, -1, -1, -1, 0, 1};
const int kDy[8] = {0, -1, -1, -1, 0, 1, 1, 1};

// icvFetchContourEx with CHAIN_APPROX_SIMPLE on an int image: unmarked
// pixels are 1, a border pixel gets +nbd, or -nbd where its right
// neighbour is background (OpenCV's nbd | 0x80).
void fetch(int32_t* img, int step, long i0, int x, int y, int is_hole,
           int nbd, std::vector<int32_t>& out) {
  long deltas[16];
  for (int k = 0; k < 16; ++k)
    deltas[k] = (long)kDx[k & 7] + (long)kDy[k & 7] * step;
  int s = is_hole ? 0 : 4;
  int s_end = s;
  long i1;
  do {
    s = (s - 1) & 7;
    i1 = i0 + deltas[s];
  } while (img[i1] == 0 && s != s_end);
  if (s == s_end) {  // a single pixel
    img[i0] = -nbd;
    out.push_back(x);
    out.push_back(y);
    return;
  }
  long i3 = i0, i4 = i0;
  int prev_s = s ^ 4;
  for (;;) {
    s_end = s;
    s = std::min(s, 15);
    while (s < 15) {
      i4 = i3 + deltas[++s];
      if (img[i4] != 0) break;
    }
    s &= 7;
    if ((unsigned)(s - 1) < (unsigned)s_end)
      img[i3] = -nbd;
    else if (img[i3] == 1)
      img[i3] = nbd;
    if (s != prev_s) {
      out.push_back(x);
      out.push_back(y);
    }
    prev_s = s;
    x += kDx[s];
    y += kDy[s];
    if (i4 == i0 && i3 == i1) break;
    i3 = i4;
    s = (s + 4) & 7;
  }
}

void walk(const std::vector<int>& first, const std::vector<int>& next,
          int node, std::vector<int>& order) {
  // pre-order: a node, then its children, then its next sibling
  for (int c = node; c != -1; c = next[c]) {
    order.push_back(c);
    walk(first, next, first[c + 1], order);
  }
}

int find_root(std::vector<int32_t>& parent, int32_t i) {
  int32_t r = i;
  while (parent[r] != r) r = parent[r];
  while (parent[i] != r) {
    int32_t n = parent[i];
    parent[i] = r;
    i = n;
  }
  return r;
}

void unite(std::vector<int32_t>& parent, int32_t a, int32_t b) {
  a = find_root(parent, a);
  b = find_root(parent, b);
  if (a < b)
    parent[b] = a;
  else if (b < a)
    parent[a] = b;
}

// Distance of each nonzero pixel of src (h, w) to the nearest zero pixel
// through the 5x5 chamfer mask of DIST_L2, in two raster passes. Without
// labels OpenCV sums the weights 1, 1.4 and 2.1969 in float32; with labels
// (distanceTransformEx_5x5) in 16-bit fixed point, and every nonzero pixel
// takes the label of the zero pixel its distance came from. `labels` (h, w)
// int32 or null: with `number_zeros` each zero pixel is first numbered
// 1, 2, ... in raster order (DIST_LABEL_PIXEL).
template <typename T>
void chamfer_passes(const uint8_t* src, int h, int w, T hv, T diag, T lng,
                    T init, std::vector<T>& t, std::vector<int32_t>* lab) {
  const int B = 2, step = w + 2 * B;
  const long off[8] = {-2L * step - 1, -2L * step + 1, -(long)step - 2,
                       -(long)step - 1, -(long)step, -(long)step + 1,
                       -(long)step + 2, -1};
  const T wt[8] = {lng, lng, lng, diag, hv, diag, lng, hv};
  t.assign((size_t)(h + 2 * B) * step, init);
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      const size_t i = (size_t)(y + B) * step + x + B;
      if (!src[(size_t)y * w + x]) {
        t[i] = 0;
        continue;
      }
      T t0 = init;
      int32_t l0 = 0;
      for (int k = 0; k < 8; ++k) {
        const T c = t[i + off[k]] + wt[k];
        if (t0 > c) {
          t0 = c;
          if (lab) l0 = (*lab)[i + off[k]];
        }
      }
      t[i] = t0;
      if (lab) (*lab)[i] = l0;
    }
  }
  for (int y = h - 1; y >= 0; --y) {
    for (int x = w - 1; x >= 0; --x) {
      const size_t i = (size_t)(y + B) * step + x + B;
      T t0 = t[i];
      if (t0 > hv) {
        int32_t l0 = lab ? (*lab)[i] : 0;
        for (int k = 0; k < 8; ++k) {
          const T c = t[i - off[k]] + wt[k];
          if (t0 > c) {
            t0 = c;
            if (lab) l0 = (*lab)[i - off[k]];
          }
        }
        t[i] = t0;
        if (lab) (*lab)[i] = l0;
      }
    }
  }
}


// LineIterator(img, p0, p1, 8, leftToRight) of drawing.cpp: Bresenham from
// the left end; pixels outside the image are skipped (the rasters here
// hold every vertex).
void cv_line(uint8_t* img, int h, int w, int x0, int y0, int x1, int y1,
             uint8_t value) {
  int dx = x1 - x0, dy = y1 - y0;
  if (dx < 0) {
    dx = -dx;
    dy = -dy;
    std::swap(x0, x1);
    std::swap(y0, y1);
  }
  int sx = 1, sy = 1;
  if (dy < 0) {
    dy = -dy;
    sy = -1;
  }
  const bool vert = dy > dx;
  if (vert) std::swap(dx, dy);
  int err = dx - (dy + dy);
  const int plus_delta = dx + dx, minus_delta = -(dy + dy);
  int x = x0, y = y0;
  for (int i = 0; i <= dx; ++i) {
    if (x >= 0 && x < w && y >= 0 && y < h) img[(size_t)y * w + x] = value;
    const bool diag = err < 0;
    err += minus_delta + (diag ? plus_delta : 0);
    // the major axis always steps; the minor one when err was negative
    if (vert) {
      y += sy;
      if (diag) x += sx;
    } else {
      x += sx;
      if (diag) y += sy;
    }
  }
}

struct PolyEdge {
  int y0, y1;
  int64_t x, dx;
  PolyEdge* next;
};

}  // namespace

extern "C" {

// Trace the borders of mask (h, w; nonzero = set). Returns a handle for
// find_contours_sizes / find_contours_copy / find_contours_free.
void* find_contours_run(const uint8_t* mask, int h, int w, int* n_out,
                        long* n_pts_out) {
  Contours* res = new Contours();
  const int W = w + 2, H = h + 2;
  std::vector<int32_t> img((size_t)W * H, 0);
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x)
      img[(size_t)(y + 1) * W + x + 1] = mask[(size_t)y * w + x] != 0;
  std::vector<Contour>& cs = res->items;
  for (int y = 1; y < H - 1; ++y) {
    int32_t* row = &img[(size_t)y * W];
    int prev = 0;
    int lnbd_x = 0;
    for (int x = 1; x < W - 1; ++x) {
      int p = row[x];
      if (p == prev) continue;
      int is_hole = -1;
      if (prev == 0 && p == 1) {
        is_hole = 0;
      } else if (p == 0 && prev >= 1) {
        if (prev & -2) lnbd_x = x - 1;
        is_hole = 1;
      }
      if (is_hole >= 0) {
        int parent = -1;
        if (is_hole && lnbd_x > 0) {
          // RETR_CCOMP: an outer border's parent is the frame; a hole's
          // is the border that owns the last border pixel left of it,
          // or that border's parent when it is a hole too
          int owner = std::abs(row[lnbd_x]) - 2;
          parent = cs[owner].is_hole ? cs[owner].parent : owner;
        }
        lnbd_x = x - is_hole;
        Contour c;
        c.is_hole = is_hole;
        c.parent = parent;
        fetch(img.data(), W, (long)y * W + x - is_hole, x - is_hole - 1,
              y - 1, is_hole, (int)cs.size() + 2, c.pts);
        cs.push_back(std::move(c));
        prev = row[x];
        continue;
      }
      prev = p;
      if (prev & -2) lnbd_x = x;
    }
  }
  // children lists newest first, as OpenCV inserts each contour at the
  // head of its parent's list; index 0 of first[] is the frame
  const int n = (int)cs.size();
  std::vector<int> first(n + 1, -1), next(n, -1);
  for (int i = 0; i < n; ++i) {
    int slot = cs[i].parent + 1;
    next[i] = first[slot];
    first[slot] = i;
  }
  walk(first, next, first[0], res->order);
  std::vector<int> pos(n, -1), prevs(n, -1);
  for (int k = 0; k < n; ++k) pos[res->order[k]] = k;
  for (int i = 0; i < n; ++i)
    if (next[i] != -1) prevs[next[i]] = i;
  res->hier.resize((size_t)4 * n);
  long total = 0;
  for (int k = 0; k < n; ++k) {
    int i = res->order[k];
    res->hier[4 * k + 0] = next[i] == -1 ? -1 : pos[next[i]];
    res->hier[4 * k + 1] = prevs[i] == -1 ? -1 : pos[prevs[i]];
    res->hier[4 * k + 2] = first[i + 1] == -1 ? -1 : pos[first[i + 1]];
    res->hier[4 * k + 3] = cs[i].parent == -1 ? -1 : pos[cs[i].parent];
    total += (long)cs[i].pts.size() / 2;
  }
  *n_out = n;
  *n_pts_out = total;
  return res;
}

// Copy out: pts (n_pts, 2) int32 in output order, sizes (n,), hier (n, 4).
void find_contours_copy(void* handle, int32_t* pts, int32_t* sizes,
                        int32_t* hier) {
  Contours* res = static_cast<Contours*>(handle);
  long off = 0;
  for (size_t k = 0; k < res->order.size(); ++k) {
    const std::vector<int32_t>& p = res->items[res->order[k]].pts;
    std::memcpy(pts + off, p.data(), p.size() * sizeof(int32_t));
    off += (long)p.size();
    sizes[k] = (int32_t)(p.size() / 2);
  }
  std::memcpy(hier, res->hier.data(), res->hier.size() * sizeof(int32_t));
}

void find_contours_free(void* handle) {
  delete static_cast<Contours*>(handle);
}

// 8-connected labels of mask (h, w) into labels (h, w) int32, 0 for the
// background; returns the number of labels including the background.
int components8(const uint8_t* mask, int h, int w, int32_t* labels) {
  const size_t n = (size_t)h * w;
  std::vector<int32_t> parent(n, -1);
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      const size_t i = (size_t)y * w + x;
      if (!mask[i]) continue;
      parent[i] = (int32_t)i;
      if (x > 0 && mask[i - 1]) unite(parent, (int32_t)i, (int32_t)(i - 1));
      if (y > 0) {
        const size_t u = i - w;
        if (x > 0 && mask[u - 1]) unite(parent, (int32_t)i, (int32_t)(u - 1));
        if (mask[u]) unite(parent, (int32_t)i, (int32_t)u);
        if (x + 1 < w && mask[u + 1])
          unite(parent, (int32_t)i, (int32_t)(u + 1));
      }
    }
  }
  std::vector<int32_t> final_label(n, 0);
  int next = 1;
  for (int by = 0; by < h; by += 2) {
    for (int bx = 0; bx < w; bx += 2) {
      for (int dy = 0; dy < 2 && by + dy < h; ++dy) {
        for (int dx = 0; dx < 2 && bx + dx < w; ++dx) {
          const size_t i = (size_t)(by + dy) * w + bx + dx;
          if (!mask[i]) continue;
          int32_t r = find_root(parent, (int32_t)i);
          if (final_label[r] == 0) final_label[r] = next++;
        }
      }
    }
  }
  for (size_t i = 0; i < n; ++i)
    labels[i] = mask[i] ? final_label[find_root(parent, (int32_t)i)] : 0;
  return next;
}

// stats (n_labels, 5) int32: left, top, width, height, area per label.
void component_stats(const int32_t* labels, int h, int w, int n_labels,
                     int32_t* stats) {
  std::vector<int32_t> x0(n_labels, INT_MAX), y0(n_labels, INT_MAX),
      x1(n_labels, INT_MIN), y1(n_labels, INT_MIN), area(n_labels, 0);
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      const int l = labels[(size_t)y * w + x];
      x0[l] = std::min(x0[l], x);
      x1[l] = std::max(x1[l], x);
      y0[l] = std::min(y0[l], y);
      y1[l] = std::max(y1[l], y);
      area[l] += 1;
    }
  }
  for (int l = 0; l < n_labels; ++l) {
    int32_t* s = stats + 5 * l;
    if (area[l] == 0) {
      s[0] = s[1] = s[2] = s[3] = s[4] = 0;
      continue;
    }
    s[0] = x0[l];
    s[1] = y0[l];
    s[2] = x1[l] - x0[l] + 1;
    s[3] = y1[l] - y0[l] + 1;
    s[4] = area[l];
  }
}

void chamfer5(const uint8_t* src, int h, int w, float* dist, int32_t* labels,
              int number_zeros) {
  const int B = 2, step = w + 2 * B;
  if (!labels) {
    std::vector<float> t;
    chamfer_passes<float>(src, h, w, 1.0f, 1.4f, 2.1969f, 1e30f, t, nullptr);
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x)
        dist[(size_t)y * w + x] = t[(size_t)(y + B) * step + x + B];
    return;
  }
  std::vector<int32_t> lab((size_t)(h + 2 * B) * step, 0);
  if (number_zeros) {
    int k = 1;
    for (size_t i = 0; i < (size_t)h * w; ++i) labels[i] = src[i] ? 0 : k++;
  }
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x)
      lab[(size_t)(y + B) * step + x + B] = labels[(size_t)y * w + x];
  // cvRound(weight * 2^16); int64 sums, so the border's INT_MAX plus a
  // weight never wraps
  std::vector<int64_t> t;
  chamfer_passes<int64_t>(src, h, w, 65536, 91750, 143976, INT_MAX, t, &lab);
  const int64_t dmax = INT_MAX >> 2;
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      const size_t i = (size_t)(y + B) * step + x + B;
      dist[(size_t)y * w + x] =
          (float)std::min(t[i], dmax) * (1.0f / 65536.0f);
      labels[(size_t)y * w + x] = lab[i];
    }
  }
}

void draw_line(uint8_t* img, int h, int w, int x0, int y0, int x1, int y1,
               int value) {
  cv_line(img, h, w, x0, y0, x1, y1, (uint8_t)value);
}

// cv2.fillPoly(img, [pts], value) for one ring of n integer points (x, y)
// with LINE_8 and shift 0: CollectPolyEdges, then FillEdgeCollection.
void fill_poly(uint8_t* img, int h, int w, const int32_t* pts, int n,
               int value) {
  const int kShift = 16;
  const uint8_t v = (uint8_t)value;
  std::vector<PolyEdge> edges;
  edges.reserve(n + 1);
  int64_t px0 = (int64_t)pts[2 * (n - 1)] << kShift;
  int64_t py0 = pts[2 * (n - 1) + 1];
  for (int i = 0; i < n; ++i) {
    const int64_t px1 = (int64_t)pts[2 * i] << kShift;
    const int64_t py1 = pts[2 * i + 1];
    cv_line(img, h, w, (int)((px0 + (1 << (kShift - 1))) >> kShift),
            (int)py0, (int)((px1 + (1 << (kShift - 1))) >> kShift),
            (int)py1, v);
    if (py0 != py1) {
      PolyEdge e;
      if (py0 < py1) {
        e.y0 = (int)py0;
        e.y1 = (int)py1;
        e.x = px0;
      } else {
        e.y0 = (int)py1;
        e.y1 = (int)py0;
        e.x = px1;
      }
      e.dx = (px1 - px0) / (py1 - py0);
      e.next = nullptr;
      edges.push_back(e);
    }
    px0 = px1;
    py0 = py1;
  }
  const int total = (int)edges.size();
  if (total < 2) return;
  int y_max = INT_MIN, y_min = INT_MAX;
  int64_t x_max = INT64_MIN, x_min = INT64_MAX;
  for (const PolyEdge& e : edges) {
    const int64_t x1 = e.x + (e.y1 - e.y0) * e.dx;
    y_min = std::min(y_min, e.y0);
    y_max = std::max(y_max, e.y1);
    x_min = std::min(x_min, std::min(e.x, x1));
    x_max = std::max(x_max, std::max(e.x, x1));
  }
  if (y_max < 0 || y_min >= h || x_max < 0 ||
      x_min >= ((int64_t)w << kShift))
    return;
  std::sort(edges.begin(), edges.end(),
            [](const PolyEdge& a, const PolyEdge& b) {
              if (a.y0 != b.y0) return a.y0 < b.y0;
              if (a.x != b.x) return a.x < b.x;
              return a.dx < b.dx;
            });
  PolyEdge tmp;
  tmp.y0 = INT_MAX;
  tmp.next = nullptr;
  edges.push_back(tmp);
  PolyEdge head;
  head.next = nullptr;
  int i = 0;
  PolyEdge* e = &edges[0];
  y_max = std::min(y_max, h);
  for (int y = e->y0; y < y_max; ++y) {
    PolyEdge* prelast = &head;
    PolyEdge* last = head.next;
    PolyEdge* keep_prelast;
    int draw = 0;
    const bool clipline = y < 0;
    while (last || e->y0 == y) {
      if (last && last->y1 == y) {
        // an edge leaves the active list at its lower end
        prelast->next = last->next;
        last = last->next;
        continue;
      }
      keep_prelast = prelast;
      if (last && (e->y0 > y || last->x < e->x)) {
        prelast = last;
        last = last->next;
      } else if (i < total) {
        // an edge enters the active list at its upper end
        prelast->next = e;
        e->next = last;
        prelast = e;
        e = &edges[++i];
      } else {
        break;
      }
      if (draw) {
        if (!clipline) {
          int x1, x2;
          // the span's pixel centres: left end rounded up, right down
          const int64_t delta = ((int64_t)1 << kShift) - 1;
          if (keep_prelast->x > prelast->x) {
            x1 = (int)((prelast->x + delta) >> kShift);
            x2 = (int)(keep_prelast->x >> kShift);
          } else {
            x1 = (int)((keep_prelast->x + delta) >> kShift);
            x2 = (int)(prelast->x >> kShift);
          }
          if (x1 < w && x2 >= 0) {
            x1 = std::max(x1, 0);
            x2 = std::min(x2, w - 1);
            std::memset(img + (size_t)y * w + x1, v, (size_t)(x2 - x1 + 1));
          }
        }
        keep_prelast->x += keep_prelast->dx;
        prelast->x += prelast->dx;
      }
      draw ^= 1;
    }
    // bubble sort of the active list by x
    keep_prelast = nullptr;
    do {
      prelast = &head;
      last = head.next;
      PolyEdge* last_exchange = nullptr;
      while (last != keep_prelast && last->next != nullptr) {
        PolyEdge* te = last->next;
        if (last->x > te->x) {
          prelast->next = te;
          last->next = te->next;
          te->next = last;
          prelast = te;
          last_exchange = prelast;
        } else {
          prelast = last;
          last = te;
        }
      }
      if (last_exchange == nullptr) break;
      keep_prelast = last_exchange;
    } while (keep_prelast != head.next && keep_prelast != &head);
  }
}

}  // extern "C"
