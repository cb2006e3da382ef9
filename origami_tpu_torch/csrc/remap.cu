// Bilinear remap, full-page dewarp and affine warp for Hopper (sm_90a).
//
// Replaces the Pallas kernel `remap_pallas` -> `_remap_call` (body
// `_remap_kernel`) of origami_tpu/ops/pallas/remap.py, and the two XLA
// routes of the JAX dewarp (core/dewarp.py:504-520: `dewarp_banded_u8`
// and the dense upsample + `bilinear_sample_xy`).
//
// What bounds it on this card: memory. Per output pixel the work is a
// handful of FMAs, four page taps and one store; the least traffic is
// one read of the page and one write of the output (the map for the map
// form, a few KB of grid for `dewarp_kernel`, six coefficients for the
// affine form). The Pallas kernel windowed the page into VMEM and ran a
// banded row loop because Mosaic has no general gather.
//
// The map and affine forms and the u8 dewarp compute 4 adjacent output
// pixels of a row in a thread and write them with one store (16 bytes
// of f32, 4 of u8), so a warp writes whole lines; a ragged row end or an
// unaligned output takes scalar stores. The f32 dewarp takes one pixel
// a thread at a time (kF32Pixels).
//
// `remap_f32_kernel` samples f32 images through the read-only cache
// (`__ldg`) at coordinates from a dense map (x and y planes, or one
// interleaved (H', W', 2) map, read with one or two `float4` loads a
// thread) or from an affine's six coefficients (the JAX affine_warp,
// origami_tpu/ops/remap.py:76-85: no map is read). The grid's z axis
// walks a batch of images, so the training step warps its whole batch
// (train/segment/warp.py's bilinear_sample, hard border) in one launch.
// The affine form reads its taps through `__ldg` too: staging each
// 128 x 32 tile's source window (the bounding box of its corners'
// coordinates) in shared memory with `cp.async` took 0.0144-0.0146 ms at
// phase 15's site on an NVIDIA H100 80GB HBM3 at 700 W, these quads
// 0.0113-0.0114 (scripts/remap_ab.py, variant "staged").
//
// `dewarp_kernel` upsamples the coarse grid inside the kernel
// (index-aligned, nearest beyond the last node, as core/dewarp.py:436-456),
// so the dense (H', W', 2) map of the JAX dense route never exists in
// memory. It is templated on the pixel type: u8 pages (`dewarp_u8`, the
// page dewarp) and f32 images (`dewarp_f32`, the layout stage's
// separator mask, in place of an upsampled map and a remap). A block
// owns an output tile of kCells x kCells grid cells:
//   * it loads the tile's nodes into shared memory and builds two tables
//     once, with the division y / res and x / res of the plain version,
//     so no pixel divides and the bits stay the plain version's: per
//     output row, the node columns already interpolated along y (the
//     plain version's first lerp), and per output column tx and the node
//     column, as two arrays that a quad of pixels reads with one 16-byte
//     load each;
//   * every source point of the tile is a convex combination of those
//     nodes, so its taps lie in the nodes' bounding box plus one pixel
//     for the second tap (plus one of margin for rounding), clamped to
//     the page (border "hard") or to the page and a ring of one pixel
//     of `fill` around it (border "fill_taps": every tap outside the
//     page reads `fill`, so a tap at -5 reads what one at -1 does, and
//     the staged window holds `fill` where it leaves the page). When
//     that window fits kWindow bytes of shared memory, the block copies
//     it in with 16-byte `cp.async` (element loads where the page's rows
//     are not 16-byte aligned) and reads its taps there; otherwise (a
//     strongly sheared or scrambled grid) the tile reads its taps
//     through `__ldg`, testing each tap against the page under
//     "fill_taps". The route is chosen per tile from the geometry; a tap
//     outside the staged window (which the bounding box excludes) would
//     also go to `__ldg`, so both give the same values;
//   * the two borders are the two JAX routes' (core/dewarp.py:504-520):
//     "hard" is the dense route's (the sample is `fill` outside
//     [0, w-1] x [0, h-1], taps clamped into the page; for u8 clipped
//     and truncated, dewarp.py:477), "fill_taps" the banded route's
//     (its passes pad the page with `fill`, ops/remap.py:189-239; for u8
//     rounded, then clipped, ops/remap.py:273-275). f32 keeps the sample.
//
// Every kernel repeats its plain version's arithmetic product by product
// (built with -fmad=false), so the two agree to the bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// An inclusive pixel range [lo, hi] of one axis of the page (size n)
// that holds every tap of source coordinates in [mn, mx]: floor, the
// second tap, one pixel of margin each side, clamped to [0, n-1] (hard)
// or [-1, n] (fill_taps: the ring of fill); empty (hi < lo) for NaN.
__device__ __forceinline__ int2 tap_range(float mn, float mx, int n,
                                          bool fill_taps) {
  if (!(mn <= mx)) return make_int2(0, -1);
  float bot = fill_taps ? -1.0f : 0.0f;
  float top = fill_taps ? (float)n : (float)(n - 1);
  int lo = (int)fminf(fmaxf(floorf(mn) - 1.0f, bot), top);
  int hi = (int)fminf(fmaxf(floorf(mx) + 2.0f, bot), top);
  return make_int2(lo, hi);
}

// ---------------------------------------------------------------------------
// the dense-map form
// ---------------------------------------------------------------------------

// One bilinear sample of the f32 image (h, w) at (sx, sy), taps through
// the read-only cache. Two borders:
//   kHard == false (remap_pallas): coordinates clamped into a fill
//     margin ([-2, w+1] x [-2, h+1]); taps outside the image read `fill`;
//   kHard == true (bilinear_sample_xy, origami_tpu/ops/remap.py:28-59,
//     the training warp's): taps clamped into the image, the sample
//     `fill` outside [0, w-1] x [0, h-1].
// Each tap is loaded from an index clamped into the image and then
// selected, so the four loads issue unconditionally.
template <bool kHard>
__device__ __forceinline__ float sample_ldg(const float* __restrict__ img,
                                            int h, int w, float sx, float sy,
                                            float fill) {
  if (!kHard) {
    sx = fminf(fmaxf(sx, -2.0f), (float)w + 1.0f);
    sy = fminf(fmaxf(sy, -2.0f), (float)h + 1.0f);
  }
  float fx = floorf(sx), fy = floorf(sy);
  float tx = sx - fx, ty = sy - fy;
  // hard: NaN and far coordinates keep the index in [-1, n] (the taps
  // clamp into the image); fill_taps: the clamp above keeps it in
  // [-2, n + 1], and each tap off the image reads `fill`
  int x0 = kHard ? (int)fminf(fmaxf(fx, -1.0f), (float)w) : (int)fx;
  int y0 = kHard ? (int)fminf(fmaxf(fy, -1.0f), (float)h) : (int)fy;
  int xa = min(max(x0, 0), w - 1), xb = min(max(x0 + 1, 0), w - 1);
  int ya = min(max(y0, 0), h - 1), yb = min(max(y0 + 1, 0), h - 1);
  float v00 = __ldg(img + (long)ya * w + xa);
  float v01 = __ldg(img + (long)ya * w + xb);
  float v10 = __ldg(img + (long)yb * w + xa);
  float v11 = __ldg(img + (long)yb * w + xb);
  if (!kHard) {
    bool xin0 = x0 >= 0 && x0 < w, xin1 = x0 + 1 >= 0 && x0 + 1 < w;
    bool yin0 = y0 >= 0 && y0 < h, yin1 = y0 + 1 >= 0 && y0 + 1 < h;
    v00 = xin0 && yin0 ? v00 : fill;
    v01 = xin1 && yin0 ? v01 : fill;
    v10 = xin0 && yin1 ? v10 : fill;
    v11 = xin1 && yin1 ? v11 : fill;
  }
  float top = v00 * (1.0f - tx) + v01 * tx;
  float bot = v10 * (1.0f - tx) + v11 * tx;
  float r = top * (1.0f - ty) + bot * ty;
  if (kHard && !(sx >= 0.0f && sx <= (float)(w - 1) && sy >= 0.0f &&
                 sy <= (float)(h - 1)))
    r = fill;
  return r;
}

struct Affine {
  float m[6];
};

// The source (x, y) of output (col, row) under an inverse-map affine:
// m0 col + m1 row + m2 and m3 col + m4 row + m5 in float32 as XLA's CPU
// backend evaluates them (ops/remap.py:80-84): m1 row rounded, m0 col
// fused into it, then m2 added (the plain version's core/math.fma_f32).
__device__ __forceinline__ void affine_src(const Affine& a, int col, int row,
                                           float& sx, float& sy) {
  float fc = (float)col, fr = (float)row;
  sx = __fadd_rn(__fmaf_rn(a.m[0], fc, __fmul_rn(a.m[1], fr)), a.m[2]);
  sy = __fadd_rn(__fmaf_rn(a.m[3], fc, __fmul_rn(a.m[4], fr)), a.m[5]);
}

// Image b of a batch (the grid's z index) sampled at (oh, ow) source
// coordinates. kAffine: each computed from the affine `a` (no map is
// read). Otherwise through a map: the source (x, y) of output pixel o is
// (mx[o * stride], my[o * stride]), so an interleaved (H', W', 2) map
// (my = mx + 1, stride 2) and separate x and y planes (stride 1) take the
// same kernel. A block is 256 threads, 8 rows of 128 output pixels; a
// thread takes 4 adjacent pixels of a row, computes their 4 coordinates
// and then their 16 taps, so the loads issue together. vec: the rows are
// whole 16-byte lines (ow % 4 == 0; the output and any map 16-byte
// aligned), so a thread reads its map with one float4 load a plane (two
// of the interleaved map) and writes one float4; otherwise scalar loads
// and stores.
template <bool kHard, bool kAffine>
__global__ void __launch_bounds__(256)
    remap_f32_kernel(const float* __restrict__ img, int h, int w,
                     const float* __restrict__ mx,
                     const float* __restrict__ my, int stride, Affine a,
                     int oh, int ow, float fill, int vec,
                     float* __restrict__ out) {
  const int x = (blockIdx.x * 32 + (threadIdx.x & 31)) << 2;
  const int y = blockIdx.y * 8 + (threadIdx.x >> 5);
  if (x >= ow || y >= oh) return;
  const int n = min(4, ow - x);
  const long o = (long)blockIdx.z * oh * ow + (long)y * ow + x;
  img += (long)blockIdx.z * h * w;
  float sx[4], sy[4];
  if (kAffine) {
#pragma unroll
    for (int k = 0; k < 4; ++k)   // past a ragged row end: its last pixel
      affine_src(a, x + min(k, n - 1), y, sx[k], sy[k]);
  } else if (vec) {
    if (stride == 1) {
      float4 p = __ldg(reinterpret_cast<const float4*>(mx + o));
      float4 q = __ldg(reinterpret_cast<const float4*>(my + o));
      sx[0] = p.x; sx[1] = p.y; sx[2] = p.z; sx[3] = p.w;
      sy[0] = q.x; sy[1] = q.y; sy[2] = q.z; sy[3] = q.w;
    } else {
      const float4* m = reinterpret_cast<const float4*>(mx + 2 * o);
      float4 p = __ldg(m), q = __ldg(m + 1);
      sx[0] = p.x; sx[1] = p.z; sx[2] = q.x; sx[3] = q.z;
      sy[0] = p.y; sy[1] = p.w; sy[2] = q.y; sy[3] = q.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      long i = (o + min(k, n - 1)) * stride;
      sx[k] = __ldg(mx + i);
      sy[k] = __ldg(my + i);
    }
  }
  float r[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    r[k] = sample_ldg<kHard>(img, h, w, sx[k], sy[k], fill);
  if (vec && n == 4) {
    *reinterpret_cast<float4*>(out + o) = make_float4(r[0], r[1], r[2], r[3]);
  } else {
    for (int k = 0; k < n; ++k) out[o + k] = r[k];
  }
}

// ---------------------------------------------------------------------------
// the grid form (the dewarp), u8 and f32
// ---------------------------------------------------------------------------

constexpr int kDewarpThreads = 256;
// u8 pages: tiles of 4 x 4 cells, a window of up to 32 KB
constexpr int kU8Cells = 4;
constexpr int kU8Window = 32768;
// f32 images: tiles of 2 x 2 cells, a window of up to 16 KB (about
// 54 x 54 floats at the layout stage's 25-px cells), one pixel a thread
// at a time. On an NVIDIA H100 80GB HBM3 at 700 W at the layout stage's
// site that took 0.0209-0.0210 ms a page, where 4 x 4-cell tiles with a
// 48 KB window (opted in above 48 KB of shared memory: 4 blocks an SM)
// took 0.0244-0.0254 with one pixel a thread and 0.0215-0.0229 with
// quads (scripts/remap_ab.py)
constexpr int kF32Cells = 2;
constexpr int kF32Window = 16384;
constexpr int kF32Pixels = 1;           // pixels of a row a thread takes

// the output of one sample: u8 under "fill_taps" rounded half to even,
// then clipped, under "hard" clipped and truncated; f32 as it is
__device__ __forceinline__ uint8_t to_pixel(float v, int fill_taps,
                                            uint8_t*) {
  return (uint8_t)(uint32_t)fminf(fmaxf(fill_taps ? rintf(v) : v, 0.0f),
                                  255.0f);
}
__device__ __forceinline__ float to_pixel(float v, int, float*) { return v; }

// 4 bytes of `fill` pixels (one f32, four u8), to fill 16-byte chunks
__device__ __forceinline__ unsigned fill_word(uint8_t v) {
  return 0x01010101u * v;
}
__device__ __forceinline__ unsigned fill_word(float v) {
  return __float_as_uint(v);
}

// 4 adjacent output pixels with one store (4 bytes of u8, 16 of f32)
__device__ __forceinline__ void store4(uint8_t* d, const uint8_t* v) {
  *reinterpret_cast<uint32_t*>(d) = (uint32_t)v[0] | ((uint32_t)v[1] << 8) |
                                    ((uint32_t)v[2] << 16) |
                                    ((uint32_t)v[3] << 24);
}
__device__ __forceinline__ void store4(float* d, const float* v) {
  *reinterpret_cast<float4*>(d) = make_float4(v[0], v[1], v[2], v[3]);
}

// full[y, x] = bilinear(hv at (x / res, y / res)), clamped to the last
// node (map_coordinates order=1, mode="nearest"), then one bilinear
// sample of the page there. fill_taps == 0 ("hard"): `fill` outside
// [0, w-1] x [0, h-1] (ops/remap.py:58-59), taps clamped into the page.
// fill_taps == 1: the coordinate clamped into [-2, w+1] x [-2, h+1],
// each tap outside the page reads `fill` (for u8 an integer in
// [0, 255]). The output as to_pixel gives it. Dynamic shared memory: the
// window (kWindow bytes), then the row table (kCells res x (kCells + 1)
// float2) and the column tables (tx, then the node column; kCells res
// each, rounded up to whole quads).
template <typename T, int kCells, int kWindow>
__global__ void __launch_bounds__(kDewarpThreads)
    dewarp_kernel(const T* __restrict__ page, int h, int w,
                  const float* __restrict__ hv, int gh, int gw, int res,
                  float fill, int fill_taps, int aligned,
                  T* __restrict__ out, int* __restrict__ staged_tiles) {
  static_assert((kCells + 1) * (kCells + 1) <= 32, "a warp loads the nodes");
  constexpr int kNodes = kCells + 1;
  constexpr int kChunk = 16 / sizeof(T);    // pixels of a 16-byte chunk
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float2 nodes[kNodes][kNodes];
  __shared__ int win[5];                    // x0, y0, x1, y1, staged
  T* window = reinterpret_cast<T*>(smem);
  const int span = kCells * res;
  const int span4 = (span + 3) & ~3;
  // per output row: hv at each node column, lerped along y
  float2* rows = (float2*)(smem + kWindow);
  // per output column: tx and the node column (16-byte aligned)
  float* ctx = (float*)(smem + kWindow +
                        ((span * kNodes * sizeof(float2) + 15) & ~15));
  int* clx = (int*)(ctx + span4);

  const int tid = threadIdx.x;
  const int cx0 = blockIdx.x * kCells, cy0 = blockIdx.y * kCells;
  const int ox0 = cx0 * res, oy0 = cy0 * res;
  const int ow = gw * res;
  const int tw = min(span, ow - ox0), th = min(span, gh * res - oy0);

  // the tile's nodes (clamped to the last node) and their bounding box
  if (tid < 32) {
    float x = __int_as_float(0x7fc00000), y = x;   // NaN: ignored below
    if (tid < kNodes * kNodes) {
      int ly = tid / kNodes, lx = tid % kNodes;
      int gy = min(cy0 + ly, gh - 1), gx = min(cx0 + lx, gw - 1);
      x = __ldg(hv + 2 * (gy * gw + gx));
      y = __ldg(hv + 2 * (gy * gw + gx) + 1);
      nodes[ly][lx] = make_float2(x, y);
    }
    float mnx = x, mxx = x, mny = y, mxy = y;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      mnx = fminf(mnx, __shfl_xor_sync(kAll, mnx, o));
      mxx = fmaxf(mxx, __shfl_xor_sync(kAll, mxx, o));
      mny = fminf(mny, __shfl_xor_sync(kAll, mny, o));
      mxy = fmaxf(mxy, __shfl_xor_sync(kAll, mxy, o));
    }
    if (tid == 0) {
      int2 rx = tap_range(mnx, mxx, w, fill_taps),
           ry = tap_range(mny, mxy, h, fill_taps);
      if (aligned && rx.y >= rx.x) {        // whole 16-byte chunks
        rx.x &= ~(kChunk - 1);              // -1 becomes -kChunk
        rx.y = min((rx.y + kChunk) & ~(kChunk - 1),
                   fill_taps ? w + kChunk : w) - 1;
      }
      long bytes = (rx.y >= rx.x && ry.y >= ry.x)
                       ? (long)sizeof(T) * (rx.y - rx.x + 1) *
                             (ry.y - ry.x + 1)
                       : 0;
      win[0] = rx.x;
      win[1] = ry.x;
      win[2] = rx.y;
      win[3] = ry.y;
      win[4] = bytes <= kWindow;
      if (staged_tiles && win[4]) atomicAdd(staged_tiles, 1);
    }
  }
  __syncthreads();
  const int wx0 = win[0], wy0 = win[1], wx1 = win[2], wy1 = win[3];
  const bool staged = win[4];
  const int ww = wx1 - wx0 + 1;

  // fill_taps: the window's cells off the page hold `fill`; with
  // aligned rows (w a multiple of the chunk) a chunk is wholly on or off
  // the page
  const T fill_t = (T)fill;
  if (staged && ww > 0 && wy1 >= wy0) {
    int nrows = wy1 - wy0 + 1;
    if (aligned) {
      int chunks = ww / kChunk;
      uint4 fill16;
      fill16.x = fill16.y = fill16.z = fill16.w = fill_word(fill_t);
      for (int i = tid; i < chunks * nrows; i += kDewarpThreads) {
        int r = i / chunks, c = (i - r * chunks) * kChunk;
        int gy = wy0 + r, gx = wx0 + c;
        if (gy >= 0 && gy < h && gx >= 0 && gx < w)
          cp_async16(window + r * ww + c, page + (size_t)gy * w + gx);
        else
          *reinterpret_cast<uint4*>(window + r * ww + c) = fill16;
      }
      asm volatile("cp.async.commit_group;\n" ::);
    } else {
      for (int i = tid; i < ww * nrows; i += kDewarpThreads) {
        int r = i / ww, c = i - r * ww;
        int gy = wy0 + r, gx = wx0 + c;
        window[i] = (gy >= 0 && gy < h && gx >= 0 && gx < w)
                        ? __ldg(page + (size_t)gy * w + gx)
                        : fill_t;
      }
    }
  }
  // the row and column tables, while the copies are in flight
  for (int i = tid; i < th * kNodes; i += kDewarpThreads) {
    int r = i / kNodes, lx = i - r * kNodes;
    float g = (float)(oy0 + r) / (float)res;
    float f = floorf(g);
    float ty = g - f, uy = 1.0f - ty;
    int ly = (int)f - cy0;
    float2 a = nodes[ly][lx], b = nodes[ly + 1][lx];
    rows[i] = make_float2(a.x * uy + b.x * ty, a.y * uy + b.y * ty);
  }
  for (int i = tid; i < tw; i += kDewarpThreads) {
    float g = (float)(ox0 + i) / (float)res;
    float f = floorf(g);
    ctx[i] = g - f;
    clx[i] = (int)f - cx0;
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  const float wmax = (float)(w - 1), hmax = (float)(h - 1);
  // fill_taps: one tap, `fill` off the page; the index is first clamped
  // into the window's ring [-1, n] (every index off the page reads fill)
  auto tap = [&](int x, int y) -> float {
    if (x < 0 || x >= w || y < 0 || y >= h) return fill;
    return (float)__ldg(page + (size_t)y * w + x);
  };
  // one output pixel of tile row `row`, of column table entries (tx, lx)
  auto pixel = [&](const float2* row, float tx, int lx) -> T {
    float2 r0 = row[lx], r1 = row[lx + 1];
    float ux = 1.0f - tx;
    float sx = r0.x * ux + r1.x * tx;
    float sy = r0.y * ux + r1.y * tx;
    if (fill_taps) {
      sx = fminf(fmaxf(sx, -2.0f), (float)(w + 1));
      sy = fminf(fmaxf(sy, -2.0f), (float)(h + 1));
      float px = floorf(sx), py = floorf(sy);
      float vx = sx - px, vy = sy - py;
      int xa = min(max((int)px, -1), w), xb = min(max((int)px + 1, -1), w);
      int ya = min(max((int)py, -1), h), yb = min(max((int)py + 1, -1), h);
      float v00, v01, v10, v11;
      if (staged && xa >= wx0 && xb <= wx1 && ya >= wy0 && yb <= wy1) {
        const T* t0 = window + (ya - wy0) * ww - wx0;
        const T* t1 = window + (yb - wy0) * ww - wx0;
        v00 = t0[xa];
        v01 = t0[xb];
        v10 = t1[xa];
        v11 = t1[xb];
      } else {
        v00 = tap(xa, ya);
        v01 = tap(xb, ya);
        v10 = tap(xa, yb);
        v11 = tap(xb, yb);
      }
      float top = v00 * (1.0f - vx) + v01 * vx;
      float bot = v10 * (1.0f - vx) + v11 * vx;
      return to_pixel(top * (1.0f - vy) + bot * vy, 1, (T*)nullptr);
    }
    float val = fill;
    if (sx >= 0.0f && sx <= wmax && sy >= 0.0f && sy <= hmax) {
      float px = floorf(sx), py = floorf(sy);
      float vx = sx - px, vy = sy - py;
      int xa = (int)px, ya = (int)py;
      int xb = min(xa + 1, w - 1), yb = min(ya + 1, h - 1);
      float v00, v01, v10, v11;
      if (staged && xa >= wx0 && xb <= wx1 && ya >= wy0 && yb <= wy1) {
        const T* t0 = window + (ya - wy0) * ww - wx0;
        const T* t1 = window + (yb - wy0) * ww - wx0;
        v00 = t0[xa];
        v01 = t0[xb];
        v10 = t1[xa];
        v11 = t1[xb];
      } else {
        v00 = __ldg(page + (size_t)ya * w + xa);
        v01 = __ldg(page + (size_t)ya * w + xb);
        v10 = __ldg(page + (size_t)yb * w + xa);
        v11 = __ldg(page + (size_t)yb * w + xb);
      }
      float top = v00 * (1.0f - vx) + v01 * vx;
      float bot = v10 * (1.0f - vx) + v11 * vx;
      val = top * (1.0f - vy) + bot * vy;
    }
    return to_pixel(val, 0, (T*)nullptr);
  };

  // groups of kPx adjacent output pixels of a row, walked in row order
  // without a division per group: thread t starts at group t and steps
  // kDewarpThreads groups. u8: quads, each written with one 4-byte store;
  // f32: single pixels, so that neighbouring lanes read neighbouring
  // words of the window (a quad a lane puts 4 lanes on each bank)
  constexpr int kPx = sizeof(T) == 1 ? 4 : kF32Pixels;
  const int groups = (tw + kPx - 1) / kPx;
  const int step_r = kDewarpThreads / groups;
  const int step_c = kDewarpThreads - step_r * groups;
  // one store a quad where every quad starts on a 4-pixel boundary
  const bool wide = (ow & 3) == 0 && (span & 3) == 0;
  int r = tid / groups, q = tid - r * groups;
  while (r < th) {
    const float2* row = rows + r * kNodes;
    int c0 = q * kPx;
    T* dst = out + (size_t)(oy0 + r) * ow + ox0 + c0;
    if (kPx == 4 && c0 + 4 <= tw) {       // four independent pixels
      float4 t4 = *reinterpret_cast<const float4*>(ctx + c0);
      int4 l4 = *reinterpret_cast<const int4*>(clx + c0);
      T v[4] = {pixel(row, t4.x, l4.x), pixel(row, t4.y, l4.y),
                pixel(row, t4.z, l4.z), pixel(row, t4.w, l4.w)};
      if (wide) {
        store4(dst, v);
      } else {
        dst[0] = v[0];
        dst[1] = v[1];
        dst[2] = v[2];
        dst[3] = v[3];
      }
    } else {                              // a pixel, or a ragged row end
      for (int k = 0; k < kPx && c0 + k < tw; ++k)
        dst[k] = pixel(row, ctx[c0 + k], clx[c0 + k]);
    }
    q += step_c;
    r += step_r;
    if (q >= groups) {
      q -= groups;
      ++r;
    }
  }
}

template <typename T, int kCells, int kWindow>
int launch_dewarp(const T* page, int h, int w, const float* hv, int gh,
                  int gw, int res, float fill, int fill_taps, T* out,
                  int* staged_tiles, void* stream) {
  size_t span = (size_t)kCells * res;
  size_t bytes = kWindow + ((span * (kCells + 1) * sizeof(float2) + 15) & ~15) +
                 ((span + 3) & ~3) * (sizeof(float) + sizeof(int));
  if (bytes > 48 * 1024) {
    cudaError_t rc = cudaFuncSetAttribute(
        dewarp_kernel<T, kCells, kWindow>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (rc != cudaSuccess) return (int)rc;
  }
  int aligned = ((uintptr_t)page % 16 == 0) && (w % (16 / sizeof(T)) == 0);
  dim3 grid((gw + kCells - 1) / kCells, (gh + kCells - 1) / kCells);
  dewarp_kernel<T, kCells, kWindow>
      <<<grid, kDewarpThreads, bytes, (cudaStream_t)stream>>>(
          page, h, w, hv, gh, gw, res, fill, fill_taps, aligned, out,
          staged_tiles);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

}  // namespace

// b images (b, h, w) through their maps (b, oh, ow): mx, my and stride
// as remap_f32_kernel takes them; one launch for the whole batch.
extern "C" int origami_remap_f32(const float* img, int b, int h, int w,
                                 const float* mx, const float* my,
                                 int stride, int oh, int ow, float fill,
                                 int hard, float* out, void* stream) {
  if (b > 65535) return (int)cudaErrorInvalidValue;
  int vec = ow % 4 == 0 && aligned16(mx) && (stride == 2 || aligned16(my)) &&
            aligned16(out);
  dim3 grid((ow + 127) / 128, (oh + 7) / 8, b);
  if (hard)
    remap_f32_kernel<true, false><<<grid, 256, 0, (cudaStream_t)stream>>>(
        img, h, w, mx, my, stride, Affine{}, oh, ow, fill, vec, out);
  else
    remap_f32_kernel<false, false><<<grid, 256, 0, (cudaStream_t)stream>>>(
        img, h, w, mx, my, stride, Affine{}, oh, ow, fill, vec, out);
  return (int)cudaGetLastError();
}

// One image (h, w) through the inverse-map affine (m0 m1 m2; m3 m4 m5)
// to (oh, ow), at the hard border.
extern "C" int origami_remap_affine_f32(const float* img, int h, int w,
                                        float m0, float m1, float m2,
                                        float m3, float m4, float m5,
                                        int oh, int ow, float fill,
                                        float* out, void* stream) {
  Affine a = {{m0, m1, m2, m3, m4, m5}};
  int vec = ow % 4 == 0 && aligned16(out);
  dim3 grid((ow + 127) / 128, (oh + 7) / 8, 1);
  remap_f32_kernel<true, true><<<grid, 256, 0, (cudaStream_t)stream>>>(
      img, h, w, nullptr, nullptr, 1, a, oh, ow, fill, vec, out);
  return (int)cudaGetLastError();
}

// staged_tiles (may be null): the kernel adds the number of tiles that
// read their taps from a staged window.
extern "C" int origami_dewarp_u8(const uint8_t* page, int h, int w,
                                 const float* hv, int gh, int gw, int res,
                                 float fill, int fill_taps, uint8_t* out,
                                 int* staged_tiles, void* stream) {
  return launch_dewarp<uint8_t, kU8Cells, kU8Window>(
      page, h, w, hv, gh, gw, res, fill, fill_taps, out, staged_tiles,
      stream);
}

// The f32 image (h, w) through the grid at the fill_taps border: the
// layout stage's separator mask.
extern "C" int origami_dewarp_f32(const float* img, int h, int w,
                                  const float* hv, int gh, int gw, int res,
                                  float fill, float* out, int* staged_tiles,
                                  void* stream) {
  return launch_dewarp<float, kF32Cells, kF32Window>(
      img, h, w, hv, gh, gw, res, fill, 1, out, staged_tiles, stream);
}
