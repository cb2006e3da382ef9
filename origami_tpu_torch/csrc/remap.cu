// Bilinear remap and full-page dewarp for Hopper (sm_90a).
//
// Replaces the Pallas kernel `remap_pallas` -> `_remap_call` (body
// `_remap_kernel`) of origami_tpu/ops/pallas/remap.py, and the two XLA
// routes of the JAX dewarp (core/dewarp.py:504-520: `dewarp_banded_u8`
// and the dense upsample + `bilinear_sample_xy`).
//
// What bounds it on this card: memory. Per output pixel the work is a
// handful of FMAs, four page taps and one store; the least traffic is
// one read of the page and one write of the output (the map for
// `remap_f32`, a few KB of grid for `dewarp_u8`). The Pallas kernel
// windowed the page into VMEM and ran a banded row loop because Mosaic
// has no general gather.
//
// `remap_f32` reaches the page's bytes through the read-only cache with
// `__ldg`: one thread per output pixel, 32x8 blocks, so the stores
// coalesce and the taps of a warp fall on one or two source rows; the
// grid's z axis walks a batch of images, so the training step warps its
// whole batch (train/segment/warp.py's bilinear_sample, hard border) in
// one launch. `remap_affine_f32` is the same sampler with the source
// (x, y) computed from an affine's six coefficients in the thread (the
// JAX affine_warp, origami_tpu/ops/remap.py:76-85), so no map is read.
//
// `dewarp_u8` upsamples the coarse grid inside the kernel (index-aligned,
// nearest beyond the last node, as core/dewarp.py:436-456), so the dense
// (H', W', 2) map of the JAX dense route never exists in memory. A block
// owns an output tile of 4 x 4 grid cells (4 res x 4 res pixels; 100 x
// 100 at the 25 px cells of the stage):
//   * it loads the tile's 5 x 5 grid nodes into shared memory and builds
//     two tables once, with the division y / res and x / res of the
//     plain version, so no pixel divides and the bits stay the plain
//     version's: per output row, the five node columns already
//     interpolated along y (the plain version's first lerp), and per
//     output column (tx, 1 - tx, node column);
//   * every source point of the tile is a convex combination of those
//     nodes, so its taps lie in the nodes' bounding box plus one pixel
//     for the second tap (plus one of margin for rounding), clamped to
//     the page (border "hard") or to the page and a ring of one pixel
//     of `fill` around it (border "fill_taps": every tap outside the
//     page reads `fill`, so a tap at -5 reads what one at -1 does, and
//     the staged window holds `fill` where it leaves the page). When
//     that window fits kWindowBytes of shared memory, the
//     block copies it in with 16-byte `cp.async` (byte loads where the
//     page's rows are not 16-byte aligned) and reads its taps there;
//     otherwise (a strongly sheared or scrambled grid) the tile reads
//     its taps through `__ldg`, testing each tap against the page under
//     "fill_taps". The route is chosen per tile from the geometry; a tap
//     outside the staged window (which the bounding box excludes) would
//     also go to `__ldg`, so both give the same bytes;
//   * the two borders are the two JAX routes' (core/dewarp.py:504-520):
//     "hard" is the dense route's (the sample is `fill` outside
//     [0, w-1] x [0, h-1], taps clamped into the page; clipped and
//     truncated to u8, dewarp.py:477), "fill_taps" the banded route's
//     (its passes pad the page with `fill`, ops/remap.py:189-239;
//     rounded, then clipped, ops/remap.py:273-275);
//   * each thread computes 4 adjacent output pixels of a row and writes
//     them with one 4-byte store, so a warp writes 128 contiguous bytes
//     (a tile row is 25 such quads at 25 px cells).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// One bilinear sample per output pixel of image b of a batch: the source
// (x, y) of output pixel o is (mx[o * stride], my[o * stride]), so an
// interleaved (H', W', 2) map (my = mx + 1, stride 2) and separate x and
// y planes (stride 1) take the same kernel. Two borders:
//   hard == 0 (remap_pallas): coordinates clamped into a fill margin
//     ([-2, w+1] x [-2, h+1]); taps outside the image read `fill`;
//   hard == 1 (bilinear_sample_xy, origami_tpu/ops/remap.py:28-59, the
//     training warp's): taps clamped into the image, the sample `fill`
//     outside [0, w-1] x [0, h-1].
// kAffine: no maps; the source (x, y) of output (col, row) is
// m0 col + m1 row + m2 and m3 col + m4 row + m5 in float32 as XLA's CPU
// backend evaluates them (ops/remap.py:80-84): m1 row rounded, m0 col
// fused into it, then m2 added (the plain version's core/math.fma_f32).
// The arithmetic is the plain version's, product by product (built
// with -fmad=false), so the two agree to the bit.
struct Affine {
  float m[6];
};

template <bool kAffine>
__global__ void remap_f32_kernel(const float* __restrict__ img, int h, int w,
                                 const float* __restrict__ mx,
                                 const float* __restrict__ my, int stride,
                                 Affine a, int oh, int ow, float fill,
                                 int hard, float* __restrict__ out) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= ow || y >= oh) return;
  long plane = (long)oh * ow;
  long o = (long)y * ow + x;
  img += (long)blockIdx.z * h * w;
  out += blockIdx.z * plane;
  float sx, sy;
  if (kAffine) {
    float fc = (float)x, fr = (float)y;
    sx = __fadd_rn(__fmaf_rn(a.m[0], fc, __fmul_rn(a.m[1], fr)), a.m[2]);
    sy = __fadd_rn(__fmaf_rn(a.m[3], fc, __fmul_rn(a.m[4], fr)), a.m[5]);
  } else {
    long mo = (blockIdx.z * plane + o) * stride;
    sx = __ldg(mx + mo);
    sy = __ldg(my + mo);
  }
  if (!hard) {
    sx = fminf(fmaxf(sx, -2.0f), (float)w + 1.0f);
    sy = fminf(fmaxf(sy, -2.0f), (float)h + 1.0f);
  }
  float fx = floorf(sx), fy = floorf(sy);
  float tx = sx - fx, ty = sy - fy;
  float v[4];
  if (hard) {
    // NaN and far coordinates: the taps stay in the image, the sample
    // is `fill` by the test below
    int x0 = (int)fminf(fmaxf(fx, -1.0f), (float)w);
    int y0 = (int)fminf(fmaxf(fy, -1.0f), (float)h);
    int xa = min(max(x0, 0), w - 1), xb = min(max(x0 + 1, 0), w - 1);
    int ya = min(max(y0, 0), h - 1), yb = min(max(y0 + 1, 0), h - 1);
    v[0] = __ldg(img + (long)ya * w + xa);
    v[1] = __ldg(img + (long)ya * w + xb);
    v[2] = __ldg(img + (long)yb * w + xa);
    v[3] = __ldg(img + (long)yb * w + xb);
  } else {
    int x0 = (int)fx, y0 = (int)fy;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      int yi = y0 + (k >> 1), xi = x0 + (k & 1);
      v[k] = (xi >= 0 && xi < w && yi >= 0 && yi < h)
                 ? __ldg(img + (long)yi * w + xi)
                 : fill;
    }
  }
  float top = v[0] * (1.0f - tx) + v[1] * tx;
  float bot = v[2] * (1.0f - tx) + v[3] * tx;
  float r = top * (1.0f - ty) + bot * ty;
  if (hard && !(sx >= 0.0f && sx <= (float)(w - 1) && sy >= 0.0f &&
                sy <= (float)(h - 1)))
    r = fill;
  out[o] = r;
}

constexpr int kTileCells = 4;           // a tile is 4 x 4 grid cells
constexpr int kWindowBytes = 32768;     // the staged source window's budget
constexpr int kDewarpThreads = 256;
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

// full[y, x] = bilinear(hv at (x / res, y / res)), clamped to the last
// node (map_coordinates order=1, mode="nearest"), then one bilinear
// sample of the u8 page there. fill_taps == 0 ("hard"): `fill` outside
// [0, w-1] x [0, h-1] (ops/remap.py:58-59), taps clamped into the page,
// clipped and truncated to u8. fill_taps == 1: the coordinate clamped
// into [-2, w+1] x [-2, h+1], each tap outside the page reads `fill`
// (an integer in [0, 255]), rounded half to even and clipped to u8.
// Dynamic shared memory: the window (kWindowBytes), then the row table
// (4 res x 5 float2) and the column table (4 res float4).
__global__ void __launch_bounds__(kDewarpThreads)
    dewarp_u8_kernel(const uint8_t* __restrict__ page, int h, int w,
                     const float* __restrict__ hv, int gh, int gw, int res,
                     float fill, int fill_taps, int aligned,
                     uint8_t* __restrict__ out,
                     int* __restrict__ staged_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float2 nodes[kTileCells + 1][kTileCells + 1];
  __shared__ int win[5];                    // x0, y0, x1, y1, staged
  constexpr int kNodes = kTileCells + 1;
  uint8_t* window = smem;
  const int span = kTileCells * res;
  // per output row: hv at each node column, lerped along y
  float2* rows = (float2*)(smem + kWindowBytes);
  // per output column: (tx, 1 - tx, node column as int bits, unused)
  float4* cols = (float4*)(rows + span * kNodes);

  const int tid = threadIdx.x;
  const int cx0 = blockIdx.x * kTileCells, cy0 = blockIdx.y * kTileCells;
  const int ox0 = cx0 * res, oy0 = cy0 * res;
  const int ow = gw * res;
  const int tw = min(span, ow - ox0), th = min(span, gh * res - oy0);

  // the tile's nodes (clamped to the last node) and their bounding box
  if (tid < 32) {
    float x = __int_as_float(0x7fc00000), y = x;   // NaN: ignored below
    if (tid < (kTileCells + 1) * (kTileCells + 1)) {
      int ly = tid / (kTileCells + 1), lx = tid % (kTileCells + 1);
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
        rx.x &= ~15;                        // -1 becomes -16
        rx.y = min((rx.y + 16) & ~15, fill_taps ? w + 16 : w) - 1;
      }
      int bytes = (rx.y >= rx.x && ry.y >= ry.x)
                      ? (rx.y - rx.x + 1) * (ry.y - ry.x + 1)
                      : 0;
      win[0] = rx.x;
      win[1] = ry.x;
      win[2] = rx.y;
      win[3] = ry.y;
      win[4] = bytes <= kWindowBytes;
      if (staged_tiles && win[4]) atomicAdd(staged_tiles, 1);
    }
  }
  __syncthreads();
  const int wx0 = win[0], wy0 = win[1], wx1 = win[2], wy1 = win[3];
  const bool staged = win[4];
  const int ww = wx1 - wx0 + 1;

  // fill_taps: the window's cells off the page hold `fill`; with
  // aligned rows (w % 16 == 0) a chunk is wholly on or off the page
  const uint8_t fill_u8 = (uint8_t)fill;
  if (staged && ww > 0 && wy1 >= wy0) {
    int nrows = wy1 - wy0 + 1;
    if (aligned) {
      int chunks = ww >> 4;
      uint4 fill16;
      fill16.x = fill16.y = fill16.z = fill16.w = 0x01010101u * fill_u8;
      for (int i = tid; i < chunks * nrows; i += kDewarpThreads) {
        int r = i / chunks, c = (i - r * chunks) << 4;
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
                        : fill_u8;
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
    cols[i] = make_float4(g - f, 1.0f - (g - f), __int_as_float((int)f - cx0),
                          0.0f);
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
  // one output pixel of tile row `row`, column c, as its u8 value
  auto pixel = [&](const float2* row, int c) -> uint32_t {
    float4 col = cols[c];
    int lx = __float_as_int(col.z);
    float2 r0 = row[lx], r1 = row[lx + 1];
    float sx = r0.x * col.y + r1.x * col.x;
    float sy = r0.y * col.y + r1.y * col.x;
    if (fill_taps) {
      sx = fminf(fmaxf(sx, -2.0f), (float)(w + 1));
      sy = fminf(fmaxf(sy, -2.0f), (float)(h + 1));
      float px = floorf(sx), py = floorf(sy);
      float vx = sx - px, vy = sy - py;
      int xa = min(max((int)px, -1), w), xb = min(max((int)px + 1, -1), w);
      int ya = min(max((int)py, -1), h), yb = min(max((int)py + 1, -1), h);
      float v00, v01, v10, v11;
      if (staged && xa >= wx0 && xb <= wx1 && ya >= wy0 && yb <= wy1) {
        const uint8_t* t0 = window + (ya - wy0) * ww - wx0;
        const uint8_t* t1 = window + (yb - wy0) * ww - wx0;
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
      float val = top * (1.0f - vy) + bot * vy;
      return (uint32_t)fminf(fmaxf(rintf(val), 0.0f), 255.0f);
    }
    float val = fill;
    if (sx >= 0.0f && sx <= wmax && sy >= 0.0f && sy <= hmax) {
      float px = floorf(sx), py = floorf(sy);
      float vx = sx - px, vy = sy - py;
      int xa = (int)px, ya = (int)py;
      int xb = min(xa + 1, w - 1), yb = min(ya + 1, h - 1);
      float v00, v01, v10, v11;
      if (staged && xa >= wx0 && xb <= wx1 && ya >= wy0 && yb <= wy1) {
        const uint8_t* t0 = window + (ya - wy0) * ww - wx0;
        const uint8_t* t1 = window + (yb - wy0) * ww - wx0;
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
    return (uint32_t)fminf(fmaxf(val, 0.0f), 255.0f);   // truncates
  };

  // quads of 4 output pixels, walked in row order without a division
  // per quad: thread t starts at quad t and steps kDewarpThreads quads
  const int quads = (tw + 3) >> 2;
  const int step_r = kDewarpThreads / quads;
  const int step_c = kDewarpThreads - step_r * quads;
  const bool wide = (ow & 3) == 0;
  int r = tid / quads, q = tid - r * quads;
  while (r < th) {
    const float2* row = rows + r * kNodes;
    int c4 = q << 2;
    uint8_t* dst = out + (size_t)(oy0 + r) * ow + ox0 + c4;
    if (c4 + 4 <= tw) {                   // four independent pixels
      uint32_t v0 = pixel(row, c4), v1 = pixel(row, c4 + 1);
      uint32_t v2 = pixel(row, c4 + 2), v3 = pixel(row, c4 + 3);
      if (wide) {
        *reinterpret_cast<uint32_t*>(dst) =
            v0 | (v1 << 8) | (v2 << 16) | (v3 << 24);
      } else {
        dst[0] = (uint8_t)v0;
        dst[1] = (uint8_t)v1;
        dst[2] = (uint8_t)v2;
        dst[3] = (uint8_t)v3;
      }
    } else {                              // the ragged end of a row
      for (int k = 0; c4 + k < tw; ++k) dst[k] = (uint8_t)pixel(row, c4 + k);
    }
    q += step_c;
    r += step_r;
    if (q >= quads) {
      q -= quads;
      ++r;
    }
  }
}

}  // namespace

// b images (b, h, w) through their maps (b, oh, ow): mx, my and stride
// as remap_f32_kernel takes them; one launch for the whole batch.
extern "C" int origami_remap_f32(const float* img, int b, int h, int w,
                                 const float* mx, const float* my,
                                 int stride, int oh, int ow, float fill,
                                 int hard, float* out, void* stream) {
  if (b > 65535) return (int)cudaErrorInvalidValue;
  dim3 block(32, 8);
  dim3 grid((ow + 31) / 32, (oh + 7) / 8, b);
  remap_f32_kernel<false><<<grid, block, 0, (cudaStream_t)stream>>>(
      img, h, w, mx, my, stride, Affine{}, oh, ow, fill, hard, out);
  return (int)cudaGetLastError();
}

// One image (h, w) through the inverse-map affine m (six float32
// coefficients, row-major (2, 3)) to (oh, ow), at the hard border.
extern "C" int origami_remap_affine_f32(const float* img, int h, int w,
                                        const float* m, int oh, int ow,
                                        float fill, float* out,
                                        void* stream) {
  Affine a;
  for (int k = 0; k < 6; ++k) a.m[k] = m[k];
  dim3 block(32, 8);
  dim3 grid((ow + 31) / 32, (oh + 7) / 8, 1);
  remap_f32_kernel<true><<<grid, block, 0, (cudaStream_t)stream>>>(
      img, h, w, nullptr, nullptr, 1, a, oh, ow, fill, 1, out);
  return (int)cudaGetLastError();
}

// staged_tiles (may be null): the kernel adds the number of tiles that
// read their taps from a staged window.
extern "C" int origami_dewarp_u8(const uint8_t* page, int h, int w,
                                 const float* hv, int gh, int gw, int res,
                                 float fill, int fill_taps, uint8_t* out,
                                 int* staged_tiles, void* stream) {
  size_t bytes = kWindowBytes + (size_t)kTileCells * res *
                                    ((kTileCells + 1) * sizeof(float2) +
                                     sizeof(float4));
  if (bytes > 48 * 1024) {
    cudaError_t rc = cudaFuncSetAttribute(
        dewarp_u8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (rc != cudaSuccess) return (int)rc;
  }
  int aligned = ((uintptr_t)page % 16 == 0) && (w % 16 == 0);
  dim3 grid((gw + kTileCells - 1) / kTileCells,
            (gh + kTileCells - 1) / kTileCells);
  dewarp_u8_kernel<<<grid, kDewarpThreads, bytes, (cudaStream_t)stream>>>(
      page, h, w, hv, gh, gw, res, fill, fill_taps, aligned, out,
      staged_tiles);
  return (int)cudaGetLastError();
}
