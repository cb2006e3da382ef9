// Batched line-strip extraction for Hopper (sm_90a).
//
// Replaces the Pallas kernel `extract_line_strips_pallas` ->
// `_strips_call` (body `_strips_kernel`) of
// origami_tpu/ops/pallas/remap.py, at the two sites where the JAX OCR
// path cuts strips (batch/core/lines.py:281-296):
//
//   mode (a) strips_dewarped: frames map strip pixels into the DEWARPED
//     page (what `extract_strips_banded` computes, ops/remap.py:277-385):
//     direct bilinear sample, taps outside the page blend with `fill`;
//     `fill` where the frame's point lies outside (-0.5, w-0.5) x
//     (-0.5, h-0.5) or the column is at or past max(width, 2);
//     a0 >= 1e-6; round half to even, then clip to u8.
//   mode (b) strips_through_grid: frames map into dewarped coordinates
//     that are pushed through the inverse grid on an 8-px lattice and
//     lerped, rows first, columns second (`extract_dewarped_strips`,
//     ops/remap.py:111-186); `fill` at or past the column `width`; the
//     warped page is sampled hard-edged; clip, then TRUNCATE to u8.
//
// What bounds it on this card: bytes. Each output byte is written once
// and most of a page's strip bytes are padding columns and padding rows
// that end up `fill`; the page bytes under the strips are read about once
// (a strip reads its own band of the page). The arithmetic is a few dozen
// FLOPs a pixel. The Pallas kernel DMA'd a window per strip into VMEM and
// ran a two-shear decomposition because Mosaic lacks a 2-D gather; on
// Hopper the page is sampled directly through the read-only cache
// (`__ldg`), so there is no window, no shear split and no |e| < 1e-3
// rejection.
//
// The design, against those bytes and the launch cost:
//   * one launch per page and mode: every strip of every (width bucket,
//     profile) group of a page is one z-index of the grid; a per-strip
//     descriptor (group, output offset, wmax, real) places its rows in
//     one u8 buffer (each group a 16-byte aligned (nb, out_h, wmax)
//     block). Column tiles are sized for the page's widest group; a
//     block whose tile lies past its strip's wmax returns at once. The
//     group-level entry points are the same kernels with no descriptor
//     (strip n at n * out_h * out_w, every row real);
//   * a block covers a 48-row x 128-column tile of one strip with 128
//     threads; a thread computes 16 horizontally adjacent pixels of a
//     strip row (three rows, 16 apart) and writes each 16 with one
//     16-byte store (byte stores where the row is not 16-byte aligned or
//     the strip ends inside the 16, e.g. out_w = 197);
//   * a 16-pixel chunk that lies wholly at or past the strip's width
//     (mode (a): max(width, 2); mode (b): width) is `fill` with no taps
//     and no coordinates: padding rows (zero frames, width 0) and the
//     columns past a line cost only their store; the descriptor's `real`
//     flag is not read, since a padding row's zero frame and width give
//     the plain version's bytes by the same rule;
//   * mode (a), the bulk of a line: a chunk whose 16 points and taps lie
//     inside the page and before the width (its two ends bound it: the
//     coordinates are monotone along x) samples with no clamp, no fill
//     tap and no validity test; the other chunks take every tap from a
//     clamped address and select `fill` afterwards, with no branch
//     between a pixel's loads. The page is read through `__ldg`: staging
//     each tile's page band in shared memory measured slower;
//   * mode (b): the block first pushes its 7 x 17 lattice nodes through
//     the inverse grid into shared memory (the same `inverse_grid`
//     arithmetic, the same clamp of the second tap), then each thread
//     lerps each node column once per row and every pixel only lerps
//     along x and takes its four hard-edged taps;
//   * every pixel's coordinates are computed from (x, y) in the plain
//     version's order (a0*x + a1*y + a2, no incremental stepping) and the
//     sources build with -fmad=false, so every output byte equals the
//     plain version's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 16;                 // pixels a thread, one store
constexpr int TILE_W = 128;               // columns of a block's tile
constexpr int TILE_H = 48;                // rows of a block's tile
constexpr int THREADS_X = TILE_W / CHUNK;  // 8
constexpr int THREADS_Y = 16;              // rows a pass; 3 passes
constexpr int STEP = 8;                   // mode (b)'s lattice step
constexpr int LAT_H = TILE_H / STEP + 1;  // 7 node rows a tile
constexpr int LAT_W = TILE_W / STEP + 1;  // 17 node columns a tile

// Strip n's output: its offset in `out` and its row width. Without a
// descriptor (the group-level entries) strip n is the n-th dense
// (out_h, out_w) block. False when the rows would leave `out`.
__device__ __forceinline__ bool strip_of(const int* __restrict__ desc,
                                         int n, int out_h, int out_w,
                                         long out_size, long* off,
                                         int* sw) {
  if (desc != nullptr) {
    *off = (long)__ldg(desc + 4 * n + 1);
    *sw = __ldg(desc + 4 * n + 2);
  } else {
    *off = (long)n * out_h * out_w;
    *sw = out_w;
  }
  return *off >= 0 && *sw >= 0 && *off + (long)out_h * *sw <= out_size;
}

// the 16 bytes of `word` at dst[0, count): one 16-byte store where it can
__device__ __forceinline__ void store_chunk(uint8_t* __restrict__ dst,
                                            const uint32_t (&word)[4],
                                            int count) {
  if (count == CHUNK && ((uintptr_t)dst & 15) == 0) {
    *reinterpret_cast<uint4*>(dst) =
        make_uint4(word[0], word[1], word[2], word[3]);
  } else {
#pragma unroll
    for (int k = 0; k < CHUNK; ++k)
      if (k < count) dst[k] = (uint8_t)(word[k >> 2] >> (8 * (k & 3)));
  }
}

__device__ __forceinline__ void fill_chunk(uint32_t (&word)[4],
                                           uint8_t v) {
  uint32_t q = 0x01010101u * v;
  word[0] = word[1] = word[2] = word[3] = q;
}

// img[y, x], or `fill` outside the (h, w) image; the byte is read from
// the clamped address either way, so a pixel's four taps are loaded
// without a branch between them (the wrappers keep h * w < 2^31)
__device__ __forceinline__ float tap(const uint8_t* __restrict__ img, int h,
                                     int w, int y, int x, float fill) {
  const float v = (float)__ldg(img + min(max(y, 0), h - 1) * w +
                               min(max(x, 0), w - 1));
  return ((unsigned)x < (unsigned)w && (unsigned)y < (unsigned)h) ? v : fill;
}

// clip(round half to even(v), 0, 255): the float-to-integer conversion
// rounds to nearest even and saturates at 0; then the top clip
__device__ __forceinline__ uint32_t to_u8_round(float v) {
  return min(__float2uint_rn(v), 255u);
}

// clip(v, 0, 255), then truncated: the conversion rounds toward zero
// and saturates at 0
__device__ __forceinline__ uint32_t to_u8_trunc(float v) {
  return min(__float2uint_rz(v), 255u);
}

__global__ void __launch_bounds__(THREADS_X * THREADS_Y)
    strips_dewarped_kernel(const uint8_t* __restrict__ dew, int h, int w,
                           const float* __restrict__ frames,
                           const int* __restrict__ widths,
                           const int* __restrict__ desc, int out_h,
                           int out_w, float fill, uint8_t* __restrict__ out,
                           long out_size) {
  const int n = blockIdx.z;
  long off;
  int sw;
  if (!strip_of(desc, n, out_h, out_w, out_size, &off, &sw)) return;
  const int x0 = blockIdx.x * TILE_W + threadIdx.x * CHUNK;
  const int count = min(CHUNK, sw - x0);
  if (count <= 0) return;  // the tile (or this chunk) is past the strip
  const float* f = frames + 6 * n;
  const float a0 = fmaxf(__ldg(f + 0), 1e-6f), a1 = __ldg(f + 1),
              a2 = __ldg(f + 2);
  const float b0 = __ldg(f + 3), b1 = __ldg(f + 4), b2 = __ldg(f + 5);
  const float wf = fmaxf((float)__ldg(widths + n), 2.0f);
  const uint8_t fill8 = (uint8_t)to_u8_round(fill);
  const float xlo = -0.5f, xhi = (float)w - 0.5f, yhi = (float)h - 0.5f;
  const int y_end = min(out_h, (int)(blockIdx.y + 1) * TILE_H);
  for (int y = blockIdx.y * TILE_H + threadIdx.y; y < y_end;
       y += THREADS_Y) {
    uint32_t word[4];
    if ((float)x0 >= wf) {
      fill_chunk(word, fill8);  // past the strip's width: no taps
    } else {
      const float yf = (float)y;
      const float a1y = a1 * yf, b1y = b1 * yf;
#pragma unroll
      for (int q = 0; q < 4; ++q) word[q] = 0;
      // px and py are monotone along x (each rounding step is), so the
      // chunk's two ends bound its 16 points: where every point and its
      // taps lie inside the page and before the width, the chunk needs
      // no clamp, no fill tap and no validity test
      const float xa = (float)x0, xb = (float)(x0 + CHUNK - 1);
      const float pxa = a0 * xa + a1y + a2, pxb = a0 * xb + a1y + a2;
      const float pya = b0 * xa + b1y + b2, pyb = b0 * xb + b1y + b2;
      const float wi = (float)(w - 1), hi = (float)(h - 1);
      if (xb < wf && pxa >= 0.0f && pxb < wi && pya >= 0.0f &&
          pyb >= 0.0f && pya < hi && pyb < hi) {
#pragma unroll
        for (int k = 0; k < CHUNK; ++k) {
          const float xf = (float)(x0 + k);
          const float px = a0 * xf + a1y + a2;
          const float py = b0 * xf + b1y + b2;
          const float fx = floorf(px), fy = floorf(py);
          const float tx = px - fx, ty = py - fy;
          const uint8_t* r0 = dew + (int)fy * w + (int)fx;
          const float top = (float)__ldg(r0) * (1.0f - tx) +
                            (float)__ldg(r0 + 1) * tx;
          const float bot = (float)__ldg(r0 + w) * (1.0f - tx) +
                            (float)__ldg(r0 + w + 1) * tx;
          word[k >> 2] |= to_u8_round(top * (1.0f - ty) + bot * ty)
                          << (8 * (k & 3));
        }
        store_chunk(out + off + (long)y * sw + x0, word, count);
        continue;
      }
#pragma unroll
      for (int k = 0; k < CHUNK; ++k) {
        const float xf = (float)(x0 + k);
        const float px = a0 * xf + a1y + a2;
        const float py = b0 * xf + b1y + b2;
        // the sample is taken for every pixel of the chunk and replaced
        // by `fill` where the point is off the page or past the width:
        // no branch, so the chunk's 64 loads are in flight together. The
        // clamp changes no valid point and keeps the int conversion in
        // range for the others
        const float pxc = fminf(fmaxf(px, -2.0f), xhi + 2.0f);
        const float pyc = fminf(fmaxf(py, -2.0f), yhi + 2.0f);
        const float fx = floorf(pxc), fy = floorf(pyc);
        const float tx = pxc - fx, ty = pyc - fy;
        const int xi = (int)fx, yi = (int)fy;
        const float top = tap(dew, h, w, yi, xi, fill) * (1.0f - tx) +
                          tap(dew, h, w, yi, xi + 1, fill) * tx;
        const float bot = tap(dew, h, w, yi + 1, xi, fill) * (1.0f - tx) +
                          tap(dew, h, w, yi + 1, xi + 1, fill) * tx;
        const bool valid = px > xlo && px < xhi && py > xlo && py < yhi &&
                           xf < wf;
        word[k >> 2] |= to_u8_round(valid ? top * (1.0f - ty) + bot * ty
                                          : fill)
                        << (8 * (k & 3));
      }
    }
    store_chunk(out + off + (long)y * sw + x0, word, count);
  }
}

// one inverse-grid evaluation at dewarped (dx, dy): bilinear in hv,
// clamped to its extent (Grid.inverse_points' semantics)
__device__ __forceinline__ void inverse_grid(const float* __restrict__ hv,
                                             int gh, int gw, float res,
                                             float dx, float dy, float* cx,
                                             float* cy) {
  float gx = fminf(fmaxf(dx / res, 0.0f), (float)(gw - 1) - 1e-6f);
  float gy = fminf(fmaxf(dy / res, 0.0f), (float)(gh - 1) - 1e-6f);
  float fx = floorf(gx), fy = floorf(gy);
  float tx = gx - fx, ty = gy - fy;
  // in float32 the clamp's upper end can round up to the last node
  // (tx = 0 there): clamp the second tap's index like a JAX gather does
  int x0 = (int)fx, y0 = (int)fy;
  int x1 = min(x0 + 1, gw - 1), y1 = min(y0 + 1, gh - 1);
  float w00 = (1.0f - tx) * (1.0f - ty), w01 = tx * (1.0f - ty);
  float w10 = (1.0f - tx) * ty, w11 = tx * ty;
  const float* g00 = hv + 2 * (y0 * gw + x0);
  const float* g01 = hv + 2 * (y0 * gw + x1);
  const float* g10 = hv + 2 * (y1 * gw + x0);
  const float* g11 = hv + 2 * (y1 * gw + x1);
  *cx = __ldg(g00) * w00 + __ldg(g01) * w01 + __ldg(g10) * w10 +
        __ldg(g11) * w11;
  *cy = __ldg(g00 + 1) * w00 + __ldg(g01 + 1) * w01 +
        __ldg(g10 + 1) * w10 + __ldg(g11 + 1) * w11;
}

__global__ void __launch_bounds__(THREADS_X * THREADS_Y)
    strips_through_grid_kernel(const uint8_t* __restrict__ page, int h,
                               int w, const float* __restrict__ hv, int gh,
                               int gw, float res,
                               const float* __restrict__ frames,
                               const int* __restrict__ widths,
                               const int* __restrict__ desc, int out_h,
                               int out_w, float fill,
                               uint8_t* __restrict__ out, long out_size) {
  __shared__ float lat_x[LAT_H][LAT_W];
  __shared__ float lat_y[LAT_H][LAT_W];
  const int n = blockIdx.z;
  long off;
  int sw;
  // every return before the barrier below is uniform over the block
  if (!strip_of(desc, n, out_h, out_w, out_size, &off, &sw)) return;
  const int tx0 = blockIdx.x * TILE_W, ty0 = blockIdx.y * TILE_H;
  if (tx0 >= sw) return;
  const float width = (float)__ldg(widths + n);
  const uint8_t fill8 = (uint8_t)to_u8_trunc(fill);
  const int tid = threadIdx.y * THREADS_X + threadIdx.x;
  const bool all_fill = (float)tx0 >= width;
  if (!all_fill) {
    // the tile's lattice nodes, each once: node (i, j) sits at strip
    // pixel (8 j, 8 i)
    const float* f = frames + 6 * n;
    const float f00 = __ldg(f + 0), f01 = __ldg(f + 1), f02 = __ldg(f + 2);
    const float f10 = __ldg(f + 3), f11 = __ldg(f + 4), f12 = __ldg(f + 5);
    for (int t = tid; t < LAT_H * LAT_W; t += THREADS_X * THREADS_Y) {
      const int li = t / LAT_W, lj = t % LAT_W;
      const float xs = (float)(tx0 + lj * STEP);
      const float ys = (float)(ty0 + li * STEP);
      const float dx = f00 * xs + f01 * ys + f02;
      const float dy = f10 * xs + f11 * ys + f12;
      inverse_grid(hv, gh, gw, res, dx, dy, &lat_x[li][lj], &lat_y[li][lj]);
    }
    __syncthreads();
  }
  const int x0 = tx0 + threadIdx.x * CHUNK;
  const int count = min(CHUNK, sw - x0);
  if (count <= 0) return;
  const int lj0 = threadIdx.x * (CHUNK / STEP);  // the chunk's first cell
  const float wlast = (float)(w - 1), hlast = (float)(h - 1);
  const int y_end = min(out_h, ty0 + TILE_H);
  for (int y = ty0 + threadIdx.y; y < y_end; y += THREADS_Y) {
    uint32_t word[4];
    if (all_fill || (float)x0 >= width) {
      fill_chunk(word, fill8);  // past the strip's width: no lattice
    } else {
      // rows first: each of the chunk's 3 node columns lerped along y
      const int li = (y - ty0) / STEP;
      const float wy = (float)(y % STEP) / (float)STEP;
      float rx[CHUNK / STEP + 1], ry[CHUNK / STEP + 1];
#pragma unroll
      for (int c = 0; c <= CHUNK / STEP; ++c) {
        rx[c] = lat_x[li][lj0 + c] * (1.0f - wy) + lat_x[li + 1][lj0 + c] * wy;
        ry[c] = lat_y[li][lj0 + c] * (1.0f - wy) + lat_y[li + 1][lj0 + c] * wy;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) word[q] = 0;
#pragma unroll
      for (int k = 0; k < CHUNK; ++k) {
        const int c = k / STEP;
        const float wx = (float)(k % STEP) / (float)STEP;
        // then columns
        const float sx = rx[c] * (1.0f - wx) + rx[c + 1] * wx;
        const float sy = ry[c] * (1.0f - wx) + ry[c + 1] * wx;
        // hard edge: inside [0, w-1] x [0, h-1] the clamps below change
        // nothing; outside, the taps read a clamped pixel and `fill`
        // replaces the sample (no branch, as in mode (a))
        const float px = floorf(sx), py = floorf(sy);
        const float ux = sx - px, uy = sy - py;
        const int xa = (int)fminf(fmaxf(px, 0.0f), wlast);
        const int ya = (int)fminf(fmaxf(py, 0.0f), hlast);
        const int xb = min(xa + 1, w - 1), yb = min(ya + 1, h - 1);
        const uint8_t* ra = page + ya * w;
        const uint8_t* rb = page + yb * w;
        const float top = (float)__ldg(ra + xa) * (1.0f - ux) +
                          (float)__ldg(ra + xb) * ux;
        const float bot = (float)__ldg(rb + xa) * (1.0f - ux) +
                          (float)__ldg(rb + xb) * ux;
        const bool inside = (float)(x0 + k) < width && sx >= 0.0f &&
                            sx <= wlast && sy >= 0.0f && sy <= hlast;
        word[k >> 2] |= to_u8_trunc(inside ? top * (1.0f - uy) + bot * uy
                                          : fill)
                        << (8 * (k & 3));
      }
    }
    store_chunk(out + off + (long)y * sw + x0, word, count);
  }
}

dim3 grid_of(int n, int out_h, int out_w) {
  return dim3((out_w + TILE_W - 1) / TILE_W, (out_h + TILE_H - 1) / TILE_H,
              n);
}

}  // namespace

// `desc`: null for one dense group of n strips (out_w their width), or
// n rows (group, offset, wmax, real) placing each strip in `out`, out_w
// then the widest wmax. out_size: the bytes of `out`.
extern "C" int origami_strips_dewarped(const uint8_t* dew, int h, int w,
                                       const float* frames, const int* widths,
                                       const int* desc, int n, int out_h,
                                       int out_w, float fill, uint8_t* out,
                                       long out_size, void* stream) {
  dim3 block(THREADS_X, THREADS_Y);
  strips_dewarped_kernel<<<grid_of(n, out_h, out_w), block, 0,
                           (cudaStream_t)stream>>>(
      dew, h, w, frames, widths, desc, out_h, out_w, fill, out, out_size);
  return (int)cudaGetLastError();
}

extern "C" int origami_strips_through_grid(
    const uint8_t* page, int h, int w, const float* hv, int gh, int gw,
    float res, const float* frames, const int* widths, const int* desc,
    int n, int out_h, int out_w, float fill, uint8_t* out, long out_size,
    void* stream) {
  dim3 block(THREADS_X, THREADS_Y);
  strips_through_grid_kernel<<<grid_of(n, out_h, out_w), block, 0,
                               (cudaStream_t)stream>>>(
      page, h, w, hv, gh, gw, res, frames, widths, desc, out_h, out_w, fill,
      out, out_size);
  return (int)cudaGetLastError();
}
