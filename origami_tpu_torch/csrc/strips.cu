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
//     (-0.5, h-0.5) or the column is past the strip's width; a0 >= 1e-6;
//     round, then clip to u8.
//   mode (b) strips_through_grid: frames map into dewarped coordinates
//     that are pushed through the inverse grid on an 8-px lattice and
//     lerped (`extract_dewarped_strips`, ops/remap.py:111-186); the
//     warped page is sampled hard-edged; clip, then TRUNCATE to u8.
//
// What bounds it on this card: memory. Each output byte is written once;
// the page bytes under the strips are read (about once: a strip reads
// its own band of the page). The arithmetic per pixel is a few dozen
// FLOPs. The Pallas kernel DMA'd a window per strip into VMEM and ran a
// two-shear decomposition because Mosaic lacks a 2-D gather; on Hopper a
// thread per output pixel samples the page directly through the
// read-only cache (`__ldg`), so there is no window, no shear split and
// no |e| < 1e-3 rejection. Grid (column tile, row band, strip), blocks
// of 32x8: a warp writes 32 neighbouring bytes of one strip row and
// reads a few neighbouring page rows. Mode (b)'s lattice nodes are
// recomputed per thread from the tiny (L1/L2-resident) grid.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float tap(const uint8_t* __restrict__ img, int h,
                                     int w, int y, int x, float fill) {
  return (x >= 0 && x < w && y >= 0 && y < h)
             ? (float)__ldg(img + (long)y * w + x)
             : fill;
}

__global__ void strips_dewarped_kernel(const uint8_t* __restrict__ dew,
                                       int h, int w,
                                       const float* __restrict__ frames,
                                       const int* __restrict__ widths,
                                       int out_h, int out_w, float fill,
                                       uint8_t* __restrict__ out) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y * blockDim.y + threadIdx.y;
  int n = blockIdx.z;
  if (x >= out_w || y >= out_h) return;
  const float* f = frames + 6 * n;
  float a0 = fmaxf(__ldg(f + 0), 1e-6f), a1 = __ldg(f + 1), a2 = __ldg(f + 2);
  float b0 = __ldg(f + 3), b1 = __ldg(f + 4), b2 = __ldg(f + 5);
  float wf = fmaxf((float)__ldg(widths + n), 2.0f);
  float xf = (float)x, yf = (float)y;
  float px = a0 * xf + a1 * yf + a2;
  float py = b0 * xf + b1 * yf + b2;
  float val = fill;
  if (px > -0.5f && px < (float)w - 0.5f && py > -0.5f &&
      py < (float)h - 0.5f && xf < wf) {
    float fx = floorf(px), fy = floorf(py);
    float tx = px - fx, ty = py - fy;
    int x0 = (int)fx, y0 = (int)fy;
    float top = tap(dew, h, w, y0, x0, fill) * (1.0f - tx) +
                tap(dew, h, w, y0, x0 + 1, fill) * tx;
    float bot = tap(dew, h, w, y0 + 1, x0, fill) * (1.0f - tx) +
                tap(dew, h, w, y0 + 1, x0 + 1, fill) * tx;
    val = top * (1.0f - ty) + bot * ty;
  }
  val = fminf(fmaxf(rintf(val), 0.0f), 255.0f);
  out[((long)n * out_h + y) * out_w + x] = (uint8_t)val;
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

__global__ void strips_through_grid_kernel(
    const uint8_t* __restrict__ page, int h, int w,
    const float* __restrict__ hv, int gh, int gw, float res,
    const float* __restrict__ frames, const int* __restrict__ widths,
    int out_h, int out_w, float fill, uint8_t* __restrict__ out) {
  const int step = 8;
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y * blockDim.y + threadIdx.y;
  int n = blockIdx.z;
  if (x >= out_w || y >= out_h) return;
  const float* f = frames + 6 * n;
  float f00 = __ldg(f + 0), f01 = __ldg(f + 1), f02 = __ldg(f + 2);
  float f10 = __ldg(f + 3), f11 = __ldg(f + 4), f12 = __ldg(f + 5);
  int i = y / step, j = x / step;
  float wy = (float)(y % step) / (float)step;
  float wx = (float)(x % step) / (float)step;
  // the four 8-px lattice nodes around (x, y), each pushed through the
  // inverse grid, then lerped rows first, columns second
  // (ops/remap.py:_upsample_lattice)
  float cx[2][2], cy[2][2];
#pragma unroll
  for (int di = 0; di < 2; ++di) {
#pragma unroll
    for (int dj = 0; dj < 2; ++dj) {
      float xs = (float)((j + dj) * step), ys = (float)((i + di) * step);
      float dx = f00 * xs + f01 * ys + f02;
      float dy = f10 * xs + f11 * ys + f12;
      inverse_grid(hv, gh, gw, res, dx, dy, &cx[di][dj], &cy[di][dj]);
    }
  }
  float rx0 = cx[0][0] * (1.0f - wy) + cx[1][0] * wy;
  float rx1 = cx[0][1] * (1.0f - wy) + cx[1][1] * wy;
  float ry0 = cy[0][0] * (1.0f - wy) + cy[1][0] * wy;
  float ry1 = cy[0][1] * (1.0f - wy) + cy[1][1] * wy;
  float sx = rx0 * (1.0f - wx) + rx1 * wx;
  float sy = ry0 * (1.0f - wx) + ry1 * wx;
  float val = fill;
  float width = (float)__ldg(widths + n);
  if ((float)x < width && sx >= 0.0f && sx <= (float)(w - 1) &&
      sy >= 0.0f && sy <= (float)(h - 1)) {
    float px = floorf(sx), py = floorf(sy);
    float ux = sx - px, uy = sy - py;
    int xa = (int)px, ya = (int)py;
    int xb = min(xa + 1, w - 1), yb = min(ya + 1, h - 1);
    float top = (float)__ldg(page + (long)ya * w + xa) * (1.0f - ux) +
                (float)__ldg(page + (long)ya * w + xb) * ux;
    float bot = (float)__ldg(page + (long)yb * w + xa) * (1.0f - ux) +
                (float)__ldg(page + (long)yb * w + xb) * ux;
    val = top * (1.0f - uy) + bot * uy;
  }
  val = fminf(fmaxf(val, 0.0f), 255.0f);
  out[((long)n * out_h + y) * out_w + x] = (uint8_t)val;  // truncates
}

}  // namespace

extern "C" int origami_strips_dewarped(const uint8_t* dew, int h, int w,
                                       const float* frames, const int* widths,
                                       int n, int out_h, int out_w,
                                       float fill, uint8_t* out,
                                       void* stream) {
  dim3 block(32, 8);
  dim3 grid((out_w + 31) / 32, (out_h + 7) / 8, n);
  strips_dewarped_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      dew, h, w, frames, widths, out_h, out_w, fill, out);
  return (int)cudaGetLastError();
}

extern "C" int origami_strips_through_grid(
    const uint8_t* page, int h, int w, const float* hv, int gh, int gw,
    float res, const float* frames, const int* widths, int n, int out_h,
    int out_w, float fill, uint8_t* out, void* stream) {
  dim3 block(32, 8);
  dim3 grid((out_w + 31) / 32, (out_h + 7) / 8, n);
  strips_through_grid_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      page, h, w, hv, gh, gw, res, frames, widths, out_h, out_w, fill, out);
  return (int)cudaGetLastError();
}
