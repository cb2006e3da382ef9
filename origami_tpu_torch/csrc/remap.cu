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
// has no general gather; here the page's bytes are reached through the
// read-only (texture) cache with `__ldg`, which serves the 2x2 taps of
// neighbouring threads from the same lines, so no window, band plan or
// DMA is needed. One thread per output pixel, 32x8 blocks: a warp
// covers 32 neighbouring output columns, so the stores coalesce and the
// taps of a warp fall on one or two source rows of a smooth map.
//
// dewarp_u8 upsamples the coarse grid inside the kernel (index-aligned,
// nearest beyond the last node, as core/dewarp.py:436-456), so the
// dense (H', W', 2) map of the JAX dense route never exists in memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// remap_pallas semantics: coordinates clamped into a fill margin
// ([-2, w+1] x [-2, h+1]); taps outside the image read `fill`.
__global__ void remap_f32_kernel(const float* __restrict__ img, int h, int w,
                                 const float* __restrict__ map, int oh,
                                 int ow, float fill,
                                 float* __restrict__ out) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= ow || y >= oh) return;
  long o = (long)y * ow + x;
  float sx = fminf(fmaxf(__ldg(map + 2 * o), -2.0f), (float)w + 1.0f);
  float sy = fminf(fmaxf(__ldg(map + 2 * o + 1), -2.0f), (float)h + 1.0f);
  float fx = floorf(sx), fy = floorf(sy);
  float tx = sx - fx, ty = sy - fy;
  int x0 = (int)fx, y0 = (int)fy;
  float v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int yi = y0 + (k >> 1), xi = x0 + (k & 1);
    v[k] = (xi >= 0 && xi < w && yi >= 0 && yi < h)
               ? __ldg(img + (long)yi * w + xi)
               : fill;
  }
  float top = v[0] * (1.0f - tx) + v[1] * tx;
  float bot = v[2] * (1.0f - tx) + v[3] * tx;
  out[o] = top * (1.0f - ty) + bot * ty;
}

// full[y, x] = bilinear(hv at (x / res, y / res)), clamped to the last
// node (map_coordinates order=1, mode="nearest"), then one bilinear
// sample of the u8 page there, hard-edged to `fill` outside
// [0, w-1] x [0, h-1] (ops/remap.py:58-59), rounded and clipped to u8.
__global__ void dewarp_u8_kernel(const uint8_t* __restrict__ page, int h,
                                 int w, const float* __restrict__ hv, int gh,
                                 int gw, int res, float fill,
                                 uint8_t* __restrict__ out) {
  int ow = gw * res, oh = gh * res;
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= ow || y >= oh) return;
  float gy = (float)y / (float)res, gx = (float)x / (float)res;
  float fy = floorf(gy), fx = floorf(gx);
  float ty = gy - fy, tx = gx - fx;
  int y0 = min((int)fy, gh - 1), y1 = min((int)fy + 1, gh - 1);
  int x0 = min((int)fx, gw - 1), x1 = min((int)fx + 1, gw - 1);
  float m[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    float r0 = __ldg(hv + 2 * (y0 * gw + x0) + c) * (1.0f - ty) +
               __ldg(hv + 2 * (y1 * gw + x0) + c) * ty;
    float r1 = __ldg(hv + 2 * (y0 * gw + x1) + c) * (1.0f - ty) +
               __ldg(hv + 2 * (y1 * gw + x1) + c) * ty;
    m[c] = r0 * (1.0f - tx) + r1 * tx;
  }
  float sx = m[0], sy = m[1];
  float val = fill;
  if (sx >= 0.0f && sx <= (float)(w - 1) && sy >= 0.0f &&
      sy <= (float)(h - 1)) {
    float px = floorf(sx), py = floorf(sy);
    float ux = sx - px, uy = sy - py;
    int xa = (int)px, ya = (int)py;
    int xb = min(xa + 1, w - 1), yb = min(ya + 1, h - 1);
    float v00 = __ldg(page + (long)ya * w + xa);
    float v01 = __ldg(page + (long)ya * w + xb);
    float v10 = __ldg(page + (long)yb * w + xa);
    float v11 = __ldg(page + (long)yb * w + xb);
    float top = v00 * (1.0f - ux) + v01 * ux;
    float bot = v10 * (1.0f - ux) + v11 * ux;
    val = top * (1.0f - uy) + bot * uy;
  }
  val = fminf(fmaxf(rintf(val), 0.0f), 255.0f);
  out[(long)y * ow + x] = (uint8_t)val;
}

}  // namespace

extern "C" int origami_remap_f32(const float* img, int h, int w,
                                 const float* map, int oh, int ow, float fill,
                                 float* out, void* stream) {
  dim3 block(32, 8);
  dim3 grid((ow + 31) / 32, (oh + 7) / 8);
  remap_f32_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      img, h, w, map, oh, ow, fill, out);
  return (int)cudaGetLastError();
}

extern "C" int origami_dewarp_u8(const uint8_t* page, int h, int w,
                                 const float* hv, int gh, int gw, int res,
                                 float fill, uint8_t* out, void* stream) {
  dim3 block(32, 8);
  dim3 grid((gw * res + 31) / 32, (gh * res + 7) / 8);
  dewarp_u8_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      page, h, w, hv, gh, gw, res, fill, out);
  return (int)cudaGetLastError();
}
