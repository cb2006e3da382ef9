// take_along_axis of a float32 matrix by int32 indices, for Hopper (sm_90a).
//
// Replaces the Pallas gather probe `run_case.kernel` of
// scripts/pallas_gather_repro.py, whose body is `_lane_gather` (axis 1)
// or `_sublane_gather` (axis 0) of origami_tpu/ops/pallas/remap.py in
// their "tiled" mode. The dewarp grid build's `jnp.take_along_axis`
// (origami_tpu/core/dewarp.py:131) runs inside the V scan kernel of
// grid.cu, so no stage launches this one.
//
//   lane    (axis 1): out[i, j] = src[i, clamp(idx[i, j], 0, w - 1)]
//                     src (r, w), idx (r, c) -> out (r, c)
//   sublane (axis 0): out[i, j] = src[clamp(idx[i, j], 0, h - 1), j]
//                     src (h, c), idx (r, c) -> out (r, c)
//
// What bounds it on this card: memory, and at the shapes the port runs
// (a few thousand elements) the launch itself. Per output element the
// work is one clamp, one index read, one source read and one store; the
// least traffic is each index and output element once plus the source
// elements the indices name. The Pallas kernel's loop over 128-wide (or
// 8-high) source tiles with a selection mask per tile exists only
// because Mosaic's dynamic_gather wants same-shape single-vreg operands;
// a CUDA thread can read any address. So this is one thread per output
// element, the index and the output coalesced along a row, the source
// read through the read-only cache (`__ldg`), which serves neighbouring
// threads' taps of a smooth index pattern from the same lines.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void lane_gather_kernel(const float* __restrict__ src, int w,
                                   const int32_t* __restrict__ idx, int r,
                                   int c, float* __restrict__ out) {
  long o = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= (long)r * c) return;
  long i = o / c;
  int k = __ldg(idx + o);
  k = k < 0 ? 0 : (k > w - 1 ? w - 1 : k);
  out[o] = __ldg(src + i * w + k);
}

__global__ void sublane_gather_kernel(const float* __restrict__ src, int h,
                                      const int32_t* __restrict__ idx, int r,
                                      int c, float* __restrict__ out) {
  long o = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= (long)r * c) return;
  long j = o % c;
  int k = __ldg(idx + o);
  k = k < 0 ? 0 : (k > h - 1 ? h - 1 : k);
  out[o] = __ldg(src + (long)k * c + j);
}

}  // namespace

// axis 1: src (r, n), axis 0: src (n, c); idx and out (r, c), row-major.
extern "C" int origami_take_along_axis_f32(const float* src, int n,
                                           const int32_t* idx, int r, int c,
                                           int axis, float* out,
                                           void* stream) {
  long total = (long)r * c;
  int block = 256;
  int grid = (int)((total + block - 1) / block);
  if (axis == 1)
    lane_gather_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(src, n, idx,
                                                                 r, c, out);
  else
    sublane_gather_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        src, n, idx, r, c, out);
  return (int)cudaGetLastError();
}
