// The dewarp grid build's two scans for Hopper (sm_90a), with the V
// scan's lane gather inside.
//
// Replaces `build_grid_device` of origami_tpu/core/dewarp.py:72-145: the
// H scan (`lax.scan(h_step)`, :89-93) and the V scan (`lax.scan(v_step)`,
// :102-143), whose choice of the nearest ray/row intersection takes
// `t_best` with `jnp.take_along_axis` (:131), the gather that the Pallas
// probe `run_case.kernel` of scripts/pallas_gather_repro.py:73 tests.
//
//   H scan: n_gy streamlines from (origin, origin + i * res), each
//           integrated n_gx - 1 steps: p += field_H(p) * res.
//   V scan: n_gx rays from the first H row; step k evaluates
//           d = field_V(p), intersects p + t * d * max_len with the 63
//           (n_gx - 1) segments of H row k (border segments extended by
//           1e5), takes the hit with the least t (argmin, then the
//           gather of t at it) or, with no finite hit, a field step.
//   field:  masked inverse-distance weights 1 / (d2 + 25) over the
//           padded samples; the weighted sums of cos and sin of the
//           sample angles, normalised; phi0 where no sample has weight.
//
// What bounds it on this card: neither bytes (16 KB of samples a field,
// 45 KB of grid) nor operations (~150 MFLOP a page over the 1024 padded
// samples, ~2 µs at the FP32 rate), but
// the chain of dependent steps: every step of a streamline or ray needs
// the one before, and each step is a block-wide reduction over the 1024
// samples. The eager PyTorch version spends about 60 launches a step on
// it and leaves the card idle between them. Here streamlines and rays,
// which are independent of each other, each get one block that walks all
// of its steps inside the kernel (a loop in the block in place of the
// scan); the block copies its field's samples into shared memory once,
// with cos and sin taken once per sample (the same bits as per step).
// A step's three sums are per-thread strided partials, a warp-shuffle
// tree and one combine in shared memory; a V step's intersection is one
// thread per segment and a (t, index) argmin with jnp.argmin's rules
// (lowest index on a tie, a NaN before every number, index 0 when every
// t is inf). Two launches a page: the H scan, then the V scan, which
// reduces row_dy over the H grid itself, so nothing waits on the host.
//
// The arithmetic of each element is the plain PyTorch version's
// (ops/grid.py: build_grid_plain), built with -fmad=false and the
// accurate cosf/sinf/sqrtf and division; the sums over the samples run
// in another order than PyTorch's reductions, so the two agree to float32
// rounding of the sums, not bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kAll = 0xffffffffu;

struct Samples {
  const float* x;
  const float* y;
  const float* c;
  const float* s;
  const float* m;
};

// The field's samples into shared memory: x, y, cos(phi), sin(phi),
// mask, n floats each.
__device__ __forceinline__ Samples stage_samples(
    float* smem, const float* __restrict__ xy, const float* __restrict__ phi,
    const float* __restrict__ mask, int n) {
  float *x = smem, *y = smem + n, *c = smem + 2 * n, *s = smem + 3 * n,
        *m = smem + 4 * n;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    x[i] = xy[2 * i];
    y[i] = xy[2 * i + 1];
    float p = phi[i];
    c[i] = cosf(p);
    s[i] = sinf(p);
    m[i] = mask[i];
  }
  return Samples{x, y, c, s, m};
}

// The unit direction of the field at (px, py), evaluated by the whole
// block; every thread gets it. `red` holds 3 * kWarps partial sums.
__device__ __forceinline__ float2 field_eval(float px, float py,
                                             const Samples& sm, int n,
                                             float c0, float s0, float* red,
                                             float2* dir) {
  float ws = 0.0f, cs = 0.0f, ss = 0.0f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    float dx = px - sm.x[i];
    float dy = py - sm.y[i];
    float d2 = dx * dx + dy * dy;
    float w = sm.m[i] / (d2 + 25.0f);
    ws += w;
    cs += w * sm.c[i];
    ss += w * sm.s[i];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    ws += __shfl_down_sync(kAll, ws, o);
    cs += __shfl_down_sync(kAll, cs, o);
    ss += __shfl_down_sync(kAll, ss, o);
  }
  int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red[warp] = ws;
    red[kWarps + warp] = cs;
    red[2 * kWarps + warp] = ss;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float wsum = 0.0f, cx = 0.0f, sx = 0.0f;
    for (int k = 0; k < kWarps; ++k) {
      wsum += red[k];
      cx += red[kWarps + k];
      sx += red[2 * kWarps + k];
    }
    bool have = wsum > 1e-12f;
    cx = have ? cx : c0;
    sx = have ? sx : s0;
    float nrm = sqrtf(cx * cx + sx * sx) + 1e-12f;
    *dir = make_float2(cx / nrm, sx / nrm);
  }
  __syncthreads();
  return *dir;
}

__global__ void grid_scan_h_kernel(const float* __restrict__ xy,
                                   const float* __restrict__ phi,
                                   const float* __restrict__ mask, int n,
                                   int n_gy, int n_gx, float res,
                                   float origin, float* __restrict__ grid_h) {
  extern __shared__ float smem[];
  __shared__ float red[3 * kWarps];
  __shared__ float2 dir;
  Samples sm = stage_samples(smem, xy, phi, mask, n);
  __syncthreads();
  int row = blockIdx.x;
  float px = origin, py = origin + (float)row * res;
  // phi0 = 0: cos 1, sin 0
  for (int k = 0; k < n_gx; ++k) {
    if (threadIdx.x == 0) {
      grid_h[2 * (row * n_gx + k)] = px;
      grid_h[2 * (row * n_gx + k) + 1] = py;
    }
    if (k + 1 == n_gx) break;
    float2 d = field_eval(px, py, sm, n, 1.0f, 0.0f, red, &dir);
    px = px + d.x * res;
    py = py + d.y * res;
  }
}

// jnp.argmin's order on (t, index): a NaN before every number, then the
// smaller t, then the lower index; `ib < 0` is "nothing yet".
__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  if (ib < 0) return ia >= 0;
  if (ia < 0) return false;
  bool an = isnan(a), bn = isnan(b);
  if (an != bn) return an;
  if (!an && a != b) return a < b;
  return ia < ib;
}

// max that lets a NaN through, as torch.max does
__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || b <= a) ? a : b;
}

__global__ void grid_scan_v_kernel(const float* __restrict__ grid_h,
                                   const float* __restrict__ xy,
                                   const float* __restrict__ phi,
                                   const float* __restrict__ mask, int n,
                                   int n_gy, int n_gx, float res,
                                   float* __restrict__ out,
                                   int* __restrict__ best_out) {
  extern __shared__ float smem[];
  __shared__ float red[3 * kWarps];
  __shared__ float2 dir;
  __shared__ float arg_t[kWarps];
  __shared__ int arg_i[kWarps];
  __shared__ float max_len_s;
  __shared__ float2 p_s;
  Samples sm = stage_samples(smem, xy, phi, mask, n);
  float* t_sel = smem + 5 * n;               // n_gx - 1 floats

  // max_len = max(row_dy) / cos(60 deg) + res over the whole H grid
  float mx = -INFINITY;
  int cnt = (n_gy - 1) * n_gx;
  for (int i = threadIdx.x; i < cnt; i += kThreads) {
    int r = i / n_gx, c = i - r * n_gx;
    mx = nan_max(mx, grid_h[2 * ((r + 1) * n_gx + c) + 1] -
                         grid_h[2 * (r * n_gx + c) + 1]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mx = nan_max(mx, __shfl_down_sync(kAll, mx, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = mx;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = red[0];
    for (int k = 1; k < kWarps; ++k) m = nan_max(m, red[k]);
    // torch.deg2rad multiplies by pi / 180 rounded to float32
    float rad = 60.0f * (float)(3.14159265358979323846 / 180.0);
    max_len_s = m / cosf(rad) + res;
  }
  __syncthreads();
  float max_len = max_len_s;

  int ray = blockIdx.x;
  int segs = n_gx - 1;
  float px = grid_h[2 * ray], py = grid_h[2 * ray + 1];
  // phi0 = pi / 2, rounded to float32 as the plain version's tensor is
  const float phi0 = (float)(3.14159265358979323846 / 2.0);
  const float c0 = cosf(phi0), s0 = sinf(phi0);
  const float upper = (float)(1.0 + 1e-6);
  if (threadIdx.x == 0) {
    out[2 * ray] = px;
    out[2 * ray + 1] = py;
  }
  for (int k = 1; k < n_gy; ++k) {
    float2 d = field_eval(px, py, sm, n, c0, s0, red, &dir);
    float rx = d.x * max_len, ry = d.y * max_len;
    const float* row = grid_h + 2 * k * n_gx;
    float bt = 0.0f;
    int bi = -1;
    for (int j = threadIdx.x; j < segs; j += kThreads) {
      float ax = row[2 * j], ay = row[2 * j + 1];
      float bx = row[2 * j + 2], by = row[2 * j + 3];
      // the border segments extended far outwards, each from the
      // unextended segment
      float ax0 = ax, ay0 = ay;
      if (j == 0) {
        float ex = ax0 - bx, ey = ay0 - by;
        float nrm = sqrtf(ex * ex + ey * ey) + 1e-12f;
        ax = ax0 + ex / nrm * 1e5f;
        ay = ay0 + ey / nrm * 1e5f;
      }
      if (j == segs - 1) {
        float ex = bx - ax0, ey = by - ay0;
        float nrm = sqrtf(ex * ex + ey * ey) + 1e-12f;
        bx = bx + ex / nrm * 1e5f;
        by = by + ey / nrm * 1e5f;
      }
      float sx = bx - ax, sy = by - ay;
      float qx = ax - px, qy = ay - py;
      float den = rx * sy - ry * sx;
      den = fabsf(den) < 1e-9f ? 1e-9f : den;
      float t = (qx * sy - qy * sx) / den;
      float u = (qx * ry - qy * rx) / den;
      bool valid = (u >= -1e-6f) && (u <= upper) && (t > 1e-6f);
      float ts = valid ? t : INFINITY;
      t_sel[j] = ts;
      if (before(ts, j, bt, bi)) {
        bt = ts;
        bi = j;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      float ot = __shfl_down_sync(kAll, bt, o);
      int oi = __shfl_down_sync(kAll, bi, o);
      if (before(ot, oi, bt, bi)) {
        bt = ot;
        bi = oi;
      }
    }
    if ((threadIdx.x & 31) == 0) {
      arg_t[threadIdx.x >> 5] = bt;
      arg_i[threadIdx.x >> 5] = bi;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      bt = arg_t[0];
      bi = arg_i[0];
      for (int w = 1; w < kWarps; ++w)
        if (before(arg_t[w], arg_i[w], bt, bi)) {
          bt = arg_t[w];
          bi = arg_i[w];
        }
      float t_best = t_sel[bi];               // the lane gather
      bool ok = isfinite(t_best);
      float2 p = ok ? make_float2(px + rx * t_best, py + ry * t_best)
                    : make_float2(px + d.x * res, py + d.y * res);
      p_s = p;
      out[2 * (k * n_gx + ray)] = p.x;
      out[2 * (k * n_gx + ray) + 1] = p.y;
      if (best_out) best_out[(k - 1) * n_gx + ray] = bi;
    }
    __syncthreads();
    px = p_s.x;
    py = p_s.y;
  }
}

int shared_bytes(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" int origami_grid_scan_h(const float* xy, const float* phi,
                                   const float* mask, int n, int n_gy,
                                   int n_gx, float res, float origin,
                                   float* grid_h, void* stream) {
  size_t bytes = (size_t)5 * n * sizeof(float);
  int rc = shared_bytes((const void*)grid_scan_h_kernel, bytes);
  if (rc) return rc;
  grid_scan_h_kernel<<<n_gy, kThreads, bytes, (cudaStream_t)stream>>>(
      xy, phi, mask, n, n_gy, n_gx, res, origin, grid_h);
  return (int)cudaGetLastError();
}

extern "C" int origami_grid_scan_v(const float* grid_h, const float* xy,
                                   const float* phi, const float* mask, int n,
                                   int n_gy, int n_gx, float res, float* out,
                                   int* best, void* stream) {
  size_t bytes = ((size_t)5 * n + (n_gx - 1)) * sizeof(float);
  int rc = shared_bytes((const void*)grid_scan_v_kernel, bytes);
  if (rc) return rc;
  grid_scan_v_kernel<<<n_gx, kThreads, bytes, (cudaStream_t)stream>>>(
      grid_h, xy, phi, mask, n, n_gy, n_gx, res, out, best);
  return (int)cudaGetLastError();
}
