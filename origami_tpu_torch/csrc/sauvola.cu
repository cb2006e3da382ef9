// Sauvola binarization for Hopper (sm_90a).
//
// Replaces the Pallas kernel `sauvola_pallas` (body `_sauvola_kernel`) of
// origami_tpu/ops/pallas/sauvola.py, and the XLA integral-image route of
// origami_tpu/ops/binarize.py (`sauvola`, `sauvola_packed`) that the JAX
// main path runs.
//
//   paper = center > m * (1 + k * (s / r - 1))
//
// with m and s the mean and the standard deviation over a window x window
// box around the pixel, for any odd window (a box larger than the page is
// the page). `border` picks what the box does at the page's edge: zero
// (the Pallas kernel: pixels outside the page count as 0, the divisor is
// always window^2) or clamp (ops/binarize._window_sums: the box is
// clipped to the page and the divisor is the clipped area). Pixels
// outside the page add nothing to either sum, so the two differ only in
// the divisor.
//
// What bounds it on this card: the least traffic is one read of the u8
// page and one write of the mask (1 byte per pixel, or 1 bit when
// packed), about 25 operations a pixel. The kernel itself issues about a
// hundred instructions a pixel (a count of this code: the column walk,
// the scans, the box lookups and the formula's correctly rounded
// divisions and square root, which bit equality keeps) and waits on its
// loads; it is bound by instruction throughput and latency, not by
// memory. The Pallas kernel's (8, 128)-aligned halo, its `window`
// unrolled adds over whole tiles, its double-buffered DMA and the padded
// copy of the page exist for Mosaic only. Here a pixel costs about the
// same whatever the window:
//
//   * a block of 256 threads owns a band of tw = 32 NIT output columns
//     (224, 192, 128 or 32, the widest whose halo keeps tw + 2 rad <=
//     256) and `band` rows, and walks down it: thread c holds column c
//     of the band and its halo (sw = tw + 2 rad columns, clipped to the
//     page) and slides that column's sums of v and v^2 down the rows,
//     adding the entering row and subtracting the leaving one (unsigned
//     wrap-around cancels), its loads issued a chunk ahead;
//   * per chunk of up to 8 rows the column sums go to shared memory, the
//     two sums of a column side by side (one 8-byte access), and each
//     warp scans one row (a lane's stretch of at most 9 columns in
//     registers, then warp shuffles) so that a pixel's box is P[hi] -
//     P[lo]; a lane's NIT pixels of the row are loaded, computed and
//     stored group by group, so their latencies overlap;
//   * the chunks alternate between two buffers, so one __syncthreads a
//     chunk separates the column walk of chunk i + 1 from the scans of
//     chunk i, and warps overlap the two;
//   * the grid is sized from the SM count and the blocks an SM holds, so
//     that the page is covered in one wave of bands of at least 32 rows
//     (scripts/sauvola_ab.py times other band rules and register caps);
//   * shared memory is sized from the window actually asked for; a halo
//     wider than the block (windows over 225) loops over its columns,
//     their running sums in shared memory.
//
// The page's bytes are read once entering and once leaving a column's
// walk (the second from L1/L2), plus once for the centre. The sums are
// exact integers in 32 bits while a box's sum of squares fits (65025 *
// box area < 2^32, i.e. a box of up to 257 x 257), in 64 bits past that
// (a template on the accumulator), converted once to float with rounding
// to nearest, so the result does not depend on a summation order; the
// float formula is written in `_sauvola_kernel`'s order and the file
// builds with -fmad=false, so the plain PyTorch version
// (ops/binarize.py) gives the same bits (a division by r = 2^e is a
// multiplication by 2^-e, exactly).
//
// The packed variant writes the mask in numpy.packbits order (bit 7 - i
// of byte j is pixel 8 j + i) straight from a warp ballot, one byte store
// per 8 pixels, so the unpacked mask never reaches device memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <cmath>

namespace {

constexpr int NT = 256;          // threads a block
constexpr int WARPS = NT / 32;   // rows a chunk at most, one per warp
constexpr int NBUF = 2;          // chunk buffers
constexpr int MIN_BAND = 32;     // the least band height
// a row's stretch a lane when sw <= NT: ceil(256 / 32) | 1
constexpr int MAX_STRETCH = 9;
constexpr unsigned FULL = 0xffffffffu;

// a column's (or a row prefix's) sums of v and v^2, side by side: one
// 8-byte (16-byte for 64-bit sums) shared-memory access moves both
template <typename Acc>
struct __align__(2 * sizeof(Acc)) Sums {
  Acc s1, s2;
};

__device__ __forceinline__ bool own_column(int c, int cx0, int x0, int tw) {
  const int xi = cx0 + c - x0;
  return xi >= 0 && xi < tw;
}

// column c's sums of v and v^2 over rows y0 - 1 - rad .. y0 - 1 + rad
// (those on the page), 8 loads in flight at a time
template <typename Acc>
__device__ __forceinline__ void column_init(const uint8_t* col, int c, int y0,
                                            int rad, int h, int w, Acc& s1,
                                            Acc& s2) {
  const int ya = max(y0 - 1 - rad, 0), yb = min(y0 - 1 + rad, h - 1);
  for (int y = ya; y <= yb; y += 8) {
    uint32_t v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = y + j <= yb ? __ldg(col + (long)(y + j) * w + c) : 0u;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s1 += (Acc)v[j];
      s2 += (Acc)(v[j] * v[j]);
    }
  }
}

// the bytes a chunk of n rows from yc needs of column c, all loads issued
// together: entering (row + rad), leaving (row - rad - 1), centre
__device__ __forceinline__ void load_rows(const uint8_t* col, int c, int yc,
                                          int n, int h, int w, int rad,
                                          bool own, uint32_t* e, uint32_t* l,
                                          uint32_t* m) {
#pragma unroll
  for (int j = 0; j < WARPS; ++j) {
    const int y = yc + j, ye = y + rad, yl = y - rad - 1;
    const long row = (long)y * w + c;
    e[j] = j < n && ye < h ? __ldg(col + row + (long)rad * w) : 0u;
    l[j] = j < n && yl >= 0 ? __ldg(col + row - (long)(rad + 1) * w) : 0u;
    m[j] = j < n && own ? __ldg(col + row) : 0u;
  }
}

// slide column c's sums down the chunk's rows into the buffers
template <typename Acc>
__device__ __forceinline__ void walk_rows(int c, int n, const uint32_t* e,
                                          const uint32_t* l,
                                          const uint32_t* m, bool own, int xi,
                                          int pitch, int tw, Sums<Acc>* cs,
                                          uint8_t* cc, Acc& s1, Acc& s2) {
#pragma unroll
  for (int j = 0; j < WARPS; ++j) {
    if (j < n) {
      s1 += (Acc)e[j] - (Acc)l[j];  // unsigned wrap-around cancels
      s2 += (Acc)(e[j] * e[j]) - (Acc)(l[j] * l[j]);
      cs[j * pitch + c] = Sums<Acc>{s1, s2};
      if (own) cc[j * tw + xi] = (uint8_t)m[j];
    }
  }
}

// inclusive prefix sums of a row's sw column sums, in place: lane l runs
// over its stretch [l * stretch, (l + 1) * stretch), warp shuffles carry
// the lanes' totals. MAXS > 0: stretch <= MAXS, the stretch is held in
// registers (loaded once); MAXS == 0: any stretch, loaded twice
template <typename Acc, int MAXS>
__device__ __forceinline__ void scan_row(Sums<Acc>* p, int sw,
                                         int stretch, int lane) {
  const int i0 = min(lane * stretch, sw);
  const int len = min(stretch, sw - i0);
  Acc t1 = 0, t2 = 0;
  Acc v1[MAXS > 0 ? MAXS : 1], v2[MAXS > 0 ? MAXS : 1];
  if (MAXS > 0) {
#pragma unroll
    for (int i = 0; i < MAXS; ++i) {
      const int c = min(i0 + i, sw - 1);
      const Sums<Acc> x = p[c];
      v1[i] = i < len ? x.s1 : (Acc)0;
      v2[i] = i < len ? x.s2 : (Acc)0;
      t1 += v1[i];
      t2 += v2[i];
    }
  } else {
    for (int i = i0; i < i0 + len; ++i) {
      t1 += p[i].s1;
      t2 += p[i].s2;
    }
  }
  Acc e1 = t1, e2 = t2;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Acc u1 = __shfl_up_sync(FULL, e1, d);
    const Acc u2 = __shfl_up_sync(FULL, e2, d);
    if (lane >= d) {
      e1 += u1;
      e2 += u2;
    }
  }
  e1 -= t1;
  e2 -= t2;
  if (MAXS > 0) {
#pragma unroll
    for (int i = 0; i < MAXS; ++i) {
      e1 += v1[i];
      e2 += v2[i];
      if (i < len) {
        p[i0 + i] = Sums<Acc>{e1, e2};
      }
    }
  } else {
    for (int i = i0; i < i0 + len; ++i) {
      const Sums<Acc> x = p[i];
      e1 += x.s1;
      e2 += x.s2;
      p[i] = Sums<Acc>{e1, e2};
    }
  }
}

template <typename Acc, bool PACKED, int NIT>
__global__ void __launch_bounds__(NT)
    sauvola_kernel(const uint8_t* __restrict__ img, int h, int w, int rad,
                   int band, int rows, int pitch, float zero_area, float k,
                   float r, float inv_r, int clamp_border,
                   uint8_t* __restrict__ out) {
  constexpr int tw = 32 * NIT;  // output columns a block
  extern __shared__ __align__(16) unsigned char smem[];
  Sums<Acc>* run = reinterpret_cast<Sums<Acc>*>(smem);  // [pitch]
  Sums<Acc>* buf = run + pitch;  // [NBUF][rows][pitch] column sums
  uint8_t* cen = reinterpret_cast<uint8_t*>(buf + NBUF * rows * pitch);

  const int x0 = blockIdx.x * tw;
  const int cx0 = max(x0 - rad, 0);
  const int sw = min(x0 + tw + rad, w) - cx0;
  const int y0 = blockIdx.y * band;
  const int y1 = min(y0 + band, h);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const uint8_t* col = img + cx0;

  // where the band and its halo fit the block (sw <= NT: every window up
  // to 225), thread c keeps column c's sums in registers and issues a
  // chunk's loads one chunk ahead, so their latency hides behind the
  // scans; wider halos loop over columns with their sums in shared memory
  const bool single = sw <= NT;
  uint32_t e[WARPS], l[WARPS], m[WARPS];
  Acc s1 = 0, s2 = 0;
  for (int c = tid; c < sw; c += NT) {
    if (single) {
      load_rows(col, c, y0, min(rows, y1 - y0), h, w, rad,
                own_column(c, cx0, x0, tw), e, l, m);
    }
    column_init(col, c, y0, rad, h, w, s1, s2);
    if (!single) {
      run[c] = Sums<Acc>{s1, s2};
      s1 = s2 = 0;
    }
  }

  // a lane's stretch of a row for the scan: odd, so that the lanes' first
  // words fall in distinct banks
  const int stretch = ((sw + 31) / 32) | 1;
  int b = 0;
  for (int yc = y0; yc < y1; yc += rows, b ^= 1) {
    const int n = min(rows, y1 - yc);
    Sums<Acc>* cs = buf + b * rows * pitch;
    uint8_t* cc = cen + b * rows * tw;

    // column walk: row yc + j's column sums into row j of the buffer
    if (single) {
      if (tid < sw) {
        const bool own = own_column(tid, cx0, x0, tw);
        walk_rows(tid, n, e, l, m, own, tid + cx0 - x0, pitch, tw, cs, cc,
                  s1, s2);
        if (yc + rows < y1) {
          load_rows(col, tid, yc + rows, min(rows, y1 - yc - rows), h, w,
                    rad, own, e, l, m);
        }
      }
    } else {
      for (int c = tid; c < sw; c += NT) {
        const bool own = own_column(c, cx0, x0, tw);
        Acc t1 = run[c].s1, t2 = run[c].s2;
        load_rows(col, c, yc, n, h, w, rad, own, e, l, m);
        walk_rows(c, n, e, l, m, own, c + cx0 - x0, pitch, tw, cs, cc, t1,
                  t2);
        run[c] = Sums<Acc>{t1, t2};
      }
    }
    __syncthreads();
    // the next chunk writes the other buffer; the __syncthreads after its
    // column walk keeps the chunk after it off this one until every warp
    // has read it
    if (warp >= n) continue;

    // warp `warp` scans its row: inclusive prefix sums of the column sums
    Sums<Acc>* p = cs + warp * pitch;
    if (single) {
      scan_row<Acc, MAX_STRETCH>(p, sw, stretch, lane);
    } else {
      scan_row<Acc, 0>(p, sw, stretch, lane);
    }
    __syncwarp();

    // formula, compare; lanes on 32 neighbouring columns of the row, the
    // NIT groups of 32 loaded, computed and stored each in one go so that
    // their latencies overlap
    const int y = yc + warp;
    const int rows_in = min(y + rad, h - 1) - max(y - rad, 0) + 1;
    Acc a1[NIT], a2[NIT];
    float counts[NIT];
    uint32_t center[NIT];
#pragma unroll
    for (int i = 0; i < NIT; ++i) {
      const int xi = lane + 32 * i;
      const int x = min(x0 + xi, w - 1);  // past the page: any valid box
      const int lo = max(x - rad, 0) - cx0;
      const int hi = min(x + rad + 1, w) - cx0;
      const int below = max(lo - 1, 0);
      const Sums<Acc> top = p[hi - 1], bot = p[below];
      a1[i] = top.s1 - (lo > 0 ? bot.s1 : (Acc)0);
      a2[i] = top.s2 - (lo > 0 ? bot.s2 : (Acc)0);
      counts[i] = clamp_border ? (float)(rows_in * (hi - lo)) : zero_area;
      center[i] = cc[warp * tw + xi];
    }
#pragma unroll
    for (int i = 0; i < NIT; ++i) {
      const int x = x0 + lane + 32 * i;
      const bool inside = x < w;
      float mean = (float)a1[i] / counts[i];
      float var = fmaxf((float)a2[i] / counts[i] - mean * mean, 0.0f);
      float sd = sqrtf(var);
      // r a power of two: sd * (1 / r) is sd / r exactly
      const float sdr = inv_r != 0.0f ? sd * inv_r : sd / r;
      float thresh = mean * (1.0f + k * (sdr - 1.0f));
      const bool paper = inside && (float)center[i] > thresh;
      if (PACKED) {
        // lane l holds pixel x; byte b of the ballot is pixels 8 b ..
        // 8 b + 7, lowest lane first: reverse it for packbits
        unsigned ballot = __ballot_sync(FULL, paper);
        if ((lane & 7) == 0 && inside) {
          unsigned byte = (ballot >> lane) & 0xffu;
          out[(long)y * ((w + 7) / 8) + (x >> 3)] =
              (uint8_t)(__brev(byte) >> 24);
        }
      } else if (inside) {
        out[(long)y * w + x] = paper ? 1 : 0;
      }
    }
  }
}

template <typename Acc, bool PACKED, int NIT>
int launch(const uint8_t* img, int h, int w, int rad, float zero_area,
           float k, float r, float inv_r, int border, uint8_t* out,
           cudaStream_t stream) {
  auto kernel = sauvola_kernel<Acc, PACKED, NIT>;
  constexpr int tw = 32 * NIT;
  int dev = 0, sms = 0, smem_max = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&smem_max,
                                cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (rc != cudaSuccess) return (int)rc;

  const int pitch = (int)std::min<long long>(tw + 2LL * rad, w);
  // halve the rows a chunk while the buffers do not fit (very wide boxes
  // on very wide pages)
  int rows = WARPS;
  auto bytes = [&](int rows_) {
    return (size_t)(1 + NBUF * rows_) * pitch * sizeof(Sums<Acc>) +
           (size_t)NBUF * rows_ * tw;
  };
  while (rows > 1 && bytes(rows) > (size_t)smem_max) rows /= 2;
  const size_t smem = bytes(rows);
  if (smem > (size_t)smem_max) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  const int nbx = (w + tw - 1) / tw;
  // one wave: as many bands as the SMs hold blocks beside each other
  // (the occupancy query costs microseconds of host time: kept for the
  // last device and size this thread asked about)
  static thread_local int last_dev = -1, per_sm = 0;
  static thread_local size_t last_smem = 0;
  if (dev != last_dev || smem != last_smem) {
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT,
                                                       smem);
    if (rc != cudaSuccess) return (int)rc;
    last_dev = dev;
    last_smem = smem;
  }
  const long long slots = (long long)max(per_sm, 1) * sms;
  int band = (h - 1) / (int)std::max<long long>(1, slots / nbx) + 1;
  band = max(band, MIN_BAND);
  band = (band + rows - 1) / rows * rows;
  const int nby = (h + band - 1) / band;
  if (nby > 65535) return (int)cudaErrorInvalidValue;
  kernel<<<dim3(nbx, nby), NT, smem, stream>>>(img, h, w, rad, band, rows,
                                              pitch, zero_area, k, r, inv_r,
                                              border, out);
  return (int)cudaGetLastError();
}

// the band width from the radius: 32 * NIT output columns, as many as
// keep the band and its halo within the block's 256 threads (sw <= NT)
template <typename Acc, bool PACKED>
int launch_rad(const uint8_t* img, int h, int w, int rad, float zero_area,
               float k, float r, float inv_r, int border, uint8_t* out,
               cudaStream_t stream) {
  if (rad <= 16)
    return launch<Acc, PACKED, 7>(img, h, w, rad, zero_area, k, r, inv_r,
                                  border, out, stream);
  if (rad <= 32)
    return launch<Acc, PACKED, 6>(img, h, w, rad, zero_area, k, r, inv_r,
                                  border, out, stream);
  if (rad <= 64)
    return launch<Acc, PACKED, 4>(img, h, w, rad, zero_area, k, r, inv_r,
                                  border, out, stream);
  return launch<Acc, PACKED, 1>(img, h, w, rad, zero_area, k, r, inv_r,
                                border, out, stream);
}

}  // namespace

// window odd, >= 1; h * w < 2^31; border 0 = zero, 1 = clamp; packed 0:
// out is (h, w) u8, 1 = paper; packed 1: out is (h, ceil(w / 8)) u8.
extern "C" int origami_sauvola_u8(const uint8_t* img, int h, int w,
                                  int window, float k, float r, int border,
                                  int packed, uint8_t* out, void* stream) {
  if (window < 1 || (window & 1) == 0 || h < 1 || w < 1 ||
      (long long)h * w >= (1LL << 31) || border < 0 || border > 1) {
    return (int)cudaErrorInvalidValue;
  }
  // a box reaches at most the whole page: past max(h, w) the radius
  // changes neither sum nor the clipped area
  const int rad = std::min(window / 2, std::max(h, w));
  // the zero border divides by window^2 (int64 to float, to nearest, as
  // the plain version converts it)
  const float zero_area = (float)((long long)window * window);
  // 64-bit sums once a box's sum of squares may pass 2^32
  const long long box = std::min<long long>(window, h) *
                        std::min<long long>(window, w);
  const bool wide = box * 65025LL >= (1LL << 32);
  // r = 2^e (the default 128): dividing by it is multiplying by 2^-e,
  // exactly, in one instruction instead of a correctly rounded division
  int e = 0;
  const bool pow2 = std::frexp(r, &e) == 0.5f && e >= -125 && e <= 127;
  const float inv_r = pow2 ? std::ldexp(1.0f, 1 - e) : 0.0f;
  cudaStream_t s = (cudaStream_t)stream;
  if (wide) {
    return packed ? launch_rad<unsigned long long, true>(
                        img, h, w, rad, zero_area, k, r, inv_r, border, out, s)
                  : launch_rad<unsigned long long, false>(
                        img, h, w, rad, zero_area, k, r, inv_r, border, out,
                        s);
  }
  return packed ? launch_rad<uint32_t, true>(img, h, w, rad, zero_area, k, r,
                                             inv_r, border, out, s)
                : launch_rad<uint32_t, false>(img, h, w, rad, zero_area, k, r,
                                              inv_r, border, out, s);
}
