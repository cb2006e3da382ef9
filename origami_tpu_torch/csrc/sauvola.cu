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
// box around the pixel. `border` picks what the box does at the page's
// edge: zero (the Pallas kernel: pixels outside the page count as 0, the
// divisor is always window^2) or clamp (ops/binarize._window_sums: the box
// is clipped to the page and the divisor is the clipped area). Pixels
// outside the page add nothing to either sum, so the two differ only in
// the divisor.
//
// What bounds it on this card: memory. The least traffic is one read of
// the u8 page and one write of the mask (1 byte per pixel, or 1 bit when
// packed); per pixel the arithmetic is two box sums and a dozen float
// operations. The Pallas kernel's (8, 128)-aligned halo, its `window`
// unrolled adds over whole tiles, its double-buffered DMA and the padded
// copy of the page exist for Mosaic only. Here one block owns a 32 x 128
// output tile: it loads the haloed u8 tile into shared memory (zero
// outside the page), a vertical pass leaves per-column sums of v and v^2
// over `window` rows in shared memory (running sums, exact in integers),
// and a horizontal pass adds `window` of those per pixel. The page's
// bytes outside shared memory are read about (1 + 2 rad / 32) (1 + 2 rad
// / 128) times, mostly from L2. The sums are integers (at most 255^2 *
// 31^2 < 2^31), converted once to float, so the result does not depend on
// a summation order; the float formula is written in `_sauvola_kernel`'s
// order and the file builds with -fmad=false, so the plain PyTorch
// version (ops/binarize.py) gives the same bits.
//
// The packed variant writes the mask in numpy.packbits order (bit 7 - i
// of byte j is pixel 8 j + i) straight from a warp ballot, so the
// unpacked mask never reaches device memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TW = 128;      // output tile width = blockDim.x
constexpr int TH = 32;       // output tile height
constexpr int BY = 4;        // blockDim.y
constexpr int SEG = 8;       // rows per running-sum segment
constexpr int MAX_RAD = 15;  // window <= 31
constexpr int SW_MAX = TW + 2 * MAX_RAD;
constexpr int SH_MAX = TH + 2 * MAX_RAD;

template <bool PACKED>
__global__ void __launch_bounds__(TW* BY)
    sauvola_kernel(const uint8_t* __restrict__ img, int h, int w, int rad,
                   float k, float r, int clamp_border,
                   uint8_t* __restrict__ out) {
  __shared__ uint8_t tile[SH_MAX * SW_MAX];
  __shared__ uint16_t col1[TH * SW_MAX];  // <= 255 * 31
  __shared__ uint32_t col2[TH * SW_MAX];  // <= 255^2 * 31
  const int win = 2 * rad + 1;
  const int sw = TW + 2 * rad, sh = TH + 2 * rad;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int tid = threadIdx.y * TW + threadIdx.x;
  const int nthreads = TW * BY;

  // haloed tile, zero outside the page
  for (int i = tid; i < sh * sw; i += nthreads) {
    int ty = i / sw, tx = i - ty * sw;
    int gy = y0 - rad + ty, gx = x0 - rad + tx;
    tile[i] = (gy >= 0 && gy < h && gx >= 0 && gx < w)
                  ? __ldg(img + (long)gy * w + gx)
                  : (uint8_t)0;
  }
  __syncthreads();

  // vertical pass: per column, sums over `win` rows for each output row;
  // each work item does SEG rows with running sums
  for (int i = tid; i < sw * (TH / SEG); i += nthreads) {
    int seg = i / sw, c = i - seg * sw;
    int row = seg * SEG;
    uint32_t s1 = 0, s2 = 0;
    for (int d = 0; d < win; ++d) {
      uint32_t v = tile[(row + d) * sw + c];
      s1 += v;
      s2 += v * v;
    }
    col1[row * sw + c] = (uint16_t)s1;
    col2[row * sw + c] = s2;
    for (int j = 1; j < SEG; ++j) {
      uint32_t a = tile[(row + j - 1) * sw + c];
      uint32_t b = tile[(row + j - 1 + win) * sw + c];
      s1 += b - a;  // unsigned wrap-around cancels
      s2 += b * b - a * a;
      col1[(row + j) * sw + c] = (uint16_t)s1;
      col2[(row + j) * sw + c] = s2;
    }
  }
  __syncthreads();

  // horizontal pass, formula, compare; a warp is 32 neighbouring columns
  // of one row
  const int x = x0 + threadIdx.x;
  for (int row = threadIdx.y; row < TH; row += BY) {
    const int y = y0 + row;
    const bool inside = x < w && y < h;
    bool paper = false;
    if (inside) {
      uint32_t s1 = 0, s2 = 0;
      const int base = row * sw + threadIdx.x;
      for (int d = 0; d < win; ++d) {
        s1 += col1[base + d];
        s2 += col2[base + d];
      }
      int area = win * win;
      if (clamp_border) {
        area = (min(y + rad, h - 1) - max(y - rad, 0) + 1) *
               (min(x + rad, w - 1) - max(x - rad, 0) + 1);
      }
      float counts = (float)area;
      float mean = (float)s1 / counts;
      float var = fmaxf((float)s2 / counts - mean * mean, 0.0f);
      float sd = sqrtf(var);
      float thresh = mean * (1.0f + k * ((sd / r) - 1.0f));
      float center = (float)tile[(row + rad) * sw + threadIdx.x + rad];
      paper = center > thresh;
    }
    if (PACKED) {
      // lane l holds pixel x0 + 32 * warp + l; byte b of the ballot is
      // pixels 8 b .. 8 b + 7, lowest lane first: reverse it for packbits
      unsigned ballot = __ballot_sync(0xffffffffu, paper);
      int lane = threadIdx.x & 31;
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

}  // namespace

// window odd, 1 <= window <= 31; border 0 = zero, 1 = clamp; packed 0:
// out is (h, w) u8, 1 = paper; packed 1: out is (h, ceil(w / 8)) u8.
extern "C" int origami_sauvola_u8(const uint8_t* img, int h, int w,
                                  int window, float k, float r, int border,
                                  int packed, uint8_t* out, void* stream) {
  if (window < 1 || (window & 1) == 0 || window / 2 > MAX_RAD || h < 1 ||
      w < 1 || border < 0 || border > 1) {
    return (int)cudaErrorInvalidValue;
  }
  dim3 block(TW, BY);
  dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH);
  if (packed) {
    sauvola_kernel<true><<<grid, block, 0, (cudaStream_t)stream>>>(
        img, h, w, window / 2, k, r, border, out);
  } else {
    sauvola_kernel<false><<<grid, block, 0, (cudaStream_t)stream>>>(
        img, h, w, window / 2, k, r, border, out);
  }
  return (int)cudaGetLastError();
}
