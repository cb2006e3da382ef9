// PNG's inverse row filters (None, Sub, Up, Average, Paeth) over the
// scanlines of one image or one Adam7 pass; core/_png.py does the rest.
//
//   png_unfilter(raw, rows, stride, bpp, out) -> 0, or the 1-based row
//       whose filter type is not 0-4 (negated)
//
// `raw` holds `rows` lines of 1 + `stride` bytes (the filter type
// first); `out` gets rows * stride bytes.

#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" int png_unfilter(const uint8_t* raw, int rows, long stride,
                            int bpp, uint8_t* out) {
  for (int y = 0; y < rows; y++) {
    const uint8_t* in = raw + (size_t)y * (stride + 1);
    int ftype = *in++;
    uint8_t* cur = out + (size_t)y * stride;
    const uint8_t* up = y > 0 ? cur - stride : nullptr;
    switch (ftype) {
      case 0:
        memcpy(cur, in, stride);
        break;
      case 1:
        for (long x = 0; x < stride; x++)
          cur[x] = (uint8_t)(in[x] + (x >= bpp ? cur[x - bpp] : 0));
        break;
      case 2:
        for (long x = 0; x < stride; x++)
          cur[x] = (uint8_t)(in[x] + (up ? up[x] : 0));
        break;
      case 3:
        for (long x = 0; x < stride; x++) {
          int a = x >= bpp ? cur[x - bpp] : 0, b = up ? up[x] : 0;
          cur[x] = (uint8_t)(in[x] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (long x = 0; x < stride; x++) {
          int a = x >= bpp ? cur[x - bpp] : 0, b = up ? up[x] : 0;
          int c = (up && x >= bpp) ? up[x - bpp] : 0;
          int pa = abs(b - c), pb = abs(a - c), pc = abs(a + b - 2 * c);
          int p = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          cur[x] = (uint8_t)(in[x] + p);
        }
        break;
      default:
        return -(y + 1);
    }
  }
  return 0;
}
