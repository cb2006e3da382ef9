// Baseline JPEG encoding that gives the bytes PIL's
// `Image.save(f, "JPEG", quality=q)` gives through libjpeg-turbo 3.1 with
// its defaults: jpeg_set_quality(q, force_baseline) on the Annex K tables
// (jcparam.c), one component (id 1, table 0) or YCbCr from RGB (ids 1-3,
// 2x2 / 1x1 / 1x1 sampling, tables 0, 1, 1; jccolor.c rgb_ycc_convert),
// h2v2_downsample with its 1, 2 bias after expand_right_edge
// (jcsample.c), the bottom rows copied down to the iMCU height
// (jcprepct.c), the ISLOW forward DCT (jfdctint.c), quantization through
// the reciprocals of jcdctmgr.c, the dummy blocks of a partial MCU
// (jccoefct.c), the standard Huffman tables (jstdhuff.c) and the marker
// layout of jcmarker.c (JFIF APP0 1.01, one DQT and one DHT segment a
// table). Integer arithmetic only, so the bytes do not depend on the
// compiler.
//
//   jpeg_encode(pixels, h, w, channels, quality, out, cap, err, errlen)
//       -> bytes of the file
//
// `pixels` holds h * w * channels bytes (channels 1: gray, 3: RGB). The
// file is written to `out` when it fits in `cap` bytes; a larger return
// value than `cap` asks for a larger buffer. On failure returns -1 with
// a message in `err`.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

const int kZigzag[64] = {  // zigzag index -> natural index
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// jcparam.c std_luminance_quant_tbl, std_chrominance_quant_tbl (natural
// order)
const int kLumaQ[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int kChromaQ[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// jstdhuff.c: code counts of lengths 1-16, then the symbols
const uint8_t kDcLumaBits[16] = {
    0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[16] = {
    0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {
    0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[16] = {
    0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

// jchuff.c jpeg_make_c_derived_tbl: symbol -> (code, length)
struct HuffCodes {
  unsigned code[256];
  int size[256];
  HuffCodes(const uint8_t* bits, const uint8_t* vals) {
    memset(size, 0, sizeof(size));
    unsigned c = 0;
    int k = 0;
    for (int l = 1; l <= 16; l++) {
      for (int i = 0; i < bits[l - 1]; i++, k++, c++) {
        code[vals[k]] = c;
        size[vals[k]] = l;
      }
      c <<= 1;
    }
  }
};

// jcdctmgr.c compute_reciprocal with 16-bit DCTELEMs (the SIMD build's):
// (|x| + corr) * recip >> shift is x / divisor rounded half away from 0
struct Divisor {
  uint32_t recip, corr;
  int shift;
  explicit Divisor(unsigned divisor = 8) {
    int b = 31 - __builtin_clz(divisor);
    int r = 16 + b;
    uint32_t fq = (uint32_t)((1u << r) / divisor);
    uint32_t fr = (uint32_t)((1u << r) % divisor);
    uint32_t c = divisor / 2;
    if (fr == 0) {
      fq >>= 1;
      r--;
    } else if (fr <= divisor / 2u) {
      c++;
    } else {
      fq++;
    }
    recip = fq;
    corr = c;
    shift = r;
  }
  int quantize(int x) const {
    uint32_t t = (uint32_t)(x < 0 ? -x : x);
    int q = (int)(((t + corr) * recip) >> shift);
    return x < 0 ? -q : q;
  }
};

#define FIX_0_298631336 2446
#define FIX_0_390180644 3196
#define FIX_0_541196100 4433
#define FIX_0_765366865 6270
#define FIX_0_899976223 7373
#define FIX_1_175875602 9633
#define FIX_1_501321110 12299
#define FIX_1_847759065 15137
#define FIX_1_961570560 16069
#define FIX_2_053119869 16819
#define FIX_2_562915447 20995
#define FIX_3_072711026 25172
#define CONST_BITS 13
#define PASS1_BITS 2

inline int32_t descale(int32_t x, int n) {
  return (x + ((int32_t)1 << (n - 1))) >> n;
}

// jfdctint.c jpeg_fdct_islow in place on 64 level-shifted samples; the
// output is the DCT scaled up by 8
void fdct_islow(int32_t* d) {
  for (int pass = 0; pass < 2; pass++) {
    const int step = pass ? 8 : 1;    // element stride within a line
    const int next = pass ? 1 : 8;    // stride between lines
    for (int line = 0; line < 8; line++) {
      int32_t* p = d + line * next;
      int32_t tmp0 = p[0] + p[7 * step], tmp7 = p[0] - p[7 * step];
      int32_t tmp1 = p[step] + p[6 * step], tmp6 = p[step] - p[6 * step];
      int32_t tmp2 = p[2 * step] + p[5 * step];
      int32_t tmp5 = p[2 * step] - p[5 * step];
      int32_t tmp3 = p[3 * step] + p[4 * step];
      int32_t tmp4 = p[3 * step] - p[4 * step];
      int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      const int sh = pass ? CONST_BITS + PASS1_BITS : CONST_BITS - PASS1_BITS;
      if (pass) {
        p[0] = descale(tmp10 + tmp11, PASS1_BITS);
        p[4 * step] = descale(tmp10 - tmp11, PASS1_BITS);
      } else {
        p[0] = (tmp10 + tmp11) * (1 << PASS1_BITS);
        p[4 * step] = (tmp10 - tmp11) * (1 << PASS1_BITS);
      }
      int32_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
      p[2 * step] = descale(z1 + tmp13 * FIX_0_765366865, sh);
      p[6 * step] = descale(z1 + tmp12 * -FIX_1_847759065, sh);
      z1 = tmp4 + tmp7;
      int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      int32_t z5 = (z3 + z4) * FIX_1_175875602;
      tmp4 *= FIX_0_298631336;
      tmp5 *= FIX_2_053119869;
      tmp6 *= FIX_3_072711026;
      tmp7 *= FIX_1_501321110;
      z1 *= -FIX_0_899976223;
      z2 *= -FIX_2_562915447;
      z3 *= -FIX_1_961570560;
      z4 *= -FIX_0_390180644;
      z3 += z5;
      z4 += z5;
      p[7 * step] = descale(tmp4 + z1 + z3, sh);
      p[5 * step] = descale(tmp5 + z2 + z4, sh);
      p[3 * step] = descale(tmp6 + z2 + z3, sh);
      p[step] = descale(tmp7 + z1 + z4, sh);
    }
  }
}

// One component's samples, padded as libjpeg pads them, and its tables.
struct Plane {
  int h, v;              // sampling factors
  int bw, bh;            // blocks holding image samples
  int stride, rows;      // padded plane: bw * 8 by the iMCU rows' height
  std::vector<uint8_t> px;
  int tbl;               // quantization and Huffman table
  int last_dc = 0;
};

class Writer {
 public:
  std::vector<uint8_t> out;

  void byte(int b) { out.push_back((uint8_t)b); }
  void u16(int v) {
    byte(v >> 8);
    byte(v & 255);
  }
  void marker(int m) {
    byte(0xFF);
    byte(m);
  }
  // entropy-coded bits, 0xFF stuffed with 0x00
  void bits(unsigned code, int n) {
    acc_ = (acc_ << n) | (code & ((1u << n) - 1));
    nacc_ += n;
    while (nacc_ >= 8) {
      nacc_ -= 8;
      int b = (int)((acc_ >> nacc_) & 255);
      byte(b);
      if (b == 0xFF) byte(0);
    }
  }
  // jchuff.c flush_bits: the partial byte filled with 1-bits
  void flush() {
    if (nacc_) bits(0x7F, 8 - nacc_);
    acc_ = 0;
  }

 private:
  uint64_t acc_ = 0;
  int nacc_ = 0;
};

void quality_table(const int* base, int quality, int* q) {
  // jcparam.c jpeg_quality_scaling, jpeg_add_quant_table (baseline)
  quality = std::min(std::max(quality, 1), 100);
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; i++) {
    long t = ((long)base[i] * scale + 50L) / 100L;
    q[i] = (int)std::min(std::max(t, 1L), 255L);
  }
}

// jccolor.c rgb_ycc_start's table, SCALEBITS 16
struct YccTable {
  int32_t t[8][256];
  YccTable() {
    const int32_t one_half = 1 << 15, cbcr = 128 << 16;
    for (int i = 0; i < 256; i++) {
      t[0][i] = 19595 * i;                          // R -> Y
      t[1][i] = 38470 * i;                          // G -> Y
      t[2][i] = 7471 * i + one_half;                // B -> Y
      t[3][i] = -11059 * i;                         // R -> Cb
      t[4][i] = -21709 * i;                         // G -> Cb
      t[5][i] = 32768 * i + cbcr + one_half - 1;    // B -> Cb, R -> Cr
      t[6][i] = -27439 * i;                         // G -> Cr
      t[7][i] = -5329 * i;                          // B -> Cr
    }
  }
};

void expand_right(uint8_t* row, int from, int to) {
  if (to > from) memset(row + from, row[from - 1], to - from);
}

// The padded planes of the image: one (gray) or Y, Cb, Cr (4:2:0).
std::vector<Plane> planes(const uint8_t* px, int h, int w, int ch) {
  const int hmax = ch == 3 ? 2 : 1, vmax = hmax;
  const int imcu_rows = (h + 8 * vmax - 1) / (8 * vmax);
  std::vector<Plane> ps(ch);
  for (int c = 0; c < ch; c++) {
    Plane& p = ps[c];
    p.h = p.v = c == 0 ? hmax : 1;
    p.bw = (int)(((long)w * p.h + 8L * hmax - 1) / (8L * hmax));
    p.bh = (int)(((long)h * p.v + 8L * vmax - 1) / (8L * vmax));
    p.stride = p.bw * 8;
    p.rows = imcu_rows * p.v * 8;
    p.px.assign((size_t)p.stride * p.rows, 0);
    p.tbl = c == 0 ? 0 : 1;
  }
  if (ch == 1) {
    Plane& p = ps[0];
    for (int y = 0; y < h; y++) {
      uint8_t* row = p.px.data() + (size_t)y * p.stride;
      memcpy(row, px + (size_t)y * w, w);
      expand_right(row, w, p.stride);
    }
    for (int y = h; y < p.rows; y++)
      memcpy(p.px.data() + (size_t)y * p.stride,
             p.px.data() + (size_t)(h - 1) * p.stride, p.stride);
    return ps;
  }
  static const YccTable tab;
  const int32_t(*t)[256] = tab.t;
  // the conversion buffer: row groups of 2, the last row copied down
  // (jcprepct.c), each row expanded right as the downsampler expands it
  const int hpad = h + (h & 1);
  const int cw = ps[1].bw * 16;     // chroma input columns (h2v2)
  std::vector<uint8_t> cb((size_t)hpad * cw), cr((size_t)hpad * cw);
  Plane& Y = ps[0];
  for (int y = 0; y < hpad; y++) {
    const uint8_t* in = px + (size_t)std::min(y, h - 1) * w * 3;
    uint8_t* yo = Y.px.data() + (size_t)y * Y.stride;
    uint8_t* bo = cb.data() + (size_t)y * cw;
    uint8_t* ro = cr.data() + (size_t)y * cw;
    for (int x = 0; x < w; x++) {
      int r = in[3 * x], g = in[3 * x + 1], b = in[3 * x + 2];
      yo[x] = (uint8_t)((t[0][r] + t[1][g] + t[2][b]) >> 16);
      bo[x] = (uint8_t)((t[3][r] + t[4][g] + t[5][b]) >> 16);
      ro[x] = (uint8_t)((t[5][r] + t[6][g] + t[7][b]) >> 16);
    }
    expand_right(yo, w, Y.stride);
    expand_right(bo, w, cw);
    expand_right(ro, w, cw);
  }
  // jcsample.c h2v2_downsample: bias 1, 2, 1, 2, ... along the row
  for (int c = 1; c < 3; c++) {
    Plane& p = ps[c];
    const std::vector<uint8_t>& src = c == 1 ? cb : cr;
    for (int y = 0; y < hpad / 2; y++) {
      const uint8_t* i0 = src.data() + (size_t)(2 * y) * cw;
      const uint8_t* i1 = i0 + cw;
      uint8_t* o = p.px.data() + (size_t)y * p.stride;
      int bias = 1;
      for (int x = 0; x < p.stride; x++) {
        o[x] = (uint8_t)((i0[2 * x] + i0[2 * x + 1] + i1[2 * x] +
                          i1[2 * x + 1] + bias) >> 2);
        bias ^= 3;
      }
    }
  }
  // the last downsampled row copied down to the iMCU height (jcprepct.c)
  for (int c = 0; c < 3; c++) {
    Plane& p = ps[c];
    int filled = c == 0 ? hpad : hpad / 2;
    for (int y = filled; y < p.rows; y++)
      memcpy(p.px.data() + (size_t)y * p.stride,
             p.px.data() + (size_t)(filled - 1) * p.stride, p.stride);
  }
  return ps;
}

void encode_block(Writer& wr, const int16_t* blk, int& last_dc,
                  const HuffCodes& dc, const HuffCodes& ac) {
  // jchuff.c encode_one_block
  int temp = blk[0] - last_dc, temp2 = temp;
  last_dc = blk[0];
  if (temp < 0) {
    temp = -temp;
    temp2--;
  }
  int nbits = 0;
  while (temp) {
    nbits++;
    temp >>= 1;
  }
  if (nbits > 11) throw Error("DC coefficient out of range");
  wr.bits(dc.code[nbits], dc.size[nbits]);
  if (nbits) wr.bits((unsigned)temp2, nbits);
  int r = 0;
  for (int k = 1; k < 64; k++) {
    temp = blk[kZigzag[k]];
    if (temp == 0) {
      r++;
      continue;
    }
    while (r > 15) {
      wr.bits(ac.code[0xF0], ac.size[0xF0]);
      r -= 16;
    }
    temp2 = temp;
    if (temp < 0) {
      temp = -temp;
      temp2--;
    }
    nbits = 1;
    while ((temp >>= 1)) nbits++;
    if (nbits > 10) throw Error("AC coefficient out of range");
    int i = (r << 4) + nbits;
    wr.bits(ac.code[i], ac.size[i]);
    wr.bits((unsigned)temp2, nbits);
    r = 0;
  }
  if (r > 0) wr.bits(ac.code[0], ac.size[0]);
}

void dct_block(const Plane& p, int by, int bx, const Divisor* div,
               int16_t* blk) {
  int32_t ws[64];
  for (int y = 0; y < 8; y++) {
    const uint8_t* row = p.px.data() + (size_t)(by * 8 + y) * p.stride +
                         bx * 8;
    for (int x = 0; x < 8; x++) ws[y * 8 + x] = (int32_t)row[x] - 128;
  }
  fdct_islow(ws);
  for (int i = 0; i < 64; i++) blk[i] = (int16_t)div[i].quantize(ws[i]);
}

std::vector<uint8_t> encode(const uint8_t* px, int h, int w, int ch,
                            int quality) {
  if (h < 1 || w < 1 || h > 65500 || w > 65500)
    throw Error("JPEG size " + std::to_string(w) + "x" + std::to_string(h) +
                " out of range");
  if (ch != 1 && ch != 3)
    throw Error("JPEG of " + std::to_string(ch) + " channels");
  int qt[2][64];
  quality_table(kLumaQ, quality, qt[0]);
  quality_table(kChromaQ, quality, qt[1]);
  Divisor div[2][64];
  for (int t = 0; t < 2; t++)
    for (int i = 0; i < 64; i++) div[t][i] = Divisor((unsigned)qt[t][i] * 8);
  static const HuffCodes dc_codes[2] = {HuffCodes(kDcLumaBits, kDcVals),
                                        HuffCodes(kDcChromaBits, kDcVals)};
  static const HuffCodes ac_codes[2] = {
      HuffCodes(kAcLumaBits, kAcLumaVals),
      HuffCodes(kAcChromaBits, kAcChromaVals)};
  std::vector<Plane> ps = planes(px, h, w, ch);
  const int ntab = ch == 3 ? 2 : 1;

  Writer wr;
  wr.out.reserve((size_t)h * w * ch / 4 + 1024);
  wr.marker(0xD8);
  // jcmarker.c emit_jfif_app0: version 1.01, no units, density 1x1
  wr.marker(0xE0);
  wr.u16(16);
  for (const char* s = "JFIF"; *s; s++) wr.byte(*s);
  wr.byte(0);
  wr.byte(1);
  wr.byte(1);
  wr.byte(0);
  wr.u16(1);
  wr.u16(1);
  wr.byte(0);
  wr.byte(0);
  for (int t = 0; t < ntab; t++) {  // emit_dqt, 8-bit entries
    wr.marker(0xDB);
    wr.u16(67);
    wr.byte(t);
    for (int i = 0; i < 64; i++) wr.byte(qt[t][kZigzag[i]]);
  }
  wr.marker(0xC0);  // emit_sof, SOF0
  wr.u16(8 + 3 * ch);
  wr.byte(8);
  wr.u16(h);
  wr.u16(w);
  wr.byte(ch);
  for (int c = 0; c < ch; c++) {
    wr.byte(c + 1);
    wr.byte((ps[c].h << 4) | ps[c].v);
    wr.byte(ps[c].tbl);
  }
  for (int t = 0; t < ntab; t++) {  // emit_dht: DC t, then AC t
    for (int cls = 0; cls < 2; cls++) {
      const uint8_t* bits = cls ? (t ? kAcChromaBits : kAcLumaBits)
                                : (t ? kDcChromaBits : kDcLumaBits);
      const uint8_t* vals = cls ? (t ? kAcChromaVals : kAcLumaVals) : kDcVals;
      int n = 0;
      for (int i = 0; i < 16; i++) n += bits[i];
      wr.marker(0xC4);
      wr.u16(2 + 1 + 16 + n);
      wr.byte((cls << 4) | t);
      for (int i = 0; i < 16; i++) wr.byte(bits[i]);
      for (int i = 0; i < n; i++) wr.byte(vals[i]);
    }
  }
  wr.marker(0xDA);  // emit_sos
  wr.u16(6 + 2 * ch);
  wr.byte(ch);
  for (int c = 0; c < ch; c++) {
    wr.byte(c + 1);
    wr.byte((ps[c].tbl << 4) | ps[c].tbl);
  }
  wr.byte(0);
  wr.byte(63);
  wr.byte(0);

  int16_t blk[64];
  if (ch == 1) {  // a one-component scan: every block its own MCU
    Plane& p = ps[0];
    for (int by = 0; by < p.bh; by++)
      for (int bx = 0; bx < p.bw; bx++) {
        dct_block(p, by, bx, div[0], blk);
        encode_block(wr, blk, p.last_dc, dc_codes[0], ac_codes[0]);
      }
  } else {
    // jccoefct.c compress_data: the blocks of a partial MCU past the
    // image are dummies, zero but for the DC of the block before them
    const int mcux = (w + 15) / 16, mcuy = (h + 15) / 16;
    for (int my = 0; my < mcuy; my++)
      for (int mx = 0; mx < mcux; mx++)
        for (int c = 0; c < 3; c++) {
          Plane& p = ps[c];
          const int t = p.tbl;
          int16_t prev_dc = 0;
          for (int yy = 0; yy < p.v; yy++)
            for (int xx = 0; xx < p.h; xx++) {
              int by = my * p.v + yy, bx = mx * p.h + xx;
              if (by < p.bh && bx < p.bw) {
                dct_block(p, by, bx, div[t], blk);
              } else {
                memset(blk, 0, sizeof(blk));
                blk[0] = prev_dc;
              }
              prev_dc = blk[0];
              encode_block(wr, blk, p.last_dc, dc_codes[t], ac_codes[t]);
            }
        }
  }
  wr.flush();
  wr.marker(0xD9);
  return std::move(wr.out);
}

}  // namespace

extern "C" long jpeg_encode(const uint8_t* pixels, int h, int w, int channels,
                            int quality, uint8_t* out, long cap, char* err,
                            int errlen) {
  try {
    std::vector<uint8_t> data = encode(pixels, h, w, channels, quality);
    if ((long)data.size() <= cap) memcpy(out, data.data(), data.size());
    return (long)data.size();
  } catch (const std::bad_alloc&) {
    snprintf(err, errlen, "image too large to encode as JPEG");
    return -1;
  } catch (const std::exception& e) {
    snprintf(err, errlen, "%s", e.what());
    return -1;
  }
}
