// JPEG decoding that gives the pixels libjpeg-turbo gives PIL: baseline,
// extended sequential and progressive DCT files, Huffman- or
// arithmetic-coded (jdarith.c: the QM decoder, DAC conditioning,
// progressive first and refinement scans), and lossless (SOF3: jdlhuff.c
// differences, jdpred.c predictors 1-7, the point transform), 8-bit, one,
// three or four components. DCT files go through the ISLOW inverse DCT
// (jidctint.c), fancy upsampling (jdsample.c), the YCbCr tables of
// jdcolor.c and, where a progressive file leaves coefficients unrefined,
// the block smoothing of jdcoefct.c (libjpeg-turbo 2.1 and later);
// lossless planes are upsampled by replication, as libjpeg-turbo 3 does
// (jdsample.c: no fancy upsampling where a block is one sample), and its
// predictors restart where jddiffct.c restarts them. Four
// components are CMYK, or YCCK where an Adobe marker's transform is not
// 0 (jdcolor.c ycck_cmyk_convert), read as PIL reads them ("CMYK;I":
// every sample inverted) and converted to RGB by Pillow's cmyk2rgb.
//
// What PIL cannot read raises: 12-bit DCT files; lossless files of
// another precision than 8 bits, or whose colour needs converting (YCbCr,
// YCCK: libjpeg-turbo converts none in lossless mode; without a JFIF or
// Adobe marker a lossless file is RGB); lossless arithmetic coding
// (SOF11); hierarchical frames; interleaved scans of more than 10 blocks
// an MCU; and arithmetic-coded files whose scan
// PIL's decoder cannot finish. libjpeg's arithmetic decoder cannot
// suspend, and Pillow hands libjpeg the file in 65536-byte blocks
// (ImageFile.MAXBLOCK): a scan is decoded in the call whose data first
// holds its whole SOS header, so PIL reads the file only if every byte
// that the scan's decoding fetches (restart markers and the marker that
// ends it included) lies before the end of that block, 65536 * ceil(end
// of the SOS header / 65536), and before the end of the file.
//
//   jpeg_decode(data, n, out, gray, err, errlen) -> channels written
//   jpeg_planes(data, n, out, sampling, err, errlen) -> components: each
//       component's samples at its own sampling, as libjpeg's raw data
//       output gives them (what libtiff's old-style JPEG codec reads)
//
// `out` holds height * width * channels bytes: channels 1 for a
// one-component file or `gray` (PIL's convert("L") of the RGB result),
// else 3 (RGB). On failure returns -1 with a message in `err`.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

// zigzag index -> natural index; 16 extra entries catch corrupt runs
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

struct Huff {
  bool defined = false;
  int maxcode[18];
  int valptr[17];
  int mincode[17];
  uint8_t vals[256];
  uint8_t look_len[512];  // 9-bit lookahead: code length, 0 = slow path
  uint8_t look_sym[512];

  void build(const uint8_t* bits, const uint8_t* v, int nv) {
    memcpy(vals, v, nv);
    memset(look_len, 0, sizeof(look_len));
    int code = 0, k = 0;
    for (int l = 1; l <= 16; l++) {
      valptr[l] = k;
      mincode[l] = code;
      for (int i = 0; i < bits[l - 1]; i++, k++, code++) {
        if (l <= 9) {
          int shift = 9 - l;
          for (int s = 0; s < (1 << shift); s++) {
            look_len[(code << shift) | s] = (uint8_t)l;
            look_sym[(code << shift) | s] = vals[k];
          }
        }
      }
      maxcode[l] = bits[l - 1] ? code - 1 : -1;
      if (code > (1 << l)) throw Error("bad Huffman table");
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    defined = true;
  }
};

// Bits of one entropy-coded segment (between markers): stuffed 0xFF 0x00
// read as 0xFF, zeros past its end (libjpeg's behaviour at a marker).
struct Bits {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int cnt = 0;

  Bits(const uint8_t* a, const uint8_t* b) : p(a), end(b) {}

  void fill() {
    while (cnt <= 56) {
      uint64_t b = 0;
      if (p < end) {
        b = *p++;
        if (b == 0xFF && p < end && *p == 0x00) p++;
      }
      buf |= b << (56 - cnt);
      cnt += 8;
    }
  }
  int get(int n) {
    if (n == 0) return 0;
    if (cnt < n) fill();
    int v = (int)(buf >> (64 - n));
    buf <<= n;
    cnt -= n;
    return v;
  }
  int decode(const Huff& h) {
    if (cnt < 16) fill();
    unsigned peek = (unsigned)(buf >> (64 - 9));
    int l = h.look_len[peek];
    if (l) {
      buf <<= l;
      cnt -= l;
      return h.look_sym[peek];
    }
    for (l = 10; l <= 16; l++) {
      int code = (int)(buf >> (64 - l));
      if (code <= h.maxcode[l]) {
        buf <<= l;
        cnt -= l;
        return h.vals[h.valptr[l] + code - h.mincode[l]];
      }
    }
    throw Error("corrupt JPEG data: bad Huffman code");
  }
};

inline int extend(int v, int s) {
  return s == 0 ? 0 : (v < (1 << (s - 1)) ? v + (int)(~0u << s) + 1 : v);
}

// jaricom.c jpeg_aritab (ITU T.81 Table D.2 and a fixed-probability
// entry 113): Qe << 16 | Next_Index_MPS << 8 | Switch_MPS << 7 |
// Next_Index_LPS
const uint32_t kAritab[114] = {
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617,
    0x00e50719, 0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09,
    0x00030d0a, 0x00010d0c, 0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227,
    0x17b91328, 0x1182142a, 0x0cef152b, 0x09a1162d, 0x072f172e, 0x055c1830,
    0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36, 0x01441d38, 0x00f51e39,
    0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320, 0x002c0921,
    0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d,
    0x0861314e, 0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633,
    0x02d43734, 0x025c3835, 0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39,
    0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d, 0x008f203d, 0x5b1241c1, 0x4d044250,
    0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654, 0x23794756, 0x1edf4857,
    0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a, 0x0d514e4b,
    0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f,
    0x44d95b60, 0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df,
    0x4f466165, 0x47e56266, 0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669,
    0x4c0f676a, 0x4639686b, 0x415e6367, 0x56276ae9, 0x50e76b6c, 0x4b85676d,
    0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70, 0x59eb6ff0, 0x5a1d7171};

// jdarith.c's QM decoder over the file's bytes from `p`: stuffed 0xFF 0x00
// read as 0xFF; from a marker on (or the file's end) it reads zeros, as
// libjpeg does. `fetched` is the end of the bytes read so far.
struct Arith {
  const uint8_t* d;
  size_t n, p;
  int64_t c = 0, a = 0;
  int ct = -16;
  int marker = 0;
  bool past_end = false;

  Arith(const uint8_t* data, size_t size, size_t pos)
      : d(data), n(size), p(pos) {}

  size_t fetched() const { return past_end ? n + 1 : p; }
  bool raw(int* v) {
    if (p >= n) {
      past_end = true;
      marker = 0xD9;
      return false;
    }
    *v = d[p++];
    return true;
  }
  int get_byte() {
    int v;
    if (marker || !raw(&v)) return 0;
    if (v != 0xFF) return v;
    do {
      if (!raw(&v)) return 0;
    } while (v == 0xFF);
    if (v == 0) return 0xFF;
    marker = v;
    return 0;
  }
  // jdmarker.c next_marker: the code of the next marker from `p` on
  int next_marker() {
    int v;
    for (;;) {
      do {
        if (!raw(&v)) return 0xD9;
      } while (v != 0xFF);
      do {
        if (!raw(&v)) return 0xD9;
      } while (v == 0xFF);
      if (v != 0) return v;
    }
  }
  void reset() {
    c = a = 0;
    ct = -16;
  }
  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        c = (c << 8) | get_byte();
        if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;
      }
      a <<= 1;
    }
    int sv = *st;
    int64_t qe = kAritab[sv & 0x7F];
    int nl = (int)(qe & 0xFF);
    qe >>= 8;
    int nm = (int)(qe & 0xFF);
    qe >>= 8;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {  // conditional LPS exchange
        a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {  // conditional MPS exchange
      if (a < qe) {
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = (uint8_t)((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
};

struct Comp {
  int id, h, v, tq;
  int dw, dh;            // downsampled size in samples
  int bw, bh;            // size in blocks (real)
  int bw_alloc, bh_alloc;  // padded to whole MCUs
  int dc_tbl = 0, ac_tbl = 0;
  bool latched = false;
  int quant[64];         // natural order
  int coef_bits[64];     // progressive: point transform of the last scan
  std::vector<int16_t> coef;  // bh_alloc * bw_alloc blocks of 64
  // lossless: the scan's differences and the samples, one a "block",
  // bh_alloc rows of bw_alloc
  std::vector<int32_t> diff;
  std::vector<uint8_t> samples;
  int dc_pred = 0;
  int dc_context = 0;    // arithmetic DC conditioning (Table F.4)
  int16_t* block(int by, int bx) {
    return coef.data() + ((size_t)by * bw_alloc + bx) * 64;
  }
};

class Decoder {
 public:
  Decoder(const uint8_t* d, size_t n) : data_(d), n_(n) {
    memset(dc_l_, 0, sizeof(dc_l_));
    memset(dc_u_, 1, sizeof(dc_u_));
    memset(ac_k_, 5, sizeof(ac_k_));
  }

  void decode(uint8_t* out, bool gray);
  int planes(uint8_t* out, int* sampling);
  int channels(bool gray) const { return (ncomp_ == 1 || gray) ? 1 : 3; }

 private:
  const uint8_t* data_;
  size_t n_;
  size_t pos_ = 0;
  int width_ = 0, height_ = 0, ncomp_ = 0;
  bool progressive_ = false, frame_ = false;
  bool lossless_ = false, arith_ = false;
  bool saw_jfif_ = false, saw_adobe_ = false;
  int adobe_transform_ = 0;
  int qt_[4][64];
  bool qt_defined_[4] = {false, false, false, false};
  Huff dc_[4], ac_[4];
  int restart_interval_ = 0;
  Comp comp_[4];
  int hmax_ = 1, vmax_ = 1, mcux_ = 0, mcuy_ = 0;
  int scans_ = 0;
  int eobrun_ = 0;
  // arithmetic coding: the DAC conditioning of each table (defaults L 0,
  // U 1, Kx 5) and the statistics areas
  uint8_t dc_l_[16], dc_u_[16], ac_k_[16];
  uint8_t dc_stats_[16][64], ac_stats_[16][256];
  uint8_t fixed_bin_[4] = {113, 0, 0, 0};

  int u8() {
    if (pos_ >= n_) throw Error("JPEG data ends early");
    return data_[pos_++];
  }
  int u16() {
    int a = u8();
    return (a << 8) | u8();
  }

  void read_frame(int marker);
  void read_dqt(size_t end);
  void read_dht(size_t end);
  void read_app(int marker, size_t end);
  void read_dac(size_t end);
  void read_scan();
  size_t segment_end(size_t from, int* marker) const;
  void decode_segment(Bits& br, Comp** sc, int ns, int ss, int se, int ah,
                      int al, long first, long count, long total);
  void decode_block(Bits& br, Comp& c, int16_t* blk, int ss, int se,
                    int ah, int al);
  void lossless_diffs(Bits& br, Comp** sc, int ns, long first, long count,
                      long total);
  void undifference(Comp& c, int psv, int pt, long restart_rows);
  void arith_scan(Comp** sc, int ns, int ss, int se, int ah, int al,
                  long total);
  void arith_block(Arith& ar, Comp& c, int16_t* blk, int ss, int se, int ah,
                   int al);
  void parse();
  void output(uint8_t* out, bool gray);
  bool smoothing_ok();
  void idct_plane(Comp& c, bool smooth, std::vector<uint8_t>& plane);
};

void Decoder::read_frame(int marker) {
  if (frame_) throw Error("JPEG with two frames");
  size_t len = u16();
  (void)len;
  int prec = u8();
  lossless_ = marker == 0xC3;
  arith_ = marker == 0xC9 || marker == 0xCA;
  if (prec != 8 && lossless_)
    throw Error("unsupported JPEG: lossless at " + std::to_string(prec) +
                "-bit precision (PIL reads 8-bit lossless JPEGs only)");
  if (prec != 8)
    throw Error("unsupported JPEG: " + std::to_string(prec) +
                "-bit samples (PIL reads 8-bit JPEGs only)");
  height_ = u16();
  width_ = u16();
  ncomp_ = u8();
  if (height_ == 0)
    throw Error("unsupported JPEG: height given by a DNL marker");
  if (width_ == 0) throw Error("corrupt JPEG: width 0");
  if (ncomp_ != 1 && ncomp_ != 3 && ncomp_ != 4)
    throw Error("unsupported JPEG: " + std::to_string(ncomp_) +
                " components");
  progressive_ = marker == 0xC2 || marker == 0xCA;
  for (int i = 0; i < ncomp_; i++) {
    Comp& c = comp_[i];
    c.id = u8();
    int hv = u8();
    c.h = hv >> 4;
    c.v = hv & 15;
    c.tq = u8();
    if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
      throw Error("corrupt JPEG: bad sampling factors or table");
    hmax_ = std::max(hmax_, c.h);
    vmax_ = std::max(vmax_, c.v);
  }
  const int unit = lossless_ ? 1 : 8;  // a lossless "block" is a sample
  mcux_ = (width_ + hmax_ * unit - 1) / (hmax_ * unit);
  mcuy_ = (height_ + vmax_ * unit - 1) / (vmax_ * unit);
  for (int i = 0; i < ncomp_; i++) {
    Comp& c = comp_[i];
    c.dw = (int)(((long)width_ * c.h + hmax_ - 1) / hmax_);
    c.dh = (int)(((long)height_ * c.v + vmax_ - 1) / vmax_);
    c.bw = (c.dw + unit - 1) / unit;
    c.bh = (c.dh + unit - 1) / unit;
    c.bw_alloc = mcux_ * c.h;
    c.bh_alloc = mcuy_ * c.v;
    if (lossless_) {
      c.diff.assign((size_t)c.bw_alloc * c.bh_alloc, 0);
      c.samples.assign((size_t)c.bw_alloc * c.bh_alloc, 0);
    } else {
      c.coef.assign((size_t)c.bw_alloc * c.bh_alloc * 64, 0);
    }
    for (int k = 0; k < 64; k++) c.coef_bits[k] = -1;
  }
  frame_ = true;
}

void Decoder::read_dqt(size_t end) {
  while (pos_ < end) {
    int pq = u8();
    int t = pq & 15, prec = pq >> 4;
    if (t > 3) throw Error("corrupt JPEG: bad quantization table");
    for (int k = 0; k < 64; k++)
      qt_[t][kNatural[k]] = prec ? u16() : u8();
    qt_defined_[t] = true;
  }
}

void Decoder::read_dht(size_t end) {
  while (pos_ < end) {
    int tc = u8();
    int cls = tc >> 4, t = tc & 15;
    if (t > 3 || cls > 1) throw Error("corrupt JPEG: bad Huffman table");
    uint8_t bits[16], vals[256];
    int total = 0;
    for (int i = 0; i < 16; i++) total += bits[i] = (uint8_t)u8();
    if (total > 256) throw Error("corrupt JPEG: bad Huffman table");
    for (int i = 0; i < total; i++) vals[i] = (uint8_t)u8();
    (cls ? ac_[t] : dc_[t]).build(bits, vals, total);
  }
}

void Decoder::read_app(int marker, size_t end) {
  size_t len = end - pos_;
  const uint8_t* p = data_ + pos_;
  if (marker == 0xE0 && len >= 5 && memcmp(p, "JFIF\0", 5) == 0)
    saw_jfif_ = true;
  if (marker == 0xEE && len >= 12 && memcmp(p, "Adobe", 5) == 0) {
    saw_adobe_ = true;
    adobe_transform_ = p[11];
  }
}

// jdmarker.c get_dac: conditioning of the arithmetic tables
void Decoder::read_dac(size_t end) {
  while (pos_ + 1 < end) {
    int index = u8(), val = u8();
    if (index >= 32) throw Error("corrupt JPEG: bad DAC table");
    if (index >= 16) {
      ac_k_[index - 16] = (uint8_t)val;
    } else {
      dc_l_[index] = (uint8_t)(val & 15);
      dc_u_[index] = (uint8_t)(val >> 4);
      if (dc_l_[index] > dc_u_[index])
        throw Error("corrupt JPEG: bad DAC value");
    }
  }
}

// The end of the entropy-coded data that starts at `from`: the first
// 0xFF (of a run of fill bytes) before a marker other than RSTn; the
// marker's code goes to `marker`.
size_t Decoder::segment_end(size_t from, int* marker) const {
  size_t i = from;
  while (i < n_) {
    if (data_[i] != 0xFF) {
      i++;
      continue;
    }
    size_t j = i + 1;
    while (j < n_ && data_[j] == 0xFF) j++;
    if (j >= n_) break;
    int m = data_[j];
    if (m == 0x00 || (m >= 0xD0 && m <= 0xD7)) {
      i = j + 1;
      continue;
    }
    *marker = m;
    return i;
  }
  *marker = -1;
  return n_;
}

void Decoder::decode_block(Bits& br, Comp& c, int16_t* blk, int ss, int se,
                           int ah, int al) {
  if (!progressive_) {
    int s = br.decode(dc_[c.dc_tbl]);
    int diff = s ? extend(br.get(s), s) : 0;
    c.dc_pred += diff;
    blk[0] = (int16_t)c.dc_pred;
    const Huff& ac = ac_[c.ac_tbl];
    for (int k = 1; k < 64; k++) {
      int rs = br.decode(ac);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = (int16_t)extend(br.get(s), s);
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
    return;
  }
  if (ss == 0) {  // DC scans, first and refine
    if (ah == 0) {
      int s = br.decode(dc_[c.dc_tbl]);
      int diff = s ? extend(br.get(s), s) : 0;
      c.dc_pred += diff;
      blk[0] = (int16_t)(int)((unsigned)c.dc_pred << al);
    } else if (br.get(1)) {
      blk[0] = (int16_t)(blk[0] | (1 << al));
    }
    return;
  }
  const Huff& ac = ac_[c.ac_tbl];
  if (ah == 0) {  // AC first
    if (eobrun_ > 0) {
      eobrun_--;
      return;
    }
    for (int k = ss; k <= se; k++) {
      int rs = br.decode(ac);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = (int16_t)(int)((unsigned)extend(br.get(s), s)
                                          << al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun_ = 1 << r;
        if (r) eobrun_ += br.get(r);
        eobrun_--;
        break;
      }
    }
    return;
  }
  // AC refine (jdphuff.c decode_mcu_AC_refine)
  int p1 = 1 << al, m1 = (int)(~0u << al);
  int k = ss;
  if (eobrun_ == 0) {
    for (; k <= se; k++) {
      int rs = br.decode(ac);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        s = br.get(1) ? p1 : m1;
      } else if (r != 15) {
        eobrun_ = 1 << r;
        if (r) eobrun_ += br.get(r);
        break;
      }
      do {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0) {
          if (br.get(1) && (*coef & p1) == 0)
            *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
        } else if (--r < 0) {
          break;
        }
        k++;
      } while (k <= se);
      if (s) blk[kNatural[k]] = (int16_t)s;
    }
  }
  if (eobrun_ > 0) {
    for (; k <= se; k++) {
      int16_t* coef = blk + kNatural[k];
      if (*coef != 0 && br.get(1) && (*coef & p1) == 0)
        *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
    }
    eobrun_--;
  }
}

// MCUs [first, first + count) of a scan of `total` MCUs.
void Decoder::decode_segment(Bits& br, Comp** sc, int ns, int ss, int se,
                             int ah, int al, long first, long count,
                             long total) {
  if (lossless_) {
    lossless_diffs(br, sc, ns, first, count, total);
    return;
  }
  for (int i = 0; i < ns; i++) sc[i]->dc_pred = 0;
  eobrun_ = 0;
  long stop = std::min(first + count, total);
  for (long m = first; m < stop; m++) {
    if (ns == 1) {
      Comp& c = *sc[0];
      int by = (int)(m / c.bw), bx = (int)(m % c.bw);
      decode_block(br, c, c.block(by, bx), ss, se, ah, al);
      continue;
    }
    int my = (int)(m / mcux_), mx = (int)(m % mcux_);
    for (int i = 0; i < ns; i++) {
      Comp& c = *sc[i];
      for (int yy = 0; yy < c.v; yy++)
        for (int xx = 0; xx < c.h; xx++)
          decode_block(br, c, c.block(my * c.v + yy, mx * c.h + xx), ss, se,
                       ah, al);
    }
  }
}

// jdlhuff.c decode_mcus: each sample's difference, Huffman-coded through
// the scan's DC tables (SSSS 16: 32768, no extra bits), into the
// components' difference planes
void Decoder::lossless_diffs(Bits& br, Comp** sc, int ns, long first,
                             long count, long total) {
  auto diff = [&](Comp& c) {
    int s = br.decode(dc_[c.dc_tbl]);
    if (s == 16) return 32768;
    if (s > 16) throw Error("corrupt JPEG: bad lossless difference");
    return s ? extend(br.get(s), s) : 0;
  };
  long stop = std::min(first + count, total);
  for (long m = first; m < stop; m++) {
    if (ns == 1) {
      Comp& c = *sc[0];
      c.diff[(size_t)(m / c.bw) * c.bw_alloc + m % c.bw] = diff(c);
      continue;
    }
    int my = (int)(m / mcux_), mx = (int)(m % mcux_);
    for (int i = 0; i < ns; i++) {
      Comp& c = *sc[i];
      for (int yy = 0; yy < c.v; yy++) {
        int32_t* row = c.diff.data() + (size_t)(my * c.v + yy) * c.bw_alloc;
        for (int xx = 0; xx < c.h; xx++) row[mx * c.h + xx] = diff(c);
      }
    }
  }
}

// jdpred.c: the predictors of a row that is not the first of its scan or
// restart interval (Ra left, Rb above, Rc above-left)
template <int P>
void undifference_row(const int32_t* d, const int* prev, int* out, int w) {
  int rb = prev[0], ra = (d[0] + rb) & 0xFFFF;
  out[0] = ra;
  for (int x = 1; x < w; x++) {
    int rc = rb;
    rb = prev[x];
    int pred = P == 1   ? ra
               : P == 2 ? rb
               : P == 3 ? rc
               : P == 4 ? ra + rb - rc
               : P == 5 ? ra + ((rb - rc) >> 1)
               : P == 6 ? rb + ((ra - rc) >> 1)
                        : (ra + rb) >> 1;
    out[x] = ra = (d[x] + pred) & 0xFFFF;
  }
}

// jdpred.c and jdlossls.c: a component's differences to samples. The
// first row of the scan and of each restart interval predicts from the
// left (its first sample from 2^(7 - Pt)), the first sample of the other
// rows from above; then the point transform: samples << Pt, kept to 8
// bits as libjpeg's JSAMPLE keeps them. jddiffct.c undifferences an iMCU
// row (the component's v rows, fewer in the last) after decoding all of
// it, so a restart before any of those rows resets the predictor at their
// first row: in a non-interleaved scan of v > 1 that need not be the
// restart's own row.
void Decoder::undifference(Comp& c, int psv, int pt, long restart_rows) {
  static void (*const rows[8])(const int32_t*, const int*, int*, int) = {
      nullptr,                undifference_row<1>, undifference_row<2>,
      undifference_row<3>,    undifference_row<4>, undifference_row<5>,
      undifference_row<6>,    undifference_row<7>};
  const int w = c.dw;
  std::vector<int> prev(w), cur(w);
  for (int y = 0; y < c.dh; y++) {
    const int32_t* d = c.diff.data() + (size_t)y * c.bw_alloc;
    if (y == 0 || (restart_rows && y % c.v == 0 &&
                   (y + restart_rows - 1) / restart_rows * restart_rows <
                       std::min(y + c.v, c.dh))) {
      int ra = (d[0] + (1 << (7 - pt))) & 0xFFFF;
      cur[0] = ra;
      for (int x = 1; x < w; x++) cur[x] = ra = (d[x] + ra) & 0xFFFF;
    } else {
      rows[psv](d, prev.data(), cur.data(), w);
    }
    uint8_t* out = c.samples.data() + (size_t)y * c.bw_alloc;
    for (int x = 0; x < w; x++) out[x] = (uint8_t)(cur[x] << pt);
    std::swap(prev, cur);
  }
}

// jdarith.c: one block of an arithmetic-coded scan (decode_mcu,
// decode_mcu_DC_first, _DC_refine, _AC_first, _AC_refine). A bad code
// sets ct to -1, and libjpeg decodes nothing more until the next restart.
void Decoder::arith_block(Arith& ar, Comp& c, int16_t* blk, int ss, int se,
                          int ah, int al) {
  if (progressive_ && ss == 0 && ah != 0) {  // DC refine
    if (ar.decode(fixed_bin_)) blk[0] = (int16_t)(blk[0] | (1 << al));
    return;
  }
  if (!progressive_ || ss == 0) {  // DC: Figures F.19-F.24
    const int t = c.dc_tbl;
    uint8_t* st = dc_stats_[t] + c.dc_context;
    if (ar.decode(st) == 0) {
      c.dc_context = 0;
    } else {
      int sign = ar.decode(st + 1);
      st += 2 + sign;
      int m = ar.decode(st);
      if (m != 0) {
        st = dc_stats_[t] + 20;
        while (ar.decode(st)) {
          if ((m <<= 1) == 0x8000) {
            ar.ct = -1;
            return;
          }
          st += 1;
        }
      }
      if (m < (int)((1L << dc_l_[t]) >> 1))
        c.dc_context = 0;
      else if (m > (int)((1L << dc_u_[t]) >> 1))
        c.dc_context = 12 + sign * 4;
      else
        c.dc_context = 4 + sign * 4;
      int v = m;
      st += 14;
      while (m >>= 1)
        if (ar.decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      c.dc_pred = (c.dc_pred + v) & 0xFFFF;
    }
    blk[0] = (int16_t)(int)((unsigned)c.dc_pred << al);
    if (progressive_) return;
    ss = 1;
    se = 63;
  }
  uint8_t* stats = ac_stats_[c.ac_tbl];
  if (ah == 0) {  // AC, sequential or first: Figure F.20
    for (int k = ss; k <= se; k++) {
      uint8_t* st = stats + 3 * (k - 1);
      if (ar.decode(st)) break;  // EOB
      while (ar.decode(st + 1) == 0) {
        st += 3;
        if (++k > se) {
          ar.ct = -1;
          return;
        }
      }
      int sign = ar.decode(fixed_bin_);
      st += 2;
      int m = ar.decode(st);
      if (m != 0 && ar.decode(st)) {
        m <<= 1;
        st = stats + (k <= ac_k_[c.ac_tbl] ? 189 : 217);
        while (ar.decode(st)) {
          if ((m <<= 1) == 0x8000) {
            ar.ct = -1;
            return;
          }
          st += 1;
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1)
        if (ar.decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      blk[kNatural[k]] = (int16_t)(int)((unsigned)v << al);
    }
    return;
  }
  // AC refine: bits of coefficients already nonzero, and new ones of +-1
  const int p1 = 1 << al, m1 = (int)(~0u << al);
  int kex = se;
  for (; kex > 0; kex--)
    if (blk[kNatural[kex]]) break;
  for (int k = ss; k <= se; k++) {
    uint8_t* st = stats + 3 * (k - 1);
    if (k > kex && ar.decode(st)) break;  // EOB
    for (;;) {
      int16_t* coef = blk + kNatural[k];
      if (*coef) {
        if (ar.decode(st + 2))
          *coef = (int16_t)(*coef < 0 ? *coef + m1 : *coef + p1);
        break;
      }
      if (ar.decode(st + 1)) {
        *coef = (int16_t)(ar.decode(fixed_bin_) ? m1 : p1);
        break;
      }
      st += 3;
      if (++k > se) {
        ar.ct = -1;
        return;
      }
    }
  }
}

// An arithmetic-coded scan of `total` MCUs from pos_ (just past its SOS
// header); restarts reset the statistics and the decoder
// (jdarith.c process_restart). Raises where PIL's decoder would run out
// of data (the rule at the top of this file).
void Decoder::arith_scan(Comp** sc, int ns, int ss, int se, int ah, int al,
                         long total) {
  const size_t header_end = pos_;
  Arith ar(data_, n_, pos_);
  const bool dc = !progressive_ || (ss == 0 && ah == 0);
  const bool ac = !progressive_ || ss > 0;
  auto reset = [&]() {
    for (int i = 0; i < ns; i++) {
      Comp& c = *sc[i];
      if (dc) {
        memset(dc_stats_[c.dc_tbl], 0, sizeof(dc_stats_[0]));
        c.dc_pred = 0;
        c.dc_context = 0;
      }
      if (ac) memset(ac_stats_[c.ac_tbl], 0, sizeof(ac_stats_[0]));
    }
    ar.reset();
  };
  reset();
  long togo = restart_interval_;
  int next_rst = 0;
  const bool dc_refine = progressive_ && ss == 0 && ah != 0;
  for (long m = 0; m < total; m++) {
    if (restart_interval_) {
      if (togo == 0) {  // jdmarker.c read_restart_marker
        int marker = ar.marker ? ar.marker : ar.next_marker();
        if (marker != 0xD0 + next_rst)
          throw Error("corrupt JPEG: restart marker out of place");
        ar.marker = 0;
        next_rst = (next_rst + 1) & 7;
        reset();
        togo = restart_interval_;
      }
      togo--;
    }
    if (ar.ct == -1 && !dc_refine) continue;
    if (ns == 1) {
      Comp& c = *sc[0];
      arith_block(ar, c, c.block((int)(m / c.bw), (int)(m % c.bw)), ss, se,
                  ah, al);
      continue;
    }
    int my = (int)(m / mcux_), mx = (int)(m % mcux_);
    for (int i = 0; i < ns && (ar.ct != -1 || dc_refine); i++) {
      Comp& c = *sc[i];
      for (int yy = 0; yy < c.v; yy++)
        for (int xx = 0; xx < c.h; xx++)
          if (ar.ct != -1 || dc_refine)
            arith_block(ar, c, c.block(my * c.v + yy, mx * c.h + xx), ss,
                        se, ah, al);
    }
  }
  const size_t limit =
      std::min((header_end + 65535) / 65536 * 65536, n_);
  if (ar.fetched() > limit)
    throw Error("unsupported JPEG: arithmetic-coded scan " +
                std::to_string(scans_) + " (header ends at byte " +
                std::to_string(header_end) + ") reads up to byte " +
                std::to_string(ar.fetched()) + ", past " +
                std::to_string(limit) +
                " (the end of PIL's 65536-byte read block or of the file): "
                "PIL cannot read it");
}

void Decoder::read_scan() {
  if (!frame_) throw Error("corrupt JPEG: scan before frame");
  u16();
  int ns = u8();
  if (ns < 1 || ns > ncomp_) throw Error("corrupt JPEG: bad scan");
  Comp* sc[4];
  for (int i = 0; i < ns; i++) {
    int id = u8(), t = u8();
    Comp* c = nullptr;
    for (int k = 0; k < ncomp_; k++)
      if (comp_[k].id == id) c = &comp_[k];
    if (c == nullptr) throw Error("corrupt JPEG: scan names no component");
    c->dc_tbl = t >> 4;
    c->ac_tbl = t & 15;
    if (!arith_ && (c->dc_tbl > 3 || c->ac_tbl > 3))
      throw Error("corrupt JPEG: bad scan");
    sc[i] = c;
  }
  // jdinput.c per_scan_setup: D_MAX_BLOCKS_IN_MCU
  int blocks = 0;
  for (int i = 0; i < ns && ns > 1; i++) blocks += sc[i]->h * sc[i]->v;
  if (blocks > 10)
    throw Error("corrupt JPEG: sampling factors too large for an "
                "interleaved scan (" + std::to_string(blocks) +
                " blocks in an MCU, at most 10)");
  int ss = u8(), se = u8(), a = u8();
  int ah = a >> 4, al = a & 15;
  scans_++;
  // jdinput.c latch_quant_tables: a component keeps the table of its
  // first scan
  for (int i = 0; i < ns; i++) {
    Comp& c = *sc[i];
    if (!c.latched && !lossless_) {
      if (!qt_defined_[c.tq])
        throw Error("corrupt JPEG: undefined quantization table");
      memcpy(c.quant, qt_[c.tq], sizeof(c.quant));
    }
    c.latched = true;
  }
  if (lossless_) {  // Ss: the predictor, Al: the point transform
    if (ss < 1 || ss > 7 || se != 0 || ah != 0 || al > 7)
      throw Error("corrupt JPEG: bad lossless scan parameters");
  } else if (progressive_) {
    bool dc = ss == 0;
    if (dc ? se != 0 : (se < ss || se > 63 || ns != 1) || al > 13)
      throw Error("corrupt JPEG: bad progression parameters");
    for (int i = 0; i < ns; i++)
      for (int k = ss; k <= se; k++) sc[i]->coef_bits[k] = al;
  } else {
    ss = 0;
    se = 63;
    ah = al = 0;
  }
  for (int i = 0; i < ns && !arith_; i++) {
    Comp& c = *sc[i];
    bool need_dc = lossless_ || !progressive_ || (ss == 0 && ah == 0);
    bool need_ac = !lossless_ && (!progressive_ || ss > 0);
    if ((need_dc && !dc_[c.dc_tbl].defined) ||
        (need_ac && !ac_[c.ac_tbl].defined))
      throw Error("corrupt JPEG: undefined Huffman table");
  }
  long total = ns == 1 ? (long)sc[0]->bw * sc[0]->bh : (long)mcux_ * mcuy_;
  if (arith_) {
    size_t start = pos_;
    arith_scan(sc, ns, ss, se, ah, al, total);
    int marker;
    pos_ = segment_end(start, &marker);
    return;
  }
  long interval = restart_interval_ ? restart_interval_ : total;
  // lossless: libjpeg-turbo restarts at whole MCU rows only (jdlossls.c)
  const long per_row = ns == 1 ? sc[0]->bw : mcux_;
  if (lossless_ && restart_interval_ % per_row)
    throw Error("corrupt JPEG: lossless restart interval " +
                std::to_string(restart_interval_) +
                " is not a whole number of MCU rows of " +
                std::to_string(per_row));
  // the restart intervals: RSTn markers split the entropy-coded data
  size_t start = pos_;
  int marker;
  size_t end = segment_end(start, &marker);
  long first = 0;
  size_t a0 = start;
  while (first < total) {
    size_t b = a0;
    // this interval ends at the next RSTn (or the scan's end)
    size_t stop = end;
    for (size_t i = a0; i + 1 < end; i++) {
      if (data_[i] != 0xFF) continue;
      size_t j = i + 1;
      while (j < end && data_[j] == 0xFF) j++;
      if (j < end && data_[j] >= 0xD0 && data_[j] <= 0xD7) {
        stop = i;
        b = j + 1;
        break;
      }
      i = j;
    }
    Bits br(data_ + a0, data_ + stop);
    decode_segment(br, sc, ns, ss, se, ah, al, first, interval, total);
    first += interval;
    if (stop == end) break;
    a0 = b;
  }
  pos_ = end;
  for (int i = 0; i < ns && lossless_; i++)
    undifference(*sc[i], ss, al,
                 restart_interval_ / per_row * (ns == 1 ? 1 : sc[i]->v));
}

// ---------------------------------------------------------------- output

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
#define DESCALE(x, n) (((x) + ((int64_t)1 << ((n) - 1))) >> (n))

inline uint8_t clamp_idct(int64_t v) {
  // the post-IDCT range limit, centred: libjpeg-turbo's SIMD paths
  // saturate where the C table wraps past +-512 (never on real data)
  v += 128;
  return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
}

// jidctint.c jpeg_idct_islow on one block of quantized coefficients
void idct_islow(const int16_t* in, const int* q, uint8_t* out, int stride) {
  int64_t ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* ip = in + c;
    const int* qp = q + c;
    int64_t* wp = ws + c;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 &&
        ip[40] == 0 && ip[48] == 0 && ip[56] == 0) {
      int64_t dc = (int64_t)ip[0] * qp[0] * (1 << PASS1_BITS);
      for (int r = 0; r < 8; r++) wp[r * 8] = dc;
      continue;
    }
    int64_t z2 = (int64_t)ip[16] * qp[16], z3 = (int64_t)ip[48] * qp[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = (int64_t)ip[0] * qp[0];
    z3 = (int64_t)ip[32] * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
    int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = (int64_t)ip[56] * qp[56];
    tmp1 = (int64_t)ip[40] * qp[40];
    tmp2 = (int64_t)ip[24] * qp[24];
    tmp3 = (int64_t)ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = CONST_BITS - PASS1_BITS;
    wp[0] = (int)DESCALE(tmp10 + tmp3, sh);
    wp[56] = (int)DESCALE(tmp10 - tmp3, sh);
    wp[8] = (int)DESCALE(tmp11 + tmp2, sh);
    wp[48] = (int)DESCALE(tmp11 - tmp2, sh);
    wp[16] = (int)DESCALE(tmp12 + tmp1, sh);
    wp[40] = (int)DESCALE(tmp12 - tmp1, sh);
    wp[24] = (int)DESCALE(tmp13 + tmp0, sh);
    wp[32] = (int)DESCALE(tmp13 - tmp0, sh);
  }
  for (int r = 0; r < 8; r++) {
    const int64_t* wp = ws + r * 8;
    uint8_t* op = out + (size_t)r * stride;
    const int sh = CONST_BITS + PASS1_BITS + 3;
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (wp[0] + wp[4]) * (1 << CONST_BITS);
    int64_t tmp1 = (wp[0] - wp[4]) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    op[0] = clamp_idct(DESCALE(tmp10 + tmp3, sh));
    op[7] = clamp_idct(DESCALE(tmp10 - tmp3, sh));
    op[1] = clamp_idct(DESCALE(tmp11 + tmp2, sh));
    op[6] = clamp_idct(DESCALE(tmp11 - tmp2, sh));
    op[2] = clamp_idct(DESCALE(tmp12 + tmp1, sh));
    op[5] = clamp_idct(DESCALE(tmp12 - tmp1, sh));
    op[3] = clamp_idct(DESCALE(tmp13 + tmp0, sh));
    op[4] = clamp_idct(DESCALE(tmp13 - tmp0, sh));
  }
}

// jdcoefct.c smoothing_ok: progressive, every first-ten quantizer
// nonzero, DC known, and some of the first nine AC coefficients not yet
// exact
bool Decoder::smoothing_ok() {
  if (!progressive_) return false;
  static const int pos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
  bool useful = false;
  for (int i = 0; i < ncomp_; i++) {
    Comp& c = comp_[i];
    if (!c.latched) return false;
    for (int k = 0; k < 10; k++)
      if (c.quant[pos[k]] == 0) return false;
    if (c.coef_bits[0] < 0) return false;
    for (int k = 1; k < 10; k++)
      if (c.coef_bits[k] != 0) useful = true;
  }
  return useful;
}

inline int smooth_pred(int64_t num, int64_t q, int al) {
  int pred;
  if (num >= 0) {
    pred = (int)(((q << 7) + num) / (q << 8));
    if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
  } else {
    pred = (int)(((q << 7) - num) / (q << 8));
    if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
    pred = -pred;
  }
  return pred;
}

// The component's samples: every real block through the IDCT, with
// jdcoefct.c decompress_smooth_data's estimates where `smooth`.
void Decoder::idct_plane(Comp& c, bool smooth, std::vector<uint8_t>& plane) {
  const int stride = c.bw_alloc * 8;
  plane.assign((size_t)stride * c.bh_alloc * 8, 0);
  const int* qt = c.quant;
  const int64_t Q00 = qt[0], Q01 = qt[1], Q10 = qt[8], Q20 = qt[16],
                Q11 = qt[9], Q02 = qt[2], Q03 = qt[3], Q12 = qt[10],
                Q21 = qt[17], Q30 = qt[24];
  const int* cb = c.coef_bits;
  const bool change_dc = cb[1] == -1 && cb[2] == -1 && cb[3] == -1 &&
                         cb[4] == -1 && cb[5] == -1 && cb[6] == -1 &&
                         cb[7] == -1 && cb[8] == -1 && cb[9] == -1;
  const int last_col = c.bw - 1;
  int16_t ws[64];
  for (int r = 0; r < mcuy_; r++) {
    int block_rows = c.v;
    if (r == mcuy_ - 1) {
      block_rows = c.bh % c.v;
      if (block_rows == 0) block_rows = c.v;
    }
    const int image_block_rows = block_rows * mcuy_;
    for (int br = 0; br < block_rows; br++) {
      const int row = r * c.v + br;
      const int ibr = r * block_rows + br;
      uint8_t* out_row = plane.data() + (size_t)row * 8 * stride;
      if (!smooth) {
        for (int bx = 0; bx < c.bw; bx++)
          idct_islow(c.block(row, bx), qt, out_row + bx * 8, stride);
        continue;
      }
      int prev = ibr > 0 ? row - 1 : row;
      int prev2 = ibr > 1 ? row - 2 : prev;
      int next = ibr < image_block_rows - 1 ? row + 1 : row;
      int next2 = ibr < image_block_rows - 2 ? row + 2 : next;
      const int rows5[5] = {prev2, prev, row, next, next2};
      for (int bx = 0; bx < c.bw; bx++) {
        int dc[26];
        for (int i = 0; i < 5; i++)
          for (int j = 0; j < 5; j++) {
            int col = std::min(std::max(bx + j - 2, 0), last_col);
            dc[1 + i * 5 + j] = c.block(rows5[i], col)[0];
          }
        const int DC01 = dc[1], DC02 = dc[2], DC03 = dc[3], DC04 = dc[4],
                  DC05 = dc[5], DC06 = dc[6], DC07 = dc[7], DC08 = dc[8],
                  DC09 = dc[9], DC10 = dc[10], DC11 = dc[11], DC12 = dc[12],
                  DC13 = dc[13], DC14 = dc[14], DC15 = dc[15], DC16 = dc[16],
                  DC17 = dc[17], DC18 = dc[18], DC19 = dc[19], DC20 = dc[20],
                  DC21 = dc[21], DC22 = dc[22], DC23 = dc[23], DC24 = dc[24],
                  DC25 = dc[25];
        memcpy(ws, c.block(row, bx), sizeof(ws));
        int al;
        int64_t num;
        if ((al = cb[1]) != 0 && ws[1] == 0) {
          num = Q00 * (change_dc
                           ? (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 +
                              13 * DC07 - 13 * DC09 + 3 * DC10 - 3 * DC11 +
                              38 * DC12 - 38 * DC14 + 3 * DC15 - 3 * DC16 +
                              13 * DC17 - 13 * DC19 + 3 * DC20 - DC21 -
                              DC22 + DC24 + DC25)
                           : (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15));
          ws[1] = (int16_t)smooth_pred(num, Q01, al);
        }
        if ((al = cb[2]) != 0 && ws[8] == 0) {
          num = Q00 * (change_dc
                           ? (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 -
                              DC06 + 13 * DC07 + 38 * DC08 + 13 * DC09 -
                              DC10 + DC16 - 13 * DC17 - 38 * DC18 -
                              13 * DC19 + DC20 + DC21 + 3 * DC22 + 3 * DC23 +
                              3 * DC24 + DC25)
                           : (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23));
          ws[8] = (int16_t)smooth_pred(num, Q10, al);
        }
        if ((al = cb[3]) != 0 && ws[16] == 0) {
          num = Q00 * (change_dc
                           ? (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 -
                              5 * DC12 - 14 * DC13 - 5 * DC14 + 2 * DC17 +
                              7 * DC18 + 2 * DC19 + DC23)
                           : (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 -
                              DC23));
          ws[16] = (int16_t)smooth_pred(num, Q20, al);
        }
        if ((al = cb[4]) != 0 && ws[9] == 0) {
          num = Q00 * (change_dc
                           ? (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 +
                              9 * DC19 + DC21 - DC25)
                           : (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 -
                              DC20 + DC22 - DC24 + DC04 - DC06 + 10 * DC07 -
                              10 * DC09));
          ws[9] = (int16_t)smooth_pred(num, Q11, al);
        }
        if ((al = cb[5]) != 0 && ws[2] == 0) {
          num = Q00 * (change_dc
                           ? (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 +
                              7 * DC12 - 14 * DC13 + 7 * DC14 + DC15 +
                              2 * DC17 - 5 * DC18 + 2 * DC19)
                           : (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 -
                              DC15));
          ws[2] = (int16_t)smooth_pred(num, Q02, al);
        }
        if (change_dc) {
          if ((al = cb[6]) != 0 && ws[3] == 0) {
            num = Q00 * (DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19);
            ws[3] = (int16_t)smooth_pred(num, Q03, al);
          }
          if ((al = cb[7]) != 0 && ws[10] == 0) {
            num = Q00 * (DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19);
            ws[10] = (int16_t)smooth_pred(num, Q12, al);
          }
          if ((al = cb[8]) != 0 && ws[17] == 0) {
            num = Q00 * (DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19);
            ws[17] = (int16_t)smooth_pred(num, Q21, al);
          }
          if ((al = cb[9]) != 0 && ws[24] == 0) {
            num = Q00 * (DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19);
            ws[24] = (int16_t)smooth_pred(num, Q30, al);
          }
          num = Q00 * (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 -
                       6 * DC06 + 6 * DC07 + 42 * DC08 + 6 * DC09 -
                       6 * DC10 - 8 * DC11 + 42 * DC12 + 152 * DC13 +
                       42 * DC14 - 8 * DC15 - 6 * DC16 + 6 * DC17 +
                       42 * DC18 + 6 * DC19 - 6 * DC20 - 2 * DC21 -
                       6 * DC22 - 8 * DC23 - 6 * DC24 - 2 * DC25);
          int pred;
          if (num >= 0) {
            pred = (int)(((Q00 << 7) + num) / (Q00 << 8));
          } else {
            pred = (int)(((Q00 << 7) - num) / (Q00 << 8));
            pred = -pred;
          }
          ws[0] = (int16_t)pred;
        }
        idct_islow(ws, qt, out_row + bx * 8, stride);
      }
    }
  }
}

// jdsample.c: one component's samples to the full grid, rows clamped to
// the component's real rows above and below (jdmainct.c's context rows);
// without `fancy`, by replication
void upsample(const uint8_t* in, int in_stride, int dw, int dh, int hexp,
              int vexp, bool fancy, uint8_t* out, int width, int height) {
  auto src = [&](int y) {
    y = std::min(std::max(y, 0), dh - 1);
    return in + (size_t)y * in_stride;
  };
  std::vector<uint8_t> tmp((size_t)dw * hexp + 8);
  for (int y = 0; y < height; y++) {
    uint8_t* o = out + (size_t)y * width;
    uint8_t* t = tmp.data();
    if (hexp == 1 && vexp == 1) {
      memcpy(o, src(y), width);
      continue;
    }
    if (!fancy) {  // h2v1_upsample, h2v2_upsample, int_upsample
      const uint8_t* p = src(y / vexp);
      for (int x = 0; x < dw; x++)
        for (int k = 0; k < hexp; k++) t[x * hexp + k] = p[x];
    } else if (hexp == 2 && vexp == 1 && dw > 2) {  // h2v1_fancy_upsample
      const uint8_t* p = src(y);
      t[0] = p[0];
      t[1] = (uint8_t)((p[0] * 3 + p[1] + 2) >> 2);
      for (int x = 1; x < dw - 1; x++) {
        int v = p[x] * 3;
        t[2 * x] = (uint8_t)((v + p[x - 1] + 1) >> 2);
        t[2 * x + 1] = (uint8_t)((v + p[x + 1] + 2) >> 2);
      }
      int v = p[dw - 1];
      t[2 * dw - 2] = (uint8_t)((v * 3 + p[dw - 2] + 1) >> 2);
      t[2 * dw - 1] = (uint8_t)v;
    } else if (hexp == 1 && vexp == 2) {  // h1v2_fancy_upsample
      int iy = y >> 1;
      bool below = y & 1;
      const uint8_t* p0 = src(iy);
      const uint8_t* p1 = src(below ? iy + 1 : iy - 1);
      int bias = below ? 2 : 1;
      for (int x = 0; x < dw; x++)
        t[x] = (uint8_t)((p0[x] * 3 + p1[x] + bias) >> 2);
    } else if (hexp == 2 && vexp == 2 && dw > 2) {  // h2v2_fancy_upsample
      int iy = y >> 1;
      bool below = y & 1;
      const uint8_t* p0 = src(iy);
      const uint8_t* p1 = src(below ? iy + 1 : iy - 1);
      int last = p0[0] * 3 + p1[0];
      int cur = last;
      int next = p0[1] * 3 + p1[1];
      t[0] = (uint8_t)((cur * 4 + 8) >> 4);
      t[1] = (uint8_t)((cur * 3 + next + 7) >> 4);
      last = cur;
      cur = next;
      for (int x = 1; x < dw - 1; x++) {
        next = p0[x + 1] * 3 + p1[x + 1];
        t[2 * x] = (uint8_t)((cur * 3 + last + 8) >> 4);
        t[2 * x + 1] = (uint8_t)((cur * 3 + next + 7) >> 4);
        last = cur;
        cur = next;
      }
      t[2 * dw - 2] = (uint8_t)((cur * 3 + last + 8) >> 4);
      t[2 * dw - 1] = (uint8_t)((cur * 4 + 7) >> 4);
    } else {  // h2v1_upsample, h2v2_upsample, int_upsample
      const uint8_t* p = src(y / vexp);
      for (int x = 0; x < dw; x++)
        for (int k = 0; k < hexp; k++) t[x * hexp + k] = p[x];
    }
    memcpy(o, t, width);
  }
}

void Decoder::output(uint8_t* out, bool gray) {
  bool smooth = smoothing_ok();
  std::vector<uint8_t> full[4];
  for (int i = 0; i < ncomp_; i++) {
    Comp& c = comp_[i];
    if (!c.latched) throw Error("corrupt JPEG: a component has no scan");
    if (hmax_ % c.h || vmax_ % c.v)
      throw Error("unsupported JPEG: fractional sampling factors");
    std::vector<uint8_t> idct;
    if (!lossless_) idct_plane(c, smooth, idct);
    const uint8_t* plane = lossless_ ? c.samples.data() : idct.data();
    const int stride = lossless_ ? c.bw_alloc : c.bw_alloc * 8;
    if (c.h == hmax_ && c.v == vmax_ && ncomp_ == 1) {
      for (int y = 0; y < height_; y++)
        memcpy(out + (size_t)y * width_, plane + (size_t)y * stride, width_);
      return;
    }
    full[i].resize((size_t)width_ * height_);
    upsample(plane, stride, c.dw, c.dh, hmax_ / c.h, vmax_ / c.v,
             !lossless_, full[i].data(), width_, height_);
  }
  // libjpeg's colour space (jdapimin.c default_decompress_parms; a
  // lossless file without JFIF or Adobe marker is RGB)
  bool rgb = false;
  if (!saw_jfif_) {
    if (saw_adobe_)
      rgb = adobe_transform_ == 0;
    else
      rgb = lossless_ ||
            (comp_[0].id == 82 && comp_[1].id == 71 && comp_[2].id == 66);
  }
  // jdcolor.c build_ycc_rgb_table, SCALEBITS 16
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  const int64_t one_half = (int64_t)1 << 15;
  for (int i = 0, x = -128; i < 256; i++, x++) {
    cr_r[i] = (int)((91881 * (int64_t)x + one_half) >> 16);
    cb_b[i] = (int)((116130 * (int64_t)x + one_half) >> 16);
    cr_g[i] = -46802 * (int64_t)x;
    cb_g[i] = -22554 * (int64_t)x + one_half;
  }
  auto lim = [](int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); };
  const size_t n = (size_t)width_ * height_;
  const uint8_t *p0 = full[0].data(), *p1 = full[1].data(),
                *p2 = full[2].data(), *p3 = full[3].data();
  // four components: jdapimin.c takes YCCK where an Adobe marker's
  // transform is not 0, else CMYK
  const bool ycck = ncomp_ == 4 && saw_adobe_ && adobe_transform_ != 0;
  if (lossless_ && ((ncomp_ == 3 && !rgb) || ycck))
    throw Error(std::string("unsupported JPEG: lossless ") +
                (ycck ? "YCCK" : "YCbCr") +
                " (libjpeg-turbo converts no colour in lossless mode): PIL "
                "cannot read it");
  for (size_t i = 0; i < n; i++) {
    int r, g, b;
    if (ncomp_ == 4) {
      int c = p0[i], m = p1[i], yy = p2[i];
      if (ycck) {  // jdcolor.c ycck_cmyk_convert
        int y = p0[i], cb = p1[i], cr = p2[i];
        c = 255 - lim(y + cr_r[cr]);
        m = 255 - lim(y + (int)((cb_g[cb] + cr_g[cr]) >> 16));
        yy = 255 - lim(y + cb_b[cb]);
      }
      // PIL's "CMYK;I" (each sample inverted), then Pillow's cmyk2rgb:
      // nk - nk * v / 255 with MULDIV255's rounding
      int nk = p3[i];
      auto part = [nk, &lim](int v) {
        int t = (255 - v) * nk + 128;
        return lim(nk - (((t >> 8) + t) >> 8));
      };
      r = part(c);
      g = part(m);
      b = part(yy);
    } else if (rgb) {
      r = p0[i];
      g = p1[i];
      b = p2[i];
    } else {
      int y = p0[i], cb = p1[i], cr = p2[i];
      r = lim(y + cr_r[cr]);
      g = lim(y + (int)((cb_g[cb] + cr_g[cr]) >> 16));
      b = lim(y + cb_b[cb]);
    }
    if (gray) {
      // PIL's RGB -> L (ITU-R 601-2 luma, 16-bit fixed point)
      out[i] = (uint8_t)((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16);
    } else {
      out[3 * i] = (uint8_t)r;
      out[3 * i + 1] = (uint8_t)g;
      out[3 * i + 2] = (uint8_t)b;
    }
  }
}

void Decoder::parse() {
  if (n_ < 4 || data_[0] != 0xFF || data_[1] != 0xD8)
    throw Error("not a JPEG file");
  pos_ = 2;
  for (;;) {
    // the next marker, past fill bytes (and junk, as libjpeg skips it)
    while (pos_ < n_ && data_[pos_] != 0xFF) pos_++;
    while (pos_ < n_ && data_[pos_] == 0xFF) pos_++;
    if (pos_ >= n_) break;  // libjpeg warns and ends the image
    int m = data_[pos_++];
    if (m == 0xD9) break;
    if (m == 0x01 || m == 0xD8 || (m >= 0xD0 && m <= 0xD7)) continue;
    size_t start = pos_;
    size_t len = u16();
    if (len < 2 || start + len > n_) throw Error("corrupt JPEG: bad segment");
    size_t end = start + len;
    switch (m) {
      case 0xC0:
      case 0xC1:
      case 0xC2:
      case 0xC3:
      case 0xC9:
      case 0xCA:
        pos_ = start;
        read_frame(m);
        break;
      case 0xCB:
        throw Error("unsupported JPEG: lossless arithmetic coding (SOF11), "
                    "which PIL cannot read");
      case 0xC5:
      case 0xC6:
      case 0xC7:
      case 0xCD:
      case 0xCE:
      case 0xCF:
        throw Error("unsupported JPEG: hierarchical (differential) frames");
      case 0xCC:
        read_dac(end);
        break;
      case 0xC4:
        read_dht(end);
        break;
      case 0xDB:
        read_dqt(end);
        break;
      case 0xDD:
        restart_interval_ = u16();
        break;
      case 0xDA:
        pos_ = start;
        read_scan();
        continue;  // pos_ is at the marker after the scan
      default:
        if (m >= 0xE0 && m <= 0xEF) read_app(m, end);
        break;
    }
    pos_ = end;
  }
  if (!frame_) throw Error("corrupt JPEG: no frame");
  if (scans_ == 0) throw Error("corrupt JPEG: no scan");
}

void Decoder::decode(uint8_t* out, bool gray) {
  parse();
  output(out, gray);
}

// libjpeg's raw data output (jpeg_read_raw_data): each component's
// samples at its own sampling, ceil(height * v / vmax) rows of
// ceil(width * h / hmax) samples, one plane after another; no upsampling,
// no colour conversion. DCT files only (libjpeg-turbo has no raw output of
// lossless data). -> components; `sampling` gets h, v of each.
int Decoder::planes(uint8_t* out, int* sampling) {
  parse();
  if (lossless_)
    throw Error("unsupported JPEG: raw planes of lossless (SOF3) data");
  bool smooth = smoothing_ok();
  for (int i = 0; i < ncomp_; i++) {
    Comp& c = comp_[i];
    if (!c.latched) throw Error("corrupt JPEG: a component has no scan");
    std::vector<uint8_t> idct;
    idct_plane(c, smooth, idct);
    const int stride = c.bw_alloc * 8;
    for (int y = 0; y < c.dh; y++, out += c.dw)
      memcpy(out, idct.data() + (size_t)y * stride, c.dw);
    sampling[2 * i] = c.h;
    sampling[2 * i + 1] = c.v;
  }
  return ncomp_;
}

}  // namespace

extern "C" {

// Header fields for the caller's buffer: [width, height, components].
int jpeg_info(const uint8_t* data, long n, int* info, char* err, int errlen) {
  try {
    size_t pos = 2;
    if (n < 4 || data[0] != 0xFF || data[1] != 0xD8)
      throw Error("not a JPEG file");
    for (;;) {
      while (pos < (size_t)n && data[pos] != 0xFF) pos++;
      while (pos < (size_t)n && data[pos] == 0xFF) pos++;
      if (pos + 3 > (size_t)n) throw Error("JPEG without a frame header");
      int m = data[pos++];
      if (m == 0x01 || m == 0xD8 || (m >= 0xD0 && m <= 0xD7)) continue;
      if (m == 0xD9) throw Error("JPEG without a frame header");
      size_t len = (data[pos] << 8) | data[pos + 1];
      if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
        if (pos + 8 > (size_t)n) throw Error("JPEG ends early");
        info[1] = (data[pos + 3] << 8) | data[pos + 4];
        info[0] = (data[pos + 5] << 8) | data[pos + 6];
        info[2] = data[pos + 7];
        return 0;
      }
      pos += len;
    }
  } catch (const std::exception& e) {
    snprintf(err, errlen, "%s", e.what());
    return -1;
  }
}

// `out` holds width * height * components bytes (each plane is at most
// the image's size); `sampling` 8 ints.
int jpeg_planes(const uint8_t* data, long n, uint8_t* out, int* sampling,
                char* err, int errlen) {
  try {
    Decoder d(data, (size_t)n);
    return d.planes(out, sampling);
  } catch (const std::bad_alloc&) {
    snprintf(err, errlen, "JPEG too large to decode");
    return -1;
  } catch (const std::exception& e) {
    snprintf(err, errlen, "%s", e.what());
    return -1;
  }
}

int jpeg_decode(const uint8_t* data, long n, uint8_t* out, int gray,
                char* err, int errlen) {
  try {
    Decoder d(data, (size_t)n);
    d.decode(out, gray != 0);
    return d.channels(gray != 0);
  } catch (const std::bad_alloc&) {
    snprintf(err, errlen, "JPEG too large to decode");
    return -1;
  } catch (const std::exception& e) {
    snprintf(err, errlen, "%s", e.what());
    return -1;
  }
}

}  // extern "C"
