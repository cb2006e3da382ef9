// Huffman-coded JPEG decoding (baseline, extended sequential and
// progressive, 8-bit, one, three or four components) that gives the
// pixels libjpeg-turbo gives PIL: ISLOW inverse DCT (jidctint.c), fancy
// upsampling (jdsample.c), the YCbCr tables of jdcolor.c and, where a
// progressive file leaves coefficients unrefined, the block smoothing of
// jdcoefct.c (libjpeg-turbo 2.1 and later). Four components are CMYK,
// or YCCK where an Adobe marker's transform is not 0 (jdcolor.c
// ycck_cmyk_convert), read as PIL reads them ("CMYK;I": every sample
// inverted) and converted to RGB by Pillow's cmyk2rgb. Arithmetic-coded,
// lossless, hierarchical and 12-bit files raise.
//
//   jpeg_decode(data, n, out, gray, err, errlen) -> channels written
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
  int dc_pred = 0;
  int16_t* block(int by, int bx) {
    return coef.data() + ((size_t)by * bw_alloc + bx) * 64;
  }
};

class Decoder {
 public:
  Decoder(const uint8_t* d, size_t n) : data_(d), n_(n) {}

  void decode(uint8_t* out, bool gray);
  int channels(bool gray) const { return (ncomp_ == 1 || gray) ? 1 : 3; }

 private:
  const uint8_t* data_;
  size_t n_;
  size_t pos_ = 0;
  int width_ = 0, height_ = 0, ncomp_ = 0;
  bool progressive_ = false, frame_ = false;
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
  void read_scan();
  size_t segment_end(size_t from, int* marker) const;
  void decode_segment(Bits& br, Comp** sc, int ns, int ss, int se, int ah,
                      int al, long first, long count, long total);
  void decode_block(Bits& br, Comp& c, int16_t* blk, int ss, int se,
                    int ah, int al);
  void output(uint8_t* out, bool gray);
  bool smoothing_ok();
  void idct_plane(Comp& c, bool smooth, std::vector<uint8_t>& plane);
};

void Decoder::read_frame(int marker) {
  if (frame_) throw Error("JPEG with two frames");
  size_t len = u16();
  (void)len;
  int prec = u8();
  if (prec != 8)
    throw Error("unsupported JPEG: " + std::to_string(prec) +
                "-bit samples (the port reads 8-bit JPEGs)");
  height_ = u16();
  width_ = u16();
  ncomp_ = u8();
  if (height_ == 0)
    throw Error("unsupported JPEG: height given by a DNL marker");
  if (width_ == 0) throw Error("corrupt JPEG: width 0");
  if (ncomp_ != 1 && ncomp_ != 3 && ncomp_ != 4)
    throw Error("unsupported JPEG: " + std::to_string(ncomp_) +
                " components");
  progressive_ = marker == 0xC2;
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
  mcux_ = (width_ + hmax_ * 8 - 1) / (hmax_ * 8);
  mcuy_ = (height_ + vmax_ * 8 - 1) / (vmax_ * 8);
  for (int i = 0; i < ncomp_; i++) {
    Comp& c = comp_[i];
    c.dw = (int)(((long)width_ * c.h + hmax_ - 1) / hmax_);
    c.dh = (int)(((long)height_ * c.v + vmax_ - 1) / vmax_);
    c.bw = (c.dw + 7) / 8;
    c.bh = (c.dh + 7) / 8;
    c.bw_alloc = mcux_ * c.h;
    c.bh_alloc = mcuy_ * c.v;
    c.coef.assign((size_t)c.bw_alloc * c.bh_alloc * 64, 0);
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
    if (c->dc_tbl > 3 || c->ac_tbl > 3) throw Error("corrupt JPEG: bad scan");
    sc[i] = c;
  }
  int ss = u8(), se = u8(), a = u8();
  int ah = a >> 4, al = a & 15;
  scans_++;
  // jdinput.c latch_quant_tables: a component keeps the table of its
  // first scan
  for (int i = 0; i < ns; i++) {
    Comp& c = *sc[i];
    if (!c.latched) {
      if (!qt_defined_[c.tq])
        throw Error("corrupt JPEG: undefined quantization table");
      memcpy(c.quant, qt_[c.tq], sizeof(c.quant));
      c.latched = true;
    }
  }
  if (progressive_) {
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
  for (int i = 0; i < ns; i++) {
    Comp& c = *sc[i];
    bool need_dc = !progressive_ || (ss == 0 && ah == 0);
    bool need_ac = !progressive_ || ss > 0;
    if ((need_dc && !dc_[c.dc_tbl].defined) ||
        (need_ac && !ac_[c.ac_tbl].defined))
      throw Error("corrupt JPEG: undefined Huffman table");
  }
  long total = ns == 1 ? (long)sc[0]->bw * sc[0]->bh : (long)mcux_ * mcuy_;
  long interval = restart_interval_ ? restart_interval_ : total;
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
// the component's real rows above and below (jdmainct.c's context rows)
void upsample(const uint8_t* in, int in_stride, int dw, int dh, int hexp,
              int vexp, uint8_t* out, int width, int height) {
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
    if (hexp == 2 && vexp == 1 && dw > 2) {  // h2v1_fancy_upsample
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
    std::vector<uint8_t> plane;
    idct_plane(c, smooth, plane);
    if (c.h == hmax_ && c.v == vmax_ && ncomp_ == 1) {
      for (int y = 0; y < height_; y++)
        memcpy(out + (size_t)y * width_,
               plane.data() + (size_t)y * c.bw_alloc * 8, width_);
      return;
    }
    full[i].resize((size_t)width_ * height_);
    upsample(plane.data(), c.bw_alloc * 8, c.dw, c.dh, hmax_ / c.h,
             vmax_ / c.v, full[i].data(), width_, height_);
  }
  // libjpeg's colour space (jdapimin.c default_decompress_parms)
  bool rgb = false;
  if (!saw_jfif_) {
    if (saw_adobe_)
      rgb = adobe_transform_ == 0;
    else
      rgb = comp_[0].id == 82 && comp_[1].id == 71 && comp_[2].id == 66;
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

void Decoder::decode(uint8_t* out, bool gray) {
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
        pos_ = start;
        read_frame(m);
        break;
      case 0xC3:
        throw Error("unsupported JPEG: lossless (SOF3)");
      case 0xC5:
      case 0xC6:
      case 0xC7:
      case 0xCD:
      case 0xCE:
      case 0xCF:
        throw Error("unsupported JPEG: hierarchical (differential) frames");
      case 0xC9:
      case 0xCA:
      case 0xCB:
      case 0xCC:
        throw Error("unsupported JPEG: arithmetic coding");
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
  output(out, gray);
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
