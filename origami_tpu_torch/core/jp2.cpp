// JPEG 2000 decoding (ITU-T T.800 | ISO/IEC 15444-1) of JP2 files and raw
// codestreams, to the pixels PIL gives (Pillow 12 through OpenJPEG 2.5's
// tile interface, then Pillow's Jpeg2KDecode.c unpackers):
//
//   - tier 2: tiles and tile-parts, packet headers (tag trees, pass
//     counts, Lblock), packed in PPM / PPT too, the five progression
//     orders and progression order changes, precincts, layers, SOP and
//     EPH markers;
//   - tier 1: the MQ decoder, the three coding passes and the code-block
//     styles (selective arithmetic coding bypass, context reset,
//     termination on each pass, vertically causal contexts, predictable
//     termination, segmentation symbols), OpenJPEG's reconstruction (a
//     half step above the last decoded bit plane), ROI shifts;
//   - the inverse 5/3 (integer) and 9/7 DWT, the inverse RCT / ICT, the DC
//     level shift and clamp of opj_tcd_dc_level_shift_decode.
//
// The 9/7 path repeats OpenJPEG's float32 operations in its order (the
// lifting steps of opj_v8dwt_decode, opj_mct_decode_real, the band step
// computed in double then cast to float), so nothing here may be
// contracted into fused multiply-adds: this file turns contraction off.
//
//   jp2_info(data, n, info, err, errlen)  -> 0; info = [width, height,
//                                            channels (1 or 3)]
//   jp2_decode(data, n, out, gray, err, errlen) -> channels written
//
// The output is Pillow's: its mode from the JP2 header or SIZ, each tile
// through its unpacker (sub-sampled colour components, sYCC through its
// YCbCr tables, CMYK through its cmyk2rgb, `pclr` palettes as its palette
// takes them; an ICC profile is not applied). Kinds the port does not decode (e-sYCC and CMYK
// colour, sub-sampled gray, more than four components or 16 bits, HTJ2K
// code-blocks, Part 2 transforms) raise with the kind named.
#pragma GCC optimize("fp-contract=off")

#include <algorithm>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& what) { throw Error(what); }

[[noreturn]] void unsupported(const std::string& kind) {
  fail("unsupported JPEG 2000: " + kind);
}

uint32_t be16(const uint8_t* p) { return (uint32_t)p[0] << 8 | p[1]; }
uint32_t be32(const uint8_t* p) {
  return (uint32_t)p[0] << 24 | (uint32_t)p[1] << 16 | (uint32_t)p[2] << 8 |
         p[3];
}

int64_t ceildiv(int64_t a, int64_t b) {
  return a >= 0 ? (a + b - 1) / b : -((-a) / b);
}
int64_t floordiv(int64_t a, int64_t b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// ------------------------------------------------------------ containers

struct Comp {
  int prec = 8;
  bool sgnd = false;
  int dx = 1, dy = 1;
};

struct Image {
  uint32_t xsiz = 0, ysiz = 0, xo = 0, yo = 0;
  uint32_t xt = 0, yt = 0, xto = 0, yto = 0;
  std::vector<Comp> comps;
};

// What PIL makes of the file's header: its size and mode, the colour space
// OpenJPEG reports, the palette of a `pclr` box.
struct Header {
  const uint8_t* cs = nullptr;
  size_t cs_len = 0;
  int width = 0, height = 0;
  std::string mode;
  int colour = 0;  // 0 unspecified, 1 gray, 2 sRGB, 3 sYCC, 4 CMYK
  uint8_t palette[256 * 3];
};

// The SIZ marker segment of a codestream.
void read_siz(const uint8_t* cs, size_t n, Image& im) {
  if (n < 4 || be16(cs) != 0xFF4F || be16(cs + 2) != 0xFF51)
    fail("corrupt JPEG 2000: no SIZ marker");
  if (n < 6) fail("corrupt JPEG 2000: SIZ past the end");
  size_t len = be16(cs + 4);
  const uint8_t* p = cs + 4;
  if (len < 41 || 4 + len > n) fail("corrupt JPEG 2000: SIZ past the end");
  im.xsiz = be32(p + 4);
  im.ysiz = be32(p + 8);
  im.xo = be32(p + 12);
  im.yo = be32(p + 16);
  im.xt = be32(p + 20);
  im.yt = be32(p + 24);
  im.xto = be32(p + 28);
  im.yto = be32(p + 32);
  int nc = be16(p + 36);
  if (nc < 1 || len < 38 + 3 * (size_t)nc)
    fail("corrupt JPEG 2000: SIZ of " + std::to_string(nc) + " components");
  if (im.xo >= im.xsiz || im.yo >= im.ysiz || im.xt == 0 || im.yt == 0 ||
      im.xto > im.xo || im.yto > im.yo || im.xto + im.xt <= im.xo ||
      im.yto + im.yt <= im.yo)
    fail("corrupt JPEG 2000: SIZ geometry");
  im.comps.resize(nc);
  for (int c = 0; c < nc; c++) {
    const uint8_t* q = p + 38 + 3 * c;
    im.comps[c].prec = (q[0] & 0x7F) + 1;
    im.comps[c].sgnd = q[0] & 0x80;
    im.comps[c].dx = q[1];
    im.comps[c].dy = q[2];
    if (q[1] == 0 || q[2] == 0) fail("corrupt JPEG 2000: sub-sampling 0");
    if (im.comps[c].prec > 38) fail("corrupt JPEG 2000: precision");
  }
}

// Boxes of a JP2 file as PIL's _parse_jp2_header and OpenJPEG read them;
// or a raw codestream.
void read_header(const uint8_t* data, size_t n, Header& h) {
  static const uint8_t kSig[12] = {0, 0, 0, 12, 'j', 'P', ' ', ' ',
                                   0x0D, 0x0A, 0x87, 0x0A};
  memset(h.palette, 0, sizeof(h.palette));
  Image im;
  if (n >= 4 && be16(data) == 0xFF4F && be16(data + 2) == 0xFF51) {
    h.cs = data;
    h.cs_len = n;
    read_siz(data, n, im);
    h.width = (int)(im.xsiz - im.xo);
    h.height = (int)(im.ysiz - im.yo);
    int nc = (int)im.comps.size();
    if (nc == 1)
      h.mode = im.comps[0].prec > 8 ? "I;16" : "L";
    else if (nc == 2)
      h.mode = "LA";
    else if (nc == 3)
      h.mode = "RGB";
    else if (nc == 4)
      h.mode = "RGBA";
    else
      unsupported(std::to_string(nc) + " components");
    return;
  }
  if (n < 12 || memcmp(data, kSig, 12) != 0) fail("not a JPEG 2000 file");
  size_t pos = 12;
  bool have_ihdr = false, have_colr = false;
  int nc = 0, meth = 0, enumcs = 0;
  auto box = [&](size_t at, size_t end, uint32_t& type, size_t& body,
                 size_t& next) {
    if (at + 8 > end) fail("corrupt JPEG 2000: box past the end");
    uint64_t len = be32(data + at);
    type = be32(data + at + 4);
    body = at + 8;
    if (len == 1) {
      if (at + 16 > end) fail("corrupt JPEG 2000: box past the end");
      len = (uint64_t)be32(data + at + 8) << 32 | be32(data + at + 12);
      body = at + 16;
      if (len < 16) fail("corrupt JPEG 2000: box length");
    } else if (len == 0) {
      len = end - at;
    } else if (len < 8) {
      fail("corrupt JPEG 2000: box length");
    }
    if (len > end - at) {
      if (type != 0x6A703263) fail("corrupt JPEG 2000: box past the end");
      len = end - at;  // a codestream cut short: its headers still read
    }
    next = at + (size_t)len;
  };
  while (pos < n) {
    uint32_t type;
    size_t body, next;
    box(pos, n, type, body, next);
    if (type == 0x6A703268) {  // jp2h
      size_t q = body;
      while (q < next) {
        uint32_t t;
        size_t b, nx;
        box(q, next, t, b, nx);
        size_t blen = nx - b;
        if (t == 0x69686472) {  // ihdr
          if (blen < 14) fail("corrupt JPEG 2000: ihdr");
          h.height = (int)be32(data + b);
          h.width = (int)be32(data + b + 4);
          nc = (int)be16(data + b + 8);
          int bpc = data[b + 10];
          if (nc == 1 && (bpc & 0x7F) > 8)
            h.mode = "I;16";
          else if (nc == 1)
            h.mode = "L";
          else if (nc == 2)
            h.mode = "LA";
          else if (nc == 3)
            h.mode = "RGB";
          else if (nc == 4)
            h.mode = "RGBA";
          have_ihdr = true;
        } else if (t == 0x636F6C72) {  // colr: OpenJPEG takes the first
          if (blen < 3) fail("corrupt JPEG 2000: colr");
          int m = data[b], e = 0;
          if (m == 1) {
            if (blen < 7) fail("corrupt JPEG 2000: colr");
            e = (int)be32(data + b + 3);
          }
          if (!have_colr) {
            meth = m;
            enumcs = e;
            have_colr = true;
          }
          if (nc == 4 && m == 1 && e == 12) h.mode = "CMYK";  // PIL: each
        } else if (t == 0x70636C72 && (h.mode == "L" || h.mode == "LA")) {
          // pclr: PIL's ImagePalette.getcolor appends each colour not yet
          // in the palette, so a repeated colour shifts the later entries
          if (blen < 3) fail("corrupt JPEG 2000: pclr");
          int ne = (int)be16(data + b), npc = data[b + 2];
          if (blen < 3 + (size_t)npc * (1 + ne))
            fail("corrupt JPEG 2000: pclr");
          int maxbits = 0;
          for (int i = 0; i < npc; i++)
            maxbits = std::max(maxbits, (int)data[b + 3 + i]);
          if (maxbits <= 8) {
            if (npc != 3) unsupported("palette of " + std::to_string(npc) +
                                      " columns");
            int used = 0;
            const uint8_t* e = data + b + 3 + npc;
            for (int i = 0; i < ne; i++, e += 3) {
              bool seen = false;
              for (int k = 0; k < used && !seen; k++)
                seen = !memcmp(h.palette + 3 * k, e, 3);
              if (seen) continue;
              if (used == 256)
                fail("unsupported JPEG 2000: palette of more than 256 colours");
              memcpy(h.palette + 3 * used++, e, 3);
            }
            h.mode = h.mode == "L" ? "P" : "PA";
          }
        }
        q = nx;
      }
    } else if (type == 0x6A703263) {  // jp2c
      h.cs = data + body;
      h.cs_len = next - body;
      break;
    }
    pos = next;
  }
  if (!have_ihdr || h.mode.empty())
    fail("corrupt JPEG 2000: JP2 without an image header");
  if (h.cs == nullptr) fail("corrupt JPEG 2000: JP2 without a codestream");
  read_siz(h.cs, h.cs_len, im);
  // OpenJPEG's colour space of the enumerated ones it knows; an ICC
  // profile (not applied: PIL does not), another enumeration or no `colr`
  // leave it unspecified
  if (meth == 1 && enumcs == 16)
    h.colour = 2;
  else if (meth == 1 && enumcs == 17)
    h.colour = 1;
  else if (meth == 1 && enumcs == 18)
    h.colour = 3;
  else if (meth == 1 && enumcs == 12)
    h.colour = 4;
  else if (meth == 1 && enumcs == 24)
    unsupported("e-sYCC colour");
  if ((int)im.comps.size() != nc)
    fail("corrupt JPEG 2000: ihdr and SIZ disagree on the components");
}

// ------------------------------------------------------------ parameters

// code-block styles (COD/COC SPcod byte 3); predictable termination (16)
// needs nothing of the decoder
enum {
  kBypass = 1, kReset = 2, kTermAll = 4, kVsc = 8, kSegSym = 32, kHt = 64
};

struct Tccp {
  int nl = 0, xcb = 6, ycb = 6, style = 0, qmf = 0;
  uint8_t ppx[33], ppy[33];
  int qstyle = 0, guard = 0;
  int expn[97], mant[97];
  int roishift = 0;
};

struct Poc {
  int rs, cs, lye, re, ce, prg;
};

struct Tcp {
  int csty = 0, prog = 0, layers = 1, mct = 0;
  std::vector<Tccp> tccp;
  std::vector<bool> coc, qcc;  // component set by COC / QCC here
  std::vector<Poc> pocs;
  // packed packet headers of this header: (Zppm or Zppt, bytes)
  std::vector<std::pair<int, std::vector<uint8_t>>> packed;
};

// The packed headers' bytes in the order of their marker segments' index.
std::vector<uint8_t> joined(
    std::vector<std::pair<int, std::vector<uint8_t>>> parts) {
  std::stable_sort(parts.begin(), parts.end(),
                   [](const auto& a, const auto& b) {
                     return a.first < b.first;
                   });
  std::vector<uint8_t> out;
  for (auto& part : parts)
    out.insert(out.end(), part.second.begin(), part.second.end());
  return out;
}

void read_spco(const uint8_t* p, size_t len, bool precincts, Tccp& t) {
  if (len < 5) fail("corrupt JPEG 2000: COD/COC");
  t.nl = p[0];
  if (t.nl > 32) fail("corrupt JPEG 2000: decomposition levels");
  t.xcb = (p[1] & 0xF) + 2;
  t.ycb = (p[2] & 0xF) + 2;
  if (t.xcb > 10 || t.ycb > 10 || t.xcb + t.ycb > 12)
    fail("corrupt JPEG 2000: code-block size");
  t.style = p[3];
  t.qmf = p[4];
  if (t.style & kHt) unsupported("HTJ2K code-blocks (Part 15)");
  if (t.style & 0x80) unsupported("mixed code-block styles");
  if (t.qmf > 1) unsupported("Part 2 wavelet");
  for (int r = 0; r <= t.nl; r++) {
    if (precincts) {
      if (len < 6 + (size_t)r) fail("corrupt JPEG 2000: precinct sizes");
      t.ppx[r] = p[5 + r] & 0xF;
      t.ppy[r] = p[5 + r] >> 4;
      if (r > 0 && (t.ppx[r] == 0 || t.ppy[r] == 0))
        fail("corrupt JPEG 2000: precinct size 1 above resolution 0");
    } else {
      t.ppx[r] = t.ppy[r] = 15;
    }
  }
}

void read_sqc(const uint8_t* p, size_t len, Tccp& t) {
  if (len < 1) fail("corrupt JPEG 2000: QCD/QCC");
  t.guard = p[0] >> 5;
  t.qstyle = p[0] & 0x1F;
  int n;
  if (t.qstyle == 0) {
    n = (int)len - 1;
    for (int i = 0; i < n && i < 97; i++) {
      t.expn[i] = p[1 + i] >> 3;
      t.mant[i] = 0;
    }
  } else if (t.qstyle == 1 || t.qstyle == 2) {
    n = (int)(len - 1) / 2;
    if (n < 1) fail("corrupt JPEG 2000: QCD/QCC");
    if (t.qstyle == 1) n = 1;
    for (int i = 0; i < n && i < 97; i++) {
      uint32_t v = be16(p + 1 + 2 * i);
      t.expn[i] = v >> 11;
      t.mant[i] = v & 0x7FF;
    }
  } else {
    fail("corrupt JPEG 2000: quantization style");
  }
  if (t.qstyle == 1) {  // derived: OpenJPEG's opj_j2k_read_SQcd_SQcc
    for (int b = 1; b < 97; b++) {
      t.expn[b] = t.expn[0] - (b - 1) / 3 > 0 ? t.expn[0] - (b - 1) / 3 : 0;
      t.mant[b] = t.mant[0];
    }
  } else {
    for (int b = std::min(n, 97); b < 97; b++) t.expn[b] = t.mant[b] = 0;
  }
}

int comp_index(const uint8_t*& p, size_t& len, int ncomp) {
  int c;
  if (ncomp < 257) {
    if (len < 1) fail("corrupt JPEG 2000: component index");
    c = p[0];
    p += 1;
    len -= 1;
  } else {
    if (len < 2) fail("corrupt JPEG 2000: component index");
    c = (int)be16(p);
    p += 2;
    len -= 2;
  }
  if (c >= ncomp) fail("corrupt JPEG 2000: component index");
  return c;
}

// One marker segment of the main or a tile-part header; COC over COD and
// QCC over QCD within a header, a tile's over the main header's.
void read_marker(int m, const uint8_t* p, size_t len, Tcp& tcp, int ncomp) {
  switch (m) {
    case 0xFF52: {  // COD
      if (len < 5) fail("corrupt JPEG 2000: COD");
      tcp.csty = p[0];
      tcp.prog = p[1];
      tcp.layers = (int)be16(p + 2);
      tcp.mct = p[4];
      if (tcp.prog > 4) fail("corrupt JPEG 2000: progression order");
      if (tcp.layers < 1) fail("corrupt JPEG 2000: no layers");
      if (tcp.mct > 1) unsupported("Part 2 multiple component transform");
      for (int c = 0; c < ncomp; c++)
        if (!tcp.coc[c]) read_spco(p + 5, len - 5, tcp.csty & 1, tcp.tccp[c]);
      break;
    }
    case 0xFF53: {  // COC
      int c = comp_index(p, len, ncomp);
      if (len < 1) fail("corrupt JPEG 2000: COC");
      read_spco(p + 1, len - 1, p[0] & 1, tcp.tccp[c]);
      tcp.coc[c] = true;
      break;
    }
    case 0xFF5C:  // QCD
      for (int c = 0; c < ncomp; c++)
        if (!tcp.qcc[c]) read_sqc(p, len, tcp.tccp[c]);
      break;
    case 0xFF5D: {  // QCC
      int c = comp_index(p, len, ncomp);
      read_sqc(p, len, tcp.tccp[c]);
      tcp.qcc[c] = true;
      break;
    }
    case 0xFF5E: {  // RGN
      int c = comp_index(p, len, ncomp);
      if (len < 2 || p[0] != 0) fail("corrupt JPEG 2000: RGN");
      tcp.tccp[c].roishift = p[1];
      break;
    }
    case 0xFF5F: {  // POC
      size_t w = ncomp < 257 ? 7 : 9;
      if (len < w || len % w) fail("corrupt JPEG 2000: POC");
      tcp.pocs.clear();
      for (size_t i = 0; i < len; i += w) {
        const uint8_t* q = p + i;
        Poc poc;
        poc.rs = q[0];
        if (ncomp < 257) {
          poc.cs = q[1];
          poc.lye = (int)be16(q + 2);
          poc.re = q[4];
          poc.ce = q[5] ? q[5] : 256;
          poc.prg = q[6];
        } else {
          poc.cs = (int)be16(q + 1);
          poc.lye = (int)be16(q + 3);
          poc.re = q[5];
          poc.ce = be16(q + 6) ? (int)be16(q + 6) : 16384;
          poc.prg = q[8];
        }
        if (poc.prg > 4) fail("corrupt JPEG 2000: POC progression");
        tcp.pocs.push_back(poc);
      }
      break;
    }
    case 0xFF60:    // PPM (main header)
    case 0xFF61:    // PPT (tile-part header)
      if (len < 1) fail("corrupt JPEG 2000: PPM/PPT");
      tcp.packed.emplace_back(p[0], std::vector<uint8_t>(p + 1, p + len));
      break;
    case 0xFF50:
      unsupported("HTJ2K capabilities (Part 15)");
    case 0xFF74:
    case 0xFF75:
    case 0xFF76:
    case 0xFF77:
      unsupported("Part 2 multiple component transform");
    default:
      break;  // TLM, PLM, PLT, CRG, COM and anything else: skipped
  }
}

// ------------------------------------------------------------ MQ decoder

struct QeEntry {
  uint32_t qe;
  uint8_t nmps, nlps, sw;
};

const QeEntry kQe[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},
    {0x0AC1, 4, 12, 0},  {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0},
    {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},  {0x4801, 9, 14, 0},
    {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1},
    {0x5401, 16, 14, 0}, {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0},
    {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0}, {0x3001, 21, 19, 0},
    {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0},
    {0x1401, 28, 25, 0}, {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0},
    {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0}, {0x08A1, 33, 30, 0},
    {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0},
    {0x0085, 40, 37, 0}, {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0},
    {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0}, {0x0005, 45, 42, 0},
    {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0}};

enum { kCtxRl = 17, kCtxUni = 18, kCtxs = 19 };

// C.3 of T.800 as OpenJPEG's opj_mqc implements it: the segment's bytes
// end in an artificial 0xFF 0xFF, so reading past them feeds 1 bits.
struct Mq {
  const uint8_t* bp;
  uint32_t a, c;
  int ct;
  uint8_t state[kCtxs], mps[kCtxs];

  void reset() {
    memset(state, 0, sizeof(state));
    memset(mps, 0, sizeof(mps));
    state[kCtxUni] = 46;
    state[kCtxRl] = 3;
    state[0] = 4;
  }
  void bytein() {
    if (*bp == 0xFF) {
      if (bp[1] > 0x8F) {
        c += 0xFF00;
        ct = 8;
      } else {
        bp++;
        c += (uint32_t)*bp << 9;
        ct = 7;
      }
    } else {
      bp++;
      c += (uint32_t)*bp << 8;
      ct = 8;
    }
  }
  void init(const uint8_t* data, size_t len) {  // data[len..len+1] = 0xFF
    bp = data;
    c = len == 0 ? 0xFFu << 16 : (uint32_t)*bp << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }
  void init_raw(const uint8_t* data) {
    bp = data;
    c = 0;
    ct = 0;
  }
  void renorm() {
    do {
      if (ct == 0) bytein();
      a <<= 1;
      c <<= 1;
      ct--;
    } while (!(a & 0x8000));
  }
  int decode(int cx) {
    const QeEntry& e = kQe[state[cx]];
    int d;
    a -= e.qe;
    if ((c >> 16) < e.qe) {
      if (a < e.qe) {
        a = e.qe;
        d = mps[cx];
        state[cx] = e.nmps;
      } else {
        a = e.qe;
        d = 1 - mps[cx];
        if (e.sw) mps[cx] = 1 - mps[cx];
        state[cx] = e.nlps;
      }
      renorm();
    } else {
      c -= e.qe << 16;
      if (!(a & 0x8000)) {
        if (a < e.qe) {
          d = 1 - mps[cx];
          if (e.sw) mps[cx] = 1 - mps[cx];
          state[cx] = e.nlps;
        } else {
          d = mps[cx];
          state[cx] = e.nmps;
        }
        renorm();
      } else {
        d = mps[cx];
      }
    }
    return d;
  }
  int raw() {  // opj_mqc_raw_decode
    if (ct == 0) {
      if (c == 0xFF) {
        if (*bp > 0x8F) {
          c = 0xFF;
          ct = 8;
        } else {
          c = *bp++;
          ct = 7;
        }
      } else {
        c = *bp++;
        ct = 8;
      }
    }
    ct--;
    return (c >> ct) & 1;
  }
};

// ------------------------------------------------------------ tier 2

// B.10.2 tag trees, decoded as opj_tgt_decode does.
struct TagTree {
  std::vector<int> parent, value, low;
  void init(int w, int h) {
    parent.clear();
    if (w <= 0 || h <= 0) return;
    std::vector<int> ws, hs;
    int nw = w, nh = h;
    for (;;) {
      ws.push_back(nw);
      hs.push_back(nh);
      if (nw * nh <= 1) break;
      nw = (nw + 1) / 2;
      nh = (nh + 1) / 2;
    }
    int total = 0;
    std::vector<int> start;
    for (size_t k = 0; k < ws.size(); k++) {
      start.push_back(total);
      total += ws[k] * hs[k];
    }
    parent.assign(total, -1);
    value.assign(total, 999);
    low.assign(total, 0);
    for (size_t k = 0; k + 1 < ws.size(); k++)
      for (int j = 0; j < hs[k]; j++)
        for (int i = 0; i < ws[k]; i++)
          parent[start[k] + j * ws[k] + i] =
              start[k + 1] + (j / 2) * ws[k + 1] + i / 2;
  }
  template <class Bits>
  bool decode(Bits& b, int leaf, int threshold) {
    int stk[40], sp = 0, node = leaf;
    while (parent[node] >= 0) {
      stk[sp++] = node;
      node = parent[node];
    }
    int lo = 0;
    for (;;) {
      if (lo > low[node])
        low[node] = lo;
      else
        lo = low[node];
      while (lo < threshold && lo < value[node]) {
        if (b.bit())
          value[node] = lo;
        else
          ++lo;
      }
      low[node] = lo;
      if (sp == 0) break;
      node = stk[--sp];
    }
    return value[node] < threshold;
  }
};

// Packet header bits (opj_bio): a byte after 0xFF holds 7.
struct Bits {
  const uint8_t *p, *end;
  uint32_t buf = 0;
  int ct = 0;
  void bytein() {
    buf = (buf << 8) & 0xFFFF;
    ct = buf == 0xFF00 ? 7 : 8;
    if (p < end) buf |= *p++;
  }
  int bit() {
    if (ct == 0) bytein();
    ct--;
    return (buf >> ct) & 1;
  }
  uint32_t bits(int n) {
    uint32_t v = 0;
    for (int i = 0; i < n; i++) v = v << 1 | bit();
    return v;
  }
  void align() {
    if ((buf & 0xFF) == 0xFF) bytein();
    ct = 0;
  }
};

struct Seg {
  std::vector<uint8_t> data;
  int passes = 0, maxpasses = 0, newpasses = 0;
  uint32_t newlen = 0;
};

struct Cblk {
  int x0, y0, x1, y1;
  bool included = false;
  int numbps = 0, lblock = 3, newpasses = 0, firstnew = 0;
  std::vector<Seg> segs;
};

struct PrecBand {
  int cw = 0, ch = 0;
  std::vector<Cblk> cblks;
  TagTree incl, imsb;
};

struct Band {
  int orient;
  int64_t x0, y0, x1, y1;
  int numbps;
  float stepsize;
};

struct Res {
  int64_t x0, y0, x1, y1;
  int ppx, ppy, pw, ph, nbands;
  Band bands[3];
  std::vector<PrecBand> precs;  // pw * ph * nbands
};

struct TileComp {
  int64_t x0, y0, x1, y1;
  std::vector<Res> res;
  std::vector<int32_t> idata;
  std::vector<float> fdata;
};

void new_seg(Cblk& cb, int style, bool first) {
  Seg s;
  if (style & kTermAll)
    s.maxpasses = 1;
  else if (style & kBypass) {
    if (first)
      s.maxpasses = 10;
    else {
      int prev = cb.segs.back().maxpasses;
      s.maxpasses = (prev == 1 || prev == 10) ? 2 : 1;
    }
  } else
    s.maxpasses = 109;
  cb.segs.push_back(std::move(s));
}

int numpasses(Bits& b) {
  if (!b.bit()) return 1;
  if (!b.bit()) return 2;
  int n = (int)b.bits(2);
  if (n != 3) return 3 + n;
  n = (int)b.bits(5);
  if (n != 31) return 6 + n;
  return 37 + (int)b.bits(7);
}

int floorlog2(uint32_t v) {
  int l = 0;
  while (v > 1) {
    v >>= 1;
    l++;
  }
  return l;
}


struct TileDecoder {
  const Image& im;
  const Tcp& tcp;
  int64_t tx0, ty0, tx1, ty1;
  std::vector<TileComp> comps;

  TileDecoder(const Image& im_, const Tcp& tcp_, int64_t x0, int64_t y0,
              int64_t x1, int64_t y1)
      : im(im_), tcp(tcp_), tx0(x0), ty0(y0), tx1(x1), ty1(y1) {}

  void build() {
    int nc = (int)im.comps.size();
    comps.resize(nc);
    for (int c = 0; c < nc; c++) {
      const Tccp& t = tcp.tccp[c];
      TileComp& tc = comps[c];
      int dx = im.comps[c].dx, dy = im.comps[c].dy;
      tc.x0 = ceildiv(tx0, dx);
      tc.y0 = ceildiv(ty0, dy);
      tc.x1 = ceildiv(tx1, dx);
      tc.y1 = ceildiv(ty1, dy);
      tc.res.resize(t.nl + 1);
      for (int r = 0; r <= t.nl; r++) {
        Res& rs = tc.res[r];
        int lev = t.nl - r;
        int64_t s = (int64_t)1 << lev;
        rs.x0 = ceildiv(tc.x0, s);
        rs.y0 = ceildiv(tc.y0, s);
        rs.x1 = ceildiv(tc.x1, s);
        rs.y1 = ceildiv(tc.y1, s);
        rs.ppx = t.ppx[r];
        rs.ppy = t.ppy[r];
        int64_t px0 = floordiv(rs.x0, (int64_t)1 << rs.ppx) << rs.ppx;
        int64_t py0 = floordiv(rs.y0, (int64_t)1 << rs.ppy) << rs.ppy;
        int64_t px1 = ceildiv(rs.x1, (int64_t)1 << rs.ppx) << rs.ppx;
        int64_t py1 = ceildiv(rs.y1, (int64_t)1 << rs.ppy) << rs.ppy;
        rs.pw = rs.x0 == rs.x1 ? 0 : (int)((px1 - px0) >> rs.ppx);
        rs.ph = rs.y0 == rs.y1 ? 0 : (int)((py1 - py0) >> rs.ppy);
        rs.nbands = r == 0 ? 1 : 3;
        for (int bi = 0; bi < rs.nbands; bi++) {
          Band& bd = rs.bands[bi];
          bd.orient = r == 0 ? 0 : bi + 1;
          int nb = r == 0 ? lev : lev + 1;
          int64_t xob = bd.orient & 1, yob = bd.orient >> 1;
          int64_t sb = (int64_t)1 << nb;
          int64_t ox = nb == 0 ? 0 : xob << (nb - 1);
          int64_t oy = nb == 0 ? 0 : yob << (nb - 1);
          bd.x0 = ceildiv(tc.x0 - ox, sb);
          bd.y0 = ceildiv(tc.y0 - oy, sb);
          bd.x1 = ceildiv(tc.x1 - ox, sb);
          bd.y1 = ceildiv(tc.y1 - oy, sb);
          int qi = r == 0 ? 0 : 3 * (r - 1) + bi + 1;
          int expn = t.expn[qi], mant = t.mant[qi];
          bd.numbps = expn + t.guard - 1;
          // opj_tcd_init_tile: log2 gain 0 for the 9/7 decoder (dwt.c's
          // two_invK makes up for it), the step in double cast to float
          bd.stepsize = (float)((1.0 + mant / 2048.0) *
                                pow(2.0, (double)(im.comps[c].prec - expn)));
        }
        // precincts and code-blocks
        int cbgw = r == 0 ? rs.ppx : rs.ppx - 1;
        int cbgh = r == 0 ? rs.ppy : rs.ppy - 1;
        int cbw = std::min(t.xcb, cbgw), cbh = std::min(t.ycb, cbgh);
        int64_t gx0 = r == 0 ? px0 : ceildiv(px0, 2);
        int64_t gy0 = r == 0 ? py0 : ceildiv(py0, 2);
        rs.precs.resize((size_t)rs.pw * rs.ph * rs.nbands);
        for (int pj = 0; pj < rs.ph; pj++)
          for (int pi = 0; pi < rs.pw; pi++)
            for (int bi = 0; bi < rs.nbands; bi++) {
              Band& bd = rs.bands[bi];
              PrecBand& pb =
                  rs.precs[((size_t)pj * rs.pw + pi) * rs.nbands + bi];
              int64_t cx0 = gx0 + ((int64_t)pi << cbgw);
              int64_t cy0 = gy0 + ((int64_t)pj << cbgh);
              int64_t x0 = std::max(cx0, bd.x0);
              int64_t y0 = std::max(cy0, bd.y0);
              int64_t x1 = std::min(cx0 + ((int64_t)1 << cbgw), bd.x1);
              int64_t y1 = std::min(cy0 + ((int64_t)1 << cbgh), bd.y1);
              if (x0 >= x1 || y0 >= y1) {
                pb.cw = pb.ch = 0;
                continue;
              }
              int64_t bx0 = floordiv(x0, (int64_t)1 << cbw) << cbw;
              int64_t by0 = floordiv(y0, (int64_t)1 << cbh) << cbh;
              int64_t bx1 = ceildiv(x1, (int64_t)1 << cbw) << cbw;
              int64_t by1 = ceildiv(y1, (int64_t)1 << cbh) << cbh;
              pb.cw = (int)((bx1 - bx0) >> cbw);
              pb.ch = (int)((by1 - by0) >> cbh);
              pb.cblks.resize((size_t)pb.cw * pb.ch);
              for (int j = 0; j < pb.ch; j++)
                for (int i = 0; i < pb.cw; i++) {
                  Cblk& cb = pb.cblks[(size_t)j * pb.cw + i];
                  int64_t ex0 = bx0 + ((int64_t)i << cbw);
                  int64_t ey0 = by0 + ((int64_t)j << cbh);
                  cb.x0 = (int)std::max(ex0, x0);
                  cb.y0 = (int)std::max(ey0, y0);
                  cb.x1 = (int)std::min(ex0 + ((int64_t)1 << cbw), x1);
                  cb.y1 = (int)std::min(ey0 + ((int64_t)1 << cbh), y1);
                }
              pb.incl.init(pb.cw, pb.ch);
              pb.imsb.init(pb.cw, pb.ch);
            }
      }
    }
  }

  // The packet sequence of opj_pi_next_{lrcp,rlcp,rpcl,pcrl,cprl}: each
  // (layer, resolution, component, precinct) once, in the order of the
  // progression order changes' volumes (or the COD's one volume).
  std::vector<int> include;
  int maxres = 0, maxprec = 0;

  size_t pidx(int l, int r, int c, int p) const {
    size_t nc = comps.size();
    return (((size_t)l * (maxres + 1) + r) * nc + c) * (size_t)maxprec + p;
  }

  template <class Emit>
  void volume(int prg, int l1, int r0, int r1, int c0, int c1, Emit emit) {
    int nc = (int)comps.size();
    c1 = std::min(c1, nc);
    l1 = std::min(l1, tcp.layers);
    auto step = [&](int c, int r, uint64_t& dx, uint64_t& dy) {
      const TileComp& tc = comps[c];
      int nr = (int)tc.res.size();
      const Res& rs = tc.res[r];
      int lev = nr - 1 - r;
      uint64_t ddx = (uint64_t)im.comps[c].dx << (rs.ppx + lev);
      uint64_t ddy = (uint64_t)im.comps[c].dy << (rs.ppy + lev);
      dx = dx == 0 ? ddx : std::min(dx, ddx);
      dy = dy == 0 ? ddy : std::min(dy, ddy);
    };
    // the precinct at reference-grid position (x, y), or -1
    auto at = [&](int c, int r, uint64_t x, uint64_t y) -> int {
      const TileComp& tc = comps[c];
      int nr = (int)tc.res.size();
      if (r >= nr) return -1;
      const Res& rs = tc.res[r];
      int lev = nr - 1 - r;
      uint64_t cdx = (uint64_t)im.comps[c].dx << lev;
      uint64_t cdy = (uint64_t)im.comps[c].dy << lev;
      uint64_t trx0 = (tx0 + cdx - 1) / cdx, try0 = (ty0 + cdy - 1) / cdy;
      uint64_t trx1 = (tx1 + cdx - 1) / cdx, try1 = (ty1 + cdy - 1) / cdy;
      int rpx = rs.ppx + lev, rpy = rs.ppy + lev;
      if (!((y % ((uint64_t)im.comps[c].dy << rpy)) == 0 ||
            (y == (uint64_t)ty0 && ((try0 << lev) % ((uint64_t)1 << rpy)))))
        return -1;
      if (!((x % ((uint64_t)im.comps[c].dx << rpx)) == 0 ||
            (x == (uint64_t)tx0 && ((trx0 << lev) % ((uint64_t)1 << rpx)))))
        return -1;
      if (rs.pw == 0 || rs.ph == 0) return -1;
      if (trx0 == trx1 || try0 == try1) return -1;
      uint64_t prci = (((x + cdx - 1) / cdx) >> rs.ppx) - (trx0 >> rs.ppx);
      uint64_t prcj = (((y + cdy - 1) / cdy) >> rs.ppy) - (try0 >> rs.ppy);
      if (prci >= (uint64_t)rs.pw || prcj >= (uint64_t)rs.ph)
        fail("corrupt JPEG 2000: precinct outside its resolution");
      return (int)(prci + prcj * rs.pw);
    };
    auto once = [&](int l, int r, int c, int p) {
      size_t i = pidx(l, r, c, p);
      if (!include[i]) {
        include[i] = 1;
        emit(l, r, c, p);
      }
    };
    auto nres = [&](int c) { return (int)comps[c].res.size(); };
    auto nprec = [&](int c, int r) {
      return comps[c].res[r].pw * comps[c].res[r].ph;
    };
    if (prg == 0) {  // LRCP
      for (int l = 0; l < l1; l++)
        for (int r = r0; r < r1; r++)
          for (int c = c0; c < c1; c++)
            if (r < nres(c))
              for (int p = 0; p < nprec(c, r); p++) once(l, r, c, p);
    } else if (prg == 1) {  // RLCP
      for (int r = r0; r < r1; r++)
        for (int l = 0; l < l1; l++)
          for (int c = c0; c < c1; c++)
            if (r < nres(c))
              for (int p = 0; p < nprec(c, r); p++) once(l, r, c, p);
    } else if (prg == 2 || prg == 3) {  // RPCL, PCRL
      uint64_t dx = 0, dy = 0;
      for (int c = 0; c < nc; c++)
        for (int r = 0; r < nres(c); r++) step(c, r, dx, dy);
      if (dx == 0 || dy == 0) return;
      auto cell = [&](int r, int c, uint64_t x, uint64_t y) {
        int p = at(c, r, x, y);
        if (p >= 0)
          for (int l = 0; l < l1; l++) once(l, r, c, p);
      };
      if (prg == 2) {
        for (int r = r0; r < r1; r++)
          for (uint64_t y = ty0; y < (uint64_t)ty1; y += dy - (y % dy))
            for (uint64_t x = tx0; x < (uint64_t)tx1; x += dx - (x % dx))
              for (int c = c0; c < c1; c++) cell(r, c, x, y);
      } else {
        for (uint64_t y = ty0; y < (uint64_t)ty1; y += dy - (y % dy))
          for (uint64_t x = tx0; x < (uint64_t)tx1; x += dx - (x % dx))
            for (int c = c0; c < c1; c++)
              for (int r = r0; r < std::min(r1, nres(c)); r++)
                cell(r, c, x, y);
      }
    } else {  // CPRL
      for (int c = c0; c < c1; c++) {
        uint64_t dx = 0, dy = 0;
        for (int r = 0; r < nres(c); r++) step(c, r, dx, dy);
        if (dx == 0 || dy == 0) continue;
        for (uint64_t y = ty0; y < (uint64_t)ty1; y += dy - (y % dy))
          for (uint64_t x = tx0; x < (uint64_t)tx1; x += dx - (x % dx))
            for (int r = r0; r < std::min(r1, nres(c)); r++) {
              int p = at(c, r, x, y);
              if (p >= 0)
                for (int l = 0; l < l1; l++) once(l, r, c, p);
            }
      }
    }
  }

  // Tier 2 over the tile's bytes (its tile-parts joined); `headers` the
  // tile's packed packet headers (PPM / PPT) or null.
  void read_packets(const std::vector<uint8_t>& data,
                    const std::vector<uint8_t>* headers) {
    int nc = (int)comps.size();
    maxres = 0;
    maxprec = 1;
    for (int c = 0; c < nc; c++) {
      maxres = std::max(maxres, (int)comps[c].res.size());
      for (auto& rs : comps[c].res) maxprec = std::max(maxprec, rs.pw * rs.ph);
    }
    include.assign((size_t)tcp.layers * (maxres + 1) * nc * maxprec, 0);
    const uint8_t* cur = data.data();
    const uint8_t* end = data.data() + data.size();
    const uint8_t* hcur = headers ? headers->data() : nullptr;
    const uint8_t* hend = headers ? hcur + headers->size() : nullptr;
    auto emit = [&](int l, int r, int c, int p) {
      if (headers ? hcur >= hend : cur >= end)
        return;  // a tile cut short: what is there
      packet(cur, end, headers ? &hcur : nullptr, hend, l, r, c, p);
    };
    if (tcp.pocs.empty()) {
      volume(tcp.prog, tcp.layers, 0, maxres, 0, nc, emit);
    } else {
      for (const Poc& poc : tcp.pocs)
        volume(poc.prg, poc.lye, poc.rs, std::min(poc.re, maxres), poc.cs,
               poc.ce, emit);
    }
  }

  // One packet: its header from `*hcur` where the headers are packed, else
  // from `cur`, its body from `cur`; both cursors advanced.
  void packet(const uint8_t*& cur, const uint8_t* end, const uint8_t** hcur,
              const uint8_t* hend, int l, int r, int c, int p) {
    const Tccp& t = tcp.tccp[c];
    Res& rs = comps[c].res[r];
    if ((tcp.csty & 2) && end - cur >= 6 && cur[0] == 0xFF && cur[1] == 0x91)
      cur += 6;
    const uint8_t*& hp = hcur ? *hcur : cur;
    const uint8_t* he = hcur ? hend : end;
    Bits b{hp, he};
    bool present = b.bit();
    if (present) {
      for (int bi = 0; bi < rs.nbands; bi++) {
        PrecBand& pb = rs.precs[(size_t)p * rs.nbands + bi];
        Band& bd = rs.bands[bi];
        for (size_t k = 0; k < pb.cblks.size(); k++) {
          Cblk& cb = pb.cblks[k];
          cb.newpasses = 0;
          bool inc = cb.included ? b.bit() : pb.incl.decode(b, (int)k, l + 1);
          if (!inc) continue;
          if (!cb.included) {
            int i = 0;
            while (!pb.imsb.decode(b, (int)k, i)) {
              ++i;
              if (i > 74) fail("corrupt JPEG 2000: zero bit planes");
            }
            cb.numbps = bd.numbps + 1 - i;
            cb.lblock = 3;
            cb.included = true;
          }
          int n = numpasses(b);
          while (b.bit()) {
            cb.lblock++;
            if (cb.lblock > 32) fail("corrupt JPEG 2000: Lblock");
          }
          if (cb.segs.empty())
            new_seg(cb, t.style, true);
          else if (cb.segs.back().passes == cb.segs.back().maxpasses)
            new_seg(cb, t.style, false);
          int segno = (int)cb.segs.size() - 1;
          cb.firstnew = segno;
          cb.newpasses = n;
          int left = n;
          for (;;) {
            Seg& s = cb.segs[segno];
            s.newpasses = std::min(s.maxpasses - s.passes, left);
            int nbits = cb.lblock + floorlog2((uint32_t)s.newpasses);
            if (nbits > 32) fail("corrupt JPEG 2000: segment length bits");
            s.newlen = b.bits(nbits);
            left -= s.newpasses;
            if (left <= 0) break;
            new_seg(cb, t.style, false);
            segno++;
          }
        }
      }
    } else {
      for (int bi = 0; bi < rs.nbands; bi++)
        for (Cblk& cb : rs.precs[(size_t)p * rs.nbands + bi].cblks)
          cb.newpasses = 0;
    }
    b.align();
    hp = b.p;
    if ((tcp.csty & 4) && he - hp >= 2 && hp[0] == 0xFF && hp[1] == 0x92)
      hp += 2;
    if (!present) return;
    for (int bi = 0; bi < rs.nbands; bi++) {
      PrecBand& pb = rs.precs[(size_t)p * rs.nbands + bi];
      for (Cblk& cb : pb.cblks) {
        if (cb.newpasses == 0) continue;
        int left = cb.newpasses;
        for (size_t s = cb.firstnew; s < cb.segs.size() && left > 0; s++) {
          Seg& sg = cb.segs[s];
          if (sg.newlen > (size_t)(end - cur))
            fail("corrupt JPEG 2000: code-block data past the tile's end");
          sg.data.insert(sg.data.end(), cur, cur + sg.newlen);
          cur += sg.newlen;
          sg.passes += sg.newpasses;
          left -= sg.newpasses;
          sg.newpasses = 0;
        }
      }
    }
  }
};

// ------------------------------------------------------------ tier 1

enum { kSig = 1, kVisit = 2, kRefined = 4, kNeg = 8 };

// Table D.1: zero coding contexts by orientation and the significant
// horizontal, vertical and diagonal neighbours.
struct ZcLut {
  uint8_t t[4][3][3][5];
  ZcLut() {
    for (int o = 0; o < 4; o++)
      for (int h = 0; h < 3; h++)
        for (int v = 0; v < 3; v++)
          for (int d = 0; d < 5; d++) {
            int n, hh = h, vv = v;
            if (o == 1) std::swap(hh, vv);  // HL: vertical first
            if (o == 3) {
              int hv = h + v;
              if (d >= 3)
                n = 8;
              else if (d == 2)
                n = hv >= 1 ? 7 : 6;
              else if (d == 1)
                n = hv >= 2 ? 5 : hv == 1 ? 4 : 3;
              else
                n = hv >= 2 ? 2 : hv == 1 ? 1 : 0;
            } else if (hh == 2) {
              n = 8;
            } else if (hh == 1) {
              n = vv >= 1 ? 7 : d >= 1 ? 6 : 5;
            } else {
              n = vv == 2 ? 4 : vv == 1 ? 3 : d >= 2 ? 2 : d == 1 ? 1 : 0;
            }
            t[o][h][v][d] = (uint8_t)n;
          }
  }
};
const ZcLut kZc;

struct T1 {
  int w = 0, h = 0, stride = 0;
  std::vector<int32_t> data;
  std::vector<uint8_t> flags;
  Mq mq;
  int orient = 0;
  bool vsc = false;

  uint8_t* fl(int x, int y) { return &flags[(size_t)(y + 1) * stride + x + 1]; }

  // neighbours, the rows below left out on a stripe's last row under VSC
  bool any_sig(const uint8_t* f, bool cut) const {
    int s = stride;
    int n = (f[-1] | f[1] | f[-s - 1] | f[-s] | f[-s + 1]) & kSig;
    if (!cut) n |= (f[s - 1] | f[s] | f[s + 1]) & kSig;
    return n;
  }
  int zc(const uint8_t* f, bool cut) const {
    int s = stride;
    int hh = (f[-1] & kSig) + (f[1] & kSig);
    int v = (f[-s] & kSig) + (cut ? 0 : (f[s] & kSig));
    int d = (f[-s - 1] & kSig) + (f[-s + 1] & kSig) +
            (cut ? 0 : (f[s - 1] & kSig) + (f[s + 1] & kSig));
    return kZc.t[orient][hh][v][d];
  }
  static int chi(uint8_t f) { return f & kSig ? (f & kNeg ? -1 : 1) : 0; }
  int sign(const uint8_t* f, bool cut) {
    int s = stride;
    int hc = std::max(-1, std::min(1, chi(f[-1]) + chi(f[1])));
    int vc = std::max(-1, std::min(1, chi(f[-s]) + (cut ? 0 : chi(f[s]))));
    static const uint8_t ctx[3][3] = {{13, 12, 11}, {10, 9, 10}, {11, 12, 13}};
    // rows: hc = -1, 0, 1; columns: vc = -1, 0, 1
    int cx = ctx[hc + 1][vc + 1];
    return mq.decode(cx) ^ (hc == 0 ? vc < 0 : hc < 0);
  }

  void sigpass(int bpp1, bool raw) {
    int32_t one = (int32_t)1 << bpp1, oph = one | (one >> 1);
    for (int k = 0; k < h; k += 4)
      for (int i = 0; i < w; i++)
        for (int j = k; j < std::min(k + 4, h); j++) {
          uint8_t* f = fl(i, j);
          bool cut = vsc && j == k + 3;
          if ((*f & (kSig | kVisit)) || !any_sig(f, cut)) continue;
          int bit = raw ? mq.raw() : mq.decode(zc(f, cut));
          if (bit) {
            int s = raw ? mq.raw() : sign(f, cut);
            data[(size_t)j * w + i] = s ? -oph : oph;
            *f |= kSig | (s ? kNeg : 0);
          }
          *f |= kVisit;
        }
  }
  void refpass(int bpp1, bool raw) {
    int32_t half = ((int32_t)1 << bpp1) >> 1;
    for (int k = 0; k < h; k += 4)
      for (int i = 0; i < w; i++)
        for (int j = k; j < std::min(k + 4, h); j++) {
          uint8_t* f = fl(i, j);
          if ((*f & (kSig | kVisit)) != kSig) continue;
          int bit;
          if (raw) {
            bit = mq.raw();
          } else {
            int cx = *f & kRefined ? 16
                                   : any_sig(f, vsc && j == k + 3) ? 15 : 14;
            bit = mq.decode(cx);
          }
          int32_t& d = data[(size_t)j * w + i];
          d += (bit ^ (d < 0)) ? half : -half;
          *f |= kRefined;
        }
  }
  void clnpass(int bpp1, bool segsym) {
    int32_t one = (int32_t)1 << bpp1, oph = one | (one >> 1);
    for (int k = 0; k < h; k += 4) {
      for (int i = 0; i < w; i++) {
        int j = k;
        if (k + 3 < h) {
          bool rl = true;
          for (int r = 0; r < 4 && rl; r++) {
            uint8_t* f = fl(i, k + r);
            rl = !(*f & (kSig | kVisit)) && !any_sig(f, vsc && r == 3);
          }
          if (rl) {
            if (!mq.decode(kCtxRl)) {
              j = k + 4;
            } else {
              int run = mq.decode(kCtxUni) << 1;
              run |= mq.decode(kCtxUni);
              j = k + run;
              uint8_t* f = fl(i, j);
              int s = sign(f, vsc && run == 3);
              data[(size_t)j * w + i] = s ? -oph : oph;
              *f |= kSig | (s ? kNeg : 0);
              j++;
            }
          }
        }
        for (; j < std::min(k + 4, h); j++) {
          uint8_t* f = fl(i, j);
          if (*f & (kSig | kVisit)) continue;
          bool cut = vsc && j == k + 3;
          if (mq.decode(zc(f, cut))) {
            int s = sign(f, cut);
            data[(size_t)j * w + i] = s ? -oph : oph;
            *f |= kSig | (s ? kNeg : 0);
          }
        }
        for (int r = k; r < std::min(k + 4, h); r++) *fl(i, r) &= ~kVisit;
      }
    }
    if (segsym)
      for (int i = 0; i < 4; i++) mq.decode(kCtxUni);
  }

  // opj_t1_decode_cblk
  void decode(Cblk& cb, int orient_, int roishift, int style) {
    w = cb.x1 - cb.x0;
    h = cb.y1 - cb.y0;
    stride = w + 2;
    data.assign((size_t)w * h, 0);
    flags.assign((size_t)stride * (h + 2), 0);
    orient = orient_;
    vsc = style & kVsc;
    mq.reset();
    if (cb.segs.empty()) return;
    int bpp1 = roishift + cb.numbps;
    if (bpp1 >= 31) fail("corrupt JPEG 2000: too many bit planes");
    int passtype = 2;
    std::vector<uint8_t> buf;
    for (Seg& sg : cb.segs) {
      bool raw = bpp1 <= cb.numbps - 4 && passtype < 2 && (style & kBypass);
      buf.assign(sg.data.begin(), sg.data.end());
      buf.push_back(0xFF);
      buf.push_back(0xFF);
      buf.push_back(0);
      if (raw)
        mq.init_raw(buf.data());
      else
        mq.init(buf.data(), sg.data.size());
      for (int pass = 0; pass < sg.passes && bpp1 >= 1; pass++) {
        if (passtype == 0)
          sigpass(bpp1, raw);
        else if (passtype == 1)
          refpass(bpp1, raw);
        else
          clnpass(bpp1, style & kSegSym);
        if ((style & kReset) && !raw) mq.reset();
        if (++passtype == 3) {
          passtype = 0;
          bpp1--;
        }
      }
    }
    if (roishift) {
      int32_t thresh = (int32_t)1 << roishift;
      for (auto& v : data) {
        int32_t mag = v < 0 ? -v : v;
        if (mag >= thresh) {
          mag >>= roishift;
          v = v < 0 ? -mag : mag;
        }
      }
    }
  }
};

// ------------------------------------------------------------ DWT

// dwt.c's 9/7 constants (opj_v8dwt_decode; two_invK is its historic value
// for 2/K, which the band steps' log2 gain of 0 makes up for)
const float kAlpha = -1.586134342f;
const float kBeta = -0.052980118f;
const float kGamma = 0.882911075f;
const float kDelta = 0.443506852f;
const float kK = 1.230174105f;
const float kTwoInvK = 1.625732422f;

// opj_v8dwt_decode_step2 on `lanes` interleaved lines
void step2(float* x, int lanes, int l, int w, int end, int m, float c) {
  int imax = std::min(end, m);
  int i = 0;
  if (imax >= 1) {
    float* t = x + (size_t)(w - 1) * lanes;
    const float* a = x + (size_t)l * lanes;
    const float* b = x + (size_t)w * lanes;
    for (int k = 0; k < lanes; k++) t[k] = t[k] + (a[k] + b[k]) * c;
    i = 1;
  }
  for (; i < imax; i++) {
    float* t = x + (size_t)(w + 2 * i - 1) * lanes;
    const float* a = t - lanes;
    const float* b = t + lanes;
    for (int k = 0; k < lanes; k++) t[k] = t[k] + (a[k] + b[k]) * c;
  }
  if (m < end) {
    float* t = x + (size_t)(w + 2 * imax - 1) * lanes;
    const float* a = t - lanes;
    float c2 = c + c;
    for (int k = 0; k < lanes; k++) t[k] = t[k] + c2 * a[k];
  }
}

void idwt97(float* x, int lanes, int sn, int dn, int cas) {
  if (cas == 0 ? !(dn > 0 || sn > 1) : !(sn > 0 || dn > 1)) return;
  int a = cas, b = 1 - cas;
  for (int i = 0; i < sn; i++) {
    float* t = x + (size_t)(a + 2 * i) * lanes;
    for (int k = 0; k < lanes; k++) t[k] = t[k] * kK;
  }
  for (int i = 0; i < dn; i++) {
    float* t = x + (size_t)(b + 2 * i) * lanes;
    for (int k = 0; k < lanes; k++) t[k] = t[k] * kTwoInvK;
  }
  step2(x, lanes, b, a + 1, sn, std::min(sn, dn - a), -kDelta);
  step2(x, lanes, a, b + 1, dn, std::min(dn, sn - b), -kGamma);
  step2(x, lanes, b, a + 1, sn, std::min(sn, dn - a), -kBeta);
  step2(x, lanes, a, b + 1, dn, std::min(dn, sn - b), -kAlpha);
}

// The reversible 5/3 (F.3.8.1), integer-exact; a lone odd sample halved
// with C's division, as opj_idwt53_h does.
void idwt53(int32_t* x, int lanes, int sn, int dn, int cas) {
  int len = sn + dn;
  if (len == 1) {
    if (cas)
      for (int k = 0; k < lanes; k++) x[k] /= 2;
    return;
  }
  for (int p = cas; p < len; p += 2) {
    int32_t* t = x + (size_t)p * lanes;
    const int32_t* a = x + (size_t)(p >= 1 ? p - 1 : p + 1) * lanes;
    const int32_t* b = x + (size_t)(p + 1 < len ? p + 1 : p - 1) * lanes;
    for (int k = 0; k < lanes; k++) t[k] -= (a[k] + b[k] + 2) >> 2;
  }
  for (int p = 1 - cas; p < len; p += 2) {
    int32_t* t = x + (size_t)p * lanes;
    const int32_t* a = x + (size_t)(p >= 1 ? p - 1 : p + 1) * lanes;
    const int32_t* b = x + (size_t)(p + 1 < len ? p + 1 : p - 1) * lanes;
    for (int k = 0; k < lanes; k++) t[k] += (a[k] + b[k]) >> 1;
  }
}

// Every level of a tile-component, rows then columns (opj_dwt_decode_tile
// and opj_dwt_decode_tile_97), lines in groups of kLanes.
const int kLanes = 16;

template <class T, class F>
void idwt_tile(TileComp& tc, std::vector<T>& dat, F line) {
  int64_t tw = tc.x1 - tc.x0;
  std::vector<T> tmp;
  for (size_t r = 1; r < tc.res.size(); r++) {
    const Res& lo = tc.res[r - 1];
    const Res& cur = tc.res[r];
    int rw = (int)(cur.x1 - cur.x0), rh = (int)(cur.y1 - cur.y0);
    int snh = (int)(lo.x1 - lo.x0), snv = (int)(lo.y1 - lo.y0);
    int cash = (int)(cur.x0 & 1), casv = (int)(cur.y0 & 1);
    tmp.resize((size_t)std::max(rw, rh) * kLanes);
    for (int j0 = 0; j0 < rh; j0 += kLanes) {
      int n = std::min(kLanes, rh - j0);
      for (int k = 0; k < n; k++) {
        const T* row = dat.data() + (size_t)(j0 + k) * tw;
        for (int i = 0; i < snh; i++)
          tmp[(size_t)(cash + 2 * i) * n + k] = row[i];
        for (int i = 0; i < rw - snh; i++)
          tmp[(size_t)(1 - cash + 2 * i) * n + k] = row[snh + i];
      }
      line(tmp.data(), n, snh, rw - snh, cash);
      for (int k = 0; k < n; k++) {
        T* row = dat.data() + (size_t)(j0 + k) * tw;
        for (int i = 0; i < rw; i++) row[i] = tmp[(size_t)i * n + k];
      }
    }
    for (int i0 = 0; i0 < rw; i0 += kLanes) {
      int n = std::min(kLanes, rw - i0);
      for (int j = 0; j < snv; j++) {
        const T* row = dat.data() + (size_t)j * tw + i0;
        T* t = tmp.data() + (size_t)(casv + 2 * j) * n;
        for (int k = 0; k < n; k++) t[k] = row[k];
      }
      for (int j = 0; j < rh - snv; j++) {
        const T* row = dat.data() + (size_t)(snv + j) * tw + i0;
        T* t = tmp.data() + (size_t)(1 - casv + 2 * j) * n;
        for (int k = 0; k < n; k++) t[k] = row[k];
      }
      line(tmp.data(), n, snv, rh - snv, casv);
      for (int j = 0; j < rh; j++) {
        T* row = dat.data() + (size_t)j * tw + i0;
        const T* t = tmp.data() + (size_t)j * n;
        for (int k = 0; k < n; k++) row[k] = t[k];
      }
    }
  }
}

// ------------------------------------------------------------ decoding

// Pillow's image as its JPEG 2000 decoder fills it (Jpeg2KDecode.c): one
// sample a pixel for "L", "P" and "I;16", four 8-bit ones for "LA", "PA",
// "RGB" and "RGBA"; 0 where no tile lands.
struct PilImage {
  std::string mode;
  int colour;  // 1 gray, 2 sRGB, 3 sYCC, 4 CMYK
  int width, height, bands;
  std::vector<uint16_t> px;
};

// j2ku_shift(offset + word, shift) into `bits` for a component
struct Shift {
  int shift, offset;
  Shift(const Comp& c, int bits) {
    shift = bits - c.prec;
    offset = c.sgnd ? 1 << (c.prec - 1) : 0;
    if (shift < 0) offset += 1 << (-shift - 1);
  }
  uint32_t operator()(uint32_t word) const {
    uint32_t x = (uint32_t)offset + word;
    return shift < 0 ? x >> -shift : x << shift;
  }
};

int csize(const Comp& c) {
  int s = (c.prec + 7) >> 3;
  return s == 3 ? 4 : s;
}

uint32_t word_at(const uint8_t* p, int csiz) {
  if (csiz == 1) return p[0];
  if (csiz == 2) {
    uint16_t v;
    memcpy(&v, p, 2);
    return v;
  }
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}

// ImagingConvertYCbCr2RGB (Pillow's ConvertYCbCr.c): tables of
// (int)(c (i - 128) 2^6 + 0.5), SCALE 6
struct YccTables {
  int r_cr[256], g_cb[256], g_cr[256], b_cb[256];
  YccTables() {
    for (int i = 0; i < 256; i++) {
      r_cr[i] = (int)(1.402 * (i - 128) * 64 + 0.5);
      g_cb[i] = (int)(-0.34414 * (i - 128) * 64 + 0.5);
      g_cr[i] = (int)(-0.71414 * (i - 128) * 64 + 0.5);
      b_cb[i] = (int)(1.772 * (i - 128) * 64 + 0.5);
    }
  }
};
const YccTables kYcc;

uint16_t clamp255(int v) {
  return (uint16_t)(v <= 0 ? 0 : v >= 255 ? 255 : v);
}

// One tile into Pillow's image: the bytes opj_decode_tile_data writes
// (each component's samples in turn, csiz bytes each), read back by the
// mode's unpacker, which walks a sub-sampled component with strides of
// w / dx and rows of y / dy.
void unpack_tile(PilImage& out, const Image& im, int64_t tx0, int64_t ty0,
                 int64_t tx1, int64_t ty1, const std::vector<TileComp>& tc) {
  int nc = (int)tc.size();
  std::vector<int> csiz(nc);
  std::vector<uint8_t> buf;
  size_t w = (size_t)(tx1 - tx0), h = (size_t)(ty1 - ty0), all = 0;
  size_t used = 0;
  for (int c = 0; c < nc; c++) {
    csiz[c] = csize(im.comps[c]);
    all += (size_t)csiz[c];
    used += (size_t)csiz[c] * tc[c].idata.size();
  }
  buf.assign(std::max(used, w * h * all) + 8, 0);
  uint8_t* q = buf.data();
  for (int c = 0; c < nc; c++) {
    // the low bytes: (OPJ_CHAR), (OPJ_INT16) or the OPJ_INT32 itself
    if (csiz[c] == 1)
      for (int32_t v : tc[c].idata) *q++ = (uint8_t)v;
    else
      for (int32_t v : tc[c].idata) {
        memcpy(q, &v, csiz[c]);
        q += csiz[c];
      }
  }
  size_t ox = (size_t)(tx0 - im.xo), oy = (size_t)(ty0 - im.yo);
  const std::string& mode = out.mode;
  const uint8_t* d = buf.data();
  if (out.bands == 1) {  // j2ku_gray_l, j2ku_gray_i
    Shift sh(im.comps[0], mode == "I;16" ? 16 : 8);
    uint32_t mask = mode == "I;16" ? 0xFFFF : 0xFF;
    for (size_t y = 0; y < h; y++)
      for (size_t x = 0; x < w; x++)
        out.px[(oy + y) * out.width + ox + x] =
            (uint16_t)(sh(word_at(d + csiz[0] * (y * w + x), csiz[0])) & mask);
    return;
  }
  if (nc == 2) {  // j2ku_graya_la
    Shift sh(im.comps[0], 8), ash(im.comps[1], 8);
    const uint8_t* a = d + csiz[0] * w * h;
    for (size_t y = 0; y < h; y++)
      for (size_t x = 0; x < w; x++) {
        uint16_t* row = &out.px[4 * ((oy + y) * out.width + ox + x)];
        row[0] = row[1] = row[2] =
            (uint16_t)(sh(word_at(d + csiz[0] * (y * w + x), csiz[0])) & 0xFF);
        row[3] = (uint16_t)(ash(word_at(a + csiz[1] * (y * w + x), csiz[1])) &
                            0xFF);
      }
    return;
  }
  // j2ku_srgb_rgb, j2ku_srgba_rgba (CMYK too; the sYCC ones after them)
  std::vector<const uint8_t*> cdata(nc);
  std::vector<size_t> dx(nc), dy(nc);
  std::vector<Shift> sh;
  const uint8_t* cptr = d;
  for (int c = 0; c < nc; c++) {
    cdata[c] = cptr;
    dx[c] = (size_t)im.comps[c].dx;
    dy[c] = (size_t)im.comps[c].dy;
    sh.emplace_back(im.comps[c], 8);
    cptr += csiz[c] * (w / dx[c]) * (h / dy[c]);
  }
  for (size_t y = 0; y < h; y++) {
    for (size_t x = 0; x < w; x++) {
      uint16_t* row = &out.px[4 * ((oy + y) * out.width + ox + x)];
      for (int c = 0; c < nc; c++) {
        const uint8_t* p = cdata[c] + csiz[c] * ((y / dy[c]) * (w / dx[c]) +
                                                 x / dx[c]);
        row[c] = (uint16_t)(sh[c](word_at(p, csiz[c])) & 0xFF);
      }
      if (nc == 3) row[3] = 0xFF;
      if (out.colour == 3) {
        int yy = row[0], cb = row[1], cr = row[2];
        row[0] = clamp255(yy + (kYcc.r_cr[cr] >> 6));
        row[1] = clamp255(yy + ((kYcc.g_cb[cb] + kYcc.g_cr[cr]) >> 6));
        row[2] = clamp255(yy + (kYcc.b_cb[cb] >> 6));
      }
    }
  }
}

void decode_tile(const Image& im, const Tcp& tcp, int tileno,
                 const std::vector<uint8_t>& bytes,
                 const std::vector<uint8_t>* headers, PilImage& out) {
  int nxt = (int)ceildiv((int64_t)im.xsiz - im.xto, im.xt);
  int p = tileno % nxt, q = tileno / nxt;
  int64_t tx0 = std::max<int64_t>((int64_t)im.xto + (int64_t)p * im.xt, im.xo);
  int64_t ty0 = std::max<int64_t>((int64_t)im.yto + (int64_t)q * im.yt, im.yo);
  int64_t tx1 = std::min<int64_t>((int64_t)im.xto + (int64_t)(p + 1) * im.xt,
                                  im.xsiz);
  int64_t ty1 = std::min<int64_t>((int64_t)im.yto + (int64_t)(q + 1) * im.yt,
                                  im.ysiz);
  TileDecoder td(im, tcp, tx0, ty0, tx1, ty1);
  td.build();
  td.read_packets(bytes, headers);
  int nc = (int)im.comps.size();
  T1 t1;
  for (int c = 0; c < nc; c++) {
    TileComp& tc = td.comps[c];
    const Tccp& t = tcp.tccp[c];
    int64_t tw = tc.x1 - tc.x0, th = tc.y1 - tc.y0;
    bool rev = t.qmf == 1;
    if (rev)
      tc.idata.assign((size_t)tw * th, 0);
    else
      tc.fdata.assign((size_t)tw * th, 0.0f);
    for (size_t r = 0; r < tc.res.size(); r++) {
      Res& rs = tc.res[r];
      for (int bi = 0; bi < rs.nbands; bi++) {
        Band& bd = rs.bands[bi];
        int64_t offx = 0, offy = 0;
        if (bd.orient & 1) offx = tc.res[r - 1].x1 - tc.res[r - 1].x0;
        if (bd.orient & 2) offy = tc.res[r - 1].y1 - tc.res[r - 1].y0;
        float step = 0.5f * bd.stepsize;
        for (int pi = 0; pi < rs.pw * rs.ph; pi++) {
          PrecBand& pb = rs.precs[(size_t)pi * rs.nbands + bi];
          for (Cblk& cb : pb.cblks) {
            if (cb.segs.empty()) continue;
            t1.decode(cb, bd.orient, t.roishift, t.style);
            int64_t x = cb.x0 - bd.x0 + offx, y = cb.y0 - bd.y0 + offy;
            for (int j = 0; j < t1.h; j++) {
              const int32_t* src = t1.data.data() + (size_t)j * t1.w;
              size_t o = (size_t)(y + j) * tw + x;
              if (rev)
                for (int i = 0; i < t1.w; i++) tc.idata[o + i] = src[i] / 2;
              else
                for (int i = 0; i < t1.w; i++)
                  tc.fdata[o + i] = (float)src[i] * step;
            }
          }
        }
      }
    }
    if (rev)
      idwt_tile(tc, tc.idata, idwt53);
    else
      idwt_tile(tc, tc.fdata, idwt97);
  }
  // the multiple component transform: RCT or ICT by component 0's wavelet
  if (tcp.mct == 1 && nc >= 3) {
    bool same = true;
    for (int c = 1; c < 3; c++)
      same = same && td.comps[c].x0 == td.comps[0].x0 &&
             td.comps[c].x1 == td.comps[0].x1 &&
             td.comps[c].y0 == td.comps[0].y0 &&
             td.comps[c].y1 == td.comps[0].y1;
    if (!same) unsupported("component transform over unequal components");
    if (tcp.tccp[0].qmf == 1) {
      if (tcp.tccp[1].qmf != 1 || tcp.tccp[2].qmf != 1)
        unsupported("RCT over mixed wavelets");
      int32_t *c0 = td.comps[0].idata.data(), *c1 = td.comps[1].idata.data(),
              *c2 = td.comps[2].idata.data();
      size_t n = td.comps[0].idata.size();
      for (size_t i = 0; i < n; i++) {
        int32_t y = c0[i], u = c1[i], v = c2[i];
        int32_t g = y - ((u + v) >> 2);
        c0[i] = v + g;
        c1[i] = g;
        c2[i] = u + g;
      }
    } else {
      if (tcp.tccp[1].qmf != 0 || tcp.tccp[2].qmf != 0)
        unsupported("ICT over mixed wavelets");
      float *c0 = td.comps[0].fdata.data(), *c1 = td.comps[1].fdata.data(),
            *c2 = td.comps[2].fdata.data();
      size_t n = td.comps[0].fdata.size();
      for (size_t i = 0; i < n; i++) {  // opj_mct_decode_real
        float y = c0[i], u = c1[i], v = c2[i];
        float r = y + (v * 1.402f);
        float g = y - (u * 0.34413f) - (v * 0.71414f);
        float b = y + (u * 1.772f);
        c0[i] = r;
        c1[i] = g;
        c2[i] = b;
      }
    }
  }
  // DC level shift and clamp (opj_tcd_dc_level_shift_decode)
  for (int c = 0; c < nc; c++) {
    TileComp& tc = td.comps[c];
    const Comp& cp = im.comps[c];
    int64_t lo = cp.sgnd ? -((int64_t)1 << (cp.prec - 1)) : 0;
    int64_t hi = cp.sgnd ? ((int64_t)1 << (cp.prec - 1)) - 1
                         : ((int64_t)1 << cp.prec) - 1;
    int64_t shift = cp.sgnd ? 0 : (int64_t)1 << (cp.prec - 1);
    bool rev = tcp.tccp[c].qmf == 1;
    size_t n = (size_t)((tc.x1 - tc.x0) * (tc.y1 - tc.y0));
    tc.idata.resize(n);
    for (size_t s = 0; s < n; s++) {
      int64_t v;
      if (rev) {
        v = std::min(hi, std::max(lo, (int64_t)tc.idata[s] + shift));
      } else {
        float f = tc.fdata[s];
        if (f > (float)INT_MAX)
          v = hi;
        else if (f < (float)INT_MIN)
          v = lo;
        else
          v = std::min(hi, std::max(lo, (int64_t)lrintf(f) + shift));
      }
      tc.idata[s] = (int32_t)v;
    }
  }
  unpack_tile(out, im, tx0, ty0, tx1, ty1, td.comps);
}

// Main header, tile-parts, every tile -> Pillow's image.
void decode_codestream(const uint8_t* cs, size_t n, PilImage& out) {
  Image im;
  read_siz(cs, n, im);
  int nc = (int)im.comps.size();
  Tcp main;
  main.tccp.resize(nc);
  main.coc.assign(nc, false);
  main.qcc.assign(nc, false);
  for (Tccp& t : main.tccp) {
    memset(t.ppx, 15, sizeof(t.ppx));
    memset(t.ppy, 15, sizeof(t.ppy));
    memset(t.expn, 0, sizeof(t.expn));
    memset(t.mant, 0, sizeof(t.mant));
  }
  size_t pos = 4 + be16(cs + 4);
  bool have_cod = false, have_qcd = false;
  for (;;) {
    if (pos + 2 > n) fail("corrupt JPEG 2000: main header past the end");
    int m = (int)be16(cs + pos);
    if (m == 0xFF90) break;
    if (m == 0xFFD9) fail("corrupt JPEG 2000: no tiles");
    if (pos + 4 > n) fail("corrupt JPEG 2000: main header past the end");
    size_t len = be16(cs + pos + 2);
    if (len < 2 || pos + 2 + len > n)
      fail("corrupt JPEG 2000: marker segment past the end");
    if (m == 0xFF52) have_cod = true;
    if (m == 0xFF5C) have_qcd = true;
    read_marker(m, cs + pos + 4, len - 2, main, nc);
    pos += 2 + len;
  }
  if (!have_cod || !have_qcd) fail("corrupt JPEG 2000: no COD or QCD");
  // PPM: for each tile-part in turn, Nppm and that many header bytes
  std::vector<uint8_t> ppm = joined(main.packed);
  size_t ppm_pos = 0;
  main.packed.clear();
  int nxt = (int)ceildiv((int64_t)im.xsiz - im.xto, im.xt);
  int nyt = (int)ceildiv((int64_t)im.ysiz - im.yto, im.yt);
  int ntiles = nxt * nyt;
  std::vector<Tcp> tcps(ntiles);
  std::vector<bool> seen(ntiles, false);
  std::vector<std::vector<uint8_t>> bytes(ntiles), headers(ntiles);
  while (pos + 2 <= n) {
    int m = (int)be16(cs + pos);
    if (m == 0xFFD9) break;
    if (m != 0xFF90) fail("corrupt JPEG 2000: expected a tile-part");
    if (pos + 12 > n) fail("corrupt JPEG 2000: SOT past the end");
    int tile = (int)be16(cs + pos + 4);
    size_t psot = be32(cs + pos + 6);
    size_t tp_end = psot == 0 ? n : pos + psot;
    if (psot == 0 && n >= 2 && be16(cs + n - 2) == 0xFFD9) tp_end = n - 2;
    if (tile >= ntiles || tp_end > n || (psot && psot < 14))
      fail("corrupt JPEG 2000: SOT");
    if (!seen[tile]) {
      tcps[tile] = main;
      tcps[tile].coc.assign(nc, false);
      tcps[tile].qcc.assign(nc, false);
      seen[tile] = true;
    }
    size_t q = pos + 12;
    for (;;) {
      if (q + 2 > tp_end) fail("corrupt JPEG 2000: tile-part header");
      int mm = (int)be16(cs + q);
      if (mm == 0xFF93) {
        q += 2;
        break;
      }
      if (q + 4 > tp_end) fail("corrupt JPEG 2000: tile-part header");
      size_t len = be16(cs + q + 2);
      if (len < 2 || q + 2 + len > tp_end)
        fail("corrupt JPEG 2000: marker segment past the tile-part");
      read_marker(mm, cs + q + 4, len - 2, tcps[tile], nc);
      q += 2 + len;
    }
    std::vector<uint8_t> packed = joined(tcps[tile].packed);
    tcps[tile].packed.clear();
    if (!ppm.empty()) {
      if (ppm_pos + 4 > ppm.size()) fail("corrupt JPEG 2000: PPM");
      size_t nppm = be32(ppm.data() + ppm_pos);
      if (nppm > ppm.size() - ppm_pos - 4) fail("corrupt JPEG 2000: PPM");
      packed.assign(ppm.begin() + ppm_pos + 4,
                    ppm.begin() + ppm_pos + 4 + nppm);
      ppm_pos += 4 + nppm;
    }
    headers[tile].insert(headers[tile].end(), packed.begin(), packed.end());
    bytes[tile].insert(bytes[tile].end(), cs + q, cs + tp_end);
    pos = tp_end;
  }
  bool packed = !ppm.empty();
  for (int t = 0; t < ntiles; t++)
    packed = packed || !headers[t].empty();
  for (int t = 0; t < ntiles; t++)
    if (seen[t])
      decode_tile(im, tcps[t], t, bytes[t], packed ? &headers[t] : nullptr,
                  out);
}

uint8_t lum(uint32_t r, uint32_t g, uint32_t b) {
  return (uint8_t)((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16);
}

int channels(const Header& h) {
  return h.mode == "L" || h.mode == "I;16" || h.mode == "LA" ? 1 : 3;
}

}  // namespace

extern "C" {

int jp2_info(const uint8_t* data, long n, int* info, char* err, int errlen) {
  try {
    Header h;
    read_header(data, (size_t)n, h);
    info[0] = h.width;
    info[1] = h.height;
    info[2] = channels(h);
    return 0;
  } catch (const std::exception& e) {
    snprintf(err, errlen, "%s", e.what());
    return -1;
  }
}

// -> channels written to `out` (height * width * channels bytes): 1 for a
// gray mode or `gray` (PIL's convert("L")), else 3 (convert("RGB")).
int jp2_decode(const uint8_t* data, long n, uint8_t* out, int gray, char* err,
               int errlen) {
  try {
    Header h;
    read_header(data, (size_t)n, h);
    Image im;
    read_siz(h.cs, h.cs_len, im);
    int nc = (int)im.comps.size();
    // Pillow's unpacker table: mode, colour space, components; only the
    // colour unpackers take sub-sampled components. A codestream without a
    // colour space is gray below 3 components, else sRGB, but sYCC where
    // component 0 is whole and component 1 or 2 sub-sampled (what OpenJPEG
    // 2.5 and Pillow 12 give; each case checked against PIL's pixels)
    int colour = h.colour;
    if (!colour) {
      auto sub = [&](int c) {
        return im.comps[c].dx != 1 || im.comps[c].dy != 1;
      };
      colour = nc <= 2 ? 1 : !sub(0) && (sub(1) || sub(2)) ? 3 : 2;
    }
    const std::string& mode = h.mode;
    bool colour_mode = (nc == 3 && mode == "RGB") ||
                       (nc == 4 && (mode == "RGBA" || mode == "CMYK"));
    bool ok = (colour == 1 && ((nc == 1 && (mode == "L" || mode == "I;16")) ||
                               (nc == 2 && mode == "LA"))) ||
              (colour == 2 && ((nc == 1 && mode == "P") ||
                               (nc == 2 && mode == "PA"))) ||
              ((colour == 2 || colour == 3) && colour_mode &&
               mode != "CMYK") ||
              (colour == 4 && mode == "CMYK");
    if (!ok)
      unsupported("mode " + mode + " of " + std::to_string(nc) +
                  " components in colour space " + std::to_string(colour));
    for (const Comp& cp : im.comps) {
      if (cp.prec > 16) unsupported(std::to_string(cp.prec) + "-bit samples");
      if ((cp.dx != 1 || cp.dy != 1) && !colour_mode)
        unsupported("component sub-sampling in mode " + mode);
    }
    if (h.width != (int)(im.xsiz - im.xo) || h.height != (int)(im.ysiz - im.yo))
      unsupported("JP2 header size other than the codestream's");
    PilImage pil;
    pil.mode = mode;
    pil.colour = colour;
    pil.width = h.width;
    pil.height = h.height;
    pil.bands = nc >= 2 ? 4 : 1;
    pil.px.assign((size_t)pil.width * pil.height * pil.bands, 0);
    decode_codestream(h.cs, h.cs_len, pil);
    size_t npx = (size_t)pil.width * pil.height;
    int ch = gray || channels(h) == 1 ? 1 : 3;
    const uint16_t* px = pil.px.data();
    int bands = pil.bands;
    if (mode == "P" || mode == "PA") {
      for (size_t i = 0; i < npx; i++) {
        const uint8_t* e = h.palette + 3 * px[i * bands];
        if (ch == 1)
          out[i] = lum(e[0], e[1], e[2]);
        else
          memcpy(out + 3 * i, e, 3);
      }
    } else if (colour_mode) {
      for (size_t i = 0; i < npx; i++) {
        uint16_t cmyk[3];
        const uint16_t* p = px + 4 * i;
        if (mode == "CMYK") {  // Pillow's cmyk2rgb
          int nk = 255 - p[3];
          for (int k = 0; k < 3; k++) {
            int t = p[k] * nk + 128;
            cmyk[k] = clamp255(nk - (((t >> 8) + t) >> 8));
          }
          p = cmyk;
        }
        if (ch == 1) {
          out[i] = lum(p[0], p[1], p[2]);
        } else {
          out[3 * i] = (uint8_t)p[0];
          out[3 * i + 1] = (uint8_t)p[1];
          out[3 * i + 2] = (uint8_t)p[2];
        }
      }
    } else {  // L, LA; I;16 clipped as PIL's I;16 -> L
      for (size_t i = 0; i < npx; i++)
        out[i] = (uint8_t)std::min<uint16_t>(px[i * bands], 255);
    }
    return ch;
  } catch (const std::exception& e) {
    snprintf(err, errlen, "%s", e.what());
    return -1;
  }
}

}  // extern "C"
