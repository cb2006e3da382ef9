// The TIFF codecs that libtiff decodes for PIL and that need a loop per
// bit or byte: LZW (tif_lzw.c, MSB-first codes with early change, and
// LZWDecodeCompat's old-style LSB-first codes without it), PackBits, and
// CCITT fax (tif_fax3.c: Modified Huffman, T.4 Group 3
// one- and two-dimensional, T.6 Group 4). core/_tiff.py parses the
// file and does the rest in numpy.
//
//   tiff_lzw(in, n, out, cap) -> bytes written, or -1 on a bad code
//   tiff_lzw_compat(in, n, out, cap) -> the same for old-style codes
//   tiff_packbits(in, n, out, cap) -> bytes written
//   tiff_fax(in, n, mode, t4options, width, rows, out, err, errlen)
//       -> rows decoded, or -1 with a message in `err`; `out` gets one
//          byte a pixel, 1 for black, rows * width bytes
//
// mode: 2 Modified Huffman (byte-aligned rows, no EOL), 3 Group 3
// (EOL before every row; `t4options` bit 0: two-dimensional rows),
// 4 Group 4. The caller reverses the bits of FillOrder 2 data first.

#include <algorithm>
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

// ------------------------------------------------------------------ LZW

long lzw(const uint8_t* in, long n, uint8_t* out, long cap) {
  const int kClear = 256, kEoi = 257;
  std::vector<int> prefix(4096, -1), length(4096, 1);
  std::vector<uint8_t> suffix(4096), first(4096);
  for (int i = 0; i < 256; i++) suffix[i] = first[i] = (uint8_t)i;
  int next = 258, nbits = 9, prev = -1;
  long bitpos = 0, written = 0;
  const long nbitsin = n * 8;
  // the string of `code`, written backwards from its last byte
  auto emit = [&](int code) {
    long end = written + length[code];
    long pos = end - 1;
    for (int c = code; c >= 0; c = prefix[c], pos--)
      if (pos < cap) out[pos] = suffix[c];
    written = end;
  };
  while (bitpos + nbits <= nbitsin && written < cap) {
    int code = 0;
    for (int i = 0; i < nbits; i++, bitpos++)
      code = (code << 1) | ((in[bitpos >> 3] >> (7 - (bitpos & 7))) & 1);
    if (code == kEoi) break;
    if (code == kClear) {
      next = 258;
      nbits = 9;
      prev = -1;
      continue;
    }
    if (prev < 0) {
      if (code > 255) return -1;
      emit(code);
      prev = code;
      continue;
    }
    if (code > next || next >= 4096) return -1;
    // a new entry: prev's string and the first byte of code's (of
    // prev's own where code is the entry being made)
    prefix[next] = prev;
    suffix[next] = code < next ? first[code] : first[prev];
    first[next] = first[prev];
    length[next] = length[prev] + 1;
    next++;
    emit(code);
    // tif_lzw.c: the next code is one bit wider one entry early
    if (next + 1 >= (1 << nbits) && nbits < 12) nbits++;
    prev = code;
  }
  return std::min(written, cap);
}

// tif_lzw.c LZWDecodeCompat: codes LSB first, each CLEAR restarting the
// table at 258 and 9 bits; a code one bit wider only once the entry
// (1 << nbits) - 1 is made. Entries go on past 4095 (unreachable with
// 12-bit codes) up to libtiff's table of 5119, where it gives up; a code
// no entry holds yet is corrupt. The data's end stands for EOI.
long lzw_compat(const uint8_t* in, long n, uint8_t* out, long cap) {
  const int kClear = 256, kEoi = 257, kSize = 4095 + 1024;
  std::vector<int> prefix(kSize, -1), length(kSize, 0);
  std::vector<uint8_t> suffix(kSize), first(kSize);
  for (int i = 0; i < 256; i++) {
    suffix[i] = first[i] = (uint8_t)i;
    length[i] = 1;
  }
  int next = -1, nbits = 9, prev = -1;
  long bitpos = 0, written = 0;
  const long nbitsin = n * 8;
  auto get = [&](int& code) {
    if (bitpos + nbits > nbitsin) return false;
    code = 0;
    for (int i = 0; i < nbits; i++, bitpos++)
      code |= ((in[bitpos >> 3] >> (bitpos & 7)) & 1) << i;
    return true;
  };
  int code;
  while (written < cap && get(code)) {
    if (code == kEoi) break;
    if (code == kClear) {
      do {
        std::fill(length.begin() + 258, length.end(), 0);
        next = 258;
        nbits = 9;
        if (!get(code)) code = kEoi;
      } while (code == kClear);
      if (code == kEoi) break;
      if (code > kClear) return -1;
      out[written++] = (uint8_t)code;
      prev = code;
      continue;
    }
    // before the first CLEAR libtiff's table has no free entry
    if (next < 0 || next >= kSize || prev < 0) return -1;
    prefix[next] = prev;
    first[next] = first[prev];
    length[next] = length[prev] + 1;
    suffix[next] = code < next ? first[code] : first[next];
    if (++next > (1 << nbits) - 1 && nbits < 12) nbits++;
    if (code >= 256) {
      if (length[code] == 0) return -1;
      long end = written + length[code];
      long pos = end - 1;
      for (int c = code; c >= 0; c = c < 256 ? -1 : prefix[c], pos--)
        if (pos < cap) out[pos] = suffix[c];
      written = std::min(end, cap);
    } else {
      out[written++] = (uint8_t)code;
    }
    prev = code;
  }
  return written;
}

// ------------------------------------------------------------- PackBits

long packbits(const uint8_t* in, long n, uint8_t* out, long cap) {
  long i = 0, o = 0;
  while (i < n && o < cap) {
    int c = (int8_t)in[i++];
    if (c >= 0) {
      // tif_packbits.c: a literal run that the data cuts short ends the
      // decode without a byte of it
      long k = std::min((long)c + 1, cap - o);
      if (n - i < k) break;
      memcpy(out + o, in + i, k);
      i += c + 1;
      o += k;
    } else if (c != -128) {
      if (i >= n) break;
      long k = std::min((long)(1 - c), cap - o);
      memset(out + o, in[i++], k);
      o += k;
    }
  }
  return o;
}

// ---------------------------------------------------------------- CCITT

struct Code {
  int value;
  const char* bits;
};

// T.4 tables: terminating (0-63) and makeup codes of each colour, the
// extended makeup codes both share
const Code kWhite[] = {
    {0, "00110101"}, {1, "000111"}, {2, "0111"}, {3, "1000"},
    {4, "1011"}, {5, "1100"}, {6, "1110"}, {7, "1111"},
    {8, "10011"}, {9, "10100"}, {10, "00111"}, {11, "01000"},
    {12, "001000"}, {13, "000011"}, {14, "110100"}, {15, "110101"},
    {16, "101010"}, {17, "101011"}, {18, "0100111"}, {19, "0001100"},
    {20, "0001000"}, {21, "0010111"}, {22, "0000011"}, {23, "0000100"},
    {24, "0101000"}, {25, "0101011"}, {26, "0010011"}, {27, "0100100"},
    {28, "0011000"}, {29, "00000010"}, {30, "00000011"}, {31, "00011010"},
    {32, "00011011"}, {33, "00010010"}, {34, "00010011"}, {35, "00010100"},
    {36, "00010101"}, {37, "00010110"}, {38, "00010111"}, {39, "00101000"},
    {40, "00101001"}, {41, "00101010"}, {42, "00101011"}, {43, "00101100"},
    {44, "00101101"}, {45, "00000100"}, {46, "00000101"}, {47, "00001010"},
    {48, "00001011"}, {49, "01010010"}, {50, "01010011"}, {51, "01010100"},
    {52, "01010101"}, {53, "00100100"}, {54, "00100101"}, {55, "01011000"},
    {56, "01011001"}, {57, "01011010"}, {58, "01011011"}, {59, "01001010"},
    {60, "01001011"}, {61, "00110010"}, {62, "00110011"}, {63, "00110100"},
    {64, "11011"}, {128, "10010"}, {192, "010111"}, {256, "0110111"},
    {320, "00110110"}, {384, "00110111"}, {448, "01100100"},
    {512, "01100101"}, {576, "01101000"}, {640, "01100111"},
    {704, "011001100"}, {768, "011001101"}, {832, "011010010"},
    {896, "011010011"}, {960, "011010100"}, {1024, "011010101"},
    {1088, "011010110"}, {1152, "011010111"}, {1216, "011011000"},
    {1280, "011011001"}, {1344, "011011010"}, {1408, "011011011"},
    {1472, "010011000"}, {1536, "010011001"}, {1600, "010011010"},
    {1664, "011000"}, {1728, "010011011"}};

const Code kBlack[] = {
    {0, "0000110111"}, {1, "010"}, {2, "11"}, {3, "10"},
    {4, "011"}, {5, "0011"}, {6, "0010"}, {7, "00011"},
    {8, "000101"}, {9, "000100"}, {10, "0000100"}, {11, "0000101"},
    {12, "0000111"}, {13, "00000100"}, {14, "00000111"},
    {15, "000011000"}, {16, "0000010111"}, {17, "0000011000"},
    {18, "0000001000"}, {19, "00001100111"}, {20, "00001101000"},
    {21, "00001101100"}, {22, "00000110111"}, {23, "00000101000"},
    {24, "00000010111"}, {25, "00000011000"}, {26, "000011001010"},
    {27, "000011001011"}, {28, "000011001100"}, {29, "000011001101"},
    {30, "000001101000"}, {31, "000001101001"}, {32, "000001101010"},
    {33, "000001101011"}, {34, "000011010010"}, {35, "000011010011"},
    {36, "000011010100"}, {37, "000011010101"}, {38, "000011010110"},
    {39, "000011010111"}, {40, "000001101100"}, {41, "000001101101"},
    {42, "000011011010"}, {43, "000011011011"}, {44, "000001010100"},
    {45, "000001010101"}, {46, "000001010110"}, {47, "000001010111"},
    {48, "000001100100"}, {49, "000001100101"}, {50, "000001010010"},
    {51, "000001010011"}, {52, "000000100100"}, {53, "000000110111"},
    {54, "000000111000"}, {55, "000000100111"}, {56, "000000101000"},
    {57, "000001011000"}, {58, "000001011001"}, {59, "000000101011"},
    {60, "000000101100"}, {61, "000001011010"}, {62, "000001100110"},
    {63, "000001100111"}, {64, "0000001111"}, {128, "000011001000"},
    {192, "000011001001"}, {256, "000001011011"}, {320, "000000110011"},
    {384, "000000110100"}, {448, "000000110101"}, {512, "0000001101100"},
    {576, "0000001101101"}, {640, "0000001001010"}, {704, "0000001001011"},
    {768, "0000001001100"}, {832, "0000001001101"}, {896, "0000001110010"},
    {960, "0000001110011"}, {1024, "0000001110100"},
    {1088, "0000001110101"}, {1152, "0000001110110"},
    {1216, "0000001110111"}, {1280, "0000001010010"},
    {1344, "0000001010011"}, {1408, "0000001010100"},
    {1472, "0000001010101"}, {1536, "0000001011010"},
    {1600, "0000001011011"}, {1664, "0000001100100"},
    {1728, "0000001100101"}};

const Code kExtended[] = {
    {1792, "00000001000"}, {1856, "00000001100"}, {1920, "00000001101"},
    {1984, "000000010010"}, {2048, "000000010011"}, {2112, "000000010100"},
    {2176, "000000010101"}, {2240, "000000010110"}, {2304, "000000010111"},
    {2368, "000000011100"}, {2432, "000000011101"}, {2496, "000000011110"},
    {2560, "000000011111"}};

// two-dimensional mode codes: pass, horizontal, vertical -3..3
enum { kPass = 100, kHoriz = 101, kV0 = 200, kExt = 300 };
const Code kModes[] = {{kPass, "0001"},      {kHoriz, "001"},
                       {kV0, "1"},           {kV0 + 1, "011"},
                       {kV0 + 2, "000011"},  {kV0 + 3, "0000011"},
                       {kV0 - 1, "010"},     {kV0 - 2, "000010"},
                       {kV0 - 3, "0000010"}, {kExt, "0000001"}};

// A binary trie over the codes; value -1 at inner nodes.
struct Trie {
  std::vector<int> child;  // 2 per node
  std::vector<int> value;
  Trie() {
    child.assign(2, -1);
    value.assign(1, -1);
  }
  template <size_t N>
  void add(const Code (&codes)[N]) {
    for (const Code& c : codes) {
      int node = 0;
      for (const char* b = c.bits; *b; b++) {
        int bit = *b - '0';
        if (child[2 * node + bit] < 0) {
          child[2 * node + bit] = (int)value.size();
          value.push_back(-1);
          child.push_back(-1);
          child.push_back(-1);
        }
        node = child[2 * node + bit];
      }
      value[node] = c.value;
    }
  }
};

struct FaxBits {
  const uint8_t* p;
  long nbits;
  long pos = 0;
  int bit() {
    if (pos >= nbits) throw Error("EOF");
    int b = (p[pos >> 3] >> (7 - (pos & 7))) & 1;
    pos++;
    return b;
  }
  bool at_end() const { return pos >= nbits; }
  int decode(const Trie& t) {
    int node = 0;
    for (;;) {
      node = t.child[2 * node + bit()];
      if (node < 0) throw Error("bad code");
      if (t.value[node] >= 0) return t.value[node];
    }
  }
};

struct Fax {
  Trie white, black, modes;
  Fax() {
    white.add(kWhite);
    white.add(kExtended);
    black.add(kBlack);
    black.add(kExtended);
    modes.add(kModes);
  }
};

const Fax& fax_tables() {
  static const Fax f;
  return f;
}

int run_length(FaxBits& br, const Trie& t) {
  int total = 0;
  for (;;) {
    int v = br.decode(t);
    total += v;
    if (v < 64) return total;
  }
}

// libtiff's SYNC_EOL: 11 zero bits, more zeros, then the 1
void sync_eol(FaxBits& br) {
  int zeros = 0;
  for (;;) {
    int b = br.bit();
    if (b == 0) {
      zeros++;
    } else if (zeros >= 11) {
      return;
    } else {
      zeros = 0;
    }
  }
}

// One row from runs; `changes` gets the row's changing elements.
void fill(uint8_t* row, int width, int a, int b, int color) {
  a = std::max(a, 0);
  b = std::min(b, width);
  if (color && b > a) memset(row + a, 1, b - a);
}

void decode_1d(FaxBits& br, const Fax& f, uint8_t* row, int width,
               std::vector<int>& changes) {
  changes.clear();
  int a0 = 0, color = 0;
  while (a0 < width) {
    int run = run_length(br, color ? f.black : f.white);
    fill(row, width, a0, a0 + run, color);
    a0 += run;
    changes.push_back(std::min(a0, width));
    color ^= 1;
  }
}

void decode_2d(FaxBits& br, const Fax& f, uint8_t* row, int width,
               const std::vector<int>& ref, std::vector<int>& changes) {
  changes.clear();
  int a0 = -1, color = 0;
  size_t base = 0;  // first reference element right of a0
  while (a0 < width) {
    while (base < ref.size() && ref[base] <= a0) base++;
    size_t k = base;
    if ((k & 1) != (size_t)color) k++;
    int b1 = k < ref.size() ? ref[k] : width;
    int b2 = k + 1 < ref.size() ? ref[k + 1] : width;
    int mode = br.decode(f.modes);
    if (mode == kPass) {
      fill(row, width, a0, b2, color);
      a0 = b2;
    } else if (mode == kHoriz) {
      int start = std::max(a0, 0);
      int r1 = run_length(br, color ? f.black : f.white);
      int r2 = run_length(br, color ? f.white : f.black);
      int a1 = start + r1, a2 = a1 + r2;
      fill(row, width, start, a1, color);
      fill(row, width, a1, a2, color ^ 1);
      changes.push_back(std::min(a1, width));
      changes.push_back(std::min(a2, width));
      a0 = a2;
    } else if (mode == kExt) {
      throw Error("uncompressed mode is not supported");
    } else {
      int a1 = b1 + (mode - kV0);
      fill(row, width, a0, a1, color);
      changes.push_back(std::min(std::max(a1, 0), width));
      a0 = a1;
      color ^= 1;
    }
  }
  // drop elements at the row's end: the next row's b1 search stops there
  while (!changes.empty() && changes.back() >= width) changes.pop_back();
}

int fax(const uint8_t* in, long n, int mode, int t4options, int width,
        int rows, uint8_t* out) {
  const Fax& f = fax_tables();
  FaxBits br{in, n * 8};
  std::vector<int> ref, cur;
  memset(out, 0, (size_t)rows * width);
  int y = 0;
  try {
    for (; y < rows; y++) {
      uint8_t* row = out + (size_t)y * width;
      if (mode == 2) {
        decode_1d(br, f, row, width, cur);
        br.pos = (br.pos + 7) & ~7L;
      } else if (mode == 3) {
        sync_eol(br);
        bool one_d = true;
        if (t4options & 1) one_d = br.bit() == 1;
        if (one_d)
          decode_1d(br, f, row, width, cur);
        else
          decode_2d(br, f, row, width, ref, cur);
      } else {
        decode_2d(br, f, row, width, ref, cur);
      }
      ref.swap(cur);
      while (!ref.empty() && ref.back() >= width) ref.pop_back();
    }
  } catch (const Error& e) {
    // libtiff ends the strip at its data's end and keeps the rows before
    if (!br.at_end()) throw Error(std::string("corrupt CCITT data (") +
                                  e.what() + ") in row " + std::to_string(y));
  }
  return y;
}

}  // namespace

extern "C" {

long tiff_lzw(const uint8_t* in, long n, uint8_t* out, long cap) {
  return lzw(in, n, out, cap);
}

long tiff_lzw_compat(const uint8_t* in, long n, uint8_t* out, long cap) {
  return lzw_compat(in, n, out, cap);
}

long tiff_packbits(const uint8_t* in, long n, uint8_t* out, long cap) {
  return packbits(in, n, out, cap);
}

int tiff_fax(const uint8_t* in, long n, int mode, int t4options, int width,
             int rows, uint8_t* out, char* err, int errlen) {
  try {
    return fax(in, n, mode, t4options, width, rows, out);
  } catch (const std::exception& e) {
    snprintf(err, errlen, "%s", e.what());
    return -1;
  }
}

}  // extern "C"
