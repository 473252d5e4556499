// Baseline JPEG codec shared by the port's host libraries: the codec's
// own C interface (jpeg.cpp, bound in ursonet_torch/data/jpeg.py) and the
// batch loader (host_loader.cpp, bound in ursonet_torch/data/native_loader.py).
// Plain C++17, no libjpeg. Included by one translation unit of each library,
// so its definitions live in an anonymous namespace.
//
// The port's counterpart of the JPEG half of native/host_loader.cpp, which
// links libjpeg: the card's machine has no JPEG library. Built with g++ at
// first use by ursonet_torch/ops/cuda_build.py.
//
// Decoder: baseline sequential DCT (SOF0, SOF1) with Huffman coding,
// 8-bit samples, one component (gray) or three (YCbCr) with luma
// sampling 1x1, 2x1 or 2x2 and chroma 1x1, interleaved or not, restart
// intervals, any width and height. It reproduces what libjpeg-turbo
// gives with its defaults (and so what PIL gives), bit for bit:
//   * the integer IDCT of jidctint.c (jpeg_idct_islow: CONST_BITS 13,
//     PASS1_BITS 2, rounding descale, +128 through the range-limit table);
//   * jdsample.c's fancy upsampling (h2v1 / h2v2 triangle filters with
//     their alternating biases; the plain box copy at widths of 2 or less);
//   * jdcolor.c's fixed-point YCbCr -> RGB tables;
//   * a scan whose Huffman table the file never defined takes the
//     standard table of its slot (Annex K.3), as libjpeg does for the
//     Motion-JPEG frames of AVI files, which carry no DHT segment.
// Everything else raises, naming the feature: progressive, lossless,
// hierarchical or arithmetic-coded files, 12-bit samples, four
// components, other sampling factors.
//
// Encoder: one gray component as libjpeg-turbo writes it at a given
// quality with jpeg_set_defaults (what PIL writes for a mode-L image), or
// RGB as baseline YCbCr 4:2:0 with libjpeg's conversion and
// downsampling (encode_rgb; MJPEG video frames):
// the Annex K luminance table scaled by the IJG quality rule (capped at
// 255), jfdctint.c's integer FDCT, jcdctmgr.c's reciprocal quantizer, the
// Annex K Huffman tables, and edge replication into partial blocks.

#pragma once

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <initializer_list>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct JpegError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& what) { throw JpegError(what); }

// zigzag position -> natural (row-major) index; 16 extra entries keep a
// corrupt run length inside the block, as libjpeg's table does
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// ---------------------------------------------------------------------------
// jidctint.c / jfdctint.c constants (CONST_BITS 13)

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int64_t FIX_0_298631336 = 2446;
constexpr int64_t FIX_0_390180644 = 3196;
constexpr int64_t FIX_0_541196100 = 4433;
constexpr int64_t FIX_0_765366865 = 6270;
constexpr int64_t FIX_0_899976223 = 7373;
constexpr int64_t FIX_1_175875602 = 9633;
constexpr int64_t FIX_1_501321110 = 12299;
constexpr int64_t FIX_1_847759065 = 15137;
constexpr int64_t FIX_1_961570560 = 16069;
constexpr int64_t FIX_2_053119869 = 16819;
constexpr int64_t FIX_2_562915447 = 20995;
constexpr int64_t FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t(1) << (n - 1))) >> n;  // arithmetic shift
}

// jdmaster.c's post-IDCT range-limit table, indexed by (x & 1023) for a
// descaled IDCT output x (before the +128 level shift).
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; ++i) {
      if (i < 128) t[i] = uint8_t(i + 128);
      else if (i < 512) t[i] = 255;
      else if (i < 896) t[i] = 0;
      else t[i] = uint8_t(i - 896);
    }
  }
  uint8_t operator()(int64_t x) const { return t[int(x) & 1023]; }
};
const RangeLimit kRange;

// jpeg_idct_islow: dequantize, 8x8 inverse DCT, level shift, clamp.
void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out,
                int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const uint16_t* qt = q + c;
    int* w = ws + c;
    if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 &&
        in[40] == 0 && in[48] == 0 && in[56] == 0) {
      int dc = int(int64_t(in[0]) * qt[0]) * (1 << kPass1Bits);
      for (int r = 0; r < 8; ++r) w[8 * r] = dc;
      continue;
    }
    int64_t z2 = int64_t(in[16]) * qt[16];
    int64_t z3 = int64_t(in[48]) * qt[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = int64_t(in[0]) * qt[0];
    z3 = int64_t(in[32]) * qt[32];
    int64_t tmp0 = (z2 + z3) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (z2 - z3) * (int64_t(1) << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

    tmp0 = int64_t(in[56]) * qt[56];
    tmp1 = int64_t(in[40]) * qt[40];
    tmp2 = int64_t(in[24]) * qt[24];
    tmp3 = int64_t(in[8]) * qt[8];
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
    const int sh = kConstBits - kPass1Bits;
    w[0] = int(descale(tmp10 + tmp3, sh));
    w[56] = int(descale(tmp10 - tmp3, sh));
    w[8] = int(descale(tmp11 + tmp2, sh));
    w[48] = int(descale(tmp11 - tmp2, sh));
    w[16] = int(descale(tmp12 + tmp1, sh));
    w[40] = int(descale(tmp12 - tmp1, sh));
    w[24] = int(descale(tmp13 + tmp0, sh));
    w[32] = int(descale(tmp13 - tmp0, sh));
  }
  const int sh = kConstBits + kPass1Bits + 3;
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + r * stride;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 &&
        w[6] == 0 && w[7] == 0) {
      uint8_t v = kRange(descale(w[0], kPass1Bits + 3));
      for (int c = 0; c < 8; ++c) o[c] = v;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (int64_t(w[0]) + w[4]) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (int64_t(w[0]) - w[4]) * (int64_t(1) << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
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
    o[0] = kRange(descale(tmp10 + tmp3, sh));
    o[7] = kRange(descale(tmp10 - tmp3, sh));
    o[1] = kRange(descale(tmp11 + tmp2, sh));
    o[6] = kRange(descale(tmp11 - tmp2, sh));
    o[2] = kRange(descale(tmp12 + tmp1, sh));
    o[5] = kRange(descale(tmp12 - tmp1, sh));
    o[3] = kRange(descale(tmp13 + tmp0, sh));
    o[4] = kRange(descale(tmp13 - tmp0, sh));
  }
}

// ---------------------------------------------------------------------------
// the standard Huffman tables (ITU-T T.81 Annex K.3): the encoder's, and the
// decoder's for a scan whose table was never defined, as libjpeg's
// std_huff_tables (AVI MJPEG frames carry no DHT segment): slot 0 the
// luminance tables, slot 1 the chrominance ones

const uint8_t kDcBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcVals[162] = {
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

const uint8_t kDcBitsC[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kAcBitsC[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcValsC[162] = {
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

// (bits, values) of standard table `slot` (0 luminance, 1 chrominance)
inline const uint8_t* std_bits(bool ac, int slot) {
  return ac ? (slot ? kAcBitsC : kAcBits) : (slot ? kDcBitsC : kDcBits);
}
inline const uint8_t* std_vals(bool ac, int slot) {
  return ac ? (slot ? kAcValsC : kAcVals) : kDcVals;   // DC: 0..11 both
}

// ---------------------------------------------------------------------------
// decoder

struct Huffman {
  bool defined = false;
  uint8_t bits[17] = {};
  uint8_t vals[256] = {};
  int32_t maxcode[18] = {};
  int32_t mincode[17] = {};
  int32_t valptr[17] = {};
  uint16_t look[512] = {};  // (length << 8) | value for codes of <= 9 bits

  void build() {
    int count = 0;
    for (int l = 1; l <= 16; ++l) count += bits[l];
    if (count > 256) fail("corrupt data: Huffman table with >256 codes");
    int32_t code = 0;
    int k = 0;
    std::memset(look, 0, sizeof(look));
    for (int l = 1; l <= 16; ++l) {
      valptr[l] = k;
      mincode[l] = code;
      if (code + bits[l] >= (int32_t(1) << l))
        fail("corrupt data: bad Huffman table");
      for (int i = 0; i < bits[l]; ++i, ++code, ++k) {
        if (l <= 9) {
          int base = code << (9 - l);
          for (int j = 0; j < (1 << (9 - l)); ++j)
            look[base + j] = uint16_t((l << 8) | vals[k]);
        }
      }
      maxcode[l] = bits[l] ? code - 1 : -1;
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    defined = true;
  }
};

struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc = 0;   // bits left-aligned
  int nbits = 0;
  bool at_marker = false;

  BitReader(const uint8_t* p_, const uint8_t* e) : p(p_), end(e) {}

  void fill() {
    while (nbits <= 56) {
      uint32_t b = 0;
      if (!at_marker && p < end) {
        if (*p == 0xFF) {
          const uint8_t* q = p + 1;
          while (q < end && *q == 0xFF) ++q;   // fill bytes
          if (q < end && *q == 0x00) {
            b = 0xFF;
            p = q + 1;
          } else {
            at_marker = true;   // leave p on the marker; feed zeros
          }
        } else {
          b = *p++;
        }
      }
      acc |= uint64_t(b) << (56 - nbits);
      nbits += 8;
    }
  }
  int get(int n) {  // 1 <= n <= 16
    if (nbits < n) fill();
    int v = int(acc >> (64 - n));
    acc <<= n;
    nbits -= n;
    return v;
  }
  int decode(const Huffman& h) {
    if (nbits < 16) fill();
    uint16_t e = h.look[acc >> (64 - 9)];
    if (e >> 8) {
      int l = e >> 8;
      acc <<= l;
      nbits -= l;
      return e & 0xFF;
    }
    for (int l = 10; l <= 16; ++l) {
      int32_t code = int32_t(acc >> (64 - l));
      if (code <= h.maxcode[l]) {
        acc <<= l;
        nbits -= l;
        return h.vals[(h.valptr[l] + code - h.mincode[l]) & 0xFF];
      }
    }
    fail("corrupt data: bad Huffman code");
  }
  // discard buffered bits and step over the restart marker that follows
  void restart() {
    acc = 0;
    nbits = 0;
    at_marker = false;
    while (p + 1 < end && !(p[0] == 0xFF && p[1] != 0x00 && p[1] != 0xFF))
      ++p;
    if (p + 1 >= end || p[1] < 0xD0 || p[1] > 0xD7)
      fail("corrupt data: missing restart marker");
    p += 2;
  }
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dc_tbl = 0, ac_tbl = 0;
  int bw = 0, bh = 0;      // blocks across and down (MCU-padded)
  int cw = 0, ch = 0;      // sample width and height (downsampled)
  bool latched = false;
  uint16_t q[64] = {};
  std::vector<int16_t> coef;
  std::vector<uint8_t> plane;  // bw*8 x bh*8 samples after the IDCT
};

struct Decoder {
  const uint8_t* data;
  size_t n;
  size_t pos = 0;
  int width = 0, height = 0;
  bool have_frame = false, jfif = false;
  int adobe_transform = -1;
  int restart_interval = 0;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  uint16_t qt[4][64] = {};
  bool qt_defined[4] = {};
  Huffman dc[4], ac[4];
  std::vector<Component> comps;

  Decoder(const uint8_t* d, size_t len) : data(d), n(len) {}

  int u8() {
    if (pos >= n) fail("corrupt data: truncated file");
    return data[pos++];
  }
  int u16() {
    int a = u8();
    return (a << 8) | u8();
  }

  // next marker code, skipping fill bytes
  int marker() {
    if (u8() != 0xFF) fail("corrupt data: expected a marker");
    int m;
    do m = u8(); while (m == 0xFF);
    return m;
  }

  void parse_headers(bool stop_at_frame) {
    if (n < 2 || data[0] != 0xFF || data[1] != 0xD8) fail("not a JPEG file");
    pos = 2;
    for (;;) {
      int m = marker();
      if (m == 0xD9) break;   // EOI
      if (m >= 0xD0 && m <= 0xD7) continue;
      if (m == 0x01) continue;
      int len = u16();
      if (len < 2 || pos + len - 2 > n) fail("corrupt data: bad segment length");
      size_t seg_end = pos + len - 2;
      switch (m) {
        case 0xC0: case 0xC1: read_frame(seg_end); break;
        case 0xC2: fail("progressive JPEG (SOF2) is not supported");
        case 0xC3: fail("lossless JPEG (SOF3) is not supported");
        case 0xC5: case 0xC6: case 0xC7:
          fail("hierarchical (differential) JPEG is not supported");
        case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
        case 0xCC:
          fail("arithmetic-coded JPEG is not supported");
        case 0xC4: read_dht(seg_end); break;
        case 0xDB: read_dqt(seg_end); break;
        case 0xDD: restart_interval = u16(); break;
        case 0xE0:
          if (len >= 7 && std::memcmp(data + pos, "JFIF\0", 5) == 0) jfif = true;
          break;
        case 0xEE:
          if (len >= 14 && std::memcmp(data + pos, "Adobe", 5) == 0)
            adobe_transform = data[pos + 11];
          break;
        case 0xDA:
          if (stop_at_frame) return;
          read_scan(seg_end);
          continue;   // read_scan leaves pos after the entropy data
        default: break;
      }
      pos = seg_end;
      if (stop_at_frame && have_frame) return;
    }
    if (!have_frame) fail("corrupt data: no frame header");
  }

  void read_frame(size_t seg_end) {
    if (have_frame) fail("corrupt data: two frame headers");
    int precision = u8();
    if (precision != 8)
      fail(std::to_string(precision) + "-bit samples are not supported");
    height = u16();
    width = u16();
    int nc = u8();
    if (height == 0) fail("a height defined by a DNL marker is not supported");
    if (width == 0) fail("corrupt data: zero width");
    if (nc == 4) fail("four-component (CMYK/YCCK) JPEG is not supported");
    if (nc != 1 && nc != 3)
      fail(std::to_string(nc) + "-component JPEG is not supported");
    if (pos + 3 * size_t(nc) > seg_end) fail("corrupt data: short frame header");
    comps.resize(nc);
    for (auto& c : comps) {
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8() & 3;
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4)
        fail("corrupt data: bad sampling factors");
    }
    if (nc == 1) {
      comps[0].h = comps[0].v = 1;   // one component: no subsampling
    } else {
      const Component& y = comps[0];
      bool luma_ok = (y.h == 1 && y.v == 1) || (y.h == 2 && y.v == 1) ||
                     (y.h == 2 && y.v == 2);
      if (!luma_ok || comps[1].h != 1 || comps[1].v != 1 ||
          comps[2].h != 1 || comps[2].v != 1)
        fail("sampling factors " + std::to_string(y.h) + "x" +
             std::to_string(y.v) + "," + std::to_string(comps[1].h) + "x" +
             std::to_string(comps[1].v) + "," + std::to_string(comps[2].h) +
             "x" + std::to_string(comps[2].v) + " are not supported");
      if (adobe_transform == 0 ||
          (!jfif && adobe_transform < 0 && comps[0].id == 'R' &&
           comps[1].id == 'G' && comps[2].id == 'B'))
        fail("RGB-coded (untransformed) JPEG is not supported");
    }
    hmax = vmax = 1;
    for (auto& c : comps) {
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (auto& c : comps) {
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.cw = int((int64_t(width) * c.h + hmax - 1) / hmax);
      c.ch = int((int64_t(height) * c.v + vmax - 1) / vmax);
      c.coef.assign(size_t(c.bw) * c.bh * 64, 0);
    }
    have_frame = true;
  }

  void read_dht(size_t seg_end) {
    while (pos < seg_end) {
      int tc = u8();
      int cls = tc >> 4, id = tc & 15;
      if (cls > 1 || id > 3) fail("corrupt data: bad Huffman table id");
      Huffman& h = cls ? ac[id] : dc[id];
      int count = 0;
      for (int l = 1; l <= 16; ++l) {
        h.bits[l] = uint8_t(u8());
        count += h.bits[l];
      }
      if (count > 256 || pos + count > seg_end)
        fail("corrupt data: bad Huffman table");
      for (int i = 0; i < count; ++i) h.vals[i] = uint8_t(u8());
      h.build();
    }
  }

  void read_dqt(size_t seg_end) {
    while (pos < seg_end) {
      int pq = u8();
      int prec = pq >> 4, id = pq & 15;
      if (id > 3 || prec > 1) fail("corrupt data: bad quantization table");
      for (int k = 0; k < 64; ++k)
        qt[id][kNatural[k]] = uint16_t(prec ? u16() : u8());
      qt_defined[id] = true;
    }
  }

  void decode_block(BitReader& br, Component& c, int bx, int by, int& pred) {
    int16_t* blk = c.coef.data() + (size_t(by) * c.bw + bx) * 64;
    const Huffman& hd = dc[c.dc_tbl];
    const Huffman& ha = ac[c.ac_tbl];
    int s = br.decode(hd);
    int diff = 0;
    if (s) {
      if (s > 16) fail("corrupt data: bad DC category");
      diff = extend(br.get(s), s);
    }
    pred += diff;
    blk[0] = int16_t(pred);
    for (int k = 1; k < 64; ++k) {
      int rs = br.decode(ha);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = int16_t(extend(br.get(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  // a table the file never defined: the standard one of its slot (0 or 1,
  // as libjpeg loads them for Motion-JPEG), else an error
  static void load_std_table(Huffman& h, bool is_ac, int slot) {
    if (h.defined) return;
    if (slot > 1) fail("corrupt data: undefined Huffman table");
    const uint8_t* bits = std_bits(is_ac, slot);
    int count = 0;
    for (int l = 1; l <= 16; ++l) {
      h.bits[l] = bits[l];
      count += bits[l];
    }
    std::memcpy(h.vals, std_vals(is_ac, slot), size_t(count));
    h.build();
  }

  void read_scan(size_t seg_end) {
    if (!have_frame) fail("corrupt data: scan before frame header");
    int ns = u8();
    if (ns < 1 || ns > 4) fail("corrupt data: bad scan header");
    std::vector<Component*> sc;
    for (int i = 0; i < ns; ++i) {
      int id = u8(), tt = u8();
      Component* found = nullptr;
      for (auto& c : comps)
        if (c.id == id) found = &c;
      if (!found) fail("corrupt data: scan names an unknown component");
      found->dc_tbl = tt >> 4 & 3;
      found->ac_tbl = tt & 3;
      load_std_table(dc[found->dc_tbl], false, found->dc_tbl);
      load_std_table(ac[found->ac_tbl], true, found->ac_tbl);
      if (!found->latched) {
        if (!qt_defined[found->tq])
          fail("corrupt data: undefined quantization table");
        std::memcpy(found->q, qt[found->tq], sizeof(found->q));
        found->latched = true;
      }
      sc.push_back(found);
    }
    int ss = u8(), se = u8(), a = u8();
    if (ss != 0 || se != 63 || a != 0)
      fail("corrupt data: spectral selection in a sequential scan");
    pos = seg_end;

    BitReader br(data + pos, data + n);
    std::vector<int> pred(ns, 0);
    int todo = restart_interval;
    auto next_mcu = [&]() {
      if (!restart_interval) return;
      if (todo == 0) {
        br.restart();
        std::fill(pred.begin(), pred.end(), 0);
        todo = restart_interval;
      }
      --todo;
    };
    if (ns == 1) {
      Component& c = *sc[0];
      int bx_n = (c.cw + 7) / 8, by_n = (c.ch + 7) / 8;
      for (int by = 0; by < by_n; ++by)
        for (int bx = 0; bx < bx_n; ++bx) {
          next_mcu();
          decode_block(br, c, bx, by, pred[0]);
        }
    } else {
      for (int my = 0; my < mcuy; ++my)
        for (int mx = 0; mx < mcux; ++mx) {
          next_mcu();
          for (int i = 0; i < ns; ++i) {
            Component& c = *sc[i];
            for (int v = 0; v < c.v; ++v)
              for (int h = 0; h < c.h; ++h)
                decode_block(br, c, mx * c.h + h, my * c.v + v, pred[i]);
          }
        }
    }
    // step past the entropy-coded data to the next marker
    const uint8_t* p = br.p;
    while (p + 1 < data + n &&
           !(p[0] == 0xFF && p[1] != 0x00 && !(p[1] >= 0xD0 && p[1] <= 0xD7)))
      ++p;
    pos = size_t(p - data);
  }

  void idct_all() {
    for (auto& c : comps) {
      if (!c.latched) fail("corrupt data: a component has no scan");
      int stride = c.bw * 8;
      c.plane.assign(size_t(stride) * c.bh * 8, 0);
      for (int by = 0; by < c.bh; ++by)
        for (int bx = 0; bx < c.bw; ++bx)
          idct_islow(c.coef.data() + (size_t(by) * c.bw + bx) * 64, c.q,
                     c.plane.data() + size_t(by) * 8 * stride + bx * 8,
                     stride);
    }
  }

  // one chroma plane brought to the luma grid: (cw*h) x (ch*v) samples,
  // row stride `ow`
  std::vector<uint8_t> upsample(const Component& c, int fh, int fv,
                                int& ow) const {
    const int stride = c.bw * 8;
    ow = c.cw * fh;
    const int oh = c.ch * fv;
    std::vector<uint8_t> out(size_t(ow) * oh);
    auto row = [&](int y) { return c.plane.data() + size_t(y) * stride; };
    const bool fancy = c.cw > 2;
    for (int y = 0; y < c.ch; ++y) {
      const uint8_t* in = row(y);
      if (fh == 1) {
        std::memcpy(out.data() + size_t(y) * ow, in, c.cw);
        continue;
      }
      if (fv == 1) {
        uint8_t* o = out.data() + size_t(y) * ow;
        if (!fancy) {
          for (int x = 0; x < c.cw; ++x) o[2 * x] = o[2 * x + 1] = in[x];
          continue;
        }
        // jdsample.c h2v1_fancy_upsample
        int v0 = in[0];
        o[0] = uint8_t(v0);
        o[1] = uint8_t((v0 * 3 + in[1] + 2) >> 2);
        for (int x = 1; x < c.cw - 1; ++x) {
          int v = in[x] * 3;
          o[2 * x] = uint8_t((v + in[x - 1] + 1) >> 2);
          o[2 * x + 1] = uint8_t((v + in[x + 1] + 2) >> 2);
        }
        int last = in[c.cw - 1];
        o[2 * c.cw - 2] = uint8_t((last * 3 + in[c.cw - 2] + 1) >> 2);
        o[2 * c.cw - 1] = uint8_t(last);
        continue;
      }
      for (int v = 0; v < 2; ++v) {
        uint8_t* o = out.data() + size_t(2 * y + v) * ow;
        if (!fancy) {
          for (int x = 0; x < c.cw; ++x) o[2 * x] = o[2 * x + 1] = in[x];
          continue;
        }
        // jdsample.c h2v2_fancy_upsample; the context rows above the first
        // and below the last are those rows again (jdmainct.c)
        int ny = v == 0 ? (y > 0 ? y - 1 : 0) : (y + 1 < c.ch ? y + 1 : y);
        const uint8_t* in1 = row(ny);
        int thiscol = in[0] * 3 + in1[0];
        int nextcol = in[1] * 3 + in1[1];
        o[0] = uint8_t((thiscol * 4 + 8) >> 4);
        o[1] = uint8_t((thiscol * 3 + nextcol + 7) >> 4);
        int lastcol = thiscol;
        thiscol = nextcol;
        for (int x = 1; x < c.cw - 1; ++x) {
          nextcol = in[x + 1] * 3 + in1[x + 1];
          o[2 * x] = uint8_t((thiscol * 3 + lastcol + 8) >> 4);
          o[2 * x + 1] = uint8_t((thiscol * 3 + nextcol + 7) >> 4);
          lastcol = thiscol;
          thiscol = nextcol;
        }
        o[2 * c.cw - 2] = uint8_t((thiscol * 3 + lastcol + 8) >> 4);
        o[2 * c.cw - 1] = uint8_t((thiscol * 4 + 7) >> 4);
      }
    }
    return out;
  }

  void write(uint8_t* out) const {
    const Component& y = comps[0];
    const int ys = y.bw * 8;
    if (comps.size() == 1) {
      for (int r = 0; r < height; ++r)
        std::memcpy(out + size_t(r) * width, y.plane.data() + size_t(r) * ys,
                    width);
      return;
    }
    int cbw = 0, crw = 0;
    std::vector<uint8_t> cb = upsample(comps[1], hmax, vmax, cbw);
    std::vector<uint8_t> cr = upsample(comps[2], hmax, vmax, crw);
    // jdcolor.c build_ycc_rgb_table (SCALEBITS 16)
    const int64_t one_half = int64_t(1) << 15;
    auto fix = [](double x) { return int64_t(x * 65536.0 + 0.5); };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = int((fix(1.40200) * x + one_half) >> 16);
      cb_b[i] = int((fix(1.77200) * x + one_half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + one_half;
    }
    auto clamp = [](int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); };
    for (int r = 0; r < height; ++r) {
      const uint8_t* yr = y.plane.data() + size_t(r) * ys;
      const uint8_t* br = cb.data() + size_t(r) * cbw;
      const uint8_t* rr = cr.data() + size_t(r) * crw;
      uint8_t* o = out + size_t(r) * width * 3;
      for (int x = 0; x < width; ++x) {
        int Y = yr[x], Cb = br[x], Cr = rr[x];
        o[3 * x] = clamp(Y + cr_r[Cr]);
        o[3 * x + 1] = clamp(Y + int((cb_g[Cb] + cr_g[Cr]) >> 16));
        o[3 * x + 2] = clamp(Y + cb_b[Cb]);
      }
    }
  }
};

// ---------------------------------------------------------------------------
// encoder

const uint8_t kStdLuma[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};

struct EncTable {
  uint16_t code[256] = {};
  uint8_t size[256] = {};
  EncTable(const uint8_t* bits, const uint8_t* vals) {
    int code_v = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      for (int i = 0; i < bits[l]; ++i, ++k, ++code_v) {
        code[vals[k]] = uint16_t(code_v);
        size[vals[k]] = uint8_t(l);
      }
      code_v <<= 1;
    }
  }
};

struct BitWriter {
  std::vector<uint8_t>& out;
  uint32_t acc = 0;
  int nbits = 0;
  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
  void put(uint32_t bits, int n) {
    acc = (acc << n) | (bits & ((1u << n) - 1));
    nbits += n;
    while (nbits >= 8) {
      uint8_t b = uint8_t(acc >> (nbits - 8));
      out.push_back(b);
      if (b == 0xFF) out.push_back(0);
      nbits -= 8;
    }
  }
  void flush() {
    if (nbits) put(0x7F, 8 - nbits);   // pad with 1 bits
  }
};

// jcdctmgr.c compute_reciprocal with a 16-bit DCTELEM
struct Divisor {
  uint32_t recip, corr, shift;
};

Divisor reciprocal(uint32_t divisor) {
  int b = 0;
  while ((divisor >> (b + 1)) != 0) ++b;   // flss(divisor) - 1
  int r = 16 + b;
  uint32_t fq = (uint32_t(1) << r) / divisor;
  uint32_t fr = (uint32_t(1) << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    --r;
  } else if (fr <= divisor / 2) {
    ++c;
  } else {
    ++fq;
  }
  return {fq & 0xFFFF, c & 0xFFFF, uint32_t(r - 16)};
}

// jfdctint.c jpeg_fdct_islow on a level-shifted block, in place
void fdct_islow(int32_t* d) {
  for (int pass = 0; pass < 2; ++pass) {
    const int step = pass == 0 ? 1 : 8;    // along a row, then a column
    const int next = pass == 0 ? 8 : 1;
    for (int i = 0; i < 8; ++i) {
      int32_t* p = d + i * next;
      int64_t tmp0 = p[0] + p[7 * step], tmp7 = p[0] - p[7 * step];
      int64_t tmp1 = p[step] + p[6 * step], tmp6 = p[step] - p[6 * step];
      int64_t tmp2 = p[2 * step] + p[5 * step],
              tmp5 = p[2 * step] - p[5 * step];
      int64_t tmp3 = p[3 * step] + p[4 * step],
              tmp4 = p[3 * step] - p[4 * step];
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
      const int sh = pass == 0 ? kConstBits - kPass1Bits
                               : kConstBits + kPass1Bits;
      if (pass == 0) {
        p[0] = int32_t((tmp10 + tmp11) * (1 << kPass1Bits));
        p[4 * step] = int32_t((tmp10 - tmp11) * (1 << kPass1Bits));
      } else {
        p[0] = int32_t(descale(tmp10 + tmp11, kPass1Bits));
        p[4 * step] = int32_t(descale(tmp10 - tmp11, kPass1Bits));
      }
      p[2 * step] = int32_t(descale(z1 + tmp13 * FIX_0_765366865, sh));
      p[6 * step] = int32_t(descale(z1 + tmp12 * -FIX_1_847759065, sh));

      z1 = tmp4 + tmp7;
      int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      int64_t z5 = (z3 + z4) * FIX_1_175875602;
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
      p[7 * step] = int32_t(descale(tmp4 + z1 + z3, sh));
      p[5 * step] = int32_t(descale(tmp5 + z2 + z4, sh));
      p[3 * step] = int32_t(descale(tmp6 + z2 + z3, sh));
      p[step] = int32_t(descale(tmp7 + z1 + z4, sh));
    }
  }
}

void put16(std::vector<uint8_t>& o, int v) {
  o.push_back(uint8_t(v >> 8));
  o.push_back(uint8_t(v & 0xFF));
}

const uint8_t kStdChroma[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// `base` scaled by the IJG quality rule (capped at 255: force_baseline),
// and the quantizer's divisors
struct QTable {
  uint16_t q[64];
  Divisor div[64];
  QTable(const uint8_t* base, int quality) {
    if (quality < 1) quality = 1;
    if (quality > 100) quality = 100;
    int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
    for (int i = 0; i < 64; ++i) {
      int64_t t = (int64_t(base[i]) * scale + 50) / 100;
      if (t <= 0) t = 1;
      if (t > 255) t = 255;
      q[i] = uint16_t(t);
      div[i] = reciprocal(uint32_t(t) << 3);
    }
  }
};

// one component's blocks: FDCT, quantize, Huffman-code (DC predicted)
struct BlockCoder {
  BitWriter& bw;
  const QTable& qt;
  const EncTable& dct;
  const EncTable& act;
  int last_dc = 0;

  // a level-shifted 8x8 block, in place
  void code(int32_t* blk) {
    int16_t coef[64];
    fdct_islow(blk);
    for (int i = 0; i < 64; ++i) {
      int32_t t = int16_t(blk[i]);
      bool neg = t < 0;
      if (neg) t = -t;
      uint32_t prod = uint32_t(t + int32_t(qt.div[i].corr)) * qt.div[i].recip;
      prod >>= qt.div[i].shift + 16;
      int16_t v = int16_t(prod);
      coef[i] = neg ? int16_t(-v) : v;
    }
    int diff = coef[0] - last_dc;
    last_dc = coef[0];
    int t = diff < 0 ? -diff : diff, t2 = diff < 0 ? diff - 1 : diff;
    int nb = 0;
    while (t) { ++nb; t >>= 1; }
    bw.put(dct.code[nb], dct.size[nb]);
    if (nb) bw.put(uint32_t(t2), nb);
    int run = 0;
    for (int k = 1; k < 64; ++k) {
      int v = coef[kNatural[k]];
      if (v == 0) { ++run; continue; }
      while (run > 15) {
        bw.put(act.code[0xF0], act.size[0xF0]);
        run -= 16;
      }
      int a = v < 0 ? -v : v, a2 = v < 0 ? v - 1 : v;
      nb = 0;
      while (a) { ++nb; a >>= 1; }
      int sym = (run << 4) + nb;
      bw.put(act.code[sym], act.size[sym]);
      bw.put(uint32_t(a2), nb);
      run = 0;
    }
    if (run > 0) bw.put(act.code[0], act.size[0]);
  }

  // the 8x8 block at (x0, y0) of a w-wide plane (already padded)
  void code_at(const uint8_t* plane, int w, int x0, int y0) {
    int32_t blk[64];
    for (int r = 0; r < 8; ++r)
      for (int c = 0; c < 8; ++c)
        blk[8 * r + c] = int32_t(plane[size_t(y0 + r) * w + x0 + c]) - 128;
    code(blk);
  }
};

void put_dqt(std::vector<uint8_t>& o, int id, const QTable& t) {
  o.push_back(0xFF); o.push_back(0xDB); put16(o, 67); o.push_back(uint8_t(id));
  for (int k = 0; k < 64; ++k) o.push_back(uint8_t(t.q[kNatural[k]]));
}

struct HuffSpec {
  int tc;                 // class << 4 | slot
  const uint8_t* bits;    // [17], bits[0] unused
  const uint8_t* vals;
};

// one DHT segment holding every table of `specs`
void put_dht(std::vector<uint8_t>& o, std::initializer_list<HuffSpec> specs) {
  int len = 2;
  for (const HuffSpec& h : specs) {
    len += 17;
    for (int l = 1; l <= 16; ++l) len += h.bits[l];
  }
  o.push_back(0xFF); o.push_back(0xC4); put16(o, len);
  for (const HuffSpec& h : specs) {
    int count = 0;
    for (int l = 1; l <= 16; ++l) count += h.bits[l];
    o.push_back(uint8_t(h.tc));
    o.insert(o.end(), h.bits + 1, h.bits + 17);
    o.insert(o.end(), h.vals, h.vals + count);
  }
}

// SOI and a JFIF 1.1 APP0 segment (no thumbnail)
void put_head(std::vector<uint8_t>& o) {
  const uint8_t head[] = {0xFF, 0xD8, 0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I',
                          'F',  0x00, 0x01, 0x01, 0x00, 0x00, 0x01, 0x00,
                          0x01, 0x00, 0x00};
  o.insert(o.end(), head, head + sizeof(head));
}

void check_size(int h, int w) {
  if (h < 1 || w < 1 || h > 65535 || w > 65535)
    fail("image size out of JPEG's range");
}

std::vector<uint8_t> encode_gray(const uint8_t* px, int h, int w,
                                 int quality) {
  check_size(h, w);
  const QTable qt(kStdLuma, quality);
  std::vector<uint8_t> o;
  o.reserve(size_t(h) * w / 2 + 1024);
  put_head(o);
  put_dqt(o, 0, qt);
  o.push_back(0xFF); o.push_back(0xC0); put16(o, 11); o.push_back(8);
  put16(o, h); put16(o, w);
  o.push_back(1); o.push_back(1); o.push_back(0x11); o.push_back(0);
  put_dht(o, {{0x00, kDcBits, kDcVals}, {0x10, kAcBits, kAcVals}});
  const uint8_t sos[] = {0xFF, 0xDA, 0x00, 0x08, 0x01, 0x01,
                         0x00, 0x00, 0x3F, 0x00};
  o.insert(o.end(), sos, sos + sizeof(sos));

  static const EncTable dct(kDcBits, kDcVals), act(kAcBits, kAcVals);
  BitWriter bw(o);
  BlockCoder coder{bw, qt, dct, act};
  int32_t blk[64];
  for (int by = 0; by < (h + 7) / 8; ++by) {
    for (int bx = 0; bx < (w + 7) / 8; ++bx) {
      for (int r = 0; r < 8; ++r) {
        int y = std::min(by * 8 + r, h - 1);   // replicate the last row
        for (int c = 0; c < 8; ++c) {
          int x = std::min(bx * 8 + c, w - 1);   // and the last column
          blk[8 * r + c] = int32_t(px[size_t(y) * w + x]) - 128;
        }
      }
      coder.code(blk);
    }
  }
  bw.flush();
  o.push_back(0xFF);
  o.push_back(0xD9);
  return o;
}

// jccolor.c's fixed-point RGB -> YCbCr (SCALEBITS 16)
constexpr int kScaleBits = 16;
constexpr int32_t fix(double x) {
  return int32_t(x * (1 << kScaleBits) + 0.5);
}

// An [h, w, 3] RGB image as baseline YCbCr 4:2:0 (libjpeg's default
// sampling: 2x2 luma blocks, one Cb and one Cr block an MCU), the Annex K
// luminance and chrominance tables scaled by `quality`, jccolor.c's
// conversion and jcsample.c's h2v2 box downsampling (biases 1, 2
// alternating). The image is extended to whole 16x16 MCUs by replicating
// its last column and row.
std::vector<uint8_t> encode_rgb(const uint8_t* px, int h, int w,
                                int quality) {
  check_size(h, w);
  const QTable ql(kStdLuma, quality), qc(kStdChroma, quality);
  const int W = (w + 15) / 16 * 16, H = (h + 15) / 16 * 16;
  std::vector<uint8_t> Y(size_t(W) * H), Cb(size_t(W / 2) * (H / 2)),
      Cr(size_t(W / 2) * (H / 2));
  std::vector<uint8_t> cb_full(size_t(W) * 2), cr_full(size_t(W) * 2);
  const int32_t half = 1 << (kScaleBits - 1);
  const int32_t cbcr_off = (128 << kScaleBits) + half - 1;
  for (int y2 = 0; y2 < H / 2; ++y2) {
    for (int dy = 0; dy < 2; ++dy) {
      const int y = 2 * y2 + dy;
      const uint8_t* row = px + size_t(std::min(y, h - 1)) * w * 3;
      for (int x = 0; x < W; ++x) {
        const uint8_t* p = row + size_t(std::min(x, w - 1)) * 3;
        const int32_t r = p[0], g = p[1], b = p[2];
        Y[size_t(y) * W + x] = uint8_t(
            (fix(0.29900) * r + fix(0.58700) * g + fix(0.11400) * b + half) >>
            kScaleBits);
        cb_full[size_t(dy) * W + x] = uint8_t(
            (-fix(0.16874) * r - fix(0.33126) * g + fix(0.5) * b + cbcr_off) >>
            kScaleBits);
        cr_full[size_t(dy) * W + x] = uint8_t(
            (fix(0.5) * r - fix(0.41869) * g - fix(0.08131) * b + cbcr_off) >>
            kScaleBits);
      }
    }
    for (int x2 = 0; x2 < W / 2; ++x2) {
      const int bias = 1 + (x2 & 1);
      const size_t a = size_t(2 * x2), b = size_t(W) + 2 * x2;
      Cb[size_t(y2) * (W / 2) + x2] = uint8_t(
          (cb_full[a] + cb_full[a + 1] + cb_full[b] + cb_full[b + 1] + bias) >>
          2);
      Cr[size_t(y2) * (W / 2) + x2] = uint8_t(
          (cr_full[a] + cr_full[a + 1] + cr_full[b] + cr_full[b + 1] + bias) >>
          2);
    }
  }

  std::vector<uint8_t> o;
  o.reserve(size_t(h) * w / 2 + 2048);
  put_head(o);
  put_dqt(o, 0, ql);
  put_dqt(o, 1, qc);
  o.push_back(0xFF); o.push_back(0xC0); put16(o, 17); o.push_back(8);
  put16(o, h); put16(o, w); o.push_back(3);
  const uint8_t comps[] = {1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1};
  o.insert(o.end(), comps, comps + sizeof(comps));
  put_dht(o, {{0x00, kDcBits, kDcVals}, {0x10, kAcBits, kAcVals},
              {0x01, kDcBitsC, kDcVals}, {0x11, kAcBitsC, kAcValsC}});
  const uint8_t sos[] = {0xFF, 0xDA, 0x00, 0x0C, 0x03, 0x01, 0x00, 0x02,
                         0x11, 0x03, 0x11, 0x00, 0x3F, 0x00};
  o.insert(o.end(), sos, sos + sizeof(sos));

  static const EncTable dcl(kDcBits, kDcVals), acl(kAcBits, kAcVals),
      dcc(kDcBitsC, kDcVals), acc(kAcBitsC, kAcValsC);
  BitWriter bw(o);
  BlockCoder cy{bw, ql, dcl, acl}, cb{bw, qc, dcc, acc}, cr{bw, qc, dcc, acc};
  for (int my = 0; my < H / 16; ++my) {
    for (int mx = 0; mx < W / 16; ++mx) {
      for (int j = 0; j < 4; ++j)
        cy.code_at(Y.data(), W, 16 * mx + 8 * (j & 1), 16 * my + 8 * (j >> 1));
      cb.code_at(Cb.data(), W / 2, 8 * mx, 8 * my);
      cr.code_at(Cr.data(), W / 2, 8 * mx, 8 * my);
    }
  }
  bw.flush();
  o.push_back(0xFF);
  o.push_back(0xD9);
  return o;
}

}  // namespace
