// Zstandard frame decoder (RFC 8878) for the host, and the CRC-32C that
// OCDBT puts after every manifest and B-tree node, bound through a plain C
// interface (ctypes; see ursonet_torch/checkpoint/zstd.py). Plain C++17,
// no libzstd.
//
// It decodes what any zstd encoder writes without a dictionary: frame
// headers with and without the content size, several frames (and
// skippable frames) in one buffer, raw, RLE and compressed blocks,
// literals raw, RLE, Huffman-coded in 1 or 4 streams or treeless, the FSE
// tables in predefined, RLE, compressed and repeat modes, the three repeat
// offsets, and the XXH64 content checksum. A frame that names a
// dictionary, and any input that breaks the format, throws with the byte
// offset of the fault in the input; nothing is skipped.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <new>
#include <cstring>
#include <exception>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

constexpr uint32_t kFrameMagic = 0xFD2FB528u;
constexpr uint32_t kSkippableMagic = 0x184D2A50u;  // low 4 bits: any
constexpr size_t kBlockMax = 128 * 1024;
constexpr int kHufMaxBits = 11;

[[noreturn]] void fail(size_t off, const std::string& what) {
  throw std::runtime_error("zstd: at byte " + std::to_string(off) + ": " +
                           what);
}

int highest_bit(uint64_t x) {  // floor(log2(x)), x > 0
  return 63 - __builtin_clzll(x);
}

uint64_t load_le(const uint8_t* p, size_t n) {  // n <= 8
  uint64_t v = 0;
  if (n == 8) {
    std::memcpy(&v, p, 8);  // little-endian hosts (x86-64, AArch64)
    return v;
  }
  for (size_t i = 0; i < n; ++i) v |= uint64_t(p[i]) << (8 * i);
  return v;
}

// The decoded bytes: grows without zero-filling what it is about to write.
struct Buffer {
  uint8_t* p = nullptr;
  size_t n = 0, cap = 0;
  Buffer() = default;
  Buffer(const Buffer&) = delete;
  Buffer& operator=(const Buffer&) = delete;
  ~Buffer() { std::free(p); }
  void reserve(size_t want) {
    if (want <= cap) return;
    uint8_t* q = static_cast<uint8_t*>(std::realloc(p, want));
    if (!q) throw std::bad_alloc();
    p = q;
    cap = want;
  }
  uint8_t* grow(size_t k) {  // k more bytes at the end; returns where they go
    if (n + k > cap) reserve(std::max(n + k, cap + cap / 2 + 4096));
    n += k;
    return p + n - k;
  }
  size_t size() const { return n; }
};

// ---------------------------------------------------------------------------
// XXH64 (the frame's content checksum is its low 32 bits, seed 0)

constexpr uint64_t P1 = 11400714785074694791ull, P2 = 14029467366897019727ull,
                   P3 = 1609587929392839161ull, P4 = 9650029242287828579ull,
                   P5 = 2870177450012600261ull;

uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
uint64_t xxh_round(uint64_t acc, uint64_t in) {
  return rotl(acc + in * P2, 31) * P1;
}
uint64_t xxh_merge(uint64_t acc, uint64_t v) {
  return (acc ^ xxh_round(0, v)) * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, size_t n, uint64_t seed) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    for (; p + 32 <= end; p += 32) {
      v1 = xxh_round(v1, load_le(p, 8));
      v2 = xxh_round(v2, load_le(p + 8, 8));
      v3 = xxh_round(v3, load_le(p + 16, 8));
      v4 = xxh_round(v4, load_le(p + 24, 8));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xxh_merge(xxh_merge(xxh_merge(xxh_merge(h, v1), v2), v3), v4);
  } else {
    h = seed + P5;
  }
  h += n;
  for (; p + 8 <= end; p += 8) h = rotl(h ^ xxh_round(0, load_le(p, 8)), 27) * P1 + P4;
  if (p + 4 <= end) {
    h = rotl(h ^ (load_le(p, 4) * P1), 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; ++p) h = rotl(h ^ (*p * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ---------------------------------------------------------------------------
// bit streams

// Forward, least significant bit first (FSE table descriptions).
struct ForwardBits {
  const uint8_t* p;
  size_t n;
  size_t base;  // offset of p in the input, for messages
  size_t bit = 0;
  // Bits past the end read as zeros (a field may be read one bit wider
  // than it is); bytes() checks that what was kept lies inside.
  uint32_t read(int nb) {
    uint32_t v = 0;
    for (int i = 0; i < nb; ++i, ++bit)
      if (bit < n * 8) v |= uint32_t((p[bit >> 3] >> (bit & 7)) & 1) << i;
    return v;
  }
  size_t bytes() const {
    if (bit > n * 8) fail(base + n, "FSE table description runs past its section");
    return (bit + 7) >> 3;
  }
};

// Backward: the stream's last byte holds a 1 above its final bit, and bits
// are read from there down toward the first byte. Bits below the start read
// as zeros; the callers check where the stream ends.
struct BackwardBits {
  const uint8_t* p;
  size_t n;
  int64_t bit;  // bits not yet read lie in [0, bit)

  BackwardBits(const uint8_t* src, size_t len, size_t base) : p(src), n(len) {
    if (len == 0) fail(base, "empty bit stream");
    if (src[len - 1] == 0) fail(base + len - 1, "bit stream without its end marker");
    bit = int64_t(len) * 8 - 8 + highest_bit(src[len - 1]);
  }
  uint64_t read(int nb) {  // nb <= 56
    if (nb == 0) return 0;
    bit -= nb;
    if (bit >= 0) return extract(size_t(bit), nb);
    const int width = nb + int(bit);  // the bits below the start are zeros
    return width <= 0 ? 0 : extract(0, width) << (-bit);
  }
  uint64_t extract(size_t lo, int width) const {
    const size_t byte = lo >> 3;
    const uint64_t w = load_le(p + byte, std::min<size_t>(8, n - byte));
    return (w >> (lo & 7)) & ((uint64_t(1) << width) - 1);
  }
};

// ---------------------------------------------------------------------------
// FSE

struct Fse {
  int log = 0;
  std::vector<uint8_t> sym, nb;
  std::vector<uint16_t> base;
  bool valid = false;
};

void fse_build(Fse& t, const int16_t* norm, int nsym, int log, size_t off) {
  const uint32_t size = 1u << log;
  t.log = log;
  t.sym.assign(size, 0);
  t.nb.assign(size, 0);
  t.base.assign(size, 0);
  std::vector<uint32_t> next(nsym, 0);
  uint32_t high = size;
  for (int s = 0; s < nsym; ++s)
    if (norm[s] == -1) {
      if (high == 0) fail(off, "FSE table overfull");
      t.sym[--high] = uint8_t(s);
      next[s] = 1;
    }
  const uint32_t step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  uint32_t pos = 0;
  for (int s = 0; s < nsym; ++s) {
    if (norm[s] <= 0) continue;
    next[s] = uint32_t(norm[s]);
    for (int i = 0; i < norm[s]; ++i) {
      t.sym[pos] = uint8_t(s);
      do pos = (pos + step) & mask; while (pos >= high);
    }
  }
  if (pos != 0) fail(off, "FSE distribution does not fill its table");
  for (uint32_t i = 0; i < size; ++i) {
    uint32_t x = next[t.sym[i]]++;
    int bits = log - highest_bit(x);
    t.nb[i] = uint8_t(bits);
    t.base[i] = uint16_t((x << bits) - size);
  }
  t.valid = true;
}

// Reads an FSE table description; returns its bytes.
size_t fse_read(Fse& t, const uint8_t* p, size_t n, size_t off, int max_log,
                int max_sym) {
  ForwardBits in{p, n, off};
  int log = int(in.read(4)) + 5;
  if (log > max_log) fail(off, "FSE accuracy log " + std::to_string(log) + " above " + std::to_string(max_log));
  int32_t remaining = 1 << log;
  int16_t norm[256];
  int nsym = 0;
  while (remaining > 0) {
    if (nsym > max_sym) fail(off, "FSE distribution names symbol " + std::to_string(nsym) + " above " + std::to_string(max_sym));
    int bits = highest_bit(uint64_t(remaining) + 1) + 1;
    uint32_t val = in.read(bits);
    uint32_t lower = (1u << (bits - 1)) - 1;
    uint32_t threshold = (1u << bits) - 1 - (uint32_t(remaining) + 1);
    if ((val & lower) < threshold) {
      in.bit -= 1;
      val &= lower;
    } else if (val > lower) {
      val -= threshold;
    }
    int16_t prob = int16_t(int(val) - 1);
    remaining -= prob < 0 ? -prob : prob;
    norm[nsym++] = prob;
    if (prob == 0) {
      uint32_t repeat = in.read(2);
      for (;;) {
        for (uint32_t i = 0; i < repeat; ++i) {
          if (nsym > max_sym) fail(off, "FSE zero run past the last symbol");
          norm[nsym++] = 0;
        }
        if (repeat != 3) break;
        repeat = in.read(2);
      }
    }
  }
  if (remaining != 0) fail(off, "FSE distribution sums above its scale");
  fse_build(t, norm, nsym, log, off);
  return in.bytes();
}

void fse_rle(Fse& t, uint8_t s) {
  t.log = 0;
  t.sym.assign(1, s);
  t.nb.assign(1, 0);
  t.base.assign(1, 0);
  t.valid = true;
}

// ---------------------------------------------------------------------------
// Huffman

struct Huf {
  int max_bits = 0;
  std::vector<uint8_t> sym, nb;
  bool valid = false;
};

// Reads a Huffman tree description; returns its bytes.
size_t huf_read(Huf& h, const uint8_t* p, size_t n, size_t off) {
  if (n < 1) fail(off, "Huffman tree description missing");
  uint8_t weights[256] = {0};
  int nw = 0;
  size_t used;
  int hb = p[0];
  if (hb >= 128) {
    nw = hb - 127;
    used = 1 + size_t(nw + 1) / 2;
    if (used > n) fail(off, "Huffman weights run past the literals");
    for (int i = 0; i < nw; ++i)
      weights[i] = uint8_t(i % 2 == 0 ? p[1 + i / 2] >> 4 : p[1 + i / 2] & 15);
  } else {
    used = 1 + size_t(hb);
    if (hb == 0 || used > n) fail(off, "Huffman weights' FSE stream out of bounds");
    Fse t;
    size_t hdr = fse_read(t, p + 1, hb, off + 1, 6, 255);
    if (hdr >= size_t(hb)) fail(off + 1, "Huffman weights' FSE stream is empty");
    BackwardBits in(p + 1 + hdr, hb - hdr, off + 1 + hdr);
    auto push = [&](uint8_t w) {
      if (nw >= 255) fail(off, "more than 255 Huffman weights");
      weights[nw++] = w;
    };
    uint32_t s1 = uint32_t(in.read(t.log)), s2 = uint32_t(in.read(t.log));
    for (;;) {
      push(t.sym[s1]);
      s1 = t.base[s1] + uint32_t(in.read(t.nb[s1]));
      if (in.bit < 0) {
        push(t.sym[s2]);
        break;
      }
      push(t.sym[s2]);
      s2 = t.base[s2] + uint32_t(in.read(t.nb[s2]));
      if (in.bit < 0) {
        push(t.sym[s1]);
        break;
      }
    }
  }
  uint32_t sum = 0;
  for (int i = 0; i < nw; ++i) {
    if (weights[i] > kHufMaxBits) fail(off, "Huffman weight above 11");
    if (weights[i]) sum += 1u << (weights[i] - 1);
  }
  if (sum == 0) fail(off, "Huffman weights all zero");
  int max_bits = highest_bit(sum) + 1;
  uint32_t left = (1u << max_bits) - sum;
  if (left & (left - 1)) fail(off, "Huffman weights do not complete a tree");
  if (max_bits > kHufMaxBits) fail(off, "Huffman code longer than 11 bits");
  weights[nw] = uint8_t(highest_bit(left) + 1);
  int nsym = nw + 1;
  uint8_t bits[256];
  int rank[kHufMaxBits + 2] = {0};
  for (int i = 0; i < nsym; ++i) {
    bits[i] = weights[i] ? uint8_t(max_bits + 1 - weights[i]) : 0;
    rank[bits[i]]++;
  }
  uint32_t size = 1u << max_bits;
  h.max_bits = max_bits;
  h.sym.assign(size, 0);
  h.nb.assign(size, 0);
  uint32_t idx[kHufMaxBits + 2] = {0};
  idx[max_bits] = 0;
  for (int b = max_bits; b >= 1; --b) {
    idx[b - 1] = idx[b] + uint32_t(rank[b]) * (1u << (max_bits - b));
    std::memset(&h.nb[idx[b]], b, idx[b - 1] - idx[b]);
  }
  if (idx[0] != size) fail(off, "Huffman code lengths do not fill the table");
  for (int s = 0; s < nsym; ++s) {
    if (!bits[s]) continue;
    uint32_t len = 1u << (max_bits - bits[s]);
    std::memset(&h.sym[idx[bits[s]]], s, len);
    idx[bits[s]] += len;
  }
  h.valid = true;
  return used;
}

// One Huffman stream. The decoder's state is the next max_bits bits of the
// stream (zeros below its start): `top` is where that window ends, and a
// symbol of b bits moves it down by b. The stream is consumed exactly when
// its last symbol leaves top at 0.
struct HufStream {
  const uint8_t* p;
  size_t n, off;
  int64_t top;
  uint8_t* out;
  size_t count, i = 0;

  HufStream(const uint8_t* src, size_t len, size_t at, uint8_t* dst, size_t cnt)
      : p(src), n(len), off(at), top(BackwardBits(src, len, at).bit), out(dst), count(cnt) {}

  bool bulk_ready() const { return i + 4 <= count && top >= 64; }

  // Four symbols from one 8-byte load, which holds at least 57 unread
  // bits (a symbol takes at most 11).
  void bulk4(const Huf& h) {
    // locals: a store through `out` may alias anything a member points to
    const uint8_t* sym = h.sym.data();
    const uint8_t* nb = h.nb.data();
    const int shift = 64 - h.max_bits;
    int64_t t = top;
    const size_t b0 = size_t((t + 7) >> 3) - 8;
    uint64_t c = load_le(p + b0, 8) << (int64_t(b0) * 8 + 64 - t);
    uint8_t* o = out + i;
    for (int k = 0; k < 4; ++k) {
      const uint32_t idx = uint32_t(c >> shift);
      o[k] = sym[idx];
      const int b = nb[idx];
      c <<= b;
      t -= b;
    }
    top = t;
    i += 4;
  }

  void finish(const Huf& h) {
    while (bulk_ready()) bulk4(h);
    BackwardBits in(p, n, off);
    for (; i < count; ++i) {
      if (top <= 0) fail(off, "Huffman stream ends before its symbols");
      in.bit = top;
      const uint32_t idx = uint32_t(in.read(h.max_bits));  // zeros below 0
      out[i] = h.sym[idx];
      top -= h.nb[idx];
    }
    if (top != 0) fail(off, "Huffman stream not consumed exactly");
  }
};

// ---------------------------------------------------------------------------
// sequences

const uint32_t LL_BASE[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
                              12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,  1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t ML_BASE[53] = {3,  4,  5,  6,  7,  8,  9,  10,  11,  12,   13,   14,   15,   16,
                              17, 18, 19, 20, 21, 22, 23, 24,  25,  26,   27,   28,   29,   30,
                              31, 32, 33, 34, 35, 37, 39, 41,  43,  47,   51,   59,   67,   83,
                              99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,  1,  1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t LL_DEFAULT[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t ML_DEFAULT[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1,  1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,  1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t OF_DEFAULT[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

// State carried from block to block within a frame.
struct FrameState {
  Huf huf;
  Fse ll, of, ml;
  uint64_t rep[3] = {1, 4, 8};
  size_t start = 0;      // where the frame's output begins in `out`
  uint64_t window = 0;
};

// One of the three tables of a sequences section; returns its bytes.
size_t read_table(Fse& t, int mode, const uint8_t* p, size_t n, size_t off,
                  const int16_t* dflt, int dflt_n, int dflt_log, int max_log,
                  int max_sym, const char* name) {
  switch (mode) {
    case 0:
      fse_build(t, dflt, dflt_n, dflt_log, off);
      return 0;
    case 1:
      if (n < 1) fail(off, std::string(name) + " RLE symbol missing");
      if (p[0] > max_sym) fail(off, std::string(name) + " RLE symbol out of range");
      fse_rle(t, p[0]);
      return 1;
    case 2:
      return fse_read(t, p, n, off, max_log, max_sym);
    default:
      if (!t.valid) fail(off, std::string(name) + " table repeated before any was given");
      return 0;
  }
}

void decode_block(const uint8_t* src, size_t n, size_t off, FrameState& st,
                  Buffer& out) {
  // -- literals section
  if (n < 1) fail(off, "empty compressed block");
  const int ltype = src[0] & 3, sfmt = (src[0] >> 2) & 3;
  size_t regen = 0, csize = 0, hdr = 0;
  int streams = 1;
  if (ltype < 2) {
    if (sfmt == 0 || sfmt == 2) {
      hdr = 1;
      regen = src[0] >> 3;
    } else if (sfmt == 1) {
      hdr = 2;
      if (n < 2) fail(off, "literals header truncated");
      regen = (src[0] >> 4) + (size_t(src[1]) << 4);
    } else {
      hdr = 3;
      if (n < 3) fail(off, "literals header truncated");
      regen = (src[0] >> 4) + (size_t(src[1]) << 4) + (size_t(src[2]) << 12);
    }
  } else {
    hdr = sfmt < 2 ? 3 : size_t(sfmt + 2);
    if (n < hdr) fail(off, "literals header truncated");
    uint64_t h = load_le(src, hdr);
    int bits = sfmt < 2 ? 10 : (sfmt == 2 ? 14 : 18);
    regen = (h >> 4) & ((1u << bits) - 1);
    csize = (h >> (4 + bits)) & ((1u << bits) - 1);
    streams = sfmt == 0 ? 1 : 4;
  }
  if (regen > kBlockMax) fail(off, "literals larger than a block");
  std::vector<uint8_t> lits(regen);
  size_t pos = hdr;
  if (ltype == 0) {
    if (pos + regen > n) fail(off + pos, "raw literals run past the block");
    std::memcpy(lits.data(), src + pos, regen);
    pos += regen;
  } else if (ltype == 1) {
    if (pos + 1 > n) fail(off + pos, "RLE literal missing");
    std::memset(lits.data(), src[pos], regen);
    pos += 1;
  } else {
    if (pos + csize > n) fail(off + pos, "compressed literals run past the block");
    const uint8_t* p = src + pos;
    size_t left = csize, at = off + pos;
    if (ltype == 2) {
      size_t used = huf_read(st.huf, p, left, at);
      p += used;
      left -= used;
      at += used;
    } else if (!st.huf.valid) {
      fail(at, "treeless literals before any Huffman table");
    }
    if (streams == 1) {
      HufStream(p, left, at, lits.data(), regen).finish(st.huf);
    } else {
      if (left < 10) fail(at, "4-stream literals shorter than their jump table");
      size_t s[4] = {size_t(load_le(p, 2)), size_t(load_le(p + 2, 2)), size_t(load_le(p + 4, 2)), 0};
      if (s[0] + s[1] + s[2] + 6 >= left) fail(at, "literal jump table past the literals");
      s[3] = left - 6 - s[0] - s[1] - s[2];
      size_t per = (regen + 3) / 4;
      if (3 * per > regen) fail(at, "too few literals for 4 streams");
      std::vector<HufStream> hs;
      size_t q = 6, o = 0;
      for (int i = 0; i < 4; ++i) {
        const size_t cnt = i < 3 ? per : regen - 3 * per;
        hs.emplace_back(p + q, s[i], at + q, lits.data() + o, cnt);
        q += s[i];
        o += cnt;
      }
      // the four streams side by side, for the overlap of their loads
      while (hs[0].bulk_ready() && hs[1].bulk_ready() && hs[2].bulk_ready() &&
             hs[3].bulk_ready())
        for (HufStream& h : hs) h.bulk4(st.huf);
      for (HufStream& h : hs) h.finish(st.huf);
    }
    pos += csize;
  }

  // -- sequences section
  if (pos >= n) fail(off + pos, "sequences section missing");
  size_t nseq = src[pos];
  if (nseq < 128) {
    pos += 1;
  } else if (nseq < 255) {
    if (pos + 2 > n) fail(off + pos, "sequence count truncated");
    nseq = ((nseq - 128) << 8) + src[pos + 1];
    pos += 2;
  } else {
    if (pos + 3 > n) fail(off + pos, "sequence count truncated");
    nseq = src[pos + 1] + (size_t(src[pos + 2]) << 8) + 0x7F00;
    pos += 3;
  }
  const size_t block_start = out.size();
  size_t lit = 0;
  if (nseq > 0) {
    if (pos >= n) fail(off + pos, "sequence modes missing");
    const uint8_t modes = src[pos];
    if (modes & 3) fail(off + pos, "reserved bits set in the sequence modes");
    pos += 1;
    pos += read_table(st.ll, modes >> 6, src + pos, n - pos, off + pos, LL_DEFAULT, 36, 6, 9, 35,
                      "literal-length");
    pos += read_table(st.of, (modes >> 4) & 3, src + pos, n - pos, off + pos, OF_DEFAULT, 29, 5, 8,
                      31, "offset");
    pos += read_table(st.ml, (modes >> 2) & 3, src + pos, n - pos, off + pos, ML_DEFAULT, 53, 6, 9,
                      52, "match-length");
    if (pos >= n) fail(off + pos, "sequence bit stream missing");
    BackwardBits in(src + pos, n - pos, off + pos);
    uint32_t sll = uint32_t(in.read(st.ll.log));
    uint32_t sof = uint32_t(in.read(st.of.log));
    uint32_t sml = uint32_t(in.read(st.ml.log));
    for (size_t i = 0; i < nseq; ++i) {
      const int oc = st.of.sym[sof], mc = st.ml.sym[sml], lc = st.ll.sym[sll];
      if (oc > 31) fail(off + pos, "offset code above 31");
      uint64_t ofv = (uint64_t(1) << oc) + in.read(oc);
      uint64_t ml = ML_BASE[mc] + in.read(ML_BITS[mc]);
      uint64_t ll = LL_BASE[lc] + in.read(LL_BITS[lc]);
      if (i + 1 < nseq) {
        sll = st.ll.base[sll] + uint32_t(in.read(st.ll.nb[sll]));
        sml = st.ml.base[sml] + uint32_t(in.read(st.ml.nb[sml]));
        sof = st.of.base[sof] + uint32_t(in.read(st.of.nb[sof]));
      }
      if (in.bit < 0) fail(off + pos, "sequence bit stream ends early");
      uint64_t offset;
      if (ofv > 3) {
        offset = ofv - 3;
        st.rep[2] = st.rep[1];
        st.rep[1] = st.rep[0];
        st.rep[0] = offset;
      } else {
        uint32_t idx = uint32_t(ofv - 1) + (ll == 0);
        if (idx == 0) {
          offset = st.rep[0];
        } else {
          offset = idx < 3 ? st.rep[idx] : st.rep[0] - 1;
          if (idx > 1) st.rep[2] = st.rep[1];
          st.rep[1] = st.rep[0];
          st.rep[0] = offset;
        }
      }
      if (ll > regen - lit) fail(off + pos, "sequence takes more literals than the block has");
      std::memcpy(out.grow(ll), lits.data() + lit, ll);
      lit += ll;
      const size_t have = out.size() - st.start;
      if (offset == 0 || offset > have) fail(off + pos, "match offset " + std::to_string(offset) + " before the frame's start");
      if (offset > st.window) fail(off + pos, "match offset beyond the window");
      if (out.size() - block_start + ml > kBlockMax) fail(off + pos, "block decodes to more than 128 KiB");
      const size_t to = out.size();
      out.grow(ml);
      uint8_t* o = out.p;
      const size_t from = to - offset;
      // The match repeats with period `offset`: each copy takes all that
      // is written since `from`, so it doubles until the match is whole.
      for (size_t done = 0; done < ml;) {
        const size_t k = std::min<size_t>(ml - done, offset + done);
        std::memcpy(o + to + done, o + from, k);
        done += k;
      }
    }
    if (in.bit != 0) fail(off + pos, "sequence bit stream not consumed exactly");
  } else if (pos != n) {
    fail(off + pos, "bytes after an empty sequences section");
  }
  std::memcpy(out.grow(regen - lit), lits.data() + lit, regen - lit);
  if (out.size() - block_start > kBlockMax) fail(off, "block decodes to more than 128 KiB");
}

// Decodes one frame at src[pos...]; returns the offset after it.
size_t decode_frame(const uint8_t* src, size_t n, size_t pos, Buffer& out) {
  const size_t fstart = pos;
  pos += 4;
  if (pos >= n) fail(pos, "frame header truncated");
  const uint8_t fhd = src[pos++];
  const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1,
            did_flag = fhd & 3;
  if (fhd & 8) fail(pos - 1, "reserved bit set in the frame header");
  uint64_t window = 0;
  if (!single) {
    if (pos >= n) fail(pos, "window descriptor missing");
    const uint8_t wd = src[pos++];
    const int wlog = 10 + (wd >> 3);
    if (wlog > 31) fail(pos - 1, "window above 2 GiB");
    const uint64_t wbase = uint64_t(1) << wlog;
    window = wbase + (wbase / 8) * (wd & 7);
  }
  const size_t did_size = did_flag == 3 ? 4 : size_t(did_flag);
  if (pos + did_size > n) fail(pos, "dictionary id truncated");
  const uint64_t did = load_le(src + pos, did_size);
  if (did != 0) fail(pos, "frame names dictionary " + std::to_string(did) + ": dictionaries are not supported");
  pos += did_size;
  const size_t fcs_size = fcs_flag == 0 ? size_t(single) : size_t(1) << fcs_flag;
  bool has_fcs = fcs_size > 0;
  uint64_t fcs = 0;
  if (pos + fcs_size > n) fail(pos, "content size truncated");
  if (has_fcs) {
    fcs = load_le(src + pos, fcs_size);
    if (fcs_size == 2) fcs += 256;
  }
  pos += fcs_size;
  if (single) window = fcs;
  const uint64_t block_max = std::min<uint64_t>(window, kBlockMax);

  FrameState st;
  st.start = out.size();
  st.window = window;
  if (has_fcs && fcs <= (uint64_t(1) << 34)) out.reserve(out.size() + fcs);
  for (;;) {
    if (pos + 3 > n) fail(pos, "block header truncated");
    const uint32_t bh = uint32_t(load_le(src + pos, 3));
    const size_t bstart = pos;
    pos += 3;
    const bool last = bh & 1;
    const int type = (bh >> 1) & 3;
    const size_t size = bh >> 3;
    if (type == 3) fail(bstart, "reserved block type");
    if (size > block_max) fail(bstart, "block larger than its maximum size");
    if (type == 0) {
      if (pos + size > n) fail(pos, "raw block truncated");
      std::memcpy(out.grow(size), src + pos, size);
      pos += size;
    } else if (type == 1) {
      if (pos >= n) fail(pos, "RLE block truncated");
      std::memset(out.grow(size), src[pos], size);
      pos += 1;
    } else {
      if (pos + size > n) fail(pos, "compressed block truncated");
      decode_block(src + pos, size, pos, st, out);
      pos += size;
    }
    if (last) break;
  }
  const size_t produced = out.size() - st.start;
  if (has_fcs && produced != fcs)
    fail(fstart, "frame decodes to " + std::to_string(produced) + " bytes, its header says " + std::to_string(fcs));
  if (checksum) {
    if (pos + 4 > n) fail(pos, "content checksum truncated");
    const uint32_t want = uint32_t(load_le(src + pos, 4));
    const uint32_t got = uint32_t(xxh64(out.p + st.start, produced, 0));
    if (want != got) fail(pos, "content checksum mismatch");
    pos += 4;
  }
  return pos;
}

void decompress(const uint8_t* src, size_t n, Buffer& out) {
  if (n == 0) fail(0, "empty input: no frame");
  size_t pos = 0;
  while (pos < n) {
    if (pos + 4 > n) fail(pos, "frame magic truncated");
    const uint32_t magic = uint32_t(load_le(src + pos, 4));
    if (magic == kFrameMagic) {
      pos = decode_frame(src, n, pos, out);
    } else if ((magic & 0xFFFFFFF0u) == kSkippableMagic) {
      if (pos + 8 > n) fail(pos, "skippable frame header truncated");
      const uint64_t len = load_le(src + pos + 4, 4);
      if (pos + 8 + len > n) fail(pos, "skippable frame truncated");
      pos += 8 + len;
    } else {
      fail(pos, "not a zstd frame");
    }
  }
}

// ---------------------------------------------------------------------------
// CRC-32C (Castagnoli, reflected 0x82F63B78), slicing by 8

struct Crc32cTable {
  uint32_t t[8][256];
  Crc32cTable() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ ((c & 1) ? 0x82F63B78u : 0);
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int s = 1; s < 8; ++s) t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 255];
  }
};

const Crc32cTable kCrc;

void set_error(char* err, int errlen, const char* msg) {
  if (err && errlen > 0) std::snprintf(err, size_t(errlen), "%s", msg);
}

}  // namespace

extern "C" {

// Decodes every frame of src[0..n) into a buffer that the caller reads with
// ursonet_zstd_data / ursonet_zstd_size and releases with ursonet_zstd_free;
// size_hint (0: none) reserves room for the decoded bytes. NULL with a
// message in err on a fault.
void* ursonet_zstd_decompress(const uint8_t* src, size_t n, uint64_t size_hint, char* err,
                              int errlen) {
  Buffer* out = new Buffer();
  try {
    if (size_hint) out->reserve(size_hint);
    decompress(src, n, *out);
    return out;
  } catch (const std::exception& e) {
    delete out;
    set_error(err, errlen, e.what());
    return nullptr;
  }
}

const uint8_t* ursonet_zstd_data(void* h) { return static_cast<Buffer*>(h)->p; }

uint64_t ursonet_zstd_size(void* h) { return static_cast<Buffer*>(h)->n; }

void ursonet_zstd_free(void* h) { delete static_cast<Buffer*>(h); }

// CRC-32C of p[0..n), continuing from `crc` (0 to start).
uint32_t ursonet_crc32c(const uint8_t* p, size_t n, uint32_t crc) {
  crc = ~crc;
  while (n >= 8) {
    const uint64_t w = load_le(p, 8) ^ crc;
    crc = kCrc.t[7][w & 255] ^ kCrc.t[6][(w >> 8) & 255] ^ kCrc.t[5][(w >> 16) & 255] ^
          kCrc.t[4][(w >> 24) & 255] ^ kCrc.t[3][(w >> 32) & 255] ^ kCrc.t[2][(w >> 40) & 255] ^
          kCrc.t[1][(w >> 48) & 255] ^ kCrc.t[0][w >> 56];
    p += 8;
    n -= 8;
  }
  while (n--) crc = (crc >> 8) ^ kCrc.t[0][(crc ^ *p++) & 255];
  return ~crc;
}

}  // extern "C"
