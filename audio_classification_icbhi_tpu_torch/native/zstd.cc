// A Zstandard frame decoder (RFC 8878) and CRC32C, for reading orbax
// checkpoint directories: zarr chunks are zstd frames, and OCDBT manifests
// and B-tree nodes are zstd frames inside a crc32c-checked envelope.
//
// The decoder takes every frame a zstd encoder emits without a dictionary:
// frame headers with or without Single_Segment, Frame_Content_Size and a
// content checksum (XXH64, verified); raw, RLE and compressed blocks;
// literals raw, RLE or Huffman-coded in 1 or 4 streams, treeless literals
// reusing the previous table; sequences with predefined, RLE, FSE-coded and
// repeated tables; the three repeat offsets; concatenated and skippable
// frames. It bounds every read by the input and every write by the output
// buffer, and returns a negative code, never crashes, on a frame that names
// a dictionary, a corrupt frame or a truncated one.
//
// C interface (ctypes):
//   long zstd_decompress(const uint8_t* src, size_t n, uint8_t* dst, size_t cap)
//     the decoded size, or one of the negative codes below;
//   uint32_t zstd_crc32c(uint32_t crc, const uint8_t* data, size_t n)
//     CRC32C (Castagnoli) continued from `crc` (0 to start).

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum Code : long {
  kCorrupt = -1,
  kTruncated = -2,
  kDictionary = -3,
  kOutputTooSmall = -4,
  kChecksum = -5,
};

struct Fail {
  long code;
};

[[noreturn]] void fail(long code) { throw Fail{code}; }

constexpr uint32_t kFrameMagic = 0xFD2FB528u;
constexpr size_t kBlockMax = 128 * 1024;

inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

inline uint64_t load_le(const uint8_t* p, size_t n) {
  uint64_t v = 0;
  std::memcpy(&v, p, n);  // little-endian hosts only (x86-64, aarch64)
  return v;
}

// --- bit streams -------------------------------------------------------------

// Little-endian bits read forward: FSE table descriptions.
struct ForwardBits {
  const uint8_t* p;
  size_t size;
  size_t pos = 0;  // in bits

  uint32_t read(int n) {
    if (pos + n > size * 8) fail(kCorrupt);
    uint32_t v = 0;
    for (int i = 0; i < n; ++i, ++pos) v |= uint32_t((p[pos >> 3] >> (pos & 7)) & 1) << i;
    return v;
  }
  uint32_t peek(int n) const {
    ForwardBits copy = *this;
    uint32_t v = 0;
    for (int i = 0; i < n && copy.pos < size * 8; ++i, ++copy.pos)
      v |= uint32_t((p[copy.pos >> 3] >> (copy.pos & 7)) & 1) << i;
    return v;
  }
  size_t bytes() const { return (pos + 7) >> 3; }
};

// Bits read backward from the end: Huffman and FSE streams. The last byte's
// highest set bit marks the start; bits past the front read as zeros, and
// `left` goes negative so the caller can tell an overread.
struct BackwardBits {
  const uint8_t* p;
  size_t size;
  int64_t left;

  BackwardBits(const uint8_t* data, size_t n) : p(data), size(n) {
    if (n == 0) fail(kCorrupt);
    uint8_t last = data[n - 1];
    if (last == 0) fail(kCorrupt);
    left = int64_t(n - 1) * 8 + highbit(last);
  }

  uint64_t peek(int n) const {
    int64_t at = left - n;
    uint64_t mask = (uint64_t(1) << n) - 1;
    if (at >= 0) {
      size_t byte = size_t(at >> 3);
      uint64_t v;
      if (size - byte >= 8) {
        std::memcpy(&v, p + byte, 8);
      } else {
        v = load_le(p + byte, size - byte);
      }
      return (v >> (at & 7)) & mask;
    }
    if (left <= 0) return 0;  // bits [0, left) are real; below 0 are zeros
    uint64_t v = load_le(p, size < 8 ? size : 8) & ((uint64_t(1) << left) - 1);
    return (v << (-at)) & mask;
  }
  void skip(int n) { left -= n; }
  uint64_t read(int n) {
    uint64_t v = peek(n);
    left -= n;
    return v;
  }
  bool overread() const { return left < 0; }
};

// --- FSE ---------------------------------------------------------------------

struct FseEntry {
  uint16_t base;
  uint8_t symbol;
  uint8_t bits;
};

struct FseTable {
  int log = 0;
  bool valid = false;
  FseEntry e[1 << 9];
};

void build_fse(FseTable& t, const int16_t* norm, int max_symbol, int log) {
  const int size = 1 << log;
  int high = size - 1;
  uint16_t next[256];
  for (int s = 0; s <= max_symbol; ++s) {
    if (norm[s] == -1) {
      t.e[high--].symbol = uint8_t(s);
      next[s] = 1;
    } else {
      next[s] = uint16_t(norm[s] > 0 ? norm[s] : 0);
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3;
  const int mask = size - 1;
  int pos = 0;
  for (int s = 0; s <= max_symbol; ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      t.e[pos].symbol = uint8_t(s);
      do {
        pos = (pos + step) & mask;
      } while (pos > high);
    }
  }
  if (pos != 0) fail(kCorrupt);
  for (int u = 0; u < size; ++u) {
    int s = t.e[u].symbol;
    uint32_t ns = next[s]++;
    int bits = log - highbit(ns);
    t.e[u].bits = uint8_t(bits);
    t.e[u].base = uint16_t((ns << bits) - size);
  }
  t.log = log;
  t.valid = true;
}

// An FSE table description (RFC 8878 4.1.1); returns the bytes it took.
size_t read_fse_table(FseTable& t, const uint8_t* src, size_t n, int max_log, int max_symbol) {
  ForwardBits br{src, n};
  int log = int(br.read(4)) + 5;
  if (log > max_log) fail(kCorrupt);
  int16_t norm[256] = {0};
  int remaining = (1 << log) + 1;
  int threshold = 1 << log;
  int bits = log + 1;
  int symbol = 0;
  while (remaining > 1) {
    if (symbol > max_symbol) fail(kCorrupt);
    int max = (2 * threshold - 1) - remaining;
    int value;
    uint32_t low = br.peek(bits - 1);
    if (int(low & (threshold - 1)) < max) {
      value = int(low & (threshold - 1));
      br.read(bits - 1);
    } else {
      value = int(br.read(bits) & (2 * threshold - 1));
      if (value >= threshold) value -= max;
    }
    int prob = value - 1;
    remaining -= prob < 0 ? -prob : prob;
    norm[symbol++] = int16_t(prob);
    if (prob == 0) {
      for (;;) {
        uint32_t rep = br.read(2);
        symbol += int(rep);
        if (symbol > max_symbol + 1) fail(kCorrupt);
        if (rep != 3) break;
      }
    }
    while (remaining < threshold) {
      --bits;
      threshold >>= 1;
    }
  }
  if (remaining != 1 || symbol > max_symbol + 1) fail(kCorrupt);
  build_fse(t, norm, symbol - 1, log);
  return br.bytes();
}

void rle_fse(FseTable& t, uint8_t symbol) {
  t.e[0] = FseEntry{0, symbol, 0};
  t.log = 0;
  t.valid = true;
}

// --- Huffman -----------------------------------------------------------------

constexpr int kHufMaxBits = 12;

struct HufTable {
  int bits = 0;
  bool valid = false;
  uint8_t symbol[1 << kHufMaxBits];
  uint8_t length[1 << kHufMaxBits];
};

// A Huffman tree description (RFC 8878 4.2.1); returns the bytes it took.
size_t read_huffman_table(HufTable& h, const uint8_t* src, size_t n) {
  if (n < 1) fail(kCorrupt);
  uint8_t weights[256];
  int count = 0;
  size_t used;
  int head = src[0];
  if (head < 128) {
    // weights coded with FSE: two interleaved states over one stream
    used = 1 + size_t(head);
    if (used > n || head == 0) fail(kCorrupt);
    FseTable t;
    size_t hdr = read_fse_table(t, src + 1, size_t(head), 6, kHufMaxBits);
    if (hdr >= size_t(head)) fail(kCorrupt);
    BackwardBits br(src + 1 + hdr, size_t(head) - hdr);
    uint32_t s1 = uint32_t(br.read(t.log));
    uint32_t s2 = uint32_t(br.read(t.log));
    for (;;) {
      if (count > 253) fail(kCorrupt);
      weights[count++] = t.e[s1].symbol;
      s1 = t.e[s1].base + uint32_t(br.read(t.e[s1].bits));
      if (br.overread()) {
        weights[count++] = t.e[s2].symbol;
        break;
      }
      weights[count++] = t.e[s2].symbol;
      s2 = t.e[s2].base + uint32_t(br.read(t.e[s2].bits));
      if (br.overread()) {
        if (count > 254) fail(kCorrupt);
        weights[count++] = t.e[s1].symbol;
        break;
      }
    }
  } else {
    count = head - 127;
    used = 1 + size_t((count + 1) / 2);
    if (used > n) fail(kCorrupt);
    for (int i = 0; i < count; ++i) {
      uint8_t b = src[1 + i / 2];
      weights[i] = (i & 1) ? (b & 15) : (b >> 4);
    }
  }
  uint32_t total = 0;
  for (int i = 0; i < count; ++i) {
    if (weights[i] > kHufMaxBits) fail(kCorrupt);
    if (weights[i]) total += uint32_t(1) << (weights[i] - 1);
  }
  if (total == 0) fail(kCorrupt);
  int bits = highbit(total) + 1;
  if (bits > kHufMaxBits) fail(kCorrupt);
  uint32_t rest = (uint32_t(1) << bits) - total;
  if (rest & (rest - 1)) fail(kCorrupt);  // not a power of two
  if (count >= 256) fail(kCorrupt);
  weights[count++] = uint8_t(highbit(rest) + 1);
  // canonical codes: weight 1 first, symbols in order within a weight
  uint32_t rank[kHufMaxBits + 2] = {0};
  for (int i = 0; i < count; ++i) rank[weights[i]]++;
  uint32_t start[kHufMaxBits + 2] = {0};
  uint32_t next = 0;
  for (int w = 1; w <= bits; ++w) {
    start[w] = next;
    next += rank[w] << (w - 1);
  }
  if (next != (uint32_t(1) << bits)) fail(kCorrupt);
  for (int s = 0; s < count; ++s) {
    int w = weights[s];
    if (!w) continue;
    uint32_t len = uint32_t(1) << (w - 1);
    for (uint32_t i = 0; i < len; ++i) {
      h.symbol[start[w] + i] = uint8_t(s);
      h.length[start[w] + i] = uint8_t(bits + 1 - w);
    }
    start[w] += len;
  }
  h.bits = bits;
  h.valid = true;
  return used;
}

void decode_huffman_stream(const HufTable& h, const uint8_t* src, size_t n, uint8_t* out,
                           size_t count) {
  BackwardBits br(src, n);
  for (size_t i = 0; i < count; ++i) {
    uint32_t idx = uint32_t(br.peek(h.bits));
    out[i] = h.symbol[idx];
    br.skip(h.length[idx]);
    if (br.overread()) fail(kCorrupt);
  }
  if (br.left != 0) fail(kCorrupt);
}

// --- sequences ---------------------------------------------------------------

const uint32_t kLLBase[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
                              12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,  1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,   10,  11,  12,   13,   14,   15,   16,
                              17, 18, 19, 20, 21, 22, 23,  24,  25,  26,   27,   28,   29,   30,
                              31, 32, 33, 34, 35, 37, 39,  41,  43,  47,   51,   59,   67,   83,
                              99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1,  1,  1,  1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,  1,  1,  1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

// --- XXH64 (seed 0), the frame checksum ---------------------------------------

constexpr uint64_t P1 = 11400714785074694791ull, P2 = 14029467366897019727ull,
                   P3 = 1609587929392839161ull, P4 = 9650029242287828579ull,
                   P5 = 2870177450012600261ull;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t in) { return rotl(acc + in * P2, 31) * P1; }
inline uint64_t merge(uint64_t h, uint64_t v) { return (h ^ xround(0, v)) * P1 + P4; }

uint64_t xxh64(const uint8_t* p, size_t n) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = uint64_t(0) - P1;
    for (; end - p >= 32; p += 32) {
      v1 = xround(v1, load_le(p, 8));
      v2 = xround(v2, load_le(p + 8, 8));
      v3 = xround(v3, load_le(p + 16, 8));
      v4 = xround(v4, load_le(p + 24, 8));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = merge(h, v1);
    h = merge(h, v2);
    h = merge(h, v3);
    h = merge(h, v4);
  } else {
    h = P5;
  }
  h += uint64_t(n);
  for (; end - p >= 8; p += 8) h = rotl(h ^ xround(0, load_le(p, 8)), 27) * P1 + P4;
  if (end - p >= 4) {
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

// --- frames ------------------------------------------------------------------

struct Decoder {
  const uint8_t* src;
  size_t n;
  uint8_t* dst;
  size_t cap;
  size_t out = 0;          // bytes written
  size_t frame_start = 0;  // offsets cannot reach before the frame
  HufTable huf;
  FseTable ll, of, ml;
  uint32_t rep[3];
  std::vector<uint8_t> lit_buf = std::vector<uint8_t>(kBlockMax);

  void need(size_t at, size_t len) const {
    if (at > n || len > n - at) fail(kTruncated);
  }
  void room(size_t len) const {
    if (len > cap - out) fail(kOutputTooSmall);
  }

  // literals section; returns the bytes it took, points `lits` at them
  size_t read_literals(const uint8_t* p, size_t len, const uint8_t*& lits, size_t& lit_n) {
    if (len < 1) fail(kCorrupt);
    int type = p[0] & 3, sf = (p[0] >> 2) & 3;
    if (type < 2) {
      size_t hdr, size;
      if (sf == 0 || sf == 2) {
        hdr = 1;
        size = p[0] >> 3;
      } else if (sf == 1) {
        hdr = 2;
        if (len < 2) fail(kCorrupt);
        size = (p[0] >> 4) + (size_t(p[1]) << 4);
      } else {
        hdr = 3;
        if (len < 3) fail(kCorrupt);
        size = (p[0] >> 4) + (size_t(p[1]) << 4) + (size_t(p[2]) << 12);
      }
      if (size > kBlockMax) fail(kCorrupt);
      if (type == 0) {
        if (hdr + size > len) fail(kCorrupt);
        lits = p + hdr;
        lit_n = size;
        return hdr + size;
      }
      if (hdr + 1 > len) fail(kCorrupt);
      std::memset(lit_buf.data(), p[hdr], size);
      lits = lit_buf.data();
      lit_n = size;
      return hdr + 1;
    }
    size_t hdr, regen, comp;
    bool four = sf != 0;
    if (sf < 2) {
      hdr = 3;
      if (len < 3) fail(kCorrupt);
      uint32_t h = uint32_t(load_le(p, 3));
      regen = (h >> 4) & 0x3FF;
      comp = (h >> 14) & 0x3FF;
    } else if (sf == 2) {
      hdr = 4;
      if (len < 4) fail(kCorrupt);
      uint32_t h = uint32_t(load_le(p, 4));
      regen = (h >> 4) & 0x3FFF;
      comp = (h >> 18) & 0x3FFF;
    } else {
      hdr = 5;
      if (len < 5) fail(kCorrupt);
      uint64_t h = load_le(p, 5);
      regen = (h >> 4) & 0x3FFFF;
      comp = (h >> 22) & 0x3FFFF;
    }
    if (regen > kBlockMax || hdr + comp > len) fail(kCorrupt);
    const uint8_t* q = p + hdr;
    size_t qn = comp;
    if (type == 2) {
      size_t used = read_huffman_table(huf, q, qn);
      q += used;
      qn -= used;
    } else if (!huf.valid) {
      fail(kCorrupt);  // treeless literals with no earlier table
    }
    uint8_t* o = lit_buf.data();
    if (!four) {
      decode_huffman_stream(huf, q, qn, o, regen);
    } else {
      if (qn < 6) fail(kCorrupt);
      size_t s1 = load_le(q, 2), s2 = load_le(q + 2, 2), s3 = load_le(q + 4, 2);
      if (6 + s1 + s2 + s3 > qn) fail(kCorrupt);
      size_t s4 = qn - 6 - s1 - s2 - s3;
      size_t seg = (regen + 3) / 4;
      if (3 * seg > regen) fail(kCorrupt);
      const uint8_t* s = q + 6;
      decode_huffman_stream(huf, s, s1, o, seg);
      decode_huffman_stream(huf, s + s1, s2, o + seg, seg);
      decode_huffman_stream(huf, s + s1 + s2, s3, o + 2 * seg, seg);
      decode_huffman_stream(huf, s + s1 + s2 + s3, s4, o + 3 * seg, regen - 3 * seg);
    }
    lits = o;
    lit_n = regen;
    return hdr + comp;
  }

  size_t read_table(FseTable& t, int mode, const uint8_t* p, size_t len, const int16_t* def,
                    int def_max, int def_log, int max_log, int max_symbol) {
    switch (mode) {
      case 0:
        build_fse(t, def, def_max, def_log);
        return 0;
      case 1:
        if (len < 1 || p[0] > max_symbol) fail(kCorrupt);
        rle_fse(t, p[0]);
        return 1;
      case 2:
        return read_fse_table(t, p, len, max_log, max_symbol);
      default:
        if (!t.valid) fail(kCorrupt);  // repeat with no earlier table
        return 0;
    }
  }

  void copy_literals(const uint8_t*& lits, size_t& lit_n, size_t count) {
    if (count > lit_n) fail(kCorrupt);
    room(count);
    std::memcpy(dst + out, lits, count);
    out += count;
    lits += count;
    lit_n -= count;
  }

  void block(const uint8_t* p, size_t len) {
    const uint8_t* lits;
    size_t lit_n;
    size_t used = read_literals(p, len, lits, lit_n);
    p += used;
    len -= used;
    if (len < 1) fail(kCorrupt);
    size_t nseq;
    if (p[0] < 128) {
      nseq = p[0];
      p += 1;
      len -= 1;
    } else if (p[0] < 255) {
      if (len < 2) fail(kCorrupt);
      nseq = (size_t(p[0] - 128) << 8) + p[1];
      p += 2;
      len -= 2;
    } else {
      if (len < 3) fail(kCorrupt);
      nseq = p[1] + (size_t(p[2]) << 8) + 0x7F00;
      p += 3;
      len -= 3;
    }
    if (nseq == 0) {
      if (len != 0) fail(kCorrupt);
      copy_literals(lits, lit_n, lit_n);
      return;
    }
    if (len < 1) fail(kCorrupt);
    int modes = p[0];
    if (modes & 3) fail(kCorrupt);
    p += 1;
    len -= 1;
    used = read_table(ll, (modes >> 6) & 3, p, len, kLLDefault, 35, 6, 9, 35);
    p += used;
    len -= used;
    used = read_table(of, (modes >> 4) & 3, p, len, kOFDefault, 28, 5, 8, 31);
    p += used;
    len -= used;
    used = read_table(ml, (modes >> 2) & 3, p, len, kMLDefault, 52, 6, 9, 52);
    p += used;
    len -= used;

    BackwardBits br(p, len);
    uint32_t sll = uint32_t(br.read(ll.log));
    uint32_t sof = uint32_t(br.read(of.log));
    uint32_t sml = uint32_t(br.read(ml.log));
    for (size_t i = 0; i < nseq; ++i) {
      int of_code = of.e[sof].symbol, ml_code = ml.e[sml].symbol, ll_code = ll.e[sll].symbol;
      if (of_code > 31 || ml_code > 52 || ll_code > 35) fail(kCorrupt);
      uint64_t of_value = (uint64_t(1) << of_code) + br.read(of_code);
      size_t match = kMLBase[ml_code] + size_t(br.read(kMLBits[ml_code]));
      size_t literal = kLLBase[ll_code] + size_t(br.read(kLLBits[ll_code]));
      uint64_t offset;
      if (of_value > 3) {
        offset = of_value - 3;
        rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = uint32_t(offset);
      } else {
        int idx = int(of_value) - 1 + (literal == 0 ? 1 : 0);
        if (idx == 0) {
          offset = rep[0];
        } else {
          offset = idx == 3 ? uint64_t(rep[0]) - 1 : rep[idx];
          if (offset == 0) fail(kCorrupt);
          if (idx != 1) rep[2] = rep[1];
          rep[1] = rep[0];
          rep[0] = uint32_t(offset);
        }
      }
      copy_literals(lits, lit_n, literal);
      if (offset > out - frame_start) fail(kCorrupt);
      room(match);
      uint8_t* o = dst + out;
      const uint8_t* from = o - offset;
      if (offset >= match) {
        std::memcpy(o, from, match);
      } else {
        for (size_t k = 0; k < match; ++k) o[k] = from[k];
      }
      out += match;
      if (i + 1 < nseq) {
        sll = ll.e[sll].base + uint32_t(br.read(ll.e[sll].bits));
        sml = ml.e[sml].base + uint32_t(br.read(ml.e[sml].bits));
        sof = of.e[sof].base + uint32_t(br.read(of.e[sof].bits));
      }
      if (br.overread()) fail(kCorrupt);
    }
    if (br.left != 0) fail(kCorrupt);
    copy_literals(lits, lit_n, lit_n);
  }

  // One frame from src[pos]; returns the position after it.
  size_t frame(size_t pos) {
    need(pos, 4);
    uint32_t magic = uint32_t(load_le(src + pos, 4));
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {  // skippable frame
      need(pos + 4, 4);
      size_t size = size_t(load_le(src + pos + 4, 4));
      need(pos + 8, size);
      return pos + 8 + size;
    }
    if (magic != kFrameMagic) fail(kCorrupt);
    pos += 4;
    need(pos, 1);
    uint8_t fhd = src[pos++];
    int fcs_flag = fhd >> 6;
    bool single = (fhd >> 5) & 1;
    if ((fhd >> 3) & 1) fail(kCorrupt);  // reserved bit
    bool checksum = (fhd >> 2) & 1;
    int dict_flag = fhd & 3;
    if (!single) {
      need(pos, 1);
      pos += 1;  // window descriptor: every offset is bounded by the frame itself
    }
    static const int kDictBytes[4] = {0, 1, 2, 4};
    int dict_bytes = kDictBytes[dict_flag];
    need(pos, size_t(dict_bytes));
    uint64_t dict = dict_bytes ? load_le(src + pos, size_t(dict_bytes)) : 0;
    pos += size_t(dict_bytes);
    if (dict != 0) fail(kDictionary);
    static const int kFcsBytes[4] = {0, 2, 4, 8};
    int fcs_bytes = fcs_flag == 0 ? (single ? 1 : 0) : kFcsBytes[fcs_flag];
    need(pos, size_t(fcs_bytes));
    bool has_size = fcs_bytes > 0;
    uint64_t content = has_size ? load_le(src + pos, size_t(fcs_bytes)) : 0;
    if (fcs_bytes == 2) content += 256;
    pos += size_t(fcs_bytes);
    if (has_size && content > cap - out) fail(kOutputTooSmall);

    frame_start = out;
    rep[0] = 1;
    rep[1] = 4;
    rep[2] = 8;
    huf.valid = false;
    ll.valid = of.valid = ml.valid = false;
    for (bool last = false; !last;) {
      need(pos, 3);
      uint32_t h = uint32_t(load_le(src + pos, 3));
      pos += 3;
      last = h & 1;
      int type = (h >> 1) & 3;
      size_t size = h >> 3;
      if (size > kBlockMax) fail(kCorrupt);
      if (type == 0) {
        need(pos, size);
        room(size);
        std::memcpy(dst + out, src + pos, size);
        out += size;
        pos += size;
      } else if (type == 1) {
        need(pos, 1);
        room(size);
        std::memset(dst + out, src[pos], size);
        out += size;
        pos += 1;
      } else if (type == 2) {
        need(pos, size);
        size_t before = out;
        block(src + pos, size);
        if (out - before > kBlockMax) fail(kCorrupt);
        pos += size;
      } else {
        fail(kCorrupt);
      }
    }
    if (has_size && out - frame_start != content) fail(kCorrupt);
    if (checksum) {
      need(pos, 4);
      uint32_t want = uint32_t(load_le(src + pos, 4));
      pos += 4;
      if (uint32_t(xxh64(dst + frame_start, out - frame_start)) != want) fail(kChecksum);
    }
    return pos;
  }
};

// --- CRC32C ------------------------------------------------------------------

struct Crc32cTable {
  uint32_t t[8][256];
  Crc32cTable() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ 0x82F63B78u : c >> 1;
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int s = 1; s < 8; ++s) t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
  }
};

const Crc32cTable kCrc;

}  // namespace

extern "C" {

long zstd_decompress(const uint8_t* src, size_t n, uint8_t* dst, size_t cap) {
  try {
    Decoder d{src, n, dst, cap};
    if (n == 0) fail(kTruncated);
    for (size_t pos = 0; pos < n;) pos = d.frame(pos);
    return long(d.out);
  } catch (const Fail& f) {
    return f.code;
  } catch (...) {
    return kCorrupt;
  }
}

uint32_t zstd_crc32c(uint32_t crc, const uint8_t* p, size_t n) {
  const auto& t = kCrc.t;
  crc = ~crc;
  for (; n >= 8; n -= 8, p += 8) {
    uint64_t v = load_le(p, 8) ^ crc;
    crc = t[7][v & 0xFF] ^ t[6][(v >> 8) & 0xFF] ^ t[5][(v >> 16) & 0xFF] ^
          t[4][(v >> 24) & 0xFF] ^ t[3][(v >> 32) & 0xFF] ^ t[2][(v >> 40) & 0xFF] ^
          t[1][(v >> 48) & 0xFF] ^ t[0][v >> 56];
  }
  for (; n; --n, ++p) crc = t[0][(crc ^ *p) & 0xFF] ^ (crc >> 8);
  return ~crc;
}

}  // extern "C"
