// A Zstandard frame decoder (RFC 8878), written for the port's TIFF reader
// (ops/tiff.py, compression 50000, which libtiff hands to libzstd), so that
// the port reads such files without the zstandard package:
//
//   * frames: the header (window descriptor, single segment, content size,
//     the content checksum flag), raw, RLE and compressed blocks, the
//     XXH64 content checksum verified, several frames one after another,
//     skippable frames passed over;
//   * literals: raw, RLE, Huffman-coded in one or four streams, and
//     treeless (the previous block's Huffman table); Huffman weights sent
//     directly or FSE-coded;
//   * sequences: predefined, RLE, FSE-compressed and repeat table modes for
//     literal lengths, offsets and match lengths, the three repeat offsets.
//
// Dictionaries are not supported (a frame that names one is refused):
// libtiff uses none. Every read of the source and every write of the output
// is bounds-checked, so corrupt or truncated data give an error code, never
// a read out of bounds.
//
// Exported C ABI: vkgr_zstd_decode returns 0 on success (the decoded size in
// *out_len; with a null dst only the size) and < 0 on corrupt, truncated or
// unsupported data, or when the output would pass `cap` bytes.
//
// Build: g++ -O2 -shared -fPIC -std=c++17

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum Err : int {
  kOk = 0,
  kCorrupt = -1,
  kTruncated = -2,
  kTooLarge = -3,
  kUnsupported = -4,
  kChecksum = -5,
};

// ------------------------------------------------------------------ XXH64

constexpr uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL, P3 = 1609587929392839161ULL,
                   P4 = 9650029242287828579ULL, P5 = 2870177450012600261ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t rd64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}
inline uint32_t rd32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}
inline uint64_t round64(uint64_t acc, uint64_t in) { return rotl(acc + in * P2, 31) * P1; }
inline uint64_t merge64(uint64_t acc, uint64_t v) { return (acc ^ round64(0, v)) * P1 + P4; }

uint64_t xxh64(const uint8_t* p, size_t len) {
  const uint8_t* end = p + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = round64(v1, rd64(p));
      v2 = round64(v2, rd64(p + 8));
      v3 = round64(v3, rd64(p + 16));
      v4 = round64(v4, rd64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = merge64(merge64(merge64(merge64(h, v1), v2), v3), v4);
  } else {
    h = P5;
  }
  h += uint64_t(len);
  while (p + 8 <= end) {
    h ^= round64(0, rd64(p));
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= uint64_t(rd32(p)) * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= (*p++) * P5;
    h = rotl(h, 11) * P1;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

// ------------------------------------------------------------------ bit readers

// LSB-first forward reader (FSE table descriptions); bits past the end read 0.
struct ForwardBits {
  const uint8_t* p;
  int64_t n;
  int64_t pos = 0;  // in bits
  uint32_t peek(int k) const {
    uint32_t v = 0;
    for (int i = 0; i < k; ++i) {
      const int64_t b = pos + i;
      if ((b >> 3) < n) v |= uint32_t((p[b >> 3] >> (b & 7)) & 1) << i;
    }
    return v;
  }
  void skip(int k) { pos += k; }
};

// The backward stream of Huffman and FSE-coded data: read from the end,
// the highest set bit of the last byte a marker; bits below the start read
// 0 and leave `pos` negative (an overflow).
struct BackBits {
  const uint8_t* p = nullptr;
  int64_t n = 0;
  int64_t pos = 0;  // bits not yet read: [0, pos)
  bool init(const uint8_t* src, int64_t size) {
    p = src;
    n = size;
    if (size < 1 || src[size - 1] == 0) return false;
    pos = 8 * (size - 1) + highbit(src[size - 1]);
    return true;
  }
  // the k (<= 32) bits below pos, most significant first, without moving
  uint32_t peek(int k) const {
    if (k == 0) return 0;
    const int64_t start = pos - k;
    uint64_t v;
    if (start >= 0) {
      const int64_t byte = start >> 3;
      uint64_t w = 0;
      const int64_t avail = n - byte;
      std::memcpy(&w, p + byte, size_t(avail >= 8 ? 8 : avail));
      v = w >> (start & 7);
    } else {
      if (pos <= 0) return 0;
      uint64_t w = 0;
      std::memcpy(&w, p, size_t(n >= 8 ? 8 : n));
      v = w << (-start);
    }
    return uint32_t(v & ((uint64_t(1) << k) - 1));
  }
  uint32_t read(int k) {
    const uint32_t v = peek(k);
    pos -= k;
    return v;
  }
};

// ------------------------------------------------------------------ FSE

struct FseEntry {
  uint16_t symbol;
  uint8_t bits;
  int32_t base;
};

struct FseTable {
  int log = 0;
  std::vector<FseEntry> e;
  bool ok = false;
};

// The decoding table of a normalized distribution (RFC 8878 4.1.1).
bool fse_build(FseTable& t, const int16_t* norm, int nsym, int log) {
  const int size = 1 << log;
  t.log = log;
  t.e.assign(size_t(size), FseEntry{0, 0, 0});
  std::vector<uint32_t> next(size_t(nsym), 0);
  int high = size - 1;
  for (int s = 0; s < nsym; ++s) {
    if (norm[s] == -1) {
      if (high < 0) return false;
      t.e[size_t(high--)].symbol = uint16_t(s);
      next[size_t(s)] = 1;
    } else {
      next[size_t(s)] = uint32_t(norm[s] > 0 ? norm[s] : 0);
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  int pos = 0;
  for (int s = 0; s < nsym; ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      t.e[size_t(pos)].symbol = uint16_t(s);
      do pos = (pos + step) & mask;
      while (pos > high);
    }
  }
  if (pos != 0) return false;
  for (int u = 0; u < size; ++u) {
    const int s = t.e[size_t(u)].symbol;
    const uint32_t ns = next[size_t(s)]++;
    if (ns == 0) return false;
    const int nb = log - highbit(ns);
    t.e[size_t(u)].bits = uint8_t(nb);
    t.e[size_t(u)].base = int32_t((ns << nb) - uint32_t(size));
  }
  t.ok = true;
  return true;
}

// An FSE table description (the "normalized counts"); returns the bytes it
// took, or < 0.
int64_t fse_read_description(FseTable& t, const uint8_t* src, int64_t n, int max_sym, int max_log) {
  if (n < 1) return kTruncated;
  ForwardBits br{src, n};
  const int log = int(br.peek(4)) + 5;
  br.skip(4);
  if (log > max_log) return kCorrupt;
  int remaining = (1 << log) + 1, threshold = 1 << log, nb = log + 1, sym = 0;
  bool previous0 = false;
  std::vector<int16_t> norm(size_t(max_sym + 1), 0);
  while (remaining > 1 && sym <= max_sym) {
    if (previous0) {
      int n0 = sym;
      while (br.peek(16) == 0xFFFF) {
        n0 += 24;
        br.skip(16);
        if (br.pos > 8 * n) return kTruncated;
      }
      while (br.peek(2) == 3) {
        n0 += 3;
        br.skip(2);
      }
      n0 += int(br.peek(2));
      br.skip(2);
      if (n0 > max_sym) return kCorrupt;
      while (sym < n0) norm[size_t(sym++)] = 0;
    }
    if (sym > max_sym) return kCorrupt;
    const int max = (2 * threshold - 1) - remaining;
    int count;
    const int low = int(br.peek(nb - 1));
    if (low < max) {
      count = low;
      br.skip(nb - 1);
    } else {
      count = int(br.peek(nb));
      if (count >= threshold) count -= max;
      br.skip(nb);
    }
    --count;  // -1: a probability below one
    remaining -= count < 0 ? -count : count;
    norm[size_t(sym++)] = int16_t(count);
    previous0 = count == 0;
    while (remaining < threshold) {
      --nb;
      threshold >>= 1;
    }
    if (br.pos > 8 * n) return kTruncated;
  }
  if (remaining != 1) return kCorrupt;
  const int64_t used = (br.pos + 7) >> 3;
  if (used > n) return kTruncated;
  if (!fse_build(t, norm.data(), sym, log)) return kCorrupt;
  return used;
}

void fse_rle(FseTable& t, int symbol) {
  t.log = 0;
  t.e.assign(1, FseEntry{uint16_t(symbol), 0, 0});
  t.ok = true;
}

// ------------------------------------------------------------------ Huffman

struct HufTable {
  int max_bits = 0;
  std::vector<uint8_t> sym, bits;  // 1 << max_bits entries
  bool ok = false;
};

constexpr int kHufMaxBits = 11;

bool huf_from_weights(HufTable& h, const uint8_t* w, int nw) {
  if (nw < 1 || nw > 255) return false;
  uint32_t total = 0;
  for (int i = 0; i < nw; ++i) {
    if (w[i] > kHufMaxBits) return false;
    if (w[i]) total += 1u << (w[i] - 1);
  }
  if (total == 0) return false;
  const int max_bits = highbit(total) + 1;
  if (max_bits > kHufMaxBits) return false;
  const uint32_t rest = (1u << max_bits) - total;
  if (rest & (rest - 1)) return false;  // not a power of two
  std::vector<uint8_t> weight(w, w + nw);
  weight.push_back(uint8_t(highbit(rest) + 1));
  const int nsym = nw + 1;
  h.max_bits = max_bits;
  h.sym.assign(size_t(1) << max_bits, 0);
  h.bits.assign(size_t(1) << max_bits, 0);
  uint32_t pos = 0;
  for (int wt = 1; wt <= max_bits; ++wt)
    for (int s = 0; s < nsym; ++s)
      if (weight[size_t(s)] == wt) {
        const uint32_t span = 1u << (wt - 1);
        if (pos + span > (1u << max_bits)) return false;
        for (uint32_t i = 0; i < span; ++i) {
          h.sym[pos + i] = uint8_t(s);
          h.bits[pos + i] = uint8_t(max_bits + 1 - wt);
        }
        pos += span;
      }
  if (pos != (1u << max_bits)) return false;
  h.ok = true;
  return true;
}

// A Huffman tree description; returns the bytes it took, or < 0.
int64_t huf_read_description(HufTable& h, const uint8_t* src, int64_t n) {
  if (n < 1) return kTruncated;
  const int head = src[0];
  uint8_t w[256];
  int nw = 0;
  if (head >= 128) {
    nw = head - 127;
    const int64_t bytes = (nw + 1) / 2;
    if (1 + bytes > n) return kTruncated;
    for (int i = 0; i < nw; ++i) w[i] = (i & 1) ? (src[1 + i / 2] & 15) : (src[1 + i / 2] >> 4);
    if (!huf_from_weights(h, w, nw)) return kCorrupt;
    return 1 + bytes;
  }
  if (1 + head > n) return kTruncated;
  FseTable t;
  const int64_t used = fse_read_description(t, src + 1, head, 255, 6);
  if (used < 0) return used;
  BackBits br;
  if (!br.init(src + 1 + used, head - used)) return kCorrupt;
  uint32_t s1 = br.read(t.log), s2 = br.read(t.log);
  auto step = [&](uint32_t& s) {
    const FseEntry& e = t.e[s];
    w[nw++] = uint8_t(e.symbol);
    s = uint32_t(e.base) + br.read(e.bits);
  };
  while (true) {
    if (nw > 253) return kCorrupt;
    step(s1);
    if (br.pos < 0) {
      w[nw++] = uint8_t(t.e[s2].symbol);
      break;
    }
    step(s2);
    if (br.pos < 0) {
      w[nw++] = uint8_t(t.e[s1].symbol);
      break;
    }
  }
  if (!huf_from_weights(h, w, nw)) return kCorrupt;
  return 1 + head;
}

int huf_stream(const HufTable& h, const uint8_t* src, int64_t n, uint8_t* out, int64_t count) {
  BackBits br;
  if (!br.init(src, n)) return kCorrupt;
  for (int64_t i = 0; i < count; ++i) {
    const uint32_t v = br.peek(h.max_bits);
    out[i] = h.sym[v];
    br.pos -= h.bits[v];
  }
  return br.pos == 0 ? kOk : kCorrupt;
}

// ------------------------------------------------------------------ sequences

const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
const uint32_t kLLBase[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
                              12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16,  17,  18,   19,   20,
                              21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34,  35,  37,   39,   41,
                              43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

struct Frame {
  std::vector<uint8_t> out;  // this frame's content so far
  uint64_t cap = 0;          // what the frame may still write
  HufTable huf;
  FseTable ll, of, ml;
  uint32_t rep[3] = {1, 4, 8};
};

// One table of the sequences section by its mode; returns the bytes it took.
int64_t seq_table(FseTable& t, int mode, const uint8_t* src, int64_t n, const int16_t* def, int ndef, int def_log,
                  int max_sym, int max_log) {
  switch (mode) {
    case 0:
      fse_build(t, def, ndef, def_log);
      return 0;
    case 1:
      if (n < 1) return kTruncated;
      if (src[0] > max_sym) return kCorrupt;
      fse_rle(t, src[0]);
      return 1;
    case 2:
      return fse_read_description(t, src, n, max_sym, max_log);
    default:
      return t.ok ? 0 : kCorrupt;  // repeat: the previous block's table
  }
}

int literals(Frame& f, const uint8_t* src, int64_t n, std::vector<uint8_t>& lit, int64_t& used) {
  if (n < 1) return kTruncated;
  const int type = src[0] & 3, fmt = (src[0] >> 2) & 3;
  if (type < 2) {
    int64_t size, head;
    if ((fmt & 1) == 0) {
      size = src[0] >> 3;
      head = 1;
    } else if (fmt == 1) {
      if (n < 2) return kTruncated;
      size = (src[0] >> 4) + (int64_t(src[1]) << 4);
      head = 2;
    } else {
      if (n < 3) return kTruncated;
      size = (src[0] >> 4) + (int64_t(src[1]) << 4) + (int64_t(src[2]) << 12);
      head = 3;
    }
    if (size > (128 << 10)) return kCorrupt;
    if (type == 0) {
      if (head + size > n) return kTruncated;
      lit.assign(src + head, src + head + size);
      used = head + size;
    } else {
      if (head + 1 > n) return kTruncated;
      lit.assign(size_t(size), src[head]);
      used = head + 1;
    }
    return kOk;
  }
  int64_t regen, comp, head;
  const bool four = fmt != 0;
  if (fmt < 2) {
    if (n < 3) return kTruncated;
    const uint32_t v = src[0] | (uint32_t(src[1]) << 8) | (uint32_t(src[2]) << 16);
    regen = (v >> 4) & 0x3FF;
    comp = (v >> 14) & 0x3FF;
    head = 3;
  } else if (fmt == 2) {
    if (n < 4) return kTruncated;
    const uint32_t v = rd32(src);
    regen = (v >> 4) & 0x3FFF;
    comp = (v >> 18) & 0x3FFF;
    head = 4;
  } else {
    if (n < 5) return kTruncated;
    const uint64_t v = rd32(src) | (uint64_t(src[4]) << 32);
    regen = (v >> 4) & 0x3FFFF;
    comp = (v >> 22) & 0x3FFFF;
    head = 5;
  }
  if (regen > (128 << 10)) return kCorrupt;
  if (head + comp > n) return kTruncated;
  const uint8_t* p = src + head;
  int64_t left = comp;
  if (type == 2) {
    const int64_t t = huf_read_description(f.huf, p, left);
    if (t < 0) return int(t);
    p += t;
    left -= t;
  } else if (!f.huf.ok) {
    return kCorrupt;  // treeless without an earlier table
  }
  lit.assign(size_t(regen), 0);
  if (!four) {
    const int rc = huf_stream(f.huf, p, left, lit.data(), regen);
    if (rc) return rc;
  } else {
    if (left < 6) return kTruncated;
    const int64_t s1 = p[0] | (p[1] << 8), s2 = p[2] | (p[3] << 8), s3 = p[4] | (p[5] << 8);
    const int64_t s4 = left - 6 - s1 - s2 - s3;
    if (s4 < 1) return kCorrupt;
    const int64_t part = (regen + 3) / 4;
    if (3 * part > regen) return kCorrupt;
    const uint8_t* q = p + 6;
    const int64_t sizes[4] = {s1, s2, s3, s4};
    for (int i = 0; i < 4; ++i) {
      const int64_t cnt = i < 3 ? part : regen - 3 * part;
      const int rc = huf_stream(f.huf, q, sizes[i], lit.data() + i * part, cnt);
      if (rc) return rc;
      q += sizes[i];
    }
  }
  used = head + comp;
  return kOk;
}

int block_compressed(Frame& f, const uint8_t* src, int64_t n) {
  std::vector<uint8_t> lit;
  int64_t used = 0;
  int rc = literals(f, src, n, lit, used);
  if (rc) return rc;
  const uint8_t* p = src + used;
  int64_t left = n - used;
  if (left < 1) return kTruncated;
  int64_t nseq = p[0];
  if (nseq == 0) {
    p += 1;
    left -= 1;
  } else if (nseq < 128) {
    p += 1;
    left -= 1;
  } else if (nseq < 255) {
    if (left < 2) return kTruncated;
    nseq = ((nseq - 128) << 8) + p[1];
    p += 2;
    left -= 2;
  } else {
    if (left < 3) return kTruncated;
    nseq = p[1] + (int64_t(p[2]) << 8) + 0x7F00;
    p += 3;
    left -= 3;
  }
  size_t lpos = 0;
  if (nseq > 0) {
    if (left < 1) return kTruncated;
    const int modes = p[0];
    if (modes & 3) return kCorrupt;
    p += 1;
    left -= 1;
    int64_t t = seq_table(f.ll, modes >> 6, p, left, kLLDefault, 36, 6, 35, 9);
    if (t < 0) return int(t);
    p += t;
    left -= t;
    t = seq_table(f.of, (modes >> 4) & 3, p, left, kOFDefault, 29, 5, 31, 8);
    if (t < 0) return int(t);
    p += t;
    left -= t;
    t = seq_table(f.ml, (modes >> 2) & 3, p, left, kMLDefault, 53, 6, 52, 9);
    if (t < 0) return int(t);
    p += t;
    left -= t;
    BackBits br;
    if (!br.init(p, left)) return kCorrupt;
    uint32_t sll = br.read(f.ll.log), sof = br.read(f.of.log), sml = br.read(f.ml.log);
    for (int64_t i = 0; i < nseq; ++i) {
      const int llc = f.ll.e[sll].symbol, ofc = f.of.e[sof].symbol, mlc = f.ml.e[sml].symbol;
      if (llc > 35 || mlc > 52 || ofc > 31) return kCorrupt;
      const uint32_t ofv = (uint32_t(1) << ofc) + br.read(ofc);
      const uint32_t ml = kMLBase[mlc] + br.read(kMLBits[mlc]);
      const uint32_t ll = kLLBase[llc] + br.read(kLLBits[llc]);
      uint32_t off;
      if (ofv > 3) {
        off = ofv - 3;
        f.rep[2] = f.rep[1];
        f.rep[1] = f.rep[0];
        f.rep[0] = off;
      } else {
        const int idx = int(ofv) - 1 + (ll == 0 ? 1 : 0);
        if (idx == 0) {
          off = f.rep[0];
        } else {
          off = idx == 3 ? f.rep[0] - 1 : f.rep[idx];
          if (idx != 1) f.rep[2] = f.rep[1];
          f.rep[1] = f.rep[0];
          f.rep[0] = off;
        }
      }
      if (i + 1 < nseq) {  // the states move on in the order literal length, match length, offset
        sll = uint32_t(f.ll.e[sll].base) + br.read(f.ll.e[sll].bits);
        sml = uint32_t(f.ml.e[sml].base) + br.read(f.ml.e[sml].bits);
        sof = uint32_t(f.of.e[sof].base) + br.read(f.of.e[sof].bits);
      }
      if (br.pos < 0) return kCorrupt;
      if (ll > lit.size() - lpos) return kCorrupt;
      if (uint64_t(ll) + ml > f.cap - f.out.size()) return kTooLarge;
      f.out.insert(f.out.end(), lit.begin() + int64_t(lpos), lit.begin() + int64_t(lpos + ll));
      lpos += ll;
      if (off == 0 || off > f.out.size()) return kCorrupt;
      size_t from = f.out.size() - off;
      for (uint32_t k = 0; k < ml; ++k) f.out.push_back(f.out[from + k]);
    }
    if (br.pos != 0) return kCorrupt;
  } else if (left != 0) {
    return kCorrupt;
  }
  if (lit.size() - lpos > f.cap - f.out.size()) return kTooLarge;
  f.out.insert(f.out.end(), lit.begin() + int64_t(lpos), lit.end());
  return kOk;
}

// One frame at src; its content appended to dst. Returns the bytes the frame
// took, or < 0.
int64_t frame(const uint8_t* src, int64_t n, std::vector<uint8_t>& dst, uint64_t cap) {
  if (n < 5) return kTruncated;
  const int fhd = src[4];
  const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1, did_flag = fhd & 3;
  if (fhd & 8) return kCorrupt;  // the reserved bit
  int64_t pos = 5;
  uint64_t window = 0;
  if (!single) {
    if (pos >= n) return kTruncated;
    const int wd = src[pos++];
    const int wlog = 10 + (wd >> 3);
    if (wlog > 41) return kUnsupported;
    const uint64_t base = uint64_t(1) << wlog;
    window = base + (base / 8) * uint64_t(wd & 7);
  }
  const int did_size = did_flag == 3 ? 4 : did_flag;
  if (pos + did_size > n) return kTruncated;
  uint32_t did = 0;
  for (int i = 0; i < did_size; ++i) did |= uint32_t(src[pos + i]) << (8 * i);
  pos += did_size;
  if (did) return kUnsupported;  // dictionaries: libtiff uses none
  const int fcs_size = fcs_flag == 0 ? (single ? 1 : 0) : fcs_flag == 1 ? 2 : fcs_flag == 2 ? 4 : 8;
  if (pos + fcs_size > n) return kTruncated;
  uint64_t content = 0;
  bool has_content = fcs_size > 0;
  for (int i = 0; i < fcs_size; ++i) content |= uint64_t(src[pos + i]) << (8 * i);
  if (fcs_size == 2) content += 256;
  pos += fcs_size;
  if (single) window = content;
  if (has_content && content > cap) return kTooLarge;
  const uint64_t block_max = window < (128u << 10) ? window : (128u << 10);
  Frame f;
  f.cap = has_content ? content : cap;
  f.out.reserve(size_t(has_content ? content : 0));
  while (true) {
    if (pos + 3 > n) return kTruncated;
    const uint32_t bh = src[pos] | (uint32_t(src[pos + 1]) << 8) | (uint32_t(src[pos + 2]) << 16);
    pos += 3;
    const int last = bh & 1, type = (bh >> 1) & 3;
    const uint32_t size = bh >> 3;
    if (type == 3) return kCorrupt;
    if (size > block_max && type != 1) return kCorrupt;
    if (type == 0) {
      if (pos + size > n) return kTruncated;
      if (size > f.cap - f.out.size()) return kTooLarge;
      f.out.insert(f.out.end(), src + pos, src + pos + size);
      pos += size;
    } else if (type == 1) {
      if (pos + 1 > n) return kTruncated;
      if (size > block_max) return kCorrupt;
      if (size > f.cap - f.out.size()) return kTooLarge;
      f.out.insert(f.out.end(), size_t(size), src[pos]);
      pos += 1;
    } else {
      if (pos + size > n) return kTruncated;
      const size_t before = f.out.size();
      const int rc = block_compressed(f, src + pos, size);
      if (rc) return rc;
      if (f.out.size() - before > (128u << 10)) return kCorrupt;
      pos += size;
    }
    if (last) break;
  }
  if (has_content && f.out.size() != content) return kCorrupt;
  if (checksum) {
    if (pos + 4 > n) return kTruncated;
    if (uint32_t(xxh64(f.out.data(), f.out.size())) != rd32(src + pos)) return kChecksum;
    pos += 4;
  }
  dst.insert(dst.end(), f.out.begin(), f.out.end());
  return pos;
}

}  // namespace

extern "C" {

// Every frame of src (skippable frames passed over) into dst, at most cap
// bytes; the decoded size in *out_len.
int vkgr_zstd_decode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap, int64_t* out_len) {
  std::vector<uint8_t> out;
  int64_t pos = 0;
  if (n < 4) return kTruncated;
  while (pos < n) {
    if (pos + 4 > n) return kTruncated;
    const uint32_t magic = rd32(src + pos);
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
      if (pos + 8 > n) return kTruncated;
      const uint32_t size = rd32(src + pos + 4);
      if (uint64_t(size) > uint64_t(n - pos - 8)) return kTruncated;
      pos += 8 + int64_t(size);
      continue;
    }
    if (magic != 0xFD2FB528u) return kCorrupt;
    const int64_t used = frame(src + pos, n - pos, out, uint64_t(cap) - out.size());
    if (used < 0) return int(used);
    pos += used;
  }
  if (int64_t(out.size()) > cap) return kTooLarge;
  if (dst != nullptr && !out.empty()) std::memcpy(dst, out.data(), out.size());  // no dst: the size alone
  *out_len = int64_t(out.size());
  return kOk;
}

}  // extern "C"
