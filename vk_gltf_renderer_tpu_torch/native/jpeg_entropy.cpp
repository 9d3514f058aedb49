// JPEG entropy coding (ITU T.81 Huffman), the host half of ops/jpeg.py.
//
// Decoding one scan: sequential (baseline SOF0, extended SOF1) and
// progressive (SOF2: DC first / DC refine / AC first / AC refine, with
// end-of-band runs), interleaved or not, with restart intervals. The
// coefficients land in per-component int16 buffers of 64 natural-order
// values a block; dequantisation, the inverse DCT, upsampling and colour
// conversion are numpy in ops/jpeg.py. The bit reader, the Huffman decode
// and the refinement logic follow libjpeg's jdhuff.c / jdphuff.c, so a
// corrupt stream decodes as libjpeg decodes it (a bad code reads as 0, a
// marker inside the data reads as zero bits; once a read has taken such a
// bit, the MCUs after the one being decoded are left as they are until a
// restart marker, and a lossless scan's rows restart at 2^(P-Pt-1)).
//
// Encoding one scan: the blocks in coding order with their component's
// tables; DC differences and AC run/size symbols (EOB and ZRL), byte
// stuffing, padding with one bits. The same routine writes a baseline scan
// (Ss 0, Se 63), a progressive DC-first scan (Ss = Se = 0) and a
// progressive AC-first scan (Ss 1, Se 63) with point transform 0.
//
// Decoding one arithmetic-coded scan (SOF9 sequential, SOF10 progressive):
// the QM decoder of ITU T.81 Annex D with its probability estimation table,
// the DC and AC statistics models of F.1.4.4 and G.1.3.3 with the DAC
// conditioning bounds, as libjpeg's jdarith.c decodes them (statistics
// reset at each scan and restart; a marker inside the data reads as zero
// bytes; a magnitude or spectral overflow stops the scan, its remaining
// blocks left as they are).
//
// Decoding one lossless scan (SOF3, Huffman): the differences of each
// sample (DC tables, symbol 16 meaning 32768), in MCUs of h x v samples a
// component when the scan interleaves subsampled components, undone with
// the scan's predictor 1-7 and point transform; the first row of the scan,
// and of each restart interval, predicts from the left (its first sample
// from 2^(P-Pt-1)), each row's first sample from above, as libjpeg-turbo's
// jddiffct.c and jdpred.c do.
//
// Exported C ABI (all return 0 on success, < 0 on bad arguments or tables):
//   vkgr_jpeg_decode_scan(...)        see below
//   vkgr_jpeg_decode_scan_arith(...)  see below
//   vkgr_jpeg_decode_lossless(...)    see below
//   vkgr_jpeg_encode_scan(...)        see below
//
// Build: g++ -O2 -shared -fPIC -std=c++17

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <utility>
#include <vector>

namespace {

// zigzag index -> natural index, with 16 guard entries as in libjpeg
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33, 40, 48,
    41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23,
    30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63, 63, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int nbits = 0;
  bool marker = false;
  int fake = 0;               // the zero bits at the bottom of buf that stand in for data past a marker
  bool insufficient = false;  // a read took such a bit: libjpeg's insufficient_data

  void fill() {
    while (nbits <= 56) {
      uint32_t byte = 0;
      if (!marker && p < end) {
        byte = *p;
        if (byte == 0xFF) {
          if (p + 1 < end && p[1] == 0x00) {
            p += 2;
          } else {  // a marker: feed zero bits from here on, as libjpeg does
            marker = true;
            byte = 0;
          }
        } else {
          ++p;
        }
      } else {
        marker = true;  // the end of the scan's data is the marker that ends it
      }
      buf = (buf << 8) | byte;
      nbits += 8;
      if (marker) fake += 8;
    }
  }
  int peek(int n) {
    if (nbits < n) fill();
    return static_cast<int>((buf >> (nbits - n)) & ((1u << n) - 1));
  }
  void skip(int n) {
    nbits -= n;
    if (nbits < fake) {  // jpeg_fill_bit_buffer's "hit marker": the rest of the MCU reads zeros
      insufficient = true;
      fake = nbits;
    }
  }
  int get(int n) {
    if (n == 0) return 0;
    int v = peek(n);
    skip(n);
    return v;
  }
  // byte-align, then pass the next RSTn marker; the data past it are real again (process_restart resets
  // insufficient_data only when the marker it reads is a restart marker)
  void restart() {
    buf = 0;
    nbits = 0;
    fake = 0;
    marker = false;
    while (p + 1 < end && !(p[0] == 0xFF && p[1] >= 0xD0 && p[1] <= 0xD7)) {
      if (p[0] == 0xFF && p[1] != 0x00 && p[1] != 0xFF) break;  // another marker (the EOI): resync stops there
      ++p;
    }
    if (p + 1 < end && p[1] >= 0xD0 && p[1] <= 0xD7) {
      p += 2;
      insufficient = false;
    } else {
      marker = true;
    }
  }
};

struct Huff {
  bool present = false;
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  uint8_t look_len[512];  // 0: code longer than 9 bits
  uint8_t look_val[512];

  // Returns false for a table libjpeg's jpeg_make_d_derived_tbl refuses:
  // more than 256 codes, a code length whose codes do not fit in it (the
  // all-ones code included), or, for a DC table, a symbol above 15.
  bool build(const uint8_t* bits, const uint8_t* v, bool dc, int max_dc = 15) {
    int total = 0;
    for (int l = 0; l < 16; ++l) total += bits[l];
    if (total > 256) return false;
    if (dc)
      for (int k = 0; k < total; ++k)
        if (v[k] > max_dc) return false;
    std::memcpy(vals, v, 256);
    std::memset(look_len, 0, sizeof(look_len));
    int code = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      int n = bits[l - 1];
      if (code + n >= (1 << l)) return false;
      valoffset[l] = k - code;
      for (int i = 0; i < n; ++i, ++k, ++code) {
        if (l <= 9) {
          int shift = 9 - l;
          for (int j = 0; j < (1 << shift); ++j) {
            look_len[(code << shift) | j] = static_cast<uint8_t>(l);
            look_val[(code << shift) | j] = v[k];
          }
        }
      }
      maxcode[l] = n ? code - 1 : -1;
      code <<= 1;
    }
    maxcode[17] = 0x7FFFFFFF;
    present = true;
    return true;
  }

  int decode(BitReader& br) const {
    int look = br.peek(9);
    if (look_len[look]) {
      br.skip(look_len[look]);
      return look_val[look];
    }
    int l = 10;
    int code = br.peek(l);
    while (l <= 16 && code > maxcode[l]) {
      ++l;
      code = br.peek(l);
    }
    if (l > 16) {  // a bad code: libjpeg fakes a zero
      br.skip(16);
      return 0;
    }
    br.skip(l);
    return vals[(code + valoffset[l]) & 0xFF];
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

struct ScanComp {
  int16_t* coef;
  int h, v, buf_cols, real_cols, real_rows;
  const Huff* dc;
  const Huff* ac;
  int pred;
};

struct Decoder {
  BitReader br;
  int Ss, Se, Ah, Al;
  bool progressive;
  int eobrun = 0;

  void sequential(ScanComp& c, int16_t* blk) {
    int t = c.dc->decode(br);
    int diff = t ? extend(br.get(t), t) : 0;
    c.pred = static_cast<int>(static_cast<uint32_t>(c.pred) + static_cast<uint32_t>(diff));  // wraps, as in libjpeg-turbo
    blk[0] = static_cast<int16_t>(c.pred);
    for (int k = 1; k < 64; ++k) {
      int rs = c.ac->decode(br);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        int val = extend(br.get(s), s);
        blk[kNatural[k]] = static_cast<int16_t>(val);
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  void dc_first(ScanComp& c, int16_t* blk) {
    int t = c.dc->decode(br);
    int diff = t ? extend(br.get(t), t) : 0;
    c.pred = static_cast<int>(static_cast<uint32_t>(c.pred) + static_cast<uint32_t>(diff));  // wraps, as in libjpeg-turbo
    blk[0] = static_cast<int16_t>(static_cast<uint32_t>(c.pred) << Al);
  }

  void dc_refine(int16_t* blk) {
    if (br.get(1)) blk[0] = static_cast<int16_t>(blk[0] | (1 << Al));
  }

  void ac_first(ScanComp& c, int16_t* blk) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    for (int k = Ss; k <= Se; ++k) {
      int rs = c.ac->decode(br);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        int val = extend(br.get(s), s);
        blk[kNatural[k]] = static_cast<int16_t>(static_cast<uint32_t>(val) << Al);
      } else {
        if (r == 15) {
          k += 15;
        } else {
          eobrun = 1 << r;
          if (r) eobrun += br.get(r);
          --eobrun;
          break;
        }
      }
    }
  }

  void ac_refine(ScanComp& c, int16_t* blk) {
    const int p1 = 1 << Al;
    const int m1 = -1 * (1 << Al);
    int k = Ss;
    if (eobrun == 0) {
      for (; k <= Se; ++k) {
        int rs = c.ac->decode(br);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = br.get(1) ? p1 : m1;  // a newly nonzero coefficient has size 1
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.get(r);
          break;
        }
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            if (br.get(1) && (*coef & p1) == 0) *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1 : *coef + m1);
          } else {
            if (--r < 0) break;
          }
          ++k;
        } while (k <= Se);
        if (s) blk[kNatural[k]] = static_cast<int16_t>(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= Se; ++k) {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0 && br.get(1) && (*coef & p1) == 0)
          *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1 : *coef + m1);
      }
      --eobrun;
    }
  }

  void block(ScanComp& c, int16_t* blk) {
    if (!progressive) {
      sequential(c, blk);
    } else if (Ss == 0) {
      if (Ah == 0) dc_first(c, blk);
      else dc_refine(blk);
    } else if (Ah == 0) {
      ac_first(c, blk);
    } else {
      ac_refine(c, blk);
    }
  }
};

// T.81 Table D.3 as libjpeg's jaricom.c packs it: Qe << 16 | Next_Index_MPS << 8 |
// Switch_MPS << 7 | Next_Index_LPS; entry 113 is the fixed 0.5 estimate.
#define V(a, b, c, d) ((int32_t(a) << 16) | (int32_t(c) << 8) | (int32_t(d) << 7) | (b))
const int32_t kAritab[114] = {
    V(0x5a1d, 1, 1, 1),     V(0x2586, 14, 2, 0),    V(0x1114, 16, 3, 0),    V(0x080b, 18, 4, 0),
    V(0x03d8, 20, 5, 0),    V(0x01da, 23, 6, 0),    V(0x00e5, 25, 7, 0),    V(0x006f, 28, 8, 0),
    V(0x0036, 30, 9, 0),    V(0x001a, 33, 10, 0),   V(0x000d, 35, 11, 0),   V(0x0006, 9, 12, 0),
    V(0x0003, 10, 13, 0),   V(0x0001, 12, 13, 0),   V(0x5a7f, 15, 15, 1),   V(0x3f25, 36, 16, 0),
    V(0x2cf2, 38, 17, 0),   V(0x207c, 39, 18, 0),   V(0x17b9, 40, 19, 0),   V(0x1182, 42, 20, 0),
    V(0x0cef, 43, 21, 0),   V(0x09a1, 45, 22, 0),   V(0x072f, 46, 23, 0),   V(0x055c, 48, 24, 0),
    V(0x0406, 49, 25, 0),   V(0x0303, 51, 26, 0),   V(0x0240, 52, 27, 0),   V(0x01b1, 54, 28, 0),
    V(0x0144, 56, 29, 0),   V(0x00f5, 57, 30, 0),   V(0x00b7, 59, 31, 0),   V(0x008a, 60, 32, 0),
    V(0x0068, 62, 33, 0),   V(0x004e, 63, 34, 0),   V(0x003b, 32, 35, 0),   V(0x002c, 33, 9, 0),
    V(0x5ae1, 37, 37, 1),   V(0x484c, 64, 38, 0),   V(0x3a0d, 65, 39, 0),   V(0x2ef1, 67, 40, 0),
    V(0x261f, 68, 41, 0),   V(0x1f33, 69, 42, 0),   V(0x19a8, 70, 43, 0),   V(0x1518, 72, 44, 0),
    V(0x1177, 73, 45, 0),   V(0x0e74, 74, 46, 0),   V(0x0bfb, 75, 47, 0),   V(0x09f8, 77, 48, 0),
    V(0x0861, 78, 49, 0),   V(0x0706, 79, 50, 0),   V(0x05cd, 48, 51, 0),   V(0x04de, 50, 52, 0),
    V(0x040f, 50, 53, 0),   V(0x0363, 51, 54, 0),   V(0x02d4, 52, 55, 0),   V(0x025c, 53, 56, 0),
    V(0x01f8, 54, 57, 0),   V(0x01a4, 55, 58, 0),   V(0x0160, 56, 59, 0),   V(0x0125, 57, 60, 0),
    V(0x00f6, 58, 61, 0),   V(0x00cb, 59, 62, 0),   V(0x00ab, 61, 63, 0),   V(0x008f, 61, 32, 0),
    V(0x5b12, 65, 65, 1),   V(0x4d04, 80, 66, 0),   V(0x412c, 81, 67, 0),   V(0x37d8, 82, 68, 0),
    V(0x2fe8, 83, 69, 0),   V(0x293c, 84, 70, 0),   V(0x2379, 86, 71, 0),   V(0x1edf, 87, 72, 0),
    V(0x1aa9, 87, 73, 0),   V(0x174e, 72, 74, 0),   V(0x1424, 72, 75, 0),   V(0x119c, 74, 76, 0),
    V(0x0f6b, 74, 77, 0),   V(0x0d51, 75, 78, 0),   V(0x0bb6, 77, 79, 0),   V(0x0a40, 77, 48, 0),
    V(0x5832, 80, 81, 1),   V(0x4d1c, 88, 82, 0),   V(0x438e, 89, 83, 0),   V(0x3bdd, 90, 84, 0),
    V(0x34ee, 91, 85, 0),   V(0x2eae, 92, 86, 0),   V(0x299a, 93, 87, 0),   V(0x2516, 86, 71, 0),
    V(0x5570, 88, 89, 1),   V(0x4ca9, 95, 90, 0),   V(0x44d9, 96, 91, 0),   V(0x3e22, 97, 92, 0),
    V(0x3824, 99, 93, 0),   V(0x32b4, 99, 94, 0),   V(0x2e17, 93, 86, 0),   V(0x56a8, 95, 96, 1),
    V(0x4f46, 101, 97, 0),  V(0x47e5, 102, 98, 0),  V(0x41cf, 103, 99, 0),  V(0x3c3d, 104, 100, 0),
    V(0x375e, 99, 93, 0),   V(0x5231, 105, 102, 0), V(0x4c0f, 106, 103, 0), V(0x4639, 107, 104, 0),
    V(0x415e, 103, 99, 0),  V(0x5627, 105, 106, 1), V(0x50e7, 108, 107, 0), V(0x4b85, 109, 103, 0),
    V(0x5597, 110, 109, 0), V(0x504f, 111, 107, 0), V(0x5a10, 110, 111, 1), V(0x5522, 112, 109, 0),
    V(0x59eb, 112, 111, 1), V(0x5a1d, 113, 113, 0)};
#undef V

struct ArithScanComp {
  int16_t* coef;
  int h, v, buf_cols, real_cols, real_rows;
  int dc_tbl, ac_tbl;
  int last_dc = 0, dc_context = 0;
};

struct ArithDecoder {
  const uint8_t* p;
  const uint8_t* end;
  bool marker = false;
  int32_t c = 0, a = 0;
  int ct = -16;  // -16: two bytes to read; -1: the scan stopped on a bad code
  int Ss = 0, Se = 63, Ah = 0, Al = 0;
  bool progressive = false;
  const int32_t* dac_l = nullptr;
  const int32_t* dac_u = nullptr;
  const int32_t* dac_k = nullptr;
  uint8_t dc_stats[4][64] = {};
  uint8_t ac_stats[4][256] = {};
  uint8_t fixed_bin[4] = {113, 0, 0, 0};

  int unread = 0;  // the marker the data ran into (0: none yet)

  int byte() {
    if (marker || p >= end) return 0;
    int d = *p++;
    if (d == 0xFF) {
      while (p < end && *p == 0xFF) ++p;
      int nxt = p < end ? *p++ : 0xD9;
      if (nxt == 0) return 0xFF;
      marker = true;  // a marker: zero data from here on
      unread = nxt;
      return 0;
    }
    return d;
  }

  int want = 0;  // the number of the next RSTn (libjpeg's next_restart_num, 0 at each scan)

  // jdmarker.c next_marker: skip to the next marker (past stuffed FF00s); the end of the scan's data is the
  // marker that ends the scan, never a restart marker
  int next_marker() {
    for (;;) {
      while (p < end && *p != 0xFF) ++p;
      while (p < end && *p == 0xFF) ++p;
      if (p >= end) return 0xD9;
      int m = *p++;
      if (m != 0) return m;
    }
  }

  // read_restart_marker, with jpeg_resync_to_restart where the marker is not the RSTn expected: the marker
  // the data ran into (or the next one ahead) is passed when it is the RSTn expected, one too far away, or
  // skipped past when it is an earlier one (action 2); any other marker (the EOI of a cut scan, or one of
  // the next two RSTn) stays unread (action 3), so the interval decodes from zero data. Then the coder
  // starts over.
  void restart() {
    int m = marker ? unread : next_marker();
    for (;;) {
      int action;
      if (m < 0xC0)
        action = 2;
      else if (m < 0xD0 || m > 0xD7)
        action = 3;
      else if (m == 0xD0 + ((want + 1) & 7) || m == 0xD0 + ((want + 2) & 7))
        action = 3;
      else if (m == 0xD0 + ((want - 1) & 7) || m == 0xD0 + ((want - 2) & 7))
        action = 2;
      else
        action = 1;
      if (action == 1) {
        marker = false;
        unread = 0;
        break;
      }
      if (action == 3) {
        marker = true;
        unread = m;
        break;
      }
      m = next_marker();
    }
    want = (want + 1) & 7;
    reset_coder();
  }

  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        c = (c << 8) | byte();
        if ((ct += 8) < 0)
          if (++ct == 0) a = 0x8000;  // two initial bytes read
      }
      a <<= 1;
    }
    int sv = *st;
    int32_t qe = kAritab[sv & 0x7F];
    const uint8_t nl = qe & 0xFF;
    qe >>= 8;
    const uint8_t nm = qe & 0xFF;
    qe >>= 8;
    int32_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {
        a = qe;
        *st = uint8_t((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = uint8_t((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }

  void reset_coder() {
    c = 0;
    a = 0;
    ct = -16;
  }

  // Figures F.19 and F.21-F.24: one DC difference; false on a magnitude overflow
  bool dc_diff(ArithScanComp& k, int tbl, int* diff) {
    uint8_t* st = dc_stats[tbl] + k.dc_context;
    if (decode(st) == 0) {
      k.dc_context = 0;
      *diff = 0;
      return true;
    }
    int sign = decode(st + 1);
    st += 2 + sign;
    int m = decode(st);
    if (m != 0) {
      st = dc_stats[tbl] + 20;
      while (decode(st)) {
        if ((m <<= 1) == 0x8000) return false;
        st += 1;
      }
    }
    if (m < int((1L << dac_l[tbl]) >> 1))
      k.dc_context = 0;
    else if (m > int((1L << dac_u[tbl]) >> 1))
      k.dc_context = 12 + sign * 4;
    else
      k.dc_context = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (decode(st)) v |= m;
    v += 1;
    *diff = sign ? -v : v;
    return true;
  }

  // the magnitude category and bits of an AC value at index k (st at its bin S0 + 2)
  bool ac_value(uint8_t* st, int tbl, int k, int sign, int* out) {
    int m = decode(st);
    if (m != 0 && decode(st)) {
      m <<= 1;
      st = ac_stats[tbl] + (k <= dac_k[tbl] ? 189 : 217);
      while (decode(st)) {
        if ((m <<= 1) == 0x8000) return false;
        st += 1;
      }
    }
    int v = m;
    st += 14;
    while (m >>= 1)
      if (decode(st)) v |= m;
    v += 1;
    *out = sign ? -v : v;
    return true;
  }

  void sequential(ArithScanComp& k, int16_t* blk) {
    int diff;
    if (!dc_diff(k, k.dc_tbl, &diff)) {
      ct = -1;
      return;
    }
    k.last_dc = (k.last_dc + diff) & 0xffff;
    blk[0] = int16_t(k.last_dc);
    if (Se == 0) return;
    const int tbl = k.ac_tbl;
    int i = 0;
    do {
      uint8_t* st = ac_stats[tbl] + 3 * i;
      if (decode(st)) break;  // EOB
      for (;;) {
        ++i;
        if (decode(st + 1)) break;
        st += 3;
        if (i >= Se) {
          ct = -1;  // spectral overflow
          return;
        }
      }
      int sign = decode(fixed_bin);
      int v;
      if (!ac_value(st + 2, tbl, i, sign, &v)) {
        ct = -1;
        return;
      }
      blk[kNatural[i]] = int16_t(v);
    } while (i < Se);
  }

  void dc_first(ArithScanComp& k, int16_t* blk) {
    int diff;
    if (!dc_diff(k, k.dc_tbl, &diff)) {
      ct = -1;
      return;
    }
    k.last_dc = (k.last_dc + diff) & 0xffff;
    blk[0] = int16_t(uint32_t(k.last_dc) << Al);
  }

  void dc_refine(int16_t* blk) {
    if (decode(fixed_bin)) blk[0] = int16_t(blk[0] | (1 << Al));
  }

  void ac_first(ArithScanComp& k, int16_t* blk) {
    const int tbl = k.ac_tbl;
    for (int i = Ss; i <= Se; ++i) {
      uint8_t* st = ac_stats[tbl] + 3 * (i - 1);
      if (decode(st)) break;  // EOB
      while (decode(st + 1) == 0) {
        st += 3;
        if (++i > Se) {
          ct = -1;
          return;
        }
      }
      int sign = decode(fixed_bin);
      int v;
      if (!ac_value(st + 2, tbl, i, sign, &v)) {
        ct = -1;
        return;
      }
      blk[kNatural[i]] = int16_t(uint32_t(v) << Al);
    }
  }

  void ac_refine(ArithScanComp& k, int16_t* blk) {
    const int tbl = k.ac_tbl;
    const int p1 = 1 << Al, m1 = -1 * (1 << Al);
    int kex = Se;
    for (; kex > 0; --kex)
      if (blk[kNatural[kex]]) break;
    for (int i = Ss; i <= Se; ++i) {
      uint8_t* st = ac_stats[tbl] + 3 * (i - 1);
      if (i > kex && decode(st)) break;  // EOB
      for (;;) {
        int16_t* coef = blk + kNatural[i];
        if (*coef) {
          if (decode(st + 2)) *coef = int16_t(*coef < 0 ? *coef + m1 : *coef + p1);
          break;
        }
        if (decode(st + 1)) {
          *coef = int16_t(decode(fixed_bin) ? m1 : p1);
          break;
        }
        st += 3;
        if (++i > Se) {
          ct = -1;
          return;
        }
      }
    }
  }

  void block(ArithScanComp& k, int16_t* blk) {
    if (ct == -1) return;  // a bad code stopped the scan
    if (!progressive)
      sequential(k, blk);
    else if (Ss == 0)
      Ah == 0 ? dc_first(k, blk) : dc_refine(blk);
    else
      Ah == 0 ? ac_first(k, blk) : ac_refine(k, blk);
  }
};

struct BitWriter {
  uint8_t* out;
  int64_t cap;
  int64_t n = 0;
  uint64_t acc = 0;
  int nbits = 0;
  bool overflow = false;

  void byte(uint8_t b) {
    if (n + 2 > cap) {
      overflow = true;
      return;
    }
    out[n++] = b;
    if (b == 0xFF) out[n++] = 0x00;
  }
  void put(uint32_t code, int size) {
    if (size == 0) return;
    acc = (acc << size) | (code & ((1u << size) - 1));
    nbits += size;
    while (nbits >= 8) {
      byte(static_cast<uint8_t>(acc >> (nbits - 8)));
      nbits -= 8;
    }
  }
  void flush() {  // pad with one bits
    if (nbits > 0) put((1u << (8 - nbits)) - 1, 8 - nbits);
  }
};

inline int nbits_of(int v) {
  int a = v < 0 ? -v : v;
  int n = 0;
  while (a) {
    ++n;
    a >>= 1;
  }
  return n;
}

}  // namespace

extern "C" {

// Decode one scan's entropy-coded data.
//   data, len      the bytes after the SOS header up to the marker that ends the scan
//   ncomp          components in the scan (1..4)
//   coef           per scan component, its int16 buffer [rows * buf_cols, 64]
//   geom           per scan component 7 ints: h, v, buf_cols, real_cols, real_rows, dc table, ac table
//   mcux, mcuy     the interleaved MCU grid (read when ncomp > 1)
//   bits, vals     8 Huffman tables (0-3 DC, 4-7 AC): 16 code counts and 256 values each;
//   present        8 flags
//   ss, se, ah, al the scan's spectral selection and successive approximation
//   progressive    1 under SOF2
//   restart        the restart interval in MCUs (0: none)
// Returns -2 when the scan reads an undefined table, -4 when a table it reads
// is one libjpeg refuses (Huff::build).
int vkgr_jpeg_decode_scan(const uint8_t* data, int64_t len, int32_t ncomp, int16_t* const* coef,
                          const int32_t* geom, int32_t mcux, int32_t mcuy, const uint8_t* bits,
                          const uint8_t* vals, const uint8_t* present, int32_t ss, int32_t se,
                          int32_t ah, int32_t al, int32_t progressive, int32_t restart) {
  if (ncomp < 1 || ncomp > 4 || ss < 0 || se > 63 || ss > se || al < 0 || al > 13) return -1;
  // build the tables the scan reads, as libjpeg does when a scan starts
  Huff tables[8];
  auto use = [&](int t, bool dc) {
    if (!present[t]) return -2;
    if (!tables[t].present && !tables[t].build(bits + 16 * t, vals + 256 * t, dc)) return -4;
    return 0;
  };
  ScanComp comps[4];
  bool need_dc = !progressive || (ss == 0 && ah == 0);  // a DC refinement reads no table
  bool need_ac = !progressive || ss > 0;
  for (int i = 0; i < ncomp; ++i) {
    const int32_t* g = geom + 7 * i;
    int dc = g[5] & 3, ac = 4 + (g[6] & 3);
    comps[i] = ScanComp{coef[i], g[0], g[1], g[2], g[3], g[4], &tables[dc], &tables[ac], 0};
    int rc = need_dc ? use(dc, true) : 0;
    if (rc == 0 && need_ac) rc = use(ac, false);
    if (rc) return rc;
  }
  Decoder d{BitReader{data, data + len}, ss, se, ah, al, progressive != 0};
  int64_t mcus_done = 0;
  auto maybe_restart = [&]() {
    if (restart > 0 && mcus_done > 0 && mcus_done % restart == 0) {
      d.br.restart();
      d.eobrun = 0;
      for (int i = 0; i < ncomp; ++i) comps[i].pred = 0;
    }
  };
  if (ncomp == 1) {  // non-interleaved: the component's own block grid, one block an MCU
    ScanComp& c = comps[0];
    for (int by = 0; by < c.real_rows; ++by)
      for (int bx = 0; bx < c.real_cols; ++bx) {
        maybe_restart();
        if (!d.br.insufficient)  // past the data's end libjpeg leaves the MCU as it is
          d.block(c, c.coef + (static_cast<int64_t>(by) * c.buf_cols + bx) * 64);
        ++mcus_done;
      }
    return 0;
  }
  for (int my = 0; my < mcuy; ++my)
    for (int mx = 0; mx < mcux; ++mx) {
      maybe_restart();
      if (d.br.insufficient) {
        ++mcus_done;
        continue;
      }
      for (int i = 0; i < ncomp; ++i) {
        ScanComp& c = comps[i];
        for (int y = 0; y < c.v; ++y)
          for (int x = 0; x < c.h; ++x) {
            int64_t row = static_cast<int64_t>(my) * c.v + y, col = static_cast<int64_t>(mx) * c.h + x;
            d.block(c, c.coef + (row * c.buf_cols + col) * 64);
          }
      }
      ++mcus_done;
    }
  return 0;
}

// Decode one arithmetic-coded scan: the arguments of vkgr_jpeg_decode_scan,
// with the DAC conditioning bounds (dac_l, dac_u per DC table, dac_k per AC
// table) in place of the Huffman tables.
int vkgr_jpeg_decode_scan_arith(const uint8_t* data, int64_t len, int32_t ncomp, int16_t* const* coef,
                                const int32_t* geom, int32_t mcux, int32_t mcuy, const int32_t* dac_l,
                                const int32_t* dac_u, const int32_t* dac_k, int32_t ss, int32_t se, int32_t ah,
                                int32_t al, int32_t progressive, int32_t restart) {
  if (ncomp < 1 || ncomp > 4 || ss < 0 || se > 63 || ss > se || al < 0 || al > 13) return -1;
  ArithDecoder d{data, data + len};
  d.Ss = ss;
  d.Se = se;
  d.Ah = ah;
  d.Al = al;
  d.progressive = progressive != 0;
  d.dac_l = dac_l;
  d.dac_u = dac_u;
  d.dac_k = dac_k;
  ArithScanComp comps[4];
  for (int i = 0; i < ncomp; ++i) {
    const int32_t* g = geom + 7 * i;
    comps[i] = ArithScanComp{coef[i], g[0], g[1], g[2], g[3], g[4], g[5] & 3, g[6] & 3};
  }
  const bool dc_pass = !progressive || (ss == 0 && ah == 0);
  const bool ac_pass = (!progressive && se > 0) || (progressive && ss > 0);
  auto reset_stats = [&]() {
    for (int i = 0; i < ncomp; ++i) {
      if (dc_pass) {
        std::memset(d.dc_stats[comps[i].dc_tbl], 0, 64);
        comps[i].last_dc = 0;
        comps[i].dc_context = 0;
      }
      if (ac_pass) std::memset(d.ac_stats[comps[i].ac_tbl], 0, 256);
    }
  };
  reset_stats();
  int64_t mcus_done = 0;
  auto maybe_restart = [&]() {
    if (restart > 0 && mcus_done > 0 && mcus_done % restart == 0) {
      d.restart();
      reset_stats();
    }
  };
  if (ncomp == 1) {
    ArithScanComp& c = comps[0];
    for (int by = 0; by < c.real_rows; ++by)
      for (int bx = 0; bx < c.real_cols; ++bx) {
        maybe_restart();
        d.block(c, c.coef + (int64_t(by) * c.buf_cols + bx) * 64);
        ++mcus_done;
      }
    return 0;
  }
  for (int my = 0; my < mcuy; ++my)
    for (int mx = 0; mx < mcux; ++mx) {
      maybe_restart();
      for (int i = 0; i < ncomp; ++i) {
        ArithScanComp& c = comps[i];
        for (int y = 0; y < c.v; ++y)
          for (int x = 0; x < c.h; ++x) {
            int64_t row = int64_t(my) * c.v + y, col = int64_t(mx) * c.h + x;
            d.block(c, c.coef + (row * c.buf_cols + col) * 64);
          }
      }
      ++mcus_done;
    }
  return 0;
}

// Decode one lossless (SOF3) scan of ncomp components, as libjpeg-turbo's
// jddiffct.c and jdpred.c do. A data unit is one sample: an interleaved scan
// codes MCUs of h x v samples of each component in turn (the samples past a
// component's edge in the last MCU column and row are decoded and dropped),
// a scan of one component codes its samples in raster order. The
// differences of one iMCU row (v rows of each component) are decoded first
// and then undone row by row; a restart (every `restart` MCUs, a whole
// number of MCU rows) makes the next undone row of every component a first
// row again, which predicts from the left.
//   out            per component its uint16 plane [geom rows, geom cols]
//   geom           per component h, v, cols, rows, DC Huffman table (0..3)
//   mcux, mcuy     an interleaved scan's MCU columns and rows (ceil(W / hmax),
//                  ceil(H / vmax))
//   bits, vals, present   the Huffman tables as vkgr_jpeg_decode_scan takes them
//   precision, predictor (1..7), pt   the frame's P and the scan's Ss and Al
//   restart        the restart interval in MCUs
// Returns -2 / -4 for an undefined or refused table, -5 for a restart
// interval that is not a whole number of MCU rows.
int vkgr_jpeg_decode_lossless(const uint8_t* data, int64_t len, int32_t ncomp, uint16_t* const* out,
                              const int32_t* geom, int32_t mcux, int32_t mcuy, const uint8_t* bits,
                              const uint8_t* vals, const uint8_t* present, int32_t precision, int32_t predictor,
                              int32_t pt, int32_t restart) {
  if (ncomp < 1 || ncomp > 4 || predictor < 1 || predictor > 7 || pt < 0 || pt >= precision) return -1;
  Huff tables[4];
  const Huff* tab[4];
  int hs[4], vs[4], cols[4], rows[4], pitch[4];
  for (int i = 0; i < ncomp; ++i) {
    const int32_t* g = geom + 5 * i;
    hs[i] = ncomp == 1 ? 1 : g[0];
    vs[i] = g[1];
    cols[i] = g[2];
    rows[i] = g[3];
    if (hs[i] < 1 || vs[i] < 1 || cols[i] < 1 || rows[i] < 1) return -1;
    int t = g[4] & 3;
    if (!present[t]) return -2;
    if (!tables[t].present && !tables[t].build(bits + 16 * t, vals + 256 * t, true, 16)) return -4;
    tab[i] = &tables[t];
  }
  const bool interleaved = ncomp > 1;
  const int per_row = interleaved ? mcux : cols[0];
  const int imcu_rows = interleaved ? mcuy : (rows[0] + vs[0] - 1) / vs[0];
  if (per_row < 1 || imcu_rows < 1) return -1;
  if (restart > 0 && restart % per_row != 0) return -5;
  std::vector<std::vector<int32_t>> diff(ncomp), prev(ncomp), cur(ncomp);
  for (int c = 0; c < ncomp; ++c) {
    pitch[c] = interleaved ? mcux * hs[c] : cols[c];
    diff[c].assign(size_t(pitch[c]) * vs[c], 0);
    prev[c].assign(cols[c], 0);
    cur[c].assign(cols[c], 0);
  }
  BitReader br{data, data + len};
  const int restart_rows = restart > 0 ? restart / per_row : 0;
  int rows_to_go = restart_rows;
  const int initial = 1 << (precision - pt - 1);
  bool first_row[4] = {true, true, true, true};
  auto sample = [&](const Huff* t) {
    int s = t->decode(br);
    return s == 0 ? 0 : s == 16 ? 32768 : extend(br.get(s), s);
  };
  for (int im = 0; im < imcu_rows; ++im) {
    const bool last = im == imcu_rows - 1;
    const int mcu_rows = interleaved ? 1 : last ? rows[0] - im * vs[0] : vs[0];
    for (int yo = 0; yo < mcu_rows; ++yo) {
      if (restart_rows > 0 && rows_to_go == 0) {
        br.restart();
        rows_to_go = restart_rows;
        for (int c = 0; c < ncomp; ++c) first_row[c] = true;
      }
      if (br.insufficient) {  // jdlhuff.c: zero differences, and the undifferencer starts over (rows of 2^(P-Pt-1))
        for (int c = 0; c < ncomp; ++c) {
          if (interleaved)
            std::fill(diff[c].begin(), diff[c].end(), 0);
          else
            std::fill(diff[c].begin() + size_t(yo) * pitch[c], diff[c].begin() + size_t(yo + 1) * pitch[c], 0);
          first_row[c] = true;
        }
        if (restart_rows > 0) --rows_to_go;
        continue;
      }
      for (int mx = 0; mx < per_row; ++mx) {
        if (interleaved) {
          for (int c = 0; c < ncomp; ++c)
            for (int yy = 0; yy < vs[c]; ++yy)
              for (int xx = 0; xx < hs[c]; ++xx) diff[c][size_t(yy) * pitch[c] + mx * hs[c] + xx] = sample(tab[c]);
        } else {
          diff[0][size_t(yo) * pitch[0] + mx] = sample(tab[0]);
        }
      }
      if (restart_rows > 0) --rows_to_go;
    }
    for (int c = 0; c < ncomp; ++c) {
      const int n = last ? rows[c] - im * vs[c] : vs[c];
      for (int r = 0; r < n && r < vs[c]; ++r) {
        const int32_t* d = diff[c].data() + size_t(r) * pitch[c];
        std::vector<int32_t>& up = prev[c];
        std::vector<int32_t>& row = cur[c];
        for (int x = 0; x < cols[c]; ++x) {
          int pred;
          if (first_row[c]) {
            pred = x == 0 ? initial : row[x - 1];
          } else if (x == 0) {
            pred = up[0];
          } else {
            const int ra = row[x - 1], rb = up[x], rc = up[x - 1];
            switch (predictor) {
              case 1: pred = ra; break;
              case 2: pred = rb; break;
              case 3: pred = rc; break;
              case 4: pred = ra + rb - rc; break;
              case 5: pred = ra + ((rb - rc) >> 1); break;
              case 6: pred = rb + ((ra - rc) >> 1); break;
              default: pred = (ra + rb) >> 1; break;
            }
          }
          row[x] = (pred + d[x]) & 0xFFFF;
          out[c][int64_t(im * vs[c] + r) * cols[c] + x] = uint16_t(row[x] << pt);
        }
        first_row[c] = false;
        std::swap(prev[c], cur[c]);
      }
    }
  }
  return 0;
}

// Encode one scan with point transform 0.
//   blocks         [n, 64] int16 natural-order coefficients in coding order
//   comp           [n] the scan component of each block (0..3; its DC predictor and tables)
//   dc_code/size   [4][256] the code and length of each DC symbol, per scan component
//   ac_code/size   [4][256] likewise for AC
//   ss, se         0, 63 baseline; 0, 0 progressive DC first; 1, 63 progressive AC first
//   out, cap       the output buffer; the bytes written go to *written
int vkgr_jpeg_encode_scan(const int16_t* blocks, const int32_t* comp, int64_t n, const uint16_t* dc_code,
                          const uint8_t* dc_size, const uint16_t* ac_code, const uint8_t* ac_size,
                          int32_t ss, int32_t se, uint8_t* out, int64_t cap, int64_t* written) {
  if (ss < 0 || se > 63 || ss > se) return -1;
  BitWriter bw{out, cap};
  int pred[4] = {0, 0, 0, 0};
  for (int64_t b = 0; b < n; ++b) {
    const int16_t* blk = blocks + b * 64;
    int c = comp[b] & 3;
    if (ss == 0) {
      int diff = blk[0] - pred[c];
      pred[c] = blk[0];
      int s = nbits_of(diff);
      if (dc_size[c * 256 + s] == 0) return -2;
      bw.put(dc_code[c * 256 + s], dc_size[c * 256 + s]);
      bw.put(static_cast<uint32_t>(diff < 0 ? diff - 1 : diff), s);
    }
    if (se == 0) continue;
    const uint16_t* code = ac_code + c * 256;
    const uint8_t* size = ac_size + c * 256;
    int run = 0;
    for (int k = ss < 1 ? 1 : ss; k <= se; ++k) {
      int v = blk[kNatural[k]];
      if (v == 0) {
        ++run;
        continue;
      }
      while (run > 15) {
        bw.put(code[0xF0], size[0xF0]);
        run -= 16;
      }
      int s = nbits_of(v);
      int sym = (run << 4) | s;
      if (size[sym] == 0) return -2;
      bw.put(code[sym], size[sym]);
      bw.put(static_cast<uint32_t>(v < 0 ? v - 1 : v), s);
      run = 0;
    }
    if (run > 0) bw.put(code[0x00], size[0x00]);
  }
  bw.flush();
  if (bw.overflow) return -3;
  *written = bw.n;
  return 0;
}

}  // extern "C"
