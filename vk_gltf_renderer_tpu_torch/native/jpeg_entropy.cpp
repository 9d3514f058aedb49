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
// marker inside the data reads as zero bits).
//
// Encoding one scan: the blocks in coding order with their component's
// tables; DC differences and AC run/size symbols (EOB and ZRL), byte
// stuffing, padding with one bits. The same routine writes a baseline scan
// (Ss 0, Se 63), a progressive DC-first scan (Ss = Se = 0) and a
// progressive AC-first scan (Ss 1, Se 63) with point transform 0.
//
// Exported C ABI (all return 0 on success, < 0 on bad arguments or tables):
//   vkgr_jpeg_decode_scan(...)  see below
//   vkgr_jpeg_encode_scan(...)  see below
//
// Build: g++ -O2 -shared -fPIC -std=c++17

#include <cstdint>
#include <cstring>

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
      }
      buf = (buf << 8) | byte;
      nbits += 8;
    }
  }
  int peek(int n) {
    if (nbits < n) fill();
    return static_cast<int>((buf >> (nbits - n)) & ((1u << n) - 1));
  }
  void skip(int n) { nbits -= n; }
  int get(int n) {
    if (n == 0) return 0;
    int v = peek(n);
    nbits -= n;
    return v;
  }
  // byte-align, then pass the next RSTn marker
  void restart() {
    buf = 0;
    nbits = 0;
    marker = false;
    while (p + 1 < end && !(p[0] == 0xFF && p[1] >= 0xD0 && p[1] <= 0xD7)) ++p;
    if (p + 1 < end) p += 2;
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
  bool build(const uint8_t* bits, const uint8_t* v, bool dc) {
    int total = 0;
    for (int l = 0; l < 16; ++l) total += bits[l];
    if (total > 256) return false;
    if (dc)
      for (int k = 0; k < total; ++k)
        if (v[k] > 15) return false;
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
        d.block(c, c.coef + (static_cast<int64_t>(by) * c.buf_cols + bx) * 64);
        ++mcus_done;
      }
    return 0;
  }
  for (int my = 0; my < mcuy; ++my)
    for (int mx = 0; mx < mcux; ++mx) {
      maybe_restart();
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
