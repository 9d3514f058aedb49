// Byte-stream coders of the port's image readers and its GIF writer
// (ops/bmp.py, ops/tga.py, ops/gif.py, ops/tiff.py, ops/psd.py, ops/sgi.py,
// ops/pcx.py, ops/qoi.py, ops/sun.py): the loops
// that would take tens of seconds a 2048^2 map in Python. Each decoder
// follows the code that Pillow reads the format with, so that a file
// (corrupt ones included) decodes as the JAX package decodes it:
//
//   vkgr_tiff_lzw       libtiff's tif_lzw.c: MSB-first codes with early
//                       change, and the old-style LSB-first form (a strip
//                       that starts 0x00, then a byte with bit 0 set),
//   vkgr_packbits       libtiff's tif_packbits.c,
//   vkgr_gif_lzw_decode Pillow's GifDecode.c (LSB-first, 2-12 bit codes,
//                       no new entries once the table holds 4096, rows in
//                       GIF's interlace order, done only when the frame is
//                       full),
//   vkgr_gif_lzw_encode a plain GIF LZW writer (clear when the table is
//                       full), in sub-blocks of 255 bytes,
//   vkgr_bmp_rle        Pillow's BmpRleDecoder (RLE8 and RLE4, with its
//                       file-position word alignment and its delta record),
//   vkgr_tga_rle        Pillow's TgaRleDecode.c (packets cross scan lines),
//   vkgr_packbits_rows  Pillow's PackbitsDecode.c over PSD rows,
//   vkgr_sgi_rle        Pillow's SgiRleDecode.c (8 and 16-bit samples),
//   vkgr_pcx_rle        Pillow's PcxDecode.c,
//   vkgr_sun_rle        Pillow's SunRleDecode.c (runs cross scan lines),
//   vkgr_qoi_decode     Pillow's QoiDecoder (the QOI ops, its index table),
//   vkgr_ccitt          libtiff's tif_fax3.c: CCITT modified Huffman (TIFF
//                       compression 2), T.4 one- and two-dimensional
//                       (Group 3) and T.6 (Group 4),
//   vkgr_thunderscan    libtiff's tif_thunder.c,
//   vkgr_png_unfilter   Pillow's ZipDecode.c: PNG's five scanline filters
//                       undone, one interlace pass (or the whole image) a
//                       call,
//   vkgr_lab_to_rgb     LittleCMS's TetrahedralInterp16 in the 16-bit
//                       table of ops/imagemodes.lab_table (Pillow's LAB to
//                       RGB),
//   vkgr_msp_rle        Pillow's MspDecoder (version 2 Windows Paint rows),
//   vkgr_bit_decode     Pillow's BitDecode.c as IM's "L*j" types call it,
//   vkgr_fli_frame      Pillow's FliDecode.c (one FLI/FLC frame's chunks),
//   vkgr_icns_rle       IcnsImagePlugin.read_32's three RLE channels.
//
// Exported C ABI: every function returns 0 on success and < 0 on corrupt
// or short data (the Python side raises ValueError).
//
// Build: g++ -O2 -shared -fPIC -std=c++17

#include <algorithm>
#include <cstdlib>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kCodeClear = 256, kCodeEoi = 257, kCodeFirst = 258;
constexpr int kTiffTable = 4096 + 1024;  // libtiff's CSIZE: the table may run past 12 bits' codes

struct TiffEntry {
  int32_t next;  // the prefix entry, -1 for a root
  int32_t length;
  uint8_t value, firstchar;
};


// ITU-T T.4 modified Huffman codes: {code bits, run length}; terminating
// codes 0-63, make-up codes 64-1728 of each colour, then the make-up codes
// 1792-2560 that both colours share.
struct FaxCode {
  const char* bits;
  int16_t run;
};
const FaxCode kWhite[] = {
    {"00110101", 0}, {"000111", 1}, {"0111", 2}, {"1000", 3}, {"1011", 4}, {"1100", 5}, {"1110", 6},
    {"1111", 7}, {"10011", 8}, {"10100", 9}, {"00111", 10}, {"01000", 11}, {"001000", 12}, {"000011", 13},
    {"110100", 14}, {"110101", 15}, {"101010", 16}, {"101011", 17}, {"0100111", 18}, {"0001100", 19},
    {"0001000", 20}, {"0010111", 21}, {"0000011", 22}, {"0000100", 23}, {"0101000", 24}, {"0101011", 25},
    {"0010011", 26}, {"0100100", 27}, {"0011000", 28}, {"00000010", 29}, {"00000011", 30}, {"00011010", 31},
    {"00011011", 32}, {"00010010", 33}, {"00010011", 34}, {"00010100", 35}, {"00010101", 36}, {"00010110", 37},
    {"00010111", 38}, {"00101000", 39}, {"00101001", 40}, {"00101010", 41}, {"00101011", 42}, {"00101100", 43},
    {"00101101", 44}, {"00000100", 45}, {"00000101", 46}, {"00001010", 47}, {"00001011", 48}, {"01010010", 49},
    {"01010011", 50}, {"01010100", 51}, {"01010101", 52}, {"00100100", 53}, {"00100101", 54}, {"01011000", 55},
    {"01011001", 56}, {"01011010", 57}, {"01011011", 58}, {"01001010", 59}, {"01001011", 60}, {"00110010", 61},
    {"00110011", 62}, {"00110100", 63}, {"11011", 64}, {"10010", 128}, {"010111", 192}, {"0110111", 256},
    {"00110110", 320}, {"00110111", 384}, {"01100100", 448}, {"01100101", 512}, {"01101000", 576},
    {"01100111", 640}, {"011001100", 704}, {"011001101", 768}, {"011010010", 832}, {"011010011", 896},
    {"011010100", 960}, {"011010101", 1024}, {"011010110", 1088}, {"011010111", 1152}, {"011011000", 1216},
    {"011011001", 1280}, {"011011010", 1344}, {"011011011", 1408}, {"010011000", 1472}, {"010011001", 1536},
    {"010011010", 1600}, {"011000", 1664}, {"010011011", 1728}};
const FaxCode kBlack[] = {
    {"0000110111", 0}, {"010", 1}, {"11", 2}, {"10", 3}, {"011", 4}, {"0011", 5}, {"0010", 6}, {"00011", 7},
    {"000101", 8}, {"000100", 9}, {"0000100", 10}, {"0000101", 11}, {"0000111", 12}, {"00000100", 13},
    {"00000111", 14}, {"000011000", 15}, {"0000010111", 16}, {"0000011000", 17}, {"0000001000", 18},
    {"00001100111", 19}, {"00001101000", 20}, {"00001101100", 21}, {"00000110111", 22}, {"00000101000", 23},
    {"00000010111", 24}, {"00000011000", 25}, {"000011001010", 26}, {"000011001011", 27}, {"000011001100", 28},
    {"000011001101", 29}, {"000001101000", 30}, {"000001101001", 31}, {"000001101010", 32},
    {"000001101011", 33}, {"000011010010", 34}, {"000011010011", 35}, {"000011010100", 36},
    {"000011010101", 37}, {"000011010110", 38}, {"000011010111", 39}, {"000001101100", 40},
    {"000001101101", 41}, {"000011011010", 42}, {"000011011011", 43}, {"000001010100", 44},
    {"000001010101", 45}, {"000001010110", 46}, {"000001010111", 47}, {"000001100100", 48},
    {"000001100101", 49}, {"000001010010", 50}, {"000001010011", 51}, {"000000100100", 52},
    {"000000110111", 53}, {"000000111000", 54}, {"000000100111", 55}, {"000000101000", 56},
    {"000001011000", 57}, {"000001011001", 58}, {"000000101011", 59}, {"000000101100", 60},
    {"000001011010", 61}, {"000001100110", 62}, {"000001100111", 63}, {"0000001111", 64},
    {"000011001000", 128}, {"000011001001", 192}, {"000001011011", 256}, {"000000110011", 320},
    {"000000110100", 384}, {"000000110101", 448}, {"0000001101100", 512}, {"0000001101101", 576},
    {"0000001001010", 640}, {"0000001001011", 704}, {"0000001001100", 768}, {"0000001001101", 832},
    {"0000001110010", 896}, {"0000001110011", 960}, {"0000001110100", 1024}, {"0000001110101", 1088},
    {"0000001110110", 1152}, {"0000001110111", 1216}, {"0000001010010", 1280}, {"0000001010011", 1344},
    {"0000001010100", 1408}, {"0000001010101", 1472}, {"0000001011010", 1536}, {"0000001011011", 1600},
    {"0000001100100", 1664}, {"0000001100101", 1728}};
const FaxCode kExtended[] = {
    {"00000001000", 1792}, {"00000001100", 1856}, {"00000001101", 1920}, {"000000010010", 1984},
    {"000000010011", 2048}, {"000000010100", 2112}, {"000000010101", 2176}, {"000000010110", 2240},
    {"000000010111", 2304}, {"000000011100", 2368}, {"000000011101", 2432}, {"000000011110", 2496},
    {"000000011111", 2560}};
// T.4 two-dimensional mode codes: vertical offsets -3..3, then these
constexpr int kPass = 10, kHoriz = 11, kExt = 12, kEol = 13;
const FaxCode kModes[] = {{"1", 0},        {"011", 1},     {"000011", 2},       {"0000011", 3},
                          {"010", -1},     {"000010", -2}, {"0000010", -3},     {"0001", kPass},
                          {"001", kHoriz}, {"0000001", kExt}, {"000000000001", kEol}};

constexpr int kFaxMaxLen = 13;
constexpr int16_t kNoCode = -32768;

// A code table as lut[length][code]; kNoCode where no code has those bits.
struct FaxTable {
  std::vector<int16_t> lut = std::vector<int16_t>(size_t(kFaxMaxLen + 1) << kFaxMaxLen, kNoCode);
  void add(const FaxCode* codes, size_t n) {
    for (size_t i = 0; i < n; ++i) {
      int len = int(std::strlen(codes[i].bits)), code = 0;
      for (int k = 0; k < len; ++k) code = (code << 1) | (codes[i].bits[k] - '0');
      lut[(size_t(len) << kFaxMaxLen) | code] = codes[i].run;
    }
  }
};

// MSB-first bits of a fax strip (FillOrder 2 is undone before).
struct FaxBits {
  const uint8_t* p;
  int64_t n, pos = 0;  // pos in bits
  int64_t loaded = -1;  // libtiff's bits loaded so far (BitsAvail + pos), padding included; -1: not started
  int bit() { return pos < n * 8 ? (p[pos >> 3] >> (7 - (pos++ & 7))) & 1 : -1; }
  // a bit, zero past the end of the data (libtiff's zero padding)
  int bitz() {
    const int b = pos < n * 8 ? (p[pos >> 3] >> (7 - (pos & 7))) & 1 : 0;
    ++pos;
    return b;
  }
  int peekz(int k) const {
    int v = 0;
    for (int64_t q = pos; q < pos + k; ++q) v = (v << 1) | (q < n * 8 ? (p[q >> 3] >> (7 - (q & 7))) & 1 : 0);
    return v;
  }
  // libtiff's NeedBits(k): false where no bit is left (its EOF), else
  // pads the bits left with zeros up to k past the end of the data
  bool need(int k) {
    if (loaded < 0) loaded = n * 8;
    if (pos + k <= loaded) return true;
    if (pos >= loaded) return false;
    loaded = pos + k;
    return true;
  }
  // one code of `t` over zero-padded bits: its value, or kNoCode with no bit
  // taken (an empty entry of libtiff's state tables has width 0)
  int code_z(const FaxTable& t) {
    const int64_t start = pos;
    int c = 0;
    for (int len = 1; len <= kFaxMaxLen; ++len) {
      c = (c << 1) | bitz();
      int16_t v = t.lut[(size_t(len) << kFaxMaxLen) | c];
      if (v != kNoCode) return v;
    }
    pos = start;
    return kNoCode;
  }
  // one code of `t`: its value, kNoCode for bits no code has, -32767 at the end of the data
  int code(const FaxTable& t) {
    int c = 0;
    for (int len = 1; len <= kFaxMaxLen; ++len) {
      int b = bit();
      if (b < 0) return -32767;
      c = (c << 1) | b;
      int16_t v = t.lut[(size_t(len) << kFaxMaxLen) | c];
      if (v != kNoCode) return v;
    }
    return kNoCode;
  }
  // a run: make-up codes, then a terminating code; < 0 on bad or missing codes
  int run(const FaxTable& t) {
    int total = 0;
    for (;;) {
      int v = code(t);
      if (v < 0) return -1;
      total += v;
      if (v < 64) return total;
    }
  }
  // libtiff's SYNC_EOL: unless an EOL was read at the end of the row before
  // (eolcnt), 11 zero bits found sliding a bit at a time; then the zeros up
  // to and including the 1 that ends the EOL; NeedBits pads the bits left
  // with zeros. False where no bit is left.
  bool sync_eol(bool eolcnt) {
    if (!eolcnt)
      for (;;) {
        if (!need(11)) return false;
        if (peekz(11) == 0) break;
        ++pos;
      }
    for (;;) {
      if (!need(8)) return false;
      if (peekz(8)) break;
      pos += 8;
    }
    while (!bitz()) {
    }
    return true;
  }
};

const FaxTable& fax_table(int which) {
  static const FaxTable* tables = [] {
    static FaxTable t[3];
    t[0].add(kWhite, sizeof(kWhite) / sizeof(kWhite[0]));
    t[0].add(kExtended, sizeof(kExtended) / sizeof(kExtended[0]));
    t[1].add(kBlack, sizeof(kBlack) / sizeof(kBlack[0]));
    t[1].add(kExtended, sizeof(kExtended) / sizeof(kExtended[0]));
    t[2].add(kModes, sizeof(kModes) / sizeof(kModes[0]));
    return t;
  }();
  return tables[which];
}

// One row coded one-dimensionally: alternating white and black runs from
// white, into the changing elements `cur`; false on a bad code or the end
// of the data.
bool fax_row_1d(FaxBits& br, int w, std::vector<int>& cur) {
  cur.clear();
  int a0 = 0, colour = 0;
  while (a0 < w) {
    int r = br.run(fax_table(colour));
    if (r < 0) return false;
    a0 = std::min(a0 + r, w);
    cur.push_back(a0);
    colour ^= 1;
  }
  return true;
}

void fax_fill(const std::vector<int>& cur, int w, uint8_t* row) {
  std::memset(row, 0, size_t((w + 7) / 8));
  for (size_t k = 0; k < cur.size(); k += 2) {
    const int x0 = cur[k], x1 = k + 1 < cur.size() ? cur[k + 1] : w;
    for (int x = x0; x < x1 && x < w; ++x) row[x >> 3] |= uint8_t(0x80 >> (x & 7));
  }
}

// libtiff's two run arrays of a T.4 or T.6 strip (Fax3SetupState): nruns
// entries each (twice as many where rows refer to the row before), zeroed
// once, swapped after every row and never cleared, so a reference read past
// its row's runs meets the runs of an earlier row.
struct FaxRuns {
  size_t nruns;
  std::vector<uint32_t> a, b;
  uint32_t *cur, *ref;
  size_t ncur = 0;  // the runs of the row in cur
  FaxRuns(int w, bool ref_line) : nruns((ref_line ? 2 : 1) * ((size_t(w) + 1 + 31) / 32 * 32)), a(nruns), b(nruns) {
    cur = a.data();
    ref = b.data();
    ref[0] = uint32_t(w);  // Fax3PreDecode: the first reference row white
    ref[1] = 0;
  }
};

// One T.6 row, or a two-dimensional T.4 row (t4), as libtiff's EXPAND2D
// decodes it, in run lengths (white, black, ... as libtiff keeps them)
// against the reference row's runs:
// b1 walks the reference runs (CHECK_b1), a pass adds to a pending run,
// the lookups pad the bits left with zeros past the end of the data
// (NeedBits) and meet the end only when no bit is left. Returns 0 for a
// whole row, 1 where the data end (eof2d: CLEANUP_RUNS, libtiff fills
// the row and stops) or, in T.6 data, an EOL is read (the row's rest its
// colour at that point; in T.4 data the row ends there, eol is set and the
// next row's EOL search is skipped), 2 for a bad code (libtiff's
// "unexpected": CLEANUP_RUNS, and the next row goes on from the bits after
// it), -1 where a run array would overflow (libtiff fails the strip).
int expand2d(FaxBits& br, int w, FaxRuns& fr, bool t4, bool& eol) {
  const int64_t lastx = w;
  uint32_t* const runs = fr.cur;
  const uint32_t* const ref = fr.ref;
  size_t pa = 0, pb = 0;
  int64_t a0 = 0, run_length = 0;
  int64_t b1 = ref[pb++];
  auto setvalue = [&](int64_t x) {
    runs[pa++] = uint32_t(run_length + x);
    a0 += x;
    run_length = 0;
  };
  auto check_b1 = [&]() {  // false past the reference array (libtiff's "Buffer overflow")
    if (pa != 0)
      while (b1 <= a0 && b1 < lastx) {
        if (pb + 1 >= fr.nruns) return false;
        b1 += int64_t(ref[pb]) + ref[pb + 1];
        pb += 2;
      }
    return true;
  };
  auto cleanup = [&]() -> bool {  // CLEANUP_RUNS; false where it would overflow the array
    if (pa + 3 > fr.nruns) return false;
    if (run_length) setvalue(0);
    if (a0 != lastx) {
      while (a0 > lastx && pa > 0) a0 -= runs[--pa];
      if (a0 < lastx) {
        if (a0 < 0) a0 = 0;
        if (pa & 1) setvalue(0);
        setvalue(lastx - a0);
      } else if (a0 > lastx) {
        setvalue(lastx);
        setvalue(0);
      }
    }
    return true;
  };
  auto finish = [&](int rc) -> int {
    if (!cleanup()) return -1;
    fr.ncur = pa;
    return rc;
  };
  while (a0 < lastx) {
    if (pa + 4 >= fr.nruns) return -1;
    if (!br.need(7)) return finish(1);
    const int peek = br.peekz(7);
    if (peek == 0 || peek == 1) {  // S_EOL (seven zeros) or S_Ext (uncompressed mode)
      br.pos += 7;
      runs[pa++] = uint32_t(lastx - a0);  // *pa++ = lastx - a0: a0 does not move
      if (peek == 1) return finish(2);  // libtiff's "extension"
      if (!br.need(4)) return finish(1);
      br.pos += 4;
      if (!t4) return finish(1);  // Fax4Decode stops at an EOL
      eol = true;  // Fax3Decode2D goes on to the next row (EOLcnt)
      return finish(0);
    }
    const int m = br.code_z(fax_table(2));
    if (m == kPass) {
      if (!check_b1() || pb + 1 >= fr.nruns) return -1;
      b1 += ref[pb++];
      run_length += b1 - a0;
      a0 = b1;
      b1 += ref[pb++];
    } else if (m == kHoriz) {
      const int first = int(pa & 1);  // black first after an odd number of runs
      for (int half = 0; half < 2; ++half) {
        const int col = first ^ half;
        for (;;) {
          if (!br.need(col ? 13 : 12)) return finish(1);
          if (br.peekz(11) == 0) {  // an EOL where a run should be
            br.pos += 11;
            return finish(2);
          }
          const int v = br.code_z(fax_table(col));
          if (v == kNoCode || v < 0) return finish(2);
          if (v < 64) {
            setvalue(v);
            break;
          }
          a0 += v;
          run_length += v;
        }
      }
      if (!check_b1()) return -1;
    } else if (m >= 0 && m <= 3) {  // V0, VR1-VR3
      if (!check_b1()) return -1;
      setvalue(b1 - a0 + m);
      if (pb >= fr.nruns) return -1;
      b1 += ref[pb++];
    } else if (m >= -3 && m < 0) {  // VL1-VL3
      if (!check_b1()) return -1;
      if (b1 < a0 - m) return finish(2);
      setvalue(b1 - a0 + m);
      b1 -= ref[--pb];
    } else {
      return finish(2);
    }
  }
  if (run_length) {
    if (run_length + a0 < lastx) {  // expect a final V0
      if (!br.need(1)) return finish(1);
      if (!br.peekz(1)) return finish(2);  // libtiff leaves the bit unread
      ++br.pos;
    }
    setvalue(0);
  }
  return finish(0);
}

// One one-dimensional T.4 row as libtiff's EXPAND1D decodes it, in run
// lengths: make-up codes add to a pending run, a run that passes the row's
// end is taken back by CLEANUP_RUNS (the rest of the row white), an EOL
// code ends the row (eol set), a bad code ends it as CLEANUP_RUNS does
// (libtiff's "unexpected"). Returns as expand2d.
int expand1d(FaxBits& br, int w, FaxRuns& fr, bool& eol) {
  const int64_t lastx = w;
  uint32_t* const runs = fr.cur;
  size_t pa = 0;
  int64_t a0 = 0, run_length = 0;
  auto finish = [&](int rc) -> int {  // CLEANUP_RUNS
    if (pa + 3 > fr.nruns) return -1;
    if (run_length) {
      runs[pa++] = uint32_t(run_length);
      run_length = 0;
    }
    if (a0 != lastx) {
      while (a0 > lastx && pa > 0) a0 -= runs[--pa];
      if (a0 < lastx) {
        if (a0 < 0) a0 = 0;
        if (pa & 1) runs[pa++] = 0;
        runs[pa++] = uint32_t(lastx - a0);
      } else if (a0 > lastx) {
        runs[pa++] = uint32_t(lastx);
        runs[pa++] = 0;
      }
    }
    fr.ncur = pa;
    return rc;
  };
  for (;;) {
    for (int col = 0; col < 2; ++col) {
      for (;;) {
        if (!br.need(col ? 13 : 12)) return finish(1);
        if (br.peekz(11) == 0) {  // S_EOL
          br.pos += 11;
          eol = true;
          return finish(0);
        }
        const int v = br.code_z(fax_table(col));
        if (v == kNoCode || v < 0) return finish(2);
        if (pa + 4 >= fr.nruns) return -1;
        if (v < 64) {
          runs[pa++] = uint32_t(run_length + v);
          a0 += v;
          run_length = 0;
          break;
        }
        a0 += v;
        run_length += v;
      }
      if (a0 >= lastx) return finish(0);
    }
    if (runs[pa - 1] == 0 && runs[pa - 2] == 0) pa -= 2;
  }
}

// libtiff's _TIFFFax3fillruns: white and black runs from the left, each
// cut at the row's end. As libtiff's, it writes into the run array: a zero
// run after an odd count, and each run it cuts (the later rows may read
// them as stale reference runs).
void fax_fill_runs(uint32_t* runs, size_t n, int w, uint8_t* row) {
  std::memset(row, 0, size_t((w + 7) / 8));
  if (n & 1) runs[n++] = 0;
  uint32_t x = 0;
  const uint32_t lastx = uint32_t(w);
  for (size_t k = 0; k < n; ++k) {
    if (x + runs[k] > lastx || runs[k] > lastx) runs[k] = lastx - x;
    if (k & 1)
      for (uint32_t i = x; i < x + runs[k]; ++i) row[i >> 3] |= uint8_t(0x80 >> (i & 7));
    x += runs[k];
  }
}

}  // namespace

extern "C" {

// TIFF LZW: decode src into exactly cap bytes of dst. -1: the codes end
// (EOI or data) before cap bytes, -2: a corrupt table.
int vkgr_tiff_lzw(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
  const bool compat = n >= 2 && src[0] == 0 && (src[1] & 1);
  std::vector<TiffEntry> tab(kTiffTable);
  for (int i = 0; i < 256; ++i) tab[i] = {-1, 1, uint8_t(i), uint8_t(i)};
  for (int i = 256; i < kTiffTable; ++i) tab[i] = {-1, 0, 0, 0};
  int nbits = 9, free_ent = kCodeFirst;
  // early change: the width grows once the next free entry passes 2^nbits - 2
  // (libtiff's dec_maxcodep); the old-style form grows once it passes 2^nbits - 1
  auto max_code = [&](int bits) { return (1 << bits) - (compat ? 1 : 2); };
  int maxcode = max_code(9);
  int old = -2;  // -2: no clear code yet (libtiff refuses a strip that does not start with one)
  uint64_t bitbuf = 0;
  int bitcount = 0;
  int64_t pos = 0, out = 0;
  while (out < cap) {
    while (bitcount < nbits) {
      if (pos >= n) return -1;  // the data end before the strip is full
      if (compat)
        bitbuf |= uint64_t(src[pos++]) << bitcount;
      else
        bitbuf = (bitbuf << 8) | src[pos++];
      bitcount += 8;
    }
    int code;
    if (compat) {
      code = int(bitbuf & ((1u << nbits) - 1));
      bitbuf >>= nbits;
    } else {
      code = int((bitbuf >> (bitcount - nbits)) & ((1u << nbits) - 1));
    }
    bitcount -= nbits;
    if (code == kCodeEoi) return -1;
    if (code == kCodeClear) {
      free_ent = kCodeFirst;
      nbits = 9;
      maxcode = max_code(9);
      old = -1;
      continue;
    }
    if (old == -2) return -2;
    if (old < 0) {  // the first code after a clear
      if (code > kCodeClear) return -2;
      dst[out++] = uint8_t(code);
      old = code;
      continue;
    }
    if (free_ent >= kTiffTable) return -2;
    if (code > free_ent) return -2;
    TiffEntry& e = tab[free_ent];
    e.next = old;
    e.firstchar = tab[old].firstchar;
    e.length = tab[old].length + 1;
    e.value = code < free_ent ? tab[code].firstchar : e.firstchar;
    if (++free_ent > maxcode) {
      if (++nbits > 12) nbits = 12;
      maxcode = max_code(nbits);
    }
    old = code;
    int len = tab[code].length;
    if (len <= 0) return -2;
    int64_t take = len < cap - out ? len : cap - out;
    // the string is written back to front; only its first `take` bytes land
    int c = code;
    for (int k = len - 1; k >= 0; --k) {
      if (k < take) dst[out + k] = tab[c].value;
      c = tab[c].next;
    }
    out += take;
  }
  return 0;
}

// PackBits: decode src into exactly cap bytes (a run past the end is cut
// short, as libtiff discards it). -1: the data end first; what was decoded
// stays in dst, a literal the data cut short not copied (libtiff's
// PackBitsDecode stops before it).
int vkgr_packbits(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
  int64_t pos = 0, out = 0;
  while (out < cap) {
    if (pos >= n) return -1;
    int b = int8_t(src[pos++]);
    if (b >= 0) {
      int64_t cnt = b + 1;
      int64_t t = cnt < cap - out ? cnt : cap - out;
      if (pos + t > n) return -1;
      std::memcpy(dst + out, src + pos, t);
      out += t;
      pos += cnt;
    } else if (b != -128) {
      if (pos >= n) return -1;
      int64_t cnt = 1 - b;
      int64_t t = cnt < cap - out ? cnt : cap - out;
      std::memset(dst + out, src[pos++], t);
      out += t;
    }
  }
  return 0;
}

// GIF LZW, as Pillow's GifDecode.c decodes frame data. src is the file from
// the first sub-block's size byte on; the frame is w x h indices written
// into idx (row stride w) in row order or in GIF's interlace order. Decoding
// stops when the last row is full (rc 0); the end code does not stop it.
// -1: a code that is not in the table (Pillow's "broken data stream"); -2:
// the sub-blocks run past the end of the data before the frame is full
// (Pillow's "truncated").
int vkgr_gif_lzw_decode(const uint8_t* src, int64_t n, int32_t bits, uint8_t* idx, int32_t w, int32_t h,
                        int32_t interlace) {
  if (bits < 0 || bits > 12) return -1;
  if (w <= 0 || h <= 0) return 0;
  const int clear = 1 << bits, end = clear + 1;
  std::vector<uint8_t> data(4096), buffer(4097);  // one more for the string's first byte
  std::vector<int32_t> link(4096);
  int next = 0, codesize = 0, codemask = 0, lastcode = 0, state = 1;
  uint8_t lastdata = 0;
  uint32_t bitbuffer = 0;
  int bitcount = 0, blocksize = 0;
  int64_t pos = 0;
  int x = 0, y = 0, step = interlace ? 8 : 1, pass = interlace ? 1 : 0;
  for (;;) {
    if (state == 1) {
      next = clear + 2;
      codesize = bits + 1;
      codemask = (1 << codesize) - 1;
      state = 2;
    }
    while (bitcount < codesize) {
      if (blocksize > 0) {
        bitbuffer |= uint32_t(src[pos++]) << bitcount;
        --blocksize;
        bitcount += 8;
      } else {
        if (pos >= n) return -2;
        int c = src[pos];
        if (n - pos < c + 1) return -2;
        blocksize = c;
        ++pos;
      }
    }
    int c = int(bitbuffer & uint32_t(codemask));
    bitbuffer >>= codesize;
    bitcount -= codesize;
    if (c == clear) {
      if (state != 2) state = 1;
      continue;
    }
    // Pillow's decoder returns at the end code as if it needed more data, and its
    // loader feeds it the bytes that follow: the end code is passed over, and only
    // a full frame ends decoding
    if (c == end) continue;
    int len = 1;
    const uint8_t* p = &lastdata;
    if (state == 2) {
      if (c > clear) return -1;
      lastdata = uint8_t(c);
      lastcode = c;
      state = 3;
    } else {
      int thiscode = c, bi = 4097;
      if (c > next) return -1;
      if (c == next) {
        buffer[--bi] = lastdata;
        c = lastcode;
      }
      while (c >= clear) {
        if (bi <= 1 || c >= 4096) return -1;
        buffer[--bi] = data[c];
        c = link[c];
      }
      lastdata = uint8_t(c);
      if (next < 4096) {
        data[next] = uint8_t(c);
        link[next] = lastcode;
        if (next == codemask && codesize < 12) {
          ++codesize;
          codemask = (1 << codesize) - 1;
        }
        ++next;
      }
      lastcode = thiscode;
      // the string is lastdata then buffer[bi:]
      buffer[--bi] = lastdata;
      p = &buffer[bi];
      len = 4097 - bi;
    }
    for (int k = 0; k < len; ++k) {
      idx[int64_t(y) * w + x] = p[k];
      if (++x >= w) {
        x = 0;
        y += step;
        while (y >= h) {
          if (pass == 1) {
            y = 4;
            pass = 2;
          } else if (pass == 2) {
            step = 4;
            y = 2;
            pass = 3;
          } else if (pass == 3) {
            step = 2;
            y = 1;
            pass = 0;
          } else {
            return 0;  // the last row is full
          }
        }
      }
    }
  }
}

// GIF LZW encoder: npix indices (each < 2^bits) with minimum code size
// bits (2..8) -> sub-blocks (size byte, up to 255 bytes) and the 0
// terminator, into out (cap bytes); *out_len gets the length. The table
// starts over with a clear code when it holds 4096 entries. -1: out is too
// small.
int vkgr_gif_lzw_encode(const uint8_t* idx, int64_t npix, int32_t bits, uint8_t* out, int64_t cap,
                        int64_t* out_len) {
  if (bits < 2 || bits > 8) return -1;
  const int clear = 1 << bits, end = clear + 1;
  // the dictionary: (prefix code, byte) -> code, in a table of 4096 x 256 entries
  std::vector<int16_t> dict(size_t(4096) * 256, -1);
  std::vector<uint8_t> bytes;
  bytes.reserve(size_t(npix) + 64);
  uint32_t acc = 0;
  int nacc = 0, codesize = bits + 1, next = clear + 2;
  auto emit = [&](int code) {
    acc |= uint32_t(code) << nacc;
    nacc += codesize;
    while (nacc >= 8) {
      bytes.push_back(uint8_t(acc & 255));
      acc >>= 8;
      nacc -= 8;
    }
  };
  auto reset = [&]() {
    std::fill(dict.begin(), dict.end(), int16_t(-1));
    codesize = bits + 1;
    next = clear + 2;
  };
  emit(clear);
  if (npix > 0) {
    int prefix = idx[0];
    for (int64_t i = 1; i < npix; ++i) {
      const uint8_t k = idx[i];
      int16_t& slot = dict[size_t(prefix) * 256 + k];
      if (slot >= 0) {
        prefix = slot;
        continue;
      }
      emit(prefix);
      if (next < 4096) {
        slot = int16_t(next);
        // the decoder widens its codes once it has assigned code 2^size - 1
        if (next == (1 << codesize) && codesize < 12) ++codesize;
        ++next;
      } else {
        emit(clear);
        reset();
      }
      prefix = k;
    }
    emit(prefix);
    if (next < 4096 && next == (1 << codesize) && codesize < 12) ++codesize;
  }
  emit(end);
  if (nacc > 0) bytes.push_back(uint8_t(acc & 255));
  const int64_t nb = int64_t(bytes.size());
  const int64_t need = nb + (nb + 254) / 255 + 1;
  if (need > cap) return -1;
  int64_t o = 0;
  for (int64_t i = 0; i < nb; i += 255) {
    const int64_t len = nb - i < 255 ? nb - i : 255;
    out[o++] = uint8_t(len);
    std::memcpy(out + o, bytes.data() + i, size_t(len));
    o += len;
  }
  out[o++] = 0;
  *out_len = o;
  return 0;
}

// BMP RLE8/RLE4 as Pillow's BmpRleDecoder reads it: file[pos:] holds the
// records; dst gets the first w*h decoded indices in file row order, and
// *produced the count the records gave (Pillow raises when it is short of
// w*h). The alignment after an absolute run is to an even position in the
// file, and a delta record reads four bytes, the last two of which are the
// right and up steps (both as Pillow does). -1: a delta record cut short.
int vkgr_bmp_rle(const uint8_t* file, int64_t n, int64_t pos, int32_t rle4, int32_t w, int32_t h,
                 uint8_t* dst, int64_t* produced) {
  const int64_t total = int64_t(w) * h;
  int64_t len = 0, x = 0;
  auto put = [&](uint8_t v) {
    if (len < total) dst[len] = v;
    ++len;
  };
  while (len < total) {
    if (pos + 2 > n) break;
    int num = file[pos], byte = file[pos + 1];
    pos += 2;
    if (num) {
      if (x + num > w) num = int(w - x > 0 ? w - x : 0);
      if (rle4) {
        for (int i = 0; i < num; ++i) put(uint8_t(i % 2 == 0 ? byte >> 4 : byte & 15));
      } else {
        for (int i = 0; i < num; ++i) put(uint8_t(byte));
      }
      x += num;
    } else if (byte == 0) {
      while (len % w != 0) put(0);
      x = 0;
    } else if (byte == 1) {
      break;
    } else if (byte == 2) {
      if (pos + 2 > n) break;
      pos += 2;
      if (pos + 2 > n) return -1;  // Pillow unpacks a short read: an error
      int right = file[pos], up = file[pos + 1];
      pos += 2;
      const int64_t skip = right + int64_t(up) * w;
      for (int64_t i = 0; i < skip && len < total; ++i) put(0);
      x = len % w;
    } else {
      const int64_t count = rle4 ? byte / 2 : byte;
      const int64_t avail = n - pos < count ? n - pos : count;
      if (rle4) {
        for (int64_t i = 0; i < avail; ++i) {
          put(uint8_t(file[pos + i] >> 4));
          put(uint8_t(file[pos + i] & 15));
        }
      } else {
        for (int64_t i = 0; i < avail; ++i) put(file[pos + i]);
      }
      pos += avail;
      if (avail < count) break;
      x += byte;
      if (pos % 2 != 0) ++pos;
    }
  }
  *produced = len < total ? len : total;
  return 0;
}

// TGA RLE as Pillow's TgaRleDecode.c: packets of depth-byte pixels (depth
// 1..4) into rows of row_bytes; a literal packet that runs past the end of
// a row continues on the next. A run packet past the end of a row is an
// overrun (-1). dst gets rows * row_bytes bytes in file order; -2: the data
// end first.
int vkgr_tga_rle(const uint8_t* src, int64_t n, int32_t depth, int64_t row_bytes, int32_t rows,
                 uint8_t* dst) {
  int64_t pos = 0, x = 0;
  int32_t y = 0;
  while (y < rows) {
    if (pos >= n) return -2;
    const int hdr = src[pos];
    int64_t cnt = int64_t(depth) * ((hdr & 0x7f) + 1);
    uint8_t* row = dst + int64_t(y) * row_bytes;
    if (hdr & 0x80) {
      if (n - pos < 1 + depth) return -2;
      if (x + cnt > row_bytes) return -1;
      for (int64_t i = 0; i < cnt; i += depth) std::memcpy(row + x + i, src + pos + 1, size_t(depth));
      pos += 1 + depth;
      x += cnt;
      if (x >= row_bytes) {
        x = 0;
        ++y;
      }
    } else {
      if (n - pos < 1 + cnt) return -2;
      const uint8_t* p = src + pos + 1;
      pos += 1 + cnt;
      while (cnt > 0 && y < rows) {
        const int64_t t = cnt < row_bytes - x ? cnt : row_bytes - x;
        std::memcpy(dst + int64_t(y) * row_bytes + x, p, size_t(t));
        p += t;
        cnt -= t;
        x += t;
        if (x >= row_bytes) {
          x = 0;
          ++y;
        }
      }
    }
  }
  return 0;
}

// PackBits as Pillow's PackbitsDecode.c reads a PSD channel: rows of
// row_bytes bytes decoded one after another from one stream; a run or
// literal that passes the end of a row is cut there (the rest dropped),
// 0x80 is a no-op. dst gets rows * row_bytes bytes. -1: the data end
// before the last row is full (Pillow's "image file is truncated").
int vkgr_packbits_rows(const uint8_t* src, int64_t n, int64_t row_bytes, int32_t rows, uint8_t* dst) {
  int64_t pos = 0, x = 0;
  int32_t y = 0;
  while (y < rows) {
    if (pos >= n) return -1;
    const int hdr = src[pos];
    uint8_t* row = dst + int64_t(y) * row_bytes;
    if (hdr & 0x80) {
      if (hdr == 0x80) {
        ++pos;
        continue;
      }
      if (n - pos < 2) return -1;
      for (int k = 257 - hdr; k > 0 && x < row_bytes; --k) row[x++] = src[pos + 1];
      pos += 2;
    } else {
      const int64_t len = hdr + 1;
      if (n - pos < len + 1) return -1;
      for (int64_t i = 0; i < len && x < row_bytes; ++i) row[x++] = src[pos + 1 + i];
      pos += len + 1;
    }
    if (x >= row_bytes) {
      x = 0;
      ++y;
    }
  }
  return 0;
}

// SGI RLE as Pillow's SgiRleDecode.c: body is the file from byte 512 on
// (the start and length tables first, big-endian, ysize * zsize entries
// each, channel-major); rows are decoded bottom row first, each channel
// into a row buffer kept from row to row (samples a short row leaves are
// the previous row's), 8-bit samples (bpc 1) or the big-endian 16-bit
// words (bpc 2) whose high byte Pillow keeps. A packet reads its count
// from the sample's low byte: 0 ends the row, 0x80 set copies, else a run;
// the packets counted down from the row's length in bytes, the last one
// with a count ends the image early (the rows after it stay 0), as
// Pillow's expandrow does. dst gets ysize * xsize * zsize bytes (the high
// bytes), rows in file order, channels interleaved. -1: an offset or
// packet outside the data, or a row past xsize (Pillow's overrun).
int vkgr_sgi_rle(const uint8_t* body, int64_t n, int32_t xsize, int32_t ysize, int32_t zsize, int32_t bpc,
                 uint8_t* dst) {
  const int64_t tablen = int64_t(ysize) * zsize;
  if (n < 8 * tablen) return -1;
  auto u32 = [&](int64_t off) {
    return (uint32_t(body[off]) << 24) | (uint32_t(body[off + 1]) << 16) | (uint32_t(body[off + 2]) << 8) |
           uint32_t(body[off + 3]);
  };
  const uint8_t* end = body + n - 1;  // the last byte, as Pillow's end_of_buffer
  std::vector<uint8_t> buf(size_t(xsize) * zsize * 2, 0);
  for (int32_t row = 0; row < ysize; ++row) {
    for (int32_t ch = 0; ch < zsize; ++ch) {
      const int64_t t = row + int64_t(ch) * ysize;
      uint32_t off = u32(4 * t), len = u32(4 * (tablen + t));
      if (off < 512) return -1;
      off -= 512;
      const uint8_t* p = body + off;
      uint8_t* d = buf.data() + ch * bpc;
      int x = 0;
      int status = 0;
      for (int64_t k = len; k > 0; --k) {
        if (p + (bpc - 1) > end) return -1;
        const uint8_t pixel = p[bpc - 1];
        p += bpc;
        if (k == 1 && pixel != 0) {
          status = 1;
          break;
        }
        int count = pixel & 0x7f;
        if (!count) break;
        if (x + count > xsize) return -1;
        x += count;
        if (pixel & 0x80) {
          if (p + int64_t(bpc) * count > end) return -1;
          while (count--) {
            std::memcpy(d, p, size_t(bpc));
            p += bpc;
            d += int64_t(zsize) * bpc;
          }
        } else {
          if (bpc == 1 ? p > end : p + 2 > end) return -1;
          while (count--) {
            std::memcpy(d, p, size_t(bpc));
            d += int64_t(zsize) * bpc;
          }
          p += bpc;
        }
      }
      if (status == 1) return 0;  // Pillow stops here without an error
    }
    uint8_t* out = dst + int64_t(row) * xsize * zsize;
    for (int64_t i = 0; i < int64_t(xsize) * zsize; ++i) out[i] = buf[i * bpc];
  }
  return 0;
}

// PCX RLE as Pillow's PcxDecode.c: a byte with its top two bits set is a
// run of (byte & 0x3f) copies of the next byte, any other byte a literal;
// rows of row_bytes bytes. -1: a run past the end of a row (Pillow's
// overrun), -2: the data end before the last row is full.
int vkgr_pcx_rle(const uint8_t* src, int64_t n, int64_t row_bytes, int32_t rows, uint8_t* dst) {
  int64_t pos = 0, x = 0;
  int32_t y = 0;
  while (y < rows) {
    if (pos >= n) return -2;
    uint8_t* row = dst + int64_t(y) * row_bytes;
    if ((src[pos] & 0xC0) == 0xC0) {
      if (n - pos < 2) return -2;
      const int cnt = src[pos] & 0x3F;
      if (x + cnt > row_bytes) return -1;
      std::memset(row + x, src[pos + 1], size_t(cnt));
      x += cnt;
      pos += 2;
    } else {
      row[x++] = src[pos++];
    }
    if (x >= row_bytes) {
      x = 0;
      ++y;
    }
  }
  return 0;
}

// Sun raster byte-encoded RLE as Pillow's SunRleDecode.c: 0x80 0 is a
// literal 0x80, 0x80 n v (n > 0) n + 1 copies of v, any other byte a
// literal; one stream whose runs pass from row to row, into cap bytes (a
// run past the end is cut). -1: the data end first.
int vkgr_sun_rle(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
  int64_t pos = 0, out = 0;
  while (out < cap) {
    if (pos >= n) return -1;
    if (src[pos] == 0x80) {
      if (n - pos < 2) return -1;
      if (src[pos + 1] == 0) {
        dst[out++] = 0x80;
        pos += 2;
        continue;
      }
      if (n - pos < 3) return -1;
      int64_t cnt = int64_t(src[pos + 1]) + 1;
      if (cnt > cap - out) cnt = cap - out;
      std::memset(dst + out, src[pos + 2], size_t(cnt));
      out += cnt;
      pos += 3;
    } else {
      dst[out++] = src[pos++];
    }
  }
  return 0;
}

// QOI as Pillow's QoiDecoder: src is the stream after the 14-byte header;
// dst gets npix pixels of `bands` (3 or 4) bytes. A run writes the
// previous pixel; an index names one of 64 pixels hashed by
// (3r + 5g + 7b + 11a) % 64, (0, 0, 0, 0) before it is set; the first
// previous pixel is (0, 0, 0, 255). -1: the stream ends before the image
// is full (Pillow raises then).
int vkgr_qoi_decode(const uint8_t* src, int64_t n, int64_t npix, int32_t bands, uint8_t* dst) {
  uint8_t index[64][4];
  std::memset(index, 0, sizeof(index));
  uint8_t prev[4] = {0, 0, 0, 255};
  int64_t pos = 0, px = 0;
  auto put = [&](const uint8_t* v) {
    std::memcpy(dst + px * bands, v, size_t(bands));
    ++px;
  };
  while (px < npix) {
    if (pos >= n) return -1;
    const uint8_t b = src[pos++];
    uint8_t v[4];
    if (b == 0xFE) {
      if (n - pos < 3) return -1;
      v[0] = src[pos], v[1] = src[pos + 1], v[2] = src[pos + 2], v[3] = prev[3];
      pos += 3;
    } else if (b == 0xFF) {
      if (n - pos < 4) return -1;
      std::memcpy(v, src + pos, 4);
      pos += 4;
    } else {
      const int op = b >> 6;
      if (op == 0) {
        std::memcpy(v, index[b & 63], 4);
      } else if (op == 1) {
        v[0] = uint8_t(prev[0] + ((b >> 4) & 3) - 2);
        v[1] = uint8_t(prev[1] + ((b >> 2) & 3) - 2);
        v[2] = uint8_t(prev[2] + (b & 3) - 2);
        v[3] = prev[3];
      } else if (op == 2) {
        if (pos >= n) return -1;
        const uint8_t b2 = src[pos++];
        const int dg = (b & 63) - 32, dr = ((b2 >> 4) & 15) - 8, db = (b2 & 15) - 8;
        v[0] = uint8_t(prev[0] + dg + dr);
        v[1] = uint8_t(prev[1] + dg);
        v[2] = uint8_t(prev[2] + dg + db);
        v[3] = prev[3];
      } else {
        for (int k = (b & 63) + 1; k > 0 && px < npix; --k) put(prev);
        continue;
      }
    }
    std::memcpy(prev, v, 4);
    std::memcpy(index[(v[0] * 3 + v[1] * 5 + v[2] * 7 + v[3] * 11) % 64], v, 4);
    put(v);
  }
  return 0;
}

// CCITT fax data of one strip or tile as libtiff's tif_fax3.c decodes it:
// compression 2 (modified Huffman rows, each from a byte boundary), 3 (T.4:
// an EOL before each row, found as libtiff's SYNC_EOL finds it; with
// T4Options bit 0 a tag bit after it picks a 1-D or 2-D row) or 4 (T.6:
// 2-D rows against the row before, the first against a white row). dst gets
// h rows of (w + 7) / 8 bytes, black runs as 1 bits, as libtiff hands them
// to Pillow. T.4 and T.6 rows decode in libtiff's run arrays (expand1d,
// expand2d): where the data end, the bits left are read padded with zeros;
// a bad code completes its row as CLEANUP_RUNS does and the decoding goes
// on (libtiff's "unexpected"). Returns 0, or -1: a code past the run
// arrays, a bad code or the end of the data in modified Huffman data, or
// the data end in the strip's first row; or k >= 1: the data end (or, in
// T.6 data, an EOL is read) in row k - 1, which libtiff fills as
// CLEANUP_RUNS left it and takes for a badly terminated strip, the rows
// after it zero (libtiff does not write them).
int vkgr_ccitt(const uint8_t* src, int64_t n, int32_t w, int32_t h, int32_t compression, int32_t t4options,
               uint8_t* dst) {
  if (w <= 0 || h <= 0 || compression < 2 || compression > 4) return -1;
  FaxBits br{src, n};
  const int64_t rowbytes = (w + 7) / 8;
  std::memset(dst, 0, size_t(rowbytes) * h);
  if (compression == 2) {  // Fax3DecodeRLE fails a strip with a bad code or cut short
    std::vector<int> cur;
    for (int y = 0; y < h; ++y) {
      if (!fax_row_1d(br, w, cur)) return -1;
      br.pos = (br.pos + 7) & ~int64_t(7);
      fax_fill(cur, w, dst + y * rowbytes);
    }
    return 0;
  }
  FaxRuns fr(w, compression == 4 || (t4options & 1));
  bool eolcnt = false;  // T.4: an EOL read at the end of the row before
  for (int y = 0; y < h; ++y) {
    int rc = 1;
    if (compression == 4) {
      rc = expand2d(br, w, fr, false, eolcnt);
    } else if (br.sync_eol(eolcnt) && (!(t4options & 1) || br.need(1))) {
      // Fax3Decode1D / Fax3Decode2D: SYNC_EOL (no search after an EOL read in the row before), the tag bit
      eolcnt = false;
      const bool two_d = (t4options & 1) && !br.bitz();
      rc = two_d ? expand2d(br, w, fr, true, eolcnt) : expand1d(br, w, fr, eolcnt);
    } else {
      fr.ncur = 0;
      fr.cur[fr.ncur++] = uint32_t(w);  // the data end before the row: CLEANUP_RUNS of no run, white
    }
    if (rc < 0) return -1;
    fax_fill_runs(fr.cur, fr.ncur, w, dst + y * rowbytes);
    if (rc == 1) return y == 0 ? -1 : y + 1;
    fr.cur[fr.ncur] = 0;  // the imaginary change of the reference (SETVALUE(0))
    std::swap(fr.cur, fr.ref);
  }
  return 0;
}

// ThunderScan 4-bit data as libtiff's tif_thunder.c decodes a row: each byte
// is a run of the last pixel (low 6 bits a count), three 2-bit deltas, two
// 3-bit deltas (a skip code leaves a slot out) or a raw pixel; pixels pack
// two a byte, the high nibble first. A delta or raw pixel past the row's
// end is dropped; a run is written only when it ends before the row's end
// (its first pixel is, at an odd position), and one that passes the end
// fails the row, as in libtiff. dst gets rows * ((w + 1) / 2) bytes. -1:
// the data end before the last row is full, or a run passes a row's end.
int vkgr_thunderscan(const uint8_t* src, int64_t n, int32_t w, int32_t rows, uint8_t* dst) {
  static const int two[4] = {0, 1, 0, -1};
  static const int three[8] = {0, 1, 2, 3, 0, -3, -2, -1};
  const int64_t rowbytes = (int64_t(w) + 1) / 2;
  int64_t pos = 0;
  for (int32_t y = 0; y < rows; ++y) {
    uint8_t* op = dst + y * rowbytes;
    std::memset(op, 0, size_t(rowbytes));
    int last = 0;
    int64_t np = 0;
    auto put = [&](int v) {  // libtiff's SETPIXEL
      last = v & 15;
      if (np < w) {
        op[np >> 1] |= uint8_t((np & 1) ? last : last << 4);
        ++np;
      }
    };
    while (np < w) {
      if (pos >= n) return -1;
      const int b = src[pos++];
      switch (b & 0xC0) {
        case 0x00: {  // a run of the last pixel
          int k = b & 0x3F;
          if (np & 1) {
            op[np >> 1] |= uint8_t(last);
            ++np;
            --k;
          }
          if (np + k < w)
            for (int i = 0; i < k; ++i, ++np) op[np >> 1] |= uint8_t((np & 1) ? last : last << 4);
          else
            np += k;
          break;
        }
        case 0x40:  // three 2-bit deltas, 2 skips
          for (int sh = 4; sh >= 0; sh -= 2) {
            const int d = (b >> sh) & 3;
            if (d != 2) put(last + two[d]);
          }
          break;
        case 0x80:  // two 3-bit deltas, 4 skips
          for (int sh = 3; sh >= 0; sh -= 3) {
            const int d = (b >> sh) & 7;
            if (d != 4) put(last + three[d]);
          }
          break;
        default:  // a raw pixel
          put(b & 15);
          break;
      }
    }
    if (np != w) return -1;
  }
  return 0;
}

// PNG scanline filters undone: `rows` rows of a filter byte and `stride`
// bytes from src, into out (rows x stride); bpp is the byte distance to the
// left neighbour (max(1, bits per pixel / 8)). The row above the first is
// zeros. -1: src too short, -2: an unknown filter type (Pillow's decoder
// fails the image then).
int vkgr_png_unfilter(const uint8_t* src, int64_t n_src, int64_t rows, int64_t stride, int32_t bpp, uint8_t* out) {
  if (rows < 0 || stride < 0 || bpp < 1 || n_src < rows * (stride + 1)) return -1;
  std::vector<uint8_t> zero(size_t(stride), 0);
  const uint8_t* prev = zero.data();
  for (int64_t y = 0; y < rows; ++y) {
    const uint8_t* in = src + y * (stride + 1);
    const uint8_t ft = *in++;
    uint8_t* cur = out + y * stride;
    const int64_t lead = std::min<int64_t>(bpp, stride);
    switch (ft) {
      case 0:
        std::memcpy(cur, in, size_t(stride));
        break;
      case 1:  // Sub
        std::memcpy(cur, in, size_t(lead));
        for (int64_t i = bpp; i < stride; ++i) cur[i] = uint8_t(in[i] + cur[i - bpp]);
        break;
      case 2:  // Up
        for (int64_t i = 0; i < stride; ++i) cur[i] = uint8_t(in[i] + prev[i]);
        break;
      case 3:  // Average
        for (int64_t i = 0; i < lead; ++i) cur[i] = uint8_t(in[i] + (prev[i] >> 1));
        for (int64_t i = bpp; i < stride; ++i) cur[i] = uint8_t(in[i] + ((cur[i - bpp] + prev[i]) >> 1));
        break;
      case 4:  // Paeth
        for (int64_t i = 0; i < lead; ++i) cur[i] = uint8_t(in[i] + prev[i]);
        for (int64_t i = bpp; i < stride; ++i) {
          const int a = cur[i - bpp], b = prev[i], c = prev[i - bpp];
          const int pa = std::abs(b - c), pb = std::abs(a - c), pc = std::abs(a + b - 2 * c);
          cur[i] = uint8_t(in[i] + ((pa <= pb && pa <= pc) ? a : (pb <= pc) ? b : c));
        }
        break;
      default:
        return -2;
    }
    prev = cur;
  }
  return 0;
}

// Pillow's LAB -> RGB as LittleCMS runs its optimised transform: each byte
// to 16 bits (x * 257), TetrahedralInterp16 in an n^3 table of 16-bit RGB
// ([L][a][b][3], from ops/imagemodes.lab_table), then FROM_16_TO_8.
int vkgr_lab_to_rgb(const uint16_t* table, int32_t n, const uint8_t* src, int64_t count, uint8_t* dst) {
  if (n < 2) return -1;
  const int32_t oz = 3, oy = 3 * n, ox = 3 * n * n, dom = n - 1;
  for (int64_t i = 0; i < count; ++i) {
    int32_t x0[3], r[3], d1[3];
    const int32_t off[3] = {ox, oy, oz};
    for (int c = 0; c < 3; ++c) {
      const int32_t in = src[3 * i + c] * 257;
      const int32_t fx = in * dom;
      const int32_t f = fx + (fx + 0x7FFF) / 0xFFFF;  // _cmsToFixedDomain
      x0[c] = (f >> 16) * off[c];
      r[c] = f & 0xFFFF;
      d1[c] = in == 0xFFFF ? 0 : off[c];
    }
    const uint16_t* t = table + x0[0] + x0[1] + x0[2];
    const int32_t rx = r[0], ry = r[1], rz = r[2];
    int32_t X1 = d1[0], Y1 = d1[1], Z1 = d1[2];
    for (int o = 0; o < 3; ++o) {
      int32_t c0 = t[o], c1, c2, c3;
      if (rx >= ry) {
        if (ry >= rz) {
          c1 = t[X1 + o] - c0;
          c2 = t[X1 + Y1 + o] - t[X1 + o];
          c3 = t[X1 + Y1 + Z1 + o] - t[X1 + Y1 + o];
        } else if (rz >= rx) {
          c1 = t[X1 + Z1 + o] - t[Z1 + o];
          c2 = t[X1 + Y1 + Z1 + o] - t[X1 + Z1 + o];
          c3 = t[Z1 + o] - c0;
        } else {
          c1 = t[X1 + o] - c0;
          c2 = t[X1 + Y1 + Z1 + o] - t[X1 + Z1 + o];
          c3 = t[X1 + Z1 + o] - t[X1 + o];
        }
      } else if (rx >= rz) {
        c1 = t[X1 + Y1 + o] - t[Y1 + o];
        c2 = t[Y1 + o] - c0;
        c3 = t[X1 + Y1 + Z1 + o] - t[X1 + Y1 + o];
      } else if (ry >= rz) {
        c1 = t[X1 + Y1 + Z1 + o] - t[Y1 + Z1 + o];
        c2 = t[Y1 + o] - c0;
        c3 = t[Y1 + Z1 + o] - t[Y1 + o];
      } else {
        c1 = t[X1 + Y1 + Z1 + o] - t[Y1 + Z1 + o];
        c2 = t[Y1 + Z1 + o] - t[Z1 + o];
        c3 = t[Z1 + o] - c0;
      }
      const int32_t rest = c1 * rx + c2 * ry + c3 * rz + 0x8001;
      const uint32_t v16 = uint32_t(uint16_t(c0 + ((rest + (rest >> 16)) >> 16)));
      dst[3 * i + o] = uint8_t((v16 * 65281u + 8388608u) >> 24);  // FROM_16_TO_8
    }
  }
  return 0;
}

// Pillow's MspDecoder: `rows` rows of rowmap[y] bytes each, one after
// another in src; a row's runs are (0, count, value) or (n, n literal bytes,
// cut at the row's end); an empty row is `blank` bytes of 0xFF. The rows'
// bytes are one stream: written into out up to cap, counted in *out_len.
// -1: a row or a run header past the data (Pillow's "Truncated" and
// "Corrupted MSP file").
int vkgr_msp_rle(const uint8_t* src, int64_t n, const uint16_t* rowmap, int32_t rows, int32_t blank, uint8_t* out,
                 int64_t cap, int64_t* out_len) {
  int64_t pos = 0, o = 0;
  auto put = [&](uint8_t v) {
    if (o < cap) out[o] = v;
    ++o;
  };
  for (int32_t y = 0; y < rows; ++y) {
    const int64_t len = rowmap[y];
    if (len == 0) {
      for (int32_t i = 0; i < blank; ++i) put(0xFF);
      continue;
    }
    if (pos + len > n) return -1;
    const uint8_t* row = src + pos;
    int64_t i = 0;
    while (i < len) {
      const int run = row[i++];
      if (run == 0) {
        if (i + 2 > len) return -1;
        for (int k = 0; k < row[i]; ++k) put(row[i + 1]);
        i += 2;
      } else {
        const int64_t end = std::min<int64_t>(i + run, len);
        for (int64_t k = i; k < end; ++k) put(row[k]);
        i += run;
      }
    }
    pos += len;
  }
  *out_len = o;
  return 0;
}

// Pillow's BitDecode.c with IM's arguments (bits, pad 8, fill 3, unsigned,
// ystep -1): bytes fill the bit buffer from its low end and each sample is
// the buffer's low `bits` bits; at the end of a row the bit count restarts
// (the byte's unread bits stay in the buffer and are ORed into the next
// row's first bytes, as in Pillow). out gets h rows of w float32, the
// bottom row first. -1: the data end before the last row (Pillow's
// "image file is truncated").
int vkgr_bit_decode(const uint8_t* src, int64_t n, int32_t bits, int32_t w, int32_t h, float* out) {
  if (bits < 1 || bits >= 32 || w <= 0 || h <= 0) return -1;
  const uint64_t mask = (uint64_t(1) << bits) - 1;
  uint64_t buf = 0;
  int cnt = 0;
  int64_t y = h - 1, x = 0;
  for (int64_t i = 0; i < n; ++i) {
    const uint64_t byte = src[i];
    buf |= byte << cnt;
    cnt += 8;
    while (cnt >= bits) {
      const uint64_t v = buf & mask;
      if (cnt > 32)
        buf = byte >> (8 - (cnt - bits));
      else
        buf >>= bits;
      cnt -= bits;
      out[y * w + x] = float(v);
      if (++x >= w) {
        if (--y < 0) return 0;
        x = 0;
        cnt = 0;
      }
    }
  }
  return -1;
}

// One FLI/FLC frame as Pillow's FliDecode.c decodes it into a zeroed P
// image (frame 0): buf holds the frame's bytes as Pillow hands them to the
// decoder (at most the frame's size). The chunks: COLOR (4, 11) and PSTAMP
// (18) skipped, SS2 (7, word delta lines with skip and last-byte words),
// LC (12, byte delta lines from a first line), BLACK (13), BRUN (15,
// byte runs a line), COPY (16). -1: Pillow's overrun, unknown-chunk and
// broken errors; -2: not enough data for the frame (Pillow's "image file
// is truncated").
int vkgr_fli_frame(const uint8_t* buf, int64_t bytes, int32_t xsize, int32_t ysize, uint8_t* im) {
  auto i16 = [](const uint8_t* p) { return int(p[0]) | (int(p[1]) << 8); };
  auto i32 = [](const uint8_t* p) {
    return int32_t(uint32_t(p[0]) | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16) | (uint32_t(p[3]) << 24));
  };
  if (bytes < 4) return -2;
  const uint8_t* ptr = buf;
  const int64_t framesize = i32(ptr);
  if (bytes + (bytes % 2) < framesize) return -2;
  if (bytes < 8) return -1;
  if (i16(ptr + 4) != 0xF1FA) return -1;
  const int chunks = i16(ptr + 6);
  ptr += 16;
  bytes -= 16;
  for (int c = 0; c < chunks; ++c) {
    if (bytes < 10) return -1;
    const uint8_t* data = ptr + 6;
    auto oob = [&](int64_t off) { return data + off > ptr + bytes; };
    int x = 0, y = 0, i = 0;
    switch (i16(ptr + 4)) {
      case 4:
      case 11:
      case 18:
        break;
      case 7: {  // SS2
        const int lines = i16(data);
        data += 2;
        int l = 0;
        for (y = 0; l < lines && y < ysize; ++l, ++y) {
          uint8_t* row = im + int64_t(y) * xsize;
          if (oob(2)) return -1;
          int packets = i16(data);
          data += 2;
          while (packets & 0x8000) {
            if (packets & 0x4000) {
              y += 65536 - packets;
              if (y >= ysize) return -1;
              row = im + int64_t(y) * xsize;
            } else {
              row[xsize - 1] = uint8_t(packets);
            }
            if (oob(2)) return -1;
            packets = i16(data);
            data += 2;
          }
          int p = 0;
          for (x = 0; p < packets; ++p) {
            if (oob(2)) return -1;
            x += data[0];
            if (data[1] >= 128) {
              if (oob(4)) return -1;
              i = 256 - data[1];
              if (x + i + i > xsize) break;
              for (int j = 0; j < i; ++j) {
                row[x++] = data[2];
                row[x++] = data[3];
              }
              data += 4;
            } else {
              i = 2 * int(data[1]);
              if (x + i > xsize) break;
              if (oob(2 + i)) return -1;
              std::memcpy(row + x, data + 2, size_t(i));
              data += 2 + i;
              x += i;
            }
          }
          if (p < packets) break;
        }
        if (l < lines) return -1;
        break;
      }
      case 12: {  // LC
        y = i16(data);
        const int ymax = y + i16(data + 2);
        data += 4;
        for (; y < ymax && y < ysize; ++y) {
          uint8_t* row = im + int64_t(y) * xsize;
          if (oob(1)) return -1;
          const int packets = *data++;
          int p = 0;
          for (x = 0; p < packets; ++p, x += i) {
            if (oob(2)) return -1;
            x += data[0];
            if (data[1] & 0x80) {
              i = 256 - data[1];
              if (x + i > xsize) break;
              if (oob(3)) return -1;
              std::memset(row + x, data[2], size_t(i));
              data += 3;
            } else {
              i = data[1];
              if (x + i > xsize) break;
              if (oob(2 + i)) return -1;
              std::memcpy(row + x, data + 2, size_t(i));
              data += i + 2;
            }
          }
          if (p < packets) break;
        }
        if (y < ymax) return -1;
        break;
      }
      case 13:  // BLACK
        std::memset(im, 0, size_t(xsize) * ysize);
        break;
      case 15:  // BRUN
        for (y = 0; y < ysize; ++y) {
          uint8_t* row = im + int64_t(y) * xsize;
          data += 1;
          for (x = 0; x < xsize; x += i) {
            if (oob(2)) return -1;
            if (data[0] & 0x80) {
              i = 256 - data[0];
              if (x + i > xsize) break;
              if (oob(i + 1)) return -1;
              std::memcpy(row + x, data + 1, size_t(i));
              data += i + 1;
            } else {
              i = data[0];
              if (x + i > xsize) break;
              std::memset(row + x, data[1], size_t(i));
              data += 2;
            }
          }
          if (x != xsize) return -1;
        }
        break;
      case 16:  // COPY
        if (INT32_MAX / xsize < ysize) return -1;
        if (data + int64_t(xsize) * ysize > ptr + bytes) return -2;
        std::memcpy(im, data, size_t(xsize) * ysize);
        break;
      default:
        return -1;
    }
    const int32_t advance = i32(ptr);
    if (advance == 0 || advance < 0 || advance > bytes) return -1;
    ptr += advance;
    bytes -= advance;
  }
  return 0;
}

// IcnsImagePlugin.read_32's RLE: three channels of npix bytes one after
// another from src (a byte with bit 7 set is a run of byte - 125 copies of
// the next byte, any other a literal of byte + 1 bytes), into out [3][npix].
// -1: a channel's blocks pass its size, or the data end first (Pillow's
// SyntaxError, or its frombuffer's "not enough image data").
int vkgr_icns_rle(const uint8_t* src, int64_t n, int64_t npix, uint8_t* out) {
  int64_t pos = 0;
  for (int band = 0; band < 3; ++band) {
    uint8_t* d = out + band * npix;
    int64_t left = npix;
    while (left > 0) {
      if (pos >= n) return -1;
      const int b = src[pos++];
      if (b & 0x80) {
        const int64_t k = b - 125;
        if (pos >= n || k > left) return -1;
        std::memset(d + (npix - left), src[pos++], size_t(k));
        left -= k;
      } else {
        const int64_t k = b + 1;
        if (k > left || pos + k > n) return -1;
        std::memcpy(d + (npix - left), src + pos, size_t(k));
        pos += k;
        left -= k;
      }
    }
  }
  return 0;
}

}  // extern "C"
