// JPEG 2000 Part 1 (ITU-T T.800) codestream decoding, as OpenJPEG 2.5
// decodes a codestream tile by tile for Pillow (opj_read_tile_header /
// opj_decode_tile_data), for the port's JPEG 2000 reader (ops/jpeg2000.py).
//
//   * the main and tile-part headers: SIZ, COD, COC, QCD, QCC, RGN, POC,
//     PPM and PPT; any other marker segment is read past (CAP, TLM, PLM,
//     PLT, CRG, COM, Part 2's); Part 15's HT code-blocks (code-block
//     style bit 6) fail with kUnsupported;
//   * tier 2: tag trees, packet headers (bit-stuffed after 0xFF), packed
//     packet headers (PPM, PPT), SOP and EPH markers, quality layers, the
//     five progression orders and POC, precincts, tile-parts;
//   * tier 1: the MQ decoder (C.3, OpenJPEG's artificial 0xFF 0xFF after a
//     segment), the significance, refinement and cleanup passes with their
//     contexts (D.3), run-length coding, and every code-block style bit:
//     selective arithmetic coding bypass (raw passes), context reset,
//     termination on each pass, vertically causal contexts, predictable
//     termination (which the decoder need not see) and segmentation
//     symbols; ROI by maxshift;
//   * dequantisation (none, scalar derived, scalar expounded; guard bits;
//     OpenJPEG's coefficients carry one extra bit, its mid-point
//     reconstruction), the inverse 5/3 in integers and the inverse 9/7 in
//     float32 with OpenJPEG's constants, lifting order and its 2/K scaling
//     of the high-pass samples (rows, then columns, level by level);
//   * the inverse RCT and ICT, the DC level shift and the clamp to each
//     component's range (9/7 samples rounded by lrintf: half to even);
//   * OpenJPEG's refusals of damaged codestreams, as its strict reading
//     fails them (learnt from mutated files against Pillow): marker
//     segments of the wrong length, a marker where OpenJPEG does not allow
//     it, the search two bytes at a time past a marker it does not know,
//     COD and QCD required, tile-parts out of order, a segment or a
//     tile-part past the data, a missing EPH, PPM lengths that do not
//     chain, more than 30 bit-planes in a code-block; the data ending right
//     after an SOT's code end the codestream there.
//
// Float contraction is off in this file: OpenJPEG's generic x86-64 build
// multiplies and adds in separate instructions, and -march=native would
// fuse them here.
//
//   vkgr_j2k_decode(cs, n, out, cap, used)
//     cs, n   the codestream (from SOC)
//     out     int32 words: for each decoded tile, in the order its data
//             come, [x0, y0, x1, y1] of the tile on the reference grid
//             (clipped to the image), then for each component [w, h] and
//             w * h samples, row by row
//     cap     the words out holds
//     used    the words written
//   returns 0, or < 0 for a codestream OpenJPEG refuses.

#pragma GCC optimize("fp-contract=off")

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum Err {
  kOk = 0,
  kBadHeader = -1,
  kUnsupported = -2,
  kBadData = -3,
  kNoSpace = -4,
};

inline int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }
inline int64_t ceil_div_pow2(int64_t a, int b) { return (a + (int64_t(1) << b) - 1) >> b; }
inline int64_t floor_div_pow2(int64_t a, int b) { return a >> b; }
inline int floorlog2(uint32_t v) {
  int l = 0;
  while (v >>= 1) ++l;
  return l;
}

// ------------------------------------------------------------------ coding parameters

struct Tccp {
  int csty = 0;  // bit 0: precinct sizes given
  int numres = 6;
  int cblkw = 6, cblkh = 6;  // exponents
  int cblksty = 0;
  int qmfbid = 0;  // 1: 5/3, 0: 9/7
  int prcw[33], prch[33];
  int qntsty = 0;
  int numgbits = 2;
  int expn[97] = {}, mant[97] = {};
  int roishift = 0;
  Tccp() {
    for (int i = 0; i < 33; ++i) prcw[i] = prch[i] = 15;
  }
};

struct Poc {
  int resno0, compno0, layno1, resno1, compno1, prg;
};

struct Tcp {
  int csty = 0;  // bit 1: SOP, bit 2: EPH
  int prg = 0;
  int numlayers = 1;
  int mct = 0;
  std::vector<Tccp> tccps;
  std::vector<Poc> pocs;
  std::vector<std::vector<uint8_t>> ppt_parts;  // PPT contents, by Zppt
  bool has_ppt = false;
  std::vector<uint8_t> data;  // the tile-parts' bodies, in codestream order
  bool seen = false;
  bool cod_seen = false, qcd_seen = false;
  int parts = 0;  // tile-parts read
};

struct Comp {
  int dx, dy, prec, sgnd;
};

struct Image {
  int64_t x0, y0, x1, y1, tx0, ty0, tdx, tdy;
  int ncomp = 0;
  std::vector<Comp> comps;
  int tw = 0, th = 0;
};

struct BoundedReader {
  const uint8_t* p;
  int64_t n, pos = 0;
  bool ok = true;
  uint32_t u8() {
    if (pos + 1 > n) {
      ok = false;
      return 0;
    }
    return p[pos++];
  }
  uint32_t u16() {
    uint32_t a = u8();
    return (a << 8) | u8();
  }
  uint32_t u32() {
    uint32_t a = u16();
    return (a << 16) | u16();
  }
};

// SPcod / SPcoc (A.6.1, A.6.2) into t: the decomposition levels, the
// code-block size and style, the transform, the precinct sizes (when
// csty bit 0); kOk, kBadHeader, or kUnsupported for HT code-blocks
int read_spcod(BoundedReader& r, Tccp& t, bool precincts) {
  t.numres = int(r.u8()) + 1;
  t.cblkw = int(r.u8()) + 2;
  t.cblkh = int(r.u8()) + 2;
  t.cblksty = int(r.u8());
  t.qmfbid = int(r.u8());
  if (!r.ok) return kBadHeader;
  if (t.numres > 33 || t.cblkw > 10 || t.cblkh > 10 || t.cblkw + t.cblkh > 12) return kBadHeader;
  if (t.qmfbid > 1) return kBadHeader;
  if (t.cblksty & 0x80) return kBadHeader;  // mixed HT code-blocks: OpenJPEG refuses them
  if (t.cblksty & 0x40) return kUnsupported;  // HT (Part 15) code-blocks: not ported
  t.csty = precincts ? 1 : 0;
  if (precincts) {
    for (int i = 0; i < t.numres; ++i) {
      int v = int(r.u8());
      t.prcw[i] = v & 15;
      t.prch[i] = v >> 4;
      if (i > 0 && (t.prcw[i] == 0 || t.prch[i] == 0)) return kBadHeader;
    }
  } else {
    for (int i = 0; i < 33; ++i) t.prcw[i] = t.prch[i] = 15;
  }
  return r.ok ? kOk : kBadHeader;
}

// SQcd / SQcc (A.6.4, A.6.5)
bool read_sqcd(BoundedReader& r, int64_t end, Tccp& t) {
  int s = int(r.u8());
  t.qntsty = s & 31;
  t.numgbits = s >> 5;
  if (t.qntsty == 0) {
    const int64_t n = end - r.pos;
    for (int64_t i = 0; i < n; ++i) {  // past 97 bands, read past as OpenJPEG does
      const int v = int(r.u8()) >> 3;
      if (i < 97) {
        t.expn[i] = v;
        t.mant[i] = 0;
      }
    }
  } else if (t.qntsty == 1) {
    uint32_t v = r.u16();
    t.expn[0] = int(v >> 11);
    t.mant[0] = int(v & 0x7ff);
    for (int b = 1; b < 97; ++b) {
      int e = t.expn[0] - (b - 1) / 3;
      t.expn[b] = e > 0 ? e : 0;
      t.mant[b] = t.mant[0];
    }
  } else {  // 2, and any other style OpenJPEG reads as scalar expounded
    const int64_t n = (end - r.pos) / 2;
    for (int64_t i = 0; i < n; ++i) {
      const uint32_t v = r.u16();
      if (i < 97) {
        t.expn[i] = int(v >> 11);
        t.mant[i] = int(v & 0x7ff);
      }
    }
  }
  return r.ok;
}

// ------------------------------------------------------------------ tile geometry

struct Seg {
  int len = 0, numpasses = 0, maxpasses = 0, newlen = 0, numnewpasses = 0;
};

struct Cblk {
  int x0, y0, x1, y1;
  int numbps = 0, numlenbits = 0;
  int numnewpasses = 0;
  std::vector<Seg> segs;
  int numsegs = 0;
  std::vector<uint8_t> data;
};

struct TagTree {
  std::vector<int> parent, value, low;
  void init(int nw, int nh) {
    std::vector<int> lw{nw}, lh{nh};
    int total = 0;
    for (;;) {
      int n = lw.back() * lh.back();
      total += n;
      if (n <= 1) break;
      lw.push_back((lw.back() + 1) / 2);
      lh.push_back((lh.back() + 1) / 2);
    }
    parent.assign(total, -1);
    value.assign(total, 999);
    low.assign(total, 0);
    int base = 0;
    for (size_t l = 0; l + 1 < lw.size(); ++l) {
      int next = base + lw[l] * lh[l];
      for (int j = 0; j < lh[l]; ++j)
        for (int i = 0; i < lw[l]; ++i) parent[base + j * lw[l] + i] = next + (j / 2) * lw[l + 1] + i / 2;
      base = next;
    }
  }
};

struct Precinct {
  int x0, y0, x1, y1;
  int cw = 0, ch = 0;
  std::vector<Cblk> cblks;
  TagTree incl, imsb;
};

struct Band {
  int bandno;  // 0 LL, 1 HL (x high), 2 LH (y high), 3 HH
  int x0, y0, x1, y1;
  int numbps;
  float stepsize;
  std::vector<Precinct> precincts;
  bool empty() const { return x1 <= x0 || y1 <= y0; }
};

struct Resolution {
  int x0, y0, x1, y1;
  int pw = 0, ph = 0;
  int pdx, pdy;
  std::vector<Band> bands;
};

struct TileComp {
  int x0, y0, x1, y1;
  int numres;
  std::vector<Resolution> res;
  std::vector<int32_t> idata;
  std::vector<float> fdata;
};

// ------------------------------------------------------------------ bit reader of packet headers

struct Bio {
  const uint8_t* start;
  const uint8_t* bp;
  const uint8_t* end;
  uint32_t buf = 0;
  int ct = 0;
  void init(const uint8_t* p, int64_t len) {
    start = bp = p;
    end = p + len;
    buf = 0;
    ct = 0;
  }
  void bytein() {
    buf = (buf << 8) & 0xffff;
    ct = buf == 0xff00 ? 7 : 8;
    if (bp < end) buf |= *bp++;
  }
  uint32_t bit() {
    if (ct == 0) bytein();
    --ct;
    return (buf >> ct) & 1;
  }
  uint32_t read(int n) {
    uint32_t v = 0;
    for (int i = n - 1; i >= 0; --i) v |= bit() << i;
    return v;
  }
  void inalign() {
    if ((buf & 0xff) == 0xff) bytein();
    ct = 0;
  }
  int64_t numbytes() const { return bp - start; }
};

bool tgt_decode(Bio& bio, TagTree& t, int leaf, int threshold) {
  int stk[40];
  int sp = 0;
  int node = leaf;
  while (t.parent[node] >= 0) {
    if (sp >= 40) return false;
    stk[sp++] = node;
    node = t.parent[node];
  }
  int low = 0;
  for (;;) {
    if (low > t.low[node])
      t.low[node] = low;
    else
      low = t.low[node];
    while (low < threshold && low < t.value[node]) {
      if (bio.bit())
        t.value[node] = low;
      else
        ++low;
    }
    t.low[node] = low;
    if (sp == 0) break;
    node = stk[--sp];
  }
  return t.value[node] < threshold;
}

uint32_t getnumpasses(Bio& bio) {
  if (!bio.read(1)) return 1;
  if (!bio.read(1)) return 2;
  uint32_t n = bio.read(2);
  if (n != 3) return 3 + n;
  n = bio.read(5);
  if (n != 31) return 6 + n;
  return 37 + bio.read(7);
}

void init_seg(Cblk& c, int index, int cblksty, bool first) {
  if (int(c.segs.size()) <= index) c.segs.resize(index + 1);
  Seg& s = c.segs[index];
  s = Seg();
  if (cblksty & 4) {  // TERMALL
    s.maxpasses = 1;
  } else if (cblksty & 1) {  // BYPASS
    if (first) {
      s.maxpasses = 10;
    } else {
      const int prev = c.segs[index - 1].maxpasses;
      s.maxpasses = (prev == 1 || prev == 10) ? 2 : 1;
    }
  } else {
    s.maxpasses = 109;
  }
}

// ------------------------------------------------------------------ MQ decoder (C.3) and raw bits

struct MQState {
  uint16_t qe;
  uint8_t nmps, nlps, sw;
};

const MQState kMQ[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},   {0x0AC1, 4, 12, 0},  {0x0521, 5, 29, 0},
    {0x0221, 38, 33, 0}, {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},  {0x4801, 9, 14, 0},  {0x3801, 10, 14, 0},
    {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0}, {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1},
    {0x5401, 16, 14, 0}, {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0}, {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0},
    {0x3001, 21, 19, 0}, {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0}, {0x1C01, 25, 22, 0},
    {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0}, {0x1401, 28, 25, 0}, {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0},
    {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0}, {0x08A1, 33, 30, 0}, {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0},
    {0x02A1, 36, 33, 0}, {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0}, {0x0085, 40, 37, 0},
    {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0}, {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0}, {0x0005, 45, 42, 0},
    {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0},
};

enum Ctx { kCtxZc = 0, kCtxSc = 9, kCtxMag = 14, kCtxAgg = 17, kCtxUni = 18, kNumCtx = 19 };

struct MQ {
  const uint8_t* bp = nullptr;  // a segment followed by 0xFF 0xFF
  uint32_t a = 0, c = 0;
  int ct = 0;
  uint8_t st[kNumCtx];
  uint8_t mps[kNumCtx];

  void reset_states() {
    std::memset(st, 0, sizeof(st));
    std::memset(mps, 0, sizeof(mps));
    st[kCtxUni] = 46;
    st[kCtxAgg] = 3;
    st[kCtxZc] = 4;
  }
  void bytein() {
    if (*bp == 0xff) {
      if (bp[1] > 0x8f) {
        c += 0xff00;
        ct = 8;
      } else {
        ++bp;
        c += uint32_t(*bp) << 9;
        ct = 7;
      }
    } else {
      ++bp;
      c += uint32_t(*bp) << 8;
      ct = 8;
    }
  }
  void init(const uint8_t* p, int len) {
    bp = p;
    c = len == 0 ? (0xffu << 16) : (uint32_t(*bp) << 16);
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }
  void renorm() {
    do {
      if (ct == 0) bytein();
      a <<= 1;
      c <<= 1;
      --ct;
    } while (a < 0x8000);
  }
  int decode(int cx) {
    const MQState& s = kMQ[st[cx]];
    const uint32_t qe = s.qe;
    int d;
    a -= qe;
    if ((c >> 16) < qe) {
      if (a < qe) {
        a = qe;
        d = mps[cx];
        st[cx] = s.nmps;
      } else {
        a = qe;
        d = 1 - mps[cx];
        if (s.sw) mps[cx] ^= 1;
        st[cx] = s.nlps;
      }
      renorm();
    } else {
      c -= qe << 16;
      if ((a & 0x8000) == 0) {
        if (a < qe) {
          d = 1 - mps[cx];
          if (s.sw) mps[cx] ^= 1;
          st[cx] = s.nlps;
        } else {
          d = mps[cx];
          st[cx] = s.nmps;
        }
        renorm();
      } else {
        d = mps[cx];
      }
    }
    return d;
  }
  void raw_init(const uint8_t* p) {
    bp = p;
    c = 0;
    ct = 0;
  }
  int raw() {
    if (ct == 0) {
      if (c == 0xff) {
        if (*bp > 0x8f) {
          c = 0xff;
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
    --ct;
    return int((c >> ct) & 1);
  }
};

// ------------------------------------------------------------------ tier 1 (Annex D)

// zero-coding contexts by band (0 LL, 1 HL, 2 LH, 3 HH) and the counts of
// significant horizontal (0-2), vertical (0-2) and diagonal (0-4) neighbours
uint8_t g_zc[4][3][3][5];
// sign contexts and XOR bits by horizontal and vertical contribution (-1..1) + 1
uint8_t g_sc[3][3], g_sx[3][3];

struct Luts {
  Luts() {
    for (int o = 0; o < 4; ++o)
      for (int h0 = 0; h0 < 3; ++h0)
        for (int v0 = 0; v0 < 3; ++v0)
          for (int d = 0; d < 5; ++d) {
            int h = h0, v = v0, n;
            if (o == 1) std::swap(h, v);  // HL: vertical neighbours weigh as LL's horizontal ones
            if (o != 3) {
              if (h == 0)
                n = v == 0 ? (d == 0 ? 0 : d == 1 ? 1 : 2) : v == 1 ? 3 : 4;
              else if (h == 1)
                n = v == 0 ? (d == 0 ? 5 : 6) : 7;
              else
                n = 8;
            } else {
              const int hv = h + v;
              if (d == 0)
                n = hv == 0 ? 0 : hv == 1 ? 1 : 2;
              else if (d == 1)
                n = hv == 0 ? 3 : hv == 1 ? 4 : 5;
              else if (d == 2)
                n = hv == 0 ? 6 : 7;
              else
                n = 8;
            }
            g_zc[o][h0][v0][d] = uint8_t(kCtxZc + n);
          }
    // Table D.3 by (H, V)
    const int ctx[3][3] = {{13, 12, 11}, {10, 9, 10}, {11, 12, 13}};  // [H+1][V+1]
    const int xr[3][3] = {{1, 1, 1}, {1, 0, 0}, {0, 0, 0}};
    for (int h = 0; h < 3; ++h)
      for (int v = 0; v < 3; ++v) {
        g_sc[h][v] = uint8_t(ctx[h][v]);
        g_sx[h][v] = uint8_t(xr[h][v]);
      }
  }
};
const Luts g_luts;

enum Flag : uint8_t { kSig = 1, kNeg = 2, kPi = 4, kMu = 8 };

struct T1 {
  int w = 0, h = 0, stride = 0;
  std::vector<uint8_t> f;  // (h + 2) x (w + 2), a zero border
  std::vector<int32_t> data;
  bool vsc = false;
  int orient = 0;
  MQ mq;

  void reset(int nw, int nh) {
    w = nw;
    h = nh;
    stride = w + 2;
    f.assign(size_t(stride) * (h + 2), 0);
    data.assign(size_t(w) * h, 0);
  }
  uint8_t* fp(int x, int y) { return &f[size_t(y + 1) * stride + (x + 1)]; }

  // neighbour counts (h, v, d) of (x, y); with vertically causal contexts
  // the row below a stripe's last row does not count
  inline void counts(const uint8_t* p, int y, int& hc, int& vc, int& dc) const {
    const bool south = !(vsc && (y & 3) == 3);
    hc = (p[-1] & kSig) + (p[1] & kSig);
    vc = (p[-stride] & kSig);
    dc = (p[-stride - 1] & kSig) + (p[-stride + 1] & kSig);
    if (south) {
      vc += (p[stride] & kSig);
      dc += (p[stride - 1] & kSig) + (p[stride + 1] & kSig);
    }
  }
  inline bool any_neighbour(const uint8_t* p, int y) const {
    int hc, vc, dc;
    counts(p, y, hc, vc, dc);
    return hc + vc + dc != 0;
  }
  static inline int contrib(uint8_t q) { return (q & kSig) ? ((q & kNeg) ? -1 : 1) : 0; }
  inline int sign_ctx(const uint8_t* p, int y, int& xorbit) const {
    const bool south = !(vsc && (y & 3) == 3);
    int hs = contrib(p[-1]) + contrib(p[1]);
    int vs = contrib(p[-stride]) + (south ? contrib(p[stride]) : 0);
    hs = hs < -1 ? -1 : hs > 1 ? 1 : hs;
    vs = vs < -1 ? -1 : vs > 1 ? 1 : vs;
    xorbit = g_sx[hs + 1][vs + 1];
    return g_sc[hs + 1][vs + 1];
  }
  inline int zc_ctx(const uint8_t* p, int y) const {
    int hc, vc, dc;
    counts(p, y, hc, vc, dc);
    return g_zc[orient][hc][vc][dc];
  }
  inline int mag_ctx(const uint8_t* p, int y) const {
    if (*p & kMu) return kCtxMag + 2;
    return any_neighbour(p, y) ? kCtxMag + 1 : kCtxMag;
  }

  void sigpass(int bpno, bool raw) {
    const int one = 1 << bpno, oph = one | (one >> 1);
    for (int k = 0; k < h; k += 4)
      for (int x = 0; x < w; ++x)
        for (int y = k; y < k + 4 && y < h; ++y) {
          uint8_t* p = fp(x, y);
          if (*p & (kSig | kPi)) continue;
          if (!any_neighbour(p, y)) continue;
          int bit = raw ? mq.raw() : mq.decode(zc_ctx(p, y));
          if (bit) {
            int s;
            if (raw) {
              s = mq.raw();
            } else {
              int xb;
              const int cx = sign_ctx(p, y, xb);
              s = mq.decode(cx) ^ xb;
            }
            data[size_t(y) * w + x] = s ? -oph : oph;
            *p |= uint8_t(kSig | (s ? kNeg : 0));
          }
          *p |= kPi;
        }
  }

  void refpass(int bpno, bool raw) {
    const int poshalf = (1 << bpno) >> 1;
    for (int k = 0; k < h; k += 4)
      for (int x = 0; x < w; ++x)
        for (int y = k; y < k + 4 && y < h; ++y) {
          uint8_t* p = fp(x, y);
          if ((*p & (kSig | kPi)) != kSig) continue;
          int v = raw ? mq.raw() : mq.decode(mag_ctx(p, y));
          int32_t& d = data[size_t(y) * w + x];
          d += (v ^ (d < 0)) ? poshalf : -poshalf;
          *p |= kMu;
        }
  }

  void clnpass(int bpno, bool segsym) {
    const int one = 1 << bpno, oph = one | (one >> 1);
    for (int k = 0; k < h; k += 4)
      for (int x = 0; x < w; ++x) {
        const int rows = std::min(4, h - k);
        int start = 0;
        bool partial = false;
        if (rows == 4) {
          bool zero = true;
          for (int ci = 0; ci < 4 && zero; ++ci) {
            const uint8_t* p = fp(x, k + ci);
            if ((*p & (kSig | kPi)) || any_neighbour(p, k + ci)) zero = false;
          }
          if (zero) {
            if (!mq.decode(kCtxAgg)) continue;
            int run = mq.decode(kCtxUni);
            run = (run << 1) | mq.decode(kCtxUni);
            start = run;
            partial = true;
          }
        }
        for (int ci = start; ci < rows; ++ci) {
          const int y = k + ci;
          uint8_t* p = fp(x, y);
          if (!(*p & (kSig | kPi))) {
            bool sig = true;
            if (!partial) sig = mq.decode(zc_ctx(p, y)) != 0;
            partial = false;
            if (sig) {
              int xb;
              const int cx = sign_ctx(p, y, xb);
              const int s = mq.decode(cx) ^ xb;
              data[size_t(y) * w + x] = s ? -oph : oph;
              *p |= uint8_t(kSig | (s ? kNeg : 0));
            }
          }
        }
        for (int ci = 0; ci < rows; ++ci) *fp(x, k + ci) &= uint8_t(~kPi);
      }
    if (segsym) {
      for (int i = 0; i < 4; ++i) mq.decode(kCtxUni);
    }
  }

  // opj_t1_decode_cblk
  void decode(Cblk& cb, int orient_, int roishift, int cblksty) {
    reset(cb.x1 - cb.x0, cb.y1 - cb.y0);
    orient = orient_;
    vsc = (cblksty & 8) != 0;
    int bpno_plus_one = roishift + cb.numbps;
    int passtype = 2;
    mq.reset_states();
    std::vector<uint8_t> buf;
    int64_t index = 0;
    for (int segno = 0; segno < cb.numsegs; ++segno) {
      const Seg& seg = cb.segs[segno];
      const bool raw = (bpno_plus_one <= cb.numbps - 4) && passtype < 2 && (cblksty & 1);
      buf.assign(cb.data.begin() + index, cb.data.begin() + index + seg.len);
      buf.push_back(0xff);
      buf.push_back(0xff);
      index += seg.len;
      if (raw)
        mq.raw_init(buf.data());
      else
        mq.init(buf.data(), seg.len);
      for (int passno = 0; passno < seg.numpasses && bpno_plus_one >= 1; ++passno) {
        if (passtype == 0)
          sigpass(bpno_plus_one, raw);
        else if (passtype == 1)
          refpass(bpno_plus_one, raw);
        else
          clnpass(bpno_plus_one, (cblksty & 32) != 0);
        if ((cblksty & 2) && !raw) mq.reset_states();
        if (++passtype == 3) {
          passtype = 0;
          --bpno_plus_one;
        }
      }
    }
    if (roishift) {
      if (roishift >= 31) {
        std::fill(data.begin(), data.end(), 0);
      } else {
        const int32_t thresh = int32_t(1) << roishift;
        for (auto& v : data) {
          int32_t mag = v < 0 ? -v : v;
          if (mag >= thresh) {
            mag >>= roishift;
            v = v < 0 ? -mag : mag;
          }
        }
      }
    }
  }
};

// ------------------------------------------------------------------ inverse DWT

// one 5/3 line in place: x holds the samples in their positions, the first
// at an odd position of the reference grid when cas
void idwt53_line(int32_t* x, int len, int cas, std::vector<int32_t>& tmp) {
  if (len == 1) {
    if (cas) x[0] /= 2;
    return;
  }
  auto mir = [len](int i) { return i < 0 ? -i : (i >= len ? 2 * (len - 1) - i : i); };
  tmp.assign(x, x + len);
  // even positions of the grid (low-pass) first
  for (int i = cas ? 1 : 0; i < len; i += 2) tmp[i] = x[i] - ((x[mir(i - 1)] + x[mir(i + 1)] + 2) >> 2);
  for (int i = cas ? 0 : 1; i < len; i += 2) tmp[i] = x[i] + ((tmp[mir(i - 1)] + tmp[mir(i + 1)]) >> 1);
  std::memcpy(x, tmp.data(), sizeof(int32_t) * size_t(len));
}

const float kAlpha = -1.586134342f, kBeta = -0.052980118f, kGamma = 0.882911075f, kDelta = 0.443506852f;
const float kK = 1.230174105f, kTwoInvK = 1.625732422f;

__attribute__((optimize("fp-contract=off"))) void idwt97_lift(float* x, int len, int first, float c) {
  auto mir = [len](int i) { return i < 0 ? -i : (i >= len ? 2 * (len - 1) - i : i); };
  for (int i = first; i < len; i += 2) {
    const float s = x[mir(i - 1)] + x[mir(i + 1)];
    const float m = s * c;
    x[i] = x[i] + m;
  }
}

// one 9/7 line in place (opj_v8dwt_decode): low-pass samples times K, high-pass times
// OpenJPEG's 2/K, then the four lifting steps
__attribute__((optimize("fp-contract=off"))) void idwt97_line(float* x, int len, int cas) {
  const int sn = cas ? len / 2 : (len + 1) / 2, dn = len - sn;
  if (cas == 0 ? !(dn > 0 || sn > 1) : !(sn > 0 || dn > 1)) return;
  const int lo = cas ? 1 : 0, hi = 1 - lo;
  for (int i = lo; i < len; i += 2) x[i] = x[i] * kK;
  for (int i = hi; i < len; i += 2) x[i] = x[i] * kTwoInvK;
  idwt97_lift(x, len, lo, -kDelta);
  idwt97_lift(x, len, hi, -kGamma);
  idwt97_lift(x, len, lo, -kBeta);
  idwt97_lift(x, len, hi, -kAlpha);
}

// the tile-component's buffer (width W) holds each resolution's bands
// deinterleaved, [L | H] along a row and down a column; rows, then columns,
// level by level
template <typename T, typename Line>
void idwt_2d(T* buf, int W, const TileComp& tc, int numres, Line line) {
  std::vector<T> lin;
  for (int r = 1; r < numres; ++r) {
    const Resolution& prev = tc.res[r - 1];
    const Resolution& res = tc.res[r];
    const int rw = res.x1 - res.x0, rh = res.y1 - res.y0;
    const int sw = prev.x1 - prev.x0, shh = prev.y1 - prev.y0;
    const int hcas = res.x0 & 1, vcas = res.y0 & 1;
    lin.resize(std::max(rw, rh));
    if (rw > 0) {
      for (int j = 0; j < rh; ++j) {
        T* row = buf + size_t(j) * W;
        const int sn = sw, dn = rw - sw;
        for (int i = 0; i < sn; ++i) lin[2 * i + hcas] = row[i];
        for (int i = 0; i < dn; ++i) lin[2 * i + 1 - hcas] = row[sn + i];
        line(lin.data(), rw, hcas);
        std::memcpy(row, lin.data(), sizeof(T) * size_t(rw));
      }
    }
    if (rh > 0) {
      for (int i = 0; i < rw; ++i) {
        const int sn = shh, dn = rh - shh;
        for (int j = 0; j < sn; ++j) lin[2 * j + vcas] = buf[size_t(j) * W + i];
        for (int j = 0; j < dn; ++j) lin[2 * j + 1 - vcas] = buf[size_t(sn + j) * W + i];
        line(lin.data(), rh, vcas);
        for (int j = 0; j < rh; ++j) buf[size_t(j) * W + i] = lin[j];
      }
    }
  }
}

// ------------------------------------------------------------------ the decoder

struct Decoder {
  const uint8_t* cs;
  int64_t n;
  Image img;
  Tcp deftcp;
  std::vector<Tcp> tcps;
  std::vector<std::vector<uint8_t>> ppm_parts;  // PPM contents, by Zppm
  std::vector<uint8_t> ppm;  // the packet headers of every tile-part in turn, Nppm fields taken out
  bool has_ppm = false;
  // OpenJPEG's resno_decoded: by component, the highest resolution of a packet read in any tile so far
  std::vector<int> resno_decoded;

  // opj_j2k_merge_ppm: the PPM contents in Zppm order hold Nppm (4 bytes) and Nppm bytes of headers, in
  // turn, across the markers' ends; a length past the last one fails ("Corrupted PPM markers")
  bool merge_ppm() {
    int64_t remaining = 0;
    for (const auto& part : ppm_parts) {
      size_t at = 0;
      while (at < part.size()) {
        if (remaining > 0) {
          const size_t k = size_t(std::min<int64_t>(remaining, int64_t(part.size() - at)));
          ppm.insert(ppm.end(), part.begin() + at, part.begin() + at + k);
          at += k;
          remaining -= int64_t(k);
          continue;
        }
        if (part.size() - at < 4) return false;  // "Not enough bytes to read Nppm"
        remaining = (int64_t(part[at]) << 24) | (part[at + 1] << 16) | (part[at + 2] << 8) | part[at + 3];
        at += 4;
      }
    }
    return remaining == 0;
  }
  int64_t ppm_pos = 0;
  std::vector<int> order;  // tiles in the order their data come

  int read_siz(BoundedReader& r) {
    r.u16();  // Rsiz
    img.x1 = r.u32();
    img.y1 = r.u32();
    img.x0 = r.u32();
    img.y0 = r.u32();
    img.tdx = r.u32();
    img.tdy = r.u32();
    img.tx0 = r.u32();
    img.ty0 = r.u32();
    img.ncomp = int(r.u16());
    if (!r.ok || img.ncomp < 1 || img.ncomp > 16384 || r.n != 36 + 3 * int64_t(img.ncomp)) return kBadHeader;
    for (int i = 0; i < img.ncomp; ++i) {
      int s = int(r.u8()), dx = int(r.u8()), dy = int(r.u8());
      if (dx == 0 || dy == 0) return kBadHeader;
      img.comps.push_back({dx, dy, (s & 0x7f) + 1, (s >> 7) & 1});
      if ((s & 0x7f) + 1 > 31) return kBadHeader;
    }
    if (!r.ok) return kBadHeader;
    if (img.x0 >= img.x1 || img.y0 >= img.y1 || img.tdx == 0 || img.tdy == 0) return kBadHeader;
    if (img.tx0 > img.x0 || img.ty0 > img.y0 || img.tx0 + img.tdx <= img.x0 || img.ty0 + img.tdy <= img.y0)
      return kBadHeader;
    img.tw = int(ceil_div(img.x1 - img.tx0, img.tdx));
    img.th = int(ceil_div(img.y1 - img.ty0, img.tdy));
    if (int64_t(img.tw) * img.th > 65535) return kBadHeader;
    deftcp.tccps.assign(img.ncomp, Tccp());
    return kOk;
  }

  int comp_index(BoundedReader& r) { return img.ncomp <= 256 ? int(r.u8()) : int(r.u16()); }

  // one marker segment of a main (tcp == &deftcp) or tile-part header
  // where OpenJPEG's marker table allows a marker: 1 in both headers, 2
  // the main header only, 3 a tile-part header only, 4 nowhere (SIZ after
  // its place, SOP), 0 a marker it does not know
  static int marker_place(int m) {
    switch (m) {
      case 0xFF52: case 0xFF53: case 0xFF5C: case 0xFF5D: case 0xFF5E: case 0xFF5F: case 0xFF64: case 0xFF74:
      case 0xFF75: case 0xFF77:  // COD COC QCD QCC RGN POC COM, Part 2's MCT MCC MCO
        return 1;
      case 0xFF55: case 0xFF57: case 0xFF60: case 0xFF63: case 0xFF50: case 0xFF59: case 0xFF78:
        return 2;  // TLM PLM PPM CRG CAP CPF CBD
      case 0xFF58: case 0xFF61:
        return 3;  // PLT PPT
      case 0xFF51: case 0xFF91:
        return 4;
      default:
        return 0;
    }
  }

  // the next marker of a header at pos, as OpenJPEG finds it: a value below
  // 0xFF00 fails; a marker it does not know is followed by a search, two
  // bytes at a time, for one it knows (opj_j2k_read_unk); a known one must
  // be allowed where it stands (`stop`, SOT or SOD, ends the header). -1
  // on a failure, else the marker, with pos at it.
  int next_marker(int64_t& pos, int64_t limit, bool main, int stop) const {
    if (pos + 2 > limit) return -1;
    int m = (int(cs[pos]) << 8) | cs[pos + 1];
    if (m < 0xFF00) return -1;  // "A marker ID was expected"
    if (m != stop && marker_place(m) == 0) {
      int64_t q = pos + 2;
      for (;;) {
        if (q + 2 > limit) return -1;  // "Stream too short"
        m = (int(cs[q]) << 8) | cs[q + 1];
        q += 2;
        if (m >= 0xFF00 && (m == stop || marker_place(m) != 0)) break;
      }
      pos = q - 2;
    }
    if (m == stop) return m;
    const int place = marker_place(m);
    return (place == 1 || place == (main ? 2 : 3)) ? m : -1;  // "Marker is not compliant with its position"
  }

  int read_marker(int marker, BoundedReader& r, int64_t end, Tcp& tcp, bool main) {
    switch (marker) {
      case 0xFF52: {  // COD
        const int scod = int(r.u8());
        if (scod & ~7) return kBadHeader;  // "Unknown Scod value in COD marker"
        tcp.csty = scod;
        tcp.prg = int(r.u8());
        tcp.numlayers = int(r.u16());
        tcp.mct = int(r.u8());
        if (!r.ok || tcp.numlayers == 0 || tcp.mct > 1) return kBadHeader;
        if (tcp.prg > 4) tcp.prg = -1;  // unknown: OpenJPEG fails the tile only if no POC replaces it
        Tccp t0 = tcp.tccps[0];
        if (int rc = read_spcod(r, t0, scod & 1)) return rc;
        if (r.pos != end) return kBadHeader;  // "Error reading COD marker"
        for (auto& t : tcp.tccps) {
          t.csty = t0.csty;
          t.numres = t0.numres;
          t.cblkw = t0.cblkw;
          t.cblkh = t0.cblkh;
          t.cblksty = t0.cblksty;
          t.qmfbid = t0.qmfbid;
          std::memcpy(t.prcw, t0.prcw, sizeof(t.prcw));
          std::memcpy(t.prch, t0.prch, sizeof(t.prch));
        }
        tcp.cod_seen = true;
        return kOk;
      }
      case 0xFF53: {  // COC
        const int c = comp_index(r);
        if (c >= img.ncomp) return kBadHeader;
        const int scoc = int(r.u8());
        if (int rc = read_spcod(r, tcp.tccps[c], scoc & 1)) return rc;
        return r.pos == end ? kOk : kBadHeader;
      }
      case 0xFF5C: {  // QCD
        Tccp t0 = tcp.tccps[0];
        if (!read_sqcd(r, end, t0) || r.pos != end) return kBadHeader;  // "Error reading QCD marker"
        tcp.qcd_seen = true;
        for (auto& t : tcp.tccps) {
          t.qntsty = t0.qntsty;
          t.numgbits = t0.numgbits;
          std::memcpy(t.expn, t0.expn, sizeof(t.expn));
          std::memcpy(t.mant, t0.mant, sizeof(t.mant));
        }
        return kOk;
      }
      case 0xFF5D: {  // QCC
        const int c = comp_index(r);
        if (c >= img.ncomp) return kBadHeader;
        if (!read_sqcd(r, end, tcp.tccps[c]) || r.pos != end) return kBadHeader;
        return kOk;
      }
      case 0xFF5E: {  // RGN: Srgn is not checked, as OpenJPEG does not check it
        if (end != (img.ncomp <= 256 ? 3 : 4)) return kBadHeader;
        const int c = comp_index(r);
        r.u8();
        const int sp = int(r.u8());
        if (!r.ok || c >= img.ncomp) return kBadHeader;
        tcp.tccps[c].roishift = sp;
        return kOk;
      }
      case 0xFF5F: {  // POC
        const int room = img.ncomp <= 256 ? 1 : 2;
        const int64_t size = end - r.pos, chunk = 5 + 2 * room;
        if (size <= 0 || size % chunk) return kBadHeader;
        for (int64_t i = 0; i < size / chunk; ++i) {
          Poc p;
          p.resno0 = int(r.u8());
          p.compno0 = room == 1 ? int(r.u8()) : int(r.u16());
          p.layno1 = int(r.u16());
          p.resno1 = int(r.u8());
          p.compno1 = room == 1 ? int(r.u8()) : int(r.u16());
          p.prg = int(r.u8());
          if (p.prg > 4) return kBadHeader;
          p.compno1 = std::min(p.compno1, img.ncomp);
          tcp.pocs.push_back(p);
        }
        if (tcp.pocs.size() >= 32) return kBadHeader;
        return r.ok ? kOk : kBadHeader;
      }
      case 0xFF60: {  // PPM: its Zppm orders it, merged at the end of the main header (merge_ppm)
        if (!main) return kBadHeader;
        const int z = int(r.u8());
        if (int(ppm_parts.size()) <= z) ppm_parts.resize(z + 1);
        while (r.pos < end) ppm_parts[z].push_back(uint8_t(r.u8()));
        has_ppm = true;
        return kOk;
      }
      case 0xFF61: {  // PPT
        if (main) return kBadHeader;
        const int z = int(r.u8());
        if (int(tcp.ppt_parts.size()) <= z) tcp.ppt_parts.resize(z + 1);
        while (r.pos < end) tcp.ppt_parts[z].push_back(uint8_t(r.u8()));
        tcp.has_ppt = true;
        return kOk;
      }
      default:  // CAP (HT code-blocks fail in SPcod), TLM, PLM, PLT, CRG, COM, Part 2's: read past
        return kOk;
    }
  }

  int parse() {
    if (n < 4 || cs[0] != 0xFF || cs[1] != 0x4F || cs[2] != 0xFF || cs[3] != 0x51) return kBadHeader;
    int64_t pos = 4;
    {
      if (pos + 2 > n) return kBadHeader;
      const int64_t len = (int64_t(cs[pos]) << 8) | cs[pos + 1];
      if (len < 2 || pos + len > n) return kBadHeader;
      BoundedReader r{cs + pos + 2, len - 2};
      int rc = read_siz(r);
      if (rc) return rc;
      pos += len;
    }
    // main header
    for (;;) {
      const int marker = next_marker(pos, n, true, 0xFF90);
      if (marker < 0) return kBadHeader;
      if (marker == 0xFF90) break;
      if (pos + 4 > n) return kBadHeader;
      const int64_t len = (int64_t(cs[pos + 2]) << 8) | cs[pos + 3];
      if (len < 2 || pos + 2 + len > n) return kBadHeader;
      BoundedReader r{cs + pos + 4, len - 2};
      int rc = read_marker(marker, r, len - 2, deftcp, true);
      if (rc) return rc;
      pos += 2 + len;
    }
    if (!deftcp.cod_seen || !deftcp.qcd_seen) return kBadHeader;  // "required COD / QCD marker not found"
    if (has_ppm && !merge_ppm()) return kBadHeader;
    tcps.assign(size_t(img.tw) * img.th, deftcp);
    // tile-parts, each followed by a marker (OpenJPEG: "Stream too short"); the data ending right after
    // an SOT's code ends the codestream there (its tile is not decoded)
    for (;;) {
      if (n - pos < 2) return kBadData;
      const int marker = (int(cs[pos]) << 8) | cs[pos + 1];
      if (marker == 0xFFD9) break;
      if (marker != 0xFF90) return kBadData;
      if (n - pos == 2) break;
      if (pos + 12 > n) return kBadData;
      BoundedReader s{cs + pos + 2, 10};
      const int lsot = int(s.u16());
      const int isot = int(s.u16());
      int64_t psot = s.u32();
      const int tpsot = int(s.u8());
      const int tnsot = int(s.u8());
      if (lsot != 10 || isot >= int(tcps.size())) return kBadData;
      Tcp& tp = tcps[isot];
      if (tpsot != tp.parts || (tnsot != 0 && tpsot >= tnsot)) return kBadData;  // tile-parts in order
      ++tp.parts;
      const int64_t tp_start = pos;
      if (psot == 0) psot = n - 2 - tp_start;  // up to the EOC
      if (psot < 14) return kBadData;
      int64_t tp_end = tp_start + psot;
      if (tp_end > n) return kBadData;
      Tcp& tcp = tcps[isot];
      if (!tcp.seen) {
        tcp.seen = true;
        order.push_back(isot);
      }
      pos += 12;
      for (;;) {
        const int m = next_marker(pos, tp_end, false, 0xFF93);
        if (m < 0) return kBadData;
        if (m == 0xFF93) {
          pos += 2;
          break;
        }
        if (pos + 4 > tp_end) return kBadData;
        const int64_t len = (int64_t(cs[pos + 2]) << 8) | cs[pos + 3];
        if (len < 2 || pos + 2 + len > tp_end) return kBadData;
        BoundedReader r{cs + pos + 4, len - 2};
        int rc = read_marker(m, r, len - 2, tcp, false);
        if (rc) return rc == kUnsupported ? rc : kBadData;
        pos += 2 + len;
      }
      tcp.data.insert(tcp.data.end(), cs + pos, cs + tp_end);
      pos = tp_end;
    }
    return kOk;
  }

  // ---------------------------------------------------------------- one tile

  void tile_rect(int t, int64_t& x0, int64_t& y0, int64_t& x1, int64_t& y1) const {
    const int p = t % img.tw, q = t / img.tw;
    x0 = std::max(img.tx0 + p * img.tdx, img.x0);
    y0 = std::max(img.ty0 + q * img.tdy, img.y0);
    x1 = std::min(img.tx0 + (p + 1) * img.tdx, img.x1);
    y1 = std::min(img.ty0 + (q + 1) * img.tdy, img.y1);
  }

  int init_tilecomp(TileComp& tc, const Tccp& tccp, const Comp& comp, int64_t tx0, int64_t ty0, int64_t tx1,
                    int64_t ty1) {
    tc.x0 = int(ceil_div(tx0, comp.dx));
    tc.y0 = int(ceil_div(ty0, comp.dy));
    tc.x1 = int(ceil_div(tx1, comp.dx));
    tc.y1 = int(ceil_div(ty1, comp.dy));
    tc.numres = tccp.numres;
    tc.res.assign(tc.numres, Resolution());
    for (int r = 0; r < tc.numres; ++r) {
      Resolution& res = tc.res[r];
      const int levelno = tc.numres - 1 - r;
      res.x0 = int(ceil_div_pow2(tc.x0, levelno));
      res.y0 = int(ceil_div_pow2(tc.y0, levelno));
      res.x1 = int(ceil_div_pow2(tc.x1, levelno));
      res.y1 = int(ceil_div_pow2(tc.y1, levelno));
      res.pdx = tccp.prcw[r];
      res.pdy = tccp.prch[r];
      const int64_t tlprcx = floor_div_pow2(res.x0, res.pdx) << res.pdx;
      const int64_t tlprcy = floor_div_pow2(res.y0, res.pdy) << res.pdy;
      const int64_t brprcx = ceil_div_pow2(res.x1, res.pdx) << res.pdx;
      const int64_t brprcy = ceil_div_pow2(res.y1, res.pdy) << res.pdy;
      res.pw = res.x0 == res.x1 ? 0 : int((brprcx - tlprcx) >> res.pdx);
      res.ph = res.y0 == res.y1 ? 0 : int((brprcy - tlprcy) >> res.pdy);
      if (int64_t(res.pw) * res.ph > (1 << 20)) return kBadData;  // past any real image's precinct count
      int64_t tlcbgx, tlcbgy;
      int cbgw, cbgh;
      if (r == 0) {
        tlcbgx = tlprcx;
        tlcbgy = tlprcy;
        cbgw = res.pdx;
        cbgh = res.pdy;
      } else {
        tlcbgx = ceil_div_pow2(tlprcx, 1);
        tlcbgy = ceil_div_pow2(tlprcy, 1);
        cbgw = res.pdx - 1;
        cbgh = res.pdy - 1;
      }
      const int cblkw = std::min(tccp.cblkw, cbgw), cblkh = std::min(tccp.cblkh, cbgh);
      const int nbands = r == 0 ? 1 : 3;
      res.bands.assign(nbands, Band());
      for (int b = 0; b < nbands; ++b) {
        Band& band = res.bands[b];
        band.bandno = r == 0 ? 0 : b + 1;
        if (r == 0) {
          band.x0 = res.x0;
          band.y0 = res.y0;
          band.x1 = res.x1;
          band.y1 = res.y1;
        } else {
          const int nb = tc.numres - r;  // decomposition level of the band
          const int x0b = band.bandno & 1, y0b = band.bandno >> 1;
          band.x0 = int(ceil_div_pow2(tc.x0 - (int64_t(x0b) << (nb - 1)), nb));
          band.y0 = int(ceil_div_pow2(tc.y0 - (int64_t(y0b) << (nb - 1)), nb));
          band.x1 = int(ceil_div_pow2(tc.x1 - (int64_t(x0b) << (nb - 1)), nb));
          band.y1 = int(ceil_div_pow2(tc.y1 - (int64_t(y0b) << (nb - 1)), nb));
        }
        const int bidx = r == 0 ? 0 : 3 * (r - 1) + b + 1;
        const int gain = tccp.qmfbid == 0 ? 0 : (band.bandno == 0 ? 0 : band.bandno == 3 ? 2 : 1);
        const int numbps = comp.prec + gain;
        band.stepsize = float((1.0 + tccp.mant[bidx] / 2048.0) * std::pow(2.0, numbps - tccp.expn[bidx]));
        band.numbps = tccp.expn[bidx] + tccp.numgbits - 1;
        const int np = res.pw * res.ph;
        band.precincts.assign(np, Precinct());
        for (int p = 0; p < np; ++p) {
          Precinct& prc = band.precincts[p];
          const int64_t cbgx0 = tlcbgx + int64_t(p % res.pw) * (int64_t(1) << cbgw);
          const int64_t cbgy0 = tlcbgy + int64_t(p / res.pw) * (int64_t(1) << cbgh);
          prc.x0 = int(std::max<int64_t>(cbgx0, band.x0));
          prc.y0 = int(std::max<int64_t>(cbgy0, band.y0));
          prc.x1 = int(std::min<int64_t>(cbgx0 + (int64_t(1) << cbgw), band.x1));
          prc.y1 = int(std::min<int64_t>(cbgy0 + (int64_t(1) << cbgh), band.y1));
          const int64_t tlcx = floor_div_pow2(prc.x0, cblkw) << cblkw;
          const int64_t tlcy = floor_div_pow2(prc.y0, cblkh) << cblkh;
          const int64_t brcx = ceil_div_pow2(prc.x1, cblkw) << cblkw;
          const int64_t brcy = ceil_div_pow2(prc.y1, cblkh) << cblkh;
          prc.cw = int(std::max<int64_t>(0, (brcx - tlcx) >> cblkw));
          prc.ch = int(std::max<int64_t>(0, (brcy - tlcy) >> cblkh));
          if (band.empty() || prc.x0 >= prc.x1 || prc.y0 >= prc.y1) prc.cw = prc.ch = 0;
          if (int64_t(prc.cw) * prc.ch > (1 << 20)) return kBadData;
          prc.cblks.assign(size_t(prc.cw) * prc.ch, Cblk());
          for (int c = 0; c < prc.cw * prc.ch; ++c) {
            Cblk& cb = prc.cblks[c];
            const int64_t cx0 = tlcx + int64_t(c % prc.cw) * (int64_t(1) << cblkw);
            const int64_t cy0 = tlcy + int64_t(c / prc.cw) * (int64_t(1) << cblkh);
            cb.x0 = int(std::max<int64_t>(cx0, prc.x0));
            cb.y0 = int(std::max<int64_t>(cy0, prc.y0));
            cb.x1 = int(std::min<int64_t>(cx0 + (int64_t(1) << cblkw), prc.x1));
            cb.y1 = int(std::min<int64_t>(cy0 + (int64_t(1) << cblkh), prc.y1));
          }
          prc.incl.init(prc.cw, prc.ch);
          prc.imsb.init(prc.cw, prc.ch);
        }
      }
    }
    return kOk;
  }

  // opj_t2_read_packet_header + opj_t2_read_packet_data
  int read_packet(std::vector<TileComp>& tcs, const Tcp& tcp, int compno, int resno, int precno, int layno,
                  const uint8_t*& cur, const uint8_t* end, const std::vector<uint8_t>* hdrbuf, int64_t& hdrpos) {
    Resolution& res = tcs[compno].res[resno];
    const Tccp& tccp = tcp.tccps[compno];
    if (tcp.csty & 2) {  // SOP
      if (end - cur >= 6 && cur[0] == 0xff && cur[1] == 0x91) cur += 6;
    }
    const uint8_t* hstart;
    int64_t hlen;
    if (hdrbuf) {
      hstart = hdrbuf->data() + hdrpos;
      hlen = int64_t(hdrbuf->size()) - hdrpos;
    } else {
      hstart = cur;
      hlen = end - cur;
    }
    if (hlen < 0) hlen = 0;
    Bio bio;
    bio.init(hstart, hlen);
    const bool present = bio.read(1) != 0;
    if (present) {
      for (Band& band : res.bands) {
        if (band.empty()) continue;
        if (precno >= int(band.precincts.size())) continue;
        Precinct& prc = band.precincts[precno];
        const int ncb = prc.cw * prc.ch;
        for (int c = 0; c < ncb; ++c) {
          Cblk& cb = prc.cblks[c];
          bool included;
          if (!cb.numsegs)
            included = tgt_decode(bio, prc.incl, c, layno + 1);
          else
            included = bio.read(1) != 0;
          if (!included) {
            cb.numnewpasses = 0;
            continue;
          }
          if (!cb.numsegs) {
            int i = 0;
            while (!tgt_decode(bio, prc.imsb, c, i)) {
              if (++i > 64) return kBadData;
            }
            cb.numbps = band.numbps + 1 - i;
            cb.numlenbits = 3;
          }
          cb.numnewpasses = int(getnumpasses(bio));
          int incr = 0;
          while (bio.read(1)) {
            if (++incr > 64) return kBadData;
          }
          cb.numlenbits += incr;
          int segno = 0;
          if (!cb.numsegs) {
            init_seg(cb, 0, tccp.cblksty, true);
          } else {
            segno = cb.numsegs - 1;
            if (cb.segs[segno].numpasses == cb.segs[segno].maxpasses) {
              ++segno;
              init_seg(cb, segno, tccp.cblksty, false);
            }
          }
          int left = cb.numnewpasses;
          do {
            Seg& s = cb.segs[segno];
            s.numnewpasses = std::min(s.maxpasses - s.numpasses, left);
            const int bits = cb.numlenbits + floorlog2(uint32_t(s.numnewpasses));
            if (bits > 32) return kBadData;
            s.newlen = int(bio.read(bits));
            left -= s.numnewpasses;
            if (left > 0) {
              ++segno;
              init_seg(cb, segno, tccp.cblksty, false);
            }
          } while (left > 0);
        }
      }
    }
    bio.inalign();
    const uint8_t* hp = hstart + bio.numbytes();
    if (tcp.csty & 4) {  // EPH: OpenJPEG fails a packet header without it
      const int64_t left = (hstart + hlen) - hp;
      if (left < 2 || hp[0] != 0xff || hp[1] != 0x92) return kBadData;
      hp += 2;
    }
    if (hdrbuf)
      hdrpos = hp - hdrbuf->data();
    else
      cur = hp;
    if (!present) return kOk;
    // the packet's data
    for (Band& band : res.bands) {
      if (band.empty()) continue;
      if (precno >= int(band.precincts.size())) continue;
      Precinct& prc = band.precincts[precno];
      for (Cblk& cb : prc.cblks) {
        if (!cb.numnewpasses) continue;
        int segi;
        if (!cb.numsegs) {
          segi = 0;
          cb.numsegs = 1;
        } else {
          segi = cb.numsegs - 1;
          if (cb.segs[segi].numpasses == cb.segs[segi].maxpasses) {
            ++segi;
            ++cb.numsegs;
          }
        }
        do {
          Seg& s = cb.segs[segi];
          if (s.newlen < 0 || cur + s.newlen > end) return kBadData;  // a segment past the tile's data
          cb.data.insert(cb.data.end(), cur, cur + s.newlen);
          cur += s.newlen;
          s.len += s.newlen;
          s.numpasses += s.numnewpasses;
          cb.numnewpasses -= s.numnewpasses;
          if (cb.numnewpasses > 0) {
            ++segi;
            ++cb.numsegs;
          }
        } while (cb.numnewpasses > 0);
      }
    }
    return kOk;
  }

  // the packets of one tile in the order of its progressions (opj_pi_next_*)
  int decode_packets(std::vector<TileComp>& tcs, const Tcp& tcp, int64_t tx0, int64_t ty0, int64_t tx1, int64_t ty1,
                     const std::vector<uint8_t>* hdrbuf, int64_t& hdrpos) {
    const int nc = img.ncomp;
    int maxres = 0, maxprec = 0;
    for (int c = 0; c < nc; ++c) {
      maxres = std::max(maxres, tcs[c].numres);
      for (auto& r : tcs[c].res) maxprec = std::max(maxprec, r.pw * r.ph);
    }
    const int64_t step_c = maxprec, step_r = int64_t(nc) * step_c, step_l = int64_t(maxres) * step_r;
    const int64_t total = step_l * tcp.numlayers;
    if (total > (int64_t(1) << 26)) return kBadData;
    std::vector<uint8_t> include(size_t(total), 0);
    std::vector<Poc> pocs = tcp.pocs;
    if (pocs.empty()) {
      if (tcp.prg < 0) return kBadData;  // an unknown progression and no POC
      pocs.push_back({0, 0, tcp.numlayers, maxres, nc, tcp.prg});
    }
    const uint8_t* cur = tcp.data.data();
    const uint8_t* end = cur + tcp.data.size();
    auto visit = [&](int layno, int resno, int compno, int precno) -> int {
      const int64_t idx = layno * step_l + resno * step_r + compno * step_c + precno;
      if (idx >= total || include[idx]) return 1;
      include[idx] = 1;
      const int rc = read_packet(tcs, tcp, compno, resno, precno, layno, cur, end, hdrbuf, hdrpos);
      if (rc >= 0) resno_decoded[compno] = std::max(resno_decoded[compno], resno);
      return rc;
    };
    for (const Poc& poc : pocs) {
      const int lay1 = std::min(poc.layno1, tcp.numlayers);
      const int res0 = poc.resno0, res1 = poc.resno1, c0 = poc.compno0, c1 = std::min(poc.compno1, nc);
      int rc;
      if (poc.prg == 0 || poc.prg == 1) {  // LRCP, RLCP
        for (int a = 0; a < (poc.prg == 0 ? lay1 : res1); ++a) {
          if (poc.prg == 1 && a < res0) continue;
          for (int b = (poc.prg == 0 ? res0 : 0); b < (poc.prg == 0 ? res1 : lay1); ++b) {
            const int layno = poc.prg == 0 ? a : b, resno = poc.prg == 0 ? b : a;
            for (int c = c0; c < c1; ++c) {
              if (resno >= tcs[c].numres) continue;
              const Resolution& res = tcs[c].res[resno];
              for (int p = 0; p < res.pw * res.ph; ++p)
                if ((rc = visit(layno, resno, c, p)) < 0) return rc;
            }
          }
        }
        continue;
      }
      // position-driven orders: RPCL (2), PCRL (3), CPRL (4)
      auto step_of = [&](int c, bool ydir) -> int64_t {
        int64_t d = 0;
        const TileComp& tc = tcs[c];
        for (int r = 0; r < tc.numres; ++r) {
          const int sh = (ydir ? tc.res[r].pdy : tc.res[r].pdx) + tc.numres - 1 - r;
          if (sh >= 32) continue;
          const int64_t v = int64_t(ydir ? img.comps[c].dy : img.comps[c].dx) << sh;
          d = d == 0 ? v : std::min(d, v);
        }
        return d;
      };
      auto packet_at = [&](int c, int resno, int64_t x, int64_t y, int& precno) -> bool {
        const TileComp& tc = tcs[c];
        if (resno >= tc.numres) return false;
        const Resolution& res = tc.res[resno];
        const int levelno = tc.numres - 1 - resno;
        const int64_t cdx = int64_t(img.comps[c].dx) << levelno, cdy = int64_t(img.comps[c].dy) << levelno;
        const int64_t trx0 = ceil_div(tx0, cdx), try0 = ceil_div(ty0, cdy);
        const int64_t trx1 = ceil_div(tx1, cdx), try1 = ceil_div(ty1, cdy);
        const int rpx = res.pdx + levelno, rpy = res.pdy + levelno;
        if (rpx >= 31 || rpy >= 31) return false;
        if (!((y % (int64_t(img.comps[c].dy) << rpy) == 0) ||
              (y == ty0 && ((try0 << levelno) % (int64_t(1) << rpy)))))
          return false;
        if (!((x % (int64_t(img.comps[c].dx) << rpx) == 0) ||
              (x == tx0 && ((trx0 << levelno) % (int64_t(1) << rpx)))))
          return false;
        if (res.pw == 0 || res.ph == 0) return false;
        if (trx0 == trx1 || try0 == try1) return false;
        const int64_t prci = floor_div_pow2(ceil_div(x, cdx), res.pdx) - floor_div_pow2(trx0, res.pdx);
        const int64_t prcj = floor_div_pow2(ceil_div(y, cdy), res.pdy) - floor_div_pow2(try0, res.pdy);
        precno = int(prci + prcj * res.pw);
        return true;
      };
      if (poc.prg == 2 || poc.prg == 3) {
        int64_t dx = 0, dy = 0;
        for (int c = 0; c < nc; ++c) {
          const int64_t a = step_of(c, false), b = step_of(c, true);
          if (a) dx = dx == 0 ? a : std::min(dx, a);
          if (b) dy = dy == 0 ? b : std::min(dy, b);
        }
        if (dx == 0 || dy == 0) return kBadData;
        if (poc.prg == 2) {  // RPCL
          for (int resno = res0; resno < res1; ++resno)
            for (int64_t y = ty0; y < ty1; y += dy - (y % dy))
              for (int64_t x = tx0; x < tx1; x += dx - (x % dx))
                for (int c = c0; c < c1; ++c) {
                  int precno;
                  if (!packet_at(c, resno, x, y, precno)) continue;
                  for (int l = 0; l < lay1; ++l)
                    if ((rc = visit(l, resno, c, precno)) < 0) return rc;
                }
        } else {  // PCRL
          for (int64_t y = ty0; y < ty1; y += dy - (y % dy))
            for (int64_t x = tx0; x < tx1; x += dx - (x % dx))
              for (int c = c0; c < c1; ++c)
                for (int resno = res0; resno < res1; ++resno) {
                  int precno;
                  if (!packet_at(c, resno, x, y, precno)) continue;
                  for (int l = 0; l < lay1; ++l)
                    if ((rc = visit(l, resno, c, precno)) < 0) return rc;
                }
        }
      } else {  // CPRL
        for (int c = c0; c < c1; ++c) {
          const int64_t dx = step_of(c, false), dy = step_of(c, true);
          if (dx == 0 || dy == 0) return kBadData;
          for (int64_t y = ty0; y < ty1; y += dy - (y % dy))
            for (int64_t x = tx0; x < tx1; x += dx - (x % dx))
              for (int resno = res0; resno < res1; ++resno) {
                int precno;
                if (!packet_at(c, resno, x, y, precno)) continue;
                for (int l = 0; l < lay1; ++l)
                  if ((rc = visit(l, resno, c, precno)) < 0) return rc;
              }
        }
      }
    }
    return kOk;
  }

  int decode_tile(int t, int32_t* out, int64_t cap, int64_t& used) {
    Tcp& tcp = tcps[t];
    int64_t tx0, ty0, tx1, ty1;
    tile_rect(t, tx0, ty0, tx1, ty1);
    const int nc = img.ncomp;
    std::vector<TileComp> tcs(nc);
    for (int c = 0; c < nc; ++c) {
      int rc = init_tilecomp(tcs[c], tcp.tccps[c], img.comps[c], tx0, ty0, tx1, ty1);
      if (rc) return rc;
    }
    std::vector<uint8_t> ppt;
    const std::vector<uint8_t>* hdrbuf = nullptr;
    int64_t ppt_pos = 0;
    int rc;
    if (has_ppm) {
      rc = decode_packets(tcs, tcp, tx0, ty0, tx1, ty1, &ppm, ppm_pos);
    } else if (tcp.has_ppt) {
      for (auto& part : tcp.ppt_parts) ppt.insert(ppt.end(), part.begin(), part.end());
      hdrbuf = &ppt;
      rc = decode_packets(tcs, tcp, tx0, ty0, tx1, ty1, hdrbuf, ppt_pos);
    } else {
      rc = decode_packets(tcs, tcp, tx0, ty0, tx1, ty1, nullptr, ppt_pos);
    }
    if (rc) return rc;
    // tier 1, dequantisation, inverse DWT
    T1 t1;
    for (int c = 0; c < nc; ++c) {
      TileComp& tc = tcs[c];
      const Tccp& tccp = tcp.tccps[c];
      const int W = tc.x1 - tc.x0, H = tc.y1 - tc.y0;
      const bool rev = tccp.qmfbid == 1;
      if (rev)
        tc.idata.assign(size_t(W) * H, 0);
      else
        tc.fdata.assign(size_t(W) * H, 0.f);
      for (int r = 0; r < tc.numres; ++r) {
        Resolution& res = tc.res[r];
        for (Band& band : res.bands) {
          if (band.empty()) continue;
          int offx = 0, offy = 0;
          if (band.bandno & 1) offx = tc.res[r - 1].x1 - tc.res[r - 1].x0;
          if (band.bandno & 2) offy = tc.res[r - 1].y1 - tc.res[r - 1].y0;
          const float step = 0.5f * band.stepsize;
          for (Precinct& prc : band.precincts)
            for (Cblk& cb : prc.cblks) {
              if (cb.x1 <= cb.x0 || cb.y1 <= cb.y0) continue;
              // opj_t1_decode_cblk fails every code-block past 30 bit-planes (a never included one counts 0)
              if (tccp.roishift + cb.numbps >= 31) return kBadData;
              if (cb.numsegs == 0) continue;
              t1.decode(cb, band.bandno, tccp.roishift, tccp.cblksty);
              const int bw = cb.x1 - cb.x0, bh = cb.y1 - cb.y0;
              const int ox = cb.x0 - band.x0 + offx, oy = cb.y0 - band.y0 + offy;
              for (int y = 0; y < bh; ++y)
                for (int x = 0; x < bw; ++x) {
                  const int32_t v = t1.data[size_t(y) * bw + x];
                  const size_t at = size_t(oy + y) * W + (ox + x);
                  if (rev)
                    tc.idata[at] = v / 2;
                  else
                    tc.fdata[at] = float(v) * step;
                }
              std::vector<uint8_t>().swap(cb.data);
            }
        }
      }
      // the inverse DWT up to the highest resolution a packet reached (opj_tcd_dwt_decode)
      const int nres = std::min(resno_decoded[c], tc.numres - 1) + 1;
      if (W > 0 && H > 0) {
        if (rev) {
          std::vector<int32_t> tmp;
          idwt_2d(tc.idata.data(), W, tc, nres,
                  [&tmp](int32_t* x, int len, int cas) { idwt53_line(x, len, cas, tmp); });
        } else {
          idwt_2d(tc.fdata.data(), W, tc, nres, [](float* x, int len, int cas) { idwt97_line(x, len, cas); });
        }
      }
    }
    // multiple component transform
    if (tcp.mct == 1 && nc >= 3) {
      const size_t s0 = tcs[0].idata.size() + tcs[0].fdata.size();
      for (int c = 1; c < 3; ++c)
        if (tcs[c].idata.size() + tcs[c].fdata.size() != s0 || tcp.tccps[c].qmfbid != tcp.tccps[0].qmfbid)
          return kBadData;
      if (tcp.tccps[0].qmfbid == 1) {
        int32_t *c0 = tcs[0].idata.data(), *c1 = tcs[1].idata.data(), *c2 = tcs[2].idata.data();
        for (size_t i = 0; i < s0; ++i) {
          const int32_t y = c0[i], u = c1[i], v = c2[i];
          const int32_t g = y - ((u + v) >> 2);
          c0[i] = v + g;
          c1[i] = g;
          c2[i] = u + g;
        }
      } else {
        ict(tcs[0].fdata.data(), tcs[1].fdata.data(), tcs[2].fdata.data(), s0);
      }
    }
    // DC level shift, clamp, output
    const int64_t need = 4 + int64_t(nc) * 2;
    if (used + need > cap) return kNoSpace;
    out[used++] = int32_t(tx0);
    out[used++] = int32_t(ty0);
    out[used++] = int32_t(tx1);
    out[used++] = int32_t(ty1);
    // of each component the resolution the inverse DWT reached, which OpenJPEG hands on as the tile
    // (opj_tcd_update_tile_data): the top-left W x H samples of the full-size buffer of stride S
    for (int c = 0; c < nc; ++c) {
      TileComp& tc = tcs[c];
      const Comp& comp = img.comps[c];
      const int S = tc.x1 - tc.x0;
      const Resolution& top = tc.res[std::min(resno_decoded[c], tc.numres - 1)];
      const int W = top.x1 - top.x0, H = top.y1 - top.y0;
      if (used + 2 + int64_t(W) * H > cap) return kNoSpace;
      out[used++] = W;
      out[used++] = H;
      const int64_t lo = comp.sgnd ? -(int64_t(1) << (comp.prec - 1)) : 0;
      const int64_t hi = comp.sgnd ? (int64_t(1) << (comp.prec - 1)) - 1 : (int64_t(1) << comp.prec) - 1;
      const int64_t shift = comp.sgnd ? 0 : (int64_t(1) << (comp.prec - 1));
      const size_t cnt = size_t(W) * H;
      auto at = [&](size_t i) { return (i / size_t(W)) * size_t(S) + i % size_t(W); };
      if (tcp.tccps[c].qmfbid == 1) {
        for (size_t i = 0; i < cnt; ++i)
          out[used + int64_t(i)] = int32_t(std::clamp(tc.idata[at(i)] + shift, lo, hi));
      } else {
        for (size_t i = 0; i < cnt; ++i) {
          const float v = tc.fdata[at(i)];
          int64_t q;
          if (v > float(INT32_MAX))
            q = hi;
          else if (v < float(INT32_MIN))
            q = lo;
          else
            q = std::clamp(int64_t(std::lrintf(v)) + shift, lo, hi);
          out[used + int64_t(i)] = int32_t(q);
        }
      }
      used += int64_t(cnt);
    }
    return kOk;
  }

  __attribute__((optimize("fp-contract=off"))) static void ict(float* c0, float* c1, float* c2, size_t n) {
    for (size_t i = 0; i < n; ++i) {
      const float y = c0[i], u = c1[i], v = c2[i];
      const float vr = v * 1.402f;
      const float r = y + vr;
      const float ug = u * 0.34413f, vg = v * 0.71414f;
      const float g = (y - ug) - vg;
      const float ub = u * 1.772f;
      const float b = y + ub;
      c0[i] = r;
      c1[i] = g;
      c2[i] = b;
    }
  }
};

}  // namespace

extern "C" {

int vkgr_j2k_decode(const uint8_t* cs, int64_t n, int32_t* out, int64_t cap, int64_t* used) {
  Decoder d;
  d.cs = cs;
  d.n = n;
  *used = 0;
  int rc = d.parse();
  if (rc) return rc;
  d.resno_decoded.assign(size_t(d.img.ncomp), 0);
  int64_t u = 0;
  for (int t : d.order) {
    rc = d.decode_tile(t, out, cap, u);
    if (rc) return rc;
  }
  *used = u;
  return 0;
}

}  // extern "C"
