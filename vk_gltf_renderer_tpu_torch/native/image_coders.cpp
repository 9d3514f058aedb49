// Byte-stream coders of the port's BMP, TGA, GIF and TIFF readers and its
// GIF writer (ops/bmp.py, ops/tga.py, ops/gif.py, ops/tiff.py): the loops
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
//   vkgr_tga_rle        Pillow's TgaRleDecode.c (packets cross scan lines).
//
// Exported C ABI: every function returns 0 on success and < 0 on corrupt
// or short data (the Python side raises ValueError).
//
// Build: g++ -O2 -shared -fPIC -std=c++17

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
// short, as libtiff discards it). -1: the data end first.
int vkgr_packbits(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
  int64_t pos = 0, out = 0;
  while (out < cap) {
    if (pos >= n) return -1;
    int b = int8_t(src[pos++]);
    if (b >= 0) {
      int64_t cnt = b + 1;
      if (pos + cnt > n) {
        int64_t have = n - pos;
        int64_t t = have < cap - out ? have : cap - out;
        std::memcpy(dst + out, src + pos, t);
        return -1;
      }
      int64_t t = cnt < cap - out ? cnt : cap - out;
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

}  // extern "C"
