"""JPEG 2000 reading without Pillow (raw J2K codestreams and JP2 files,
Part 1), as Pillow's Jpeg2KImagePlugin opens a file and its OpenJPEG
decoder (decode_jpeg2k.c over OpenJPEG 2.5) loads it:

  * identification as Pillow's accept: the codestream's SOC and SIZ
    markers (FF 4F FF 51), or the 12-byte JP2 signature box;
  * the mode and size as Pillow's open finds them: from SIZ for a
    codestream (one component "L", or "I;16" past 8 bits; 2 "LA", 3 "RGB",
    4 "RGBA"), from the JP2 header box for a file (ihdr the same way, a
    colr of CMYK (12) makes four components "CMYK", a pclr of at most
    8-bit entries makes "L" "P" and "LA" "PA", its palette built as
    ImagePalette.getcolor builds it); Pillow's header checks raise PassOn
    where its open lets the next plugin try;
  * the JP2 boxes as OpenJPEG walks them (jP, ftyp, jp2h with ihdr, colr,
    bpcc, pclr, cmap, cdef, res, then jp2c; XL lengths, a last box of
    length 0); the colour space from the first colr's enumerated space (16
    sRGB, 17 gray, 18 sYCC, 24 e-sYCC, 12 CMYK), unknown without one or for
    an ICC profile, unspecified for a raw codestream;
  * the codestream in native/j2k_decode.cpp (built at first use; a failed
    build raises), tile by tile, each tile's components packed as
    OpenJPEG hands them to Pillow (1, 2 or 4 bytes a sample by precision,
    truncated);
  * Pillow's unpacker chosen by mode, colour space (guessed from the
    component count and the first subsampled component where unspecified
    or unknown)
    and component count, and run as decode_jpeg2k.c runs it: the
    precision shift to 8 bits (16 for "I;16") with its rounding offset,
    the signed offset, the stores truncated to the mode's bytes, sYCC
    through ops/imagemodes.ycbcr_to_rgb; OpenJPEG's tile-wise decoding
    applies no palette, component mapping or channel definition, so
    neither does this reader (a pclr image's pixels are the codestream's
    indices into Pillow's palette);
  * then Image.convert("RGBA") (ops/imagemodes.to_rgba).

Part 15 (HT code-blocks, the CAP marker) is refused (ROADMAP A).
"""

from __future__ import annotations

import struct

import numpy as np

from .imagemodes import PassOn, check_size, to_rgba, ycbcr_to_rgb

J2K_MAGIC = b"\xff\x4f\xff\x51"
JP2_MAGIC = b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"

# OpenJPEG's OPJ_COLOR_SPACE
UNKNOWN, UNSPECIFIED, SRGB, GRAY, SYCC, EYCC, CMYK = -1, 0, 1, 2, 3, 4, 5
_ENUMCS = {16: SRGB, 17: GRAY, 18: SYCC, 24: EYCC, 12: CMYK}


def is_jpeg2000(data: bytes) -> bool:
    return data[:4] == J2K_MAGIC or data[:12] == JP2_MAGIC


def _lib():
    from ..native import j2k_lib

    return j2k_lib()


# ------------------------------------------------------------------ Pillow's open


def _siz(data: bytes, at: int):
    """_parse_codestream at `at` (after SOC and the SIZ marker): (size, mode, the SIZ segment's end)."""
    try:
        lsiz = struct.unpack_from(">H", data, at)[0]
        siz = data[at : at + lsiz]
        _, _, xsiz, ysiz, xosiz, yosiz, _, _, _, _, csiz = struct.unpack_from(">HHIIIIIIIIH", siz)
        if csiz == 1:
            mode = "I;16" if (struct.unpack_from(">B", siz, 38)[0] & 0x7F) + 1 > 8 else "L"
        else:
            mode = {2: "LA", 3: "RGB", 4: "RGBA"}.get(csiz)
    except struct.error as e:
        raise PassOn(f"JPEG 2000: short SIZ ({e})") from e
    if mode is None:
        raise PassOn("unable to determine J2K image mode")
    return (xsiz - xosiz, ysiz - yosiz), mode, at + max(lsiz, 2)


def _parse_comment(data: bytes, pos: int) -> None:
    """Jpeg2KImageFile._parse_comment: the marker segments after SIZ up to
    SOT, EOC or a COM (a short length field fails Pillow's open)."""
    for _ in range(1 << 16):
        marker = data[pos : pos + 2]
        pos += len(marker)
        if not marker:
            return
        if len(marker) < 2:
            raise PassOn("JPEG 2000: short marker")
        if marker[1] in (0x90, 0xD9):
            return
        hdr = data[pos : pos + 2]
        pos += len(hdr)
        if len(hdr) < 2:
            raise PassOn("JPEG 2000: short marker segment")
        length = (hdr[0] << 8) | hdr[1]
        if marker[1] == 0x64:
            return
        pos = max(pos + length - 2, 0)


class _Boxes:
    """Pillow's BoxReader over data[start:end] (end None: no length)."""

    def __init__(self, data: bytes, start: int, end: int | None):
        self.data, self.pos, self.end, self.remaining = data, start, end, -1

    def _can_read(self, n: int) -> bool:
        if self.end is not None and self.pos + n > self.end:
            return False
        return n <= self.remaining if self.remaining >= 0 else True

    def read(self, fmt: str):
        n = struct.calcsize(fmt)
        if not self._can_read(n):
            raise PassOn("Not enough data in header")
        if self.pos + n > len(self.data):
            raise ValueError("JPEG 2000: header box past the end of the file")  # Pillow's OSError
        v = struct.unpack_from(fmt, self.data, self.pos)
        self.pos += n
        if self.remaining > 0:
            self.remaining -= n
        return v

    def sub(self) -> _Boxes:
        n = self.remaining
        if not self._can_read(n):
            raise PassOn("Not enough data in header")
        if self.pos + n > len(self.data):
            raise ValueError("JPEG 2000: header box past the end of the file")
        start = self.pos
        self.pos += n
        if self.remaining > 0:
            self.remaining -= n
        return _Boxes(self.data[start : start + n], 0, n)

    def has_next(self) -> bool:
        return self.pos + self.remaining < self.end if self.end is not None else True

    def next_type(self) -> bytes:
        if self.remaining > 0:
            self.pos += self.remaining
        self.remaining = -1
        lbox, tbox = self.read(">I4s")
        hlen = 8
        if lbox == 1:
            lbox, hlen = self.read(">Q")[0], 16
        if lbox < hlen or not self._can_read(lbox - hlen):
            raise PassOn("Invalid header length")
        self.remaining = lbox - hlen
        return tbox


def _pillow_palette(entries, npc: int):
    """ImagePalette.getcolor over the pclr entries: (palette mode, bytes)."""
    mode = "RGBA" if npc == 4 else "RGB"
    ml, colors, pal = len(mode), {}, bytearray()
    for c in entries:
        if mode == "RGB" and len(c) == 4:
            if c[3] != 255:
                raise ValueError("cannot add non-opaque RGBA color to RGB palette")
            c = c[:3]
        if c in colors:
            continue
        index = len(pal) // ml
        if index >= 256:
            raise ValueError("cannot allocate more than 256 colors")
        colors[c] = index
        if index * ml < len(pal):
            pal = pal[: index * ml] + bytes(c) + pal[index * ml + ml :]
        else:
            pal += bytes(c)
    return mode, bytes(pal)


def _jp2_header(data: bytes):
    """_parse_jp2_header after the signature box: (size, mode, palette or
    None, the position after jp2h)."""
    reader = _Boxes(data, 12, None)
    header = None
    while reader.has_next():
        tbox = reader.next_type()
        if tbox == b"jp2h":
            header = reader.sub()
            break
        if tbox == b"ftyp":
            reader.read(">4s")
    if header is None:
        raise ValueError("JPEG 2000: no jp2h box")
    size = mode = nc = palette = None
    while header.has_next():
        tbox = header.next_type()
        if tbox == b"ihdr":
            height, width, nc, bpc = header.read(">IIHB")
            size = (width, height)
            if nc == 1 and (bpc & 0x7F) > 8:
                mode = "I;16"
            else:
                mode = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}.get(nc, mode)
        elif tbox == b"colr" and nc == 4:
            meth, _, _, enumcs = header.read(">BBBI")
            if meth == 1 and enumcs == 12:
                mode = "CMYK"
        elif tbox == b"pclr" and mode in ("L", "LA"):
            ne, npc = header.read(">HB")
            depths = header.read(">" + "B" * npc)
            if max((0, *depths)) <= 8:
                palette = _pillow_palette([tuple(header.read(">" + "B" * npc)) for _ in range(ne)], npc)
                mode = "P" if mode == "L" else "PA"
        elif tbox == b"res ":
            res = header.sub()
            while res.has_next():
                if res.next_type() == b"resc":
                    res.read(">HHHHBB")
                    break
    if size is None or mode is None:
        raise PassOn("Malformed JP2 header")
    return size, mode, palette, reader.pos


def _open(data: bytes):
    """Jpeg2KImageFile._open: (codec, size, mode, palette)."""
    if data[:4] == J2K_MAGIC:
        size, mode, end = _siz(data, 4)
        _parse_comment(data, end)
        return "j2k", size, mode, None
    if data[:12] != JP2_MAGIC:
        raise PassOn("not a JPEG 2000 file")
    size, mode, palette, pos = _jp2_header(data)
    if data[pos : pos + 12].endswith(b"jp2c\xff\x4f\xff\x51") and len(data) >= pos + 14:
        length = (data[pos + 12] << 8) | data[pos + 13]
        _parse_comment(data, pos + 12 + length)
    return "jp2", size, mode, palette


# ------------------------------------------------------------------ OpenJPEG's JP2 reader


def _walk(data: bytes):
    """OpenJPEG's box headers over data: (type, body start, body end) of
    each box (an XL length, or 0: to the end; a jp2c box may run past
    the end)."""
    pos, n = 0, len(data)
    while pos + 8 <= n:
        lbox, tbox = struct.unpack_from(">I4s", data, pos)
        hlen = 8
        if lbox == 1:
            if pos + 16 > n:
                raise ValueError("JPEG 2000: short box header")
            lbox, hlen = struct.unpack_from(">Q", data, pos + 8)[0], 16
        elif lbox == 0:
            lbox = n - pos
        if lbox < hlen or (pos + lbox > n and tbox != b"jp2c"):
            raise ValueError("JPEG 2000: bad box length")
        yield tbox, pos + hlen, min(pos + lbox, n)
        pos += lbox


def _jp2h(body: bytes):
    """opj_jp2_read_jp2h's checks of the header box: (ihdr's height and
    width, the first colr's enumerated space or 0)."""
    ihdr, nc, enumcs, npc, seen = None, 0, 0, None, set()
    for sub, a, b in _walk(body):
        size, sb = b - a, body[a:b]
        if sub == b"ihdr":
            if size != 14 or not 1 <= struct.unpack_from(">H", sb, 8)[0] <= 16384:
                raise ValueError("JPEG 2000: bad ihdr box")
            ihdr, nc = struct.unpack_from(">II", sb), struct.unpack_from(">H", sb, 8)[0]
        elif sub == b"colr" and "colr" not in seen:
            if size < 3 or (sb[0] == 1 and size < 7):
                raise ValueError("JPEG 2000: bad colr box")
            enumcs = struct.unpack_from(">I", sb, 3)[0] if sb[0] == 1 else 0
        elif sub == b"bpcc" and size != nc:
            raise ValueError("JPEG 2000: bad bpcc box")
        elif sub == b"pclr":
            ne, npc = struct.unpack_from(">HB", sb) if size >= 3 else (0, 0)
            if "pclr" in seen or not 1 <= ne <= 1024 or npc == 0 or size < 3 + npc:
                raise ValueError("JPEG 2000: bad pclr box")
            if size < 3 + npc + ne * sum(min(((d & 0x7F) + 8) >> 3, 4) for d in sb[3 : 3 + npc]):
                raise ValueError("JPEG 2000: short pclr box")
        elif sub == b"cmap":
            if npc is None or "cmap" in seen or size < 4 * npc:
                raise ValueError("JPEG 2000: bad cmap box")
        elif sub == b"cdef":
            count = struct.unpack_from(">H", sb)[0] if size >= 2 else 0
            if "cdef" in seen or count == 0 or size < 2 + 6 * count:
                raise ValueError("JPEG 2000: bad cdef box")
        seen.add(sub.decode("latin-1"))
    if ihdr is None:
        raise ValueError("JPEG 2000: no ihdr box")
    return ihdr, enumcs


def _jp2_boxes(data: bytes):
    """OpenJPEG's walk of a JP2 file's boxes: (colour space, the
    codestream). The signature box comes first and the file type box
    second; the header box's boxes pass opj_jp2_read_jp2h's checks and
    its ihdr gives the codestream's size; the first colr names the colour
    space; the codestream runs from jp2c to the end of the file, whatever
    the box's length."""
    header = None
    for k, (tbox, a, b) in enumerate(_walk(data)):
        if k < 2 and tbox != (b"jP  ", b"ftyp")[k]:
            raise ValueError("JPEG 2000: the signature box first, then the file type box")
        if tbox == b"jp2h":
            header = _jp2h(data[a:b])
        elif tbox == b"jp2c":
            if header is None:
                raise ValueError("JPEG 2000: JP2H box missing")
            (height, width), enumcs = header
            try:  # opj_j2k_read_siz: the codestream's size is ihdr's
                xsiz, ysiz, xo, yo = struct.unpack_from(">IIII", data, a + 8)
            except struct.error as e:
                raise ValueError(f"JPEG 2000: short SIZ ({e})") from e
            if (height, width) != (ysiz - yo, xsiz - xo):
                raise ValueError("JPEG 2000: ihdr and SIZ disagree")
            return _ENUMCS.get(enumcs, UNKNOWN), data[a:]
    raise ValueError("JPEG 2000: no codestream box")


# ------------------------------------------------------------------ decoding and Pillow's unpackers


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _tiles(cs: bytes):
    """The codestream through native/j2k_decode.cpp: (components [(prec,
    sgnd, dx, dy)], image origin, tiles [(x0, y0, x1, y1, [component
    int32 [h, w]])])."""
    if len(cs) < 4 or cs[:4] != J2K_MAGIC:
        raise ValueError("JPEG 2000: no codestream")
    try:
        lsiz = struct.unpack_from(">H", cs, 4)[0]
        _, xsiz, ysiz, xo, yo, xt, yt, xto, yto, csiz = struct.unpack_from(">HIIIIIIIIH", cs, 6)
        comps = [struct.unpack_from(">BBB", cs, 42 + 3 * i) for i in range(min(csiz, 5))]
    except struct.error as e:
        raise ValueError(f"JPEG 2000: short SIZ ({e})") from e
    if not 1 <= csiz <= 4 or lsiz < 38 + 3 * csiz or any(dx == 0 or dy == 0 for _, dx, dy in comps):
        raise ValueError("JPEG 2000: bad SIZ, or more components than Pillow unpacks")
    if xsiz <= xo or ysiz <= yo or xt == 0 or yt == 0 or xto > xo or yto > yo:
        raise ValueError("JPEG 2000: bad image or tile geometry")
    check_size("JPEG 2000", xsiz - xo, ysiz - yo)
    comps = [((s & 0x7F) + 1, s >> 7, dx, dy) for s, dx, dy in comps]
    tiles = _cdiv(xsiz - xto, xt) * _cdiv(ysiz - yto, yt)
    if tiles > 65535:
        raise ValueError("JPEG 2000: too many tiles")
    # each tile's rectangle and component sizes, then the samples: the tiles partition each component
    cap = tiles * (4 + 2 * csiz) + sum((_cdiv(xsiz, dx) - _cdiv(xo, dx)) * (_cdiv(ysiz, dy) - _cdiv(yo, dy))
                                       for _, _, dx, dy in comps)
    src = np.frombuffer(cs, np.uint8)
    out = np.empty(cap, np.int32)
    used = np.zeros(1, np.int64)
    rc = _lib().vkgr_j2k_decode(src.ctypes.data, len(src), out.ctypes.data, cap, used.ctypes.data)
    if rc == -2:
        raise ValueError("JPEG 2000: Part 15 (HT) code-blocks are not supported")
    if rc != 0:
        raise ValueError(f"JPEG 2000: corrupt or truncated codestream (rc {rc})")
    tiles, pos, end = [], 0, int(used[0])
    while pos < end:
        x0, y0, x1, y1 = (int(v) for v in out[pos : pos + 4])
        pos += 4
        planes = []
        for _ in comps:
            w, h = int(out[pos]), int(out[pos + 1])
            planes.append(out[pos + 2 : pos + 2 + w * h].reshape(h, w))
            pos += 2 + w * h
        tiles.append((x0, y0, x1, y1, planes))
    return comps, (xo, yo), tiles


def _csiz(prec: int) -> int:
    c = (prec + 7) >> 3
    return 4 if c == 3 else c


def _tile_bytes(comps, planes) -> bytes:
    """OpenJPEG's tile data: each component's samples truncated to 1, 2 or 4 bytes."""
    parts = []
    for (prec, _, _, _), p in zip(comps, planes):
        parts.append(p.astype({1: "<u1", 2: "<u2", 4: "<u4"}[_csiz(prec)], casting="unsafe").tobytes())
    return b"".join(parts)


def _shifted(words: np.ndarray, prec: int, sgnd: int, bits: int) -> np.ndarray:
    """j2ku_shift(offset + word, shift) for a mode of `bits` bits (8, or 16 for "I;16"), as stored."""
    shift = bits - prec
    offset = (1 << (prec - 1)) if sgnd else 0
    if shift < 0:
        offset += 1 << (-shift - 1)
    v = (words.astype(np.uint64) + np.uint64(offset)) & np.uint64(0xFFFFFFFF)
    v = (v << np.uint64(shift)) & np.uint64(0xFFFFFFFF) if shift >= 0 else v >> np.uint64(-shift)
    return (v & np.uint64((1 << bits) - 1)).astype(np.uint16 if bits == 16 else np.uint8)


def _words(buf: bytes, at: int, csiz: int, count: int) -> np.ndarray:
    """count samples of csiz bytes from buf at `at`; the bytes past the data
    read as zeros (Pillow's buffer is at least its tile size)."""
    need = at + csiz * count
    if need > len(buf):
        buf = buf + bytes(need - len(buf))
    return np.frombuffer(buf, {1: "<u1", 2: "<u2", 4: "<u4"}[csiz], count, at)


# (mode, colour space, components) -> (unpacker, takes subsampled components)
_UNPACKERS = {
    ("L", GRAY, 1): ("gray_l", False), ("P", SRGB, 1): ("gray_l", False), ("PA", SRGB, 2): ("graya_la", False),
    ("I;16", GRAY, 1): ("gray_i", False), ("LA", GRAY, 2): ("graya_la", False),
    ("RGB", GRAY, 1): ("gray_rgb", False), ("RGB", GRAY, 2): ("gray_rgb", False),
    ("RGB", SRGB, 3): ("srgb_rgb", True), ("RGB", SYCC, 3): ("sycc_rgb", True),
    ("RGB", SRGB, 4): ("srgb_rgb", True), ("RGB", SYCC, 4): ("sycc_rgb", True),
    ("RGBA", GRAY, 1): ("gray_rgb", False), ("RGBA", GRAY, 2): ("graya_la", False),
    ("RGBA", SRGB, 3): ("srgb_rgb", True), ("RGBA", SYCC, 3): ("sycc_rgb", True),
    ("RGBA", SRGB, 4): ("srgba_rgba", True), ("RGBA", SYCC, 4): ("sycca_rgba", True),
    ("CMYK", CMYK, 4): ("srgba_rgba", True),
}


def _unpack(kind: str, comps, buf: bytes, w: int, h: int) -> np.ndarray:
    """One tile through decode_jpeg2k.c's unpacker: [h, w] (gray_l) or
    [h, w, 4] bytes as Pillow stores them, or [h, w] uint16 (gray_i)."""
    if kind in ("gray_l", "gray_i", "gray_rgb"):
        prec, sgnd = comps[0][0], comps[0][1]
        v = _shifted(_words(buf, 0, _csiz(prec), w * h), prec, sgnd, 16 if kind == "gray_i" else 8).reshape(h, w)
        if kind != "gray_rgb":
            return v
        out = np.empty((h, w, 4), np.uint8)
        out[..., :3] = v[..., None]
        out[..., 3] = 255
        return out
    if kind == "graya_la":
        (p0, s0, _, _), (p1, s1, _, _) = comps[0], comps[1]
        c0 = _csiz(p0)
        out = np.empty((h, w, 4), np.uint8)
        out[..., :3] = _shifted(_words(buf, 0, c0, w * h), p0, s0, 8).reshape(h, w)[..., None]
        out[..., 3] = _shifted(_words(buf, c0 * w * h, _csiz(p1), w * h), p1, s1, 8).reshape(h, w)
        return out
    n = 4 if kind in ("srgba_rgba", "sycca_rgba") else 3
    out = np.empty((h, w, 4), np.uint8)
    out[..., 3] = 255
    # Pillow's buffer holds at least w * h samples of every component: a subsampled component is read with
    # the floor of w / dx and h / dy for its size, so the reads shift across the data OpenJPEG wrote (the
    # bytes past them read as zeros here)
    size = w * h * sum(_csiz(c[0]) for c in comps)
    buf = buf + bytes(max(size - len(buf), 0))
    at = 0
    ys, xs = np.arange(h), np.arange(w)
    for k in range(n):
        prec, sgnd, dx, dy = comps[k]
        cs = _csiz(prec)
        cw, ch = w // dx, h // dy
        words = np.frombuffer(buf, {1: "<u1", 2: "<u2", 4: "<u4"}[cs], (len(buf) - at) // cs, at)
        at += cs * cw * ch
        idx = (ys // dy)[:, None] * cw + (xs // dx)[None, :]
        out[..., k] = _shifted(words[idx], prec, sgnd, 8)
    if kind in ("sycc_rgb", "sycca_rgba"):
        out[..., :3] = ycbcr_to_rgb(out[..., :3])
    return out


def read_jpeg2000(data: bytes):
    """JPEG 2000 bytes -> (mode, pixels as Pillow stores the mode, palette)."""
    codec, (w, h), mode, palette = _open(data)
    check_size("JPEG 2000", w, h)
    if codec == "jp2":
        space, cs = _jp2_boxes(data)
    else:
        space, cs = UNSPECIFIED, data
    comps, (ox, oy), tiles = _tiles(cs)
    n = len(comps)
    if n < 1 or n > 4:
        raise ValueError("JPEG 2000: unsupported component count")
    sub = next((i for i, c in enumerate(comps) if c[2] != 1 or c[3] != 1), -1)
    if space in (UNSPECIFIED, UNKNOWN):  # no colr, an ICC profile, an enumerated space OpenJPEG does not know
        space = GRAY if n <= 2 else (SYCC if sub in (1, 2) else SRGB)
    kind = _UNPACKERS.get((mode, space, n))
    if kind is None or (sub != -1 and not kind[1]):
        raise ValueError(f"JPEG 2000: no unpacker for mode {mode}, colour space {space}, {n} components")
    kind = kind[0]
    if kind in ("gray_l",):
        img = np.zeros((h, w), np.uint8)
    elif kind == "gray_i":
        img = np.zeros((h, w), np.uint16)
    else:
        img = np.zeros((h, w, 4), np.uint8)
    for x0, y0, x1, y1, planes in tiles:
        tx, ty, tw, th = x0 - ox, y0 - oy, x1 - x0, y1 - y0
        if tx < 0 or ty < 0 or tx + tw > w or ty + th > h:
            raise ValueError("JPEG 2000: a tile outside the image")
        if tw <= 0 or th <= 0:
            continue
        img[ty : ty + th, tx : tx + tw] = _unpack(kind, comps, _tile_bytes(comps, planes), tw, th)
    return mode, img, palette


def decode_jpeg2000(data: bytes) -> np.ndarray:
    """JPEG 2000 bytes -> uint8 [H, W, 4], as Pillow's convert("RGBA")."""
    mode, img, palette = read_jpeg2000(data)
    if mode in ("LA", "PA"):
        px = img[..., [0, 3]]
    elif mode in ("RGB",):
        px = img[..., :3]
    else:
        px = img
    pal = None
    if palette is not None:
        pmode, raw = palette
        k = len(pmode)
        pal = np.frombuffer(raw[: len(raw) // k * k], np.uint8).reshape(-1, k) if len(raw) >= k else None
    return to_rgba(mode, px, pal)
