"""AVIF still images without Pillow, as Pillow's AvifImagePlugin reads them
through libavif 1.3.0 (with dav1d 1.5.1 under it for AV1, and libyuv for
the colour conversion).

  * Claiming: is_avif is Pillow's _accept (an ftyp box at byte 4 with the
    major brand avif, avis, mif1 or msf1). Data whose ftyp box lists
    neither avif nor avis (libavif's "invalid ftyp"), or that is too short
    or malformed for libavif's box parser, raise ops/imagemodes.PassOn, as
    Pillow's SyntaxError lets Image.open try the next plugin.
  * The HEIF boxes as libavif walks them: ftyp; meta with hdlr "pict",
    pitm, iinf/infe (versions 2 and 3), iloc (versions 0-2, construction
    methods 0 and 1 with idat), iref "auxl"; iprp/ipco/ipma with av1C,
    ispe, pixi, colr (nclx; an ICC profile, which does not change the
    pixels Pillow hands on), auxC (the alpha URN), irot, imir and clap,
    each refused where libavif's parser refuses it.
    Pillow does not turn the pixels for irot/imir (it writes them into the
    Exif orientation it hands on, which Image.open does not apply), and
    libavif does not crop to clap: the port does neither.
  * The AV1 data of the primary item (and of its alpha auxiliary item)
    decode through native/av1_decode.cpp: AV1 key frames as Pillow writes
    them, lossless (quality 100) and lossy, with the three loop filters
    aom's speeds and options turn on (deblocking, CDEF, and loop
    restoration: Wiener, self-guided and switchable). Quantiser matrices,
    segmentation, delta q/lf, superres, film grain, screen content tools,
    more than 8 bits, image sequences (the avis brand without an image
    item) and grid items raise UnsupportedCodec naming what is not ported
    (ROADMAP A).
  * YUV to RGB as libavif hands it to Pillow: libyuv's fixed-point
    I444/I422/I420/I400ToARGBMatrix rows (6-bit coefficients, the Y value
    scaled by 0x0101), with the matrix and range of the colr nclx box, or
    else of the sequence header (BT.601 where unspecified); 4:2:0 and 4:2:2
    chroma upsampled by libyuv's bilinear filter (its ScaleRowUp2 rows,
    libavif's AVIF_CHROMA_UPSAMPLING_AUTOMATIC); the identity matrix (GBR)
    copied plane by plane. The alpha item (a 4:0:0 AV1) becomes the fourth
    channel as it is (full range).
"""

from __future__ import annotations

import struct

import numpy as np

from .dds import UnsupportedCodec
from .imagemodes import PassOn, check_size

_BRANDS = (b"avif", b"avis", b"mif1", b"msf1")
_ALPHA_URNS = (b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha", b"urn:mpeg:hevc:2015:auxid:1")


def is_avif(data: bytes) -> bool:
    """Pillow's AvifImagePlugin._accept."""
    return data[4:8] == b"ftyp" and data[8:12] in _BRANDS


def _lib():
    from ..native import av1_lib

    return av1_lib()


def _fail(why: str):
    raise PassOn(f"AVIF: {why}")


def _box_at(data: bytes, pos: int, end: int):
    """(type, body start, body end) of the box at pos in data[:end]; a box
    that runs past end raises PassOn (libavif's BMFF parse failure)."""
    if end - pos < 8:
        _fail("a truncated box header")
    size, typ = struct.unpack_from(">I4s", data, pos)
    hdr = 8
    if size == 1:
        if end - pos < 16:
            _fail("a truncated box header")
        size = struct.unpack_from(">Q", data, pos + 8)[0]
        hdr = 16
    elif size == 0:
        size = end - pos
    if size < hdr or pos + size > end:
        _fail("a box past its container")
    return typ, pos + hdr, pos + size


def _boxes(data: bytes, start: int, end: int):
    """Every box in data[start:end], as _box_at reads each."""
    out = []
    while start < end:
        out.append(_box_at(data, start, end))
        start = out[-1][2]
    return out


def _top_boxes(data: bytes):
    """The top-level boxes up to the first meta box, where libavif's parse of
    a still image stops (the boxes after it, mdat among them, are not
    walked); a box past the end of the file before that fails, as does a
    second ftyp."""
    out = []
    pos = 0
    while pos < len(data):
        box = _box_at(data, pos, len(data))
        if box[0] == b"ftyp" and out:
            _fail("a second ftyp box")
        out.append(box)
        if box[0] == b"meta":
            break
        pos = box[2]
    return out


def _top_types(data: bytes) -> set:
    """The types of the top-level boxes as far as they can be walked."""
    types, pos = set(), 0
    while len(data) - pos >= 8:
        size, typ = struct.unpack_from(">I4s", data, pos)
        types.add(typ)
        if size < 8:
            break
        pos += size
    return types


class _Reader:
    """Big-endian fields of one box body; reading past it raises PassOn."""

    def __init__(self, data: bytes, start: int, end: int):
        self.data, self.pos, self.end = data, start, end

    def take(self, n: int) -> bytes:
        if self.pos + n > self.end:
            raise PassOn("AVIF: a truncated box")
        b = self.data[self.pos : self.pos + n]
        self.pos += n
        return b

    def uint(self, nbytes: int) -> int:
        return int.from_bytes(self.take(nbytes), "big") if nbytes else 0

    def full(self):
        v = self.uint(4)
        return v >> 24, v & 0xFFFFFF

    def cstring(self) -> bytes:
        i = self.data.find(b"\x00", self.pos, self.end)
        if i < 0:
            raise PassOn("AVIF: an unterminated string")
        s = self.data[self.pos : i]
        self.pos = i + 1
        return s


def _props(data: bytes, start: int, end: int):
    """The ipco box's properties [(type, fields)] as libavif parses each one
    (a malformed known property fails the file)."""
    out = []
    for typ, s, e in _boxes(data, start, end):
        r = _Reader(data, s, e)
        v = None
        if typ in (b"ispe", b"pixi", b"auxC"):
            if r.full()[0] != 0:
                _fail(f"a {typ.decode()} box of a version libavif does not read")
            if typ == b"ispe":
                v = (r.uint(4), r.uint(4))
            elif typ == b"pixi":
                n = r.uint(1)
                if n < 1 or n > 4:  # libavif's AVIF_RESULT_NOT_IMPLEMENTED: Pillow's open raises, tries no other plugin
                    raise ValueError(f"AVIF: a pixi box of {n} channels")
                v = tuple(r.uint(1) for _ in range(n))
            else:
                v = r.cstring()
        elif typ == b"av1C":
            marker = r.uint(1)
            if marker != 0x81:
                _fail("an av1C box without its marker and version 1")
            b1, b2 = r.uint(1), r.uint(1)
            r.uint(1)
            v = {"profile": b1 >> 5, "depth": 12 if b2 & 0x20 else 10 if b2 & 0x40 else 8}  # as libavif reads it
        elif typ == b"colr":
            kind = r.take(4)
            if kind == b"nclx":
                cp, tc, mc, last = r.uint(2), r.uint(2), r.uint(2), r.uint(1)
                if last & 0x7F:
                    _fail("a colr box with its reserved bits set")
                v = ("nclx", cp, tc, mc, last >> 7)
            elif kind in (b"rICC", b"prof"):
                v = ("icc", data[r.pos : e])
        elif typ in (b"irot", b"imir"):
            v = r.uint(1)
        elif typ == b"clap":
            v = tuple(r.uint(4) for _ in range(8))
        out.append((typ, v))
    return out


# the properties libavif keeps; of them, the transformative ones must be marked essential, a1lx must not be
_SUPPORTED = (b"ispe", b"auxC", b"colr", b"av1C", b"pasp", b"clap", b"irot", b"imir", b"pixi", b"a1op", b"lsel",
              b"a1lx", b"clli")
_ESSENTIAL = (b"a1op", b"lsel", b"clap", b"irot", b"imir")


def _parse(data: bytes):
    """The file's items as libavif 1.3.0 parses them: (items {id: {"type",
    "method", "extents", "props", "auxl", "skip"}}, primary id, idat).
    Where libavif's parser fails (BMFF parse failure, invalid ftyp), PassOn."""
    top = _top_boxes(data)
    if not top or top[0][0] != b"ftyp":
        _fail("no ftyp box first")
    _, s, e = top[0]
    r = _Reader(data, s, e)
    major = r.take(4)
    r.take(4)
    brands = {major}
    while r.pos + 4 <= e:
        brands.add(r.take(4))
    if not brands & {b"avif", b"avis", b"avio"}:
        _fail("the ftyp box lists no AVIF brand")
    # libavif's AVIF_DECODER_SOURCE_AUTO: the tracks of an avis major brand, or of a file that is neither avif nor
    # avis and has them, else the items
    if major == b"avis" or (major != b"avif" and b"moov" in _top_types(data)):
        raise UnsupportedCodec("AVIF: image sequences are not supported (ROADMAP A)")
    metas = [b for b in top if b[0] == b"meta"]
    if not metas:
        raise ValueError("AVIF: no meta box")
    _, s, e = metas[0]
    r = _Reader(data, s, e)
    if r.full()[0] != 0:
        _fail("a meta box of a version libavif does not read")
    children = _boxes(data, r.pos, e)
    if not children or children[0][0] != b"hdlr":
        _fail("a meta box whose first child is not hdlr")
    seen = [t for t, _, _ in children if t in (b"hdlr", b"iloc", b"pitm", b"idat", b"iprp", b"iinf", b"iref")]
    if len(seen) != len(set(seen)):
        _fail("a repeated box in meta")
    items, props, primary, idat = {}, [], None, b""

    def item(iid):
        if iid == 0:
            _fail("an item ID of 0")
        return items.setdefault(iid, {})

    for typ, bs, be in children:
        br = _Reader(data, bs, be)
        if typ == b"hdlr":
            if br.full()[0] != 0 or br.uint(4) != 0:
                _fail("a hdlr box of another version, or with pre_defined set")
            if br.take(4) != b"pict":
                _fail("the meta box's handler is not pict")
            br.take(12)
            br.cstring()
        elif typ == b"pitm":
            v, _ = br.full()
            primary = br.uint(2 if v == 0 else 4)
        elif typ == b"idat":
            idat = data[bs:be]
        elif typ == b"iinf":
            v, _ = br.full()
            if v > 1:
                _fail("an iinf box of a version libavif does not read")
            n = br.uint(2 if v == 0 else 4)
            entries = _boxes(data, br.pos, be)
            if len(entries) < n or any(t != b"infe" for t, _, _ in entries[:n]):
                _fail("an iinf box whose entries are not infe boxes")
            for _, s2, e2 in entries[:n]:
                ir = _Reader(data, s2, e2)
                iv, _ = ir.full()
                if iv not in (2, 3):
                    _fail("an infe box of a version libavif does not read")
                it = item(ir.uint(2 if iv == 2 else 4))
                ir.uint(2)
                it["type"] = ir.take(4)
                ir.cstring()
                if it["type"] == b"mime":
                    ir.cstring()
        elif typ == b"iloc":
            v, _ = br.full()
            if v > 2:
                _fail("an iloc box of a version libavif does not read")
            a, b = br.uint(1), br.uint(1)
            off_size, len_size, base_size, idx_size = a >> 4, a & 15, b >> 4, (b & 15) if v else 0
            if any(n not in (0, 4, 8) for n in (off_size, len_size, base_size, idx_size)):
                _fail("an iloc field size libavif does not read")
            for _ in range(br.uint(2 if v < 2 else 4)):
                it = item(br.uint(2 if v < 2 else 4))
                if it.get("extents"):
                    _fail("an item located twice")
                method = br.uint(2) & 15 if v else 0
                if method not in (0, 1):
                    _fail("an item in another item (construction method 2)")
                br.uint(2)
                base = br.uint(base_size)
                extents = []
                for _ in range(br.uint(2)):
                    br.uint(idx_size)
                    extents.append((base + br.uint(off_size), br.uint(len_size)))
                it.update(method=method, extents=extents)
        elif typ == b"iprp":
            kids = _boxes(data, bs, be)
            if not kids or kids[0][0] != b"ipco":
                _fail("an iprp box whose first child is not ipco")
            props = _props(data, kids[0][1], kids[0][2])
            seen_vf = set()
            for t2, s2, e2 in kids[1:]:
                if t2 != b"ipma":
                    _fail("an iprp box holding more than ipco and ipma")
                ir = _Reader(data, s2, e2)
                v, flags = ir.full()
                if (v, flags) in seen_vf:
                    _fail("two ipma boxes of one version and flags")
                seen_vf.add((v, flags))
                prev = 0
                for _ in range(ir.uint(4)):
                    iid = ir.uint(2 if v < 1 else 4)
                    if iid <= prev:
                        _fail("ipma entries not in increasing item order")
                    prev = iid
                    it = item(iid)
                    if "props" in it:
                        _fail("an item in two ipma boxes")
                    it["props"] = []
                    for _ in range(ir.uint(1)):
                        x = ir.uint(2 if flags & 1 else 1)
                        essential, k = x >> (15 if flags & 1 else 7), x & (0x7FFF if flags & 1 else 0x7F)
                        if k == 0:
                            continue
                        if k > len(props):
                            _fail("an ipma entry past the properties")
                        ptype, pval = props[k - 1]
                        if ptype not in _SUPPORTED:  # an unknown essential property: libavif ignores the item
                            it["skip"] = it.get("skip", False) or bool(essential)
                        elif (essential and ptype == b"a1lx") or (not essential and ptype in _ESSENTIAL):
                            _fail(f"a {ptype.decode()} property marked essential where it must not be, or not where "
                                  "it must be")
                        else:
                            it["props"].append((ptype, pval))
        elif typ == b"iref":
            v, _ = br.full()
            while br.pos < be:  # libavif reads the references one after another, past each box's own size
                size = br.uint(4)
                if size < 8 or br.pos - 4 + size > be:
                    _fail("an iref entry past its box")
                rtype = br.take(4)
                if v > 1:  # libavif skips the references of an iref version it does not read
                    break
                src = br.uint(2 if v == 0 else 4)
                item(src)
                for _ in range(br.uint(2)):
                    dst = br.uint(2 if v == 0 else 4)
                    item(dst)
                    if src != dst and rtype == b"auxl":
                        items[src]["auxl"] = dst
    if primary is None or primary not in items or items[primary].get("skip"):
        raise ValueError("AVIF: no primary item")
    return items, primary, idat


def _item_data(data: bytes, item: dict, idat: bytes) -> bytes:
    src = idat if item.get("method") == 1 else data
    if "extents" not in item:
        raise ValueError("AVIF: an item without a location")
    parts = []
    for off, length in item["extents"]:  # libavif sums the lengths: an extent of length 0 adds no bytes
        if off + length > len(src):
            raise PassOn("AVIF: item data past the end of the file")
        parts.append(src[off : off + length])
    return b"".join(parts)


def _prop(item: dict, typ: bytes):
    return next((v for t, v in item.get("props", ()) if t == typ), None)


# vkgr_av1_info's fields
_INFO = ("w", "h", "depth", "mono", "ssx", "ssy", "cp", "tc", "mc", "full", "base_q_idx", "csp", "cicp",
         "lf_y_v", "lf_y_h", "lf_u", "lf_v", "sharpness", "lf_deltas", "enable_cdef", "cdef_bits", "cdef_strength",
         "lr_planes", "qm", "delta_q", "delta_lf", "segmentation", "tx_mode_select", "reduced_tx_set", "sb128",
         "lossless", "lr_type_y", "lr_type_u", "lr_type_v", "lr_unit_y", "lr_unit_uv", "lr_uv_shift", "cdef_damping",
         "cdef_y_strength", "cdef_uv_strength", "tile_cols", "tile_rows", "why")
# FrameRestorationType, as the lr_type_* fields hold it
LR_TYPES = ("none", "wiener", "sgrproj", "switchable")
# why the decoder refuses a frame (the info's last field)
_WHY = {1: "a frame other than a shown key frame", 2: "superres", 3: "screen content tools",
        4: "quantiser matrices", 5: "segmentation", 6: "delta q", 7: "delta lf", 10: "film grain",
        11: "more than 8 bits"}


def _decode_av1(obus: bytes):
    """AV1 OBUs -> (info dict, [Y, U, V] uint8 planes, U and V None at 4:0:0)."""
    info = np.zeros(len(_INFO), np.int32)
    src = np.frombuffer(obus, np.uint8)
    lib = _lib()
    rc = lib.vkgr_av1_info(src.ctypes.data, len(src), info.ctypes.data)
    if rc == 0:
        w, h, mono, ssx, ssy = int(info[0]), int(info[1]), int(info[3]), int(info[4]), int(info[5])
        check_size("AVIF", w, h)
        cw, ch = (w + ssx) >> ssx, (h + ssy) >> ssy
        out = np.zeros(w * h + (0 if mono else 2 * cw * ch), np.uint8)
        rc = lib.vkgr_av1_decode(src.ctypes.data, len(src), info.ctypes.data, out.ctypes.data, len(out))
    if rc == -2:
        why = _WHY.get(int(info[-1]), "tools")
        raise UnsupportedCodec(f"AVIF: AV1 with {why}, which the port does not decode (ROADMAP A)")
    if rc != 0:
        raise ValueError(f"AVIF: corrupt AV1 data (rc {rc})")
    meta = {k: int(v) for k, v in zip(_INFO, info)}
    y = out[: w * h].reshape(h, w)
    if mono:
        return meta, [y, None, None]
    u = out[w * h : w * h + cw * ch].reshape(ch, cw)
    v = out[w * h + cw * ch :].reshape(ch, cw)
    return meta, [y, u, v]


def av1_header(obus: bytes) -> dict:
    """The first frame's sequence and frame header fields (base_q_idx, the
    loop filter levels, CDEF, loop restoration and quantiser matrices among
    them; lr_type_* index LR_TYPES), without decoding it; "refused" where
    the frame lies outside the ported subset, and "why" then names the tool
    that puts it there."""
    info = np.zeros(len(_INFO), np.int32)
    src = np.frombuffer(obus, np.uint8)
    rc = _lib().vkgr_av1_info(src.ctypes.data, len(src), info.ctypes.data)
    fields = {k: int(v) for k, v in zip(_INFO, info)}
    return {**fields, "refused": rc == -2, "why": _WHY.get(fields["why"], "") if rc == -2 else ""}


# libyuv's YuvConstants (row_common.cc) by (matrix, full range): UB, UG, VG, VR, YG, YB
_LIBYUV = {
    ("601", False): (128, 25, 52, 102, 18997, -1160),  # kYuvI601Constants
    ("601", True): (113, 22, 46, 90, 16320, 32),  # kYuvJPEGConstants
    ("709", False): (128, 14, 34, 115, 18997, -1160),  # kYuvH709Constants
    ("709", True): (119, 12, 30, 101, 16320, 32),  # kYuvF709Constants
    ("2020", False): (128, 12, 42, 107, 19003, -1160),  # kYuv2020Constants
    ("2020", True): (120, 11, 37, 94, 16320, 32),  # kYuvV2020Constants
}


def _matrix(mc: int):
    if mc in (5, 6, 2):  # BT.470BG, BT.601, unspecified
        return "601"
    if mc == 1:
        return "709"
    if mc == 9:
        return "2020"
    return None


def _upsample_row(c: np.ndarray, width: int) -> np.ndarray:
    """libyuv's ScaleRowUp2_Linear_Any over rows c [n, cw] (int32) -> [n, width]."""
    n, cw = c.shape
    out = np.empty((n, width), np.int32)
    out[:, 0] = c[:, 0]
    k = (width - 1) // 2  # interior pairs (2x+1, 2x+2) from source x, x+1
    if k > 0:
        a, b = c[:, :k], c[:, 1 : k + 1]
        out[:, 1 : 2 * k : 2] = (3 * a + b + 2) >> 2
        out[:, 2 : 2 * k + 1 : 2] = (a + 3 * b + 2) >> 2
    out[:, width - 1] = c[:, (width - 1) // 2]
    return out


def _upsample_420(c: np.ndarray, width: int, height: int) -> np.ndarray:
    """libyuv's I420ToARGBMatrixBilinear chroma: row 0 and (for an even
    height) the last row from one chroma row, the rows between from
    ScaleRowUp2_Bilinear_Any of two chroma rows (9:3:3:1, the edges 3:1)."""
    c = c.astype(np.int32)
    ch, cw = c.shape
    out = np.empty((height, width), np.int32)
    out[0] = _upsample_row(c[:1], width)[0]
    pairs = (height - 1) // 2
    if pairs > 0:
        s, t = c[:pairs], c[1 : pairs + 1]
        near, far = 3 * s + t, s + 3 * t  # the rows nearer s, nearer t, as 4x weights
        for rows, dst in ((near, slice(1, 2 * pairs, 2)), (far, slice(2, 2 * pairs + 1, 2))):
            o = np.empty((pairs, width), np.int32)
            o[:, 0] = (rows[:, 0] + 2) >> 2
            k = (width - 1) // 2
            if k > 0:
                a, b = rows[:, :k], rows[:, 1 : k + 1]
                o[:, 1 : 2 * k : 2] = (3 * a + b + 8) >> 4
                o[:, 2 : 2 * k + 1 : 2] = (a + 3 * b + 8) >> 4
            o[:, width - 1] = (rows[:, (width - 1) // 2] + 2) >> 2
            out[dst] = o
    if height % 2 == 0 and height > 1:
        out[height - 1] = _upsample_row(c[ch - 1 : ch], width)[0]
    return out


def _yuv_to_rgb(meta: dict, planes, nclx) -> np.ndarray:
    y, u, v = planes
    h, w = y.shape
    if nclx is not None:
        mc, full = nclx
    else:
        mc, full = meta["mc"], bool(meta["full"])
    if u is None:  # I400ToARGBMatrix: gray, whatever the matrix; limited range with BT.2020's Y scale
        yg, yb = _LIBYUV[("2020", bool(full))][4:]
        g = np.clip((((y.astype(np.int64) * 0x0101 * yg) >> 16) + yb) >> 6, 0, 255).astype(np.uint8)
        return np.stack([g, g, g], axis=-1)
    if mc == 0 and full:  # identity: G in Y, B in U, R in V
        return np.stack([v, y, u], axis=-1)
    if mc == 0:
        raise UnsupportedCodec("AVIF: matrix coefficients 0 in limited range, which libavif converts without libyuv")
    name = _matrix(mc)
    if name is None:
        raise UnsupportedCodec(f"AVIF: matrix coefficients {mc}, which libavif converts without libyuv")
    ub, ug, vg, vr, yg, yb = _LIBYUV[(name, bool(full))]
    y1 = (y.astype(np.int64) * 0x0101 * yg) >> 16
    if meta["ssx"] and meta["ssy"]:
        uu, vv = _upsample_420(u, w, h), _upsample_420(v, w, h)
    elif meta["ssx"]:
        uu, vv = _upsample_row(u.astype(np.int32), w), _upsample_row(v.astype(np.int32), w)
    else:
        uu, vv = u.astype(np.int32), v.astype(np.int32)
    bb = -(ub * 128) + yb
    bg = ug * 128 + vg * 128 + yb
    br = -(vr * 128) + yb
    b = (y1 + uu * ub + bb) >> 6
    g = (y1 - (uu * ug + vv * vg) + bg) >> 6
    r = (y1 + vv * vr + br) >> 6
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def _check_item(item: dict) -> None:
    """libavif's checks of an AV1 item: av1C and ispe present, pixi's depths those of av1C."""
    av1c = _prop(item, b"av1C")
    if av1c is None:
        _fail("an AV1 item without av1C")
    if _prop(item, b"ispe") is None:
        _fail("an item without ispe")
    pixi = _prop(item, b"pixi")
    if pixi is not None and any(d != av1c["depth"] for d in pixi):
        _fail("pixi depths that are not av1C's")


def read_avif(data: bytes):
    """AVIF bytes -> (mode "RGB" or "RGBA", uint8 [H, W, 3 or 4])."""
    items, primary, idat = _parse(data)
    item = items[primary]
    kind = item.get("type")
    if kind == b"grid":
        raise UnsupportedCodec("AVIF: grid items are not supported (ROADMAP A)")
    if kind != b"av01":
        raise ValueError(f"AVIF: a primary item of type {kind!r}")
    _check_item(item)
    iw, ih = _prop(item, b"ispe")
    check_size("AVIF", iw, ih)
    aux = [a for a in items.values() if a.get("auxl") == primary and a.get("type") == b"av01"
           and not a.get("skip") and any(n for _, n in a.get("extents", ()))]
    if any(_prop(a, b"av1C") is None for a in aux):
        _fail("an AV1 auxiliary item without av1C")
    alpha = next((a for a in aux if (_prop(a, b"auxC") or b"") in _ALPHA_URNS), None)
    if alpha is not None:
        _check_item(alpha)
    colr = _prop(item, b"colr")
    nclx = (colr[3], bool(colr[4])) if colr is not None and colr[0] == "nclx" else None
    meta, planes = _decode_av1(_item_data(data, item, idat))
    if (meta["w"], meta["h"]) != (iw, ih):
        raise ValueError("AVIF: the AV1 frame's size is not the ispe size")
    rgb = _yuv_to_rgb(meta, planes, nclx)
    if alpha is None:
        return "RGB", rgb
    ameta, aplanes = _decode_av1(_item_data(data, alpha, idat))
    if (ameta["w"], ameta["h"]) != _prop(alpha, b"ispe"):  # libavif would scale it (ROADMAP C5)
        raise ValueError("AVIF: the AV1 frame's size is not the ispe size")
    if (ameta["w"], ameta["h"]) != (meta["w"], meta["h"]):
        raise ValueError("AVIF: an alpha plane of another size")
    return "RGBA", np.concatenate([rgb, aplanes[0][..., None]], axis=-1)


def decode_avif(data: bytes) -> np.ndarray:
    """AVIF bytes -> uint8 [H, W, 3] (RGB) or [H, W, 4] (RGBA), as Pillow opens it."""
    return read_avif(data)[1]
