"""GIF reading (frame 0) and writing without Pillow, as Pillow's
GifImagePlugin reads and writes it.

Reading follows GifImageFile._open/_seek(0)/load for the first frame: the
global and the local colour table (a table that is the gray ramp 0, 1,
2, ... makes the frame mode "L", indices read as gray; no table at all
does too; a gray-ramp local table over a global one reads through the
global table, as Pillow's attached palette does), extension blocks skipped as Pillow skips them (stray bytes
between blocks too), the graphic control extension's transparency index,
a frame rectangle that grows the logical screen when it reaches past it,
and interlaced rows. The canvas outside the frame holds index 0, or the
transparency index when there is one; convert("RGBA") then makes that index
transparent. The LZW data decode in native/image_coders.cpp as Pillow's
GifDecode.c decodes them: a code outside the table is an error, and so are
sub-blocks that run past the end of the file before the frame is full
(Pillow passes over an early end code and reads on).

encode_gif writes a GIF87a file with one frame. For an image of at most
256 colours the palette is its colours, so the file decodes to exactly
its pixels, as Pillow's adaptive palette does then. Above 256 colours
Pillow quantizes by its median cut (Quant.c); this module quantizes by a
median cut of its own (boxes split at the median of their widest channel,
each colour the rounded mean of its box), so such a file decodes close to
but not equal to Pillow's (ROADMAP C).
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from .dds import UnsupportedCodec
from .imagemodes import to_rgba


def is_gif(data: bytes) -> bool:
    return data[:6] in (b"GIF87a", b"GIF89a")


def _lib():
    from ..native import image_lib

    return image_lib()


class _Stream:
    def __init__(self, data: bytes, pos: int):
        self.data, self.pos = data, pos

    def read(self, n: int) -> bytes:
        b = self.data[self.pos : self.pos + n]
        self.pos += len(b)
        return b

    def block(self):
        """GifImageFile.data: one sub-block, None at a terminator or the end."""
        s = self.read(1)
        if s and s[0]:
            return self.read(s[0])
        return None


def _palette_needed(p: bytes) -> bool:
    return any(not (i // 3 == p[i] == p[i + 1] == p[i + 2]) for i in range(0, len(p), 3))


def read_gif(data: bytes):
    """GIF bytes -> (mode "P" or "L", indices [H, W] uint8, palette [n, 3]
    or None, transparency index or None) of frame 0."""
    if len(data) < 13 or not is_gif(data):
        raise UnsupportedCodec("not a GIF file")
    w, h = struct.unpack_from("<HH", data, 6)
    flags = data[10]
    st = _Stream(data, 13)
    global_pal = None
    if flags & 128:
        p = st.read(3 << ((flags & 7) + 1))
        if len(p) % 3:
            raise ValueError("GIF: truncated colour table")
        if _palette_needed(p):
            global_pal = p
    trns = None
    frame = None
    s = st.read(1)
    while True:
        if not s:
            s = st.read(1)
        if not s or s == b";":
            break
        if s == b"!":
            label = st.read(1)
            if not label:
                raise ValueError("GIF: truncated extension")
            blk = st.block()
            if label[0] == 249 and blk is not None:
                if len(blk) < 3 or (blk[0] & 1 and len(blk) < 4):
                    raise ValueError("GIF: short graphic control extension")
                if blk[0] & 1:
                    trns = blk[3]
            elif label[0] == 254:
                while blk:
                    blk = st.block()
                s = b""
                continue
            elif label[0] == 255 and blk is not None and blk.startswith(b"NETSCAPE2.0"):
                st.block()
            while st.block():
                pass
        elif s == b",":
            d = st.read(9)
            if len(d) < 9:
                raise ValueError("GIF: truncated image descriptor")
            x0, y0, fw, fh, fflags = struct.unpack("<HHHHB", d)
            local = None
            if fflags & 128:
                p = st.read(3 << ((fflags & 7) + 1))
                if len(p) % 3:
                    raise ValueError("GIF: truncated colour table")
                local = p if _palette_needed(p) else False
            bits = st.read(1)
            if not bits:
                raise ValueError("GIF: no LZW code size")
            frame = (x0, y0, fw, fh, bool(fflags & 64), local, bits[0], st.pos)
            break
        s = b""
    if frame is None:
        raise ValueError("GIF: no image in the file")
    x0, y0, fw, fh, interlace, local, bits, offset = frame
    w, h = max(w, x0 + fw), max(h, y0 + fh)
    if w <= 0 or h <= 0:
        raise ValueError("GIF: empty image")
    pal = local if local is not None else global_pal
    mode = "P" if pal else "L"
    if local is False and global_pal:
        # Pillow opens the frame as "L" but attaches the global table, so its pixels read through that
        # table, and convert("RGBA") refuses the transparency of such a frame
        if trns is not None:
            raise ValueError("GIF: a gray-ramp local table over a global table, with transparency")
        mode, pal = "P", global_pal
    canvas = np.full((h, w), trns if trns is not None else 0, np.uint8)
    if fw > 0 and fh > 0:
        idx = canvas[y0 : y0 + fh, x0 : x0 + fw].copy()
        src = np.frombuffer(data, np.uint8)[offset:]
        rc = _lib().vkgr_gif_lzw_decode(src.ctypes.data, len(src), bits, idx.ctypes.data, fw, fh, int(interlace))
        if rc == -1:
            raise ValueError("GIF: broken LZW data")
        if rc != 0:
            raise ValueError("GIF: truncated LZW data")
        canvas[y0 : y0 + fh, x0 : x0 + fw] = idx
    palette = np.frombuffer(pal, np.uint8).reshape(-1, 3) if pal else None
    return mode, canvas, palette, trns


def decode_gif(data: bytes) -> np.ndarray:
    """GIF bytes -> uint8 [H, W, 4] of frame 0, as Pillow's convert("RGBA")."""
    mode, idx, palette, trns = read_gif(data)
    return to_rgba(mode, idx, palette, trns)


def median_cut(cols: np.ndarray, weights: np.ndarray, colors: int = 256):
    """Distinct colours [N, 3] uint8 with pixel counts [N] -> (palette
    [k, 3] uint8, box of each colour [N]), k <= colors: the box with the
    most pixels (of those with more than one colour) splits at the weighted
    median of its widest channel; a box's colour is its rounded mean."""

    def stats(b):
        rng = np.ptp(cols[b], axis=0)
        return (int(weights[b].sum()) if rng.max() > 0 else 0), int(np.argmax(rng))

    boxes, info = [np.arange(len(cols))], [stats(np.arange(len(cols)))]
    while len(boxes) < colors:
        k = max(range(len(boxes)), key=lambda i: info[i][0])
        if info[k][0] == 0:
            break
        b = boxes.pop(k)
        c = info.pop(k)[1]
        order = b[np.argsort(cols[b, c], kind="stable")]
        cw = np.cumsum(weights[order])
        mid = int(np.clip(np.searchsorted(cw, cw[-1] / 2) + 1, 1, len(order) - 1))
        for half in (order[:mid], order[mid:]):
            boxes.append(half)
            info.append(stats(half))
    palette = np.empty((len(boxes), 3), np.uint8)
    box = np.empty(len(cols), np.uint8)
    for i, b in enumerate(boxes):
        wsum = weights[b].sum()
        palette[i] = np.floor((cols[b] * weights[b, None]).sum(axis=0) / wsum + 0.5).astype(np.uint8)
        box[b] = i
    return palette, box


def encode_gif(u8: np.ndarray) -> bytes:
    """uint8 [H, W] (gray), [H, W, 3] or [H, W, 4] (alpha dropped) -> one
    GIF87a frame."""
    a = np.asarray(u8, np.uint8)
    h, w = a.shape[:2]
    if a.ndim == 2:
        palette = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
        index = a.reshape(-1)
        palette = palette[: int(index.max()) + 1]
    else:
        rgb = a[..., :3].reshape(-1, 3)
        key = (rgb[:, 0].astype(np.int32) << 16) | (rgb[:, 1].astype(np.int32) << 8) | rgb[:, 2]
        uniq, inv = np.unique(key, return_inverse=True)
        if len(uniq) <= 256:
            palette = np.stack([uniq >> 16, (uniq >> 8) & 255, uniq & 255], axis=-1).astype(np.uint8)
            index = inv.astype(np.uint8)
        else:
            cols = np.stack([uniq >> 16, (uniq >> 8) & 255, uniq & 255], axis=-1).astype(np.int64)
            palette, box = median_cut(cols, np.bincount(inv, minlength=len(uniq)))
            index = box[inv]
    size_bits = max(1, int(np.ceil(np.log2(max(len(palette), 2)))))
    table = np.zeros((1 << size_bits, 3), np.uint8)
    table[: len(palette)] = palette
    lzw = np.empty(len(index) * 2 + 1024, np.uint8)
    n = ctypes.c_int64(0)
    index = np.ascontiguousarray(index, np.uint8)
    rc = _lib().vkgr_gif_lzw_encode(index.ctypes.data, len(index), 8, lzw.ctypes.data, len(lzw), ctypes.byref(n))
    if rc != 0:
        raise RuntimeError("GIF: LZW buffer too small")
    head = b"GIF87a" + struct.pack("<HHBBB", w, h, 0x80 | (size_bits - 1), 0, 0)
    desc = b"," + struct.pack("<HHHHB", 0, 0, w, h, 0) + b"\x08"
    return head + table.tobytes() + desc + lzw[: n.value].tobytes() + b";"
