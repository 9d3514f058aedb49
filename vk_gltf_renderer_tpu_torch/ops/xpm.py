"""XPM reading without Pillow, as Pillow's XpmImagePlugin reads X11
pixmaps: "/* XPM */", then the first line that starts with the quoted
width, height, colour count and characters a pixel; one line a colour,
whose "c" key is a #hex colour or None (any other colour name Pillow
refuses). Up to 256 colours give a "P" image whose palette holds the #hex
colours in the order their keys first appear (a None key has no entry, so
a pixel of it fails the image, as in Pillow), and the None key's own bytes
become the transparency (Pillow's info["transparency"], which its
convert("RGBA") takes as per-entry alphas); more give "RGB". The pixels are
the text between each later line's first and last quote, keys of the
given width, a "/* pixels */" line skipped once, read until the image is
full.
"""

from __future__ import annotations

import re

import numpy as np

from .imagemodes import PassOn, check_size, to_rgba

HEAD = re.compile(b'"([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)')


def is_xpm(data: bytes) -> bool:
    return data.startswith(b"/* XPM */")


def read_xpm(data: bytes):
    """XPM bytes -> (mode, pixels, palette or None, transparency or None)."""
    if not is_xpm(data):
        raise PassOn("not an XPM file")
    lines = [ln + b"\n" for ln in data[9:].split(b"\n")]  # readline's lines
    i = 0
    while True:
        if i >= len(lines):
            raise PassOn("XPM: broken file")
        m = HEAD.match(lines[i])
        i += 1
        if m:
            break
    w, h, ncolors, cpp = (int(g) for g in m.groups())  # an empty field raises ValueError, as in Pillow
    palette, transparency = {}, None
    for _ in range(ncolors):
        line = lines[i].rstrip() if i < len(lines) else b""
        i += 1
        key, s = line[1 : cpp + 1], line[cpp + 1 : -2].split()
        for k in range(0, len(s), 2):
            if s[k] == b"c":
                if k + 1 >= len(s):  # Pillow's IndexError in its open: the next plugin is asked
                    raise PassOn("XPM: a colour key without a value")
                rgb = s[k + 1]
                if rgb == b"None":
                    transparency = key
                elif rgb.startswith(b"#"):
                    v = int(rgb[1:], 16)
                    palette[key] = ((v >> 16) & 255, (v >> 8) & 255, v & 255)
                else:
                    raise ValueError("XPM: cannot read this file (a colour name)")
                break
        else:
            raise ValueError("XPM: cannot read this file (no colour key)")
    if w <= 0 or h <= 0:
        raise PassOn("XPM: empty image")
    check_size("XPM", w, h)
    keys = list(palette)
    lookup = {k: j for j, k in enumerate(keys)}
    need = w * h
    out, header = [], False
    for line in lines[i:]:
        if len(out) >= need:
            break
        if line.rstrip() == b"/* pixels */" and not header:
            header = True
            continue
        text = b'"'.join(line.split(b'"')[1:-1])
        try:
            out.extend(lookup[text[j : j + cpp]] for j in range(0, len(text), cpp))
        except KeyError as e:
            raise ValueError(f"XPM: a pixel of no palette key {e}") from e
    if len(out) < need:
        raise ValueError("XPM: not enough image data")
    idx = np.asarray(out[:need], np.int64).reshape(h, w)
    pal = np.asarray([palette[k] for k in keys], np.uint8).reshape(-1, 3)
    if ncolors > 256:
        if transparency is not None:  # Pillow's convert("RGBA") cannot take a key as an RGB transparency
            raise ValueError("XPM: an RGB image with a None colour")
        return "RGB", pal[idx], None, transparency
    return "P", idx.astype(np.uint8), pal, transparency


def decode_xpm(data: bytes) -> np.ndarray:
    """XPM bytes -> uint8 [H, W, 4], as Pillow's convert("RGBA")."""
    mode, px, palette, transparency = read_xpm(data)
    return to_rgba(mode, px, palette, transparency)
