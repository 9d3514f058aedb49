"""Kodak PhotoCD reading without Pillow, as Pillow's PcdImagePlugin reads
the base image: "PCD_" at byte 2048 (Pillow registers PCD without a magic
check, so data without it pass on), the 768 x 512 image at 96 * 2048 in
groups of two luma rows and one row each of C1 and C2 at half width, each
pixel's (Y, C1, C2) turned into RGB by Pillow's PhotoYCC tables
(Unpack.c's "YCC;P"), then turned by 90 or 270 degrees when the low bits
of header byte 1538 say so.
"""

from __future__ import annotations

import numpy as np

from .imagemodes import PassOn

W, H = 768, 512
OFFSET = 96 * 2048


def _table(k: float, centre: int) -> np.ndarray:
    """k * (i - centre) + 0.5, truncated toward zero (UnpackYCC.c's tables), for i in 0..255."""
    return np.trunc(k * (np.arange(256) - centre) + 0.5).astype(np.int64)


# Kodak's PhotoYCC to RGB: 1.3584 Y, C1 about 156, C2 about 137
_L = _table(1.3584, 0)
_CR, _GR = _table(1.8215, 137), _table(-0.9271435, 137)
_CB, _GB = _table(2.2179, 156), _table(-0.4302726, 156)


def photo_ycc_to_rgb(y: np.ndarray, c1: np.ndarray, c2: np.ndarray) -> np.ndarray:
    """Pillow's PhotoYCC unpacker: uint8 planes -> uint8 [..., 3]."""
    lum = _L[y]
    rgb = (lum + _CR[c2], lum + _GB[c1] + _GR[c2], lum + _CB[c1])
    return np.clip(np.stack(rgb, axis=-1), 0, 255).astype(np.uint8)


def read_pcd(data: bytes):
    """PCD bytes -> ("RGB", pixels [512, 768, 3] or [768, 512, 3])."""
    head = data[2048 : 2048 + 1539]
    if not head.startswith(b"PCD_") or len(head) < 1539:
        raise PassOn("not a PCD file")
    orientation = head[1538] & 3
    if OFFSET + H * W * 3 // 2 > len(data):
        raise ValueError("PCD: image file is truncated")
    groups = np.frombuffer(data, np.uint8, H * W * 3 // 2, OFFSET).reshape(H // 2, 3 * W)
    y = groups[:, : 2 * W].reshape(H, W)
    c1 = np.repeat(np.repeat(groups[:, 2 * W : 2 * W + W // 2], 2, axis=0), 2, axis=1)
    c2 = np.repeat(np.repeat(groups[:, 2 * W + W // 2 :], 2, axis=0), 2, axis=1)
    rgb = photo_ycc_to_rgb(y, c1, c2)
    if orientation == 1:
        rgb = np.rot90(rgb, 1)
    elif orientation == 3:
        rgb = np.rot90(rgb, 3)
    return "RGB", np.ascontiguousarray(rgb)


def decode_pcd(data: bytes) -> np.ndarray:
    """PCD bytes -> uint8 [H, W, 3] (Pillow's "RGB")."""
    return read_pcd(data)[1]
