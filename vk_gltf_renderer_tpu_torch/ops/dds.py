"""DDS and KTX2 image decoding (no external codec libraries).

The port's copy of vk_gltf_renderer_tpu/ops/dds.py: every function's
source is the JAX package's (tests/test_torch_codecs.py holds them equal),
so the port decodes these containers as the JAX package does, on the host.
The upstream renderer decodes DDS/KTX/KTX2 through nv_dds/nv_ktx
(gltf_image_loader.cpp:1-242); this module covers the same container
formats in pure numpy:

  DDS:  uncompressed BGRA/RGBA8, BC1 (DXT1), BC2 (DXT3), BC3 (DXT5) —
        block decompression fully vectorized over blocks.
  KTX2: header + level index parse; uncompressed R8G8B8A8_{UNORM,SRGB},
        zlib/zstd supercompression, BasisLZ/ETC1S via the in-repo
        transcoder (ops/basisu.py), UASTC (DFD color model 166 — bit-valid
        ASTC 4x4 blocks, ops/astc.py) and plain ASTC LDR 4x4..12x12.

Returned images are float32 RGBA [H,W,4] in [0,1], matching decode_image.
A zstd payload goes through the port's own Zstandard decoder (ops/zstd.py;
the JAX package's copy of this function uses the zstandard package). A
truncated file raises struct.error, zlib.error or IndexError here, a
corrupt zstd payload ValueError; ops/textures.decode_image turns those
into ValueError.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

DDS_MAGIC = b"DDS "
KTX2_MAGIC = b"\xabKTX 20\xbb\r\n\x1a\n"


class UnsupportedCodec(ValueError):
    pass


# ------------------------------------------------------------------ BC blocks
def _decode_bc1_colors(block_u64, with_alpha_palette):
    """Color part shared by BC1/BC2/BC3. block_u64: [N] uint64 (8 bytes).
    Returns rgba [N, 16, 4] uint8 (alpha only meaningful for BC1)."""
    b = block_u64
    c0 = (b & 0xFFFF).astype(np.uint32)
    c1 = ((b >> 16) & 0xFFFF).astype(np.uint32)
    idx = (b >> 32).astype(np.uint64)

    def rgb565(c):
        r = ((c >> 11) & 31) * 255 // 31
        g = ((c >> 5) & 63) * 255 // 63
        bl = (c & 31) * 255 // 31
        return np.stack([r, g, bl], axis=-1).astype(np.int32)

    p0 = rgb565(c0)
    p1 = rgb565(c1)
    four = (c0 > c1) | (~with_alpha_palette)  # BC2/BC3 always 4-color mode
    p2_4 = (2 * p0 + p1) // 3
    p3_4 = (p0 + 2 * p1) // 3
    p2_3 = (p0 + p1) // 2
    p3_3 = np.zeros_like(p0)
    f = four[:, None]
    p2 = np.where(f, p2_4, p2_3)
    p3 = np.where(f, p3_4, p3_3)
    pal = np.stack([p0, p1, p2, p3], axis=1)  # [N,4,3]
    a_pal = np.stack(
        [
            np.full_like(c0, 255),
            np.full_like(c0, 255),
            np.full_like(c0, 255),
            np.where(four, 255, 0).astype(np.uint32),
        ],
        axis=1,
    )  # [N,4]
    sel = ((idx[:, None] >> (2 * np.arange(16, dtype=np.uint64))) & 3).astype(np.int64)  # [N,16]
    rows = np.arange(b.shape[0])[:, None]
    rgb = pal[rows, sel]  # [N,16,3]
    a = a_pal[rows, sel]  # [N,16]
    return np.concatenate([rgb, a[..., None]], axis=-1).astype(np.uint8)


def _decode_bc3_alpha(block_u64):
    """BC3/BC4 interpolated alpha block: [N] uint64 -> [N,16] uint8."""
    b = block_u64
    a0 = (b & 0xFF).astype(np.int32)
    a1 = ((b >> 8) & 0xFF).astype(np.int32)
    bits = b >> 16  # 48 bits of 3-bit indices
    pal = np.empty((b.shape[0], 8), np.int32)
    pal[:, 0] = a0
    pal[:, 1] = a1
    eight = a0 > a1
    for i in range(1, 7):
        pal[:, 1 + i] = np.where(
            eight,
            ((7 - i) * a0 + i * a1) // 7,
            0,  # filled below for 6-mode
        )
    for i in range(1, 5):
        six = ((5 - i) * a0 + i * a1) // 5
        pal[:, 1 + i] = np.where(eight, pal[:, 1 + i], six)
    pal[:, 6] = np.where(eight, pal[:, 6], 0)
    pal[:, 7] = np.where(eight, pal[:, 7], 255)
    sel = ((bits[:, None] >> (3 * np.arange(16, dtype=np.uint64))) & 7).astype(np.int64)
    return pal[np.arange(b.shape[0])[:, None], sel].astype(np.uint8)


def _blocks_to_image(px, w, h):
    """px [N,16,4] block texels -> [h,w,4] (blocks in row-major order)."""
    bw, bh = (w + 3) // 4, (h + 3) // 4
    img = px.reshape(bh, bw, 4, 4, 4).transpose(0, 2, 1, 3, 4).reshape(bh * 4, bw * 4, 4)
    return img[:h, :w]


def decode_bc(data: bytes, w: int, h: int, fmt: str) -> np.ndarray:
    """fmt in {'BC1','BC2','BC3'} -> uint8 RGBA [h,w,4]."""
    bw, bh = (w + 3) // 4, (h + 3) // 4
    n = bw * bh
    if fmt == "BC1":
        blocks = np.frombuffer(data[: n * 8], "<u8")
        px = _decode_bc1_colors(blocks, with_alpha_palette=np.ones(n, bool))
    elif fmt in ("BC2", "BC3"):
        raw = np.frombuffer(data[: n * 16], "<u8").reshape(n, 2)
        a_blk, c_blk = raw[:, 0], raw[:, 1]
        px = _decode_bc1_colors(c_blk, with_alpha_palette=np.zeros(n, bool))
        if fmt == "BC2":  # explicit 4-bit alpha
            sel = ((a_blk[:, None] >> (4 * np.arange(16, dtype=np.uint64))) & 15).astype(np.uint16)
            px[..., 3] = (sel * 17).astype(np.uint8)
        else:
            px[..., 3] = _decode_bc3_alpha(a_blk)
    else:
        raise UnsupportedCodec(f"unsupported BC format {fmt}")
    return _blocks_to_image(px, w, h)


# ------------------------------------------------------------------ DDS
def decode_dds(data: bytes) -> np.ndarray:
    """DDS container -> float32 RGBA [H,W,4] in [0,1] (top mip only; the
    texture pool regenerates the mip chain)."""
    if data[:4] != DDS_MAGIC:
        raise ValueError("not a DDS file")
    (size, flags, h, w) = struct.unpack_from("<4I", data, 4)
    if size != 124:
        raise ValueError("bad DDS header")
    pf_off = 4 + 72  # pixel format struct
    pf_size, pf_flags, fourcc = struct.unpack_from("<2I4s", data, pf_off)
    rgb_bits, rmask, gmask, bmask, amask = struct.unpack_from("<5I", data, pf_off + 12)
    payload = data[4 + 124 :]
    fourcc_s = fourcc.decode("ascii", "replace")
    if fourcc_s == "DX10":
        (dxgi,) = struct.unpack_from("<I", payload, 0)
        payload = payload[20:]
        dxgi_map = {71: "BC1", 74: "BC2", 77: "BC3", 28: "RGBA8", 87: "BGRA8"}
        kind = dxgi_map.get(dxgi)
        if kind is None:
            raise UnsupportedCodec(f"DDS DXGI format {dxgi} not supported")
    elif pf_flags & 0x4:  # FOURCC
        kind = {"DXT1": "BC1", "DXT3": "BC2", "DXT5": "BC3"}.get(fourcc_s)
        if kind is None:
            raise UnsupportedCodec(f"DDS fourcc {fourcc_s} not supported")
    elif pf_flags & 0x40:  # uncompressed RGB
        if rgb_bits != 32:
            raise UnsupportedCodec(f"DDS {rgb_bits}-bit uncompressed not supported")
        kind = "BGRA8" if bmask == 0xFF else "RGBA8"
    else:
        raise UnsupportedCodec("unrecognized DDS pixel format")

    if kind in ("BC1", "BC2", "BC3"):
        img = decode_bc(payload, w, h, kind)
    else:
        img = np.frombuffer(payload[: w * h * 4], np.uint8).reshape(h, w, 4).copy()
        if kind == "BGRA8":
            img = img[..., [2, 1, 0, 3]]
        if not (pf_flags & 0x4) and amask == 0:
            img[..., 3] = 255
    return img.astype(np.float32) / 255.0


# ------------------------------------------------------------------ KTX2
def decode_ktx2(data: bytes) -> np.ndarray:
    """KTX2 container -> float32 RGBA [H,W,4] (level 0)."""
    if data[:12] != KTX2_MAGIC:
        raise ValueError("not a KTX2 file")
    (vk_format, type_size, w, h, depth, layers, faces, levels, scheme) = struct.unpack_from(
        "<9I", data, 12
    )
    dfd_off, dfd_len, kvd_off, kvd_len = struct.unpack_from("<4I", data, 48)
    sgd_off, sgd_len = struct.unpack_from("<2Q", data, 64)
    # level index starts at byte 80; 24 bytes per level
    off, length, uncomp = struct.unpack_from("<3Q", data, 80)
    payload = data[off : off + length]
    if scheme == 0:
        pass
    elif scheme == 3:  # ZLIB supercompression
        payload = zlib.decompress(payload)
    elif scheme == 1:  # BasisLZ (ETC1S) — in-repo transcoder
        from .basisu import parse_basis_lz_global, prepare_codebooks, transcode_etc1s_image

        color_model = data[dfd_off + 12] if dfd_len >= 13 else 0
        if color_model != 163:  # KHR_DF_MODEL_ETC1S
            raise UnsupportedCodec(
                f"KTX2 BasisLZ with DFD color model {color_model} (only ETC1S=163 supported)")
        n_images_per_level = max(layers, 1) * max(faces, 1) * max(depth, 1)
        glob = parse_basis_lz_global(
            data[sgd_off : sgd_off + sgd_len], levels * n_images_per_level
        )
        glob = prepare_codebooks(glob)
        # image descs are level-major ascending; level 0 image 0
        img = transcode_etc1s_image(payload, glob["image_descs"][0], glob, w, h)
        return img.astype(np.float32) / 255.0
    elif scheme == 2:  # ZSTD supercompression
        from .zstd import decompress

        payload = decompress(payload, int(uncomp) or 1 << 30)
    else:
        raise UnsupportedCodec(f"KTX2 supercompression scheme {scheme} not supported")
    VK_RGBA8_UNORM, VK_RGBA8_SRGB = 37, 43
    VK_BC1_UNORM, VK_BC1_SRGB, VK_BC3_UNORM, VK_BC3_SRGB = 131, 132, 137, 138
    if vk_format in (VK_RGBA8_UNORM, VK_RGBA8_SRGB):
        img = np.frombuffer(payload[: w * h * 4], np.uint8).reshape(h, w, 4).copy()
    elif vk_format in (VK_BC1_UNORM, VK_BC1_SRGB):
        img = decode_bc(payload, w, h, "BC1")
    elif vk_format in (VK_BC3_UNORM, VK_BC3_SRGB):
        img = decode_bc(payload, w, h, "BC3")
    elif vk_format == 0:
        # vkFormat 0 + scheme!=1: UASTC (KHR_DF_MODEL_UASTC=166), whose LDR
        # 4x4 payload is a stream of bit-valid ASTC blocks (ops/astc.py)
        from .astc import decode_astc, uastc_structural_check

        color_model = data[dfd_off + 12] if dfd_len >= 13 else 0
        if color_model != 166:
            raise UnsupportedCodec(
                f"KTX2 vkFormat 0 with DFD color model {color_model} (UASTC=166)")
        uastc_structural_check(payload, w, h)
        img = decode_astc(payload, w, h)
    elif 157 <= vk_format <= 184:  # VK_FORMAT_ASTC_*_{UNORM,SRGB}_BLOCK
        from .astc import decode_astc

        dims = [(4, 4), (5, 4), (5, 5), (6, 5), (6, 6), (8, 5), (8, 6),
                (8, 8), (10, 5), (10, 6), (10, 8), (10, 10), (12, 10), (12, 12)]
        bw, bh = dims[(vk_format - 157) // 2]
        img = decode_astc(payload, w, h, bw, bh)
    else:
        raise UnsupportedCodec(f"KTX2 vkFormat {vk_format} not supported")
    return img.astype(np.float32) / 255.0


def sniff_decode(data: bytes):
    """Return decoded image if `data` is DDS/KTX2, else None."""
    if data[:4] == DDS_MAGIC:
        return decode_dds(data)
    if data[:12] == KTX2_MAGIC:
        return decode_ktx2(data)
    return None
