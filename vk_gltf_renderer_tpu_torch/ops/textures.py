"""Texture pool: decode -> quad-packed texel rows + per-mip descriptors
(host), bilinear/trilinear sampling as row gathers (device).

Port of vk_gltf_renderer_tpu/ops/textures.py. The pool layout is the
reference's: row i of tex_quads holds the 4 bilinear taps anchored at
texel i (REPEAT wrap baked in), so one bilinear fetch is one row gather.
Sampling wraps with REPEAT only, as the reference does. decode_image
tries DDS and KTX2 first (BC1-3, RGBA8, zlib, zstd through the port's own
decoder, BasisLZ/ETC1S, UASTC, ASTC, through ops/dds.py), as the
reference does, then identifies the data as Image.open does, in its order
(utils/image_io.read_image): BMP/DIB, GIF, JPEG, Netpbm, PNG, BLP, CUR,
PCX, DCX, FTEX, ICO, IM, TIFF, MSP, PSD, QOI, SGI, Sun raster, TGA (by
its header checks), WebP, XBM and XPM. Every decoder
raises ValueError (or its subclass UnsupportedCodec) for input it cannot
read, data that no reader claims included, and build_texture_pool turns
such an image into 1x1 white, as the reference does for any failed
decode.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from ..utils.image_io import read_image
from .dds import DDS_MAGIC, KTX2_MAGIC, sniff_decode

_SRGB_SLOT_KEYS = (
    "baseColorTexture",
    "emissiveTexture",
    "sheenColorTexture",
    "specularColorTexture",
    "diffuseTexture",
    "diffuseTransmissionColorTexture",
)


def _srgb_to_linear(c: np.ndarray) -> np.ndarray:
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4).astype(np.float32)


def find_srgb_images(model) -> set:
    """Image indices that must be sRGB-decoded (usage-based)."""
    srgb = set()

    def visit(tex_ref):
        if not isinstance(tex_ref, dict) or "index" not in tex_ref:
            return
        tex = model.textures[tex_ref["index"]]
        src = -1
        text = tex.get("extensions", {})
        for e in ("EXT_texture_webp", "MSFT_texture_dds", "KHR_texture_basisu"):
            if e in text and text[e].get("source") is not None:
                src = text[e]["source"]
                break
        if src < 0:
            src = tex.get("source", -1)
        if src >= 0:
            srgb.add(src)

    for mat in model.materials:
        pbr = mat.get("pbrMetallicRoughness", {})
        visit(pbr.get("baseColorTexture"))
        visit(mat.get("emissiveTexture"))
        for ext in mat.get("extensions", {}).values():
            if isinstance(ext, dict):
                for k in _SRGB_SLOT_KEYS:
                    visit(ext.get(k))
    return srgb


def _image_bytes(model, image: dict):
    if "bufferView" in image:
        bv = model.buffer_views[image["bufferView"]]
        buf = model.buffers[bv.get("buffer", 0)]
        off = bv.get("byteOffset", 0)
        return bytes(buf[off : off + bv["byteLength"]])
    if "uri" in image:
        uri = image["uri"]
        if uri.startswith("data:"):
            import base64

            return base64.b64decode(uri.split(",", 1)[1])
        from urllib.parse import unquote

        return (model.base_dir / unquote(uri)).read_bytes()
    return None


def decode_image(model, image: dict) -> np.ndarray:
    """Decode one glTF image to float32 RGBA [H,W,4] in [0,1]."""
    data = _image_bytes(model, image)
    if data is None:
        return np.ones((1, 1, 4), np.float32)
    try:
        if data[:4] == DDS_MAGIC or data[:12] == KTX2_MAGIC:
            # C order: the BGRA swizzle's fancy index leaves another memory layout, and the mip
            # chain's mean sums in layout order (the reference's DDS BGRA8 mips differ in the last bit)
            return np.ascontiguousarray(sniff_decode(data))
        px = read_image(data)
    except (struct.error, zlib.error, IndexError) as e:  # a truncated or corrupt file
        raise ValueError(f"corrupt image: {e!r}") from e
    px = px.astype(np.float32) / 255.0
    ch = px.shape[2]
    if ch == 1:  # gray
        px = np.concatenate([px, px, px, np.ones_like(px)], axis=-1)
    elif ch == 2:  # gray + alpha
        px = np.concatenate([px[..., :1]] * 3 + [px[..., 1:]], axis=-1)
    elif ch == 3:
        px = np.concatenate([px, np.ones_like(px[..., :1])], axis=-1)
    return px


def _mip_chain(img: np.ndarray, max_mips: int = 16) -> list:
    mips = [img]
    while min(img.shape[0], img.shape[1]) > 1 and len(mips) < max_mips:
        h, w = img.shape[:2]
        h2, w2 = max(h // 2, 1), max(w // 2, 1)
        img = img[: h2 * 2, : w2 * 2].reshape(h2, 2, w2, 2, 4).mean(axis=(1, 3))
        mips.append(img.astype(np.float32))
    return mips


def _quad_pack(mip: np.ndarray, out: np.ndarray) -> None:
    """[h,w,4] -> out [h*w,16] float32: row (y,x) = taps (x,y),(x+1,y),
    (x,y+1),(x+1,y+1), REPEAT wrap (the reference's rolls, written in
    place)."""
    h, w = mip.shape[:2]
    q = out.reshape(h, w, 4, 4)
    q[:, :, 0] = mip
    q[:, : w - 1, 1] = mip[:, 1:]
    q[:, w - 1, 1] = mip[:, 0]
    q[: h - 1, :, 2:] = q[1:, :, :2]
    q[h - 1, :, 2:] = q[0, :, :2]


def build_texture_pool(model, used_texinfos=None):
    """Decode all images -> (quads [K,16], desc [D,4], mip_table [ntex,max],
    num_mips [ntex]) (reference ops/textures.py:124). An image that fails to
    decode (ValueError, or an unreadable file) becomes 1x1 white, as in the
    reference. The catch is no wider, so that a device or programming error
    is not hidden."""
    del used_texinfos  # the reference takes it too and decodes every image
    srgb = find_srgb_images(model)
    mips = []
    desc_rows = []
    per_image_descs = []
    offset = 0
    for i, image in enumerate(model.images):
        try:
            img = decode_image(model, image)
        except (ValueError, OSError, EOFError):
            img = np.ones((1, 1, 4), np.float32)
        if i in srgb:
            img = np.concatenate([_srgb_to_linear(img[..., :3]), img[..., 3:4]], axis=-1)
        rows = []
        for mip in _mip_chain(img):
            h, w = mip.shape[:2]
            desc_rows.append([offset, w, h, 0])
            rows.append(len(desc_rows) - 1)
            mips.append(mip)
            offset += h * w
        per_image_descs.append(rows)

    if desc_rows:
        quads = np.empty((offset, 16), np.float32)
        for mip, (start, w, h, _) in zip(mips, desc_rows):
            _quad_pack(mip, quads[start : start + h * w])
    else:
        quads = np.ones((1, 16), np.float32)
        desc_rows = [[0, 1, 1, 0]]
        per_image_descs = [[0]]

    max_mips = max(len(r) for r in per_image_descs)
    ntex = len(per_image_descs)
    mip_table = np.full((ntex, max_mips), -1, np.int32)
    num_mips = np.zeros(ntex, np.int32)
    for i, rows in enumerate(per_image_descs):
        mip_table[i, : len(rows)] = rows
        num_mips[i] = len(rows)
        mip_table[i, len(rows) :] = rows[-1]  # pad with the coarsest mip

    return quads, np.asarray(desc_rows, np.int32), mip_table, num_mips


def _fetch_bilinear(quads, desc, uv):
    """One mip's bilinear fetch = one quad-row gather. desc: [...,4] i32
    (offset, w, h, _); uv in [0,1)."""
    w = desc[..., 1].to(torch.float32)
    h = desc[..., 2].to(torch.float32)
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    wi = desc[..., 1]
    hi = desc[..., 2]

    def wrap(v, n):
        return torch.remainder(v.to(torch.int32), torch.clamp(n, min=1))

    x0i = wrap(x0, wi)
    y0i = wrap(y0, hi)
    row = quads[(desc[..., 0] + y0i * wi + x0i).long()]
    c00, c10, c01, c11 = row[..., 0:4], row[..., 4:8], row[..., 8:12], row[..., 12:16]
    return (c00 * (1 - fx) + c10 * fx) * (1 - fy) + (c01 * (1 - fx) + c11 * fx) * fy


def sample_texture(scene, ti_slot, uv0, uv1, grad):
    """Sample through texture-info slots (KHR_texture_transform +
    trilinear by ray-cone footprint). ti_slot: [..] i32 (0 = none -> white);
    grad: [..] UV-space footprint; mip level = log2(grad * width).
    Returns [...,4] RGBA."""
    slot = ti_slot.long()
    idx = scene.ti_index[slot]
    texcoord = scene.ti_texcoord[slot]
    xf = scene.ti_uvxform[slot]  # [...,2,3]
    uv = torch.where((texcoord == 0)[..., None], uv0, uv1)
    u = xf[..., 0, 0] * uv[..., 0] + xf[..., 0, 1] * uv[..., 1] + xf[..., 0, 2]
    v = xf[..., 1, 0] * uv[..., 0] + xf[..., 1, 1] * uv[..., 1] + xf[..., 1, 2]
    uvt = torch.stack([u, v], dim=-1)
    uvt = uvt - torch.floor(uvt)  # REPEAT wrap

    safe_idx = torch.clamp(idx, min=0).long()
    nmips = scene.tex_num_mips[safe_idx].to(torch.float32)
    d0_ = scene.tex_desc[scene.tex_mip_table[safe_idx, 0].long()]
    lod = torch.log2(torch.clamp(grad * d0_[..., 1].to(torch.float32), min=1.0))
    lod = torch.minimum(torch.clamp(lod, min=0.0), nmips - 1.0)
    l0 = torch.floor(lod).to(torch.int64)
    l1 = torch.minimum(l0 + 1, (nmips - 1.0).to(torch.int64))
    fl = (lod - l0.to(torch.float32))[..., None]
    d0 = scene.tex_desc[scene.tex_mip_table[safe_idx, l0].long()]
    d1 = scene.tex_desc[scene.tex_mip_table[safe_idx, l1].long()]
    c0 = _fetch_bilinear(scene.tex_quads, d0, uvt)
    c1 = _fetch_bilinear(scene.tex_quads, d1, uvt)
    c = c0 * (1 - fl) + c1 * fl
    return torch.where((idx >= 0)[..., None], c, torch.ones_like(c))
