"""HDR environment: Radiance (.hdr/RGBE) loader, alias-table importance
sampling, evaluation (port of vk_gltf_renderer_tpu/ops/hdr.py).

Conventions: lat-long u = 0.5 + atan2(d.x, -d.z) / 2pi, v = acos(d.y) / pi;
`rotation` spins the map about +Y; pdfs are solid-angle densities.

The reduced RED_H x RED_W sampling map is kept as the reference has it:
sampling, NEE radiance and pdf all come from it, so it defines the
estimator's pdf. The full-resolution map only serves the directly visible
background (ops/pathtrace._hdr_background_fixup). Lookups into the reduced
map go through the gather kernel (ops/gather.py).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .gather import gather_channels

RED_H, RED_W = 64, 128


def read_hdr(path) -> np.ndarray:
    """Decode a Radiance RGBE .hdr file -> float32 [H,W,3]."""
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    if not data.startswith(b"#?"):
        raise ValueError("not a Radiance HDR file")
    while True:  # header ends with an empty line
        eol = data.index(b"\n", pos)
        line = data[pos:eol]
        pos = eol + 1
        if line == b"":
            break
    eol = data.index(b"\n", pos)
    res = data[pos:eol].decode().split()
    pos = eol + 1
    if res[0] != "-Y" or res[2] != "+X":
        raise ValueError(f"unsupported HDR orientation {res}")
    h, w = int(res[1]), int(res[3])

    rgbe = np.zeros((h, w, 4), np.uint8)
    buf = np.frombuffer(data, np.uint8, offset=pos)
    bi = 0
    for y in range(h):
        if buf[bi] == 2 and buf[bi + 1] == 2 and (int(buf[bi + 2]) << 8 | int(buf[bi + 3])) == w:
            bi += 4  # adaptive RLE scanline
            for c in range(4):
                x = 0
                while x < w:
                    count = int(buf[bi])
                    bi += 1
                    if count > 128:  # run
                        rgbe[y, x : x + count - 128, c] = buf[bi]
                        bi += 1
                        x += count - 128
                    else:  # literal
                        rgbe[y, x : x + count, c] = buf[bi : bi + count]
                        bi += count
                        x += count
        else:  # flat scanline
            rgbe[y] = buf[bi : bi + w * 4].reshape(w, 4)
            bi += w * 4
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(1.0, e - 136), 0.0)  # 2^(e-128-8)
    return rgbe[..., :3].astype(np.float32) * scale[..., None].astype(np.float32)


def write_hdr(path, rgb: np.ndarray) -> None:
    """float [H,W,3] -> Radiance .hdr with flat (uncompressed) RGBE
    scanlines, the layout read_hdr's flat branch decodes."""
    rgb = np.asarray(rgb, np.float64)
    h, w = rgb.shape[:2]
    m = rgb.max(axis=-1)
    mant, ex = np.frexp(m)
    scale = np.where(m > 1e-32, mant * 256.0 / np.maximum(m, 1e-32), 0.0)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(rgb * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(m > 1e-32, ex + 128, 0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())


def _build_alias_table(weights: np.ndarray):
    """Walker alias method. Returns (prob [N] f32, alias [N] i32)."""
    n = weights.size
    w = weights.astype(np.float64)
    total = w.sum()
    if total <= 0:
        return np.ones(n, np.float32), np.arange(n, dtype=np.int32)
    p = w * n / total
    alias = np.arange(n, dtype=np.int32)
    prob = np.ones(n, np.float32)
    small = [i for i in range(n) if p[i] < 1.0]
    large = [i for i in range(n) if p[i] >= 1.0]
    while small and large:
        s = small.pop()
        l = large.pop()
        prob[s] = p[s]
        alias[s] = l
        p[l] = p[l] - (1.0 - p[s])
        (small if p[l] < 1.0 else large).append(l)
    for i in large + small:
        prob[i] = 1.0
    return prob, alias


def _downsample(rgb: np.ndarray) -> np.ndarray:
    """Energy-preserving block mean onto the RED_H x RED_W grid."""
    h, w = rgb.shape[:2]
    ry = np.arange(h) * RED_H // h
    rx = np.arange(w) * RED_W // w
    acc = np.zeros((RED_H, RED_W, 3), np.float64)
    cnt = np.zeros((RED_H, RED_W), np.float64)
    np.add.at(acc, (ry[:, None].repeat(w, 1), rx[None, :].repeat(h, 0)), rgb)
    np.add.at(cnt, (ry[:, None].repeat(w, 1), rx[None, :].repeat(h, 0)), 1.0)
    return (acc / np.maximum(cnt, 1.0)[..., None]).astype(np.float32)


def build_environment(rgb: np.ndarray, intensity: float = 1.0, rotation: float = 0.0) -> dict:
    """Lat-long HDR -> the reference's env dict as numpy: img [H,W,4]
    (rgb + pdf), samp [6, RED_H*RED_W] (prob, alias, r, g, b, pdf of the
    reduced map), intensity, rotation."""
    h, w = rgb.shape[:2]
    lum = 0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]
    theta = (np.arange(h) + 0.5) / h * np.pi
    sin_t = np.sin(theta)[:, None]
    d_omega = (2.0 * np.pi / w) * (np.pi / h) * np.maximum(sin_t, 1e-8)
    total = (lum * sin_t).sum()
    pdf = np.where(total > 0, lum * sin_t / np.maximum(total, 1e-20) / d_omega, 1.0 / (4 * np.pi))
    img = np.concatenate([rgb, pdf[..., None]], axis=-1).astype(np.float32)

    rgb_s = _downsample(rgb)
    lum_s = 0.2126 * rgb_s[..., 0] + 0.7152 * rgb_s[..., 1] + 0.0722 * rgb_s[..., 2]
    theta_s = (np.arange(RED_H) + 0.5) / RED_H * np.pi
    sin_s = np.sin(theta_s)[:, None]
    prob_s, alias_s = _build_alias_table((lum_s * sin_s).reshape(-1))
    dom_s = (2.0 * np.pi / RED_W) * (np.pi / RED_H) * np.maximum(sin_s, 1e-8)
    tot_s = (lum_s * sin_s).sum()
    pdf_s = np.where(tot_s > 0, lum_s * sin_s / np.maximum(tot_s, 1e-20) / dom_s, 1.0 / (4 * np.pi))
    samp = np.stack(
        [prob_s, alias_s.astype(np.float32), rgb_s[..., 0].reshape(-1), rgb_s[..., 1].reshape(-1),
         rgb_s[..., 2].reshape(-1), pdf_s.reshape(-1).astype(np.float32)]
    ).astype(np.float32)
    return {"img": img, "samp": samp, "intensity": np.float32(intensity),
            "rotation": np.float32(rotation)}


@dataclass
class HdrEnv:
    """Device HDR environment."""

    img: torch.Tensor  # [H,W,4] f32 full-resolution rgb + pdf
    samp: torch.Tensor  # [6, RED_H*RED_W] f32
    intensity: torch.Tensor  # 0-d f32
    rotation: torch.Tensor  # 0-d f32

    @classmethod
    def from_arrays(cls, arrays, device) -> "HdrEnv":
        """Any mapping with the reference's HDR keys (numpy or jax arrays)."""
        return cls(**{k: torch.tensor(np.asarray(arrays[k], np.float32), device=device).contiguous()
                      for k in cls.__dataclass_fields__})


def load_hdr_environment(path, device, intensity: float = 1.0, rotation: float = 0.0) -> HdrEnv:
    return HdrEnv.from_arrays(build_environment(read_hdr(path), intensity, rotation), device)


def _rotate_y(d, ang):
    c, s = torch.cos(ang), torch.sin(ang)
    return torch.stack([c * d[..., 0] + s * d[..., 2], d[..., 1], -s * d[..., 0] + c * d[..., 2]], dim=-1)


def _spherical_uv(d):
    u = 0.5 + torch.atan2(d[..., 0], -d[..., 2]) / (2.0 * math.pi)
    v = torch.acos(torch.clamp(d[..., 1], -1.0, 1.0)) / math.pi
    return u, v


def _uv_dir(u, v):
    theta = v * math.pi
    phi = (u - 0.5) * 2.0 * math.pi
    sin_t = torch.sin(theta)
    return torch.stack([sin_t * torch.sin(phi), torch.cos(theta), -sin_t * torch.cos(phi)], dim=-1)


def eval_hdr(env: HdrEnv, d, full=False):
    """(radiance, pdf) for directions d [N,3]. Default: the reduced map via
    the gather kernel (the pdf sample_hdr uses). full=True: the
    full-resolution image, for the directly visible background only."""
    dl = _rotate_y(d, -env.rotation)
    u, v = _spherical_uv(dl)
    if full:
        h, w = env.img.shape[0], env.img.shape[1]
        x = torch.clamp((u * w).to(torch.int32), 0, w - 1).long()
        y = torch.clamp((v * h).to(torch.int32), 0, h - 1).long()
        texel = env.img[y, x]
        return texel[..., :3] * env.intensity, texel[..., 3]
    x = torch.clamp((u * RED_W).to(torch.int32), 0, RED_W - 1)
    y = torch.clamp((v * RED_H).to(torch.int32), 0, RED_H - 1)
    ch = gather_channels(env.samp[2:6], (y * RED_W + x).reshape(-1))
    shp = d.shape[:-1]
    rgb = torch.stack([ch[0], ch[1], ch[2]], dim=-1).reshape(shp + (3,))
    return rgb * env.intensity, ch[3].reshape(shp)


def sample_hdr(env: HdrEnv, u3):
    """Alias-table importance sample of the reduced map:
    (direction, radiance, pdf)."""
    n = RED_H * RED_W
    shp = u3.shape[:-1]
    q = (u3[..., 0] * n).reshape(-1)
    j = torch.clamp(q.to(torch.int32), 0, n - 1)
    frac = q - j.to(torch.float32)
    pa = gather_channels(env.samp[0:2], j)
    take_alias = frac > pa[0]
    idx = torch.where(take_alias, pa[1].to(torch.int32), j)
    ch = gather_channels(env.samp[2:6], idx)
    y = torch.div(idx, RED_W, rounding_mode="floor")
    x = idx - y * RED_W
    u = (x.to(torch.float32).reshape(shp) + u3[..., 1]) / RED_W
    v = (y.to(torch.float32).reshape(shp) + u3[..., 2]) / RED_H
    d = _uv_dir(u, v)
    rgb = torch.stack([ch[0], ch[1], ch[2]], dim=-1).reshape(shp + (3,))
    d = _rotate_y(d, env.rotation)
    return d, rgb * env.intensity, ch[3].reshape(shp)
