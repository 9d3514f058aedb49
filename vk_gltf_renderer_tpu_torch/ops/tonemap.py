"""Tonemap operators (port of vk_gltf_renderer_tpu/ops/tonemap.py):
filmic (default), aces, agx, khronos_pbr, reinhard_ext, none. Linear
radiance [..., 3] -> display-referred sRGB in [0, 1]. The AgX colour
matrices are applied as explicit multiply-adds, not a matmul."""

from __future__ import annotations

import torch

OPERATORS = ("filmic", "aces", "agx", "khronos_pbr", "reinhard_ext", "none")

_AGX_IN = ((0.842479, 0.0784336, 0.0792237), (0.0423282, 0.878468, 0.0791661),
           (0.0423756, 0.0784336, 0.879142))
_AGX_OUT = ((1.19688, -0.0980209, -0.0990297), (-0.0528968, 1.15190, -0.0989611),
            (-0.0529716, -0.0980434, 1.15107))


def linear_to_srgb(c):
    c = torch.clamp(c, 0.0, 1.0)
    return torch.where(c <= 0.0031308, c * 12.92, 1.055 * c ** (1.0 / 2.4) - 0.055)


def _filmic(c):
    """Uncharted2/Hable filmic."""
    A, B, C, D, E, F = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
    W = 11.2

    def hable(x):
        return ((x * (A * x + C * B) + D * E) / (x * (A * x + B) + D * F)) - E / F

    exposure_bias = 2.0
    white = hable(torch.tensor(W, dtype=torch.float32, device=c.device))
    return torch.clamp(hable(c * exposure_bias) / white, 0.0, 1.0)


def _aces(c):
    """Narkowicz ACES approximation."""
    a, b, cc, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((c * (a * c + b)) / (c * (cc * c + d) + e), 0.0, 1.0)


def _mat3(m, v):
    return torch.stack([m[i][0] * v[..., 0] + m[i][1] * v[..., 1] + m[i][2] * v[..., 2]
                        for i in range(3)], dim=-1)


def _agx(c):
    """AgX approximation (Wrensch / Sobotka fit)."""
    v = _mat3(_AGX_IN, c)
    v = torch.clamp((torch.log2(torch.clamp(v, min=1e-10)) + 12.47393) / 16.5, 0.0, 1.0)
    v2 = v * v
    v4 = v2 * v2
    v = 15.5 * v4 * v2 - 40.14 * v4 * v + 31.96 * v4 - 6.868 * v2 * v + 0.4298 * v2 + 0.1191 * v - 0.00232
    return torch.clamp(_mat3(_AGX_OUT, v), 0.0, 1.0)


def _khronos_pbr(c):
    """Khronos PBR neutral tone mapper."""
    start_compression = 0.8 - 0.04
    desaturation = 0.15
    x = torch.amin(c, dim=-1, keepdim=True)
    offset = torch.where(x < 0.08, x - 6.25 * x * x, 0.04)
    c = c - offset
    peak = torch.amax(c, dim=-1, keepdim=True)
    new_peak = 1.0 - (1.0 - start_compression) ** 2 / torch.clamp(peak + 1.0 - 2.0 * start_compression, min=1e-6)
    scale = torch.where(peak > start_compression, new_peak / torch.clamp(peak, min=1e-6), 1.0)
    c = c * scale
    g = 1.0 / (desaturation * torch.clamp(peak - new_peak, min=0.0) / torch.clamp(new_peak, min=1e-6) + 1.0)
    g = torch.where(peak > start_compression, g, 1.0)
    return torch.clamp(c * g + new_peak * (1.0 - g), 0.0, 1.0)


def _reinhard_ext(c, white=4.0):
    return torch.clamp(c * (1.0 + c / (white * white)) / (1.0 + c), 0.0, 1.0)


def tonemap(c, operator: str = "filmic", exposure: float = 1.0):
    """Linear HDR -> sRGB display; an unknown operator name means filmic,
    as in the reference."""
    c = torch.clamp(c, min=0.0) * exposure
    if operator == "none":
        return torch.clamp(c, 0.0, 1.0)  # linear passthrough, no sRGB curve
    out = {"aces": _aces, "agx": _agx, "khronos_pbr": _khronos_pbr,
           "reinhard_ext": _reinhard_ext}.get(operator, _filmic)(c)
    return linear_to_srgb(out)
