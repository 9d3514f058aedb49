"""Sheen directional-albedo LUT (Charlie NDF + Ashikhmin visibility).

Port of vk_gltf_renderer_tpu/ops/sheen_lut.py. compute_sheen_lut is the
reference's numpy integration, copied as it stands (tests/test_torch_materials.py
holds the table equal to the original): E(cos_v, alpha) of the same sheen
BRDF ops/bsdf._sheen_eval evaluates, integrated once at first use over the
hemisphere,

  E(v, a) = int f_sheen(v, l) cos(theta_l) dl   (white sheen_color)

sheen_albedo is the bilinear lookup in torch, on a copy of the table
cached per device.
"""

from __future__ import annotations

import numpy as np
import torch

_N_COS = 32  # cos(theta_v) resolution
_N_ALPHA = 32  # sheen alpha = roughness^2 resolution
_lut_cache = None
_device_luts: dict = {}


def _charlie_d_np(h_z, alpha):
    a = np.maximum(alpha, 1e-3)
    sin2 = np.maximum(0.0, 1.0 - h_z * h_z)
    return (2.0 + 1.0 / a) * (sin2 ** (0.5 / a)) / (2.0 * np.pi)


def compute_sheen_lut() -> np.ndarray:
    """[cos_v, alpha] directional albedo, Gauss-Legendre over the hemisphere."""
    global _lut_cache
    if _lut_cache is not None:
        return _lut_cache
    n_mu, n_phi = 64, 64
    mu_l, w_mu = np.polynomial.legendre.leggauss(n_mu)  # over [-1,1]
    mu_l = 0.5 * (mu_l + 1.0)  # cos(theta_l) in [0,1]
    w_mu = 0.5 * w_mu
    phi = (np.arange(n_phi) + 0.5) * (2.0 * np.pi / n_phi)
    w_phi = 2.0 * np.pi / n_phi

    cos_v = np.linspace(1.0 / (2 * _N_COS), 1.0 - 1.0 / (2 * _N_COS), _N_COS)
    alpha = np.linspace(1e-3, 1.0, _N_ALPHA)

    sin_l = np.sqrt(np.maximum(0.0, 1.0 - mu_l**2))
    lx = sin_l[:, None] * np.cos(phi)[None, :]  # [mu, phi]
    lz = np.broadcast_to(mu_l[:, None], lx.shape)

    out = np.empty((_N_COS, _N_ALPHA), np.float32)
    for i, cv in enumerate(cos_v):
        sv = np.sqrt(max(0.0, 1.0 - cv * cv))
        # v in the xz-plane; h = normalize(v + l)
        hx = sv + lx
        hz = cv + lz
        hy = sin_l[:, None] * np.sin(phi)[None, :]
        h_norm = np.sqrt(hx * hx + hy * hy + hz * hz)
        h_z = hz / np.maximum(h_norm, 1e-12)
        denom = 4.0 * (cv + lz - cv * lz)
        vis = 1.0 / np.maximum(denom, 1e-6)
        for j, a in enumerate(alpha):
            f = _charlie_d_np(h_z, a) * vis  # f_sheen (white)
            integrand = f * lz  # * cos(theta_l)
            out[i, j] = float((integrand * w_mu[:, None]).sum() * w_phi)
    # the Ashikhmin visibility overshoots slightly at grazing angles; the
    # albedo-scaling consumer needs E <= 1 (it darkens the base by 1 - E)
    np.minimum(out, 1.0, out=out)
    _lut_cache = out
    return out


def _lut_on(device) -> torch.Tensor:
    key = str(torch.device(device))
    lut = _device_luts.get(key)
    if lut is None:
        lut = torch.tensor(compute_sheen_lut(), device=device)
        _device_luts[key] = lut
    return lut


def sheen_albedo(ndotv, sheen_roughness):
    """Bilinear LUT lookup E(cos_v, alpha = roughness^2) of tensors (or
    floats, then on the CPU)."""
    ndotv = torch.as_tensor(ndotv, dtype=torch.float32)
    sheen_roughness = torch.as_tensor(sheen_roughness, dtype=torch.float32, device=ndotv.device)
    lut = _lut_on(ndotv.device)
    cv = torch.clamp(ndotv, 0.0, 1.0) * (_N_COS - 1)
    av = torch.clamp(sheen_roughness**2, 0.0, 1.0) * (_N_ALPHA - 1)
    c0 = torch.clamp(torch.floor(cv).long(), 0, _N_COS - 2)
    a0 = torch.clamp(torch.floor(av).long(), 0, _N_ALPHA - 2)
    fc = cv - c0
    fa = av - a0
    return (
        lut[c0, a0] * (1 - fc) * (1 - fa)
        + lut[c0 + 1, a0] * fc * (1 - fa)
        + lut[c0, a0 + 1] * (1 - fc) * fa
        + lut[c0 + 1, a0 + 1] * fc * fa
    )
