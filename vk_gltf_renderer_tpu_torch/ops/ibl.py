"""Image-based-lighting prefilter for the preview: port of
vk_gltf_renderer_tpu/ops/ibl.py.

The reference's raster path shades with a cosine-convolved diffuse map, a
GGX-prefiltered glossy chain and a split-sum BRDF LUT; here they are small
equirect (lat-long) maps, integrated over a fixed Hammersley set of 128
samples:

  build_ibl(env, env_kind) -> {
      "irr":   [16, 32, 3]      cosine-convolved irradiance / pi
      "spec":  [5, 32, 64, 3]   GGX-prefiltered radiance per roughness level
      "brdf":  [32, 32, 2]      split-sum (scale, bias) over (roughness, NdotV)
  }

Plain torch; under the HDR the environment lookups go through the gather
kernel (ops/hdr.eval_hdr).
"""

from __future__ import annotations

import math

import torch

from .sky import _onb  # the same basis as the reference's copy in ops/ibl.py

IRR_H, IRR_W = 16, 32
SPEC_H, SPEC_W = 32, 64
SPEC_LEVELS = 5
BRDF_N = 32
SAMPLES = 128


def _hammersley(n, device=None):
    """[n,2] Hammersley points (i / n, radical inverse of i in base 2); the
    bit reversal runs on int64 masked to 32 bits."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    m32 = 0xFFFFFFFF
    bits = ((i << 16) | (i >> 16)) & m32
    bits = ((bits & 0x55555555) << 1) | ((bits & 0xAAAAAAAA) >> 1)
    bits = ((bits & 0x33333333) << 2) | ((bits & 0xCCCCCCCC) >> 2)
    bits = ((bits & 0x0F0F0F0F) << 4) | ((bits & 0xF0F0F0F0) >> 4)
    bits = ((bits & 0x00FF00FF) << 8) | ((bits & 0xFF00FF00) >> 8)
    return torch.stack([i.to(torch.float32) / n, bits.to(torch.float32) * 2.3283064365386963e-10], -1)


def _latlong_dirs(h, w, device=None):
    """Texel-centre directions [h,w,3] of an equirect map (+Y up, phi from -Z)."""
    v = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
    u = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
    theta = v * math.pi  # 0 = up
    phi = u * 2.0 * math.pi - math.pi
    st = torch.sin(theta)[:, None]
    y = torch.cos(theta)[:, None].expand(h, w)
    x = st * torch.sin(phi)[None, :]
    z = -st * torch.cos(phi)[None, :]
    return torch.stack([x, y, z], -1)


def _ggx_sample(u2, rough):
    """GGX half vector in tangent space (alpha = rough^2)."""
    a = torch.clamp(rough * rough, min=1e-4)
    phi = 2.0 * math.pi * u2[..., 0]
    ct = torch.sqrt((1.0 - u2[..., 1]) / (1.0 + (a * a - 1.0) * u2[..., 1]))
    st = torch.sqrt(torch.clamp(1.0 - ct * ct, min=0.0))
    return torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], -1)


def _in_frame(basis, local):
    """sum_k basis[k][None] * local[:, k] over the three axes: [S,H,W,3]
    directions from a per-texel frame and [S,3] local vectors."""
    return sum(basis[k][None] * local[:, k][:, None, None, None] for k in range(3))


def build_ibl(env, env_kind: str, samples: int = SAMPLES):
    """Prefilter the environment (SkyEnv or HdrEnv) into the irradiance
    map, the glossy chain and the BRDF LUT, on the environment's device."""
    from .pathtrace import RenderConfig, sample_environment

    cfg = RenderConfig(env_kind=env_kind)
    dev = env.img.device if env_kind == "hdr" else env.sun_dir.device

    def radiance(d):
        c, _ = sample_environment(env, d.reshape(-1, 3), cfg)
        return c.reshape(d.shape)

    xi = _hammersley(samples, dev)

    # diffuse irradiance: cosine-weighted Monte Carlo, already / pi
    nrm = _latlong_dirs(IRR_H, IRR_W, dev)
    t, b = _onb(nrm)
    phi = 2.0 * math.pi * xi[:, 0]
    st = torch.sqrt(xi[:, 1])
    local = torch.stack([st * torch.cos(phi), st * torch.sin(phi), torch.sqrt(1.0 - xi[:, 1])], -1)
    irr = torch.mean(radiance(_in_frame((t, b, nrm), local)), dim=0)

    # glossy chain: GGX-prefiltered radiance, one level per roughness li / 4
    rdirs = _latlong_dirs(SPEC_H, SPEC_W, dev)
    rt, rb = _onb(rdirs)
    levels = [radiance(rdirs)]
    for li in range(1, SPEC_LEVELS):
        hvec = _in_frame((rt, rb, rdirs), _ggx_sample(xi, torch.tensor(li / (SPEC_LEVELS - 1), device=dev)))
        # reflect the view (= R) about h: l = 2 (v.h) h - v with v = rdirs
        vh = torch.sum(rdirs[None] * hvec, -1, keepdim=True)
        ld = 2.0 * vh * hvec - rdirs[None]
        w = torch.clamp(torch.sum(rdirs[None] * ld, -1), min=0.0)[..., None]
        num = torch.sum(radiance(ld) * w, dim=0)
        den = torch.clamp(torch.sum(w, dim=0), min=1e-4)
        levels.append(num / den)
    spec = torch.stack(levels)

    # split-sum BRDF LUT (scale, bias) [Karis 2013], rows roughness, columns NdotV
    nv = (torch.arange(BRDF_N, dtype=torch.float32, device=dev) + 0.5) / BRDF_N
    rg, nvg = torch.meshgrid(nv, nv, indexing="ij")
    v = torch.stack([torch.sqrt(1.0 - nvg * nvg), torch.zeros_like(nvg), nvg], -1)
    a_lut = torch.clamp(rg * rg, min=1e-4)
    h = _ggx_sample(xi[:, None, None, :], rg)  # [S,B,B,3]
    vh = torch.sum(v * h, -1)
    lz = 2.0 * vh * h[..., 2] - v[..., 2]
    nl = torch.clamp(lz, min=0.0)
    nh = torch.clamp(h[..., 2], min=0.0)
    nvc = torch.clamp(nvg, min=1e-4)
    vis = torch.where(nl > 0, 1.0, 0.0)
    # Smith G for GGX (Schlick-k form), over the pdf terms
    k = a_lut * a_lut / 2.0
    g1v = nvc / (nvc * (1.0 - k) + k)
    g1l = nl / (nl * (1.0 - k) + k + 1e-6)
    g = g1v * g1l
    g_vis = torch.where(nh > 0, g * vh / torch.clamp(nh * nvc, min=1e-6), 0.0) * vis
    fc = (1.0 - torch.clamp(vh, min=0.0)) ** 5
    brdf = torch.stack([torch.sum((1.0 - fc) * g_vis, 0), torch.sum(fc * g_vis, 0)], -1) / samples

    return {"irr": irr, "spec": spec, "brdf": brdf}


def _sample_latlong(img, d):
    """Bilinear lookup of an equirect map img [H,W,C] in directions d [N,3],
    wrapping in longitude."""
    h, w = img.shape[0], img.shape[1]
    theta = torch.acos(torch.clamp(d[..., 1], -1.0, 1.0))
    phi = torch.atan2(d[..., 0], -d[..., 2])
    v = theta / math.pi * h - 0.5
    u = (phi + math.pi) / (2.0 * math.pi) * w - 0.5
    x0 = torch.floor(u).to(torch.int64)
    y0 = torch.clamp(torch.floor(v).to(torch.int64), 0, h - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    fx = (u - torch.floor(u))[..., None]
    fy = (v - y0)[..., None]
    xa = torch.remainder(x0, w)
    xb = torch.remainder(x0 + 1, w)
    return (
        img[y0, xa] * (1 - fx) * (1 - fy)
        + img[y0, xb] * fx * (1 - fy)
        + img[y1, xa] * (1 - fx) * fy
        + img[y1, xb] * fx * fy
    )


def ibl_diffuse(ibl, n):
    """Cosine-convolved irradiance / pi for normals n [N,3]."""
    return _sample_latlong(ibl["irr"], n)


def ibl_specular(ibl, r, rough, f0, n_dot_v):
    """Split-sum specular: the prefiltered radiance along r, interpolated
    between the two roughness levels around `rough`, times the BRDF LUT's
    f0 * scale + bias."""
    lvl = torch.clamp(rough, 0.0, 1.0) * (SPEC_LEVELS - 1)
    l0 = torch.clamp(torch.floor(lvl).to(torch.int64), 0, SPEC_LEVELS - 1)
    l1 = torch.clamp(l0 + 1, 0, SPEC_LEVELS - 1)
    f = (lvl - l0)[..., None]
    # every level's lookup, then each lane's two levels
    per_level = torch.stack([_sample_latlong(ibl["spec"][i], r) for i in range(SPEC_LEVELS)])
    lane = torch.arange(r.shape[0], device=r.device)
    pre = per_level[l0, lane] * (1 - f) + per_level[l1, lane] * f
    bi = torch.clamp((n_dot_v * BRDF_N).to(torch.int64), 0, BRDF_N - 1)
    ri = torch.clamp((rough * BRDF_N).to(torch.int64), 0, BRDF_N - 1)
    ab = ibl["brdf"][ri, bi]
    return pre * (f0 * ab[..., 0:1] + ab[..., 1:2])
