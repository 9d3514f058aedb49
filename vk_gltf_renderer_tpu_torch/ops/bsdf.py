"""glTF PBR BSDF: evaluate / sample, batched and branch-free (port of
vk_gltf_renderer_tpu/ops/bsdf.py).

Lobes are gated statically by the scene feature set, as in the reference.
Ported: Lambert diffuse and anisotropic GGX reflection (Heitz VNDF
sampling, height-correlated Smith, impulse mirror below the roughness
floor) — the lobes a scene without transmission, clearcoat, sheen,
diffuse transmission or iridescence compiles in. A feature set naming one
of those raises NotImplementedError (ROADMAP.md lists them).

bsdf_evaluate(pbr, k1, k2, features) -> dict(bsdf_diffuse, bsdf_glossy, pdf)
    (both terms include the cosine factor)
bsdf_sample(pbr, k1, u3, extra_u, features) -> dict(k2, bsdf_over_pdf, pdf, event)
"""

from __future__ import annotations

import math

import torch

from .traverse import cross3, dot3

DIRAC = -1.0

EVENT_ABSORB = 0
EVENT_DIFFUSE = 1
EVENT_GLOSSY_REFLECTION = 2
EVENT_IMPULSE_REFLECTION = 3
EVENT_GLOSSY_TRANSMISSION = 4
EVENT_IMPULSE_TRANSMISSION = 5
EVENT_DIFFUSE_TRANSMISSION = 6

_MIN_ALPHA = 1e-6
_IMPULSE_ALPHA = 4.0e-6  # alpha below this on both axes -> mirror impulse

_UNPORTED_LOBES = ("transmission", "clearcoat", "sheen", "diffuse_transmission", "iridescence")


def _check_lobes(features) -> None:
    if features is None:
        raise NotImplementedError("bsdf needs the scene feature set (all-lobe mode is not ported)")
    bad = [f for f in _UNPORTED_LOBES if f in features]
    if bad:
        raise NotImplementedError(f"BSDF lobes not ported yet: {', '.join(bad)}")


def _luminance(c):
    return 0.2126 * c[..., 0] + 0.7152 * c[..., 1] + 0.0722 * c[..., 2]


def _to_local(v, T, B, N):
    return torch.stack([dot3(v, T), dot3(v, B), dot3(v, N)], dim=-1)


def _from_local(v, T, B, N):
    return v[..., 0:1] * T + v[..., 1:2] * B + v[..., 2:3] * N


def _schlick1(f0, cos_theta):
    m = torch.clamp(1.0 - cos_theta, 0.0, 1.0)
    return f0 + (1.0 - f0) * m**5


def _schlick3(f0, cos_theta):
    m = torch.clamp(1.0 - cos_theta, 0.0, 1.0)
    return f0 + (1.0 - f0) * (m**5)[..., None]


def _ggx_d(h_l, ax, ay):
    """Anisotropic GGX NDF; h_l in the local frame."""
    x = h_l[..., 0] / torch.clamp(ax, min=_MIN_ALPHA)
    y = h_l[..., 1] / torch.clamp(ay, min=_MIN_ALPHA)
    z = h_l[..., 2]
    d = x * x + y * y + z * z
    return 1.0 / (math.pi * torch.clamp(ax, min=_MIN_ALPHA) * torch.clamp(ay, min=_MIN_ALPHA)
                  * torch.clamp(d * d, min=1e-20))


def _ggx_lambda(w_l, ax, ay):
    x = w_l[..., 0] * ax
    y = w_l[..., 1] * ay
    z = w_l[..., 2]
    return 0.5 * (-1.0 + torch.sqrt(1.0 + (x * x + y * y) / torch.clamp(z * z, min=1e-12)))


def _ggx_g2(wo_l, wi_l, ax, ay):
    return 1.0 / (1.0 + _ggx_lambda(wo_l, ax, ay) + _ggx_lambda(wi_l, ax, ay))


def _ggx_g1(w_l, ax, ay):
    return 1.0 / (1.0 + _ggx_lambda(w_l, ax, ay))


def _sample_vndf(wo_l, ax, ay, u1, u2):
    """Heitz 2018 sampling of the GGX distribution of visible normals."""
    v = torch.stack([wo_l[..., 0] * ax, wo_l[..., 1] * ay, wo_l[..., 2]], dim=-1)
    v = v / torch.sqrt(dot3(v, v))[..., None]
    lensq = v[..., 0] ** 2 + v[..., 1] ** 2
    inv = 1.0 / torch.sqrt(torch.clamp(lensq, min=1e-20))
    t1 = torch.where(
        (lensq > 1e-16)[..., None],
        torch.stack([-v[..., 1] * inv, v[..., 0] * inv, torch.zeros_like(inv)], dim=-1),
        torch.tensor([1.0, 0.0, 0.0], device=v.device).expand(v.shape),
    )
    t2 = cross3(v, t1)
    r = torch.sqrt(u1)
    phi = 2.0 * math.pi * u2
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + v[..., 2])
    p2 = (1.0 - s) * torch.sqrt(torch.clamp(1.0 - p1 * p1, min=0.0)) + s * p2
    p3 = torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=0.0))
    nh = p1[..., None] * t1 + p2[..., None] * t2 + p3[..., None] * v
    h = torch.stack([ax * nh[..., 0], ay * nh[..., 1], torch.clamp(nh[..., 2], min=1e-6)], dim=-1)
    return h / torch.sqrt(dot3(h, h))[..., None]


def _vndf_pdf(wo_l, h_l, ax, ay):
    """pdf of _sample_vndf in half-vector measure: G1 * D * (wo.h) / wo.z."""
    d = _ggx_d(h_l, ax, ay)
    g1 = _ggx_g1(wo_l, ax, ay)
    return g1 * d * torch.clamp(dot3(wo_l, h_l), min=0.0) / torch.clamp(torch.abs(wo_l[..., 2]), min=1e-8)


def _cos_hemisphere(N, T, B, u1, u2):
    r = torch.sqrt(u1)
    phi = 2.0 * math.pi * u2
    local = torch.stack([r * torch.cos(phi), r * torch.sin(phi),
                         torch.sqrt(torch.clamp(1.0 - u1, min=0.0))], dim=-1)
    return _from_local(local, T, B, N)


def _f0_dielectric(pbr):
    """glTF dielectric F0 with KHR_materials_specular scaling."""
    ior1, ior2 = pbr["ior1"], pbr["ior2"]
    f = ((ior2 - ior1) / torch.clamp(ior2 + ior1, min=1e-6)) ** 2
    return torch.clamp(f[..., None] * pbr["specular_color"], max=1.0) * pbr["specular"][..., None]


def _lobe_weights(pbr, k1):
    """Sampling probabilities of the diffuse and glossy lobes
    (Fresnel-aware, luminance-weighted)."""
    n_dot_v = torch.abs(dot3(pbr["N"], k1))
    f0 = _f0_dielectric(pbr)
    f_diel = _schlick1(_luminance(f0), n_dot_v)
    f_metal = _schlick1(_luminance(pbr["base_color"]), n_dot_v)
    m = pbr["metallic"]
    w_glossy = m * f_metal + (1.0 - m) * f_diel
    w_diffuse = (1.0 - m) * _luminance(pbr["base_color"]) * (1.0 - f_diel)
    total = torch.clamp(w_diffuse + w_glossy, min=1e-8)
    return w_diffuse / total, w_glossy / total


def bsdf_evaluate(pbr, k1, k2, features):
    """Evaluate the lobes for light direction k2 (the NEE path). Returns
    bsdf_diffuse / bsdf_glossy with the cosine included, and the sampling
    pdf for MIS."""
    _check_lobes(features)
    N, T, B = pbr["N"], pbr["T"], pbr["B"]
    k1_l = _to_local(k1, T, B, N)
    k2_l = _to_local(k2, T, B, N)
    n_dot_l = k2_l[..., 2]
    n_dot_v = torch.abs(k1_l[..., 2])
    refl_side = n_dot_l > 0.0

    # pbr["roughness"] holds alpha = roughness^2, consumed directly
    ax = torch.clamp(pbr["roughness"][..., 0], min=_MIN_ALPHA)
    ay = torch.clamp(pbr["roughness"][..., 1], min=_MIN_ALPHA)

    h = k1_l + k2_l
    h = h / torch.clamp(torch.sqrt(dot3(h, h)), min=1e-12)[..., None]
    v_dot_h = torch.clamp(dot3(k1_l, h), min=0.0)

    f0_d = _f0_dielectric(pbr)
    m = pbr["metallic"][..., None]
    f0 = f0_d * (1.0 - m) + pbr["base_color"] * m
    fr = _schlick3(f0, v_dot_h)

    d = _ggx_d(h, ax, ay)
    g2 = _ggx_g2(k1_l, k2_l, ax, ay)
    glossy = fr * (d * g2 / torch.clamp(4.0 * n_dot_v, min=1e-8))[..., None]  # f * n.l

    kd = 1.0 - pbr["metallic"]
    f_diel_l = _schlick1(_luminance(f0_d), v_dot_h)
    diffuse = pbr["base_color"] * (kd * (1.0 - f_diel_l) / math.pi * torch.clamp(n_dot_l, min=0.0))[..., None]

    glossy = torch.where(refl_side[..., None], glossy, torch.zeros_like(glossy))

    w_d, w_g = _lobe_weights(pbr, k1)
    pdf_d = torch.clamp(n_dot_l, min=0.0) / math.pi
    pdf_g = _vndf_pdf(k1_l, h, ax, ay) / torch.clamp(4.0 * v_dot_h, min=1e-8)
    pdf = w_d * pdf_d + w_g * torch.where(refl_side, pdf_g, 0.0)
    pdf = torch.where(refl_side, pdf, 0.0)
    return {"bsdf_diffuse": diffuse, "bsdf_glossy": glossy, "pdf": pdf}


def bsdf_sample(pbr, k1, u, extra_u, features):
    """Sample an outgoing direction. u: [...,3] lobe-selection + direction
    uniforms; extra_u: [...,2] (read only by the unported transmission and
    sheen lobes). Returns dict(k2, bsdf_over_pdf [...,3], pdf, event i32)."""
    _check_lobes(features)
    del extra_u
    N, T, B = pbr["N"], pbr["T"], pbr["B"]
    k1_l = _to_local(k1, T, B, N)
    ax = torch.clamp(pbr["roughness"][..., 0], min=_MIN_ALPHA)
    ay = torch.clamp(pbr["roughness"][..., 1], min=_MIN_ALPHA)
    is_smooth = (ax < _IMPULSE_ALPHA) & (ay < _IMPULSE_ALPHA)

    w_d, w_g = _lobe_weights(pbr, k1)
    pick_d = u[..., 0] < w_d
    pick_g = ~pick_d  # glossy also takes the rounding residue of the weights
    u1, u2 = u[..., 1], u[..., 2]

    # flip so k1 is in the +z hemisphere for VNDF (inside hits)
    flip = torch.where(k1_l[..., 2] < 0.0, -1.0, 1.0)
    fz = torch.stack([torch.ones_like(flip), torch.ones_like(flip), flip], dim=-1)
    k1_lf = k1_l * fz

    d_diff = _cos_hemisphere(N, T, B, u1, u2)
    h_l = _sample_vndf(k1_lf, ax, ay, u1, u2) * fz
    h_smooth = torch.cat([torch.zeros_like(h_l[..., :2]),
                          torch.sign(k1_l[..., 2:3]) * torch.ones_like(h_l[..., 2:3])], dim=-1)
    h_l = torch.where(is_smooth[..., None], h_smooth, h_l)
    h_w = _from_local(h_l, T, B, N)
    d_refl = 2.0 * dot3(k1, h_w)[..., None] * h_w - k1
    d_refl = d_refl / torch.clamp(torch.sqrt(dot3(d_refl, d_refl)), min=1e-12)[..., None]

    k2 = torch.where(pick_d[..., None], d_diff, 0.0) + torch.where(pick_g[..., None], d_refl, 0.0)

    impulse = is_smooth & pick_g
    event = torch.where(
        pick_d, EVENT_DIFFUSE,
        torch.where(impulse, EVENT_IMPULSE_REFLECTION, EVENT_GLOSSY_REFLECTION),
    ).to(torch.int32)

    # combined-mixture estimator f_total / sum_i(w_i p_i), f and pdf from
    # bsdf_evaluate so the sample and evaluate pdfs agree by construction
    ev = bsdf_evaluate(pbr, k1, k2, features)
    pdf = ev["pdf"]
    f_total = ev["bsdf_diffuse"] + ev["bsdf_glossy"]
    bsdf_over_pdf = f_total / torch.clamp(pdf, min=1e-12)[..., None]
    pdf = torch.where(impulse, DIRAC, pdf)

    # impulse reflection: f/p = F (Schlick with rgb f0)
    f0_d = _f0_dielectric(pbr)
    m3 = pbr["metallic"][..., None]
    f0 = f0_d * (1.0 - m3) + pbr["base_color"] * m3
    fr_imp = _schlick3(f0, torch.abs(dot3(k1, h_w)))
    bsdf_over_pdf = torch.where(impulse[..., None], fr_imp / torch.clamp(w_g, min=1e-6)[..., None],
                                bsdf_over_pdf)

    # invalid / degenerate samples are absorbed
    bad_refl = dot3(pbr["N"], k2) <= 0.0
    zero_w = torch.all(bsdf_over_pdf <= 0.0, dim=-1) | ~torch.isfinite(bsdf_over_pdf).all(dim=-1)
    absorb = bad_refl | zero_w
    event = torch.where(absorb, EVENT_ABSORB, event)
    bsdf_over_pdf = torch.where(absorb[..., None], 0.0, bsdf_over_pdf)
    return {"k2": k2, "bsdf_over_pdf": bsdf_over_pdf, "pdf": pdf, "event": event}
