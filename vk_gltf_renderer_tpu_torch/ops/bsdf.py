"""glTF PBR BSDF: evaluate / sample, batched and branch-free (port of
vk_gltf_renderer_tpu/ops/bsdf.py).

Every lobe of the reference: Lambert diffuse, anisotropic GGX reflection
(Heitz VNDF sampling, height-correlated Smith, impulse mirror below the
roughness floor) with optional thin-film iridescence (Belcour-Barla Airy
summation), microfacet / impulse dielectric transmission with refraction
and TIR, diffuse transmission, clearcoat (GGX on its own normal) and sheen
(Charlie NDF, Ashikhmin visibility). Lobes are gated statically by the
scene feature set, the GLTF_USE_* analog: a lobe the scene cannot express
compiles out to a literal 0.0 weight, as in the reference; features=None
keeps every lobe.

bsdf_evaluate(pbr, k1, k2, features) -> dict(bsdf_diffuse, bsdf_glossy, pdf)
    (both terms include the cosine factor)
bsdf_sample(pbr, k1, u3, extra_u, features) -> dict(k2, bsdf_over_pdf, pdf, event)
"""

from __future__ import annotations

import math

import numpy as np
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


# XYZ (CIE 1931) -> linear Rec.709, used by the thin-film sensitivity fit
_XYZ_TO_RGB = (
    (3.2404542, -1.5371385, -0.4985314),
    (-0.9692660, 1.8760108, 0.0415560),
    (0.0556434, -0.2040259, 1.0572252),
)
# the Gaussian fits of the CIE XYZ curves (value, position, variance per
# channel); each channel's amplitude val * sqrt(2 pi var) is folded in
# float32, the reference's order, and held as a Python float so that no
# constant tensor is built per call
_SENS_POS = (1.6810e06, 1.7953e06, 2.2084e06)
_SENS_VAR = (4.3278e09, 9.3046e09, 6.6121e09)
_SENS_AMP = tuple(float(np.float32(v) * np.sqrt(np.float32(2.0 * math.pi) * np.float32(w)))
                  for v, w in zip((5.4856e-13, 4.4201e-13, 5.2481e-13), _SENS_VAR))
_X_EXTRA_AMP = float(np.float32(9.7470e-14) * np.sqrt(np.float32(2.0 * math.pi * 4.5282e09)))


def _eval_sensitivity(opd, shift):
    """Belcour-Barla spectral-sensitivity integral (Gaussian fits of the
    CIE XYZ curves), opd in nanometers. Returns RGB [.., 3]. Every
    operation is the reference's float32 one, in its order: the phase
    arguments reach ~1e4 rad at 500 nm."""
    phase = 2.0 * math.pi * opd * 1.0e-9  # meters
    xyz = [amp * torch.cos(pos * phase + shift[..., k]) * torch.exp(-var * phase * phase)
           for k, (amp, pos, var) in enumerate(zip(_SENS_AMP, _SENS_POS, _SENS_VAR))]
    x_extra = (
        _X_EXTRA_AMP
        * torch.cos(2.2399e06 * phase + shift[..., 0])
        * torch.exp(-4.5282e09 * phase * phase)
    )
    xyz = [(xyz[0] + x_extra) / 1.0685e-7, xyz[1] / 1.0685e-7, xyz[2] / 1.0685e-7]
    m = _XYZ_TO_RGB
    return torch.stack([m[i][0] * xyz[0] + m[i][1] * xyz[1] + m[i][2] * xyz[2] for i in range(3)], dim=-1)


def _ior_to_f0(nt, ni):
    return ((nt - ni) / torch.clamp(nt + ni, min=1e-6)) ** 2


def _f0_to_ior(f0):
    r = torch.sqrt(torch.clamp(f0, 0.0, 0.9999))
    return (1.0 + r) / torch.clamp(1.0 - r, min=1e-6)


def _eval_iridescence(n_film, cos_theta1, thickness, base_f0):
    """Thin-film interference Fresnel (Belcour & Barla 2017 as adopted by
    KHR_materials_iridescence): Airy summation with 2 interference orders
    through the CIE sensitivity fits, outside medium IOR 1. Returns the
    per-channel Fresnel [.., 3]."""
    outside = 1.0
    # the film vanishes below ~30nm: blend its IOR toward the outside medium
    t01 = torch.clamp(thickness / 30.0, 0.0, 1.0)
    film_ior = outside + (n_film - outside) * (t01 * t01 * (3.0 - 2.0 * t01))
    sin2_1 = torch.clamp(1.0 - cos_theta1 * cos_theta1, min=0.0)
    sin2_2 = (outside / torch.clamp(film_ior, min=1e-6)) ** 2 * sin2_1
    tir = sin2_2 > 1.0
    cos_theta2 = torch.sqrt(torch.clamp(1.0 - sin2_2, min=0.0))

    # first interface (outside | film): the exact Fresnel (Schlick breaks
    # the thin-film limit of a near-index-matched interface)
    r12 = _fresnel_dielectric(cos_theta1, torch.full_like(film_ior, outside), film_ior)
    t121 = 1.0 - r12
    phi12 = torch.where(film_ior < outside, math.pi, 0.0)
    phi21 = math.pi - phi12

    # second interface (film | base), per channel via F0 -> equivalent IOR
    base_ior = _f0_to_ior(base_f0)
    r1 = _ior_to_f0(base_ior, film_ior[..., None])
    r23 = _schlick3(r1, cos_theta2)
    phi23 = torch.where(base_ior < film_ior[..., None], math.pi, 0.0)

    opd = 2.0 * film_ior * thickness * cos_theta2  # nm
    phi = phi21[..., None] + phi23

    r123 = torch.clamp(r12[..., None] * r23, 0.0, 0.9999)  # no floor: a vanishing film kills the terms
    sr123 = torch.sqrt(r123)
    rs = (t121[..., None] ** 2) * r23 / torch.clamp(1.0 - r123, min=1e-6)
    irid = r12[..., None] + rs  # C0 (m = 0)
    cm = rs - t121[..., None]
    for m in (1, 2):
        cm = cm * sr123
        sm = 2.0 * _eval_sensitivity(m * opd, m * phi)
        irid = irid + cm * sm
    irid = torch.clamp(irid, 0.0, 1.0)
    return torch.where(tir[..., None], torch.ones_like(irid), irid)


def _fresnel_spec(pbr, f0, cos_theta):
    """Specular Fresnel; with iridescence in pbr the Airy evaluation is
    mixed against Schlick by the iridescence factor."""
    fr = _schlick3(f0, cos_theta)
    irid = pbr.get("iridescence")
    if irid is None:
        return fr
    f_irid = _eval_iridescence(pbr["iridescence_ior"], cos_theta, pbr["iridescence_thickness"], f0)
    w = (irid * (pbr["iridescence_thickness"] > 0.0))[..., None]
    return fr * (1.0 - w) + f_irid * w


def _f0_dielectric(pbr):
    """glTF dielectric F0 with KHR_materials_specular scaling."""
    ior1, ior2 = pbr["ior1"], pbr["ior2"]
    f = ((ior2 - ior1) / torch.clamp(ior2 + ior1, min=1e-6)) ** 2
    return torch.clamp(f[..., None] * pbr["specular_color"], max=1.0) * pbr["specular"][..., None]


def _lobe_gates(features):
    """Static lobe flags (transmission, clearcoat, sheen, diffuse
    transmission) from the scene feature set; None keeps every lobe."""
    if features is None:
        return True, True, True, True
    return (
        "transmission" in features,
        "clearcoat" in features,
        "sheen" in features,
        "diffuse_transmission" in features,
    )


def _drop_iridescence(pbr, features):
    """Without the iridescence feature the Airy stack compiles out."""
    if features is not None and "iridescence" not in features:
        return {k: v for k, v in pbr.items() if k != "iridescence"}
    return pbr


def _lobe_weights(pbr, k1, features=None):
    """Sampling probabilities of (diffuse, glossy, transmission, clearcoat,
    sheen, diffuse transmission), Fresnel-aware and luminance-weighted; a
    gated-out lobe is the literal 0.0."""
    use_t, use_c, use_s, use_dt = _lobe_gates(features)
    n_dot_v = torch.abs(dot3(pbr["N"], k1))
    f0 = _f0_dielectric(pbr)
    f_diel = _schlick1(_luminance(f0), n_dot_v)
    f_metal = _schlick1(_luminance(pbr["base_color"]), n_dot_v)
    m = pbr["metallic"]
    trans = pbr["transmission"] * (1.0 - m) if use_t else 0.0
    dt = (pbr["diffuse_transmission"] * (1.0 - m) * (1.0 - pbr["transmission"])
          if use_dt else 0.0)
    w_glossy = m * f_metal + (1.0 - m) * f_diel
    w_diffuse = (1.0 - m) * (1.0 - trans) * (1.0 - dt) * _luminance(pbr["base_color"]) * (1.0 - f_diel)
    w_trans = trans * (1.0 - f_diel) * _luminance(pbr["base_color"]) if use_t else 0.0
    w_dt = dt * _luminance(pbr["diffuse_transmission_color"]) if use_dt else 0.0
    w_coat = pbr["clearcoat"] * _schlick1(0.04, n_dot_v) if use_c else 0.0
    w_sheen = _luminance(pbr["sheen_color"]) if use_s else 0.0
    total = w_diffuse + w_glossy + w_trans + w_coat + w_sheen + w_dt
    total = torch.clamp(total, min=1e-8)
    return (w_diffuse / total, w_glossy / total, w_trans / total, w_coat / total, w_sheen / total,
            w_dt / total)


def _charlie_d(h_z, alpha):
    """Charlie sheen NDF (Estevez & Kulla)."""
    a = torch.clamp(alpha, min=1e-3)
    inv_a = 1.0 / a
    sin2 = torch.clamp(1.0 - h_z * h_z, min=0.0)
    return (2.0 + inv_a) * (sin2 ** (inv_a * 0.5)) / (2.0 * math.pi)


def _sheen_eval(pbr, k1_l, k2_l):
    h = k1_l + k2_l
    h = h / torch.sqrt(dot3(h, h))[..., None]
    d = _charlie_d(h[..., 2], pbr["sheen_roughness"] ** 2)
    # Ashikhmin's simple visibility term
    denom = 4.0 * (torch.abs(k1_l[..., 2]) + torch.abs(k2_l[..., 2])
                   - torch.abs(k1_l[..., 2]) * torch.abs(k2_l[..., 2]))
    v = 1.0 / torch.clamp(denom, min=1e-6)
    return pbr["sheen_color"] * (d * v * torch.clamp(k2_l[..., 2], min=0.0))[..., None]


def bsdf_evaluate(pbr, k1, k2, features=None):
    """Evaluate the lobes for light direction k2 (the NEE path). Returns
    bsdf_diffuse / bsdf_glossy with the cosine included, and the sampling
    pdf for MIS."""
    use_t, use_c, use_s, use_dt = _lobe_gates(features)
    pbr = _drop_iridescence(pbr, features)
    N, T, B = pbr["N"], pbr["T"], pbr["B"]
    k1_l = _to_local(k1, T, B, N)
    k2_l = _to_local(k2, T, B, N)
    n_dot_l = k2_l[..., 2]
    n_dot_v = torch.abs(k1_l[..., 2])
    refl_side = n_dot_l > 0.0

    # pbr["roughness"] holds alpha = roughness^2, consumed directly (the
    # clearcoat's ac = ccr^2 below likewise)
    ax = torch.clamp(pbr["roughness"][..., 0], min=_MIN_ALPHA)
    ay = torch.clamp(pbr["roughness"][..., 1], min=_MIN_ALPHA)

    h = k1_l + k2_l
    h = h / torch.clamp(torch.sqrt(dot3(h, h)), min=1e-12)[..., None]
    v_dot_h = torch.clamp(dot3(k1_l, h), min=0.0)

    f0_d = _f0_dielectric(pbr)
    m = pbr["metallic"][..., None]
    f0 = f0_d * (1.0 - m) + pbr["base_color"] * m
    fr = _fresnel_spec(pbr, f0, v_dot_h)

    d = _ggx_d(h, ax, ay)
    g2 = _ggx_g2(k1_l, k2_l, ax, ay)
    glossy = fr * (d * g2 / torch.clamp(4.0 * n_dot_v, min=1e-8))[..., None]  # f * n.l

    trans = pbr["transmission"] * (1.0 - pbr["metallic"]) if use_t else 0.0
    dt = (pbr["diffuse_transmission"] * (1.0 - pbr["metallic"]) * (1.0 - pbr["transmission"])
          if use_dt else 0.0)
    kd = (1.0 - pbr["metallic"]) * (1.0 - trans) * (1.0 - dt)
    f_diel_l = _schlick1(_luminance(f0_d), v_dot_h)
    diffuse = pbr["base_color"] * (kd * (1.0 - f_diel_l) / math.pi * torch.clamp(n_dot_l, min=0.0))[..., None]

    if use_dt:
        # diffuse transmission: Lambertian into the opposite hemisphere
        dt_term = pbr["diffuse_transmission_color"] * (dt / math.pi * torch.clamp(-n_dot_l, min=0.0))[..., None]
        diffuse = diffuse + dt_term

    if use_s:
        sheen = _sheen_eval(pbr, k1_l, k2_l)
        glossy = glossy + sheen * pbr["_sheen_on"][..., None]

    if use_c:
        # clearcoat layer (own normal Nc, isotropic GGX)
        cc = pbr["clearcoat"]
        k1_c = _to_local(k1, T, B, pbr["Nc"])
        k2_c = _to_local(k2, T, B, pbr["Nc"])
        hc = k1_c + k2_c
        hc = hc / torch.clamp(torch.sqrt(dot3(hc, hc)), min=1e-12)[..., None]
        ac = torch.clamp(pbr["clearcoat_roughness"] ** 2, min=_MIN_ALPHA)
        dc = _ggx_d(hc, ac, ac)
        g2c = _ggx_g2(k1_c, k2_c, ac, ac)
        fc = _schlick1(0.04, torch.clamp(dot3(k1_c, hc), min=0.0)) * cc
        cc_spec = (fc * dc * g2c / torch.clamp(4.0 * torch.abs(k1_c[..., 2]), min=1e-8))[..., None]
        # the coat attenuates the base by 1 - Fc(view)
        atten = 1.0 - (cc * _schlick1(0.04, n_dot_v))[..., None]
        glossy = glossy * atten + cc_spec * torch.clamp(k2_c[..., 2], min=0.0)[..., None]
        diffuse = diffuse * atten

    glossy = torch.where(refl_side[..., None], glossy, torch.zeros_like(glossy))

    # pdf (matches bsdf_sample's strategy)
    w_d, w_g, w_t, w_c, w_s, w_dt = _lobe_weights(pbr, k1, features)
    pdf_d = torch.clamp(n_dot_l, min=0.0) / math.pi
    pdf_g = _vndf_pdf(k1_l, h, ax, ay) / torch.clamp(4.0 * v_dot_h, min=1e-8)
    pdf = w_d * pdf_d + w_g * torch.where(refl_side, pdf_g, 0.0)
    if use_c:
        pdf_c = _vndf_pdf(k1_c, hc, ac, ac) / torch.clamp(4.0 * torch.clamp(dot3(k1_c, hc), min=0.0), min=1e-8)
        pdf = pdf + w_c * torch.where(k2_c[..., 2] > 0, pdf_c, 0.0)
    if use_s:
        pdf_s = torch.clamp(n_dot_l, min=0.0) / math.pi  # sheen samples the cosine
        pdf = pdf + w_s * pdf_s
    if use_dt:
        pdf_dt = torch.clamp(-n_dot_l, min=0.0) / math.pi
        pdf = pdf + w_dt * pdf_dt
    valid_side = (refl_side | (dt > 0.0)) if use_dt else refl_side
    pdf = torch.where(valid_side, pdf, 0.0)
    return {"bsdf_diffuse": diffuse, "bsdf_glossy": glossy, "pdf": pdf}


def bsdf_sample(pbr, k1, u, extra_u, features=None):
    """Sample an outgoing direction. u: [...,3] lobe-selection + direction
    uniforms; extra_u: [...,2], which no lobe reads (the reference's
    signature). Returns dict(k2, bsdf_over_pdf [...,3], pdf, event i32)."""
    del extra_u
    use_t, use_c, use_s, use_dt = _lobe_gates(features)
    pbr = _drop_iridescence(pbr, features)
    N, T, B = pbr["N"], pbr["T"], pbr["B"]
    k1_l = _to_local(k1, T, B, N)
    ax = torch.clamp(pbr["roughness"][..., 0], min=_MIN_ALPHA)
    ay = torch.clamp(pbr["roughness"][..., 1], min=_MIN_ALPHA)
    is_smooth = (ax < _IMPULSE_ALPHA) & (ay < _IMPULSE_ALPHA)

    w_d, w_g, w_t, w_c, w_s, w_dt = _lobe_weights(pbr, k1, features)
    sel = u[..., 0]
    false_ = torch.zeros_like(sel, dtype=torch.bool)
    pick_d = sel < w_d
    pick_g = (~pick_d) & (sel < w_d + w_g)
    pick_t = (~pick_d) & (~pick_g) & (sel < w_d + w_g + w_t) if use_t else false_
    pick_c = ((~pick_d) & (~pick_g) & (~pick_t) & (sel < w_d + w_g + w_t + w_c)
              if use_c else false_)
    pick_s = ((~pick_d) & (~pick_g) & (~pick_t) & (~pick_c) & (sel < w_d + w_g + w_t + w_c + w_s)
              if use_s else false_)
    pick_dt = ((~pick_d) & (~pick_g) & (~pick_t) & (~pick_c) & (~pick_s)
               if use_dt else false_)
    if not use_dt:
        # the last lobe takes the weights' rounding residue; with diffuse
        # transmission compiled out, glossy does
        pick_g = pick_g | ((~pick_d) & (~pick_g) & (~pick_t) & (~pick_c) & (~pick_s))

    u1, u2 = u[..., 1], u[..., 2]

    # flip so k1 is in the +z hemisphere for VNDF (inside hits)
    flip = torch.where(k1_l[..., 2] < 0.0, -1.0, 1.0)
    fz = torch.stack([torch.ones_like(flip), torch.ones_like(flip), flip], dim=-1)
    k1_lf = k1_l * fz

    d_diff = _cos_hemisphere(N, T, B, u1, u2)
    d_dt = -d_diff if use_dt else None

    h_l = _sample_vndf(k1_lf, ax, ay, u1, u2) * fz
    h_smooth = torch.cat([torch.zeros_like(h_l[..., :2]),
                          torch.sign(k1_l[..., 2:3]) * torch.ones_like(h_l[..., 2:3])], dim=-1)
    h_l = torch.where(is_smooth[..., None], h_smooth, h_l)
    h_w = _from_local(h_l, T, B, N)
    d_refl = 2.0 * dot3(k1, h_w)[..., None] * h_w - k1
    d_refl = d_refl / torch.clamp(torch.sqrt(dot3(d_refl, d_refl)), min=1e-12)[..., None]

    if use_t:
        # refraction through h. The transmission lobe covers only
        # refraction; the F-weighted reflection on glass stays with the
        # glossy lobe, and TIR is an absorbed sample
        eta = pbr["ior1"] / torch.clamp(pbr["ior2"], min=1e-6)
        cos_i = dot3(k1, h_w)
        sign_i = torch.sign(cos_i)
        cos_i_a = torch.abs(cos_i)
        sin2_t = eta * eta * torch.clamp(1.0 - cos_i_a * cos_i_a, min=0.0)
        tir = sin2_t >= 1.0
        cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
        d_refr = (-k1) * eta[..., None] + (eta * cos_i_a - cos_t)[..., None] * (h_w * sign_i[..., None])
        d_refr = d_refr / torch.clamp(torch.sqrt(dot3(d_refr, d_refr)), min=1e-12)[..., None]
        f_h = _fresnel_dielectric(cos_i_a, pbr["ior1"], pbr["ior2"])
    else:
        tir = false_

    if use_c:
        # clearcoat reflection about its own normal
        k1_c = _to_local(k1, T, B, pbr["Nc"])
        ac = torch.clamp(pbr["clearcoat_roughness"] ** 2, min=_MIN_ALPHA)
        hc_l = _sample_vndf(torch.where(k1_c[..., 2:] < 0, -k1_c, k1_c), ac, ac, u1, u2)
        hc_w = _from_local(hc_l, T, B, pbr["Nc"])
        d_coat = 2.0 * dot3(k1, hc_w)[..., None] * hc_w - k1
        d_coat = d_coat / torch.clamp(torch.sqrt(dot3(d_coat, d_coat)), min=1e-12)[..., None]

    k2 = (
        torch.where(pick_d[..., None], d_diff, 0.0)
        + torch.where(pick_g[..., None], d_refl, 0.0)
        + torch.where(pick_s[..., None], d_diff, 0.0)
    )
    if use_t:
        k2 = k2 + torch.where(pick_t[..., None], d_refr, 0.0)
    if use_c:
        k2 = k2 + torch.where(pick_c[..., None], d_coat, 0.0)
    if use_dt:
        k2 = k2 + torch.where(pick_dt[..., None], d_dt, 0.0)

    impulse = is_smooth & (pick_g | pick_t)
    event = torch.where(
        pick_d | pick_s, EVENT_DIFFUSE,
        torch.where(
            pick_dt, EVENT_DIFFUSE_TRANSMISSION,
            torch.where(
                pick_t,
                torch.where(impulse, EVENT_IMPULSE_TRANSMISSION, EVENT_GLOSSY_TRANSMISSION),
                torch.where(impulse, EVENT_IMPULSE_REFLECTION, EVENT_GLOSSY_REFLECTION),
            ),
        ),
    ).to(torch.int32)

    # reflection-side lobes: the combined-mixture estimator
    # f_total / sum_i(w_i p_i), f and pdf from bsdf_evaluate so the sample
    # and evaluate pdfs agree by construction
    ev = bsdf_evaluate(pbr, k1, k2, features)
    pdf = ev["pdf"]
    f_total = ev["bsdf_diffuse"] + ev["bsdf_glossy"]
    w_reflect = f_total / torch.clamp(pdf, min=1e-12)[..., None]

    if use_t:
        # transmission: the partitioned estimator f_T / (w_t p_T); with VNDF
        # sampling f_T / p_T = (1 - F(h)) * tint * G2 / G1 (1 for impulses)
        k2_lf = _to_local(d_refr, T, B, N) * fz
        g_ratio = torch.where(
            is_smooth, 1.0,
            _ggx_g2(k1_lf, k2_lf, ax, ay) / torch.clamp(_ggx_g1(k1_lf, ax, ay), min=1e-8),
        )
        tint = pbr["base_color"]
        w_transmission = tint * ((1.0 - f_h) * g_ratio / torch.clamp(w_t, min=1e-6))[..., None]
        w_transmission = torch.where(tir[..., None], 0.0, w_transmission)
        bsdf_over_pdf = torch.where(pick_t[..., None], w_transmission, w_reflect)
        # the MIS pdf of the next env / light hit: DIRAC for an impulse, the
        # VNDF density for rough transmission
        pdf = torch.where(pick_t, torch.where(impulse, DIRAC, w_t * _vndf_pdf(k1_lf, torch.abs(h_l), ax, ay)),
                          pdf)
    else:
        bsdf_over_pdf = w_reflect
    pdf = torch.where(impulse & pick_g, DIRAC, pdf)

    # impulse reflection on smooth glossy: f/p = F (rgb f0)
    f0_d = _f0_dielectric(pbr)
    m3 = pbr["metallic"][..., None]
    f0 = f0_d * (1.0 - m3) + pbr["base_color"] * m3
    fr_imp = _fresnel_spec(pbr, f0, torch.abs(dot3(k1, h_w)))
    bsdf_over_pdf = torch.where((impulse & pick_g)[..., None], fr_imp / torch.clamp(w_g, min=1e-6)[..., None],
                                bsdf_over_pdf)

    # invalid / degenerate samples are absorbed
    bad_refl = (pick_d | pick_g | pick_c | pick_s) & (dot3(pbr["N"], k2) <= 0.0)
    bad_trans = pick_t & tir
    zero_w = torch.all(bsdf_over_pdf <= 0.0, dim=-1) | ~torch.isfinite(bsdf_over_pdf).all(dim=-1)
    absorb = bad_refl | bad_trans | zero_w
    event = torch.where(absorb, EVENT_ABSORB, event)
    bsdf_over_pdf = torch.where(absorb[..., None], 0.0, bsdf_over_pdf)
    return {"k2": k2, "bsdf_over_pdf": bsdf_over_pdf, "pdf": pdf, "event": event}


def _fresnel_dielectric(cos_i, ior1, ior2):
    """Exact unpolarized dielectric Fresnel."""
    eta = ior2 / torch.clamp(ior1, min=1e-6)
    sin2_t = torch.clamp(1.0 - cos_i * cos_i, min=0.0) / torch.clamp(eta * eta, min=1e-12)
    tir = sin2_t >= 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    rs = (cos_i - eta * cos_t) / torch.clamp(cos_i + eta * cos_t, min=1e-12)
    rp = (eta * cos_i - cos_t) / torch.clamp(eta * cos_i + cos_t, min=1e-12)
    f = 0.5 * (rs * rs + rp * rp)
    return torch.where(tir, 1.0, torch.clamp(f, 0.0, 1.0))
