"""Material evaluation: packed material rows + hit state -> PbrMaterial dict.

Port of vk_gltf_renderer_tpu/ops/materials_eval.py, every block in the
reference's order (volume before the IOR inside/outside swap: the
thin-walled check needs the thickness): metallic-roughness or the
spec-gloss conversion, occlusion, normal map, emissive, volume, specular,
ior, transmission, volume scatter, clearcoat, iridescence, anisotropy,
sheen, dispersion, retroreflection, diffuse transmission and unlit. Each
block is gated by the scene feature set and each texture slot by the
"textured" / "tex:<slot>" flags, exactly as in the reference; a block that
is off leaves the reference's feature-off constants.
"""

from __future__ import annotations

import torch

from .flat import MAT_LAYOUT, _init_mat_layout
from .textures import sample_texture
from .traverse import cross3, dot3

MICROFACET_MIN_ROUGHNESS = 0.0014142

# every flag models/materials.detect_scene_features emits, and "textured"
# (the renderer's); "tex:<slot>" flags are always handled: sample_texture
# serves every slot
SUPPORTED_FEATURES = frozenset({
    "textured", "texture_transform", "emissive_strength", "transmission", "volume",
    "volume_scatter", "ior", "specular", "clearcoat", "iridescence", "anisotropy", "sheen",
    "dispersion", "retroreflection", "specular_glossiness", "diffuse_transmission", "unlit",
})

_INT_FIELDS = ("alpha_mode", "double_sided", "unlit", "pbr_model")


def unsupported_features(features) -> list:
    return sorted(f for f in features if f not in SUPPORTED_FEATURES and not f.startswith("tex:"))


def check_features(features) -> None:
    """Raise NotImplementedError for a flag no material block handles."""
    bad = unsupported_features(features)
    if bad:
        raise NotImplementedError(f"unknown material features: {', '.join(bad)}")


def _gather_materials(scene, mat_id, names=None):
    """One packed-row gather, sliced back into the field dict (every field,
    or the named ones)."""
    _init_mat_layout()
    row = scene.mat_packed[mat_id.long()]
    m = {}
    for name in MAT_LAYOUT if names is None else names:
        off, w = MAT_LAYOUT[name]
        v = row[..., off] if w == 1 else row[..., off : off + w]
        if name in _INT_FIELDS or name.endswith("texture"):
            v = v.to(torch.int32)
        m[name] = v
    return m


def evaluate_material(scene, mat_id, hit, *, features: frozenset, is_inside=None, tex_lod=None):
    """mat_id: [N] i32; is_inside: [N] bool (None: all outside). Returns
    the PbrMaterial dict for ops/bsdf.py."""
    check_features(features)
    slot_gated = any(f.startswith("tex:") for f in features)

    def tex(name):
        off = "textured" not in features or (slot_gated and ("tex:" + name) not in features)
        if off:
            return torch.ones(m[name].shape + (4,), dtype=torch.float32, device=mat_id.device)
        return sample_texture(scene, m[name], hit["uv0"], hit["uv1"], lod)

    m = _gather_materials(scene, mat_id)
    lod = torch.zeros_like(hit["texel_density"]) if tex_lod is None else tex_lod
    shape = mat_id.shape
    dev = mat_id.device
    if is_inside is None:
        is_inside = torch.zeros(shape, dtype=torch.bool, device=dev)

    def full(value, extra=()):
        return torch.full(shape + extra, value, dtype=torch.float32, device=dev)

    pbr = {}
    # ---- base color / metallic-roughness (or the spec-gloss conversion)
    base_color = m["base_color_factor"] * hit["color"]
    bc_tex = tex("base_color_texture")
    base_color = base_color * torch.where((m["base_color_texture"] > 0)[..., None], bc_tex, 1.0)

    roughness = m["roughness_factor"]
    metallic = m["metallic_factor"]
    mr_tex = tex("metallic_roughness_texture")
    has_mr = m["metallic_roughness_texture"] > 0
    roughness = roughness * torch.where(has_mr, mr_tex[..., 1], 1.0)
    metallic = metallic * torch.where(has_mr, mr_tex[..., 2], 1.0)

    if "specular_glossiness" in features:
        sg = m["pbr_model"] == 1
        diffuse = m["diffuse_factor"] * hit["color"]
        d_tex = tex("diffuse_texture")
        diffuse = diffuse * torch.where((m["diffuse_texture"] > 0)[..., None], d_tex, 1.0)
        spec3 = m["specular_glossiness_factor"]
        gloss = m["glossiness_factor"]
        sg_tex = tex("specular_glossiness_texture")
        has_sg = m["specular_glossiness_texture"] > 0
        spec3 = spec3 * torch.where(has_sg[..., None], sg_tex[..., :3], 1.0)
        gloss = gloss * torch.where(has_sg, sg_tex[..., 3], 1.0)
        # convertSGToMR
        spec_int = torch.amax(spec3, dim=-1)
        is_metal = torch.clamp((spec_int - 0.05) / 0.04, 0.0, 1.0)
        is_metal = is_metal * is_metal * (3.0 - 2.0 * is_metal)  # smoothstep
        sg_base = torch.where(
            (is_metal > 0)[..., None], spec3,
            torch.clamp(diffuse[..., :3] / (1.0 - 0.04 * (1.0 - is_metal))[..., None], 0.0, 1.0))
        r_sg = (1.0 - gloss) ** 2
        base_color = torch.where(sg[..., None], torch.cat([sg_base, diffuse[..., 3:4]], -1), base_color)
        metallic = torch.where(sg, is_metal, metallic)
        roughness = torch.where(sg, torch.sqrt(torch.clamp(r_sg, min=0.0)), roughness)  # re-squared below

    pbr["base_color"] = base_color[..., :3]
    pbr["opacity"] = base_color[..., 3]
    roughness = torch.clamp(roughness, min=MICROFACET_MIN_ROUGHNESS)
    alpha = roughness * roughness
    pbr["roughness"] = torch.stack([alpha, alpha], dim=-1)
    pbr["metallic"] = torch.clamp(metallic, 0.0, 1.0)

    # ---- occlusion
    occ = m["occlusion_strength"]
    o_tex = tex("occlusion_texture")
    pbr["occlusion"] = torch.where(m["occlusion_texture"] > 0, 1.0 + occ * (o_tex[..., 0] - 1.0), occ)

    # ---- normal map + frame
    N, T, B = hit["nrm"], hit["tangent"], hit["bitangent"]
    has_nm = m["normal_texture"] > 0
    n_tex = tex("normal_texture")[..., :3] * 2.0 - 1.0
    n_tex = n_tex * torch.stack([m["normal_texture_scale"], m["normal_texture_scale"], full(1.0)], dim=-1)
    n_mapped = n_tex[..., 0:1] * T + n_tex[..., 1:2] * B + n_tex[..., 2:3] * N
    n_mapped = n_mapped / torch.clamp(torch.sqrt(dot3(n_mapped, n_mapped)), min=1e-12)[..., None]
    N = torch.where(has_nm[..., None], n_mapped, N)
    needs_tb_update = has_nm
    pbr["N"] = N
    pbr["Ng"] = hit["geonrm"]

    # ---- emissive
    emissive = m["emissive_factor"]
    e_tex = tex("emissive_texture")
    emissive = emissive * torch.where((m["emissive_texture"] > 0)[..., None], e_tex[..., :3], 1.0)
    pbr["emissive"] = torch.clamp(emissive, min=0.0)

    # ---- volume (before the ior swap: the thin-walled check needs thickness)
    if "volume" in features:
        thickness = m["thickness_factor"]
        th_tex = tex("thickness_texture")
        thickness = thickness * torch.where(m["thickness_texture"] > 0, th_tex[..., 1], 1.0)
        pbr["thickness"] = thickness
        pbr["attenuation_color"] = m["attenuation_color"]
        pbr["attenuation_distance"] = m["attenuation_distance"]
    else:
        pbr["thickness"] = full(0.0)
        pbr["attenuation_color"] = full(1.0, (3,))
        pbr["attenuation_distance"] = full(0.0)

    # ---- specular (KHR_materials_specular)
    if "specular" in features:
        sc = m["specular_color_factor"]
        sc_tex = tex("specular_color_texture")
        sc = sc * torch.where((m["specular_color_texture"] > 0)[..., None], sc_tex[..., :3], 1.0)
        sf = m["specular_factor"]
        sf_tex = tex("specular_texture")
        sf = sf * torch.where(m["specular_texture"] > 0, sf_tex[..., 3], 1.0)
        pbr["specular_color"] = sc
        pbr["specular"] = sf
    else:
        pbr["specular_color"] = full(1.0, (3,))
        pbr["specular"] = full(1.0)

    # ---- IOR, with the inside/outside swap for thick volumes only
    ior2 = m["ior"] if "ior" in features else full(1.5)
    ior1 = full(1.0)
    swap = is_inside & (pbr["thickness"] > 0.0)
    pbr["ior1"] = torch.where(swap, ior2, ior1)
    pbr["ior2"] = torch.where(swap, ior1, ior2)

    # ---- transmission
    if "transmission" in features:
        tr = m["transmission_factor"]
        tr_tex = tex("transmission_texture")
        pbr["transmission"] = tr * torch.where(m["transmission_texture"] > 0, tr_tex[..., 0], 1.0)
    else:
        pbr["transmission"] = full(0.0)

    # ---- volume scatter
    if "volume_scatter" in features:
        rho = m["multiscatter_color_factor"]
        t = 4.09712 + 4.20863 * rho - torch.sqrt(9.59217 + 41.6808 * rho + 17.7126 * rho * rho)
        ss_albedo = 1.0 - t * t
        att = -torch.log(torch.clamp(pbr["attenuation_color"], min=0.001)) / torch.clamp(
            pbr["attenuation_distance"], min=0.001)[..., None]
        pbr["scatter_coefficient"] = torch.where(torch.any(rho > 0, dim=-1, keepdim=True), att * ss_albedo, 0.0)
        pbr["scatter_anisotropy"] = m["scatter_anisotropy"]
    else:
        pbr["scatter_coefficient"] = full(0.0, (3,))
        pbr["scatter_anisotropy"] = full(0.0)

    # ---- clearcoat
    if "clearcoat" in features:
        cc = m["clearcoat_factor"]
        cc_tex = tex("clearcoat_texture")
        cc = cc * torch.where(m["clearcoat_texture"] > 0, cc_tex[..., 0], 1.0)
        ccr = m["clearcoat_roughness"]
        ccr_tex = tex("clearcoat_roughness_texture")
        ccr = ccr * torch.where(m["clearcoat_roughness_texture"] > 0, ccr_tex[..., 1], 1.0)
        Nc = pbr["N"]
        has_ccn = m["clearcoat_normal_texture"] > 0
        ccn = tex("clearcoat_normal_texture")[..., :3] * 2.0 - 1.0
        ncc = ccn[..., 0:1] * T + ccn[..., 1:2] * B + ccn[..., 2:3] * Nc
        ncc = ncc / torch.clamp(torch.sqrt(dot3(ncc, ncc)), min=1e-12)[..., None]
        pbr["Nc"] = torch.where(has_ccn[..., None], ncc, Nc)
        pbr["clearcoat"] = cc
        pbr["clearcoat_roughness"] = torch.clamp(ccr, min=0.001)
    else:
        pbr["Nc"] = pbr["N"]
        pbr["clearcoat"] = full(0.0)
        pbr["clearcoat_roughness"] = full(0.001)

    # ---- iridescence
    if "iridescence" in features:
        ir = m["iridescence_factor"]
        ir_tex = tex("iridescence_texture")
        ir = ir * torch.where(m["iridescence_texture"] > 0, ir_tex[..., 0], 1.0)
        th_max = m["iridescence_thickness_maximum"]
        th_tex = tex("iridescence_thickness_texture")
        th = torch.where(
            m["iridescence_thickness_texture"] > 0,
            m["iridescence_thickness_minimum"] + (th_max - m["iridescence_thickness_minimum"]) * th_tex[..., 1],
            th_max,
        )
        pbr["iridescence"] = torch.where(th > 0.0, ir, 0.0)
        pbr["iridescence_thickness"] = th
        pbr["iridescence_ior"] = m["iridescence_ior"]
    else:
        pbr["iridescence"] = full(0.0)
        pbr["iridescence_thickness"] = full(0.0)
        pbr["iridescence_ior"] = full(1.3)

    # ---- anisotropy (rotates T in the tangent plane, widens roughness.x)
    if "anisotropy" in features:
        strength = m["anisotropy_strength"]
        a_tex = tex("anisotropy_texture")
        has_at = m["anisotropy_texture"] > 0
        a_dir = torch.where(has_at[..., None], a_tex[..., :2] * 2.0 - 1.0,
                            torch.stack([full(1.0), full(0.0)], dim=-1))
        a_dir = a_dir / torch.clamp(torch.sqrt(torch.sum(a_dir**2, -1, keepdim=True)), min=1e-9)
        strength = strength * torch.where(has_at, a_tex[..., 2], 1.0)
        on = strength > 0.0
        rx = pbr["roughness"][..., 1] * (1 - strength**2) + 1.0 * strength**2
        pbr["roughness"] = torch.stack([torch.where(on, rx, pbr["roughness"][..., 0]), pbr["roughness"][..., 1]], -1)
        s_, c_ = m["anisotropy_rotation"][..., 0], m["anisotropy_rotation"][..., 1]
        ad = torch.stack([c_ * a_dir[..., 0] + s_ * a_dir[..., 1], c_ * a_dir[..., 1] - s_ * a_dir[..., 0]], dim=-1)
        t_aniso = T * ad[..., 0:1] + B * ad[..., 1:2]
        T = torch.where(on[..., None], t_aniso, T)
        needs_tb_update = needs_tb_update | on

    # ---- re-orthonormalise the frame where N or T changed
    Bn = cross3(pbr["N"], T)
    Bn = Bn / torch.clamp(torch.sqrt(dot3(Bn, Bn)), min=1e-12)[..., None]
    bsign = torch.where(dot3(hit["bitangent"], Bn) < 0.0, -1.0, 1.0)[..., None]
    B_new = Bn * bsign
    T_new = cross3(B_new, pbr["N"]) * bsign
    T_new = T_new / torch.clamp(torch.sqrt(dot3(T_new, T_new)), min=1e-12)[..., None]
    pbr["T"] = torch.where(needs_tb_update[..., None], T_new, T)
    pbr["B"] = torch.where(needs_tb_update[..., None], B_new, hit["bitangent"])

    # ---- sheen
    if "sheen" in features:
        sc = m["sheen_color_factor"]
        sc_tex = tex("sheen_color_texture")
        sc = sc * torch.where((m["sheen_color_texture"] > 0)[..., None], sc_tex[..., :3], 1.0)
        sr = m["sheen_roughness_factor"]
        sr_tex = tex("sheen_roughness_texture")
        sr = sr * torch.where(m["sheen_roughness_texture"] > 0, sr_tex[..., 3], 1.0)
        pbr["sheen_color"] = sc
        pbr["sheen_roughness"] = torch.clamp(sr, min=MICROFACET_MIN_ROUGHNESS)
        pbr["_sheen_on"] = (torch.amax(sc, dim=-1) > 0).to(torch.float32)
    else:
        pbr["sheen_color"] = full(0.0, (3,))
        pbr["sheen_roughness"] = full(MICROFACET_MIN_ROUGHNESS)
        pbr["_sheen_on"] = full(0.0)

    # ---- dispersion
    pbr["dispersion"] = m["dispersion"] if "dispersion" in features else full(0.0)

    # ---- retroreflection (read only by the reference's preview blend; its
    # path tracer ignores it too)
    if "retroreflection" in features:
        pbr["retroreflection"] = m["retroreflection_factor"] * tex("retroreflection_texture")[..., 0]
    else:
        pbr["retroreflection"] = full(0.0)

    # ---- diffuse transmission
    if "diffuse_transmission" in features:
        dt = m["diffuse_transmission_factor"]
        dt_tex = tex("diffuse_transmission_texture")
        dt = dt * torch.where(m["diffuse_transmission_texture"] > 0, dt_tex[..., 3], 1.0)
        dtc = m["diffuse_transmission_color"]
        dtc_tex = tex("diffuse_transmission_color_texture")
        dtc = dtc * torch.where((m["diffuse_transmission_color_texture"] > 0)[..., None], dtc_tex[..., :3], 1.0)
        pbr["diffuse_transmission"] = dt
        pbr["diffuse_transmission_color"] = dtc
    else:
        pbr["diffuse_transmission"] = full(0.0)
        pbr["diffuse_transmission_color"] = full(1.0, (3,))

    pbr["unlit"] = m["unlit"].to(torch.float32) if "unlit" in features else full(0.0)
    pbr["alpha_mode"] = m["alpha_mode"]
    pbr["alpha_cutoff"] = m["alpha_cutoff"]
    pbr["double_sided"] = m["double_sided"]
    return pbr


def get_opacity(scene, mat_id, hit, *, textured: bool = True):
    """Stochastic-alpha opacity at a hit: baseColor alpha x texture alpha x
    vertex alpha; MASK thresholds at the cutoff (reference :323)."""
    m = _gather_materials(scene, mat_id, ("base_color_factor", "base_color_texture", "alpha_mode", "alpha_cutoff"))
    bc = m["base_color_factor"]
    slot = m["base_color_texture"]
    if textured:
        tex = sample_texture(scene, slot, hit["uv0"], hit["uv1"], torch.zeros_like(hit["texel_density"]))
        a = bc[..., 3] * torch.where(slot > 0, tex[..., 3], 1.0) * hit["color"][..., 3]
    else:
        a = bc[..., 3] * hit["color"][..., 3]
    a = torch.where(m["alpha_mode"] == 1, torch.where(a >= m["alpha_cutoff"], 1.0, 0.0), a)
    return torch.where(m["alpha_mode"] == 0, 1.0, a)
