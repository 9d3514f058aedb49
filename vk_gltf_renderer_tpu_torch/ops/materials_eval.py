"""Material evaluation: packed material rows + hit state -> PbrMaterial dict.

Port of vk_gltf_renderer_tpu/ops/materials_eval.py for the feature set the
slice supports: metallic-roughness base color, occlusion, normal map and
emissive, each with its texture slot, gated per slot by the scene's
"textured" / "tex:<slot>" flags exactly as in the reference. Extension
blocks (volume, specular, ior, transmission, clearcoat, iridescence,
anisotropy, sheen, dispersion, retroreflection, diffuse transmission,
spec-gloss, unlit) are not ported yet: check_features raises
NotImplementedError naming them, and the keys they would fill hold the
reference's feature-off constants.
"""

from __future__ import annotations

import torch

from .flat import MAT_LAYOUT, _init_mat_layout
from .textures import sample_texture
from .traverse import cross3, dot3

MICROFACET_MIN_ROUGHNESS = 0.0014142

# scene feature flags the slice's shading handles ("tex:<slot>" flags are
# always handled: sample_texture serves every slot)
SUPPORTED_FEATURES = frozenset({"textured", "texture_transform", "emissive_strength"})

_INT_FIELDS = ("alpha_mode", "double_sided", "unlit", "pbr_model")


def unsupported_features(features) -> list:
    return sorted(f for f in features if f not in SUPPORTED_FEATURES and not f.startswith("tex:"))


def check_features(features) -> None:
    bad = unsupported_features(features)
    if bad:
        raise NotImplementedError(
            f"material features not ported to the torch path tracer yet: {', '.join(bad)}")


def _gather_materials(scene, mat_id):
    """One packed-row gather, sliced back into the field dict."""
    _init_mat_layout()
    row = scene.mat_packed[mat_id.long()]
    m = {}
    for name, (off, w) in MAT_LAYOUT.items():
        v = row[..., off] if w == 1 else row[..., off : off + w]
        if name in _INT_FIELDS or name.endswith("texture"):
            v = v.to(torch.int32)
        m[name] = v
    return m


def evaluate_material(scene, mat_id, hit, *, features: frozenset, tex_lod=None):
    """mat_id: [N] i32. Returns the PbrMaterial dict for ops/bsdf.py."""
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

    def full(value, extra=()):
        return torch.full(shape + extra, value, dtype=torch.float32, device=dev)

    pbr = {}
    base_color = m["base_color_factor"] * hit["color"]
    bc_tex = tex("base_color_texture")
    base_color = base_color * torch.where((m["base_color_texture"] > 0)[..., None], bc_tex, 1.0)

    roughness = m["roughness_factor"]
    metallic = m["metallic_factor"]
    mr_tex = tex("metallic_roughness_texture")
    has_mr = m["metallic_roughness_texture"] > 0
    roughness = roughness * torch.where(has_mr, mr_tex[..., 1], 1.0)
    metallic = metallic * torch.where(has_mr, mr_tex[..., 2], 1.0)

    pbr["base_color"] = base_color[..., :3]
    pbr["opacity"] = base_color[..., 3]
    roughness = torch.clamp(roughness, min=MICROFACET_MIN_ROUGHNESS)
    alpha = roughness * roughness
    pbr["roughness"] = torch.stack([alpha, alpha], dim=-1)
    pbr["metallic"] = torch.clamp(metallic, 0.0, 1.0)

    occ = m["occlusion_strength"]
    o_tex = tex("occlusion_texture")
    pbr["occlusion"] = torch.where(m["occlusion_texture"] > 0, 1.0 + occ * (o_tex[..., 0] - 1.0), occ)

    N, T = hit["nrm"], hit["tangent"]
    has_nm = m["normal_texture"] > 0
    n_tex = tex("normal_texture")[..., :3] * 2.0 - 1.0
    n_tex = n_tex * torch.stack([m["normal_texture_scale"], m["normal_texture_scale"], full(1.0)], dim=-1)
    n_mapped = n_tex[..., 0:1] * T + n_tex[..., 1:2] * hit["bitangent"] + n_tex[..., 2:3] * N
    n_mapped = n_mapped / torch.clamp(torch.sqrt(dot3(n_mapped, n_mapped)), min=1e-12)[..., None]
    N = torch.where(has_nm[..., None], n_mapped, N)
    needs_tb_update = has_nm
    pbr["N"] = N
    pbr["Ng"] = hit["geonrm"]

    emissive = m["emissive_factor"]
    e_tex = tex("emissive_texture")
    emissive = emissive * torch.where((m["emissive_texture"] > 0)[..., None], e_tex[..., :3], 1.0)
    pbr["emissive"] = torch.clamp(emissive, min=0.0)

    # feature-off constants of the unported extension blocks
    pbr["thickness"] = full(0.0)
    pbr["attenuation_color"] = full(1.0, (3,))
    pbr["attenuation_distance"] = full(0.0)
    pbr["specular_color"] = full(1.0, (3,))
    pbr["specular"] = full(1.0)
    pbr["ior1"] = full(1.0)
    pbr["ior2"] = full(1.5)
    pbr["transmission"] = full(0.0)
    pbr["scatter_coefficient"] = full(0.0, (3,))
    pbr["scatter_anisotropy"] = full(0.0)
    pbr["Nc"] = pbr["N"]
    pbr["clearcoat"] = full(0.0)
    pbr["clearcoat_roughness"] = full(0.001)
    pbr["iridescence"] = full(0.0)
    pbr["iridescence_thickness"] = full(0.0)
    pbr["iridescence_ior"] = full(1.3)

    # re-orthonormalise the frame where the normal map moved N
    Bn = cross3(pbr["N"], T)
    Bn = Bn / torch.clamp(torch.sqrt(dot3(Bn, Bn)), min=1e-12)[..., None]
    bsign = torch.where(dot3(hit["bitangent"], Bn) < 0.0, -1.0, 1.0)[..., None]
    B_new = Bn * bsign
    T_new = cross3(B_new, pbr["N"]) * bsign
    T_new = T_new / torch.clamp(torch.sqrt(dot3(T_new, T_new)), min=1e-12)[..., None]
    pbr["T"] = torch.where(needs_tb_update[..., None], T_new, T)
    pbr["B"] = torch.where(needs_tb_update[..., None], B_new, hit["bitangent"])

    pbr["sheen_color"] = full(0.0, (3,))
    pbr["sheen_roughness"] = full(MICROFACET_MIN_ROUGHNESS)
    pbr["_sheen_on"] = full(0.0)
    pbr["dispersion"] = full(0.0)
    pbr["retroreflection"] = full(0.0)
    pbr["diffuse_transmission"] = full(0.0)
    pbr["diffuse_transmission_color"] = full(1.0, (3,))
    pbr["unlit"] = full(0.0)
    pbr["alpha_mode"] = m["alpha_mode"]
    pbr["alpha_cutoff"] = m["alpha_cutoff"]
    pbr["double_sided"] = m["double_sided"]
    return pbr


def get_opacity(scene, mat_id, hit, *, textured: bool = True):
    """Stochastic-alpha opacity at a hit: baseColor alpha x texture alpha x
    vertex alpha; MASK thresholds at the cutoff (reference :323)."""
    m = _gather_materials(scene, mat_id)
    bc = m["base_color_factor"]
    slot = m["base_color_texture"]
    if textured:
        tex = sample_texture(scene, slot, hit["uv0"], hit["uv1"], torch.zeros_like(hit["texel_density"]))
        a = bc[..., 3] * torch.where(slot > 0, tex[..., 3], 1.0) * hit["color"][..., 3]
    else:
        a = bc[..., 3] * hit["color"][..., 3]
    a = torch.where(m["alpha_mode"] == 1, torch.where(a >= m["alpha_cutoff"], 1.0, 0.0), a)
    return torch.where(m["alpha_mode"] == 0, 1.0, a)
