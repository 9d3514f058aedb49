"""Material conversion: glTF material dict -> flat shade-material record.

Rebuild of the reference MaterialCache (gltf_material_cache.hpp:58-84):
tinygltf::Material -> shaderio::GltfShadeMaterial + packed GltfTextureInfo[].
Here the "device struct" is a struct-of-arrays (ops/flat.py packs it); this
module produces per-material python records with the exact same field
semantics as gltf_scene_io.h.slang:147-310, plus the texture-info table with
slot 0 reserved as the "no texture" sentinel (gltf_scene_io.h.slang:251).

Also hosts scene feature detection (reference scene_feature_detection.cpp):
which KHR_materials_* extensions a scene actually uses — drives shade-function
specialization (the TPU analog of the GLTF_USE_* recompile).
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields as dc_fields

import numpy as np

ALPHA_OPAQUE, ALPHA_MASK, ALPHA_BLEND = 0, 1, 2
PBR_METALLIC_ROUGHNESS, PBR_SPECULAR_GLOSSINESS = 0, 1

# Feature names mirror the reference's SceneFeatureSet bits
# (scene_feature_detection.hpp:47-104).
ALL_FEATURES = (
    "transmission",
    "volume",
    "volume_scatter",
    "ior",
    "specular",
    "clearcoat",
    "iridescence",
    "anisotropy",
    "sheen",
    "dispersion",
    "retroreflection",
    "specular_glossiness",
    "diffuse_transmission",
    "unlit",
    "emissive_strength",
    "texture_transform",
)


@dataclass
class TextureInfo:
    """One slot of the texture-info table (gltf_scene_io.h.slang:121-128)."""

    index: int = -1  # into the scene's texture descriptor table
    tex_coord: int = 0  # 0 or 1
    uv_transform: np.ndarray = field(default_factory=lambda: np.eye(3, dtype=np.float32)[:, :2].T.copy())
    # uv_transform is the KHR_texture_transform 2x3 (row-major [2,3]):
    # uv' = M @ [u, v, 1]


@dataclass
class ShadeMaterial:
    """Flat material record — field semantics of GltfShadeMaterial
    (gltf_scene_io.h.slang:147-310). Texture members are indices into the
    texture-info table; 0 = "no texture" sentinel."""

    base_color_factor: np.ndarray = field(default_factory=lambda: np.ones(4, np.float32))
    emissive_factor: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    normal_texture_scale: float = 1.0
    roughness_factor: float = 1.0
    metallic_factor: float = 1.0
    alpha_mode: int = ALPHA_OPAQUE
    alpha_cutoff: float = 0.5
    occlusion_strength: float = 1.0
    double_sided: int = 0
    # KHR_materials_volume
    attenuation_color: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))
    thickness_factor: float = 0.0
    attenuation_distance: float = 0.0
    # KHR_materials_ior
    ior: float = 1.5
    # KHR_materials_transmission
    transmission_factor: float = 0.0
    # KHR_materials_clearcoat
    clearcoat_factor: float = 0.0
    clearcoat_roughness: float = 0.0
    # KHR_materials_specular
    specular_color_factor: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))
    specular_factor: float = 1.0
    # KHR_materials_unlit
    unlit: int = 0
    # KHR_materials_iridescence
    iridescence_factor: float = 0.0
    iridescence_thickness_minimum: float = 100.0
    iridescence_thickness_maximum: float = 400.0
    iridescence_ior: float = 1.3
    # KHR_materials_anisotropy
    anisotropy_rotation: np.ndarray = field(default_factory=lambda: np.array([0.0, 1.0], np.float32))  # (sin, cos)
    anisotropy_strength: float = 0.0
    # KHR_materials_sheen
    sheen_color_factor: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    sheen_roughness_factor: float = 0.0
    # KHR_materials_dispersion
    dispersion: float = 0.0
    # KHR_materials_retroreflection (MRM, raster/preview path only — the
    # reference's path tracer also ignores it, gltf_raster.slang:136-175)
    retroreflection_factor: float = 0.0
    # KHR_materials_pbrSpecularGlossiness (deprecated)
    pbr_model: int = PBR_METALLIC_ROUGHNESS
    diffuse_factor: np.ndarray = field(default_factory=lambda: np.ones(4, np.float32))
    specular_glossiness_factor: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))
    glossiness_factor: float = 1.0
    # KHR_materials_diffuse_transmission
    diffuse_transmission_color: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))
    diffuse_transmission_factor: float = 0.0
    # KHR_materials_volume_scatter (vendor draft used by the reference)
    multiscatter_color_factor: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    scatter_anisotropy: float = 0.0

    # texture slots (0 = none)
    base_color_texture: int = 0
    normal_texture: int = 0
    metallic_roughness_texture: int = 0
    emissive_texture: int = 0
    occlusion_texture: int = 0
    transmission_texture: int = 0
    retroreflection_texture: int = 0
    thickness_texture: int = 0
    clearcoat_texture: int = 0
    clearcoat_roughness_texture: int = 0
    clearcoat_normal_texture: int = 0
    specular_texture: int = 0
    specular_color_texture: int = 0
    iridescence_texture: int = 0
    iridescence_thickness_texture: int = 0
    anisotropy_texture: int = 0
    sheen_color_texture: int = 0
    sheen_roughness_texture: int = 0
    diffuse_texture: int = 0
    specular_glossiness_texture: int = 0
    diffuse_transmission_texture: int = 0
    diffuse_transmission_color_texture: int = 0


TEXTURE_SLOT_FIELDS = tuple(f.name for f in dc_fields(ShadeMaterial) if f.name.endswith("_texture") or f.name.endswith("texture"))


def default_material() -> ShadeMaterial:
    return ShadeMaterial()


class MaterialConverter:
    """Builds the ShadeMaterial list + TextureInfo table for a Model.

    Slot 0 of the texture-info table is the invalid sentinel
    (gltf_scene_io.h.slang:251) so `tex_slot > 0` means "present" — the
    device code keeps the same convention (isTexturePresent,
    gltf_material_eval.h.slang:115-118).
    """

    def __init__(self, model):
        self.model = model
        self.texture_infos: list[TextureInfo] = [TextureInfo()]  # slot 0 sentinel
        self._info_cache: dict[tuple, int] = {}

    def _tex_slot(self, tex_ref: dict | None) -> int:
        if not tex_ref or "index" not in tex_ref:
            return 0
        gltf_tex_index = tex_ref["index"]
        tex = self.model.textures[gltf_tex_index]
        # extension sources take precedence over the fallback `source`
        # (EXT_texture_webp / MSFT_texture_dds / KHR_texture_basisu all
        # carry {"source": image}; the base source is the PNG/JPG fallback)
        text = tex.get("extensions", {})
        source = -1
        for e in ("EXT_texture_webp", "MSFT_texture_dds", "KHR_texture_basisu"):
            if e in text and text[e].get("source") is not None:
                source = text[e]["source"]
                break
        if source < 0:
            source = tex.get("source", -1)
        tc = tex_ref.get("texCoord", 0)
        xf = tex_ref.get("extensions", {}).get("KHR_texture_transform")
        uvt = np.array([[1, 0, 0], [0, 1, 0]], np.float32)
        if xf:
            off = xf.get("offset", [0.0, 0.0])
            rot = xf.get("rotation", 0.0)
            sc = xf.get("scale", [1.0, 1.0])
            tc = xf.get("texCoord", tc)
            c, s = np.cos(rot), np.sin(rot)
            # KHR_texture_transform: uv' = T * R * S * uv
            uvt = np.array(
                [[c * sc[0], -s * sc[1], off[0]], [s * sc[0], c * sc[1], off[1]]],
                np.float32,
            )
        key = (int(source), int(tc), uvt.tobytes())
        slot = self._info_cache.get(key)
        if slot is None:
            slot = len(self.texture_infos)
            self.texture_infos.append(TextureInfo(index=int(source), tex_coord=int(tc), uv_transform=uvt))
            self._info_cache[key] = slot
        return slot

    def convert(self, mat: dict) -> ShadeMaterial:
        m = ShadeMaterial()
        pbr = mat.get("pbrMetallicRoughness", {})
        m.base_color_factor = np.asarray(pbr.get("baseColorFactor", [1, 1, 1, 1]), np.float32)
        m.metallic_factor = pbr.get("metallicFactor", 1.0)
        m.roughness_factor = pbr.get("roughnessFactor", 1.0)
        m.base_color_texture = self._tex_slot(pbr.get("baseColorTexture"))
        m.metallic_roughness_texture = self._tex_slot(pbr.get("metallicRoughnessTexture"))
        m.emissive_factor = np.asarray(mat.get("emissiveFactor", [0, 0, 0]), np.float32)
        m.emissive_texture = self._tex_slot(mat.get("emissiveTexture"))
        nt = mat.get("normalTexture")
        m.normal_texture = self._tex_slot(nt)
        if nt:
            m.normal_texture_scale = nt.get("scale", 1.0)
        ot = mat.get("occlusionTexture")
        m.occlusion_texture = self._tex_slot(ot)
        if ot:
            m.occlusion_strength = ot.get("strength", 1.0)
        m.alpha_mode = {"OPAQUE": ALPHA_OPAQUE, "MASK": ALPHA_MASK, "BLEND": ALPHA_BLEND}[mat.get("alphaMode", "OPAQUE")]
        m.alpha_cutoff = mat.get("alphaCutoff", 0.5)
        m.double_sided = int(bool(mat.get("doubleSided", False)))

        ext = mat.get("extensions", {})
        if "KHR_materials_emissive_strength" in ext:
            m.emissive_factor = m.emissive_factor * np.float32(ext["KHR_materials_emissive_strength"].get("emissiveStrength", 1.0))
        if "KHR_materials_ior" in ext:
            m.ior = ext["KHR_materials_ior"].get("ior", 1.5)
        if "KHR_materials_transmission" in ext:
            e = ext["KHR_materials_transmission"]
            m.transmission_factor = e.get("transmissionFactor", 0.0)
            m.transmission_texture = self._tex_slot(e.get("transmissionTexture"))
        if "KHR_materials_volume" in ext:
            e = ext["KHR_materials_volume"]
            m.thickness_factor = e.get("thicknessFactor", 0.0)
            m.thickness_texture = self._tex_slot(e.get("thicknessTexture"))
            m.attenuation_color = np.asarray(e.get("attenuationColor", [1, 1, 1]), np.float32)
            m.attenuation_distance = e.get("attenuationDistance", 0.0)
        if "KHR_materials_clearcoat" in ext:
            e = ext["KHR_materials_clearcoat"]
            m.clearcoat_factor = e.get("clearcoatFactor", 0.0)
            m.clearcoat_roughness = e.get("clearcoatRoughnessFactor", 0.0)
            m.clearcoat_texture = self._tex_slot(e.get("clearcoatTexture"))
            m.clearcoat_roughness_texture = self._tex_slot(e.get("clearcoatRoughnessTexture"))
            m.clearcoat_normal_texture = self._tex_slot(e.get("clearcoatNormalTexture"))
        if "KHR_materials_specular" in ext:
            e = ext["KHR_materials_specular"]
            m.specular_factor = e.get("specularFactor", 1.0)
            m.specular_color_factor = np.asarray(e.get("specularColorFactor", [1, 1, 1]), np.float32)
            m.specular_texture = self._tex_slot(e.get("specularTexture"))
            m.specular_color_texture = self._tex_slot(e.get("specularColorTexture"))
        if "KHR_materials_unlit" in ext:
            m.unlit = 1
        if "KHR_materials_iridescence" in ext:
            e = ext["KHR_materials_iridescence"]
            m.iridescence_factor = e.get("iridescenceFactor", 0.0)
            m.iridescence_ior = e.get("iridescenceIor", 1.3)
            m.iridescence_thickness_minimum = e.get("iridescenceThicknessMinimum", 100.0)
            m.iridescence_thickness_maximum = e.get("iridescenceThicknessMaximum", 400.0)
            m.iridescence_texture = self._tex_slot(e.get("iridescenceTexture"))
            m.iridescence_thickness_texture = self._tex_slot(e.get("iridescenceThicknessTexture"))
        if "KHR_materials_anisotropy" in ext:
            e = ext["KHR_materials_anisotropy"]
            m.anisotropy_strength = e.get("anisotropyStrength", 0.0)
            rot = e.get("anisotropyRotation", 0.0)
            m.anisotropy_rotation = np.array([np.sin(rot), np.cos(rot)], np.float32)
            m.anisotropy_texture = self._tex_slot(e.get("anisotropyTexture"))
        if "KHR_materials_sheen" in ext:
            e = ext["KHR_materials_sheen"]
            m.sheen_color_factor = np.asarray(e.get("sheenColorFactor", [0, 0, 0]), np.float32)
            m.sheen_roughness_factor = e.get("sheenRoughnessFactor", 0.0)
            m.sheen_color_texture = self._tex_slot(e.get("sheenColorTexture"))
            m.sheen_roughness_texture = self._tex_slot(e.get("sheenRoughnessTexture"))
        if "KHR_materials_dispersion" in ext:
            m.dispersion = ext["KHR_materials_dispersion"].get("dispersion", 0.0)
        if "KHR_materials_retroreflection" in ext:
            e = ext["KHR_materials_retroreflection"]
            m.retroreflection_factor = e.get("retroreflectionFactor", 0.0)
            m.retroreflection_texture = self._tex_slot(e.get("retroreflectionTexture"))
        if "KHR_materials_pbrSpecularGlossiness" in ext:
            e = ext["KHR_materials_pbrSpecularGlossiness"]
            m.pbr_model = PBR_SPECULAR_GLOSSINESS
            m.diffuse_factor = np.asarray(e.get("diffuseFactor", [1, 1, 1, 1]), np.float32)
            m.specular_glossiness_factor = np.asarray(e.get("specularFactor", [1, 1, 1]), np.float32)
            m.glossiness_factor = e.get("glossinessFactor", 1.0)
            m.diffuse_texture = self._tex_slot(e.get("diffuseTexture"))
            m.specular_glossiness_texture = self._tex_slot(e.get("specularGlossinessTexture"))
        if "KHR_materials_diffuse_transmission" in ext:
            e = ext["KHR_materials_diffuse_transmission"]
            m.diffuse_transmission_factor = e.get("diffuseTransmissionFactor", 0.0)
            m.diffuse_transmission_color = np.asarray(e.get("diffuseTransmissionColorFactor", [1, 1, 1]), np.float32)
            m.diffuse_transmission_texture = self._tex_slot(e.get("diffuseTransmissionTexture"))
            m.diffuse_transmission_color_texture = self._tex_slot(e.get("diffuseTransmissionColorTexture"))
        if "KHR_materials_volume_scatter" in ext:
            e = ext["KHR_materials_volume_scatter"]
            m.multiscatter_color_factor = np.asarray(e.get("multiscatterColor", e.get("multiscatterColorFactor", [0, 0, 0])), np.float32)
            m.scatter_anisotropy = e.get("scatterAnisotropy", 0.0)
        return m

    def convert_all(self) -> list[ShadeMaterial]:
        mats = [self.convert(m) for m in self.model.materials]
        if not mats:
            mats = [default_material()]
        return mats


def detect_scene_features(model) -> frozenset:
    """Which material features the scene uses (reference detectSceneFeatures
    scene_feature_detection.cpp:1-244). Drives shade-function specialization:
    unused extension branches are dropped before jit, mirroring the
    GLTF_USE_* optimal-recompile system."""
    feats = set()
    ext_map = {
        "KHR_materials_transmission": "transmission",
        "KHR_materials_volume": "volume",
        "KHR_materials_volume_scatter": "volume_scatter",
        "KHR_materials_ior": "ior",
        "KHR_materials_specular": "specular",
        "KHR_materials_clearcoat": "clearcoat",
        "KHR_materials_iridescence": "iridescence",
        "KHR_materials_anisotropy": "anisotropy",
        "KHR_materials_sheen": "sheen",
        "KHR_materials_dispersion": "dispersion",
        "KHR_materials_retroreflection": "retroreflection",
        "KHR_materials_pbrSpecularGlossiness": "specular_glossiness",
        "KHR_materials_diffuse_transmission": "diffuse_transmission",
        "KHR_materials_unlit": "unlit",
        "KHR_materials_emissive_strength": "emissive_strength",
    }
    for mat in model.materials:
        for e in mat.get("extensions", {}):
            if e in ext_map:
                feats.add(ext_map[e])
        for name, tex_holder in _iter_texture_refs(mat):
            if "KHR_texture_transform" in tex_holder.get("extensions", {}):
                feats.add("texture_transform")
            # per-SLOT specialization flags (the GLTF_USE_* data half): a
            # texture slot used by NO material in the scene compiles to a
            # constant in evaluate_material — each dropped slot saves ~8
            # full-width texel-pool gathers per bounce, the single largest
            # textured-frame cost measured on v5e (tools/exp_glue.py:
            # helmet mateval 1603 ms with 5 naive slots)
            feats.add("tex:" + _camel_to_snake(name))
    return frozenset(feats)


def _camel_to_snake(name: str) -> str:
    """baseColorTexture -> base_color_texture (the ShadeMaterial field)."""
    out = []
    for ch in name:
        if ch.isupper():
            out.append("_")
            out.append(ch.lower())
        else:
            out.append(ch)
    return "".join(out)


def _iter_texture_refs(mat: dict):
    """Yields (gltfFieldName, texture_info_dict) for every texture
    reference on the material."""
    pbr = mat.get("pbrMetallicRoughness", {})
    for k in ("baseColorTexture", "metallicRoughnessTexture"):
        if k in pbr:
            yield k, pbr[k]
    for k in ("normalTexture", "occlusionTexture", "emissiveTexture"):
        if k in mat:
            yield k, mat[k]
    for e in mat.get("extensions", {}).values():
        if isinstance(e, dict):
            for k, v in e.items():
                if k.endswith("Texture") and isinstance(v, dict):
                    yield k, v


# ---------------------------------------------------------------- utilities
# Typed get/set accessors for extensions the renderer stores but does not
# shade with — the tinygltf_utils surface (tinygltf_utils.hpp:160-165,
# :202-216). Values round-trip through save untouched either way; these
# give tools/editors a typed view.

def get_displacement(mat: dict) -> dict:
    """KHR_materials_displacement (tinygltf_utils.hpp:160-165)."""
    e = mat.get("extensions", {}).get("KHR_materials_displacement", {})
    return {
        "factor": e.get("displacementGeometryFactor", 1.0),
        "offset": e.get("displacementGeometryOffset", 0.0),
        "texture": e.get("displacementGeometryTexture", {}).get("index", -1),
    }


def set_displacement(mat: dict, factor=1.0, offset=0.0, texture=-1) -> None:
    e = mat.setdefault("extensions", {}).setdefault("KHR_materials_displacement", {})
    e["displacementGeometryFactor"] = float(factor)
    e["displacementGeometryOffset"] = float(offset)
    if texture >= 0:
        e["displacementGeometryTexture"] = {"index": int(texture)}
    else:
        e.pop("displacementGeometryTexture", None)


def get_node_interaction(node: dict) -> dict:
    """KHR_node_visibility / selectability / hoverability flags
    (tinygltf_utils.hpp:202-216); missing extension means True."""
    ext = node.get("extensions", {})
    return {
        "visible": ext.get("KHR_node_visibility", {}).get("visible", True),
        "selectable": ext.get("KHR_node_selectability", {}).get("selectable", True),
        "hoverable": ext.get("KHR_node_hoverability", {}).get("hoverable", True),
    }


def set_node_interaction(node: dict, visible=None, selectable=None, hoverable=None) -> None:
    ext = node.setdefault("extensions", {})
    for key, name, val in (
        ("KHR_node_visibility", "visible", visible),
        ("KHR_node_selectability", "selectable", selectable),
        ("KHR_node_hoverability", "hoverable", hoverable),
    ):
        if val is None:
            continue
        if val:  # default-true: drop the extension entirely
            ext.pop(key, None)
        else:
            ext[key] = {name: False}


def has_interactivity(model) -> bool:
    """KHR_interactivity presence (behavior graphs are tool-side data; the
    reference also only detects/preserves them, tinygltf_utils.hpp:216)."""
    return "KHR_interactivity" in model.gltf.get("extensions", {})
