"""KHR_materials_variants: named material variant sets.

Reference: Scene::parseVariants / variant switching (gltf_scene.cpp, the
Variants UI). Selecting a variant rewrites each primitive's material from
its mappings and raises RENDER_NODES|MATERIALS dirty flags.
"""

from __future__ import annotations


def parse_variants(model) -> list:
    """Variant names declared by the asset."""
    ext = model.gltf.get("extensions", {}).get("KHR_materials_variants", {})
    return [v.get("name", f"variant {i}") for i, v in enumerate(ext.get("variants", []))]


def apply_variant(scene, variant_index: int) -> int:
    """Apply variant by index; returns number of primitives switched."""
    from .scene import DirtyFlags

    switched = 0
    for mesh in scene.model.meshes:
        for prim in mesh.get("primitives", []):
            mappings = prim.get("extensions", {}).get("KHR_materials_variants", {}).get("mappings", [])
            chosen = None
            for m in mappings:
                if variant_index in m.get("variants", []):
                    chosen = m.get("material")
                    break
            if chosen is None and mappings:
                # spec: fall back to the primitive's original material; keep
                # the original recorded so switching back works
                chosen = prim.get("extras", {}).get("_default_material", prim.get("material"))
            if mappings:
                prim.setdefault("extras", {}).setdefault("_default_material", prim.get("material"))
            if chosen is not None and chosen != prim.get("material"):
                prim["material"] = chosen
                switched += 1
    if switched:
        scene.mark_dirty(DirtyFlags.RENDER_NODES | DirtyFlags.MATERIALS)
        scene.parse_scene()
    return switched
