"""Model compaction: drop orphaned resources and unused buffer ranges.

Port of the reference's gltf_compact_model.cpp (compactModel: remove
meshes/materials/textures/images/samplers/accessors/bufferViews nothing
references) + gltf_compact_scene.cpp (buffer compaction: rewrite buffers
keeping only live byte ranges). Exhaustive cross-reference remapping, same
style as the merger.
"""

from __future__ import annotations

import numpy as np


def _collect_accessor_refs(g: dict):
    refs = set()
    for mesh in g.get("meshes", []):
        for prim in mesh.get("primitives", []):
            refs.update(prim.get("attributes", {}).values())
            if "indices" in prim:
                refs.add(prim["indices"])
            for t in prim.get("targets", []):
                refs.update(t.values())
    for skin in g.get("skins", []):
        if "inverseBindMatrices" in skin:
            refs.add(skin["inverseBindMatrices"])
    for anim in g.get("animations", []):
        for smp in anim.get("samplers", []):
            refs.add(smp["input"])
            refs.add(smp["output"])
    for node in g.get("nodes", []):
        inst = node.get("extensions", {}).get("EXT_mesh_gpu_instancing", {})
        refs.update(inst.get("attributes", {}).values())
    return refs


def _remap_list(g, key, used):
    """Compact g[key] to `used` (sorted), return old->new map."""
    items = g.get(key, [])
    keep = sorted(used & set(range(len(items))))
    remap = {old: new for new, old in enumerate(keep)}
    if items:
        g[key] = [items[i] for i in keep]
        if not g[key]:
            g.pop(key, None)
    return remap


def compact_model(model) -> dict:
    """Remove orphans; returns removal counts (reference compactModel,
    API gltf_scene.hpp:473)."""
    g = model.gltf
    counts = {}

    # --- live meshes / cameras / skins (from nodes)
    used_meshes = {n["mesh"] for n in g.get("nodes", []) if "mesh" in n}
    used_cameras = {n["camera"] for n in g.get("nodes", []) if "camera" in n}
    used_skins = {n["skin"] for n in g.get("nodes", []) if "skin" in n}
    counts["meshes"] = len(g.get("meshes", [])) - len(used_meshes)
    mesh_map = _remap_list(g, "meshes", used_meshes)
    cam_map = _remap_list(g, "cameras", used_cameras)
    skin_map = _remap_list(g, "skins", used_skins)
    for n in g.get("nodes", []):
        if "mesh" in n:
            n["mesh"] = mesh_map[n["mesh"]]
        if "camera" in n:
            n["camera"] = cam_map[n["camera"]]
        if "skin" in n:
            n["skin"] = skin_map[n["skin"]]

    # --- live materials
    used_mats = set()
    for mesh in g.get("meshes", []):
        for prim in mesh.get("primitives", []):
            if "material" in prim:
                used_mats.add(prim["material"])
    counts["materials"] = len(g.get("materials", [])) - len(used_mats)
    mat_map = _remap_list(g, "materials", used_mats)
    for mesh in g.get("meshes", []):
        for prim in mesh.get("primitives", []):
            if "material" in prim:
                prim["material"] = mat_map[prim["material"]]

    # --- live textures / images / samplers
    used_tex = set()

    def visit_tex(t):
        if isinstance(t, dict) and "index" in t:
            used_tex.add(t["index"])

    for mat in g.get("materials", []):
        pbr = mat.get("pbrMetallicRoughness", {})
        visit_tex(pbr.get("baseColorTexture"))
        visit_tex(pbr.get("metallicRoughnessTexture"))
        for k in ("normalTexture", "occlusionTexture", "emissiveTexture"):
            visit_tex(mat.get(k))
        for e in mat.get("extensions", {}).values():
            if isinstance(e, dict):
                for k, v in e.items():
                    if k.endswith("Texture"):
                        visit_tex(v)
    counts["textures"] = len(g.get("textures", [])) - len(used_tex)
    tex_map = _remap_list(g, "textures", used_tex)

    def fix_tex(t):
        if isinstance(t, dict) and "index" in t:
            t["index"] = tex_map[t["index"]]

    for mat in g.get("materials", []):
        pbr = mat.get("pbrMetallicRoughness", {})
        fix_tex(pbr.get("baseColorTexture"))
        fix_tex(pbr.get("metallicRoughnessTexture"))
        for k in ("normalTexture", "occlusionTexture", "emissiveTexture"):
            fix_tex(mat.get(k))
        for e in mat.get("extensions", {}).values():
            if isinstance(e, dict):
                for k, v in e.items():
                    if k.endswith("Texture"):
                        fix_tex(v)

    used_imgs = {t["source"] for t in g.get("textures", []) if "source" in t}
    used_samp = {t["sampler"] for t in g.get("textures", []) if "sampler" in t}
    counts["images"] = len(g.get("images", [])) - len(used_imgs)
    img_map = _remap_list(g, "images", used_imgs)
    samp_map = _remap_list(g, "samplers", used_samp)
    for t in g.get("textures", []):
        if "source" in t:
            t["source"] = img_map[t["source"]]
        if "sampler" in t:
            t["sampler"] = samp_map[t["sampler"]]

    # --- live accessors / bufferViews
    used_acc = _collect_accessor_refs(g)
    counts["accessors"] = len(g.get("accessors", [])) - len(used_acc)
    acc_map = _remap_list(g, "accessors", used_acc)

    def fix_acc_refs():
        for mesh in g.get("meshes", []):
            for prim in mesh.get("primitives", []):
                prim["attributes"] = {k: acc_map[v] for k, v in prim.get("attributes", {}).items()}
                if "indices" in prim:
                    prim["indices"] = acc_map[prim["indices"]]
                if "targets" in prim:
                    prim["targets"] = [{k: acc_map[v] for k, v in t.items()} for t in prim["targets"]]
        for skin in g.get("skins", []):
            if "inverseBindMatrices" in skin:
                skin["inverseBindMatrices"] = acc_map[skin["inverseBindMatrices"]]
        for anim in g.get("animations", []):
            for smp in anim.get("samplers", []):
                smp["input"] = acc_map[smp["input"]]
                smp["output"] = acc_map[smp["output"]]
        for node in g.get("nodes", []):
            inst = node.get("extensions", {}).get("EXT_mesh_gpu_instancing", {})
            if "attributes" in inst:
                inst["attributes"] = {k: acc_map[v] for k, v in inst["attributes"].items()}

    fix_acc_refs()

    used_bv = {a["bufferView"] for a in g.get("accessors", []) if "bufferView" in a}
    for a in g.get("accessors", []):
        sp = a.get("sparse")
        if sp:
            used_bv.add(sp["indices"]["bufferView"])
            used_bv.add(sp["values"]["bufferView"])
    for img in g.get("images", []):
        if "bufferView" in img:
            used_bv.add(img["bufferView"])
    counts["bufferViews"] = len(g.get("bufferViews", [])) - len(used_bv)
    bv_map = _remap_list(g, "bufferViews", used_bv)
    for a in g.get("accessors", []):
        if "bufferView" in a:
            a["bufferView"] = bv_map[a["bufferView"]]
        sp = a.get("sparse")
        if sp:
            sp["indices"]["bufferView"] = bv_map[sp["indices"]["bufferView"]]
            sp["values"]["bufferView"] = bv_map[sp["values"]["bufferView"]]
    for img in g.get("images", []):
        if "bufferView" in img:
            img["bufferView"] = bv_map[img["bufferView"]]

    return counts


def compact_buffers(model) -> int:
    """Rewrite buffers keeping only bytes referenced by bufferViews
    (gltf_compact_scene.cpp buffer compaction). Returns bytes saved."""
    g = model.gltf
    views = g.get("bufferViews", [])
    old_total = sum(len(b) for b in model.buffers)
    new_buffers = [bytearray() for _ in model.buffers]
    for bv in views:
        bi = bv.get("buffer", 0)
        src = model.buffers[bi]
        off = bv.get("byteOffset", 0)
        ln = bv.get("byteLength", 0)
        nb = new_buffers[bi]
        pad = -len(nb) % 4
        nb.extend(b"\0" * pad)
        bv["byteOffset"] = len(nb)
        nb.extend(src[off : off + ln])
    model.buffers = new_buffers
    for i, b in enumerate(g.get("buffers", [])):
        b["byteLength"] = len(new_buffers[i]) if i < len(new_buffers) else 0
        b.pop("uri", None)  # payload now in-memory; save re-embeds
    return old_total - sum(len(b) for b in model.buffers)
