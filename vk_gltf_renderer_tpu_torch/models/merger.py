"""SceneMerger: merge a second glTF Model into a target with exhaustive
index rebasing (reference gltf_scene_merger.{hpp,cpp}: `IndexRemapping`
rebases every cross-reference class; `instanceSubtree` shares geometry for
repeated external-asset references, docs/external_assets.md:80-100).
"""

from __future__ import annotations

import copy


_REBASED_ARRAYS = (
    "nodes",
    "meshes",
    "materials",
    "accessors",
    "bufferViews",
    "buffers",
    "textures",
    "images",
    "samplers",
    "skins",
    "cameras",
    "animations",
)


class IndexRemapping:
    """Offsets applied to every index class when appending a source Model."""

    def __init__(self, target_gltf: dict):
        self.off = {k: len(target_gltf.get(k, [])) for k in _REBASED_ARRAYS}

    def node(self, i):
        return i + self.off["nodes"]

    def __getitem__(self, kind):
        return self.off[kind]


def merge_model(target, source, *, attach_to_scene: bool = True) -> dict:
    """Append `source` (GltfModel) into `target` (GltfModel), rebasing all
    indices. Returns info dict {root_nodes: [...], remap: IndexRemapping}.

    The source is deep-copied; target buffers gain the source payloads.
    """
    tg = target.gltf
    sg = copy.deepcopy(source.gltf)
    remap = IndexRemapping(tg)

    def r(kind, i):
        return i + remap[kind]

    # ---- nodes
    for node in sg.get("nodes", []):
        if "children" in node:
            node["children"] = [r("nodes", c) for c in node["children"]]
        if "mesh" in node:
            node["mesh"] = r("meshes", node["mesh"])
        if "skin" in node:
            node["skin"] = r("skins", node["skin"])
        if "camera" in node:
            node["camera"] = r("cameras", node["camera"])
        ext = node.get("extensions", {})
        if "KHR_lights_punctual" in ext:
            ext["KHR_lights_punctual"]["light"] = ext["KHR_lights_punctual"]["light"] + len(
                tg.get("extensions", {}).get("KHR_lights_punctual", {}).get("lights", [])
            )
        if "EXT_mesh_gpu_instancing" in ext:
            attrs = ext["EXT_mesh_gpu_instancing"].get("attributes", {})
            for k in attrs:
                attrs[k] = r("accessors", attrs[k])

    # ---- meshes / primitives
    for mesh in sg.get("meshes", []):
        for prim in mesh.get("primitives", []):
            prim["attributes"] = {k: r("accessors", v) for k, v in prim.get("attributes", {}).items()}
            if "indices" in prim:
                prim["indices"] = r("accessors", prim["indices"])
            if "material" in prim:
                prim["material"] = r("materials", prim["material"])
            if "targets" in prim:
                prim["targets"] = [{k: r("accessors", v) for k, v in t.items()} for t in prim["targets"]]

    # ---- accessors / bufferViews
    for a in sg.get("accessors", []):
        if "bufferView" in a:
            a["bufferView"] = r("bufferViews", a["bufferView"])
        sp = a.get("sparse")
        if sp:
            sp["indices"]["bufferView"] = r("bufferViews", sp["indices"]["bufferView"])
            sp["values"]["bufferView"] = r("bufferViews", sp["values"]["bufferView"])
    for bv in sg.get("bufferViews", []):
        bv["buffer"] = r("buffers", bv.get("buffer", 0))

    # ---- materials: texture refs
    def fix_tex(t):
        if isinstance(t, dict) and "index" in t:
            t["index"] = r("textures", t["index"])

    for mat in sg.get("materials", []):
        pbr = mat.get("pbrMetallicRoughness", {})
        fix_tex(pbr.get("baseColorTexture"))
        fix_tex(pbr.get("metallicRoughnessTexture"))
        fix_tex(mat.get("normalTexture"))
        fix_tex(mat.get("occlusionTexture"))
        fix_tex(mat.get("emissiveTexture"))
        for e in mat.get("extensions", {}).values():
            if isinstance(e, dict):
                for k, v in e.items():
                    if k.endswith("Texture"):
                        fix_tex(v)

    for tex in sg.get("textures", []):
        if "source" in tex:
            tex["source"] = r("images", tex["source"])
        if "sampler" in tex:
            tex["sampler"] = r("samplers", tex["sampler"])
    for img in sg.get("images", []):
        if "bufferView" in img:
            img["bufferView"] = r("bufferViews", img["bufferView"])

    # ---- skins / animations
    for skin in sg.get("skins", []):
        skin["joints"] = [r("nodes", j) for j in skin.get("joints", [])]
        if "skeleton" in skin:
            skin["skeleton"] = r("nodes", skin["skeleton"])
        if "inverseBindMatrices" in skin:
            skin["inverseBindMatrices"] = r("accessors", skin["inverseBindMatrices"])
    for anim in sg.get("animations", []):
        for ch in anim.get("channels", []):
            tgt = ch.get("target", {})
            if "node" in tgt:
                tgt["node"] = r("nodes", tgt["node"])
        for smp in anim.get("samplers", []):
            smp["input"] = r("accessors", smp["input"])
            smp["output"] = r("accessors", smp["output"])

    # ---- append arrays
    for kind in _REBASED_ARRAYS:
        if sg.get(kind):
            tg.setdefault(kind, []).extend(sg[kind])
    target.buffers.extend(bytearray(b) for b in source.buffers)

    # punctual light definitions
    src_lights = sg.get("extensions", {}).get("KHR_lights_punctual", {}).get("lights", [])
    if src_lights:
        tg.setdefault("extensions", {}).setdefault("KHR_lights_punctual", {}).setdefault("lights", []).extend(src_lights)

    # extensionsUsed union
    used = set(tg.get("extensionsUsed", [])) | set(sg.get("extensionsUsed", []))
    if used:
        tg["extensionsUsed"] = sorted(used)

    # source roots -> target scene
    src_scene = sg.get("scenes", [{}])[sg.get("scene", 0)] if sg.get("scenes") else {}
    roots = [r("nodes", n) for n in src_scene.get("nodes", [])]
    if attach_to_scene and roots:
        scenes = tg.setdefault("scenes", [{"nodes": []}])
        scenes[tg.get("scene", 0)].setdefault("nodes", []).extend(roots)

    return {"root_nodes": roots, "remap": remap}


def instance_subtree(target, root_nodes: list, *, transform=None) -> list:
    """Duplicate only the NODE subtree (sharing meshes/materials) — the
    cheap path for a repeated external-asset reference
    (docs/external_assets.md:80-100)."""
    import copy as _copy

    tg = target.gltf
    nodes = tg.get("nodes", [])
    remap = {}

    def dup(nid):
        node = _copy.deepcopy(nodes[nid])
        children = node.pop("children", [])
        nodes.append(node)
        new_id = len(nodes) - 1
        remap[nid] = new_id
        kids = [dup(c) for c in children]
        if kids:
            node["children"] = kids
        return new_id

    new_roots = [dup(rt) for rt in root_nodes]
    if transform is not None and new_roots:
        # wrap in a transform holder node
        holder = {"children": new_roots, "matrix": [float(x) for x in transform]}
        nodes.append(holder)
        new_roots = [len(nodes) - 1]
    scenes = tg.setdefault("scenes", [{"nodes": []}])
    scenes[tg.get("scene", 0)].setdefault("nodes", []).extend(new_roots)
    return new_roots
