"""SceneValidator: structural validation of a glTF Model
(reference gltf_scene_validator.{hpp,cpp}; ValidationResult
gltf_scene.hpp:227-242).

Checks index bounds (nodes/meshes/materials/accessors/bufferViews/
buffers/textures), accessor ranges vs buffer sizes, primitive attribute
consistency, scene-graph cycles, and skin joint validity. Errors mean the
scene cannot be safely parsed; warnings are recoverable oddities.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .accessors import component_dtype, num_components


@dataclass
class ValidationResult:
    errors: list = field(default_factory=list)
    warnings: list = field(default_factory=list)

    @property
    def valid(self) -> bool:
        return not self.errors

    def error(self, msg: str) -> None:
        self.errors.append(msg)

    def warn(self, msg: str) -> None:
        self.warnings.append(msg)


def validate_model(model) -> ValidationResult:
    r = ValidationResult()
    g = model.gltf
    nodes = g.get("nodes", [])
    meshes = g.get("meshes", [])
    materials = g.get("materials", [])
    accessors = g.get("accessors", [])
    buffer_views = g.get("bufferViews", [])
    buffers = g.get("buffers", [])
    textures = g.get("textures", [])
    images = g.get("images", [])
    skins = g.get("skins", [])

    # ---- scene / node graph
    for si, sc in enumerate(g.get("scenes", [])):
        for n in sc.get("nodes", []):
            if not 0 <= n < len(nodes):
                r.error(f"scene {si}: root node {n} out of range")
    seen_parent = {}
    for ni, node in enumerate(nodes):
        for c in node.get("children", []):
            if not 0 <= c < len(nodes):
                r.error(f"node {ni}: child {c} out of range")
                continue
            if c in seen_parent:
                r.error(f"node {c} has multiple parents ({seen_parent[c]} and {ni})")
            seen_parent[c] = ni
        if "mesh" in node and not 0 <= node["mesh"] < len(meshes):
            r.error(f"node {ni}: mesh {node['mesh']} out of range")
        if "skin" in node and not 0 <= node["skin"] < len(skins):
            r.error(f"node {ni}: skin {node['skin']} out of range")
        if "camera" in node and not 0 <= node["camera"] < len(g.get("cameras", [])):
            r.error(f"node {ni}: camera {node['camera']} out of range")
    # cycle check
    color = {}

    def visit(n, stack):
        if color.get(n) == 1:
            r.error(f"node cycle involving node {n}")
            return
        if color.get(n) == 2:
            return
        color[n] = 1
        for c in nodes[n].get("children", []):
            if 0 <= c < len(nodes):
                visit(c, stack)
        color[n] = 2

    for sc in g.get("scenes", []):
        for root in sc.get("nodes", []):
            if 0 <= root < len(nodes):
                visit(root, [])

    # ---- accessors / buffer views
    for ai, a in enumerate(accessors):
        if "bufferView" in a:
            if not 0 <= a["bufferView"] < len(buffer_views):
                r.error(f"accessor {ai}: bufferView {a['bufferView']} out of range")
                continue
            bv = buffer_views[a["bufferView"]]
            try:
                elem = component_dtype(a["componentType"]).itemsize * num_components(a["type"])
            except KeyError:
                r.error(f"accessor {ai}: bad componentType/type")
                continue
            stride = bv.get("byteStride", 0) or elem
            need = a.get("byteOffset", 0) + stride * (a["count"] - 1) + elem if a["count"] else 0
            if need > bv.get("byteLength", 0):
                r.error(f"accessor {ai}: overruns bufferView ({need} > {bv.get('byteLength', 0)})")
    for vi, bv in enumerate(buffer_views):
        if not 0 <= bv.get("buffer", 0) < max(len(buffers), 1):
            r.error(f"bufferView {vi}: buffer {bv.get('buffer')} out of range")
            continue
        bi = bv.get("buffer", 0)
        if bi < len(model.buffers):
            blen = len(model.buffers[bi])
            if bv.get("byteOffset", 0) + bv.get("byteLength", 0) > blen:
                r.error(f"bufferView {vi}: overruns buffer ({bv.get('byteOffset', 0)}+{bv.get('byteLength', 0)} > {blen})")

    # ---- meshes / primitives
    for mi, mesh in enumerate(meshes):
        prims = mesh.get("primitives", [])
        if not prims:
            r.warn(f"mesh {mi}: no primitives")
        for pi, prim in enumerate(prims):
            attrs = prim.get("attributes", {})
            if "POSITION" not in attrs:
                r.error(f"mesh {mi} prim {pi}: missing POSITION")
            counts = set()
            for name, ai in attrs.items():
                if not 0 <= ai < len(accessors):
                    r.error(f"mesh {mi} prim {pi}: attribute {name} accessor {ai} out of range")
                else:
                    counts.add(accessors[ai]["count"])
            if len(counts) > 1:
                r.error(f"mesh {mi} prim {pi}: attribute counts differ {sorted(counts)}")
            if "indices" in prim:
                ia = prim["indices"]
                if not 0 <= ia < len(accessors):
                    r.error(f"mesh {mi} prim {pi}: indices accessor {ia} out of range")
                elif prim.get("mode", 4) == 4 and accessors[ia]["count"] % 3 != 0:
                    r.warn(f"mesh {mi} prim {pi}: triangle index count {accessors[ia]['count']} not divisible by 3")
            if "material" in prim and not 0 <= prim["material"] < len(materials):
                r.error(f"mesh {mi} prim {pi}: material {prim['material']} out of range")

    # ---- materials / textures
    for mi, mat in enumerate(materials):
        pbr = mat.get("pbrMetallicRoughness", {})
        for key, holder in [("baseColorTexture", pbr), ("metallicRoughnessTexture", pbr), ("normalTexture", mat), ("occlusionTexture", mat), ("emissiveTexture", mat)]:
            t = holder.get(key)
            if t and not 0 <= t.get("index", -1) < len(textures):
                r.error(f"material {mi}: {key} index {t.get('index')} out of range")
    for ti, tex in enumerate(textures):
        src = tex.get("source", -1)
        if src != -1 and not 0 <= src < len(images):
            r.error(f"texture {ti}: source {src} out of range")

    # ---- skins
    for si, skin in enumerate(skins):
        for j in skin.get("joints", []):
            if not 0 <= j < len(nodes):
                r.error(f"skin {si}: joint {j} out of range")
        if "inverseBindMatrices" in skin and not 0 <= skin["inverseBindMatrices"] < len(accessors):
            r.error(f"skin {si}: inverseBindMatrices accessor out of range")

    return r
