"""SceneEditor: all Model mutations (reference gltf_scene_editor.{hpp,cpp}).

Every edit mutates the glTF dict (Model-primary), raises the matching dirty
flags, and leaves derived arrays to the next parse/sync. Covers: node TRS,
add/delete/duplicate/reparent nodes, procedural primitives (plane/cube/
sphere, gltf_scene_editor.hpp:54-84), punctual lights (:88-99), material
assignment, visibility (KHR_node_visibility), and exhaustive index
remapping after node deletion (remapIndicesAfterNodeDeletion;
RENDERING_ARCHITECTURE.md:406-443).
"""

from __future__ import annotations

import numpy as np

from . import accessors as acc
from .scene import DirtyFlags, Scene


class SceneEditor:
    def __init__(self, scene: Scene):
        self.scene = scene

    @property
    def model(self):
        return self.scene.model

    # ------------------------------------------------------------ transforms
    def set_translation(self, node_id: int, t) -> None:
        self._set_trs(node_id, "translation", [float(x) for x in t])

    def set_rotation(self, node_id: int, q) -> None:
        self._set_trs(node_id, "rotation", [float(x) for x in q])

    def set_scale(self, node_id: int, s) -> None:
        self._set_trs(node_id, "scale", [float(x) for x in s])

    def _set_trs(self, node_id: int, key: str, value) -> None:
        node = self.model.nodes[node_id]
        if "matrix" in node:
            # convert matrix to TRS first (editable form)
            from ..utils.mathutil import matrix_to_trs, node_local_matrix

            t, q, s = matrix_to_trs(node_local_matrix(node))
            node.pop("matrix")
            node["translation"] = [float(x) for x in t]
            node["rotation"] = [float(x) for x in q]
            node["scale"] = [float(x) for x in s]
        node[key] = value
        self.scene.mark_dirty(DirtyFlags.NODE_TRANSFORMS | DirtyFlags.RENDER_NODES, nodes=[node_id])

    def set_visibility(self, node_id: int, visible: bool) -> None:
        node = self.model.nodes[node_id]
        ext = node.setdefault("extensions", {})
        ext.setdefault("KHR_node_visibility", {})["visible"] = bool(visible)
        self._use_extension("KHR_node_visibility")
        self.scene.mark_dirty(DirtyFlags.VISIBILITY | DirtyFlags.RENDER_NODES, nodes=[node_id])

    def set_material(self, node_id: int, prim_index: int, material_id: int) -> None:
        node = self.model.nodes[node_id]
        prim = self.model.meshes[node["mesh"]]["primitives"][prim_index]
        prim["material"] = material_id
        self.scene.mark_dirty(DirtyFlags.RENDER_NODES | DirtyFlags.MATERIALS)

    # ---------------------------------------------------------- node lifecycle
    def add_node(self, *, parent: int | None = None, name: str = "", **props) -> int:
        node = dict(props)
        if name:
            node["name"] = name
        self.model.nodes.append(node)
        node_id = len(self.model.nodes) - 1
        self._attach(node_id, parent)
        self.scene.mark_dirty(DirtyFlags.RENDER_NODES | DirtyFlags.PRIMITIVES_CHANGED)
        return node_id

    def _attach(self, node_id: int, parent: int | None) -> None:
        if parent is None:
            scenes = self.model.gltf.setdefault("scenes", [{"nodes": []}])
            if not scenes:
                scenes.append({"nodes": []})
            scenes[self.model.default_scene].setdefault("nodes", []).append(node_id)
        else:
            self.model.nodes[parent].setdefault("children", []).append(node_id)

    def duplicate_node(self, node_id: int, *, recursive: bool = True) -> int:
        """Duplicate a node (+subtree); shares mesh/material references
        (reference duplicateNode)."""
        import copy

        def dup(nid):
            node = copy.deepcopy(self.model.nodes[nid])
            children = node.pop("children", [])
            self.model.nodes.append(node)
            new_id = len(self.model.nodes) - 1
            if recursive:
                node["children"] = [dup(c) for c in children]
                if not node["children"]:
                    node.pop("children")
            return new_id

        new_id = dup(node_id)
        parent = int(self.scene.parents[node_id]) if node_id < len(self.scene.parents) else -1
        self._attach(new_id, parent if parent >= 0 else None)
        self.scene.mark_dirty(DirtyFlags.RENDER_NODES | DirtyFlags.PRIMITIVES_CHANGED)
        return new_id

    def reparent_node(self, node_id: int, new_parent: int | None) -> None:
        """Move node under new_parent, preserving WORLD transform
        (reference hierarchy commands + test_node_hierarchy_operations)."""
        self.scene.parse_scene()  # ensure world matrices current
        world = self.scene.world_matrices[node_id].astype(np.float64)
        self._detach(node_id)
        if new_parent is not None:
            parent_world = self.scene.world_matrices[new_parent].astype(np.float64)
            local = np.linalg.inv(parent_world) @ world
        else:
            local = world
        from ..utils.mathutil import matrix_to_trs

        t, q, s = matrix_to_trs(local)
        node = self.model.nodes[node_id]
        node.pop("matrix", None)
        node["translation"] = [float(x) for x in t]
        node["rotation"] = [float(x) for x in q]
        node["scale"] = [float(x) for x in s]
        self._attach(node_id, new_parent)
        self.scene.mark_dirty(DirtyFlags.RENDER_NODES | DirtyFlags.NODE_TRANSFORMS)

    def _detach(self, node_id: int) -> None:
        for sc in self.model.gltf.get("scenes", []):
            if node_id in sc.get("nodes", []):
                sc["nodes"].remove(node_id)
        for n in self.model.nodes:
            if node_id in n.get("children", []):
                n["children"].remove(node_id)

    def delete_node(self, node_id: int, *, recursive: bool = True) -> None:
        """Delete node (+subtree) and remap EVERY node index in the Model
        (reference deleteNode + remapIndicesAfterNodeDeletion — the most
        index-sensitive operation; test_index_remapping_basic.cpp)."""
        doomed = set()

        def collect(nid):
            doomed.add(nid)
            if recursive:
                for c in self.model.nodes[nid].get("children", []):
                    collect(c)

        collect(node_id)
        # children of non-recursively-deleted nodes move to the scene roots
        if not recursive:
            for c in self.model.nodes[node_id].get("children", []):
                self._detach(c)
                self._attach(c, None)

        keep = [i for i in range(len(self.model.nodes)) if i not in doomed]
        remap = {old: new for new, old in enumerate(keep)}
        new_nodes = []
        for old in keep:
            node = self.model.nodes[old]
            if "children" in node:
                node["children"] = [remap[c] for c in node["children"] if c in remap]
                if not node["children"]:
                    node.pop("children")
            new_nodes.append(node)
        self.model.gltf["nodes"] = new_nodes

        for sc in self.model.gltf.get("scenes", []):
            sc["nodes"] = [remap[n] for n in sc.get("nodes", []) if n in remap]
        # skins reference nodes (joints + skeleton)
        for skin in self.model.gltf.get("skins", []):
            skin["joints"] = [remap[j] for j in skin.get("joints", []) if j in remap]
            if "skeleton" in skin:
                skin["skeleton"] = remap.get(skin["skeleton"], 0)
        # animation channel targets
        for anim in self.model.gltf.get("animations", []):
            kept_channels = []
            for ch in anim.get("channels", []):
                tgt = ch.get("target", {})
                if "node" in tgt:
                    if tgt["node"] in remap:
                        tgt["node"] = remap[tgt["node"]]
                        kept_channels.append(ch)
                else:
                    kept_channels.append(ch)
            anim["channels"] = kept_channels
        self.scene.mark_dirty(DirtyFlags.RENDER_NODES | DirtyFlags.PRIMITIVES_CHANGED)

    # ------------------------------------------------------------ primitives
    def recompute_tangents(self, mesh_id: int, prim_id: int = 0) -> int:
        """MikkTSpace-contract tangent recompute with vertex splitting
        (reference recomputeTangents action, gltf_create_tangent.cpp).
        Returns the number of split vertices; marks TANGENTS +
        PRIMITIVES_CHANGED dirty (vertex count may change)."""
        from .geometry import recompute_tangents_mikk

        n = recompute_tangents_mikk(self.scene.model, mesh_id, prim_id)
        self.scene.mark_dirty(DirtyFlags.TANGENTS | DirtyFlags.PRIMITIVES_CHANGED)
        return n

    def add_primitive(self, kind: str, *, name: str | None = None, material: int | None = None, parent=None, segments: int = 32) -> int:
        """Add a procedural plane/cube/sphere node
        (reference gltf_scene_editor.hpp:54-84)."""
        if material is None:
            self.model.materials.append({"pbrMetallicRoughness": {"baseColorFactor": [0.8, 0.8, 0.8, 1.0]}})
            material = len(self.model.materials) - 1
        pos, nrm, uv, idx = _make_primitive(kind, segments)
        pa = acc.append_accessor(self.model, pos, "VEC3", target=34962)
        na = acc.append_accessor(self.model, nrm, "VEC3", target=34962)
        ua = acc.append_accessor(self.model, uv, "VEC2", target=34962)
        ia = acc.append_accessor(self.model, idx.astype(np.uint32).reshape(-1), "SCALAR", target=34963)
        self.model.meshes.append(
            {
                "name": name or kind,
                "primitives": [
                    {"attributes": {"POSITION": pa, "NORMAL": na, "TEXCOORD_0": ua}, "indices": ia, "material": material}
                ],
            }
        )
        return self.add_node(parent=parent, name=name or kind, mesh=len(self.model.meshes) - 1)

    def add_light(self, light_type: str = "point", *, color=(1, 1, 1), intensity=100.0, parent=None, **kw) -> int:
        """Add a KHR_lights_punctual light node (gltf_scene_editor.hpp:88-99)."""
        ext = self.model.gltf.setdefault("extensions", {}).setdefault("KHR_lights_punctual", {})
        lights = ext.setdefault("lights", [])
        light = {"type": light_type, "color": list(color), "intensity": float(intensity)}
        if light_type == "spot":
            light["spot"] = {
                "innerConeAngle": kw.get("inner_cone", 0.2),
                "outerConeAngle": kw.get("outer_cone", 0.6),
            }
        if "range" in kw:
            light["range"] = kw["range"]
        lights.append(light)
        self._use_extension("KHR_lights_punctual")
        node_id = self.add_node(parent=parent, name=f"{light_type}-light")
        self.model.nodes[node_id]["extensions"] = {"KHR_lights_punctual": {"light": len(lights) - 1}}
        if "translation" in kw:
            self.model.nodes[node_id]["translation"] = list(kw["translation"])
        self.scene.mark_dirty(DirtyFlags.LIGHTS)
        return node_id

    def _use_extension(self, name: str) -> None:
        used = self.model.gltf.setdefault("extensionsUsed", [])
        if name not in used:
            used.append(name)


def _make_primitive(kind: str, segments: int = 32):
    """Procedural geometry: plane / cube / sphere (CCW, +Y up)."""
    if kind == "plane":
        pos = np.array([[-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1]], np.float32)
        nrm = np.tile(np.array([[0, 1, 0]], np.float32), (4, 1))
        uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
        idx = np.array([[0, 2, 1], [0, 3, 2]], np.uint32)
        return pos, nrm, uv, idx
    if kind == "cube":
        faces = []
        for axis in range(3):
            for sgn in (1.0, -1.0):
                n = np.zeros(3, np.float32)
                n[axis] = sgn
                u = np.zeros(3, np.float32)
                u[(axis + 1) % 3] = 1.0
                v = np.cross(n, u)
                c = n  # face center
                quad = [c - u - v, c + u - v, c + u + v, c - u + v]
                faces.append((np.stack(quad), n))
        pos = np.concatenate([f[0] for f in faces]).astype(np.float32)
        nrm = np.concatenate([np.tile(f[1], (4, 1)) for f in faces]).astype(np.float32)
        uv = np.tile(np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32), (6, 1))
        idx = []
        for f in range(6):
            b = f * 4
            idx += [[b, b + 1, b + 2], [b, b + 2, b + 3]]
        return pos, nrm, uv, np.array(idx, np.uint32)
    if kind == "sphere":
        lat, lon = segments, segments * 2
        theta = np.linspace(0, np.pi, lat + 1)
        phi = np.linspace(0, 2 * np.pi, lon + 1)
        tt, pp = np.meshgrid(theta, phi, indexing="ij")
        x = np.sin(tt) * np.cos(pp)
        y = np.cos(tt)
        z = np.sin(tt) * np.sin(pp)
        pos = np.stack([x, y, z], axis=-1).reshape(-1, 3).astype(np.float32)
        nrm = pos.copy()
        uv = np.stack([pp / (2 * np.pi), tt / np.pi], axis=-1).reshape(-1, 2).astype(np.float32)
        idx = []
        for i in range(lat):
            for j in range(lon):
                a = i * (lon + 1) + j
                b = a + lon + 1
                idx += [[a, b, a + 1], [a + 1, b, b + 1]]
        return pos, nrm, uv, np.array(idx, np.uint32)
    raise ValueError(f"unknown primitive kind {kind!r}")
