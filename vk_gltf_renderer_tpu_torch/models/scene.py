"""Scene: Model-primary glTF scene with derived flat render arrays.

TPU-native rebuild of the reference's nvvkgltf::Scene (src/gltf_scene.hpp:210-717,
gltf_scene.cpp). The authoritative state is the ``GltfModel`` (JSON dict +
buffers). ``parse_scene()`` derives the flat arrays the device consumes:

  * ``render_primitives``: unique (mesh, primitive) pairs, deduplicated in
    deterministic mesh order (reference ``buildPrimitiveKeyMap``
    gltf_scene.cpp:2139 — array index == renderPrimID is the BVH/BLAS
    contract, RENDERING_ARCHITECTURE.md:45-63).
  * ``render_nodes``: one per (node, primitive) instance, with world matrix,
    materialID, renderPrimID, skinID, visibility (reference ``RenderNode``
    gltf_scene.hpp:50-58).
  * cameras / punctual lights (KHR_lights_punctual).

World-matrix propagation supports the reference's three strategies
(gltf_scene.cpp:1606/1681/1780/1867): serial DFS, and level-order
(topological BFS levels) which is the shape the jitted device path uses.

Dirty flags diff edits against the previous parse so device-buffer sync can
be surgical (reference DirtyFlags gltf_scene.hpp:485-513,
kFullUpdateRatio=0.3 :47).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from ..utils import mathutil as mu
from . import accessors as acc
from .gltf import GltfModel, load_model, save_model

# Ratio of dirty elements over which a full re-upload beats surgical updates
# (reference kFullUpdateRatio, gltf_scene.hpp:47).
FULL_UPDATE_RATIO = 0.3


class DirtyFlags(enum.IntFlag):
    """What changed since the last clear (reference gltf_scene.hpp:485-513)."""

    NONE = 0
    NODE_TRANSFORMS = enum.auto()  # some node local TRS changed -> world matrices
    RENDER_NODES = enum.auto()  # render-node list/world matrices need re-upload
    MATERIALS = enum.auto()
    LIGHTS = enum.auto()
    TANGENTS = enum.auto()
    PRIMITIVES_CHANGED = enum.auto()  # geometry added/removed -> rebuild BVH
    VISIBILITY = enum.auto()
    VERTICES = enum.auto()  # vertex data changed in place (skin/morph)
    ALL = (
        NODE_TRANSFORMS | RENDER_NODES | MATERIALS | LIGHTS | TANGENTS | PRIMITIVES_CHANGED | VISIBILITY | VERTICES
    )


@dataclass
class RenderPrimitive:
    """A unique (mesh, primitive) pair. Array index == renderPrimID (BVH contract)."""

    mesh_id: int
    prim_index: int  # index within mesh["primitives"]
    vertex_count: int = 0
    index_count: int = 0

    def primitive(self, model: GltfModel) -> dict:
        return model.meshes[self.mesh_id]["primitives"][self.prim_index]


@dataclass
class RenderNode:
    """Instance of a RenderPrimitive (reference gltf_scene.hpp:50-58)."""

    world_matrix: np.ndarray
    material_id: int = 0
    render_prim_id: int = -1
    ref_node_id: int = -1
    skin_id: int = -1
    visible: bool = True
    instance_count: int = 1  # >1 for EXT_mesh_gpu_instancing expansion


@dataclass
class RenderCamera:
    type: str = "perspective"  # or "orthographic"
    eye: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float64))
    center: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float64))
    up: np.ndarray = field(default_factory=lambda: np.array([0.0, 1.0, 0.0]))
    yfov: float = 0.8
    xmag: float = 1.0
    ymag: float = 1.0
    znear: float = 0.01
    zfar: float = 1000.0


@dataclass
class RenderLight:
    """KHR_lights_punctual instance (reference RenderLight gltf_scene.hpp:108-113)."""

    world_matrix: np.ndarray
    light: int = 0  # index into model.gltf extensions lights array
    node_id: int = -1


class RenderNodeRegistry:
    """Bidirectional (nodeID, primIndex) <-> renderNodeID lookups
    (reference RenderNodeRegistry gltf_scene.hpp:117-156). Rebuilt on every
    parse; O(1) dict lookups."""

    def __init__(self):
        self._fwd: dict[tuple, int] = {}
        self._rev: list[tuple] = []
        self._by_node: dict[int, list] = {}

    def add(self, node_id: int, prim_index: int, render_node_id: int) -> None:
        self._fwd[(node_id, prim_index)] = render_node_id
        while len(self._rev) <= render_node_id:
            self._rev.append((-1, -1))
        self._rev[render_node_id] = (node_id, prim_index)
        self._by_node.setdefault(node_id, []).append(render_node_id)

    def get_render_node_id(self, node_id: int, prim_index: int) -> int:
        return self._fwd.get((node_id, prim_index), -1)

    def get_node_and_prim(self, render_node_id: int):
        if 0 <= render_node_id < len(self._rev):
            return self._rev[render_node_id]
        return None

    def render_nodes_for_node(self, node_id: int) -> list:
        return self._by_node.get(node_id, [])

    def render_nodes_for_subtree(self, node_id: int, get_children) -> list:
        out = list(self._by_node.get(node_id, []))
        for c in get_children(node_id):
            out.extend(self.render_nodes_for_subtree(c, get_children))
        return out

    def clear(self) -> None:
        self._fwd.clear()
        self._rev.clear()
        self._by_node.clear()


class Scene:
    """Load/parse/manage a glTF scene; owns the Model and derived arrays."""

    def __init__(self):
        self.model: GltfModel = GltfModel()
        self.render_primitives: list[RenderPrimitive] = []
        self.render_nodes: list[RenderNode] = []
        self.render_cameras: list[RenderCamera] = []
        self.render_lights: list[RenderLight] = []
        self.world_matrices: np.ndarray = np.zeros((0, 4, 4), np.float32)
        self.parents: np.ndarray = np.zeros(0, np.int32)  # -1 for roots
        self.topo_levels: list[np.ndarray] = []  # BFS levels of node indices
        self.node_visible: np.ndarray = np.zeros(0, bool)
        self._dirty = DirtyFlags.NONE
        self._dirty_nodes: set[int] = set()
        self._locals_cache = None  # per-node local matrices (levels path)
        self._dirty_materials: set[int] = set()
        self._prim_key_map: dict[tuple, int] = {}
        self.animations = []  # populated by models.animation.parse_animations
        self.current_animation = 0
        self.registry = RenderNodeRegistry()
        self.referenced_assets = []  # glTF 2.1 external assets (read-only subtrees)

    # ------------------------------------------------------------------ load
    def load(self, path) -> None:
        """Load file and parse (reference Scene::load gltf_scene.cpp:298)."""
        self.model = load_model(path)
        from .external_assets import resolve_external_assets

        resolve_external_assets(self)  # glTF 2.1 (gltf_scene.cpp:995)
        self.parse_scene()
        from .animation import parse_animations

        self.animations = parse_animations(self)

    def load_from_model(self, model: GltfModel) -> None:
        self.model = model
        self.parse_scene()
        from .animation import parse_animations

        self.animations = parse_animations(self)

    def save(self, path) -> None:
        save_model(self.model, path)

    # ----------------------------------------------------------------- parse
    def parse_scene(self) -> None:
        """Model -> flat derived arrays (reference parseScene gltf_scene.cpp:1350).

        Re-entrant: diffs against the previous render-node state and raises
        dirty flags (reference updateRenderNodesFull :1950). Never mutates
        the Model.
        """
        self._locals_cache = None  # node list/topology may change
        model = self.model
        prev_count = len(self.render_nodes)

        self._build_primitive_key_map()
        self._build_hierarchy()
        self.update_world_matrices_serial()

        render_nodes: list[RenderNode] = []
        cameras: list[RenderCamera] = []
        lights: list[RenderLight] = []
        for node_id, node in enumerate(model.nodes):
            if not self._node_in_scene[node_id]:
                continue
            world = self.world_matrices[node_id]
            visible = self._effective_visibility(node_id)
            if "mesh" in node:
                self._emit_render_nodes(node_id, node, world, visible, render_nodes)
            if "camera" in node:
                cameras.append(self._parse_camera(node, world))
            ext = node.get("extensions", {})
            if "KHR_lights_punctual" in ext:
                lights.append(RenderLight(world_matrix=world.copy(), light=ext["KHR_lights_punctual"]["light"], node_id=node_id))

        self.render_nodes = render_nodes
        self.render_cameras = cameras
        self.render_lights = lights
        self.registry.clear()
        for rid, rn in enumerate(render_nodes):
            if rn.ref_node_id >= 0:
                mesh = model.meshes[model.nodes[rn.ref_node_id]["mesh"]]
                # recover the prim index from renderPrimID
                rp = self.render_primitives[rn.render_prim_id]
                self.registry.add(rn.ref_node_id, rp.prim_index, rid)

        if prev_count != len(render_nodes):
            self._dirty |= DirtyFlags.RENDER_NODES | DirtyFlags.PRIMITIVES_CHANGED
        self._dirty |= DirtyFlags.RENDER_NODES

    def _build_primitive_key_map(self) -> None:
        """Deterministic mesh-order primitive dedup (gltf_scene.cpp:2139).

        Identical primitives (same attribute/index accessors) referenced from
        multiple meshes collapse to one RenderPrimitive; iteration is in mesh
        order so renderPrimID assignment is reproducible run-to-run — the BVH
        array-index contract depends on this.
        """
        model = self.model
        self._prim_key_map = {}
        self.render_primitives = []
        self._mesh_prim_to_rpid: dict[tuple, int] = {}
        for mesh_id, mesh in enumerate(model.meshes):
            for prim_index, prim in enumerate(mesh.get("primitives", [])):
                attrs = tuple(sorted(prim.get("attributes", {}).items()))
                key = (attrs, prim.get("indices", -1), prim.get("mode", 4))
                rpid = self._prim_key_map.get(key)
                if rpid is None:
                    rpid = len(self.render_primitives)
                    self._prim_key_map[key] = rpid
                    vc = 0
                    pos = prim.get("attributes", {}).get("POSITION")
                    if pos is not None:
                        vc = model.accessors[pos]["count"]
                    ic = model.accessors[prim["indices"]]["count"] if "indices" in prim else vc
                    self.render_primitives.append(
                        RenderPrimitive(mesh_id=mesh_id, prim_index=prim_index, vertex_count=vc, index_count=ic)
                    )
                self._mesh_prim_to_rpid[(mesh_id, prim_index)] = rpid

    def _build_hierarchy(self) -> None:
        model = self.model
        n = len(model.nodes)
        parents = np.full(n, -1, np.int32)
        in_scene = np.zeros(n, bool)
        roots = self.model.scene_roots()
        stack = list(roots)
        for r in roots:
            in_scene[r] = True
        while stack:
            ni = stack.pop()
            for c in model.nodes[ni].get("children", []):
                parents[c] = ni
                in_scene[c] = True
                stack.append(c)
        self.parents = parents
        self._node_in_scene = in_scene
        # Topological BFS levels (reference buildTopologicalLevels
        # gltf_scene.cpp:1867): level[i] depends only on level[i-1] — the
        # exact shape a per-level jitted propagation kernel wants.
        depth = np.full(n, -1, np.int32)
        frontier = [r for r in roots]
        levels = []
        d = 0
        while frontier:
            arr = np.asarray(sorted(frontier), np.int32)
            levels.append(arr)
            depth[arr] = d
            nxt = []
            for ni in frontier:
                nxt.extend(model.nodes[ni].get("children", []))
            frontier = nxt
            d += 1
        self.topo_levels = levels

    def _effective_visibility(self, node_id: int) -> bool:
        """KHR_node_visibility is inherited down the hierarchy."""
        ni = node_id
        while ni != -1:
            ext = self.model.nodes[ni].get("extensions", {})
            vis = ext.get("KHR_node_visibility", {}).get("visible", True)
            if not vis:
                return False
            ni = int(self.parents[ni])
        return True

    def _emit_render_nodes(self, node_id, node, world, visible, out: list) -> None:
        model = self.model
        mesh_id = node["mesh"]
        mesh = model.meshes[mesh_id]
        skin_id = node.get("skin", -1)
        ext = node.get("extensions", {})
        gpu_inst = ext.get("EXT_mesh_gpu_instancing")
        for prim_index, prim in enumerate(mesh.get("primitives", [])):
            if prim.get("mode", 4) != 4:  # triangles only, like the reference render path
                continue
            rpid = self._mesh_prim_to_rpid[(mesh_id, prim_index)]
            mat_id = prim.get("material", -1)
            if gpu_inst:
                # EXT_mesh_gpu_instancing (reference handleGpuInstancing
                # gltf_scene.cpp:2388): expand instances into render nodes.
                for inst_world in self._gpu_instance_matrices(gpu_inst, world):
                    out.append(
                        RenderNode(
                            world_matrix=inst_world,
                            material_id=mat_id,
                            render_prim_id=rpid,
                            ref_node_id=node_id,
                            skin_id=skin_id,
                            visible=visible,
                        )
                    )
            else:
                out.append(
                    RenderNode(
                        world_matrix=world.copy(),
                        material_id=mat_id,
                        render_prim_id=rpid,
                        ref_node_id=node_id,
                        skin_id=skin_id,
                        visible=visible,
                    )
                )

    def _gpu_instance_matrices(self, gpu_inst: dict, world: np.ndarray):
        attrs = gpu_inst.get("attributes", {})
        t = acc.read_accessor(self.model, attrs["TRANSLATION"]) if "TRANSLATION" in attrs else None
        r = acc.read_accessor(self.model, attrs["ROTATION"]) if "ROTATION" in attrs else None
        s = acc.read_accessor(self.model, attrs["SCALE"]) if "SCALE" in attrs else None
        n = max(x.shape[0] for x in (t, r, s) if x is not None)
        for i in range(n):
            local = mu.trs_matrix(
                t[i] if t is not None else None,
                r[i] if r is not None else None,
                s[i] if s is not None else None,
            )
            yield (world @ local).astype(np.float32)

    def _parse_camera(self, node: dict, world: np.ndarray) -> RenderCamera:
        cam = self.model.cameras[node["camera"]]
        rc = RenderCamera()
        eye = world[:3, 3].astype(np.float64)
        fwd = -world[:3, 2].astype(np.float64)  # camera looks down -Z
        up = world[:3, 1].astype(np.float64)
        rc.eye = eye
        rc.center = eye + fwd
        rc.up = up
        rc.type = cam.get("type", "perspective")
        if rc.type == "perspective":
            p = cam.get("perspective", {})
            rc.yfov = p.get("yfov", 0.8)
            rc.znear = p.get("znear", 0.01)
            rc.zfar = p.get("zfar", rc.znear * 1e5)
        else:
            o = cam.get("orthographic", {})
            rc.xmag, rc.ymag = o.get("xmag", 1.0), o.get("ymag", 1.0)
            rc.znear, rc.zfar = o.get("znear", 0.01), o.get("zfar", 1000.0)
        return rc

    # -------------------------------------------------------- world matrices
    def update_world_matrices_serial(self) -> None:
        """DFS propagation (reference updateWorldMatricesSerial gltf_scene.cpp:1681)."""
        model = self.model
        n = len(model.nodes)
        self.world_matrices = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
        for ni in self.model.scene_roots():
            self._propagate(ni, np.eye(4, dtype=np.float32))

    def _propagate(self, node_id: int, parent_world: np.ndarray) -> None:
        node = self.model.nodes[node_id]
        world = parent_world @ mu.node_local_matrix(node)
        self.world_matrices[node_id] = world
        for c in node.get("children", []):
            self._propagate(c, world)

    def update_world_matrices_levels(self) -> None:
        """Level-order propagation (reference updateWorldMatricesParallel
        gltf_scene.cpp:1780 + world_matrix_propagate.comp.slang:19-32).

        Batched per BFS level: world[level] = world[parent[level]] @ local[level].
        Same numerical result as the serial path; this is the algorithm the
        jitted device propagation (ops/transforms.py) mirrors.

        Local matrices are CACHED and only the dirty nodes' entries are
        re-decoded per call (the reference's TransformComputeVk patches only
        dirty locals, gltf_scene_transform_vk.hpp:15-64) — per-frame host
        cost is O(dirty) decode + O(n) vectorized matmuls, never an O(n)
        Python loop.
        """
        model = self.model
        n = len(model.nodes)
        if self._locals_cache is None or self._locals_cache.shape[0] != n:
            self._locals_cache = (
                np.stack([mu.node_local_matrix(model.nodes[i]) for i in range(n)])
                if n else np.zeros((0, 4, 4), np.float32)
            )
        else:
            for i in self._dirty_nodes:
                if 0 <= i < n:
                    self._locals_cache[i] = mu.node_local_matrix(model.nodes[i])
        locals_ = self._locals_cache
        world = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
        for level in self.topo_levels:
            par = self.parents[level]
            parent_world = np.where((par >= 0)[:, None, None], world[np.maximum(par, 0)], np.eye(4, dtype=np.float32))
            world[level] = np.einsum("nij,njk->nik", parent_world, locals_[level])
        self.world_matrices = world

    def refresh_render_node_matrices(self) -> None:
        """Push updated node world matrices into render nodes (surgical path).

        GPU-instanced nodes are re-expanded from their instance attributes.
        """
        i = 0
        out = []
        for rn in self.render_nodes:
            ni = rn.ref_node_id
            if ni >= 0 and rn.instance_count == 1:
                node = self.model.nodes[ni]
                if "EXT_mesh_gpu_instancing" not in node.get("extensions", {}):
                    rn.world_matrix = self.world_matrices[ni].copy()
            out.append(rn)
            i += 1
        self.render_nodes = out
        self._dirty |= DirtyFlags.RENDER_NODES

    # ----------------------------------------------------------- dirty flags
    def get_dirty_flags(self) -> DirtyFlags:
        return self._dirty

    def clear_dirty_flags(self) -> None:
        self._dirty = DirtyFlags.NONE
        self._dirty_nodes.clear()
        self._dirty_materials.clear()

    def mark_dirty(self, flags: DirtyFlags, *, nodes=(), materials=()) -> None:
        self._dirty |= flags
        self._dirty_nodes.update(nodes)
        self._dirty_materials.update(materials)

    @property
    def dirty_nodes(self) -> set:
        return self._dirty_nodes

    @property
    def dirty_materials(self) -> set:
        return self._dirty_materials

    # ---------------------------------------------------------------- bounds
    def scene_bounds(self) -> tuple[np.ndarray, np.ndarray]:
        """World-space AABB over visible render nodes (for camera fitting)."""
        lo = np.full(3, np.inf)
        hi = np.full(3, -np.inf)
        for rn in self.render_nodes:
            prim = self.render_primitives[rn.render_prim_id].primitive(self.model)
            pos_acc_idx = prim.get("attributes", {}).get("POSITION")
            if pos_acc_idx is None:
                continue
            a = self.model.accessors[pos_acc_idx]
            pmin = np.asarray(a.get("min", [-1, -1, -1]), np.float64)
            pmax = np.asarray(a.get("max", [1, 1, 1]), np.float64)
            corners = np.array([[pmin[i] if (k >> i) & 1 == 0 else pmax[i] for i in range(3)] for k in range(8)])
            wc = mu.transform_points(rn.world_matrix.astype(np.float64), corners)
            lo = np.minimum(lo, wc.min(axis=0))
            hi = np.maximum(hi, wc.max(axis=0))
        if not np.isfinite(lo).all():
            lo, hi = -np.ones(3), np.ones(3)
        return lo, hi
