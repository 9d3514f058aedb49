"""GltfRenderer: the frame-loop orchestrator of the port (reference
vk_gltf_renderer_tpu/renderer.py).

Owns the host Scene (the port's copy of the reference's models package),
the numpy scene/BVH builders' output, their device mirrors, the environment (sky or
HDR), the camera and the progressive accumulation buffer, which lives on
the renderer's device. Each on_render() path-traces one frame of spp
samples and folds it into the running mean.

Traversals are picked as in the reference: at every frame _config reads
VKGR_TRAVERSAL (packet, packet4 or wavefront; default packet on the card
and on the CPU), VKGR_PRIMARY_KERNEL (default v3) and VKGR_PACKET_KERNEL
(default v9; both read under packet only), and on_render builds and
uploads any table the selection reads that the scene does not have yet
(binary rows for v2, BVH16 rows for v6, lane pages for lane/lane_stream,
the int32 sidecar for v7, the v5 walk's stack need for v5, the split
BVH4 tables for packet4, the binary tree's own boxes and meta rows for
wavefront). A kernel or walk runs only because the selection names it.

A scene with a MASK or BLEND material is built with the conservative
opacity classes of ops/omm.py (_alpha_classes): transparent triangles are
culled from the BVH, MIXED triangles with transparent cells are split into
their other cells (VKGR_OMM_SUBTRI=0 keeps whole triangles), and the path
tracer re-traces past rejected hits. use_infinite_plane, plane_height and
plane_shadow_catcher (with shadow_catcher_darken) add the reference's
infinite plane and its shadow catcher.

Scene edits go through sync_scene_changes, driven by the Scene's dirty
flags as in the reference: a topology or visibility change rebuilds; a
node, render-node or vertex change (an animation step, a material-variant
switch) refits on the device (_refit_device: skin and morph, the world
triangles, every table family's boxes and the hit rows, with no host
readback); a material or light change re-packs the material tables, and
rebuilds when the opacity classes moved (a MASK material made OPAQUE
un-culls its triangles). With animate on, on_render advances the current
clip by anim_speed / 60 s a frame first.

What a viewer shows of a frame: with denoise_guides on, each frame keeps the
full guide set and the per-sample luminance moments, and the renderer
snapshots the per-node transforms for the next frame's instance motion;
image_denoised() runs the à-trous denoiser (ops/denoise.py) and, with
temporal, reprojects it against the last denoised frame (ops/temporal.py).
With upscale > 1 the frames render at the given size with the Halton TAA
jitter and each one folds into a display-resolution TAAU history
(ops/upscale.py, image_upscaled()). selection outlines the selected render
nodes (image_with_silhouette()); pick() traces one ray through the
traversal selection. render_system 1 renders preview frames (ops/preview.py
with the IBL of ops/ibl.py, built once per environment), which replace the
accumulation rather than adding to it; wireframe overlays triangle edges on
them.

VKGR_PRIMARY_SEED=1 seeds each frame's primary trace with the last
frame's per-pixel first hits (left off for alpha scenes; the seeds are
re-verified in the frame, so edits need no invalidation) and
VKGR_SPP_BATCH=1 renders spp > 1 as one batch of W*H*spp lanes
(ops/pathtrace.py). VKGR_BVH=sbvh builds the spatial-split BVH
(ops/bvh_flatten.py).

With adaptive set to an AdaptiveSampler, each on_render waits for the
card, reads the frame's time on the host clock and retargets spp for the
next frame. The
TPU fallback ladder (VMEM kernel rungs, VKGR_LANE_STREAM, cache rotation)
has no role here,
and the reference's downgrade to the wavefront after kernel faults
(_traversal_fallback) is deliberately not ported: it would hide a faulty
kernel behind another traversal.
"""

from __future__ import annotations

import dataclasses
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from .convert import (add_kernel_tables_to_device, bvh_to_device, refit_device_bvh,
                      refit_tables_to_device, scene_to_device)
from .device import resolve_device, synchronize
from .models import DirtyFlags, Scene
from .models.animation import compute_joint_matrices, update_animation
from .models.materials import detect_scene_features
from .models.variants import apply_variant, parse_variants
from .ops.animation import bake_world_tris, morph_vertices, skin_vertices
from .ops.bvh_flatten import add_kernel_tables, build_world_bvh
from .ops.camera import pixel_angle
from .ops.denoise import denoise_renderer
from .ops.flat import build_scene_flat, refresh_materials
from .ops.hdr import load_hdr_environment
from .ops.hitstate import bake_hit_attrs
from .ops.ibl import build_ibl
from .ops.omm import classify_attr_alpha, classify_subtri
from .ops.pathtrace import RenderConfig, render_frame_flat
from .ops.postfx import pick_ray, silhouette
from .ops.preview import render_preview
from .ops.sky import SkyEnv, SkyParams
from .ops.temporal import motion_vectors, temporal_accumulate
from .ops.tonemap import tonemap
from .ops.upscale import halton23, temporal_upscale
from .utils import mathutil as mu
from .utils.image_io import write_image


@dataclass
class CameraState:
    eye: np.ndarray
    center: np.ndarray
    up: np.ndarray
    yfov: float = np.radians(45.0)
    znear: float = 0.01
    zfar: float = 1000.0
    orthographic: bool = False
    xmag: float = 1.0
    ymag: float = 1.0


def _moved(a, b) -> bool:
    """Whether two opacity-class arrays (or None) differ."""
    if a is None or b is None:
        return (a is None) != (b is None)
    return a.shape != b.shape or bool((a != b).any())


class AdaptiveSampler:
    """spp feedback controller (reference renderer_pathtracer.hpp:159-194,
    .cpp:1326-1374): retargets samples-per-frame from the measured frame
    time toward a budget (60/30/15/10 FPS presets).

    The retarget quantizes to power-of-two buckets (1..64), as in the
    reference, where each distinct spp is a compile; here it keeps the
    accumulation cadence steady, and 25% hysteresis keeps the controller
    from oscillating between two buckets."""

    BUDGETS_MS = {60: 16.67, 30: 33.33, 15: 66.67, 10: 100.0}
    BUCKETS = (1, 2, 4, 8, 16, 32, 64)

    def __init__(self, target_fps: int = 30):
        self.budget_ms = self.BUDGETS_MS.get(target_fps, 33.33)
        self.spp = 1
        self._ema_ms = None

    def update(self, frame_ms: float) -> int:
        if frame_ms <= 0:
            return self.spp
        per_sample = frame_ms / max(self.spp, 1)
        self._ema_ms = per_sample if self._ema_ms is None else 0.8 * self._ema_ms + 0.2 * per_sample
        ideal = self.budget_ms / max(self._ema_ms, 1e-3)
        # largest bucket that fits the budget
        target = 1
        for b in self.BUCKETS:
            if b <= ideal:
                target = b
        # hysteresis: move up only with 25% headroom beyond the bucket edge,
        # move down only when over budget by 25%
        if target > self.spp and ideal < target * 1.25:
            target = self.spp
        if target < self.spp and ideal > self.spp * 0.8:
            target = self.spp
        self.spp = target
        return self.spp

    def update_global(self, rays: float, wall_ms: float) -> int:
        """Retarget from a ray count summed over every card and a wall time
        all processes agree on, so that every process lands on the same
        bucket; the per-sample math is the single-card controller's
        (wall_ms / spp), so this delegates. No rays: no change."""
        if rays <= 0:
            return self.spp
        return self.update(wall_ms)


def fit_camera(scene: Scene, yfov=np.radians(45.0)) -> CameraState:
    """Frame the scene bounds (the camera fit the reference runs on load)."""
    lo, hi = scene.scene_bounds()
    center = (lo + hi) / 2.0
    radius = float(np.linalg.norm(hi - lo)) * 0.5 + 1e-6
    dist = radius / np.tan(yfov * 0.5) * 1.2
    eye = center + np.array([0.4, 0.35, 0.85]) / np.linalg.norm([0.4, 0.35, 0.85]) * dist
    return CameraState(
        eye=eye, center=center, up=np.array([0.0, 1.0, 0.0]), yfov=yfov,
        znear=radius * 0.01, zfar=radius * 100.0,
    )


class GltfRenderer:
    def __init__(self, width=512, height=512, spp=1, max_depth=5, *, device="cuda",
                 env_kind="sky", tonemapper="filmic", render_system=0):
        self.device = resolve_device(device)
        self.render_system = render_system  # 0 = path tracer, 1 = preview
        self.width = width
        self.height = height
        self.spp = spp
        self.max_depth = max_depth
        self.env_kind = env_kind
        self.tonemapper = tonemapper
        self.scene = Scene()
        self.flat = None  # host SceneFlat (numpy)
        self.bvh = None  # host WorldBvh (numpy)
        self.dev_scene = None  # convert.DeviceScene
        self.dev_bvh = None  # convert.DeviceBvh
        self._table_families = set()  # the kernel table families dev_bvh was given (_sync_kernel_tables)
        self.sky_params = SkyParams()
        self.hdr = None  # ops.hdr.HdrEnv
        self.camera: CameraState | None = None
        self.frame_idx = 0
        self.total_samples = 0
        self.accum = None
        self._last_aux = None
        self.firefly_clamp = 10.0
        self.exposure = 1.0
        self.env_intensity = 1.0
        self.env_rotation = 0.0
        self.aperture = 0.0
        self.focal_distance = 0.0
        self.background = None  # (r,g,b) solid backplate or None
        self.use_infinite_plane = False
        self.plane_height = 0.0
        self.plane_shadow_catcher = False
        self.shadow_catcher_darken = 0.0
        self.animate = False
        self.anim_speed = 1.0  # playback rate multiplier
        self._anim_tables_cache = None
        self._alpha_cls = self._subtri_cells = None  # the opacity classes the BVH was built with
        self.denoise_guides = False  # the full denoiser guide set (turn on before rendering)
        self.upscale = 1  # > 1: TAAU-reconstruct upscale x the render size
        self.selection = set()  # selected render-node ids (silhouette)
        self.wireframe = False  # preview edge overlay
        self._prev_rn_o2w = None  # the last frame's per-node o2w [R,16] (instance motion)
        self._prev_first = None  # the last frame's per-pixel (first_rnode, first_tri) (primary_seed)
        self._prev_vp = None  # the last view-projection that image_denoised or _taau_step used
        self._history = None  # the last image_denoised output (temporal reprojection)
        self._history_hi = None  # display-res TAAU history [H*up, W*up, 4]
        self._moments = None  # accumulated per-sample luminance moments [W*H,2]
        self._ibl = self._ibl_key = None  # the preview's IBL products and their environment
        self.adaptive: AdaptiveSampler | None = None  # set to retarget spp from each frame's time
        # device -> (DeviceScene, DeviceBvh, HdrEnv | None) copies that parallel/ renders on; dropped
        # whenever the tables they copy change (drop_replicas)
        self.replicas = {}

    # -------------------------------------------------------------- scene
    def create_scene(self, path) -> None:
        """Load a glTF file and build the device mirrors."""
        self.scene.load(path)
        if self.camera is None:
            if self.scene.render_cameras:
                rc = self.scene.render_cameras[0]
                self.camera = CameraState(
                    eye=np.asarray(rc.eye), center=np.asarray(rc.center), up=np.asarray(rc.up),
                    yfov=rc.yfov or np.radians(45.0), znear=rc.znear or 0.01, zfar=rc.zfar or 1000.0,
                    orthographic=rc.type == "orthographic", xmag=rc.xmag, ymag=rc.ymag,
                )
            else:
                self.camera = fit_camera(self.scene)
        self.rebuild_device_scene()

    def variants(self) -> list:
        """KHR_materials_variants names."""
        return parse_variants(self.scene.model)

    def set_variant(self, index: int) -> int:
        """Apply a material variant; returns the number of primitives
        switched. The switch marks RENDER_NODES | MATERIALS, so
        sync_scene_changes refits on the device and re-packs the materials
        (the reference's sync skips the materials there: ROADMAP C)."""
        n = apply_variant(self.scene, index)
        if n:
            self.sync_scene_changes()
        return n

    def create_hdr(self, path) -> None:
        """Load an HDR environment (Radiance .hdr)."""
        self.hdr = load_hdr_environment(path, self.device, intensity=self.env_intensity,
                                        rotation=self.env_rotation)
        self.env_kind = "hdr"
        self.drop_replicas()
        self.reset_frame()

    def rebuild_device_scene(self) -> None:
        """Re-parse the model, rebuild the host tables and their device
        mirrors."""
        self.scene.parse_scene()
        self._build_device_scene()
        self._anim_tables_cache = None
        self.scene.clear_dirty_flags()
        self.reset_frame()

    def _build_device_scene(self) -> None:
        """Host tables, opacity classes and BVH from the parsed scene, and
        their device mirrors."""
        self.flat = build_scene_flat(self.scene)
        self._alpha_cls, self._subtri_cells = self._alpha_classes()
        self.bvh = build_world_bvh(self.flat, tri_class=self._alpha_cls, subtri_cells=self._subtri_cells)
        self.dev_scene = scene_to_device(self.flat, self.device)
        self.dev_bvh = bvh_to_device(self.bvh, self.device)
        self._table_families = set()
        self.drop_replicas()
        self._sync_kernel_tables(self._config())

    def drop_replicas(self) -> None:
        """Forget the other devices' copies of the device tables (after a
        rebuild, a refit, a material or table change, a new environment)."""
        self.replicas = {}

    def _alpha_classes(self):
        """(tri_class, subtri_cells) of ops/omm.py for the current host
        tables (reference renderer.py:224): both None when every material
        is OPAQUE; subtri_cells None under VKGR_OMM_SUBTRI=0."""
        if not any(m.get("alphaMode", "OPAQUE") != "OPAQUE" for m in self.scene.model.materials):
            return None, None
        cls = classify_attr_alpha(self.flat)
        cells = classify_subtri(self.flat, cls) if os.environ.get("VKGR_OMM_SUBTRI", "1") != "0" else None
        return cls, cells

    def sync_scene_changes(self) -> bool:
        """Apply the scene's dirty flags to the device mirrors (reference
        sync_scene_changes, renderer.py:247). Returns True if anything
        changed. A topology or visibility change rebuilds. A node,
        render-node or vertex change refits on the device
        (_refit_device), or rebuilds when the render-node count or
        visibility moved. A material or light change re-packs the material
        and light tables; unlike the reference, it does so on the refit
        path too (a variant switch marks both), and the render nodes'
        material ids follow. A material edit that moves the opacity classes
        rebuilds (reference renderer.py:284-302)."""
        df = self.scene.get_dirty_flags()
        if df == DirtyFlags.NONE:
            return False
        if df & (DirtyFlags.PRIMITIVES_CHANGED | DirtyFlags.TANGENTS | DirtyFlags.VISIBILITY):
            self.rebuild_device_scene()
            return True
        if df & (DirtyFlags.NODE_TRANSFORMS | DirtyFlags.RENDER_NODES | DirtyFlags.VERTICES):
            if len(self.scene.model.nodes) >= 512:
                self.scene.update_world_matrices_levels()
            else:
                self.scene.update_world_matrices_serial()
            self.scene.refresh_render_node_matrices()
            if not self._refit_device():
                self._build_device_scene()
        if df & (DirtyFlags.MATERIALS | DirtyFlags.LIGHTS):
            self.flat = dataclasses.replace(
                refresh_materials(self.flat, self.scene),
                rn_material=np.array([max(rn.material_id, 0) for rn in self.scene.render_nodes], np.int32))
            if df & DirtyFlags.MATERIALS:
                # an alpha mode, cutoff or texture edit can move the classes the BVH culled and
                # split by: rebuild when they moved
                cls, cells = self._alpha_classes()
                if _moved(cls, self._alpha_cls) or _moved(cells, self._subtri_cells):
                    self.rebuild_device_scene()
                    return True
            self.dev_scene = scene_to_device(self.flat, self.device)
            self.drop_replicas()
        self.scene.clear_dirty_flags()
        self.reset_frame()
        return True

    def _anim_tables(self) -> dict:
        """Device-resident animation inputs, built once per device scene
        (reference _anim_tables, renderer.py:308): {render node index: {v0,
        nv, pos0, deltas, joints0, weights0}} for every skinned or morphed
        render node, so that an animated frame decodes no primitive."""
        if self._anim_tables_cache is not None:
            return self._anim_tables_cache
        from .models.geometry import extract_primitive

        scene, dev = self.scene, self.device

        def up(a, dtype):
            return None if a is None else torch.tensor(np.asarray(a, dtype), device=dev)

        tables = {}
        for i, rn in enumerate(scene.render_nodes):
            node = scene.model.nodes[rn.ref_node_id] if rn.ref_node_id >= 0 else {}
            if rn.skin_id < 0 and node.get("weights") is None:
                continue
            rp = scene.render_primitives[rn.render_prim_id]
            pd = extract_primitive(scene.model, rp.primitive(scene.model))
            deltas = None
            if pd.morph_targets:
                deltas = np.stack([t.get("POSITION", np.zeros_like(pd.positions)) for t in pd.morph_targets])
            tables[i] = {
                "v0": int(self.flat.prim_first_vtx[rn.render_prim_id]),
                "nv": int(self.flat.prim_vtx_count[rn.render_prim_id]),
                "pos0": up(pd.positions, np.float32),
                "deltas": up(deltas, np.float32),
                "joints0": up(pd.joints0, np.int64),
                "weights0": up(pd.weights0, np.float32),
            }
        self._anim_tables_cache = tables
        return tables

    def _refit_device(self) -> bool:
        """Transform, skin and morph update on the device (reference
        _refit_device, renderer.py:347): deform the vertices, rebuild the
        instance matrices (w2o by f64 inverse on the host), re-bake the world
        triangles, refit every table family present, write the instance
        matrices into the device scene and re-bake the hit rows. No host
        readback. Returns False, for a rebuild, when the
        render-node count or visibility changed (the flattened BVH bakes
        the visible instance set)."""
        if self.flat is None or self.bvh is None:
            return False
        scene = self.scene
        vis_now = np.array([1 if rn.visible else 0 for rn in scene.render_nodes], np.int32)
        if len(scene.render_nodes) != self.flat.rn_o2w.shape[0] or not np.array_equal(
                vis_now, np.asarray(self.flat.rn_visible)):
            return False
        n = len(scene.render_nodes)
        o2w = np.stack([rn.world_matrix for rn in scene.render_nodes]).astype(np.float32)
        w2o = np.linalg.inv(o2w.astype(np.float64)).astype(np.float32)
        rn_packed = np.concatenate([o2w.reshape(n, 16), w2o.reshape(n, 16)], axis=1)
        dev = self.dev_bvh
        if dev.refit is None:
            dev.refit = refit_tables_to_device(self.flat, self.bvh, self.device)
        ref = dev.refit

        def dev_f32(a):
            return torch.tensor(np.asarray(a, np.float32), device=self.device)

        # skin / morph from the tables built once; the per-frame inputs are the small joint
        # matrices and morph weights. Normals carry over from the last refit, as in the reference.
        tables = self._anim_tables()
        if tables:
            vtx_pos, vtx_nrm = ref.vtx_pos.clone(), ref.vtx_nrm.clone()
            for rn_idx, tab in tables.items():
                rn = scene.render_nodes[rn_idx]
                node = scene.model.nodes[rn.ref_node_id] if rn.ref_node_id >= 0 else {}
                weights = node.get("weights")
                v0, nv = tab["v0"], tab["nv"]
                pos, nrm = tab["pos0"], vtx_nrm[v0:v0 + nv]
                if weights is not None and tab["deltas"] is not None:
                    pos = morph_vertices(pos, tab["deltas"], dev_f32(weights))
                if rn.skin_id >= 0 and tab["joints0"] is not None:
                    jm = compute_joint_matrices(scene, rn.skin_id, scene.world_matrices[rn.ref_node_id])
                    pos, nrm = skin_vertices(pos, nrm, tab["joints0"], tab["weights0"], dev_f32(jm))
                vtx_pos[v0:v0 + nv] = pos
                vtx_nrm[v0:v0 + nv] = nrm
            ref.vtx_pos, ref.vtx_nrm = vtx_pos, vtx_nrm
            ref.vtx_packed = torch.cat([vtx_pos, vtx_nrm, ref.vtx_packed[:, 6:]], dim=1)

        tris = bake_world_tris(ref.vtx_pos, ref.tri_idx, dev_f32(o2w), ref.wtri_rnode, ref.wtri_src_tri,
                               ref.wtri_bary)
        refit_device_bvh(dev, tris)
        # the instance matrices go to the device scene (instance motion reads them) and the host
        # mirror; the deformed vertices stay on the device
        self.dev_scene.rn_packed = dev_f32(rn_packed)
        dev.hit_attr = bake_hit_attrs(ref.vtx_packed, ref.tri_idx, self.dev_scene.rn_packed, ref.attr_rnode,
                                      ref.attr_tri, ref.attr_has_uv, narrow=ref.narrow,
                                      attr_bary=ref.attr_bary)
        self.flat = dataclasses.replace(self.flat, rn_o2w=o2w, rn_w2o=w2o, rn_packed=rn_packed)
        self.drop_replicas()
        return True

    def _sync_kernel_tables(self, cfg: RenderConfig) -> None:
        """Build (host) and upload (device) the tables the selected traversal
        reads and the scene lacks; tables of an earlier selection stay. A
        table built after a device refit is refitted on upload
        (convert.add_kernel_tables_to_device)."""
        need = cfg.kernel_tables() - {"bvh4"} - self._table_families  # nodes4_fi is always built
        if need:
            add_kernel_tables(self.bvh, need)
            add_kernel_tables_to_device(self.dev_bvh, self.bvh, self.device, need)
            self._table_families |= need
            self.drop_replicas()

    # -------------------------------------------------------------- frames
    def reset_frame(self) -> None:
        """Restart accumulation (the luminance moments and the TAAU history
        restart too)."""
        self.total_samples = 0
        self.accum = torch.zeros((self.width * self.height, 3), dtype=torch.float32, device=self.device)
        self._moments = None
        self._history_hi = None

    def _config(self) -> RenderConfig:
        model = self.scene.model
        feats = set(detect_scene_features(model))
        if model.images:
            feats.add("textured")
        cam = self.camera
        alpha_any = any(m.get("alphaMode", "OPAQUE") != "OPAQUE" for m in model.materials)
        return RenderConfig(
            width=self.width,
            height=self.height,
            spp=self.spp,
            max_depth=self.max_depth,
            features=frozenset(feats),
            env_kind=self.env_kind,
            has_lights=len(self.scene.render_lights) > 0,
            alpha_any=alpha_any,
            firefly_clamp=self.firefly_clamp,
            orthographic=bool(cam and cam.orthographic),
            aperture=self.aperture,
            focal_distance=(self.focal_distance or float(np.linalg.norm(
                np.asarray(cam.center) - np.asarray(cam.eye)))) if self.aperture > 0 else 0.0,
            background=self.background,
            use_infinite_plane=self.use_infinite_plane,
            plane_height=self.plane_height,
            plane_shadow_catcher=self.plane_shadow_catcher,
            shadow_catcher_darken=self.shadow_catcher_darken,
            denoise_guides=self.denoise_guides,
            taa_jitter=self.upscale > 1,
            wireframe=self.wireframe,
            traversal=os.environ.get("VKGR_TRAVERSAL", "packet"),
            primary_kernel=os.environ.get("VKGR_PRIMARY_KERNEL", "v3"),
            packet_kernel=os.environ.get("VKGR_PACKET_KERNEL", "v9"),
            # previous-frame hit seeding, off for alpha scenes (a seeded hit would skip the
            # stochastic alpha test), and the batched spp launch (reference renderer.py:513-515)
            primary_seed=os.environ.get("VKGR_PRIMARY_SEED", "0") != "0" and not alpha_any,
            spp_batch=os.environ.get("VKGR_SPP_BATCH", "0") != "0",
        )

    def _frame_inputs(self, cfg: RenderConfig | None = None) -> dict:
        """The frame dict of render_frame_flat; with cfg.primary_seed it also
        carries the last frame's first hits (a shard's caller passes no cfg:
        shards are not seeded)."""
        cam = self.camera
        view = mu.look_at(cam.eye, cam.center, cam.up)
        if cam.orthographic:
            proj = mu.orthographic(cam.xmag, cam.ymag, cam.znear, cam.zfar)
        else:
            proj = mu.perspective(cam.yfov, self.width / self.height, cam.znear, cam.zfar)
        if self.accum is None:
            self.reset_frame()

        def dev_f32(a):
            return torch.tensor(np.asarray(a, np.float32), device=self.device)

        out = {
            "proj_inv": dev_f32(np.linalg.inv(proj.astype(np.float64))),
            "view_inv": dev_f32(np.linalg.inv(view.astype(np.float64))),
            "frame_idx": self.frame_idx,
            "accum": self.accum,
            "total_samples": self.total_samples,
            # rounded to f32 like the reference's frame scalar
            "pixel_angle": float(np.float32(pixel_angle(cam.yfov, self.height))),
        }
        if self.upscale > 1:
            out["cam_jitter"] = dev_f32(halton23(self.frame_idx))
        if self.denoise_guides and self.dev_scene is not None:
            # the previous frame's transforms; the current ones on the first frame and after the
            # node count changed (zero motion)
            cur = self._rn_o2w()
            prev = self._prev_rn_o2w
            out["prev_rn_o2w"] = cur if prev is None or prev.shape != cur.shape else prev
        if cfg is not None and cfg.primary_seed:
            # the last frame's per-pixel first hit; -1 (no seed) at first and after the pixel count
            # changed. A stale seed after an edit is re-verified in the frame.
            n = self.width * self.height
            pf = self._prev_first
            if pf is None or pf[0].shape[0] != n:
                pf = tuple(torch.full((n,), -1, dtype=torch.int32, device=self.device) for _ in range(2))
            out["prev_first_rnode"], out["prev_first_tri"] = pf
        return out

    def _rn_o2w(self) -> torch.Tensor:
        """The render nodes' current object-to-world matrices [R,16] on the device."""
        return self.dev_scene.rn_packed[:, :16]

    def _view_proj(self) -> torch.Tensor:
        """Perspective view-projection of the camera (the reference uses the
        perspective even for an orthographic camera here), f64 product
        rounded to f32."""
        cam = self.camera
        view = mu.look_at(cam.eye, cam.center, cam.up)
        proj = mu.perspective(cam.yfov, self.width / self.height, cam.znear, cam.zfar)
        vp = proj.astype(np.float64) @ view.astype(np.float64)
        return torch.tensor(vp.astype(np.float32), device=self.device)

    def _ensure_ibl(self) -> dict:
        """The preview's IBL products, rebuilt when the environment changes."""
        key = (self.env_kind, id(self.hdr), self.env_intensity, self.env_rotation,
               tuple(np.asarray(self.sky_params.sun_direction, np.float32).tolist())
               if self.env_kind == "sky" else None)
        if self._ibl is None or self._ibl_key != key:
            self._ibl = build_ibl(self._env(), self.env_kind)
            self._ibl_key = key
        return self._ibl

    def _env(self):
        if self.env_kind == "hdr" and self.hdr is not None:
            return self.hdr
        return SkyEnv.from_arrays(self.sky_params.as_arrays(), self.device)

    def step_animation(self) -> None:
        """With animate on, advance the current clip by anim_speed / 60 s
        and apply it to the model's nodes (marking them dirty)."""
        if self.animate and self.scene.animations:
            info = self.scene.animations[self.scene.current_animation]
            info.increment_time(self.anim_speed / 60.0)
            update_animation(self.scene, self.scene.current_animation)

    def on_render(self) -> dict:
        """Render one frame; returns aux (first-hit captures, ray count).
        With animate on, the current clip first advances anim_speed / 60 s;
        then the scene's edits are synced."""
        self.step_animation()
        self.sync_scene_changes()
        cfg = self._config()
        cfg.check_supported()
        self._sync_kernel_tables(cfg)
        frame = self._frame_inputs(cfg)
        if self.adaptive is not None:
            synchronize(self.device)  # the frame's time starts with nothing else queued
        t0 = time.perf_counter()
        if self.render_system == 1:
            # a preview frame replaces the accumulation
            frame["ibl"] = self._ensure_ibl()
            accum, aux = render_preview(self.dev_scene, self.dev_bvh, self._env(), frame, cfg)
        else:
            accum, aux = render_frame_flat(self.dev_scene, self.dev_bvh, self._env(), frame, cfg)
        self.accum = accum
        self.total_samples += self.spp
        self.frame_idx += 1
        self._last_aux = aux
        if "first_tri" in aux:
            self._prev_first = (aux["first_rnode"], aux["first_tri"])
        if self.upscale > 1:
            # TAAU accumulates at display resolution: each frame's accum is that frame alone
            self.total_samples = 0
            self._taau_step()
        if "lum_moments" in aux:
            self._moments = aux["lum_moments"] if self._moments is None else self._moments + aux["lum_moments"]
        if self.denoise_guides and self.dev_scene is not None:
            self._prev_rn_o2w = self._rn_o2w()
        if self.adaptive is not None:
            # a real frame time: wait for the card before the host clock; the next frame renders
            # with the new spp
            synchronize(self.device)
            self.spp = self.adaptive.update((time.perf_counter() - t0) * 1000.0)
        return aux

    # -------------------------------------------------------------- output
    def image_linear(self) -> np.ndarray:
        return self.accum.reshape(self.height, self.width, 3).cpu().numpy()

    def _motion(self, vp, prev_vp) -> torch.Tensor:
        """Motion vectors [H,W,2] of the last frame's first hits."""
        h, w, aux = self.height, self.width, self._last_aux
        prev_pos = aux["first_pos_prev"].reshape(h, w, 3) if "first_pos_prev" in aux else None
        return motion_vectors(aux["first_pos"].reshape(h, w, 3), aux["solid"].reshape(h, w), prev_vp, vp, w, h,
                              first_pos_prev=prev_pos)

    def _taau_step(self) -> None:
        """Fold the frame just rendered into the display-res TAAU history."""
        vp = self._view_proj()
        mv = self._motion(vp, self._prev_vp if self._prev_vp is not None else vp)
        # frame_idx has advanced: the frame rendered with frame_idx - 1's jitter
        self._history_hi = temporal_upscale(self.accum.reshape(self.height, self.width, 3), mv,
                                            halton23(self.frame_idx - 1), self._history_hi, self.upscale)
        self._prev_vp = vp

    def image_upscaled(self) -> np.ndarray:
        """The display-res linear image of the TAAU history (upscale > 1,
        after a frame)."""
        if self._history_hi is None:
            raise RuntimeError("no TAAU history: set upscale > 1 and render")
        return self._history_hi[..., :3].cpu().numpy()

    def _tonemapped(self) -> torch.Tensor:
        """The tonemapped image [H,W,3] on the device."""
        return tonemap(self.accum.reshape(self.height, self.width, 3), self.tonemapper, self.exposure)

    def image_tonemapped(self) -> np.ndarray:
        return self._tonemapped().cpu().numpy()

    def image_denoised(self, *, temporal: bool = True, iterations: int = 4) -> np.ndarray:
        """The denoised linear image [H,W,3]: the à-trous denoiser over the
        accumulation with the last frame's guides, then, with temporal,
        blended into the previous denoised image reprojected by the motion
        vectors."""
        return self._denoised(temporal, iterations).cpu().numpy()

    def _denoised(self, temporal: bool = True, iterations: int = 4) -> torch.Tensor:
        """image_denoised's image on the device."""
        cur = denoise_renderer(self, iterations=iterations)
        vp = self._view_proj()
        if temporal and self._history is not None and self._prev_vp is not None and self._last_aux is not None:
            valid = torch.ones((self.height, self.width), dtype=torch.bool, device=self.device)
            cur = temporal_accumulate(cur, self._history, self._motion(vp, self._prev_vp), valid)
        self._history = cur
        self._prev_vp = vp
        return cur

    def image_with_silhouette(self) -> np.ndarray:
        """The tonemapped image with the selected render nodes outlined."""
        img = self._tonemapped()
        if self.selection and self._last_aux is not None:
            mask = torch.zeros(max(len(self.scene.render_nodes), 1), dtype=torch.bool)
            for i in self.selection:
                if 0 <= i < mask.shape[0]:
                    mask[i] = True
            oid = self._last_aux["first_rnode"].reshape(self.height, self.width)
            img = silhouette(oid, mask.to(self.device), img)
        return img.cpu().numpy()

    def pick(self, px: int, py: int) -> int:
        """The render node under pixel (px, py), or -1; a node marked
        unselectable (KHR_node_selectability) gives -1."""
        rid = pick_ray(self, px, py)
        if rid >= 0:
            rn = self.scene.render_nodes[rid]
            node = self.scene.model.nodes[rn.ref_node_id] if rn.ref_node_id >= 0 else {}
            if not node.get("extensions", {}).get("KHR_node_selectability", {}).get("selectable", True):
                return -1
        return rid

    def save_image(self, path) -> None:
        """Write an 8-bit RGB image by path's suffix (utils/image_io: PNG,
        JPEG or lossless WebP): the tonemapped TAAU image under upscale, else the tonemapped
        image with the selection outlined."""
        if self.upscale > 1 and self._history_hi is not None:
            img = tonemap(self._history_hi[..., :3], self.tonemapper, self.exposure).cpu().numpy()
        else:
            img = self.image_with_silhouette()
        write_image(path, (np.clip(img, 0, 1) * 255).astype(np.uint8))
