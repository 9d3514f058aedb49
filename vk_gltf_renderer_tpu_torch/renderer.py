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

Not ported yet: animation, scene-change sync (dirty flags, refit), the
preview renderer, denoising, TAA upscaling, the silhouette overlay,
picking and the adaptive sampler (ROADMAP.md). The TPU fallback ladder
(VMEM kernel rungs, VKGR_LANE_STREAM, cache rotation) has no role here,
and the reference's downgrade to the wavefront after kernel faults
(_traversal_fallback) is deliberately not ported: it would hide a faulty
kernel behind another traversal.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from .convert import add_kernel_tables_to_device, bvh_to_device, scene_to_device
from .device import resolve_device
from .models import Scene
from .models.materials import detect_scene_features
from .ops.bvh_flatten import add_kernel_tables, build_world_bvh
from .ops.camera import pixel_angle
from .ops.flat import build_scene_flat
from .ops.hdr import load_hdr_environment
from .ops.pathtrace import RenderConfig, render_frame_flat
from .ops.sky import SkyEnv, SkyParams
from .ops.tonemap import tonemap
from .utils import mathutil as mu
from .utils.png import write_png


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
                 env_kind="sky", tonemapper="filmic"):
        self.device = resolve_device(device)
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

    def create_hdr(self, path) -> None:
        """Load an HDR environment (Radiance .hdr)."""
        self.hdr = load_hdr_environment(path, self.device, intensity=self.env_intensity,
                                        rotation=self.env_rotation)
        self.env_kind = "hdr"
        self.reset_frame()

    def rebuild_device_scene(self) -> None:
        """Re-parse the model, rebuild the host tables and their device
        mirrors."""
        self.scene.parse_scene()
        self.flat = build_scene_flat(self.scene)
        self.bvh = build_world_bvh(self.flat)
        self.dev_scene = scene_to_device(self.flat, self.device)
        self.dev_bvh = bvh_to_device(self.bvh, self.device)
        self._sync_kernel_tables(self._config())
        self.scene.clear_dirty_flags()
        self.reset_frame()

    def _sync_kernel_tables(self, cfg: RenderConfig) -> None:
        """Build (host) and upload (device) the tables the selected traversal
        reads and the scene lacks; tables of an earlier selection stay."""
        need = cfg.kernel_tables() - {"bvh4"}  # nodes4_fi is always built
        if need:
            add_kernel_tables(self.bvh, need)
            add_kernel_tables_to_device(self.dev_bvh, self.bvh, self.device, need)

    # -------------------------------------------------------------- frames
    def reset_frame(self) -> None:
        """Restart accumulation."""
        self.total_samples = 0
        self.accum = torch.zeros((self.width * self.height, 3), dtype=torch.float32, device=self.device)

    def _config(self) -> RenderConfig:
        model = self.scene.model
        feats = set(detect_scene_features(model))
        if model.images:
            feats.add("textured")
        cam = self.camera
        return RenderConfig(
            width=self.width,
            height=self.height,
            spp=self.spp,
            max_depth=self.max_depth,
            features=frozenset(feats),
            env_kind=self.env_kind,
            has_lights=len(self.scene.render_lights) > 0,
            alpha_any=any(m.get("alphaMode", "OPAQUE") != "OPAQUE" for m in model.materials),
            firefly_clamp=self.firefly_clamp,
            orthographic=bool(cam and cam.orthographic),
            aperture=self.aperture,
            focal_distance=(self.focal_distance or float(np.linalg.norm(
                np.asarray(cam.center) - np.asarray(cam.eye)))) if self.aperture > 0 else 0.0,
            background=self.background,
            traversal=os.environ.get("VKGR_TRAVERSAL", "packet"),
            primary_kernel=os.environ.get("VKGR_PRIMARY_KERNEL", "v3"),
            packet_kernel=os.environ.get("VKGR_PACKET_KERNEL", "v9"),
        )

    def _frame_inputs(self) -> dict:
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

        return {
            "proj_inv": dev_f32(np.linalg.inv(proj.astype(np.float64))),
            "view_inv": dev_f32(np.linalg.inv(view.astype(np.float64))),
            "frame_idx": self.frame_idx,
            "accum": self.accum,
            "total_samples": self.total_samples,
            # rounded to f32 like the reference's frame scalar
            "pixel_angle": float(np.float32(pixel_angle(cam.yfov, self.height))),
        }

    def _env(self):
        if self.env_kind == "hdr" and self.hdr is not None:
            return self.hdr
        return SkyEnv.from_arrays(self.sky_params.as_arrays(), self.device)

    def on_render(self) -> dict:
        """Render one frame; returns aux (first-hit captures, ray count)."""
        cfg = self._config()
        cfg.check_supported()
        self._sync_kernel_tables(cfg)
        accum, aux = render_frame_flat(self.dev_scene, self.dev_bvh, self._env(), self._frame_inputs(), cfg)
        self.accum = accum
        self.total_samples += self.spp
        self.frame_idx += 1
        self._last_aux = aux
        return aux

    # -------------------------------------------------------------- output
    def image_linear(self) -> np.ndarray:
        return self.accum.reshape(self.height, self.width, 3).cpu().numpy()

    def image_tonemapped(self) -> np.ndarray:
        img = tonemap(self.accum.reshape(self.height, self.width, 3), self.tonemapper, self.exposure)
        return img.cpu().numpy()

    def save_image(self, path) -> None:
        """Write the tonemapped image as an 8-bit RGB PNG."""
        img = (np.clip(self.image_tonemapped(), 0, 1) * 255).astype(np.uint8)
        write_png(path, img)
