"""Interactive terminal viewer — the framework's interactive front end.

The reference is an interactive Vulkan app (GltfRenderer UI: orbit camera,
renderer toggle, variants, denoiser toggle — renderer.cpp onUIRender /
onRender loop + nvgui camera widgets). The interactive surface here is
the terminal: frames render on the card (unless --device names the CPU),
the grid and gizmo overlays composite on the frame there, and one uint8
image comes back to the host to display as 24-bit ANSI half-blocks (2 px
per character cell), with the same interaction verbs.

Keys:
  a / d      orbit azimuth        w / s    orbit elevation
  + / -      dolly in / out       h/j/k/l or arrows   pan
  p          toggle path tracer <-> preview renderer
  n          toggle denoised display
  v          cycle material variants
  r          re-fit camera to scene bounds
  t          toggle the scene-browser tree pane (ui_scene_browser role)
  ] / [      tree: select next / previous node (silhouette-highlighted)
  x          tree: toggle selected node's visibility
  G          toggle the reference grid overlay (gizmo grid role)
  A          animation play/pause (ui_animation's play button; :timeline
             scrubs/selects/sets speed)
  g          cycle the transform gizmo on the selected node:
             off -> translate -> rotate -> scale (handles drawn on the
             frame, gizmo_visuals.slang role; :gizmo space world|local)
  :CMD;      run any edit-shell verb on the live scene (rename, reparent,
             matset, lightset, translate, undo, ... — see edit_cli);
             terminated by ';', e.g.  :rename 2 Hood;  :reparent 4 0;
             viewer-local verbs: :cam (live camera), :rset (renderer
             settings panel: depth/spp/tonemapper/exposure/...), :aov
             (debug guide-buffer views), :gizmo (handles + space + pick)
  q / Esc    quit

Scripted mode (CI / no TTY): --keys "aadw+p q" replays a key sequence,
rendering between keys, then writes --output and exits — the same loop the
interactive path runs, minus the TTY. ':' commands work there too, so a
--keys script can reproduce full browser/inspector workflows headlessly.

A ':' verb that fails on bad input prints an error and the viewer goes
on; an error of the renderer, the device or the kernel library (the
resync after an edit among them) propagates.

Usage:
  python -m vk_gltf_renderer_tpu_torch.viewer --scenefile scene.glb [--hdr e.hdr]
      [--size 96] [--spp 1] [--keys "..."] [--output out.png] [--device cuda]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .edit_cli import BAD_INPUT
from .ops.grid import camera_basis
from .utils.image_io import check_writable, write_image


def _node_visible(n: dict) -> bool:
    return n.get("extensions", {}).get("KHR_node_visibility", {}).get("visible", True)


def _halfblocks(img: np.ndarray) -> str:
    """[H,W,3] uint8 -> ANSI string, 2 vertical pixels per cell."""
    h, w = img.shape[:2]
    if h % 2:
        img = np.concatenate([img, np.zeros((1, w, 3), np.uint8)])
        h += 1
    top = img[0::2]
    bot = img[1::2]
    rows = []
    for y in range(h // 2):
        cells = []
        for x in range(w):
            tr, tg, tb = (int(v) for v in top[y, x])
            br, bg, bb = (int(v) for v in bot[y, x])
            cells.append(f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg};{bb}m▀")
        rows.append("".join(cells) + "\x1b[0m")
    return "\n".join(rows)


class TerminalViewer:
    def __init__(self, scene_path, hdr_path=None, size=96, spp=1, max_depth=3,
                 render_system=0, device="cuda"):
        from .renderer import GltfRenderer

        self.r = GltfRenderer(width=size, height=size, spp=spp, max_depth=max_depth, device=device)
        self.r.render_system = render_system
        self.r.create_scene(scene_path)
        if hdr_path:
            self.r.create_hdr(hdr_path)
        self.denoised = False
        self.grid = False
        self.tree = False
        self.gizmo_mode = None  # None | gizmo.Mode — drawn on the frame
        self.gizmo_space = "world"
        self.gizmo_active = None  # highlighted handle id (hover feedback)
        self.aov = None  # None = beauty; else a debug AOV view name
        self._tree_sel = 0  # index into the DFS node list
        self._cmdbuf = None  # ':' command-mode accumulator
        self._shell = None  # lazy EditShell over the live scene
        self._last_out = []  # captured output of the last ':' verb
        self._candidates = []  # tab-completion candidates (status line)
        self._syncing = False  # set once a local verb has handed work to the renderer
        self._orbit = [0.0, 0.3]  # azimuth, elevation offsets
        self._fit = None
        self._refresh_camera(reset=True)

    # ---------------------------------------------------------- camera
    def _refresh_camera(self, reset=False):
        from .renderer import CameraState, fit_camera

        if reset:
            self._fit = fit_camera(self.r.scene)
            self._orbit = [0.0, 0.3]
            self._pan = np.zeros(3)
            self._dist = float(np.linalg.norm(self._fit.eye - self._fit.center))
        base = self._fit
        az, el = self._orbit
        el = float(np.clip(el, -1.4, 1.4))
        c = np.asarray(base.center, np.float64) + self._pan
        d = self._dist
        eye = c + d * np.array([np.sin(az) * np.cos(el), np.sin(el), np.cos(az) * np.cos(el)])
        self.r.camera = CameraState(eye=eye.astype(np.float32), center=c.astype(np.float32),
                                    up=np.array([0, 1, 0], np.float32), yfov=base.yfov)
        self.r.reset_frame()

    # ------------------------------------------------------ scene browser
    def _dfs_nodes(self):
        """[(node_id, depth)] in tree order — the browser pane's rows."""
        model = self.r.scene.model
        out = []

        def walk(nid, depth):
            out.append((nid, depth))
            for c in model.nodes[nid].get("children", []):
                walk(c, depth + 1)

        scene_idx = model.gltf.get("scene", 0)
        for root in model.gltf["scenes"][scene_idx].get("nodes", []):
            walk(root, 0)
        return out

    def tree_pane(self) -> str:
        """Scene-browser tree with the selection cursor (ui_scene_browser)."""
        rows = []
        for i, (nid, depth) in enumerate(self._dfs_nodes()):
            n = self.r.scene.model.nodes[nid]
            cur = ">" if i == self._tree_sel else " "
            vis = "" if _node_visible(n) else " [hidden]"
            mesh = f" mesh={n['mesh']}" if "mesh" in n else ""
            rows.append(f"{cur} {'  ' * depth}[{nid}] {n.get('name', '') or '(unnamed)'}{mesh}{vis}")
        return "\n".join(rows)

    def _select(self, delta: int):
        nodes = self._dfs_nodes()
        if not nodes:
            return
        self._tree_sel = (self._tree_sel + delta) % len(nodes)
        nid = nodes[self._tree_sel][0]
        model = self.r.scene.model
        rns = self.r.scene.registry.render_nodes_for_subtree(
            nid, lambda n: model.nodes[n].get("children", []))
        self.r.selection = set(rns)

    def shell(self):
        if self._shell is None:
            from .edit_cli import EditShell

            self._shell = EditShell(self.r.scene, device=self.r.device)
        return self._shell

    # viewer-local camera verbs (the inspector's camera panel operates on
    # the LIVE view camera, ui_renderer.cpp camera widget role)
    def _cmd_cam(self, *args):
        cam = self.r.camera
        if not args:
            eye = " ".join(f"{v:.4g}" for v in cam.eye)
            ctr = " ".join(f"{v:.4g}" for v in cam.center)
            print(f"eye {eye}")
            print(f"center {ctr}")
            print(f"fov {np.degrees(cam.yfov):.4g}")
            print(f"dist {self._dist:.4g}")
            return
        key, vals = args[0], [float(v) for v in args[1:]]
        if key == "eye" and len(vals) == 3:
            # re-derive orbit state so a/d/w/s keep working from the new eye
            eye = np.asarray(vals)
            c = np.asarray(cam.center, np.float64)
            d = eye - c
            self._dist = float(np.linalg.norm(d))
            self._orbit = [float(np.arctan2(d[0], d[2])),
                           float(np.arcsin(np.clip(d[1] / max(self._dist, 1e-9), -1, 1)))]
        elif key == "center" and len(vals) == 3:
            self._pan = np.asarray(vals) - np.asarray(self._fit.center, np.float64)
        elif key == "fov" and len(vals) == 1:
            from .renderer import CameraState

            self._fit = CameraState(
                eye=self._fit.eye, center=self._fit.center, up=self._fit.up,
                yfov=float(np.radians(vals[0])), znear=self._fit.znear,
                zfar=self._fit.zfar)
        elif key == "dist" and len(vals) == 1:
            self._dist = float(vals[0])
        else:
            print(f"cam: unknown form {key!r} (eye|center|fov|dist)")
            return
        self._refresh_camera()

    #: live renderer settings the inspector's render panel edits
    #: (ui_renderer.cpp sliders/combos) — name -> (attr, parse, needs_reset)
    RSET_FIELDS = {
        "depth": ("max_depth", int, True),
        "spp": ("spp", int, True),
        "tonemapper": ("tonemapper", str, False),
        "exposure": ("exposure", float, False),
        "firefly": ("firefly_clamp", float, True),
        "aperture": ("aperture", float, True),
        "focal": ("focal_distance", float, True),
        "envIntensity": ("env_intensity", float, True),
        "envRotation": ("env_rotation", float, True),
    }

    def _cmd_rset(self, *args):
        """Renderer-settings panel verb (ui_renderer.cpp role): `rset`
        lists every live setting; `rset <field> <value>` edits it. Fields
        that key the jit variant (depth/spp/...) reset accumulation; the
        display-side ones (tonemapper/exposure) re-display instantly —
        exactly the reference panel's recompile-vs-pushconstant split."""
        if not args:
            for name in sorted(self.RSET_FIELDS):
                attr, _, _ = self.RSET_FIELDS[name]
                print(f"{name} {getattr(self.r, attr)}")
            print(f"aov {self.aov or 'off'}")
            return
        name = args[0]
        spec = self.RSET_FIELDS.get(name)
        if spec is None:
            print(f"rset: unknown field {name!r} (rset lists fields)")
            return
        attr, parse, needs_reset = spec
        if len(args) != 2:
            print(f"{name} {getattr(self.r, attr)}")
            return
        if name == "tonemapper":
            from .ops.tonemap import OPERATORS

            if args[1] not in OPERATORS:
                print(f"rset: tonemapper must be one of {' '.join(OPERATORS)}")
                return
        try:
            setattr(self.r, attr, parse(args[1]))
        except ValueError as e:
            print(f"rset: {e}")
            return
        if needs_reset:
            self.r.reset_frame()
        print(f"{name} {getattr(self.r, attr)}")

    #: debug AOV views (the reference's debug-render-mode combo,
    #: shaderio DebugMethod role) — rendered from the frame's aux buffers
    AOV_NAMES = ("albedo", "normal", "roughness", "depth", "solid", "objectid")

    def _cmd_aov(self, *args):
        if not args or args[0] in ("off", "beauty"):
            self.aov = None
            print("aov off")
            return
        if args[0] not in self.AOV_NAMES:
            print(f"aov: one of {' '.join(self.AOV_NAMES)} | off")
            return
        self.aov = args[0]
        print(f"aov {self.aov}")

    def _aov_image(self) -> torch.Tensor | None:
        """[H,W,3] float display of the selected debug AOV, on the
        renderer's device."""
        aux = getattr(self.r, "_last_aux", None)
        if aux is None or self.aov is None:
            return None
        h = w = self.r.width

        def buf(key, ch=3):
            return aux[key].to(torch.float32).reshape((h, w, ch) if ch > 1 else (h, w))

        if self.aov == "albedo":
            return buf("albedo")
        if self.aov == "normal":
            return buf("normal") * 0.5 + 0.5
        if self.aov == "roughness":
            return buf("roughness", 1)[..., None].expand(h, w, 3)
        if self.aov == "solid":
            return buf("solid", 1)[..., None].expand(h, w, 3)
        if self.aov == "depth":
            pos = buf("first_pos")
            solid = buf("solid", 1) > 0.5
            eye = torch.tensor(np.asarray(self.r.camera.eye, np.float32), device=pos.device)
            d = torch.linalg.norm(pos - eye, dim=-1)
            # no solid pixel: every value below is 0 whatever the scale
            dmax = torch.clamp(torch.where(solid, d, 0.0).max(), min=1e-9)
            g = torch.where(solid, 1.0 - d / dmax, 0.0)
            return g[..., None].expand(h, w, 3)
        # objectid: hash render-node id to a stable pseudo-color
        rid = aux["first_rnode"].reshape(h, w).to(torch.int64)
        u = ((rid + 1) * 2654435761) & 0xFFFFFF  # +1: id 0 must not be black
        col = torch.stack([(u >> 16) & 255, (u >> 8) & 255, u & 255], -1) / 255.0
        return torch.where((rid >= 0)[..., None], col, 0.0).to(torch.float32)

    def _cmd_timeline(self, *args):
        """Animation timeline panel verb (ui_animation.cpp role): `timeline`
        prints playback state; `timeline play [speed] | pause | speed S |
        select IDX | time T`. Playback advances speed/60 s per rendered
        frame on the renderer's device-resident skin/morph path; `time`
        scrubs the LIVE scene (the slider) without an undo entry — the
        undoable scrub stays on the edit shell's `anim` verb."""
        scene = self.r.scene
        if not scene.animations:
            print("timeline: scene has no animations")
            return
        if not args:
            info = scene.animations[scene.current_animation]
            state = "playing" if self.r.animate else "paused"
            print(f"timeline {state} anim={scene.current_animation} "
                  f"{info.name!r} t={info.current_time:.3f} "
                  f"range=[{info.start:.3f},{info.end:.3f}] "
                  f"speed={self.r.anim_speed:g}")
            return
        key = args[0]
        if key == "play":
            if len(args) == 2:
                self.r.anim_speed = float(args[1])
            self.r.animate = True
        elif key == "pause":
            self.r.animate = False
        elif key == "speed" and len(args) == 2:
            self.r.anim_speed = float(args[1])
        elif key == "select" and len(args) == 2:
            scene.current_animation = int(args[1]) % len(scene.animations)
        elif key == "time" and len(args) == 2:
            from .models.animation import update_animation

            info = scene.animations[scene.current_animation]
            info.current_time = float(args[1])
            update_animation(scene, scene.current_animation)
            self._syncing = True
            self.r.sync_scene_changes()
            self.r.reset_frame()
        else:
            print("timeline: play [speed] | pause | speed S | select IDX | time T")
            return
        self._cmd_timeline()  # echo the new state

    def _cmd_gizmo(self, *args):
        """Gizmo control verb: `gizmo` prints state; `gizmo translate|
        rotate|scale|off`; `gizmo space world|local`; `gizmo pick <px> <py>`
        highlights the handle under a pixel (hover feedback, and the id it
        prints is what begin_drag/drag_delta take)."""
        from . import gizmo as gz

        if not args:
            mode = self.gizmo_mode.value if self.gizmo_mode else "off"
            print(f"gizmo {mode} space={self.gizmo_space} active={self.gizmo_active}")
            return
        key = args[0]
        if key in ("translate", "rotate", "scale"):
            self.gizmo_mode = gz.Mode(key)
        elif key == "off":
            self.gizmo_mode = None
            self.gizmo_active = None
        elif key == "space" and len(args) == 2 and args[1] in ("world", "local"):
            self.gizmo_space = args[1]
        elif key == "pick" and len(args) == 3 and self.gizmo_mode:
            frame = self._gizmo_frame()
            if frame is None:
                print("gizmo: no selected node")
                return
            nid, pivot, axes, size = frame
            ro, rd = self._pixel_ray(float(args[1]), float(args[2]))
            self.gizmo_active = gz.pick_handle(ro, rd, pivot, axes,
                                               self.gizmo_mode, size=size)
            print(f"gizmo pick -> {self.gizmo_active}")
        else:
            print("gizmo: translate|rotate|scale|off | space world|local | pick px py")

    def _pixel_ray(self, px: float, py: float):
        """Camera ray through a pixel center — grid.py's mapping inverted
        (shared convention with ops/gizmo_draw._Camera.project)."""
        cam = self.r.camera
        eye, fwd, right, up = camera_basis(cam.eye, cam.center, cam.up)
        h = w = self.r.width
        t = np.tan(cam.yfov * 0.5)
        cx = ((px + 0.5) / w - 0.5) * 2.0 * t * (w / h)
        cy = (0.5 - (py + 0.5) / h) * 2.0 * t
        d = fwd + cx * right + cy * up
        return eye, d / np.linalg.norm(d)

    def _gizmo_frame(self):
        """(node_id, pivot, axes, world size) for the selected node."""
        from . import gizmo as gz
        from .ops.gizmo_draw import auto_size

        nodes = self._dfs_nodes()
        if not nodes:
            return None
        nid = nodes[self._tree_sel][0]
        pivot, axes = gz.handle_frame(
            self.r.scene, nid,
            gz.Space.LOCAL if self.gizmo_space == "local" else gz.Space.WORLD)
        cam = self.r.camera
        return nid, pivot, axes, auto_size(cam.eye, pivot, cam.yfov)

    #: ':'-mode verbs resolved on the viewer itself, before the edit shell
    LOCAL_VERBS = ("aov", "cam", "gizmo", "rset", "timeline")

    def run_command(self, line: str):
        """One inspector verb against the live scene (or view camera), then
        device resync. Output is captured for the viewer pane AND echoed to
        stdout (scripted mode asserts on it). A local verb's bad input
        prints an error; an error once the renderer has the work (the
        resync) propagates."""
        import contextlib
        import io

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            parts = line.split()
            if parts and parts[0] in self.LOCAL_VERBS:
                self._syncing = False
                try:
                    getattr(self, "_cmd_" + parts[0])(*parts[1:])
                except BAD_INPUT as e:
                    if self._syncing:
                        raise
                    print(f"error: {type(e).__name__}: {e}")
            else:
                self.shell().run_line(line)
                self.r.sync_scene_changes()
                self.r.reset_frame()
        self._last_out = buf.getvalue().rstrip("\n").splitlines()
        if self._last_out:
            print("\n".join(self._last_out))

    # -------------------------------------------------- ':' tab completion
    def _verbs(self):
        """Every completable verb: edit-shell cmd_* + viewer-local."""
        from .edit_cli import EditShell

        names = [a[4:] for a in dir(EditShell) if a.startswith("cmd_")]
        return sorted(names + list(self.LOCAL_VERBS))

    LIGHT_KEYS = ("color", "intensity", "range", "type")
    CAM_KEYS = ("center", "dist", "eye", "fov")

    def _complete(self, buf: str) -> str:
        """Tab-complete the ':' buffer in place; ambiguity lists candidates
        in the status line (the inspector's field dropdown role)."""
        from .edit_cli import EditShell

        parts = buf.split(" ")
        word = parts[-1]
        if len(parts) == 1:
            pool = self._verbs()
        elif parts[0] == "matset" and len(parts) == 3:
            pool = sorted(EditShell.MAT_FIELDS)
        elif parts[0] == "lightset" and len(parts) == 3:
            pool = list(self.LIGHT_KEYS)
        elif parts[0] == "cam" and len(parts) == 2:
            pool = list(self.CAM_KEYS)
        elif parts[0] == "gizmo" and len(parts) == 2:
            pool = ["off", "pick", "rotate", "scale", "space", "translate"]
        elif parts[0] == "rset" and len(parts) == 2:
            pool = sorted(self.RSET_FIELDS)
        elif parts[0] == "rset" and len(parts) == 3 and parts[1] == "tonemapper":
            from .ops.tonemap import OPERATORS

            pool = sorted(OPERATORS)
        elif parts[0] == "aov" and len(parts) == 2:
            pool = sorted(self.AOV_NAMES) + ["off"]
        elif parts[0] == "timeline" and len(parts) == 2:
            pool = ["pause", "play", "select", "speed", "time"]
        else:
            self._candidates = []
            return buf
        hits = [p for p in pool if p.startswith(word)]
        self._candidates = hits if len(hits) > 1 else []
        if not hits:
            return buf
        # extend to the longest common prefix; full word + space if unique
        import os.path

        common = os.path.commonprefix(hits)
        new = common + (" " if len(hits) == 1 else "")
        return " ".join(parts[:-1] + [new]) if len(parts) > 1 else new

    # ---------------------------------------------------------- input
    def handle_key(self, k: str) -> bool:
        """Apply one interaction verb; False = quit."""
        step = 0.15
        if self._cmdbuf is not None:  # ':' command mode until ';' or newline
            if k in (";", "\n", "\r"):
                line, self._cmdbuf = self._cmdbuf, None
                self._candidates = []
                if line:
                    self.run_command(line)
            elif k == "\t":
                self._cmdbuf = self._complete(self._cmdbuf)
            elif k in ("\x7f", "\b"):
                self._cmdbuf = self._cmdbuf[:-1]
            elif k == "\x1b":
                self._cmdbuf = None  # cancel
                self._candidates = []
            else:
                self._cmdbuf += k
            return True
        if k == ":":
            self._cmdbuf = ""
            return True
        if k == "t":
            self.tree = not self.tree
            if self.tree:
                self._select(0)
            return True
        if k == "]":
            self._select(+1)
            return True
        if k == "[":
            self._select(-1)
            return True
        if k == "x":
            nodes = self._dfs_nodes()
            if nodes:
                nid = nodes[self._tree_sel][0]
                n = self.r.scene.model.nodes[nid]
                self.run_command(f"visible {nid} {0 if _node_visible(n) else 1}")
            return True
        if k == "G":
            self.grid = not self.grid
            return True
        if k == "A":
            # play/pause toggle (ui_animation's play button)
            if self.r.scene.animations:
                self.r.animate = not self.r.animate
            return True
        if k == "g":
            from .gizmo import Mode

            cycle = [None, Mode.TRANSLATE, Mode.ROTATE, Mode.SCALE]
            self.gizmo_mode = cycle[(cycle.index(self.gizmo_mode) + 1) % len(cycle)]
            if self.gizmo_mode is None:
                self.gizmo_active = None
            return True
        if k in ("q", "\x1b"):
            return False
        if k == "a":
            self._orbit[0] -= step
        elif k == "d":
            self._orbit[0] += step
        elif k == "w":
            self._orbit[1] += step
        elif k == "s":
            self._orbit[1] -= step
        elif k == "+":
            self._dist *= 0.85
        elif k == "-":
            self._dist /= 0.85
        elif k in ("h", "j", "k", "l"):
            # pan in the camera plane (arrow keys alias to these)
            az, el = self._orbit
            right = np.array([np.cos(az), 0.0, -np.sin(az)])
            up = np.array([0.0, 1.0, 0.0])
            amt = self._dist * 0.05
            self._pan = self._pan + {
                "h": -right, "l": right, "k": up, "j": -up
            }[k] * amt
        elif k == "r":
            self._refresh_camera(reset=True)
            return True
        elif k == "p":
            self.r.render_system = 1 - self.r.render_system
            self.r.reset_frame()
            return True
        elif k == "n":
            self.denoised = not self.denoised
            return True
        elif k == "v":
            n = len(self.r.scene.model.extensions.get("KHR_materials_variants", {}).get("variants", [])) \
                if self.r.scene.model.extensions else 0
            if n:
                self.r.set_variant((getattr(self.r, "_viewer_variant", -1) + 1) % n)
                self.r._viewer_variant = (getattr(self.r, "_viewer_variant", -1) + 1) % n
            return True
        elif k == " ":
            return True
        else:
            return True
        self._refresh_camera()
        return True

    # ---------------------------------------------------------- frames
    def frame_u8(self) -> np.ndarray:
        """Render a frame and compose what the viewer shows of it on the
        renderer's device (the AOV or the tonemapped or denoised image, the
        grid, the gizmo); one uint8 image comes back to the host."""
        self.r.on_render()
        img = None
        if self.aov is not None:
            img = self._aov_image()  # debug AOV display (ui_renderer combo)
        if img is None:
            img = self.r._denoised() if self.denoised else self.r._tonemapped()
        img = img.to(torch.float32)
        if self.grid:
            from .ops.grid import grid_overlay

            cam = self.r.camera
            depth = None
            aux = getattr(self.r, "_last_aux", None)
            if aux is not None and "first_pos" in aux:
                pos = aux["first_pos"].reshape(-1, 3)
                solid = aux["solid"].reshape(-1).to(torch.float32) > 0.5
                eye = torch.tensor(np.asarray(cam.eye, np.float32), device=pos.device)
                d = torch.linalg.norm(pos - eye[None, :], dim=-1)
                depth = torch.where(solid, d, torch.inf)
            img = grid_overlay(img, cam.eye, cam.center, cam.up, cam.yfov,
                               scene_depth=depth)
        if self.gizmo_mode is not None:
            frame = self._gizmo_frame()
            if frame is not None:
                from .ops.gizmo_draw import gizmo_overlay

                _, pivot, axes, size = frame
                cam = self.r.camera
                img = gizmo_overlay(img, cam.eye, cam.center, cam.up, cam.yfov,
                                    pivot, axes, self.gizmo_mode, size=size,
                                    active=self.gizmo_active)
        return torch.clamp(img * 255.0, 0, 255).to(torch.uint8).cpu().numpy()

    def status(self) -> str:
        mode = "preview" if self.r.render_system == 1 else "pathtrace"
        dn = " +denoise" if self.denoised else ""
        gr = " +grid" if self.grid else ""
        if self.gizmo_mode is not None:
            gr += f" +gizmo:{self.gizmo_mode.value}"
        if self.aov is not None:
            gr += f" +aov:{self.aov}"
        if self.r.animate and self.r.scene.animations:
            info = self.r.scene.animations[self.r.scene.current_animation]
            gr += f" +anim:{info.current_time:.2f}s"
        if self._cmdbuf is not None:
            hint = ("   {" + " ".join(self._candidates[:8]) + "}") if self._candidates else ""
            return f":{self._cmdbuf}{hint}"
        return (f"[{mode}{dn}{gr}] frame {self.r.frame_idx} | a/d w/s orbit  +/- dolly  "
                f"p renderer  n denoise  t tree  G grid  :cmd; (tab completes)  r refit  q quit")


def run_interactive(v: TerminalViewer):
    import select
    import termios
    import tty

    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    try:
        tty.setcbreak(fd)
        sys.stdout.write("\x1b[2J")  # clear
        while True:
            img = v.frame_u8()
            pane = ("\n" + v.tree_pane()) if v.tree else ""
            if v._last_out:  # last ':' verb output (inspector panel role)
                pane += "\n" + "\n".join(v._last_out[-12:])
            sys.stdout.write("\x1b[H" + _halfblocks(img) + "\n" + v.status() + "\x1b[K" + pane + "\x1b[0J\n")
            sys.stdout.flush()
            if select.select([sys.stdin], [], [], 0.01)[0]:
                k = sys.stdin.read(1)
                if k == "\x1b":
                    # arrow keys arrive as ESC [ A/B/C/D; a lone ESC quits
                    if select.select([sys.stdin], [], [], 0.05)[0]:
                        seq = sys.stdin.read(2)
                        k = {"[A": "k", "[B": "j", "[C": "l", "[D": "h"}.get(seq, "")
                        if not k:
                            continue
                    # else: bare ESC falls through to handle_key -> quit
                if not v.handle_key(k):
                    break
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)
        sys.stdout.write("\x1b[0m\n")


def run_scripted(v: TerminalViewer, keys: str, output: str | None):
    """Replay keys (space = just render a frame), write final image."""
    alive = True
    for k in keys:
        if v._cmdbuf is None:  # don't render between ':' command characters
            v.frame_u8()
        alive = v.handle_key(k)
        if not alive:
            break
    img = v.frame_u8()
    if output:
        write_image(output, img)
        print(f"Saved {output}")
    # one pane of ANSI output proves the display path end-to-end
    small = img[:: max(1, img.shape[0] // 16), :: max(1, img.shape[1] // 16)]
    print(_halfblocks(small))
    print(v.status())
    if v.tree:
        print(v.tree_pane())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--scenefile", required=True)
    p.add_argument("--hdr", default=None)
    p.add_argument("--size", type=int, default=96)
    p.add_argument("--spp", type=int, default=1)
    p.add_argument("--maxDepth", type=int, default=3)
    p.add_argument("--keys", default=None, help="scripted key sequence (no TTY needed)")
    p.add_argument("--output", default=None)
    p.add_argument("--renderer", type=int, default=0, choices=(0, 1),
                   help="initial renderer: 0=pathtrace 1=preview (reference --renderSystem)")
    p.add_argument("--device", type=str, default="cuda", help="torch device (cuda, cuda:N or cpu)")
    args = p.parse_args(argv)
    if args.output:
        check_writable(args.output)  # before the scene loads

    v = TerminalViewer(args.scenefile, args.hdr, size=args.size, spp=args.spp,
                       max_depth=args.maxDepth, render_system=args.renderer, device=args.device)
    if args.keys is not None or not sys.stdin.isatty():
        run_scripted(v, args.keys or "", args.output)
    else:
        run_interactive(v)
    return 0


if __name__ == "__main__":
    sys.exit(main())
