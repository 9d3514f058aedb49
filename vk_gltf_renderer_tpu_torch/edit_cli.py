"""Scene-editing shell — the headless stand-in for the reference's
scene-browser/inspector EDITING surface (ui_scene_browser.cpp drag-reparent
/ context menus, ui_inspector.cpp property editing), on top of SceneEditor
+ UndoStack so every edit is undoable exactly like the reference's
command-pattern undo (undo_redo.hpp:22-90).

    python -m vk_gltf_renderer_tpu_torch.edit_cli scene.glb            # REPL
    python -m vk_gltf_renderer_tpu_torch.edit_cli scene.glb -c "translate 0 1 0 0" -c "save out.glb"
    echo "tree" | python -m vk_gltf_renderer_tpu_torch.edit_cli scene.glb --device cpu

`render` renders on the card unless --device names the CPU. The shell
survives a bad command (an unknown node, a malformed number), but an error
raised once a render has started, by the renderer, the device or the
kernel library, propagates.

Commands (tab-free, scriptable; `help` lists them):
    tree | flat | materials | lights | stats inspection (inspect_cli views)
    find SUBSTR                              node search (browser filter)
    inspect NODE                             full node panel (inspector parity)
    matget MAT                               dump one material (all fields)
    cameras                                  scene cameras
    translate|scale NODE X Y Z               TRS edit (undoable, merging)
    rotate NODE X Y Z W                      quaternion rotation
    rename NODE NAME         visible NODE 0|1
    material NODE PRIM MAT                   assign material
    matset MAT KEY V...                      e.g. matset 0 baseColorFactor 1 0 0 1
    matfields                                list every per-field material verb
    lightset LIGHT KEY V...                  e.g. lightset 0 intensity 40
    add plane|cube|sphere [PARENT]           procedural primitives
    light point|directional|spot [PARENT]
    duplicate NODE | delete NODE | reparent NODE PARENT(-1=root)
    anims | anim IDX TIME                    list / scrub animation (undoable)
    variants | variant IDX                   list / apply material variant
    undo | redo
    save PATH                                write .gltf/.glb
    render PATH [W H]                        path-traced snapshot
    quit
"""

from __future__ import annotations

import argparse
import shlex
import sys

from .device import resolve_device
from .models import Scene
from .models.editor import SceneEditor
from .models.undo import MaterialCommand, SnapshotCommand, TransformCommand, UndoStack


#: what a bad command raises while it parses its arguments or looks up the scene
BAD_INPUT = (ValueError, IndexError, KeyError, TypeError)


class EditShell:
    def __init__(self, scene: Scene, device="cuda"):
        self.scene = scene
        self.editor = SceneEditor(scene)
        self.undo = UndoStack(scene)
        self.device = resolve_device(device)  # of `render`; raises for CUDA without a card
        self._rendering = False  # set once a command has handed work to the renderer

    # ------------------------------------------------------------- commands
    def cmd_tree(self, *a):
        from .inspect_cli import print_tree

        print_tree(self.scene)

    def cmd_materials(self, *a):
        from .inspect_cli import print_materials

        print_materials(self.scene)

    def cmd_stats(self, *a):
        from .inspect_cli import print_stats

        print_stats(self.scene)

    def cmd_lights(self, *a):
        for i, rl in enumerate(self.scene.render_lights):
            print(f"[{i}] light={rl.light} node={rl.node_id}")

    def cmd_flat(self, *a):
        """Flat node list — the browser's non-tree mode (ui_scene_browser)."""
        for nid, node in enumerate(self.scene.model.nodes):
            mesh = node.get("mesh", "-")
            kids = len(node.get("children", []))
            print(f"[{nid}] {node.get('name', '')!r} mesh={mesh} children={kids}")

    def cmd_find(self, *sub):
        needle = " ".join(sub).lower()
        for nid, node in enumerate(self.scene.model.nodes):
            if needle in node.get("name", "").lower():
                print(f"[{nid}] {node.get('name', '')!r}")

    def cmd_inspect(self, node):
        """Node property panel (ui_inspector.cpp transform/mesh/material view)."""
        nid = int(node)
        n = self.scene.model.nodes[nid]
        print(f"node [{nid}] {n.get('name', '')!r}")
        if "matrix" in n:
            print(f"  matrix      {n['matrix']}")
        else:
            print(f"  translation {n.get('translation', [0, 0, 0])}")
            print(f"  rotation    {n.get('rotation', [0, 0, 0, 1])}")
            print(f"  scale       {n.get('scale', [1, 1, 1])}")
        if nid < len(self.scene.world_matrices):
            w = self.scene.world_matrices[nid]
            print("  world       " + "; ".join(
                " ".join(f"{v:.4g}" for v in row) for row in w))
        print(f"  children    {n.get('children', [])}")
        if "mesh" in n:
            mesh = self.scene.model.meshes[n["mesh"]]
            print(f"  mesh        [{n['mesh']}] {mesh.get('name', '')!r}")
            for pi, prim in enumerate(mesh.get("primitives", [])):
                mat = prim.get("material", "-")
                attrs = ",".join(sorted(prim.get("attributes", {})))
                print(f"    prim {pi}: material={mat} attrs={attrs}")
        for k in ("camera", "skin", "weights"):
            if k in n:
                print(f"  {k:<11} {n[k]}")
        if n.get("extensions"):
            print(f"  extensions  {sorted(n['extensions'])}")

    def cmd_matget(self, mat):
        import json as _json

        print(_json.dumps(self.scene.model.materials[int(mat)], indent=2, default=str))

    def cmd_cameras(self, *a):
        for i, cam in enumerate(self.scene.model.cameras):
            print(f"[{i}] {cam.get('type', '?')} {cam.get('name', '')!r} "
                  f"{cam.get('perspective', cam.get('orthographic', {}))}")
        for rc in self.scene.render_cameras:
            eye = " ".join(f"{v:.4g}" for v in rc.eye)
            print(f"  instance: {rc.type} eye=({eye}) yfov={rc.yfov:.4g}")

    def cmd_lightset(self, idx, key, *vals):
        """Edit a punctual light's properties (inspector light panel)."""
        li = int(idx)
        v = [float(x) for x in vals]
        val = v if len(v) > 1 else v[0]

        def act(scene):
            lights = scene.model.gltf["extensions"]["KHR_lights_punctual"]["lights"]
            lights[li][key] = val
            from .models.scene import DirtyFlags

            scene.mark_dirty(DirtyFlags.LIGHTS)

        self.undo.execute(SnapshotCommand(action=act, label=f"lightset {li}.{key}"))

    def cmd_anims(self, *a):
        for i, info in enumerate(self.scene.animations):
            print(f"[{i}] {info.name!r} t={info.current_time:.3f} "
                  f"range=[{info.start:.3f},{info.end:.3f}] channels={len(info.channels)}")

    def cmd_anim(self, idx, time):
        """Scrub one animation to TIME seconds — the animation bar's slider
        (ui_animation.cpp), applied Model-primary like the reference."""
        ai, t = int(idx), float(time)

        def act(scene):
            from .models.animation import update_animation

            scene.animations[ai].current_time = t
            update_animation(scene, ai)
            scene.parse_scene()

        self.undo.execute(SnapshotCommand(action=act, label=f"anim {ai}@{t}"))

    def cmd_variants(self, *a):
        from .models.variants import parse_variants

        for i, name in enumerate(parse_variants(self.scene.model)):
            print(f"[{i}] {name}")

    def cmd_variant(self, idx):
        vi = int(idx)

        def act(scene):
            from .models.variants import apply_variant

            n = apply_variant(scene, vi)
            print(f"variant {vi}: {n} primitives switched")

        self.undo.execute(SnapshotCommand(action=act, label=f"variant {vi}"))

    def _trs(self, key, node, vals):
        self.undo.execute(TransformCommand(node_id=int(node), key=key, new_value=[float(v) for v in vals]))

    def cmd_translate(self, node, x, y, z):
        self._trs("translation", node, (x, y, z))

    def cmd_scale(self, node, x, y, z):
        self._trs("scale", node, (x, y, z))

    def cmd_rotate(self, node, x, y, z, w):
        self._trs("rotation", node, (x, y, z, w))

    def cmd_rename(self, node, *name):
        nid = int(node)
        new = " ".join(name)

        def act(scene):
            scene.model.nodes[nid]["name"] = new

        self.undo.execute(SnapshotCommand(action=act, label=f"rename {nid}"))

    def cmd_visible(self, node, flag):
        nid, vis = int(node), bool(int(flag))

        def act(scene):
            SceneEditor(scene).set_visibility(nid, vis)

        self.undo.execute(SnapshotCommand(action=act, label=f"visible {nid}={vis}"))

    def cmd_material(self, node, prim, mat):
        nid, pi, mi = int(node), int(prim), int(mat)

        def act(scene):
            SceneEditor(scene).set_material(nid, pi, mi)

        self.undo.execute(SnapshotCommand(action=act, label=f"material {nid}"))

    # Per-field material registry — the full editable set of the reference's
    # inspector material panel (ui_inspector.cpp:875-1680), field name ->
    # (JSON path inside the material dict, arity, type). arity "s" = string,
    # "b" = bool, n = float vector length (1 = scalar).
    MAT_FIELDS = {
        "baseColorFactor": ("pbrMetallicRoughness.baseColorFactor", 4),
        "metallicFactor": ("pbrMetallicRoughness.metallicFactor", 1),
        "roughnessFactor": ("pbrMetallicRoughness.roughnessFactor", 1),
        "diffuseFactor": ("extensions.KHR_materials_pbrSpecularGlossiness.diffuseFactor", 4),
        "specularGlossinessFactor": ("extensions.KHR_materials_pbrSpecularGlossiness.specularFactor", 3),
        "glossinessFactor": ("extensions.KHR_materials_pbrSpecularGlossiness.glossinessFactor", 1),
        "emissiveFactor": ("emissiveFactor", 3),
        "alphaMode": ("alphaMode", "s"),
        "alphaCutoff": ("alphaCutoff", 1),
        "doubleSided": ("doubleSided", "b"),
        "normalScale": ("normalTexture.scale", 1),
        "occlusionStrength": ("occlusionTexture.strength", 1),
        "clearcoatFactor": ("extensions.KHR_materials_clearcoat.clearcoatFactor", 1),
        "clearcoatRoughnessFactor": ("extensions.KHR_materials_clearcoat.clearcoatRoughnessFactor", 1),
        "transmissionFactor": ("extensions.KHR_materials_transmission.transmissionFactor", 1),
        "ior": ("extensions.KHR_materials_ior.ior", 1),
        "emissiveStrength": ("extensions.KHR_materials_emissive_strength.emissiveStrength", 1),
        "iridescenceFactor": ("extensions.KHR_materials_iridescence.iridescenceFactor", 1),
        "iridescenceIor": ("extensions.KHR_materials_iridescence.iridescenceIor", 1),
        "iridescenceThicknessMinimum": ("extensions.KHR_materials_iridescence.iridescenceThicknessMinimum", 1),
        "iridescenceThicknessMaximum": ("extensions.KHR_materials_iridescence.iridescenceThicknessMaximum", 1),
        "sheenColorFactor": ("extensions.KHR_materials_sheen.sheenColorFactor", 3),
        "sheenRoughnessFactor": ("extensions.KHR_materials_sheen.sheenRoughnessFactor", 1),
        "specularFactor": ("extensions.KHR_materials_specular.specularFactor", 1),
        "specularColorFactor": ("extensions.KHR_materials_specular.specularColorFactor", 3),
        "thicknessFactor": ("extensions.KHR_materials_volume.thicknessFactor", 1),
        "attenuationDistance": ("extensions.KHR_materials_volume.attenuationDistance", 1),
        "attenuationColor": ("extensions.KHR_materials_volume.attenuationColor", 3),
        "dispersion": ("extensions.KHR_materials_dispersion.dispersion", 1),
        "anisotropyStrength": ("extensions.KHR_materials_anisotropy.anisotropyStrength", 1),
        "anisotropyRotation": ("extensions.KHR_materials_anisotropy.anisotropyRotation", 1),
        "diffuseTransmissionFactor": ("extensions.KHR_materials_diffuse_transmission.diffuseTransmissionFactor", 1),
        "diffuseTransmissionColorFactor": ("extensions.KHR_materials_diffuse_transmission.diffuseTransmissionColorFactor", 3),
        "unlit": ("extensions.KHR_materials_unlit", "b"),
    }

    def cmd_matfields(self, *a):
        """List every per-field material verb (inspector editable set)."""
        for name, (path, arity) in sorted(self.MAT_FIELDS.items()):
            kind = {"s": "string", "b": "bool"}.get(arity, f"float x{arity}")
            print(f"{name:<32} {kind:<9} -> {path}")

    def cmd_matset(self, mat, key, *vals):
        spec = self.MAT_FIELDS.get(key)
        if spec is None:
            # raw dotted-path escape hatch (all floats), e.g.
            # matset 0 pbrMetallicRoughness.baseColorFactor 1 0 0 1
            v = [float(x) for x in vals]
            path, val = key, (v if len(v) > 1 else v[0])
        else:
            path, arity = spec
            if arity == "s":
                val = vals[0]
            elif arity == "b":
                val = vals[0].lower() in ("1", "true", "yes", "on")
                if key == "unlit":
                    val = {} if val else None  # presence-only extension
            else:
                v = [float(x) for x in vals]
                if len(v) != arity:
                    raise ValueError(f"{key} takes {arity} value(s), got {len(v)}")
                val = v if arity > 1 else v[0]
        if val is None:  # remove (presence-only extension switched off)
            def act(scene):
                obj = scene.model.materials[int(mat)]
                keys = path.split(".")
                for k in keys[:-1]:
                    obj = obj.get(k, {})
                obj.pop(keys[-1], None)
                from .models.scene import DirtyFlags

                scene.mark_dirty(DirtyFlags.MATERIALS)

            self.undo.execute(SnapshotCommand(action=act, label=f"matset {key} off"))
        else:
            self.undo.execute(MaterialCommand(material_id=int(mat), updates={path: val}))

    def cmd_add(self, kind, parent=None):
        p = int(parent) if parent is not None else None

        def act(scene):
            SceneEditor(scene).add_primitive(kind, parent=p)

        self.undo.execute(SnapshotCommand(action=act, label=f"add {kind}"))
        print(f"added {kind} -> node {len(self.scene.model.nodes) - 1}")

    def cmd_light(self, light_type="point", parent=None):
        p = int(parent) if parent is not None else None

        def act(scene):
            SceneEditor(scene).add_light(light_type, parent=p)

        self.undo.execute(SnapshotCommand(action=act, label=f"light {light_type}"))
        print(f"added {light_type} light -> node {len(self.scene.model.nodes) - 1}")

    def cmd_duplicate(self, node):
        nid = int(node)

        def act(scene):
            SceneEditor(scene).duplicate_node(nid)

        self.undo.execute(SnapshotCommand(action=act, label=f"duplicate {nid}"))

    def cmd_delete(self, node):
        nid = int(node)

        def act(scene):
            SceneEditor(scene).delete_node(nid)

        self.undo.execute(SnapshotCommand(action=act, label=f"delete {nid}"))

    def cmd_reparent(self, node, parent):
        nid, p = int(node), int(parent)

        def act(scene):
            SceneEditor(scene).reparent_node(nid, None if p < 0 else p)

        self.undo.execute(SnapshotCommand(action=act, label=f"reparent {nid}->{p}"))

    def cmd_undo(self, *a):
        print("undone" if self.undo.undo() else "nothing to undo")

    def cmd_redo(self, *a):
        print("redone" if self.undo.redo() else "nothing to redo")

    def cmd_save(self, path):
        self.scene.save(path)
        print(f"saved {path}")

    def cmd_render(self, path, w="256", h="256"):
        from .renderer import GltfRenderer, fit_camera
        from .utils.image_io import check_writable

        width, height = int(w), int(h)
        check_writable(path)  # an unknown suffix is bad input (the reference's save raises ValueError for it)
        self._rendering = True
        r = GltfRenderer(width=width, height=height, spp=1, max_depth=3, device=self.device)
        r.scene = self.scene
        # parse first, then fit: the reference fits the bounds of the last parse, so a render
        # after an edit framed the scene as it was before the edit
        r.rebuild_device_scene()
        r.camera = fit_camera(self.scene)
        r.on_render()
        r.save_image(path)
        print(f"rendered {path}")

    def cmd_help(self, *a):
        print(__doc__.split("Commands")[1])

    # ------------------------------------------------------------ shell loop
    def run_line(self, line: str) -> bool:
        line = line.strip()
        if not line or line.startswith("#"):
            return True
        if line in ("quit", "exit", "q"):
            return False
        parts = shlex.split(line)
        fn = getattr(self, "cmd_" + parts[0], None)
        if fn is None:
            print(f"unknown command {parts[0]!r} (try `help`)")
            return True
        self._rendering = False
        try:
            fn(*parts[1:])
        except BAD_INPUT as e:  # keep the shell alive on bad input, not on a failed render
            if self._rendering:
                raise
            print(f"error: {type(e).__name__}: {e}")
        return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="glTF scene editing shell")
    ap.add_argument("scenefile")
    ap.add_argument("-c", "--cmd", action="append", default=[],
                    help="run this command and exit (repeatable)")
    ap.add_argument("--device", type=str, default="cuda", help="torch device of `render` (cuda, cuda:N or cpu)")
    args = ap.parse_args(argv)

    scene = Scene()
    scene.load(args.scenefile)
    sh = EditShell(scene, device=args.device)

    if args.cmd:
        for c in args.cmd:
            if not sh.run_line(c):
                break
        return 0

    interactive = sys.stdin.isatty()
    while True:
        if interactive:
            sys.stdout.write("edit> ")
            sys.stdout.flush()
        line = sys.stdin.readline()
        if not line:
            break
        if not sh.run_line(line):
            break
    return 0


if __name__ == "__main__":
    sys.exit(main())
