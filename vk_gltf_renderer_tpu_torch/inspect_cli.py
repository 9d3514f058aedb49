"""Scene inspector CLI — the scripting-first stand-in for the reference's
ImGui UI suite (ui_scene_browser / ui_inspector / statistics windows;
SURVEY.md §7 explicitly allows "CLI/scripting-first instead of ImGui").
The port's copy of vk_gltf_renderer_tpu/inspect_cli.py: host only, it
reads the scene and renders nothing, so it takes no device.

    python -m vk_gltf_renderer_tpu_torch.inspect_cli scene.glb [--tree] [--materials]
        [--stats] [--lights] [--animations] [--validate] [--xmp]
"""

from __future__ import annotations

import argparse
import json
import sys


def print_tree(scene) -> None:
    model = scene.model

    def walk(nid, depth):
        node = model.nodes[nid]
        bits = []
        if "mesh" in node:
            bits.append(f"mesh={node['mesh']}")
        if "camera" in node:
            bits.append("camera")
        if "KHR_lights_punctual" in node.get("extensions", {}):
            bits.append("light")
        vis = node.get("extensions", {}).get("KHR_node_visibility", {}).get("visible", True)
        if not vis:
            bits.append("HIDDEN")
        print("  " * depth + f"[{nid}] {node.get('name', '')} {' '.join(bits)}")
        for c in node.get("children", []):
            walk(c, depth + 1)

    for root in model.scene_roots():
        walk(root, 0)


def print_materials(scene) -> None:
    for i, mat in enumerate(scene.model.materials):
        pbr = mat.get("pbrMetallicRoughness", {})
        exts = sorted(mat.get("extensions", {}).keys())
        print(
            f"[{i}] {mat.get('name', '')}: base={pbr.get('baseColorFactor', [1,1,1,1])} "
            f"metal={pbr.get('metallicFactor', 1)} rough={pbr.get('roughnessFactor', 1)} "
            f"alpha={mat.get('alphaMode', 'OPAQUE')}"
            + (f" ext={','.join(e.replace('KHR_materials_', '') for e in exts)}" if exts else "")
        )


def print_stats(scene) -> None:
    """Statistics window analog (triangles, render nodes, memory)."""
    tris = sum(p.index_count // 3 for p in scene.render_primitives)
    verts = sum(p.vertex_count for p in scene.render_primitives)
    print(f"render nodes:      {len(scene.render_nodes)}")
    print(f"render primitives: {len(scene.render_primitives)}")
    print(f"triangles:         {tris}")
    print(f"vertices:          {verts}")
    print(f"materials:         {len(scene.model.materials)}")
    print(f"textures:          {len(scene.model.textures)}")
    print(f"punctual lights:   {len(scene.render_lights)}")
    print(f"cameras:           {len(scene.render_cameras)}")
    print(f"animations:        {len(scene.animations)}")
    lo, hi = scene.scene_bounds()
    print(f"bounds:            {lo.round(4).tolist()} .. {hi.round(4).tolist()}")
    from .models.materials import detect_scene_features

    feats = sorted(detect_scene_features(scene.model))
    print(f"material features: {', '.join(feats) if feats else '(none)'}")


def print_xmp(scene) -> None:
    """KHR_xmp_json_ld metadata (ui_xmp analog)."""
    g = scene.model.gltf
    packets = g.get("extensions", {}).get("KHR_xmp_json_ld", {}).get("packets", [])
    ref = g.get("asset", {}).get("extensions", {}).get("KHR_xmp_json_ld", {}).get("packet")
    if not packets:
        print("(no XMP metadata)")
        return
    for i, p in enumerate(packets):
        tag = " (asset)" if ref == i else ""
        print(f"packet {i}{tag}:")
        print(json.dumps(p, indent=2)[:2000])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="vk_gltf_renderer_tpu_torch.inspect")
    p.add_argument("scenefile")
    p.add_argument("--tree", action="store_true")
    p.add_argument("--materials", action="store_true")
    p.add_argument("--stats", action="store_true")
    p.add_argument("--lights", action="store_true")
    p.add_argument("--animations", action="store_true")
    p.add_argument("--validate", action="store_true")
    p.add_argument("--xmp", action="store_true")
    args = p.parse_args(argv)

    from .models import Scene

    sc = Scene()
    sc.load(args.scenefile)
    nothing = not any([args.tree, args.materials, args.stats, args.lights, args.animations, args.validate, args.xmp])

    if args.stats or nothing:
        print("== stats ==")
        print_stats(sc)
    if args.tree or nothing:
        print("== scene graph ==")
        print_tree(sc)
    if args.materials or nothing:
        print("== materials ==")
        print_materials(sc)
    if args.lights:
        print("== lights ==")
        for rl in sc.render_lights:
            defs = sc.model.gltf.get("extensions", {}).get("KHR_lights_punctual", {}).get("lights", [])
            ld = defs[rl.light] if rl.light < len(defs) else {}
            print(f"node {rl.node_id}: {ld.get('type')} intensity={ld.get('intensity', 1)} color={ld.get('color', [1,1,1])}")
    if args.animations:
        print("== animations ==")
        for i, a in enumerate(sc.animations):
            print(f"[{i}] {a.name}: {a.start:.2f}..{a.end:.2f}s, {len(a.channels)} channels")
    if args.validate:
        from .models.validator import validate_model

        v = validate_model(sc.model)
        print(f"== validation: {'OK' if v.valid else 'ERRORS'} ==")
        for e in v.errors:
            print("  error:", e)
        for w in v.warnings:
            print("  warn:", w)
        return 0 if v.valid else 1
    if args.xmp:
        print("== XMP ==")
        print_xmp(sc)
    return 0


if __name__ == "__main__":
    sys.exit(main())
