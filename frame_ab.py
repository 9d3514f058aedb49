"""A/B of the material scenes' frames between two checkouts of the
repository, on one NVIDIA GPU.

    python3 frame_ab.py PARENT_ROOT CHANGE_ROOT [--pairs 1] [--out build/frame_ab.json]

Each side runs in child processes of its own, in the order parent,
change, change, parent (repeated --pairs times), so that both are read
within one call. A child imports chip_smoke.py from its checkout, builds
that checkout's kernels (phase_build), writes the material scenes
(material_scenes) and times every scene of SCENES with
phase_material_frames (2 warm-up + 12 timed frames, each between two
synchronizes); then it profiles 3 frames of each scene with
utils/profiler.profile_frames (kernel ms, launches and busy share a
frame). Every run's ms/frame (mean, min, max), Mrays/s and profile are
printed and written to --out as JSON. A checkout whose chip_smoke.py
lacks a scene of SCENES stops the run.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile

SCENES = ("game", "suite", "lit_game", "materials")
TIMED = 12  # timed frames of each scene and side (chip_smoke.py's own phase 15 takes fewer)
PROFILE_KEYS = ("kernel_ms_per_frame", "launches_per_frame", "wall_ms_per_frame", "busy_share")


def child(root, tag, out):
    """One side's run, in this process, from the checkout at root."""
    sys.path.insert(0, root)
    os.chdir(root)
    import chip_smoke as cs
    from vk_gltf_renderer_tpu_torch.renderer import GltfRenderer
    from vk_gltf_renderer_tpu_torch.utils.profiler import profile_frames

    if not cs.__file__.startswith(root):
        raise SystemExit(f"frame_ab: imported {cs.__file__}, not the checkout at {root}")
    cs.MATERIAL_FRAMES = SCENES
    cs.MATERIAL_TIMED = TIMED
    cs.MATERIAL_PROFILED = ()
    device, smi = cs.phase_device()
    cs.phase_build()
    with tempfile.TemporaryDirectory() as tmp:
        cs.helmet_renderer(tmp, device)  # writes the HDR the material scenes use
        scenes = cs.material_scenes(tmp)
        missing = set(SCENES) - set(scenes)
        if missing:
            raise SystemExit(f"frame_ab: {root}'s chip_smoke.py has no scene {sorted(missing)}")
        frames = cs.phase_material_frames(device, scenes, smi)
        result = {}
        for label in SCENES:
            path, hdr, (w, h) = scenes[label]
            r = GltfRenderer(w, h, spp=cs.SPP, max_depth=cs.DEPTH, device=device)
            r.create_scene(path)
            if hdr is not None:
                r.create_hdr(hdr)
            prof = profile_frames(r, cs.PROFILED_FRAMES)
            del r
            m = frames[label]
            result[label] = dict(ms=m["ms"], min_ms=m["min_ms"], max_ms=m["max_ms"], mrays=m["mrays"],
                                 per_frame=m["per_frame"], profile={k: prof[k] for k in PROFILE_KEYS})
            cs.log(f"[ab] {tag} {label}: {m['ms']:.2f} ms/frame (min {m['min_ms']:.2f}, max {m['max_ms']:.2f}), "
                   f"{m['mrays']:.3f} Mrays/s; profile {result[label]['profile']}")
    with open(out, "w") as f:
        json.dump(dict(tag=tag, root=root, gpu=smi, scenes=result), f)


def main():
    p = argparse.ArgumentParser(prog="frame_ab.py")
    p.add_argument("parent")
    p.add_argument("change")
    p.add_argument("--pairs", type=int, default=1)
    p.add_argument("--out", default=os.path.join("build", "frame_ab.json"))
    if sys.argv[1:2] == ["--child"]:  # frame_ab.py --child ROOT TAG OUT: one side's run
        child(os.path.abspath(sys.argv[2]), sys.argv[3], sys.argv[4])
        return
    args = p.parse_args()
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for _ in range(args.pairs):
            for side in ("parent", "change", "change", "parent"):
                tag = f"{side}{len([r for r in runs if r['tag'].startswith(side)]) + 1}"
                out = os.path.join(tmp, f"{tag}.json")
                subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                                os.path.abspath(getattr(args, side)), tag, out], check=True, timeout=900)
                with open(out) as f:
                    runs.append(json.load(f))
    for label in SCENES:
        print(f"[ab] {label} ms/frame: " + ", ".join(f"{r['tag']} {r['scenes'][label]['ms']:.2f}" for r in runs))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(runs, f, indent=1)
    print(runs[0]["gpu"])


if __name__ == "__main__":
    main()
