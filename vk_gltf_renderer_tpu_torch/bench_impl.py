"""Bench entry of the port (reference vk_gltf_renderer_tpu/bench_impl.py).

    python -m vk_gltf_renderer_tpu_torch.bench_impl [--device cuda]

Recipe (the reference's, docs/benchmarking.md:16-45): 1920x1080, spp 1,
depth 5, 2 warm-up frames, then 20 timed frames per scene, each between
two torch.cuda.synchronize() calls, so a frame's time is the card's and
not the enqueue's. Reports min/median/max/mean ms and Mrays/s from the
renderer's own `rays` counter (primary + bounce + shadow rays).

Scenes, all made in the repo (nothing is downloaded):
  primary  VKGR_BENCH_SCENE if set; else shader_ball.gltf from
           VKGR_BENCH_RESOURCES when it holds one; else the helmet
           stand-in (scenes.make_helmet_standin)
  second   VKGR_BENCH_SCENE2 ("0" disables it, or a path); else the helmet
           stand-in when the primary is shader_ball, the terrain
           (scenes.write_large_glb, 1,059,968 triangles) otherwise; it runs
           in a child process with a time limit
  HDR      std_env.hdr from VKGR_BENCH_RESOURCES when it holds one; else
           the procedural 256x512 sky of scenes.write_synthetic_hdr, seed 0
           (an HDR in both cases: the HDR path is where gather.cu runs)

Env knobs (the reference's, matrix runs use smaller values for speed):

  VKGR_BENCH_FRAMES          timed frames per scene (default 20)
  VKGR_BENCH_W/H             resolution (default 1920x1080)
  VKGR_BENCH_SCENE2_TIMEOUT  the second scene's time limit, s (default 1200)
  VKGR_BENCH_ONLY_SCENE      measure this one scene and print its JSON (the
                             child's mode)
  VKGR_BENCH_RESOURCES       a directory with the reference's sample assets

The last line is one JSON object {"metric": "Mrays_per_sec", "value",
"unit", "detail"}; the exit code is 2 when the second scene failed.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from .device import synchronize

ROOT = Path(__file__).resolve().parent.parent
SPP, DEPTH, WARMUP = 1, 5, 2
TERRAIN_TRIS, TERRAIN_GRID = 1_050_000, 8


def _resource(name: str) -> str | None:
    base = os.environ.get("VKGR_BENCH_RESOURCES")
    path = Path(base) / name if base else None
    return str(path) if path is not None and path.exists() else None


def scene_file(name: str, directory) -> str:
    """Write the in-repo scene `name` ("helmet" or "terrain") into
    `directory` and return its path."""
    from .scenes import make_helmet_standin, write_large_glb

    if name == "helmet":
        return make_helmet_standin(str(directory))
    if name == "terrain":
        path = os.path.join(directory, "terrain.glb")
        write_large_glb(path, target_tris=TERRAIN_TRIS, grid=TERRAIN_GRID)
        return path
    raise ValueError(f"unknown scene {name!r}")


def hdr_file(directory) -> str:
    """std_env.hdr from VKGR_BENCH_RESOURCES, else the procedural sky
    written into `directory`."""
    from .scenes import write_synthetic_hdr

    return _resource("std_env.hdr") or write_synthetic_hdr(os.path.join(directory, "sky.hdr"), 256, 512,
                                                           seed=0)


def gpu_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _measure(scene_path: str, width: int, height: int, spp: int, depth: int,
             warmup: int, timed_frames: int, *, hdr: str, device="cuda") -> dict:
    from .renderer import GltfRenderer

    r = GltfRenderer(width, height, spp=spp, max_depth=depth, device=device)
    r.create_scene(scene_path)
    r.create_hdr(hdr)
    for _ in range(warmup):
        r.on_render()
    frame_ms, rays = [], []
    for _ in range(timed_frames):
        synchronize(r.device)
        t0 = time.perf_counter()
        aux = r.on_render()
        synchronize(r.device)
        frame_ms.append((time.perf_counter() - t0) * 1000.0)
        rays.append(float(aux["rays"]))

    wall = sum(frame_ms) / 1000.0
    cfg = r._config()
    return {
        "scene": scene_path,
        "mrays": sum(rays) / wall / 1e6,
        "ms_per_frame": wall / timed_frames * 1000.0,
        "ms_min": min(frame_ms),
        "ms_median": statistics.median(frame_ms),
        "ms_max": max(frame_ms),
        "frames": timed_frames,
        "throughput_MSps": width * height * spp * timed_frames / wall / 1e6,
        "rays_per_frame": sum(rays) / timed_frames,
        "triangles": r.dev_bvh.num_world_tris,
        "kernels": {"traversal": cfg.traversal, "primary": cfg.primary_kernel, "packet": cfg.packet_kernel},
        "device": torch.cuda.get_device_name(r.device) if r.device.type == "cuda" else "cpu",
    }


def _measure_subprocess(scene_path: str, device: str, timeout_s: int) -> dict:
    """Measure one scene in a bounded child process, so that a scene that
    hangs or faults becomes an error entry while the primary numbers still
    publish (the reference's guard)."""
    env = dict(os.environ, VKGR_BENCH_ONLY_SCENE=scene_path)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    try:
        proc = subprocess.run([sys.executable, "-m", "vk_gltf_renderer_tpu_torch.bench_impl",
                               "--device", device],
                              env=env, capture_output=True, text=True, timeout=timeout_s)
    except subprocess.TimeoutExpired:
        return {"error": f"scene measurement timed out after {timeout_s}s (hang)"}
    for line in reversed(proc.stdout.splitlines()):
        if line.startswith("{") and '"mrays"' in line:
            return json.loads(line)
    return {"error": f"rc={proc.returncode}: {proc.stderr[-300:]}"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="vk_gltf_renderer_tpu_torch.bench_impl")
    p.add_argument("--device", default="cuda", help="torch device (cuda, cuda:N or cpu)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    width = int(os.environ.get("VKGR_BENCH_W", 1920))
    height = int(os.environ.get("VKGR_BENCH_H", 1080))
    timed_frames = int(os.environ.get("VKGR_BENCH_FRAMES", 20))
    recipe = (width, height, SPP, DEPTH, WARMUP, timed_frames)

    with tempfile.TemporaryDirectory() as d:
        hdr = hdr_file(d)
        only = os.environ.get("VKGR_BENCH_ONLY_SCENE")
        if only:
            print(json.dumps(_measure(only, *recipe, hdr=hdr, device=args.device)))
            return 0

        shader_ball = _resource("shader_ball.gltf")
        scene = os.environ.get("VKGR_BENCH_SCENE") or shader_ball or scene_file("helmet", d)
        primary = _measure(scene, *recipe, hdr=hdr, device=args.device)
        detail = {
            "scene": primary["scene"],
            "resolution": f"{width}x{height}",
            "spp": SPP,
            "max_depth": DEPTH,
            **{k: primary[k] for k in ("ms_per_frame", "ms_min", "ms_median", "ms_max", "frames",
                                       "throughput_MSps", "rays_per_frame", "triangles", "kernels",
                                       "device")},
            "hdr": "std_env.hdr" if _resource("std_env.hdr") else "synthetic 256x512, seed 0",
        }
        if primary["device"] != "cpu":
            detail["gpu"] = gpu_line()

        second = os.environ.get("VKGR_BENCH_SCENE2", "")
        if second != "0":
            if not second:
                second = scene_file("helmet" if scene == shader_ball else "terrain", d)
            detail["scene2"] = _measure_subprocess(
                second, args.device, int(os.environ.get("VKGR_BENCH_SCENE2_TIMEOUT", 1200)))
    result = {"metric": "Mrays_per_sec", "value": primary["mrays"], "unit": "Mrays/s", "detail": detail}
    print(json.dumps(result), flush=True)
    return 2 if "error" in detail.get("scene2", {}) else 0


if __name__ == "__main__":
    sys.exit(main())
