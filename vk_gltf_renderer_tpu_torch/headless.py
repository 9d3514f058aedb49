"""Headless CLI of the port, flag-compatible with the reference's
(vk_gltf_renderer_tpu/headless.py; upstream main.cpp:99-115 parameter
registration, docs/benchmarking.md recipe):

  python -m vk_gltf_renderer_tpu_torch.headless --headless --size 1920 1080 \\
      --scenefile X.gltf --hdrfile env.hdr --frames 500 --maxFrames 500 \\
      --ptSamples 1 --renderSystem 0 --envSystem 1 --output out.png [--device cuda]

Emits the same machine-readable lines as the reference: a HEADLESS_SUMMARY
human line and a schema-1 BENCHMARK_JSON record. Renders on the card
unless --device names the CPU. Flags of features the port has not ported
raise NotImplementedError naming their ROADMAP item (section A).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

# flag -> (whether its value asks for a feature the port has not ported, the
# ROADMAP item of that feature); the values the reference reads the same way
UNPORTED = {
    "renderSystem": (lambda v: v != 0, "A9 (preview: the rasterizer)"),
    "wireframe": (bool, "A9 (preview: the wireframe overlay)"),
    "upscale": (lambda v: v > 1, "A7 (denoise and TAA upscaling)"),
    "animate": (bool, "A6 (animation and refit)"),
    "infinitePlane": (bool, "A8 (the infinite plane)"),
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="vk_gltf_renderer_tpu_torch", description=__doc__)
    # general (reference main.cpp:99-115)
    p.add_argument("--scenefile", type=str, default=None)
    p.add_argument("--hdrfile", type=str, default=None)
    p.add_argument("--headless", action="store_true")
    p.add_argument("--size", type=int, nargs=2, default=[512, 512], metavar=("W", "H"))
    p.add_argument("--frames", type=int, default=1, help="frames to render in headless mode")
    p.add_argument("--maxFrames", type=int, default=None, help="accumulation limit")
    p.add_argument("--output", type=str, default=None, help="output image path (.png)")
    # rendering
    p.add_argument("--renderSystem", type=int, default=0, help="0=pathtracer 1=rasterizer")
    p.add_argument("--wireframe", type=int, default=0, help="barycentric wireframe overlay (preview)")
    p.add_argument("--envSystem", type=int, default=0, help="0=sky 1=hdr")
    p.add_argument("--envIntensity", type=float, default=1.0)
    p.add_argument("--envRotation", type=float, default=0.0)
    # pathtracer (reference renderer_pathtracer.cpp:116 registerParameters)
    p.add_argument("--ptSamples", type=int, default=1, help="samples per pixel per frame")
    p.add_argument("--ptDepth", type=int, default=5, help="maximum ray depth")
    p.add_argument("--ptFireflyClamp", type=float, default=10.0)
    p.add_argument("--ptAdaptiveSampling", type=int, default=0)
    p.add_argument("--ptAperture", type=float, default=0.0)
    p.add_argument("--ptFocalDistance", type=float, default=0.0)
    # tonemapper
    p.add_argument("--upscale", type=int, default=1,
                   help="render at size/N, TAAU-reconstruct to size (DLSS-RR render-low/display-high role)")
    p.add_argument("--tonemapper", type=str, default="filmic")
    p.add_argument("--backgroundColor", type=float, nargs=3, default=None, help="solid backplate")
    p.add_argument("--infinitePlane", type=int, default=0)
    p.add_argument("--infinitePlaneDistance", type=float, default=0.0)
    p.add_argument("--infinitePlaneShadowCatcher", type=int, default=0)
    p.add_argument("--variant", type=int, default=None, help="KHR_materials_variants index")
    p.add_argument("--animate", type=int, default=0, help="play animations during headless frames")
    p.add_argument("--animation", type=int, default=0, help="animation index to play")
    p.add_argument("--camera", type=float, nargs=9, default=None,
                   metavar=("EX", "EY", "EZ", "CX", "CY", "CZ", "UX", "UY", "UZ"),
                   help="override camera: eye, center, up")
    p.add_argument("--fov", type=float, default=45.0, help="vertical fov (degrees) with --camera")
    # benchmark
    p.add_argument("--benchmark", type=str, default=None, help="benchmark .cfg script")
    p.add_argument("--logLevel", type=int, default=2)
    p.add_argument("--device", type=str, default="cuda", help="torch device (cuda, cuda:N or cpu)")
    return p


def check_ported(args) -> None:
    """Raise NotImplementedError for a flag whose feature is not ported."""
    for flag, (asks, item) in UNPORTED.items():
        if asks(getattr(args, flag)):
            raise NotImplementedError(f"--{flag} {getattr(args, flag)}: not ported (ROADMAP {item})")
    if args.output and not args.output.lower().endswith(".png"):
        raise NotImplementedError(f"--output {args.output}: the port writes PNG only "
                                  "(ROADMAP A12, image codecs)")


def main(argv=None) -> int:
    raw = argv if argv is not None else sys.argv[1:]
    args = build_parser().parse_args(argv)

    # saved-settings overlay, CLI wins (the reference's ImGui-ini handler
    # with the wasParsed CLI-override filter, renderer.cpp:224-254)
    from .utils.settings import apply_saved_settings, remember

    apply_saved_settings(args, raw)
    check_ported(args)

    from .device import synchronize
    from .renderer import GltfRenderer

    w, h = args.size
    r = GltfRenderer(
        width=w,
        height=h,
        spp=args.ptSamples,
        max_depth=args.ptDepth,
        device=args.device,
        env_kind="hdr" if args.envSystem == 1 else "sky",
        tonemapper=args.tonemapper,
    )
    r.firefly_clamp = args.ptFireflyClamp
    r.env_intensity = args.envIntensity
    r.env_rotation = args.envRotation
    r.aperture = args.ptAperture
    r.focal_distance = args.ptFocalDistance
    if args.backgroundColor:
        r.background = tuple(args.backgroundColor)

    if not args.scenefile:
        print("error: --scenefile is required in headless mode", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    r.create_scene(args.scenefile)
    if args.envSystem == 1:
        if not args.hdrfile:
            print("error: --envSystem 1 requires --hdrfile", file=sys.stderr)
            return 2
        r.create_hdr(args.hdrfile)
    if args.variant is not None:
        n = r.set_variant(args.variant)
        print(f"variant {args.variant}: switched {n} primitives")
    if args.camera:
        import numpy as np

        from .renderer import CameraState

        c = args.camera
        r.camera = CameraState(
            eye=np.asarray(c[0:3]), center=np.asarray(c[3:6]), up=np.asarray(c[6:9]),
            yfov=np.radians(args.fov),
        )
        r.reset_frame()
    load_s = time.perf_counter() - t0
    tris = int(sum(p.index_count // 3 for p in r.scene.render_primitives))
    print(f"Loaded {args.scenefile}: {len(r.scene.render_nodes)} render nodes, {tris} triangles ({load_s:.2f}s)")

    frames = args.frames
    max_frames = args.maxFrames or frames
    frames = min(frames, max_frames)

    # warmup frame excluded from timing (reference benchmarking.hpp:128); the
    # timed window opens and closes on a synchronize, so it times the card's
    # work and not its enqueue, and the ray counters are read after it
    r.on_render()
    synchronize(r.device)
    t_start = time.perf_counter()
    aux_list = []
    timed = 0
    for i in range(1, frames):
        if r.total_samples >= max_frames * args.ptSamples:
            break
        aux_list.append(r.on_render())
        timed += 1
        if timed % 50 == 0:
            synchronize(r.device)
            el = time.perf_counter() - t_start
            print(f"  frame {i + 1}/{frames}  {el / max(timed, 1) * 1000:.2f} ms/frame")
    synchronize(r.device)
    wall = time.perf_counter() - t_start
    rays_timed = float(sum(float(a["rays"]) for a in aux_list))

    if args.output:
        r.save_image(args.output)
        print(f"Saved {args.output}")

    if timed > 0:
        ms_per_frame = wall / timed * 1000.0
        msps = (w * h * args.ptSamples * timed) / wall / 1e6
        mrays = rays_timed / wall / 1e6
    else:
        ms_per_frame = msps = mrays = 0.0
    summary = {
        "schema": 1,
        "type": "headless_summary",
        "width": w,
        "height": h,
        "frames": timed,
        "spp": args.ptSamples,
        "wall_ms": wall * 1000.0,
        "ms_per_frame": ms_per_frame,
        "throughput_MSps": msps,
        "spp_per_sec": (args.ptSamples * timed) / wall if timed else 0.0,
        "Mrays_per_sec": mrays,
        "triangles": tris,
        "scene": str(args.scenefile),
        "max_depth": args.ptDepth,
        "env": "hdr" if args.envSystem == 1 else "sky",
        "renderer": args.renderSystem,
    }
    print(
        f"HEADLESS_SUMMARY frames={timed} wall_ms={wall * 1000:.1f} "
        f"ms_per_frame={ms_per_frame:.2f} throughput_MSps={msps:.2f} Mrays_per_sec={mrays:.1f}"
    )
    print("BENCHMARK_JSON " + json.dumps(summary))
    remember(args, args.scenefile)
    return 0


if __name__ == "__main__":
    sys.exit(main())
