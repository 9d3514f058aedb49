"""Profiler, device-memory tracker and frame profiler of the port (reference
vk_gltf_renderer_tpu/utils/profiler.py).

Profiler / SectionStats: named wall-clock sections with rolling averages
(the reference's nvutils::ProfilerManager role). device_memory_stats and
scene_memory_breakdown: the card's memory counters and the bytes of the
renderer's device tables (GpuMemoryTracker).

profile_frames: where a frame's device time goes. One warm-up frame, then
`frames` frames under torch.profiler with the CUDA activity; per frame the
kernel time, the kernel launches and the device busy share (the union of
the kernel intervals over the profiled window's wall clock), and the 15
kernels with the most device time under the names the profiler gives
them. The profiler's host-side cost per operation lengthens the window, so
the busy share it reads is a lower bound of the unprofiled frame's.
profile_refit does the same for an animated renderer's animation step and
scene sync alone (the device refit), one step a frame.

    python -m vk_gltf_renderer_tpu_torch.utils.profiler \
        --scene helmet|terrain|game|suite|materials|foliage|brainstem [--frames 3] [--size W H]

renders the scene at the bench recipe (1920x1080, spp 1, depth 5, the
bench entry's HDR; bench_impl.scene_file, or scenes.make_<scene>_standin
for the material stand-ins and the alpha-tested foliage stand-in at its
16,384 cards, the suite and the materials scene under the sky) on the card
and prints the table. brainstem is BASELINE config 5:
scenes.make_brainstem animated under the sky at 1024x1024, profiled
twice, whole frames and then the refit alone.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, fields

import torch

TOP_KERNELS = 15
_WINDOW = "profile_frames"


@dataclass
class SectionStats:
    count: int = 0
    total_ms: float = 0.0
    min_ms: float = float("inf")
    max_ms: float = 0.0
    ema_ms: float = 0.0

    def add(self, ms: float) -> None:
        self.count += 1
        self.total_ms += ms
        self.min_ms = min(self.min_ms, ms)
        self.max_ms = max(self.max_ms, ms)
        self.ema_ms = ms if self.count == 1 else 0.9 * self.ema_ms + 0.1 * ms

    @property
    def avg_ms(self) -> float:
        return self.total_ms / max(self.count, 1)


class Profiler:
    """Named timing sections; ~zero overhead when disabled."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.sections: dict[str, SectionStats] = defaultdict(SectionStats)

    @contextmanager
    def section(self, name: str, *, sync=None):
        """Time a block. Pass sync=tensor to wait for the card first when
        the tensor lies there: the host clock alone times the enqueue."""
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        yield
        if isinstance(sync, torch.Tensor) and sync.is_cuda:
            torch.cuda.synchronize(sync.device)
        self.sections[name].add((time.perf_counter() - t0) * 1000.0)

    def report(self) -> str:
        lines = [f"{'section':<28}{'count':>7}{'avg ms':>10}{'min':>9}{'max':>9}"]
        for name, st in sorted(self.sections.items()):
            lines.append(f"{name:<28}{st.count:>7}{st.avg_ms:>10.2f}{st.min_ms:>9.2f}{st.max_ms:>9.2f}")
        return "\n".join(lines)

    def as_dict(self) -> dict:
        return {k: {"count": v.count, "avg_ms": v.avg_ms, "min_ms": v.min_ms, "max_ms": v.max_ms}
                for k, v in self.sections.items()}


def device_memory_stats(device="cuda") -> dict:
    """The card's allocator counters (GpuMemoryTracker / BENCHMARK_ADV
    analog); zeros for a CPU device, as the reference reports a device
    without stats."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"bytes_in_use": 0, "peak_bytes_in_use": 0, "bytes_limit": 0}
    stats = torch.cuda.memory_stats(dev)
    return {
        "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
        "bytes_limit": torch.cuda.get_device_properties(dev).total_memory,
    }


def _nbytes(obj) -> dict:
    """Bytes of each tensor field of a dataclass, by field name."""
    out = {}
    for f in fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            out[f.name] = v.numel() * v.element_size()
    return out


def scene_memory_breakdown(renderer) -> dict:
    """Device bytes of the renderer's tables by group (the category-tagged
    tracker, gpu_memory_tracker.hpp): materials and textures of
    convert.DeviceScene, the node tables (bvh) and the triangle and
    hit-attribute tables (geometry) of convert.DeviceBvh, and the
    accumulation buffer."""
    out = {}
    if renderer.dev_scene is not None:
        sizes = _nbytes(renderer.dev_scene)
        out["materials"] = sum(v for k, v in sizes.items() if not k.startswith("tex_"))
        out["textures"] = sum(v for k, v in sizes.items() if k.startswith("tex_"))
    if renderer.dev_bvh is not None:
        sizes = _nbytes(renderer.dev_bvh)
        nodes = {k for k in sizes if k.startswith(("nodes", "lane"))}
        out["geometry"] = sum(v for k, v in sizes.items() if k not in nodes)
        out["bvh"] = sum(sizes[k] for k in nodes)
    if renderer.accum is not None:
        out["framebuffers"] = renderer.accum.numel() * renderer.accum.element_size()
    out["total_tracked"] = sum(out.values())
    return out


def busy_us(intervals, lo, hi) -> float:
    """Length of the union of the (start, duration) intervals inside
    [lo, hi]."""
    total, end = 0.0, lo
    for start, dur in sorted(intervals):
        a, b = max(start, end), min(start + dur, hi)
        if b > a:
            total += b - a
        end = max(end, min(start + dur, hi))
    return total


def summarize_kernels(kernels, window, frames) -> dict:
    """Per-frame summary of the kernel events (name, start us, duration
    us) of a profiled window (start us, duration us) of `frames` frames."""
    lo, dur = window
    by_name = defaultdict(lambda: [0.0, 0])
    for name, _, d in kernels:
        by_name[name][0] += d
        by_name[name][1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP_KERNELS]
    return {
        "frames": frames,
        "wall_ms_per_frame": dur / 1e3 / frames,
        "kernel_ms_per_frame": sum(d for _, _, d in kernels) / 1e3 / frames,
        "launches_per_frame": len(kernels) / frames,
        "busy_share": busy_us([(s, d) for _, s, d in kernels], lo, lo + dur) / dur,
        "top": [{"name": name, "ms_per_frame": us / 1e3 / frames, "launches_per_frame": n / frames}
                for name, (us, n) in top],
    }


def profile_frames(renderer, frames=3) -> dict:
    """Profile `frames` frames of a renderer on the card (after one warm-up
    frame): the summary of summarize_kernels, plus the card's name."""
    return _profile(renderer, renderer.on_render, frames)


def profile_refit(renderer, frames=3) -> dict:
    """profile_frames of the animation step and scene sync alone
    (GltfRenderer.step_animation + sync_scene_changes: the device refit of
    an animated scene), one of each a frame."""
    def step():
        renderer.step_animation()
        renderer.sync_scene_changes()

    return _profile(renderer, step, frames)


def profile_denoise(renderer, frames=3) -> dict:
    """profile_frames of GltfRenderer.image_denoised alone (the SVGF
    à-trous pass and the temporal reprojection over the last frame), one
    call a frame."""
    return _profile(renderer, renderer.image_denoised, frames)


def _profile(renderer, step, frames) -> dict:
    dev = renderer.device
    if dev.type != "cuda":
        raise ValueError(f"the profiler measures the card; the renderer is on {dev}")
    from torch.profiler import ProfilerActivity, profile, record_function

    step()
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(_WINDOW):
            for _ in range(frames):
                step()
            torch.cuda.synchronize(dev)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    window = [e for e in events if e.get("name") == _WINDOW and e.get("cat") == "user_annotation"]
    kernels = [(e["name"], float(e["ts"]), float(e["dur"])) for e in events
               if e.get("cat") == "kernel" and e.get("ph") == "X"]
    if len(window) != 1 or not kernels:
        raise RuntimeError(f"the profiler traced {len(window)} windows and {len(kernels)} kernels "
                           "on the card")
    out = summarize_kernels(kernels, (float(window[0]["ts"]), float(window[0]["dur"])), frames)
    out["device"] = torch.cuda.get_device_name(dev)
    return out


def format_table(summary, title="") -> str:
    """The profile_frames summary as a text table."""
    lines = [f"{title}{summary['frames']} frames on {summary.get('device', '?')}: "
             f"{summary['kernel_ms_per_frame']:.3f} ms of kernels a frame in "
             f"{summary['launches_per_frame']:.1f} launches, wall {summary['wall_ms_per_frame']:.3f} "
             f"ms a frame (profiled), busy share {summary['busy_share']:.4f}",
             f"{'ms/frame':>10} {'launches/frame':>15}  kernel"]
    for k in summary["top"]:
        lines.append(f"{k['ms_per_frame']:>10.4f} {k['launches_per_frame']:>15.1f}  {k['name'][:160]}")
    return "\n".join(lines)


def main(argv=None) -> int:
    from .. import scenes
    from ..bench_impl import DEPTH, SPP, hdr_file, scene_file
    from ..renderer import GltfRenderer

    p = argparse.ArgumentParser(prog="vk_gltf_renderer_tpu_torch.utils.profiler")
    p.add_argument("--scene", choices=("helmet", "terrain", "game", "suite", "materials", "foliage", "brainstem"),
                   required=True)
    p.add_argument("--frames", type=int, default=3)
    p.add_argument("--size", type=int, nargs=2, default=None, metavar=("W", "H"),
                   help="frame size (default 1920 1080; brainstem 1024 1024)")
    args = p.parse_args(argv)
    size = args.size or ([1024, 1024] if args.scene == "brainstem" else [1920, 1080])
    title = f"{args.scene} {size[0]}x{size[1]}: "
    with tempfile.TemporaryDirectory() as d:
        r = GltfRenderer(size[0], size[1], spp=SPP, max_depth=DEPTH, device="cuda")
        if args.scene in ("helmet", "terrain"):
            r.create_scene(scene_file(args.scene, d))
        elif args.scene == "brainstem":
            r.create_scene(scenes.make_brainstem(d))
            r.animate = True
        else:
            r.create_scene(getattr(scenes, f"make_{args.scene}_standin")(d))
        if args.scene not in ("suite", "materials", "brainstem"):  # those render under the sky
            r.create_hdr(hdr_file(d))
        summary = profile_frames(r, args.frames)
        print(format_table(summary, title))
        print(json.dumps(summary))
        if r.animate:
            refit = profile_refit(r, args.frames)
            print(format_table(refit, f"{title}refit (step_animation + sync_scene_changes), "))
            print(json.dumps(refit))
    return 0


if __name__ == "__main__":
    sys.exit(main())
