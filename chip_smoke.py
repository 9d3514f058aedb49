"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):
  1. device: require CUDA, print the card's name and power limit;
  2. build: compile the port's CUDA kernels from csrc/ (nvcc, sm_90a);
  3. kernels against their plain torch versions on the card, at the main
     path's shapes: BVH4 traversal over ~1M rays of the helmet stand-in
     (camera rays of a 1080p frame at stride 2 plus incoherent rays from
     inside the scene), closest hit and any hit; the HDR gather over 2M
     indices. Times of both versions are printed;
  4. main path: GltfRenderer(1920, 1080, spp=1, max_depth=5, device="cuda")
     renders the helmet stand-in under a procedural HDR sky through the
     user entry points (create_scene, create_hdr, on_render, image_linear,
     save_image): 2 warm-up and 10 timed frames. The kernels' launch
     counters are zeroed just before and must have moved;
  5. correctness: a small frame on the card (kernels) against the same
     frame from the port's plain CPU path, which tests/test_torch_frame.py
     holds against the JAX reference.

Prints one JSON line of per-kernel numbers, then the card's name and power
limit, then the contract line {"ok": true, "device": {...}} last. Exits
nonzero without CUDA or outside the repository.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# vk_gltf_renderer_tpu/__init__.py imports jax when JAX_PLATFORMS is set;
# the port must never pull jax in
os.environ.pop("JAX_PLATFORMS", None)
ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
# the native SAH builder caches its .so here instead of under $HOME
os.environ.setdefault("VKGR_NATIVE_CACHE", str(ROOT / "build" / "native"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

FRAME_W, FRAME_H, SPP, DEPTH = 1920, 1080, 1, 5
WARMUP, TIMED = 2, 10
TRAV_SRC = "vk_gltf_renderer_tpu_torch/csrc/traverse_bvh4.cu"
GATHER_SRC = "vk_gltf_renderer_tpu_torch/csrc/gather.cu"


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean device time of fn() over reps launches (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def require(cond, msg):
    if not cond:
        raise AssertionError(msg)


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this run needs an NVIDIA GPU")
    smi = nvidia_smi_line()
    log(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    return torch.device("cuda:0"), smi


def phase_build():
    from vk_gltf_renderer_tpu_torch import cuda_lib

    lib = cuda_lib.library()
    log(f"[build] {lib.path.name} built in {lib.build_seconds:.1f} s")
    for line in lib.compiler_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"[build] {line.strip()}")


def _helmet(tmp, device):
    from vk_gltf_renderer_tpu_torch.renderer import GltfRenderer
    from vk_gltf_renderer_tpu_torch.scenes import make_helmet_standin, write_synthetic_hdr

    scene = make_helmet_standin(tmp)
    hdr = write_synthetic_hdr(os.path.join(tmp, "sky.hdr"), 256, 512, seed=0)
    r = GltfRenderer(FRAME_W, FRAME_H, spp=SPP, max_depth=DEPTH, device=device)
    return r, scene, hdr


def _probe_rays(r, device):
    """Camera rays of the 1080p frame at stride 2, plus as many incoherent
    rays from random points inside the scene bounds."""
    from vk_gltf_renderer_tpu_torch.ops.camera import generate_rays

    fr = r._frame_inputs()
    xs, ys = torch.meshgrid(torch.arange(0, FRAME_W, 2, device=device),
                            torch.arange(0, FRAME_H, 2, device=device), indexing="xy")
    pos = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1).float()
    ro_c, rd_c = generate_rays(pos, torch.full_like(pos, 0.5),
                               torch.tensor([FRAME_W, FRAME_H], dtype=torch.float32, device=device),
                               fr["proj_inv"], fr["view_inv"])
    n = pos.shape[0]
    g = torch.Generator(device="cpu").manual_seed(1234)
    lo, hi = r.dev_bvh.scene_lo, r.dev_bvh.scene_hi
    ro_i = lo + torch.rand((n, 3), generator=g).to(device) * (hi - lo)
    rd_i = torch.randn((n, 3), generator=g).to(device)
    rd_i = rd_i / rd_i.norm(dim=1, keepdim=True)
    return torch.cat([ro_c, ro_i]), torch.cat([rd_c, rd_i])


def phase_kernels(device):
    from vk_gltf_renderer_tpu_torch.ops import gather as tgather
    from vk_gltf_renderer_tpu_torch.ops import traverse_bvh4 as tb4
    from vk_gltf_renderer_tpu_torch.ops.traverse import traverse_bvh4_plain

    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        r, scene, _ = _helmet(tmp, device)
        r.create_scene(scene)
        bvh = r.dev_bvh
        ro, rd = _probe_rays(r, device)
    n = ro.shape[0]
    comps = [ro[:, i].contiguous() for i in range(3)] + [rd[:, i].contiguous() for i in range(3)]
    tmin = torch.zeros(n, device=device)
    g = torch.Generator(device="cpu").manual_seed(99)
    diag = float((bvh.scene_hi - bvh.scene_lo).norm())
    shadow_tmax = (torch.rand(n, generator=g) * diag).to(device)
    log(f"[kernels] helmet stand-in: {bvh.num_world_tris} world tris, nodes4_fi "
        f"{tuple(bvh.nodes4_fi.shape)}, tris128 {tuple(bvh.tris128.shape)}; {n} rays")

    tb4.reset_stack_overflows()
    trav = {}
    for anyhit, tmax in ((False, torch.full((n,), 1e32, device=device)), (True, shadow_tmax)):
        args = (bvh.nodes4_fi, bvh.tris128, bvh.root4_code, *comps, tmin, tmax)
        k = tb4.traverse_bvh4(*args, anyhit=anyhit)
        torch.cuda.synchronize()
        p = traverse_bvh4_plain(*args, anyhit=anyhit)
        torch.cuda.synchronize()
        kt, krn, ktri, ku, kv = k
        pt, prn, ptri, pu, pv, dropped = p
        require(dropped == 0, f"plain traversal dropped {dropped} stack pushes")
        hit = ptri >= 0
        require(torch.equal(ktri >= 0, hit), f"anyhit={anyhit}: kernel and plain disagree on hit/miss "
                f"for {int((ktri >= 0).ne(hit).sum())} rays")
        err = 0.0
        if not anyhit:
            same = (ktri == ptri) & (krn == prn)
            tie = (kt - pt).abs() <= 1e-6 * pt.abs()
            require(bool((same | tie | ~hit).all()),
                    f"ids differ beyond equal-t ties on {int((~(same | tie) & hit).sum())} rays")
            both = same & hit
            err = max(float((kt - pt)[hit].abs().max()), float((ku - pu)[both].abs().max()),
                      float((kv - pv)[both].abs().max()))
            require(bool(((kt - pt)[hit].abs() <= 1e-5 * (1 + pt[hit].abs())).all()), "t beyond 1e-5")
            require(float((ku - pu)[both].abs().max()) <= 1e-5 and float((kv - pv)[both].abs().max()) <= 1e-5,
                    "u/v beyond 1e-5")
            log(f"[kernels] closest hit: {int(hit.sum())} hits, ids equal on {int(same.sum())}, "
                f"max |t,u,v err| {err:.3g}")
        else:
            log(f"[kernels] any hit: {int(hit.sum())} occluded, occlusion equal on all {n} rays")
        trav[anyhit] = (args, err)
    require(tb4.stack_overflows() == 0, f"kernel stack overflows: {tb4.stack_overflows()}")

    args, err = trav[False]
    ms = cuda_ms(lambda: tb4.traverse_bvh4(*args), 20)
    t0 = time.perf_counter()
    traverse_bvh4_plain(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    log(f"[kernels] traverse_bvh4 closest hit, {n} rays: kernel {ms:.3f} ms ({n / ms / 1e3:.1f} Mrays/s), "
        f"plain torch {plain_ms:.1f} ms")
    any_args, _ = trav[True]
    any_ms = cuda_ms(lambda: tb4.traverse_bvh4(*any_args, anyhit=True), 20)
    log(f"[kernels] traverse_bvh4 any hit: kernel {any_ms:.3f} ms ({n / any_ms / 1e3:.1f} Mrays/s)")
    results["traverse_bvh4"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, anyhit_ms=any_ms, rays=n)

    gen = torch.Generator(device="cpu").manual_seed(7)
    tab = torch.randn((4, 64 * 128), generator=gen).to(device)
    idx = torch.randint(0, tab.shape[1], (2_000_000,), generator=gen, dtype=torch.int32).to(device)
    out = tgather.gather_channels(tab, idx)
    ref = tab[:, idx.long()]
    require(torch.equal(out, ref), "gather kernel differs from tab[:, idx]")
    g_ms = cuda_ms(lambda: tgather.gather_channels(tab, idx), 50)
    g_plain = cuda_ms(lambda: tgather.gather_channels_plain(tab, idx), 50)
    log(f"[kernels] gather_channels [4,8192] x 2M: kernel {g_ms:.4f} ms, plain torch {g_plain:.4f} ms, exact")
    results["gather_channels"] = dict(max_abs_err=float((out - ref).abs().max()), ms=g_ms, plain_ms=g_plain)
    return results


def phase_main_path(device, tmp, smi):
    from vk_gltf_renderer_tpu_torch.ops import gather as tgather
    from vk_gltf_renderer_tpu_torch.ops import traverse_bvh4 as tb4

    r, scene, hdr = _helmet(tmp, device)
    tb4.COUNTER.launches = 0
    tgather.COUNTER.launches = 0
    tb4.reset_stack_overflows()
    r.create_scene(scene)
    r.create_hdr(hdr)
    cfg = r._config()
    log(f"[main] {FRAME_W}x{FRAME_H} spp {SPP} depth {DEPTH}, features {sorted(cfg.features)}, env {cfg.env_kind}")
    times, rays = [], []
    for i in range(WARMUP + TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        aux = r.on_render()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if i >= WARMUP:
            times.append(dt)
            rays.append(float(aux["rays"]))
    launches = {"traverse_bvh4": tb4.COUNTER.launches, "gather_channels": tgather.COUNTER.launches}
    overflow = tb4.stack_overflows()
    img = r.image_linear()
    r.save_image(os.path.join(tmp, "helmet_1080p.png"))

    require(r.accum.is_cuda, "accumulation buffer is not on the card")
    require(img.shape == (FRAME_H, FRAME_W, 3) and np.isfinite(img).all(), "image not finite")
    require(img.mean() > 0.01, f"image is black (mean {img.mean()})")
    require(min(rays) > 0, "no rays traced")
    require(all(v > 0 for v in launches.values()), f"a kernel of the path never launched: {launches}")
    require(overflow == 0, f"traversal stack overflowed {overflow} times")
    ms = 1e3 * float(np.mean(times))
    mrays = float(np.mean(rays)) / float(np.mean(times)) / 1e6
    log(f"[main] {TIMED} frames: {ms:.2f} ms/frame (min {1e3 * min(times):.2f}, max {1e3 * max(times):.2f}), "
        f"{np.mean(rays):.0f} rays/frame, {mrays:.3f} Mrays/s on {smi}; "
        f"image mean {img.mean(axis=(0, 1)).round(4).tolist()}")
    log(f"[main] kernel launches over {WARMUP + TIMED} frames: {launches}")
    return launches, ms, mrays


def phase_correctness(device, tmp):
    """Kernels on the card vs the plain CPU path on a small frame."""
    from vk_gltf_renderer_tpu_torch.renderer import GltfRenderer

    scene = os.path.join(tmp, "helmet.gltf")
    hdr = os.path.join(tmp, "sky.hdr")
    out = {}
    for dev in (device, "cpu"):
        r = GltfRenderer(96, 64, spp=1, max_depth=DEPTH, device=dev)
        r.create_scene(scene)
        r.create_hdr(hdr)
        aux = r.on_render()
        out[str(dev)] = (r.image_linear(), aux["first_tri"].cpu().numpy(), float(aux["rays"]))
    (img_g, tri_g, rays_g), (img_c, tri_c, rays_c) = out[str(device)], out["cpu"]
    ids = (tri_g == tri_c).mean()
    close = (np.abs(img_g - img_c) <= 1e-3 * (1 + np.abs(img_c))).all(-1).mean()
    rel = np.abs(img_g.mean((0, 1)) - img_c.mean((0, 1))) / np.abs(img_c.mean((0, 1)))
    log(f"[check] 96x64 frame, card vs plain CPU path: first-hit ids equal {ids:.4f}, pixels within "
        f"1e-3 {close:.4f}, channel-mean rel diff {rel.max():.2e}, rays {rays_g:.0f} vs {rays_c:.0f}")
    require(ids >= 0.999 and close >= 0.99 and rel.max() <= 1e-3, "card frame disagrees with the plain path")


def main():
    device, smi = phase_device()
    phase_build()
    kern = phase_kernels(device)
    with tempfile.TemporaryDirectory() as tmp:
        launches, ms, mrays = phase_main_path(device, tmp, smi)
        phase_correctness(device, tmp)
    kernels = [
        {"name": "traverse_bvh4", "route": "cuda", "source": TRAV_SRC,
         "replaces": "vk_gltf_renderer_tpu/ops/pallas_traverse.py:951",
         "also_replaces": "vk_gltf_renderer_tpu/ops/pallas_traverse.py:1450",
         "launches": launches["traverse_bvh4"], "max_abs_err": kern["traverse_bvh4"]["max_abs_err"],
         "ms": kern["traverse_bvh4"]["ms"], "plain_ms": kern["traverse_bvh4"]["plain_ms"],
         "anyhit_ms": kern["traverse_bvh4"]["anyhit_ms"], "rays": kern["traverse_bvh4"]["rays"]},
        {"name": "gather_channels", "route": "cuda", "source": GATHER_SRC,
         "replaces": "vk_gltf_renderer_tpu/ops/pallas_gather.py:44",
         "launches": launches["gather_channels"], "max_abs_err": kern["gather_channels"]["max_abs_err"],
         "ms": kern["gather_channels"]["ms"], "plain_ms": kern["gather_channels"]["plain_ms"]},
    ]
    print(json.dumps({"kernels": kernels, "frame_ms": ms, "mrays_per_s": mrays,
                      "frame": f"{FRAME_W}x{FRAME_H} spp{SPP} depth{DEPTH} helmet stand-in + HDR"}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
