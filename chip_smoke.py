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
     holds against the JAX reference;
  6. large-scene kernels: the 1,059,968-triangle terrain scene
     (scenes.write_large_glb) with every kernel table built (shapes, bytes,
     build seconds and stack needs printed); on ~1M rays (camera rays of
     the 1080p frame at stride 2 plus incoherent rays from inside the
     scene) each of BVH2, BVH16, the lane walk and BVH4 runs closest hit
     and any hit, timed with CUDA events, and is held against its plain
     version on a fixed subset of 65,536 of those rays: ids equal except on
     equal-t ties, t/u/v within 1e-5, occlusion equal, nothing dropped;
  7. the terrain scene through the entry points at the bench recipe
     (1920x1080, spp 1, depth 5, the synthetic HDR) once per kernel
     selection (VKGR_PRIMARY_KERNEL, VKGR_PACKET_KERNEL) = (v3, v9), (v2, v2),
     (v6, v6), (lane, lane_stream): 2 warm-up and 10 timed frames each, the
     launch counters zeroed just before; each run must move its own
     kernel's counter and no other traversal counter, and its frame 0 must
     agree with the (v3, v9) one at tests/test_torch_frame.py's thresholds
     with the same ray count.

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
LARGE_TRIS = 1_050_000  # scenes.write_large_glb target: 1,059,968 world triangles
SUBSET = 65_536  # rays the plain versions walk on the large scene
SELECTIONS = (("v3", "v9"), ("v2", "v2"), ("v6", "v6"), ("lane", "lane_stream"))
# kernel value -> its wrapper's name in the JSON line
KERNEL_OF = {"v3": "traverse_bvh4", "v9": "traverse_bvh4", "v2": "traverse_bvh2",
             "v6": "traverse_bvh16", "lane": "traverse_lanes", "lane_stream": "traverse_lanes"}


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


def _traversal_modules():
    from vk_gltf_renderer_tpu_torch.ops import lane_traverse, traverse_bvh2, traverse_bvh4, traverse_bvh16

    return {"traverse_bvh2": traverse_bvh2, "traverse_bvh4": traverse_bvh4,
            "traverse_bvh16": traverse_bvh16, "traverse_lanes": lane_traverse}


def _check_against_plain(name, k, p, n, anyhit):
    """Kernel outputs k against plain outputs p (5 tensors + dropped count)
    on the same n rays; returns max |t,u,v| difference on hits."""
    kt, krn, ktri, ku, kv = k
    pt, prn, ptri, pu, pv, dropped = p
    require(dropped == 0, f"{name}: plain version dropped {dropped}")
    hit = ptri >= 0
    require(torch.equal(ktri >= 0, hit), f"{name} anyhit={anyhit}: kernel and plain disagree on "
            f"hit/miss for {int((ktri >= 0).ne(hit).sum())} rays")
    if anyhit:
        log(f"[kernels] {name} any hit: {int(hit.sum())} occluded, occlusion equal on all {n} rays")
        return 0.0
    same = (ktri == ptri) & (krn == prn)
    tie = (kt - pt).abs() <= 1e-6 * pt.abs()
    require(bool((same | tie | ~hit).all()),
            f"{name}: ids differ beyond equal-t ties on {int((~(same | tie) & hit).sum())} rays")
    both = same & hit
    err = max(float((kt - pt)[hit].abs().max()), float((ku - pu)[both].abs().max()),
              float((kv - pv)[both].abs().max()))
    require(bool(((kt - pt)[hit].abs() <= 1e-5 * (1 + pt[hit].abs())).all()), f"{name}: t beyond 1e-5")
    require(float((ku - pu)[both].abs().max()) <= 1e-5 and float((kv - pv)[both].abs().max()) <= 1e-5,
            f"{name}: u/v beyond 1e-5")
    log(f"[kernels] {name} closest hit: {int(hit.sum())} hits of {n}, ids equal on {int(same.sum())}, "
        f"max |t,u,v err| {err:.3g}")
    return err


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

    tb4.OVERFLOW.reset()
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
    require(tb4.OVERFLOW.total() == 0, f"kernel stack overflows: {tb4.OVERFLOW.total()}")

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
    tb4.OVERFLOW.reset()
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
    overflow = tb4.OVERFLOW.total()
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


def _terrain_renderer(glb, hdr, device, selection):
    from vk_gltf_renderer_tpu_torch.renderer import GltfRenderer

    os.environ["VKGR_PRIMARY_KERNEL"], os.environ["VKGR_PACKET_KERNEL"] = selection
    r = GltfRenderer(FRAME_W, FRAME_H, spp=SPP, max_depth=DEPTH, device=device)
    t0 = time.perf_counter()
    r.create_scene(glb)
    r.create_hdr(hdr)
    return r, time.perf_counter() - t0


def phase_large_kernels(device, glb, hdr):
    """Every traversal kernel against its plain version on the terrain."""
    from vk_gltf_renderer_tpu_torch.convert import add_kernel_tables_to_device
    from vk_gltf_renderer_tpu_torch.ops import traverse as ttrav
    from vk_gltf_renderer_tpu_torch.ops.bvh_flatten import add_kernel_tables
    from vk_gltf_renderer_tpu_torch.ops.intersect import STACK_CAPACITY

    r, secs = _terrain_renderer(glb, hdr, device, SELECTIONS[0])
    wb = r.bvh
    log(f"[large] terrain: {wb.num_world_tris} world tris; create_scene (flatten, SAH, BVH4, hit rows, "
        f"upload) {secs:.1f} s")
    for family in ("bvh2", "bvh16", "lane"):
        t0 = time.perf_counter()
        add_kernel_tables(wb, {family})
        log(f"[large] {family} table built in {time.perf_counter() - t0:.1f} s")
    add_kernel_tables_to_device(r.dev_bvh, wb, device)
    bvh = r.dev_bvh
    for name in ("nodes4_fi", "tris128", "nodes_fi", "nodes16_fi", "lane_pages", "hit_attr"):
        a = getattr(wb, name)
        log(f"[large] {name} {tuple(a.shape)} {a.nbytes / 1e6:.1f} MB")
    log(f"[large] root codes: binary {bvh.root_code}, BVH4 {bvh.root4_code}; stack need "
        f"{bvh.stack_need} of capacity {STACK_CAPACITY}")
    for family, need in bvh.stack_need.items():
        require(need <= STACK_CAPACITY[family], f"{family} tree needs a {need}-entry stack")

    ro, rd = _probe_rays(r, device)
    n = ro.shape[0]
    comps = [ro[:, i].contiguous() for i in range(3)] + [rd[:, i].contiguous() for i in range(3)]
    tmin = torch.zeros(n, device=device)
    g = torch.Generator(device="cpu").manual_seed(99)
    diag = float((bvh.scene_hi - bvh.scene_lo).norm())
    shadow_tmax = (torch.rand(n, generator=g) * diag).to(device)
    far = torch.full((n,), 1e32, device=device)
    sub = torch.randperm(n, generator=torch.Generator(device="cpu").manual_seed(5))[:SUBSET].to(device)
    log(f"[large] {n} rays ({n // 2} camera rays at stride 2, {n - n // 2} incoherent); plain "
        f"versions on a fixed subset of {SUBSET}")

    mods = _traversal_modules()
    runs = {  # wrapper name -> (kernel call, plain call) on given rays
        "traverse_bvh2": (lambda *a, anyhit: mods["traverse_bvh2"].traverse_bvh2(
            bvh.nodes_fi, bvh.tris128, bvh.root_code, *a, anyhit=anyhit),
            lambda *a, anyhit: ttrav.traverse_bvh2_plain(bvh.nodes_fi, bvh.tris128, bvh.root_code, *a,
                                                         anyhit=anyhit)),
        "traverse_bvh16": (lambda *a, anyhit: mods["traverse_bvh16"].traverse_bvh16(
            bvh.nodes16_fi, bvh.tris128, *a, anyhit=anyhit),
            lambda *a, anyhit: ttrav.traverse_bvh16_plain(bvh.nodes16_fi, bvh.tris128, 0, *a,
                                                          anyhit=anyhit)),
        "traverse_lanes": (lambda *a, anyhit: mods["traverse_lanes"].traverse_lanes(
            bvh.lane_entries, *a, anyhit=anyhit),
            lambda *a, anyhit: ttrav.traverse_lanes_plain(bvh.lane_entries, *a, anyhit=anyhit)),
        "traverse_bvh4": (lambda *a, anyhit: mods["traverse_bvh4"].traverse_bvh4(
            bvh.nodes4_fi, bvh.tris128, bvh.root4_code, *a, anyhit=anyhit),
            lambda *a, anyhit: ttrav.traverse_bvh4_plain(bvh.nodes4_fi, bvh.tris128, bvh.root4_code, *a,
                                                         anyhit=anyhit)),
    }
    results = {}
    for name, (kern, plain) in runs.items():
        mods[name].OVERFLOW.reset()
        res = {"rays": n}
        for anyhit, tmax in ((False, far), (True, shadow_tmax)):
            args = (*comps, tmin, tmax)
            ms = cuda_ms(lambda: kern(*args, anyhit=anyhit), 10)
            sargs = tuple(a[sub].contiguous() for a in args)
            k = kern(*sargs, anyhit=anyhit)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p = plain(*sargs, anyhit=anyhit)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            err = _check_against_plain(name, k, p, SUBSET, anyhit)
            tag = "anyhit_" if anyhit else ""
            res.update({f"{tag}ms": ms, f"{tag}plain_ms": plain_ms})
            if not anyhit:
                res["max_abs_err"] = err
            log(f"[large] {name} {'any' if anyhit else 'closest'} hit: kernel {ms:.3f} ms for {n} rays "
                f"({n / ms / 1e3:.1f} Mrays/s); plain torch {plain_ms:.1f} ms for {SUBSET} rays")
        dropped = mods[name].OVERFLOW.total()
        require(dropped == 0, f"{name}: the kernel dropped {dropped} (stack overflow / bad link)")
        res["overflow"] = dropped
        results[name] = res
    return results


def phase_terrain_frames(device, glb, hdr, smi, tmp):
    """The terrain at the bench recipe under each kernel selection."""
    from vk_gltf_renderer_tpu_torch.ops import gather as tgather

    mods = _traversal_modules()
    runs = {}
    for selection in SELECTIONS:
        r, secs = _terrain_renderer(glb, hdr, device, selection)
        for m in mods.values():
            m.COUNTER.launches = 0
            m.OVERFLOW.reset()
        tgather.COUNTER.launches = 0
        times, rays = [], []
        first = None
        for i in range(WARMUP + TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            aux = r.on_render()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if i == 0:
                first = (r.image_linear(), aux["first_rnode"].cpu().numpy(),
                         aux["first_tri"].cpu().numpy(), float(aux["rays"]))
            if i >= WARMUP:
                times.append(dt)
                rays.append(float(aux["rays"]))
        launches = {name: m.COUNTER.launches for name, m in mods.items()}
        dropped = {name: m.OVERFLOW.total() for name, m in mods.items()}
        img = r.image_linear()
        r.save_image(os.path.join(tmp, f"terrain_{selection[0]}_{selection[1]}.png"))
        own = {KERNEL_OF[k] for k in selection}
        require(all((launches[name] > 0) == (name in own) for name in launches),
                f"{selection}: traversal launches {launches}, expected only {sorted(own)}")
        require(tgather.COUNTER.launches > 0, "the HDR gather never launched")
        require(not any(dropped.values()), f"{selection}: dropped work {dropped}")
        require(img.shape == (FRAME_H, FRAME_W, 3) and np.isfinite(img).all() and img.mean() > 0.01,
                f"{selection}: image not finite or black")
        ms = 1e3 * float(np.mean(times))
        mrays = float(np.mean(rays)) / float(np.mean(times)) / 1e6
        log(f"[terrain] {selection}: create_scene+create_hdr {secs:.1f} s; {TIMED} frames "
            f"{ms:.2f} ms/frame (min {1e3 * min(times):.2f}, max {1e3 * max(times):.2f}), "
            f"{np.mean(rays):.0f} rays/frame, {mrays:.3f} Mrays/s on {smi}; launches {launches}")
        runs[selection] = dict(ms=ms, mrays=mrays, launches=launches, first=first)

    img_r, rn_r, tri_r, rays_r = runs[SELECTIONS[0]]["first"]
    for selection in SELECTIONS[1:]:
        img, rn, tri, rays = runs[selection]["first"]
        ids = ((rn == rn_r) & (tri == tri_r)).mean()
        close = (np.abs(img - img_r) <= 1e-3 * (1 + np.abs(img_r))).all(-1).mean()
        rel = np.abs(img.mean((0, 1)) - img_r.mean((0, 1))) / np.abs(img_r.mean((0, 1)))
        log(f"[terrain] frame 0 {selection} vs {SELECTIONS[0]}: first-hit ids equal {ids:.6f}, pixels "
            f"within 1e-3 {close:.6f}, channel-mean rel diff {rel.max():.2e}, rays {rays:.0f} vs "
            f"{rays_r:.0f}")
        require(ids >= 0.999 and close >= 0.99 and rel.max() <= 1e-3 and rays == rays_r,
                f"{selection}: frame 0 disagrees with {SELECTIONS[0]}")
    for k in ("VKGR_PRIMARY_KERNEL", "VKGR_PACKET_KERNEL"):
        os.environ.pop(k, None)
    return runs


def main():
    t_start = time.perf_counter()
    device, smi = phase_device()
    phase_build()
    kern = phase_kernels(device)
    with tempfile.TemporaryDirectory() as tmp:
        launches, ms, mrays = phase_main_path(device, tmp, smi)
        phase_correctness(device, tmp)
        log(f"[time] helmet phases done at {time.perf_counter() - t_start:.1f} s")

        from vk_gltf_renderer_tpu_torch.scenes import write_large_glb, write_synthetic_hdr

        glb = os.path.join(tmp, "terrain.glb")
        hdr = write_synthetic_hdr(os.path.join(tmp, "sky.hdr"), 256, 512, seed=0)
        world = write_large_glb(glb, LARGE_TRIS)
        require(world == 1_059_968, f"terrain has {world} world triangles")
        large = phase_large_kernels(device, glb, hdr)
        log(f"[time] large-scene kernels done at {time.perf_counter() - t_start:.1f} s")
        frames = phase_terrain_frames(device, glb, hdr, smi, tmp)
        log(f"[time] terrain frames done at {time.perf_counter() - t_start:.1f} s")

    def large_entry(name):
        e = dict(large[name])
        e.pop("rays")
        return e

    kernels = [
        {"name": "traverse_bvh4", "route": "cuda", "source": TRAV_SRC,
         "replaces": "vk_gltf_renderer_tpu/ops/pallas_traverse.py:951",
         "also_replaces": "vk_gltf_renderer_tpu/ops/pallas_traverse.py:1450",
         "launches": launches["traverse_bvh4"], "max_abs_err": kern["traverse_bvh4"]["max_abs_err"],
         "ms": kern["traverse_bvh4"]["ms"], "plain_ms": kern["traverse_bvh4"]["plain_ms"],
         "anyhit_ms": kern["traverse_bvh4"]["anyhit_ms"], "rays": kern["traverse_bvh4"]["rays"],
         "terrain_launches": frames[SELECTIONS[0]]["launches"]["traverse_bvh4"],
         "terrain": large_entry("traverse_bvh4"), "terrain_rays": large["traverse_bvh4"]["rays"]},
        {"name": "gather_channels", "route": "cuda", "source": GATHER_SRC,
         "replaces": "vk_gltf_renderer_tpu/ops/pallas_gather.py:44",
         "launches": launches["gather_channels"], "max_abs_err": kern["gather_channels"]["max_abs_err"],
         "ms": kern["gather_channels"]["ms"], "plain_ms": kern["gather_channels"]["plain_ms"]},
    ]
    for name, sel, src, replaces, also in (
            ("traverse_bvh2", SELECTIONS[1], "traverse_bvh2.cu", "ops/pallas_traverse.py:1669", None),
            ("traverse_bvh16", SELECTIONS[2], "traverse_bvh16.cu", "ops/pallas_traverse.py:1640", None),
            ("traverse_lanes", SELECTIONS[3], "traverse_lanes.cu", "ops/lane_traverse.py:407",
             "ops/lane_traverse.py:376")):
        e = {"name": name, "route": "cuda", "source": f"vk_gltf_renderer_tpu_torch/csrc/{src}",
             "replaces": f"vk_gltf_renderer_tpu/{replaces}"}
        if also:
            e["also_replaces"] = f"vk_gltf_renderer_tpu/{also}"
        e["launches"] = frames[sel]["launches"][name]
        e.update(large_entry(name))
        e["rays"] = large[name]["rays"]
        e["plain_rays"] = SUBSET
        kernels.append(e)
    terrain = {f"{p},{q}": {"ms_per_frame": frames[(p, q)]["ms"], "mrays_per_s": frames[(p, q)]["mrays"]}
               for p, q in SELECTIONS}
    log(f"[time] total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels, "frame_ms": ms, "mrays_per_s": mrays,
                      "frame": f"{FRAME_W}x{FRAME_H} spp{SPP} depth{DEPTH} helmet stand-in + HDR",
                      "terrain_frames": terrain,
                      "terrain_frame": f"{FRAME_W}x{FRAME_H} spp{SPP} depth{DEPTH} terrain "
                                       f"1059968 tris + HDR"}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
