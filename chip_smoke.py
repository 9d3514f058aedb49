"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):
  1. device: require CUDA, print the card's name and power limit;
  2. build: compile the port's CUDA kernels from csrc/ (nvcc, sm_90a);
  3. kernels against their plain torch versions on the card, at the main
     path's shapes: BVH4 traversal over ~1M rays of the helmet stand-in
     (camera rays of a 1080p frame at stride 2 plus incoherent rays from
     inside the scene), closest hit and any hit, then the BVH4 variants v5
     (multi-pop), v7 (sidecar) and v8 (leaf queue) on the same rays; the
     HDR gather over 2M indices beside its library call
     (torch.index_select). Times of all versions and the visit counts of
     the bounds are printed;
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
     scene) each of BVH2, BVH16, the lane walk, BVH4 and the BVH4 variants
     v5, v7 and v8 runs closest hit and any hit, timed with CUDA events,
     and is held against its plain version on a fixed subset of 65,536 of
     those rays: ids equal except on equal-t ties, t/u/v within 1e-5,
     occlusion equal, nothing dropped; the visit counts of the bounds are
     printed;
  7. the terrain scene through the entry points at the bench recipe
     (1920x1080, spp 1, depth 5, the synthetic HDR) once per kernel
     selection (VKGR_PRIMARY_KERNEL, VKGR_PACKET_KERNEL) = (v3, v9), (v2, v2),
     (v6, v6), (lane, lane_stream), (v5, v5), (v7, v7), (v3, v8): 2 warm-up
     and 10 timed frames each, the launch counters zeroed just before; each
     run must move its own kernels' counters and no other traversal
     counter, and its frame 0 must agree with the (v3, v9) one at
     tests/test_torch_frame.py's thresholds with the same ray count;
  8. the megakernel A/B (ops/megakernel.py, the reference's
     tools/exp_mega.py): the 2,073,600 camera rays of the 1080p frame 0 on
     the helmet and on the terrain, numpy seeds, depths 1, 2 and 5;
     render_mega (one launch) and render_wavefront (one BVH4 launch per
     bounce + torch glue) timed with CUDA events, ms and Mrays/s (rays x
     depth / ms) printed; the counters are zeroed before the timed runs and
     read after them; mega is held against wavefront on every ray and
     against its plain version on a fixed subset of 65,536 rays.

Bounds (the least time the card could take for the same work, the larger
of bytes / 3.35 TB/s and FLOPs / 67 TFLOP/s, H100 SXM fp32 without tensor
cores): bytes = the distinct table rows the plain version touched on the
rays it walked (a lower bound for the full ray set) times their row bytes,
plus every ray's inputs and outputs; FLOPs = the plain version's visits
scaled to the full ray count, 24 per box test and 55 per triangle test
(plus 20 per ray and bounce of megakernel shading). Plain times include
that visit counting.

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

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

FRAME_W, FRAME_H, SPP, DEPTH = 1920, 1080, 1, 5
WARMUP, TIMED = 2, 10
SRC = "vk_gltf_renderer_tpu_torch/csrc/"
REF = "vk_gltf_renderer_tpu/"
TRAV_SRC = SRC + "traverse_bvh4.cu"
GATHER_SRC = SRC + "gather.cu"
LARGE_TRIS = 1_050_000  # scenes.write_large_glb target: 1,059,968 world triangles
LARGE_WORLD_TRIS = 1_059_968
SUBSET = 65_536  # rays the plain versions walk on the large scene
SELECTIONS = (("v3", "v9"), ("v2", "v2"), ("v6", "v6"), ("lane", "lane_stream"),
              ("v5", "v5"), ("v7", "v7"), ("v3", "v8"))
# kernel value -> its wrapper's name in the JSON line
KERNEL_OF = {"v3": "traverse_bvh4", "v9": "traverse_bvh4", "v2": "traverse_bvh2",
             "v6": "traverse_bvh16", "lane": "traverse_lanes", "lane_stream": "traverse_lanes",
             "v5": "traverse_bvh4_multipop", "v7": "traverse_bvh4_sidecar",
             "v8": "traverse_bvh4_leafqueue"}
BVH4_VARIANTS = ("traverse_bvh4_multipop", "traverse_bvh4_sidecar", "traverse_bvh4_leafqueue")
MEGA_DEPTHS = (1, 2, 5)
# the bound: H100 SXM peak HBM rate and dense FP32 rate, FLOPs per test
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
BOX_FLOPS, TRI_FLOPS, SHADE_FLOPS = 24, 55, 20
RAY_BYTES = (8 + 5) * 4  # 8 f32 ray components in, 5 outputs of 4 bytes out
# wrapper -> (source, file:line of the TPU kernel it replaces, also replaces)
SOURCES = {
    "traverse_bvh4": ("traverse_bvh4.cu", "ops/pallas_traverse.py:951", "ops/pallas_traverse.py:1450"),
    "gather_channels": ("gather.cu", "ops/pallas_gather.py:44", None),
    "traverse_bvh2": ("traverse_bvh2.cu", "ops/pallas_traverse.py:1669", None),
    "traverse_bvh16": ("traverse_bvh16.cu", "ops/pallas_traverse.py:1640", None),
    "traverse_lanes": ("traverse_lanes.cu", "ops/lane_traverse.py:407", "ops/lane_traverse.py:376"),
    "traverse_bvh4_multipop": ("traverse_bvh4_multipop.cu", "ops/pallas_traverse.py:913", None),
    "traverse_bvh4_sidecar": ("traverse_bvh4_sidecar.cu", "ops/pallas_traverse.py:951", None),
    "traverse_bvh4_leafqueue": ("traverse_bvh4_leafqueue.cu", "ops/pallas_traverse.py:1209", None),
    "render_mega": ("megakernel.cu", "ops/megakernel.py:140", None),
}


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
    from vk_gltf_renderer_tpu_torch.ops import (lane_traverse, traverse_bvh2, traverse_bvh4,
                                                traverse_bvh4_leafqueue, traverse_bvh4_multipop,
                                                traverse_bvh4_sidecar, traverse_bvh16)

    return {"traverse_bvh2": traverse_bvh2, "traverse_bvh4": traverse_bvh4,
            "traverse_bvh16": traverse_bvh16, "traverse_lanes": lane_traverse,
            "traverse_bvh4_multipop": traverse_bvh4_multipop,
            "traverse_bvh4_sidecar": traverse_bvh4_sidecar,
            "traverse_bvh4_leafqueue": traverse_bvh4_leafqueue}


def _traversal_runs(bvh):
    """wrapper name -> (kernel call, plain call, arity, bytes of a node row)
    over the 8 ray components, for every traversal kernel whose tables bvh
    (convert.DeviceBvh) holds. The plain calls take stats=."""
    from vk_gltf_renderer_tpu_torch.ops import traverse as tt

    mods = _traversal_modules()
    runs = {}
    tables = {  # name -> (kernel function, plain function, table args, arity, node row bytes)
        "traverse_bvh2": (mods["traverse_bvh2"].traverse_bvh2, tt.traverse_bvh2_plain,
                          (bvh.nodes_fi, bvh.tris128, bvh.root_code), 2, 64),
        "traverse_bvh16": (mods["traverse_bvh16"].traverse_bvh16, tt.traverse_bvh16_plain,
                           (bvh.nodes16_fi, bvh.tris128), 16, 512),
        "traverse_lanes": (mods["traverse_lanes"].traverse_lanes, tt.traverse_lanes_plain,
                           (bvh.lane_entries,), 1, 64),
        "traverse_bvh4": (mods["traverse_bvh4"].traverse_bvh4, tt.traverse_bvh4_plain,
                          (bvh.nodes4_fi, bvh.tris128, bvh.root4_code), 4, 128),
        "traverse_bvh4_multipop": (mods["traverse_bvh4_multipop"].traverse_bvh4_multipop,
                                   tt.traverse_bvh4_multipop_plain,
                                   (bvh.nodes4_fi, bvh.tris128, bvh.root4_code), 4, 128),
        # v7 reads the 96 box bytes of a nodes4_fi row and a 32-byte sidecar row
        "traverse_bvh4_sidecar": (mods["traverse_bvh4_sidecar"].traverse_bvh4_sidecar,
                                  tt.traverse_bvh4_sidecar_plain,
                                  (bvh.nodes4_fi, bvh.nodes4_sc, bvh.tris128, bvh.root4_code), 4, 128),
        "traverse_bvh4_leafqueue": (mods["traverse_bvh4_leafqueue"].traverse_bvh4_leafqueue,
                                    tt.traverse_bvh4_leafqueue_plain,
                                    (bvh.nodes4_fi, bvh.tris128, bvh.root4_code), 4, 128),
    }
    for name, (kern, plain, args, arity, row_bytes) in tables.items():
        if any(a is None for a in args):
            continue
        # the BVH16 kernel takes no root code; its plain version does (0)
        plain_args = args + (0,) if name == "traverse_bvh16" else args
        runs[name] = (lambda *a, anyhit, k=kern, t=args: k(*t, *a, anyhit=anyhit),
                      lambda *a, anyhit, stats=None, f=plain, t=plain_args: f(*t, *a, anyhit=anyhit,
                                                                              stats=stats),
                      arity, row_bytes)
    return runs


def bound(nbytes, flops):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the FLOPs over the fp32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _visits(stats, arity, row_bytes):
    """(table bytes touched, FLOPs, description) of a plain walk's counts."""
    if "entries" in stats:  # the lane walk: one box and one triangle per entry
        rows = int(stats["entry_rows"].sum())
        return (rows * 64, stats["entries"] * (BOX_FLOPS + TRI_FLOPS),
                f"{stats['entries']} entry visits, {rows} distinct entries")
    nodes, leaves = int(stats["node_rows"].sum()), int(stats["leaf_rows"].sum())
    return (nodes * row_bytes + leaves * 512,
            stats["internal"] * arity * BOX_FLOPS + stats["tris"] * TRI_FLOPS,
            f"{stats['internal']} internal + {stats['leaf']} leaf visits, {stats['tris']} "
            f"triangle tests, {nodes} node rows + {leaves} leaf rows touched")


def traversal_bound(stats, arity, row_bytes, n_rays, n_walked):
    """Bound of one launch on n_rays from the plain version's counts on
    n_walked of them: distinct rows as counted, visits scaled."""
    table_bytes, flops, desc = _visits(stats, arity, row_bytes)
    ms, by = bound(table_bytes + n_rays * RAY_BYTES, flops * n_rays / n_walked)
    return ms, by, f"{desc} on {n_walked} rays"


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


def _run_kernels(tag, names, runs, comps, tmin, far, shadow_tmax, sub):
    """Each named kernel closest and any hit on all rays (CUDA events) and
    against its plain version on the rays `sub` (None: all); returns
    name -> numbers, bound included (from the closest-hit visit counts)."""
    mods = _traversal_modules()
    n = comps[0].shape[0]
    n_plain = n if sub is None else sub.shape[0]
    results = {}
    for name in names:
        kern, plain, arity, row_bytes = runs[name]
        mods[name].OVERFLOW.reset()
        res = {"rays": n, "plain_rays": n_plain}
        for anyhit, tmax in ((False, far), (True, shadow_tmax)):
            args = (*comps, tmin, tmax)
            ms = cuda_ms(lambda: kern(*args, anyhit=anyhit), 10)
            sargs = args if sub is None else tuple(a[sub].contiguous() for a in args)
            k = kern(*sargs, anyhit=anyhit)
            stats = None if anyhit else {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p = plain(*sargs, anyhit=anyhit, stats=stats)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            err = _check_against_plain(name, k, p, n_plain, anyhit)
            hit_tag = "anyhit_" if anyhit else ""
            res.update({f"{hit_tag}ms": ms, f"{hit_tag}plain_ms": plain_ms})
            if not anyhit:
                res["max_abs_err"] = err
                res["bound_ms"], res["bound_by"], visits = traversal_bound(stats, arity, row_bytes,
                                                                           n, n_plain)
                log(f"[{tag}] {name} visits (closest hit): {visits}; bound {res['bound_ms']:.4f} ms "
                    f"({res['bound_by']}) for {n} rays")
            log(f"[{tag}] {name} {'any' if anyhit else 'closest'} hit: kernel {ms:.3f} ms for {n} rays "
                f"({n / ms / 1e3:.1f} Mrays/s); plain torch {plain_ms:.1f} ms for {n_plain} rays")
        dropped = mods[name].OVERFLOW.total()
        require(dropped == 0, f"{name}: the kernel dropped {dropped} (stack overflow / bad link)")
        res["overflow"] = dropped
        results[name] = res
    return results


def _all_tables(r, device):
    """Build (host) and upload every optional kernel table of renderer r;
    returns the seconds each host table took."""
    from vk_gltf_renderer_tpu_torch.convert import add_kernel_tables_to_device
    from vk_gltf_renderer_tpu_torch.ops.bvh_flatten import add_kernel_tables

    secs = {}
    for family in ("bvh2", "bvh16", "lane", "bvh4_sidecar", "bvh4_multipop"):
        t0 = time.perf_counter()
        add_kernel_tables(r.bvh, {family})
        add_kernel_tables_to_device(r.dev_bvh, r.bvh, device, {family})
        secs[family] = time.perf_counter() - t0
    return secs


def phase_kernels(device):
    from vk_gltf_renderer_tpu_torch.ops import gather as tgather

    with tempfile.TemporaryDirectory() as tmp:
        r, scene, _ = _helmet(tmp, device)
        r.create_scene(scene)
        _all_tables(r, device)
        bvh = r.dev_bvh
        ro, rd = _probe_rays(r, device)
    n = ro.shape[0]
    comps = [ro[:, i].contiguous() for i in range(3)] + [rd[:, i].contiguous() for i in range(3)]
    tmin = torch.zeros(n, device=device)
    g = torch.Generator(device="cpu").manual_seed(99)
    diag = float((bvh.scene_hi - bvh.scene_lo).norm())
    shadow_tmax = (torch.rand(n, generator=g) * diag).to(device)
    log(f"[kernels] helmet stand-in: {bvh.num_world_tris} world tris, nodes4_fi "
        f"{tuple(bvh.nodes4_fi.shape)}, tris128 {tuple(bvh.tris128.shape)}; {n} rays; stack need "
        f"{bvh.stack_need}")

    # BVH4 and its variants, against their plain versions on all of these rays
    far = torch.full((n,), 1e32, device=device)
    results = _run_kernels("kernels", ("traverse_bvh4",) + BVH4_VARIANTS, _traversal_runs(bvh), comps,
                           tmin, far, shadow_tmax, None)

    gen = torch.Generator(device="cpu").manual_seed(7)
    tab = torch.randn((4, 64 * 128), generator=gen).to(device)
    idx = torch.randint(0, tab.shape[1], (2_000_000,), generator=gen, dtype=torch.int32).to(device)
    out = tgather.gather_channels(tab, idx)
    ref = tab[:, idx.long()]
    require(torch.equal(out, ref), "gather kernel differs from tab[:, idx]")
    require(torch.equal(torch.index_select(tab, 1, idx), ref), "index_select differs from tab[:, idx]")
    g_ms = cuda_ms(lambda: tgather.gather_channels(tab, idx), 50)
    g_plain = cuda_ms(lambda: tgather.gather_channels_plain(tab, idx), 50)
    g_lib = cuda_ms(lambda: torch.index_select(tab, 1, idx), 50)
    g_bound, g_by = bound(tab.numel() * 4 + idx.numel() * 4 + out.numel() * 4, 0)
    log(f"[kernels] gather_channels [4,8192] x 2M: kernel {g_ms:.4f} ms, plain torch {g_plain:.4f} ms, "
        f"torch.index_select {g_lib:.4f} ms, bound {g_bound:.4f} ms ({g_by}), exact")
    results["gather_channels"] = dict(max_abs_err=float((out - ref).abs().max()), ms=g_ms, plain_ms=g_plain,
                                      library_ms=g_lib, bound_ms=g_bound, bound_by=g_by)
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
    from vk_gltf_renderer_tpu_torch.ops.intersect import STACK_CAPACITY

    r, secs = _terrain_renderer(glb, hdr, device, SELECTIONS[0])
    wb = r.bvh
    log(f"[large] terrain: {wb.num_world_tris} world tris; create_scene (flatten, SAH, BVH4, hit rows, "
        f"upload) {secs:.1f} s")
    for family, t in _all_tables(r, device).items():
        log(f"[large] {family} table (host build + upload) in {t:.1f} s")
    bvh = r.dev_bvh
    for name in ("nodes4_fi", "tris128", "nodes_fi", "nodes16_fi", "lane_pages", "nodes4_sc", "hit_attr"):
        a = getattr(wb, name)
        log(f"[large] {name} {tuple(a.shape)} {a.nbytes / 1e6:.1f} MB")
    log(f"[large] root codes: binary {bvh.root_code}, BVH4 {bvh.root4_code}; stack need "
        f"{bvh.stack_need} of capacity {STACK_CAPACITY}")
    require(set(bvh.stack_need) == set(STACK_CAPACITY), f"stack needs {bvh.stack_need}")
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
    names = ("traverse_bvh2", "traverse_bvh16", "traverse_lanes", "traverse_bvh4") + BVH4_VARIANTS
    return _run_kernels("large", names, _traversal_runs(bvh), comps, tmin, far, shadow_tmax, sub)


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


def _camera_rays(r, device):
    """The camera rays of every pixel of frame 0 (pixel centres), [N,3]."""
    from vk_gltf_renderer_tpu_torch.ops.camera import generate_rays

    fr = r._frame_inputs()
    xs, ys = torch.meshgrid(torch.arange(FRAME_W, device=device), torch.arange(FRAME_H, device=device),
                            indexing="xy")
    pos = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1).float()
    return generate_rays(pos, torch.full_like(pos, 0.5),
                         torch.tensor([FRAME_W, FRAME_H], dtype=torch.float32, device=device),
                         fr["proj_inv"], fr["view_inv"])


def phase_megakernel(device, scenes, smi):
    """The megakernel A/B on the camera rays of frame 0 of each scene."""
    from vk_gltf_renderer_tpu_torch.ops import megakernel as mk
    from vk_gltf_renderer_tpu_torch.ops import traverse_bvh4 as tb4

    results = {}
    for label, r in scenes:
        ro, rd = (a.cpu().numpy() for a in _camera_rays(r, device))
        n = ro.shape[0]
        seeds = np.random.default_rng(42).integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
        packed = mk.pack_rays(ro, rd, seeds, device=device)[:3]
        sub = np.sort(np.random.default_rng(6).permutation(n)[:SUBSET])
        sub_packed = mk.pack_rays(ro[sub], rd[sub], seeds[sub], device=device)[:3]
        bvh = r.dev_bvh
        tables = (bvh.nodes4_fi, bvh.tris128)
        for depth in MEGA_DEPTHS:
            def mega(p=packed, d=depth):
                return mk.render_mega(*tables, *p, d, bvh.root4_code)

            def wave(p=packed, d=depth):
                return mk.render_wavefront(*tables, *p, d, bvh.root4_code)

            mk.COUNTER.launches = 0
            tb4.COUNTER.launches = 0
            mk.OVERFLOW.reset()
            tb4.OVERFLOW.reset()
            mega_ms = cuda_ms(mega, 5)
            wave_ms = cuda_ms(wave, 5)
            launches = {"render_mega": mk.COUNTER.launches, "traverse_bvh4": tb4.COUNTER.launches}
            require(launches["render_mega"] == 6 and launches["traverse_bvh4"] == 6 * depth,
                    f"{label} depth {depth}: launches {launches}")
            out_m, out_w = mega(), wave()
            require(mk.OVERFLOW.total() == 0 and tb4.OVERFLOW.total() == 0, "the megakernel dropped pushes")
            # one walk in both arms: equal-t ties resolve alike, so every ray is equal
            differ = int((out_m != out_w).any(dim=1).sum())
            require(differ == 0, f"{label} depth {depth}: mega and wavefront differ on {differ} rays")
            stats = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plain = mk.render_mega_plain(*tables, *sub_packed, depth, bvh.root4_code, stats=stats)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            k = mk.render_mega(*tables, *sub_packed, depth, bvh.root4_code)
            real = torch.arange(k.shape[0] * k.shape[2] * k.shape[3], device=device) < SUBSET
            k, plain = (x.transpose(0, 1).reshape(2, -1)[:, real] for x in (k, plain))
            err = float((k - plain).abs().max())
            require(torch.equal(k[0], plain[0]) and bool(((k[1] - plain[1]).abs()
                                                          <= 1e-5 * (1 + plain[1].abs())).all()),
                    f"{label} depth {depth}: mega and its plain version differ (max err {err})")
            table_bytes, flops, visits = _visits(stats, 4, 128)
            ray_bytes = (4 + 4 + 1 + 2) * 4  # ro, rd, seed in; radiance, t out
            b_ms, b_by = bound(table_bytes + n * ray_bytes, flops * n / SUBSET + n * depth * SHADE_FLOPS)
            rad = out_m[:, 0].reshape(-1)[:n]
            require(bool(torch.isfinite(out_m).all()) and float(rad.max()) > 0, "megakernel output")
            log(f"[mega] {label} depth {depth}, {n} camera rays: render_mega {mega_ms:.3f} ms "
                f"({n * depth / mega_ms / 1e3:.1f} Mrays/s), render_wavefront {wave_ms:.3f} ms "
                f"({n * depth / wave_ms / 1e3:.1f} Mrays/s), wavefront/mega {wave_ms / mega_ms:.2f}x on "
                f"{smi}; equal on every ray; plain {plain_ms:.1f} ms for {SUBSET} rays, max err {err:.3g}; "
                f"visits on the subset {visits}; bound {b_ms:.4f} ms ({b_by}); mean radiance "
                f"{float(rad.mean()):.4f}; launches {launches}")
            results[(label, depth)] = dict(ms=mega_ms, wavefront_ms=wave_ms, plain_ms=plain_ms,
                                           max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
                                           launches=launches["render_mega"], rays=n)
    return results


def _entry(name, launches, nums, **extra):
    """One kernel's object in the kernels JSON line."""
    src, replaces, also = SOURCES[name]
    e = {"name": name, "route": "cuda", "source": SRC + src, "replaces": REF + replaces}
    if also:
        e["also_replaces"] = REF + also
    e["launches"] = launches
    for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by"):
        e[key] = nums[key]
    e["library_ms"] = nums.get("library_ms")
    e.update({k: v for k, v in nums.items() if k not in e})
    e.update(extra)
    return e


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
        require(world == LARGE_WORLD_TRIS, f"terrain has {world} world triangles")
        large = phase_large_kernels(device, glb, hdr)
        log(f"[time] large-scene kernels done at {time.perf_counter() - t_start:.1f} s")
        frames = phase_terrain_frames(device, glb, hdr, smi, tmp)
        log(f"[time] terrain frames done at {time.perf_counter() - t_start:.1f} s")
        helmet, _, _ = _helmet(tmp, device)
        helmet.create_scene(os.path.join(tmp, "helmet.gltf"))
        terrain, _ = _terrain_renderer(glb, hdr, device, SELECTIONS[0])
        mega = phase_megakernel(device, (("helmet", helmet), ("terrain", terrain)), smi)
        log(f"[time] megakernel A/B done at {time.perf_counter() - t_start:.1f} s")

    kernels = [
        _entry("traverse_bvh4", launches["traverse_bvh4"], kern["traverse_bvh4"],
               terrain_launches=frames[SELECTIONS[0]]["launches"]["traverse_bvh4"],
               terrain=large["traverse_bvh4"]),
        _entry("gather_channels", launches["gather_channels"], kern["gather_channels"]),
    ]
    for name, sel in (("traverse_bvh2", ("v2", "v2")), ("traverse_bvh16", ("v6", "v6")),
                      ("traverse_lanes", ("lane", "lane_stream")),
                      ("traverse_bvh4_multipop", ("v5", "v5")), ("traverse_bvh4_sidecar", ("v7", "v7")),
                      ("traverse_bvh4_leafqueue", ("v3", "v8"))):
        extra = {"helmet": kern[name]} if name in BVH4_VARIANTS else {}
        kernels.append(_entry(name, frames[sel]["launches"][name], large[name], **extra))
    kernels.append(_entry("render_mega", mega[("terrain", 5)]["launches"], mega[("terrain", 5)],
                          runs={f"{label},depth{depth}": v for (label, depth), v in mega.items()}))
    terrain = {f"{p},{q}": {"ms_per_frame": frames[(p, q)]["ms"], "mrays_per_s": frames[(p, q)]["mrays"]}
               for p, q in SELECTIONS}
    log(f"[time] total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels, "frame_ms": ms, "mrays_per_s": mrays,
                      "frame": f"{FRAME_W}x{FRAME_H} spp{SPP} depth{DEPTH} helmet stand-in + HDR",
                      "terrain_frames": terrain,
                      "terrain_frame": f"{FRAME_W}x{FRAME_H} spp{SPP} depth{DEPTH} terrain "
                                       f"{LARGE_WORLD_TRIS} tris + HDR"}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
