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
     against its plain version on a fixed subset of 65,536 rays;
  9. split-table kernels (the packet4 kernel traverse_bvh4_split and the v1
     kernel traverse_bvh2_split) through ops/intersect.intersect_rays_packet
     (wide=True, v2=False) on the probe rays of phases 3 and 6, on the
     helmet and on the terrain: closest hit timed (kernel alone and through
     the entry point), anyhit=True timed and equal to the closest hit on
     every ray, and each kernel held against its plain version on a fixed
     subset of 65,536 rays as in phase 6; visits, bound, stack need, table
     bytes and upload seconds printed;
 10. VKGR_TRAVERSAL=packet4 through the entry points at the bench recipe on
     the terrain and on the helmet (2 warm-up and 10 timed frames each):
     only traverse_bvh4_split's counter may move among the traversal
     kernels, and frame 0 must agree with the (v3, v9) frame 0 of phases 7
     and 4 at tests/test_torch_frame.py's thresholds with the same ray count;
 11. VKGR_TRAVERSAL=wavefront (the stackless walk in plain torch) on the
     helmet: a 960x540 frame 0 sizes the run (time scaled by pixel count),
     then 1 warm-up and 1 timed frame at the largest of 1920x1080, 960x540
     and 480x270 predicted under 30 s (the sizing frame is the warm-up when
     960x540 is chosen); no traversal kernel may launch, and frame 0 must
     agree with a (v3, v9) frame 0 of the same size;
 12. probes (vk_gltf_renderer_tpu_torch/probes): probe_nodefetch at the TPU
     probe's sizes under all four variant names, then on random-cycle
     tables of the terrain's nodes4_fi size (11 MB, in L2) and of 268 MB
     (past L2), then each table with one warp per block and SM (the
     chain's latency alone); probe_visit variants a, b, c, d, e and q at the TPU probe's
     sizes; each run equal to its plain version, ns per visit printed;
 13. the stream-copy and micro-op probes: probe_stream_dma for every TPU
     variant A-G x copy construct (ld, cp_async, tma) at the TPU probe's
     size (one stream, 48 pages), then at card scale (one stream per SM,
     256 pages each) on tables of 11 MB (in L2) and 268 MB (past L2), each
     run equal to its plain version and, in the regular page order, to
     index_select + sum (its library time); probe_uarch for all 8 micro-ops
     at 20,000 steps, each equal to its plain version run on CPU copies of
     the inputs; ms, us per page, GB/s, ns and SM cycles per step printed.

Bounds (the least time the card could take for the same work, the larger
of bytes / 3.35 TB/s and FLOPs / 67 TFLOP/s, H100 SXM fp32 without tensor
cores): bytes = the distinct table rows the plain version touched on the
rays it walked (a lower bound for the full ray set) times their row bytes,
plus every ray's inputs and outputs; FLOPs = the plain version's visits
scaled to the full ray count, 24 per box test and 55 per triangle test
(plus 20 per ray and bounce of megakernel shading). The split kernels'
leaf rows are the 64-byte rows of tris; a v1 leaf node reads only its
32-byte nodes_i row. The probes: the distinct rows
their chains read plus their inputs and outputs, and 8 FLOPs per lane and
step (node fetch) or 24 per lane and box test (visit). The stream probe:
the distinct pages read plus the output, and one add per element and page
(two in the data-dependent order, its sum). The micro-op probe: its
[8,128] input and output plus the distinct table words (rows of 128 for
dynslice128) it reads, and its float ops per element and step
(UARCH_FLOPS). Plain times include that visit counting.

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

from vk_gltf_renderer_tpu_torch.probes import device_ms  # noqa: E402

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
PT = REF + "ops/pallas_traverse.py:"
# wrapper -> (source, file:line of the TPU kernel it replaces, also replaces)
SOURCES = {
    "traverse_bvh4": ("traverse_bvh4.cu", PT + "951", PT + "1450"),
    "gather_channels": ("gather.cu", REF + "ops/pallas_gather.py:44", None),
    "traverse_bvh2": ("traverse_bvh2.cu", PT + "1669", None),
    "traverse_bvh16": ("traverse_bvh16.cu", PT + "1640", None),
    "traverse_lanes": ("traverse_lanes.cu", REF + "ops/lane_traverse.py:407",
                       REF + "ops/lane_traverse.py:376"),
    "traverse_bvh4_multipop": ("traverse_bvh4_multipop.cu", PT + "913", None),
    "traverse_bvh4_sidecar": ("traverse_bvh4_sidecar.cu", PT + "951", None),
    "traverse_bvh4_leafqueue": ("traverse_bvh4_leafqueue.cu", PT + "1209", None),
    "render_mega": ("megakernel.cu", REF + "ops/megakernel.py:140", None),
    "traverse_bvh4_split": ("traverse_bvh4_split.cu", PT + "1895", None),
    "traverse_bvh2_split": ("traverse_bvh2_split.cu", PT + "1921", None),
    "probe_nodefetch": ("probe_nodefetch.cu", "tools/exp_nodefetch.py:90", None),
    "probe_visit": ("probe_visit.cu", "tools/exp_visit.py:190", None),
    "probe_stream_dma": ("probe_stream_dma.cu", "tools/exp_stream_dma.py:163", None),
    "probe_uarch": ("probe_uarch.cu", "tools/uarch_probe.py:19", None),
}
# split kernel -> (table family, intersect_rays_packet keywords, arity, bytes read of an
# internal node: packet4 96 box bytes of nodes4_f + 32 of nodes4_i, v1 48 of nodes_f + 32 of
# nodes_i; a v1 leaf node reads only its 32-byte nodes_i row, LEAF_NODE_BYTES)
SPLIT = {"traverse_bvh4_split": ("bvh4_split", {"wide": True}, 4, 128),
         "traverse_bvh2_split": ("bvh2_split", {"v2": False}, 2, 80)}
SPLIT_LEAF_BYTES = 64  # one tris row per triangle
LEAF_NODE_BYTES = 32
WAVEFRONT_SIZES = ((1920, 1080), (960, 540), (480, 270))
WAVEFRONT_FRAME_S = 30.0  # the longest wavefront frame the run takes


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


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
    from vk_gltf_renderer_tpu_torch.ops import (lane_traverse, traverse_bvh2, traverse_bvh2_split,
                                                traverse_bvh4, traverse_bvh4_leafqueue,
                                                traverse_bvh4_multipop, traverse_bvh4_sidecar,
                                                traverse_bvh4_split, traverse_bvh16)

    return {"traverse_bvh2": traverse_bvh2, "traverse_bvh4": traverse_bvh4,
            "traverse_bvh16": traverse_bvh16, "traverse_lanes": lane_traverse,
            "traverse_bvh4_multipop": traverse_bvh4_multipop,
            "traverse_bvh4_sidecar": traverse_bvh4_sidecar,
            "traverse_bvh4_leafqueue": traverse_bvh4_leafqueue,
            "traverse_bvh4_split": traverse_bvh4_split,
            "traverse_bvh2_split": traverse_bvh2_split}


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


def _visits(stats, arity, row_bytes, leaf_bytes=512):
    """(table bytes touched, FLOPs, description) of a plain walk's counts;
    leaf_bytes: bytes of one leaf row (a tris128 row, or a tris row)."""
    if "entries" in stats:  # the lane walk: one box and one triangle per entry
        rows = int(stats["entry_rows"].sum())
        return (rows * 64, stats["entries"] * (BOX_FLOPS + TRI_FLOPS),
                f"{stats['entries']} entry visits, {rows} distinct entries")
    nodes, leaves = int(stats["node_rows"].sum()), int(stats["leaf_rows"].sum())
    # the v1 walk's leaf nodes: their nodes_i rows (the other walks code leaves in the parent)
    metas = int(stats["leaf_node_rows"].sum()) if "leaf_node_rows" in stats else 0
    return (nodes * row_bytes + metas * LEAF_NODE_BYTES + leaves * leaf_bytes,
            stats["internal"] * arity * BOX_FLOPS + stats["tris"] * TRI_FLOPS,
            f"{stats['internal']} internal + {stats['leaf']} leaf visits, {stats['tris']} "
            f"triangle tests, {nodes} node rows + {metas} leaf node rows + {leaves} leaf rows "
            "touched")


def traversal_bound(stats, arity, row_bytes, n_rays, n_walked, leaf_bytes=512):
    """Bound of one launch on n_rays from the plain version's counts on
    n_walked of them: distinct rows as counted, visits scaled."""
    table_bytes, flops, desc = _visits(stats, arity, row_bytes, leaf_bytes)
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
            ms = device_ms(lambda: kern(*args, anyhit=anyhit), 10)
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
    for family in ("bvh2", "bvh16", "lane", "bvh4_sidecar", "bvh4_multipop", "bvh4_split",
                   "bvh2_split", "wavefront"):
        t0 = time.perf_counter()
        add_kernel_tables(r.bvh, {family})
        add_kernel_tables_to_device(r.dev_bvh, r.bvh, device, {family})
        torch.cuda.synchronize()
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
    g_ms = device_ms(lambda: tgather.gather_channels(tab, idx), 50)
    g_plain = device_ms(lambda: tgather.gather_channels_plain(tab, idx), 50)
    g_lib = device_ms(lambda: torch.index_select(tab, 1, idx), 50)
    g_bound, g_by = bound(tab.numel() * 4 + idx.numel() * 4 + out.numel() * 4, 0)
    log(f"[kernels] gather_channels [4,8192] x 2M: kernel {g_ms:.4f} ms, plain torch {g_plain:.4f} ms, "
        f"torch.index_select {g_lib:.4f} ms, bound {g_bound:.4f} ms ({g_by}), exact")
    results["gather_channels"] = dict(max_abs_err=float((out - ref).abs().max()), ms=g_ms, plain_ms=g_plain,
                                      library_ms=g_lib, bound_ms=g_bound, bound_by=g_by)
    return results, r, (ro, rd)


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
    times, rays, first = _render_frames(r, WARMUP, TIMED)
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
    return launches, ms, mrays, first


def _render_frames(r, warmup, timed):
    """warmup + timed frames of renderer r, each between two synchronises;
    returns (seconds and rays of the timed frames, frame 0 as (linear
    image, first-hit rnode, first-hit tri, rays))."""
    times, rays, first = [], [], None
    for i in range(warmup + timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        aux = r.on_render()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if i == 0:
            first = (r.image_linear(), aux["first_rnode"].cpu().numpy(), aux["first_tri"].cpu().numpy(),
                     float(aux["rays"]))
        if i >= warmup:
            times.append(dt)
            rays.append(float(aux["rays"]))
    return times, rays, first


def _require_agree(tag, first, ref):
    """Frame 0 against a reference frame 0 at tests/test_torch_frame.py's
    thresholds, with the same ray count."""
    img, rn, tri, rays = first
    img_r, rn_r, tri_r, rays_r = ref
    ids = ((rn == rn_r) & (tri == tri_r)).mean()
    close = (np.abs(img - img_r) <= 1e-3 * (1 + np.abs(img_r))).all(-1).mean()
    rel = np.abs(img.mean((0, 1)) - img_r.mean((0, 1))) / np.abs(img_r.mean((0, 1)))
    log(f"{tag}: first-hit ids equal {ids:.6f}, pixels within 1e-3 {close:.6f}, channel-mean rel "
        f"diff {rel.max():.2e}, rays {rays:.0f} vs {rays_r:.0f}")
    require(ids >= 0.999 and close >= 0.99 and rel.max() <= 1e-3 and rays == rays_r,
            f"{tag}: frame 0 disagrees")


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
    for name in ("nodes4_fi", "tris128", "nodes_fi", "nodes16_fi", "lane_pages", "nodes4_sc", "hit_attr",
                 "nodes4_f", "nodes4_i", "nodes_f", "nodes_i", "nodes_self", "tris"):
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
    return (_run_kernels("large", names, _traversal_runs(bvh), comps, tmin, far, shadow_tmax, sub), r,
            (ro, rd))


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
        times, rays, first = _render_frames(r, WARMUP, TIMED)
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

    for selection in SELECTIONS[1:]:
        _require_agree(f"[terrain] frame 0 {selection} vs {SELECTIONS[0]}", runs[selection]["first"],
                       runs[SELECTIONS[0]]["first"])
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
            mega_ms = device_ms(mega, 5)
            wave_ms = device_ms(wave, 5)
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


def phase_split_kernels(device, label, r, ro, rd):
    """The packet4 and v1 kernels on renderer r's scene (its split tables
    uploaded by _all_tables) and probe rays ro, rd."""
    from vk_gltf_renderer_tpu_torch.ops import traverse as tt
    from vk_gltf_renderer_tpu_torch.ops.intersect import STACK_CAPACITY, intersect_rays_packet

    bvh = r.dev_bvh
    mods = _traversal_modules()
    n = ro.shape[0]
    comps = [ro[:, i].contiguous() for i in range(3)] + [rd[:, i].contiguous() for i in range(3)]
    tmin = torch.zeros(n, device=device)
    far = torch.full((n,), 1e32, device=device)
    g = torch.Generator(device="cpu").manual_seed(99)
    shadow_tmax = (torch.rand(n, generator=g) * float((bvh.scene_hi - bvh.scene_lo).norm())).to(device)
    sub = torch.randperm(n, generator=torch.Generator(device="cpu").manual_seed(5))[:SUBSET].to(device)
    log(f"[split] {label}: {n} rays, plain versions on a fixed subset of {SUBSET}; tables "
        + ", ".join(f"{k} {tuple(getattr(bvh, k).shape)} {getattr(bvh, k).numel() * 4 / 1e6:.1f} MB"
                    for k in ("nodes4_f", "nodes4_i", "nodes_f", "nodes_i", "tris", "wtri_rnode")))
    kernels = {"traverse_bvh4_split": (tt.traverse_bvh4_split_plain, (bvh.nodes4_f, bvh.nodes4_i, bvh.tris)),
               "traverse_bvh2_split": (tt.traverse_bvh2_split_plain, (bvh.nodes_f, bvh.nodes_i, bvh.tris))}
    results = {}
    for name, (plain, tables) in kernels.items():
        family, kw, arity, row_bytes = SPLIT[name]
        mod = mods[name]
        need, cap = bvh.stack_need[family], STACK_CAPACITY[family]
        require(need <= cap, f"{name}: the tree needs a {need}-entry stack of {cap}")
        mod.OVERFLOW.reset()
        args = (*comps, tmin, far)
        fn = getattr(mod, name)
        ms = device_ms(lambda: fn(*tables, *args), 10)
        entry_ms = device_ms(lambda: intersect_rays_packet(bvh, ro, rd, tmin, far, **kw), 10)
        any_ms = device_ms(lambda: intersect_rays_packet(bvh, ro, rd, tmin, shadow_tmax, anyhit=True, **kw), 10)
        # the entry point's run: one closest-hit and one anyhit=True call
        mod.COUNTER.launches = 0
        closest = intersect_rays_packet(bvh, ro, rd, tmin, shadow_tmax, **kw)
        anyhit = intersect_rays_packet(bvh, ro, rd, tmin, shadow_tmax, anyhit=True, **kw)
        launches = mod.COUNTER.launches
        require(launches == 2, f"{name}: {launches} launches for two intersect_rays_packet calls")
        require(all(torch.equal(closest[k], anyhit[k]) for k in closest),
                f"{name}: anyhit=True differs from the closest hit")
        sargs = tuple(a[sub].contiguous() for a in args)
        k = fn(*tables, *sargs)
        stats = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p = plain(*tables, *sargs, stats=stats)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = _check_against_plain(name, k, p, SUBSET, False)  # ids: tris rows
        require(mod.OVERFLOW.total() == 0, f"{name}: the kernel dropped {mod.OVERFLOW.total()} pushes")
        b_ms, b_by, visits = traversal_bound(stats, arity, row_bytes, n, SUBSET, SPLIT_LEAF_BYTES)
        hits = int((closest["tri"] >= 0).sum())
        log(f"[split] {label} {name}: kernel {ms:.3f} ms closest hit for {n} rays ({n / ms / 1e3:.1f} "
            f"Mrays/s), through intersect_rays_packet {entry_ms:.3f} ms, anyhit=True {any_ms:.3f} ms and "
            f"equal to the closest hit on every ray ({hits} hits within the shadow segments); plain "
            f"{plain_ms:.1f} ms for {SUBSET} rays; stack need {need} of {cap}; visits {visits}; bound "
            f"{b_ms:.4f} ms ({b_by})")
        results[name] = dict(ms=ms, entry_ms=entry_ms, anyhit_ms=any_ms, plain_ms=plain_ms,
                             max_abs_err=err, bound_ms=b_ms, bound_by=b_by, rays=n, plain_rays=SUBSET,
                             stack_need=need, launches=launches)
    return results


def phase_packet4_frames(device, scenes, smi):
    """VKGR_TRAVERSAL=packet4 at the bench recipe; scenes: (label, scene
    path, hdr path, the (v3, v9) frame 0)."""
    from vk_gltf_renderer_tpu_torch.ops import gather as tgather
    from vk_gltf_renderer_tpu_torch.renderer import GltfRenderer

    mods = _traversal_modules()
    runs = {}
    os.environ["VKGR_TRAVERSAL"] = "packet4"
    for label, path, hdr, ref in scenes:
        r = GltfRenderer(FRAME_W, FRAME_H, spp=SPP, max_depth=DEPTH, device=device)
        t0 = time.perf_counter()
        r.create_scene(path)
        r.create_hdr(hdr)
        secs = time.perf_counter() - t0
        for m in mods.values():
            m.COUNTER.launches = 0
            m.OVERFLOW.reset()
        tgather.COUNTER.launches = 0
        times, rays, first = _render_frames(r, WARMUP, TIMED)
        launches = {name: m.COUNTER.launches for name, m in mods.items()}
        dropped = {name: m.OVERFLOW.total() for name, m in mods.items()}
        require(all((v > 0) == (k == "traverse_bvh4_split") for k, v in launches.items()),
                f"packet4 {label}: traversal launches {launches}, expected only traverse_bvh4_split")
        require(tgather.COUNTER.launches > 0, "the HDR gather never launched")
        require(not any(dropped.values()), f"packet4 {label}: dropped work {dropped}")
        img = r.image_linear()
        require(np.isfinite(img).all() and img.mean() > 0.01, f"packet4 {label}: image not finite or black")
        ms = 1e3 * float(np.mean(times))
        mrays = float(np.mean(rays)) / float(np.mean(times)) / 1e6
        log(f"[packet4] {label}: create_scene+create_hdr {secs:.1f} s; {TIMED} frames {ms:.2f} ms/frame "
            f"(min {1e3 * min(times):.2f}, max {1e3 * max(times):.2f}), {np.mean(rays):.0f} rays/frame, "
            f"{mrays:.3f} Mrays/s on {smi}; launches {launches['traverse_bvh4_split']} of "
            f"traverse_bvh4_split, {tgather.COUNTER.launches} of gather_channels")
        _require_agree(f"[packet4] {label} frame 0 vs (v3, v9)", first, ref)
        runs[label] = dict(ms=ms, mrays=mrays, launches=launches["traverse_bvh4_split"])
    os.environ.pop("VKGR_TRAVERSAL")
    return runs


def phase_wavefront_frame(device, path, hdr, smi):
    """VKGR_TRAVERSAL=wavefront on the helmet at the largest size whose
    frame is predicted under WAVEFRONT_FRAME_S from a 960x540 frame (its
    time scaled by pixel count)."""
    from vk_gltf_renderer_tpu_torch.renderer import GltfRenderer

    def renderer(w, h):
        r = GltfRenderer(w, h, spp=SPP, max_depth=DEPTH, device=device)
        r.create_scene(path)
        r.create_hdr(hdr)
        return r

    mods = _traversal_modules()
    for m in mods.values():
        m.COUNTER.launches = 0
    os.environ["VKGR_TRAVERSAL"] = "wavefront"
    w0, h0 = WAVEFRONT_SIZES[1]
    r = renderer(w0, h0)
    (t_size,), _, first = _render_frames(r, 0, 1)
    w, h = next(((w, h) for w, h in WAVEFRONT_SIZES if t_size * w * h / (w0 * h0) <= WAVEFRONT_FRAME_S),
                WAVEFRONT_SIZES[-1])
    log(f"[wavefront] helmet {w0}x{h0} sizing frame {t_size:.2f} s: rendering at {w}x{h}")
    if (w, h) == (w0, h0):  # the sizing frame was the warm-up
        times, rays, _ = _render_frames(r, 0, 1)
    else:
        r = renderer(w, h)
        times, rays, first = _render_frames(r, 1, 1)
    launches = {name: m.COUNTER.launches for name, m in mods.items()}
    os.environ.pop("VKGR_TRAVERSAL")
    require(not any(launches.values()), f"wavefront: traversal kernels launched {launches}")
    img = r.image_linear()
    require(np.isfinite(img).all() and img.mean() > 0.01, "wavefront: image not finite or black")
    log(f"[wavefront] helmet {w}x{h} spp {SPP} depth {DEPTH}: 1 frame {times[0]:.2f} s, {rays[0]:.0f} rays, "
        f"{rays[0] / times[0] / 1e6:.3f} Mrays/s on {smi}; no traversal kernel launched")
    _, _, ref = _render_frames(renderer(w, h), 1, 0)
    _require_agree(f"[wavefront] helmet {w}x{h} frame 0 vs (v3, v9)", first, ref)
    return dict(ms=1e3 * times[0], size=f"{w}x{h}", sizing_s=t_size, mrays=rays[0] / times[0] / 1e6)


def _plain_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_probes(device):
    """The node-fetch and visit probes through their run() entries, then
    every run against its plain version."""
    from vk_gltf_renderer_tpu_torch.probes import nodefetch as nf
    from vk_gltf_renderer_tpu_torch.probes import visit as vs

    nf.COUNTER.launches = 0
    vs.COUNTER.launches = 0
    nf_runs = nf.run(device)
    vs_runs = vs.run(device)
    launches = {"probe_nodefetch": nf.COUNTER.launches, "probe_visit": vs.COUNTER.launches}
    require(all(v > 0 for v in launches.values()), f"a probe never launched: {launches}")
    results = {"probe_nodefetch": {"runs": {}}, "probe_visit": {"runs": {}}}
    for run in nf_runs:
        tab, start, rox = run["inputs"]
        stats = {}
        plain, plain_ms = _plain_ms(lambda: nf.probe_nodefetch_plain(*run["inputs"], run["visits"], stats=stats))
        require(torch.equal(run["out"], plain), f"probe_nodefetch {run['label']}: kernel and plain differ")
        err = float((run["out"].double() - plain.double()).abs().max())
        n = rox.numel()
        rows = int(stats["rows"].sum())
        b_ms, b_by = bound(rows * nf.ROW_BYTES + n * 4 * 2 + start.numel() * 4, n * run["visits"] * 8)
        log(f"[probe] nodefetch {run['label']}: table {tuple(tab.shape)} ({tab.numel() * 4 / 1e6:.1f} MB), "
            f"{start.numel()} chains x {run['visits']} visits in blocks of {run['block']} threads, {rows} "
            f"distinct rows: {run['ms']:.3f} ms, "
            f"{run['ns']:.1f} ns per dependent visit; equal to plain ({plain_ms:.1f} ms); bound "
            f"{b_ms:.4f} ms ({b_by})")
        results["probe_nodefetch"]["runs"][run["label"]] = dict(ms=run["ms"], ns_per_visit=run["ns"],
                                                                plain_ms=plain_ms, max_abs_err=err,
                                                                bound_ms=b_ms, bound_by=b_by)
    for run in vs_runs:
        fi, sc, ro = run["inputs"]
        stats = {}
        plain, plain_ms = _plain_ms(lambda: vs.probe_visit_plain(*run["inputs"], run["visits"], run["variant"],
                                                                 stats=stats))
        require(torch.equal(run["out"], plain), f"probe_visit {run['variant']}: kernel and plain differ")
        err = float((run["out"].double() - plain.double()).abs().max())
        ways = vs.VARIANTS[run["variant"]]
        rows = int(stats["rows"].sum())
        lanes = ro.shape[0] * vs.SUB * vs.LANE
        b_ms, b_by = bound(rows * (128 + 32) + lanes * 4 * (3 + 1),
                           lanes * (run["visits"] // ways) * 4 * BOX_FLOPS)
        log(f"[probe] visit {run['variant']} ({ways} chain(s) per packet, {ro.shape[0]} packets, "
            f"{run['visits']} visits, {rows} distinct rows): {run['ms']:.3f} ms, {run['ns']:.1f} ns per visit, "
            f"{run['ns_step']:.1f} ns per dependent step; equal to plain ({plain_ms:.1f} ms); bound "
            f"{b_ms:.4f} ms ({b_by})")
        results["probe_visit"]["runs"][run["variant"]] = dict(ms=run["ms"], ns_per_visit=run["ns"],
                                                              ns_per_step=run["ns_step"], plain_ms=plain_ms,
                                                              max_abs_err=err, bound_ms=b_ms, bound_by=b_by)
    for name, first in (("probe_nodefetch", "variant a"), ("probe_visit", "a")):
        runs = results[name]["runs"]
        head = runs[first]
        results[name].update(launches=launches[name], library_ms=None,
                             max_abs_err=max(v["max_abs_err"] for v in runs.values()),
                             **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")})
    return results


UARCH_FLOPS = {"empty": 0, "vec1": 2, "gather": 1, "gather12": 13, "reduce": 2, "dynslice": 1,
               "depchain": 2, "dynslice128": 1}  # float ops per element and step
STREAM_HEAD = "C tma TPU size"  # the stream probe's run in the kernels line's own keys


def phase_stream_uarch(device):
    """The stream-copy and micro-op probes through their run() entries,
    then every run against its plain version (the micro-ops' on CPU copies
    of their inputs) and, for the regular page order, against the
    library's index_select + sum."""
    from vk_gltf_renderer_tpu_torch.probes import stream_dma as sd
    from vk_gltf_renderer_tpu_torch.probes import uarch as ua

    sd.COUNTER.launches = 0
    ua.COUNTER.launches = 0
    sd_runs = sd.run(device)
    ua_runs = ua.run(device)
    launches = {"probe_stream_dma": sd.COUNTER.launches, "probe_uarch": ua.COUNTER.launches}
    require(all(v > 0 for v in launches.values()), f"a probe never launched: {launches}")
    results = {"probe_stream_dma": {"runs": {}}, "probe_uarch": {"runs": {}}}
    head = {}
    for run in sd_runs:
        tab, v, blocks, steps = run["tab"], run["variant"], run["blocks"], run["steps"]
        stats = {}
        plain, plain_ms = _plain_ms(lambda: sd.probe_stream_dma_plain(tab, v, blocks, steps, stats=stats))
        require(torch.equal(run["out"], plain), f"probe_stream_dma {run['label']}: kernel and plain differ")
        err = float((run["out"].double() - plain.double()).abs().max())
        f = sd.fields_of(v)
        page_bytes = f * sd.LANE * 4
        dyn, _ = sd.order_of(v)
        pages = int(stats["pages"].sum())
        b_ms, b_by = bound((pages + blocks) * page_bytes, blocks * steps * f * sd.LANE * (2 if dyn else 1))
        lib_ms = None
        if not dyn:
            idx = sd.regular_pages(tab.shape[0] // f, blocks, steps, device).reshape(-1)

            def lib():
                return tab.view(-1, f, sd.LANE).index_select(0, idx).view(blocks, steps, f, sd.LANE).sum(1)

            require(torch.equal(lib().reshape(plain.shape), plain), f"index_select + sum {run['label']} differs")
            lib_ms = device_ms(lib, 5)
        log(f"[stream] {run['label']}: {blocks} x {steps} pages of {page_bytes} B, {pages} distinct: "
            f"{run['ms']:.4f} ms, {run['us_page']:.3f} us per page, {run['gbs']:.1f} GB/s; equal to plain "
            f"({plain_ms:.1f} ms)" + (f" and to index_select + sum ({lib_ms:.4f} ms)" if lib_ms else "")
            + f"; bound {b_ms:.5f} ms ({b_by})")
        # the JSON line keeps [ms, us per page, GB/s, max_abs_err]; plain, bound and library times are in
        # the log line
        results["probe_stream_dma"]["runs"][run["label"]] = [run["ms"], run["us_page"], run["gbs"], err]
        if run["label"] == STREAM_HEAD:
            head = dict(plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
    for run in ua_runs:
        op, (a, b) = run["op"], run["inputs"]
        stats = {}
        t0 = time.perf_counter()
        plain = ua.probe_uarch_plain(op, a.cpu(), b.cpu(), run["iters"], stats=stats)
        plain_ms = (time.perf_counter() - t0) * 1e3
        require(torch.equal(run["out"].cpu(), plain), f"probe_uarch {op}: kernel and plain differ")
        err = float((run["out"].cpu().double() - plain.double()).abs().max())
        row_bytes = b.shape[1] * 4 if op == "dynslice128" else 4  # dynslice reads one word a row
        b_ms, b_by = bound(2 * a.numel() * 4 + stats["rows"] * row_bytes,
                           a.numel() * run["iters"] * UARCH_FLOPS[op])
        log(f"[uarch] {op}: {run['iters']} steps: {run['ms']:.4f} ms, {run['ns']:.2f} ns and "
            f"{run['cycles']:.2f} SM cycles per step ({run['cycles'] / run['ns']:.3f} GHz); equal to plain "
            f"on the CPU ({plain_ms:.0f} ms); bound {b_ms:.6f} ms ({b_by})")
        results["probe_uarch"]["runs"][op] = dict(ms=run["ms"], ns_per_step=run["ns"],
                                                  cycles_per_step=run["cycles"], plain_ms=plain_ms,
                                                  plain_device="cpu", max_abs_err=err, bound_ms=b_ms,
                                                  bound_by=b_by)
    stream = results["probe_stream_dma"]
    stream.update(launches=launches["probe_stream_dma"], headline=STREAM_HEAD,
                  max_abs_err=max(r[3] for r in stream["runs"].values()),
                  ms=stream["runs"][STREAM_HEAD][0], runs_fields=["ms", "us_per_page", "gb_per_s", "max_abs_err"],
                  library="tab.view(-1,F,128).index_select(0, idx).sum over steps", **head)
    uarch = results["probe_uarch"]
    uarch.update(launches=launches["probe_uarch"], headline="depchain", library_ms=None,
                 max_abs_err=max(r["max_abs_err"] for r in uarch["runs"].values()),
                 **{k: uarch["runs"]["depchain"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")})
    return results


def _entry(name, launches, nums, **extra):
    """One kernel's object in the kernels JSON line."""
    src, replaces, also = SOURCES[name]
    e = {"name": name, "route": "cuda", "source": SRC + src, "replaces": replaces}
    if also:
        e["also_replaces"] = also
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
    kern, helmet_r, helmet_rays = phase_kernels(device)
    with tempfile.TemporaryDirectory() as tmp:
        launches, ms, mrays, helmet_first = phase_main_path(device, tmp, smi)
        phase_correctness(device, tmp)
        log(f"[time] helmet phases done at {time.perf_counter() - t_start:.1f} s")

        from vk_gltf_renderer_tpu_torch.scenes import write_large_glb, write_synthetic_hdr

        glb = os.path.join(tmp, "terrain.glb")
        hdr = write_synthetic_hdr(os.path.join(tmp, "sky.hdr"), 256, 512, seed=0)
        world = write_large_glb(glb, LARGE_TRIS)
        require(world == LARGE_WORLD_TRIS, f"terrain has {world} world triangles")
        large, terrain_r, terrain_rays = phase_large_kernels(device, glb, hdr)
        log(f"[time] large-scene kernels done at {time.perf_counter() - t_start:.1f} s")
        frames = phase_terrain_frames(device, glb, hdr, smi, tmp)
        log(f"[time] terrain frames done at {time.perf_counter() - t_start:.1f} s")
        helmet, _, _ = _helmet(tmp, device)
        helmet.create_scene(os.path.join(tmp, "helmet.gltf"))
        terrain, _ = _terrain_renderer(glb, hdr, device, SELECTIONS[0])
        mega = phase_megakernel(device, (("helmet", helmet), ("terrain", terrain)), smi)
        log(f"[time] megakernel A/B done at {time.perf_counter() - t_start:.1f} s")
        split = {"helmet": phase_split_kernels(device, "helmet", helmet_r, *helmet_rays),
                 "terrain": phase_split_kernels(device, "terrain", terrain_r, *terrain_rays)}
        del helmet, terrain, helmet_r, terrain_r
        log(f"[time] split-table kernels done at {time.perf_counter() - t_start:.1f} s")
        helmet_path = os.path.join(tmp, "helmet.gltf")
        packet4 = phase_packet4_frames(device, (("terrain", glb, hdr, frames[SELECTIONS[0]]["first"]),
                                                ("helmet", helmet_path, hdr, helmet_first)), smi)
        log(f"[time] packet4 frames done at {time.perf_counter() - t_start:.1f} s")
        wave = phase_wavefront_frame(device, helmet_path, hdr, smi)
        log(f"[time] wavefront frame done at {time.perf_counter() - t_start:.1f} s")
    probes = phase_probes(device)
    log(f"[time] probes done at {time.perf_counter() - t_start:.1f} s")
    probes.update(phase_stream_uarch(device))
    log(f"[time] stream and micro-op probes done at {time.perf_counter() - t_start:.1f} s")

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
    kernels.append(_entry("traverse_bvh4_split", packet4["terrain"]["launches"],
                          split["terrain"]["traverse_bvh4_split"], helmet=split["helmet"]["traverse_bvh4_split"],
                          helmet_launches=packet4["helmet"]["launches"]))
    # v1 has no renderer path: its launches are those of phase 9's two intersect_rays_packet
    # calls on the terrain
    kernels.append(_entry("traverse_bvh2_split", split["terrain"]["traverse_bvh2_split"]["launches"],
                          split["terrain"]["traverse_bvh2_split"], helmet=split["helmet"]["traverse_bvh2_split"],
                          launches_of="phase 9: intersect_rays_packet(v2=False), closest hit and "
                                      "anyhit=True, on the terrain's probe rays"))
    for name in ("probe_nodefetch", "probe_visit", "probe_stream_dma", "probe_uarch"):
        kernels.append(_entry(name, probes[name]["launches"], probes[name]))
    terrain = {f"{p},{q}": {"ms_per_frame": frames[(p, q)]["ms"], "mrays_per_s": frames[(p, q)]["mrays"]}
               for p, q in SELECTIONS}
    log(f"[time] total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels, "frame_ms": ms, "mrays_per_s": mrays,
                      "frame": f"{FRAME_W}x{FRAME_H} spp{SPP} depth{DEPTH} helmet stand-in + HDR",
                      "terrain_frames": terrain,
                      "packet4_frames": {k: {"ms_per_frame": v["ms"], "mrays_per_s": v["mrays"]}
                                         for k, v in packet4.items()},
                      "wavefront_frame": wave,
                      "terrain_frame": f"{FRAME_W}x{FRAME_H} spp{SPP} depth{DEPTH} terrain "
                                       f"{LARGE_WORLD_TRIS} tris + HDR"}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
