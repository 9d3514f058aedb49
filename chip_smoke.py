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
     the bounds are printed. traverse_bvh4 is also held equal to v7 (the
     same walk over the int32 sidecar) bit for bit on every ray and
     timed beside it in interleaved rounds (phase 6 does the same on the
     terrain), and v5's closest-hit t is held equal to traverse_bvh4's bit
     for bit on every ray (ids, u and v may differ only there: equal-t
     ties, counted), any-hit occlusion equal, both timed in interleaved
     rounds, and so is v8's; the build's registers and spills of the
     instances of the ten kernels on csrc/live_lanes.cuh (the nine that
     compact live lanes, traverse_bvh4.cu, traverse_lanes.cu,
     traverse_bvh4_multipop.cu, traverse_bvh2.cu, traverse_bvh16.cu,
     traverse_bvh4_sidecar.cu, traverse_bvh4_split.cu,
     traverse_bvh4_leafqueue.cu and traverse_bvh2_split.cu, and
     megakernel.cu) are printed and kept in the JSON line;
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
 7b. main-path launch replay: one (v3, v9) 1080p frame of the helmet (HDR)
     and of the terrain through on_render, with ops.intersect.traverse_bvh4
     wrapped to record clones of the 8 ray components of each of its
     launches (10 a frame: closest and shadow per bounce); each launch is
     then run through traverse_bvh4 and through v7 (traverse_bvh4_sidecar,
     the same walk over the sidecar), held equal to v7 bit for bit on every
     lane, timed in interleaved rounds, and held
     against the plain version on a fixed subset of 65,536 lanes (dead
     lanes included); lanes, live lanes, ms of each, the bound and the
     frame sums are printed. Then the same frame under (lane, lane_stream),
     (v5, v5), (v2, v2), (v6, v6) and (v3, v8), recording traverse_lanes',
     traverse_bvh4_multipop's, traverse_bvh2's, traverse_bvh16's and
     traverse_bvh4_leafqueue's launches (v8 takes the 9 after bounce 0's
     closest hit): each timed, against its plain version on a fixed subset,
     with its bound, and v5's, v2's, v6's and v8's beside traverse_bvh4 on
     the same lanes (v5's and v8's closest-hit t bit for bit, ties
     counted, any-hit occlusion equal). The (v2, v2) frames' launches also
     go through v1 (traverse_bvh2_split, which walks the same binary tree
     in the same near-first order over the split tables; closest hit only)
     beside traverse_bvh2: on a closest-hit launch t equal bit for bit on
     every lane and the (rnode, tri) pair after resolution equal except on
     equal-t ties (the lanes that differ are counted), on an any-hit
     launch the occlusion equal; timed in interleaved rounds, held against
     v1's plain version on a fixed subset, with its bound;
  8. the megakernel A/B (ops/megakernel.py, the reference's
     tools/exp_mega.py): the 2,073,600 camera rays of the 1080p frame 0 on
     the helmet and on the terrain, numpy seeds, depths 1, 2 and 5;
     render_mega (one launch) and render_wavefront (one BVH4 launch per
     bounce + torch glue) timed with CUDA events, ms and Mrays/s (rays x
     depth / ms), their ratio and the bound printed; the counters are
     zeroed before the timed runs and read after them; mega is held against
     wavefront on every ray and against its plain version on a fixed subset
     of 65,536 rays, whose paths that ended at each bounce are printed (the
     megakernel's lanes refill by path);
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
     and 4 at tests/test_torch_frame.py's thresholds with the same ray count.
     Then phase 7b's replay of packet4: one more frame with
     ops.intersect.traverse_bvh4_split wrapped to record its 10 launches
     (every one closest hit, the shadow segments too), each timed beside
     traverse_bvh4 on the same lanes (the lanes whose t differs counted),
     held against the plain version on a fixed subset of 65,536 lanes, with
     its bound;
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
 14. front ends, the user's entry points on the card: headless.main on the
     helmet stand-in under the HDR at 1920x1080, 6 frames (5 timed), with
     VKGR_SETTINGS in the run's temp dir: its BENCHMARK_JSON must read 5
     frames, 9,218 triangles and Mrays/s > 0, its PNG must decode with
     utils/png.read_png, and traverse_bvh4 and gather_channels must have
     launched (their counters zeroed just before); `benchmark run` on a
     two-line cfg (helmet and terrain at 512x512, 4 frames) and `compare`
     of its CSV with itself, both rc 0; the bench entry
     (python -m vk_gltf_renderer_tpu_torch.bench_impl) as a child at its
     full recipe, whose JSON line must read value > 0 with no error; and
     utils/profiler.profile_frames on the helmet and the terrain at 1080p
     (3 frames each), both tables printed.

Bounds (the least time the card could take for the same work, the larger
of bytes / 3.35 TB/s and FLOPs / 67 TFLOP/s, H100 SXM fp32 without tensor
cores): bytes = the distinct table rows the plain version touched on the
rays it walked (a lower bound for the full ray set) times their row bytes,
plus every ray's inputs and outputs; FLOPs = the plain version's visits
scaled to the full ray count, 24 per box test and 55 per triangle test
(plus 20 per ray and bounce of megakernel shading); a lane entry is a box
test or a triangle test, as its kind says. A replayed launch's
dead lanes (!(tmax >= 0)) move only their tmax and five outputs (24
bytes): their result does not depend on the rest (the same rule holds for
the lane walk, v5, v2 and v6). The split kernels'
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
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from vk_gltf_renderer_tpu_torch.bench_impl import gpu_line  # noqa: E402
from vk_gltf_renderer_tpu_torch.probes import device_ms  # noqa: E402

FRAME_W, FRAME_H, SPP, DEPTH = 1920, 1080, 1, 5
WARMUP, TIMED = 2, 10
PROFILED_FRAMES = 3  # frames each of phase 14's profiles covers
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
# the kernels with live-lane compaction and a persistent grid (csrc/live_lanes.cuh)
COMPACTING = ("traverse_bvh4.cu", "traverse_lanes.cu", "traverse_bvh4_multipop.cu", "traverse_bvh2.cu",
              "traverse_bvh16.cu", "traverse_bvh4_sidecar.cu", "traverse_bvh4_split.cu",
              "traverse_bvh4_leafqueue.cu", "traverse_bvh2_split.cu")
# the sources whose registers and spills go into the JSON line: those and the megakernel (which
# takes only live_lanes.cuh's persistent grid)
RESOURCES = COMPACTING + ("megakernel.cu",)
# phase 7b's other replays: wrapper -> its kernel selection
REPLAYS = {"traverse_lanes": ("lane", "lane_stream"), "traverse_bvh4_multipop": ("v5", "v5"),
           "traverse_bvh2": ("v2", "v2"), "traverse_bvh16": ("v6", "v6"),
           "traverse_bvh4_leafqueue": ("v3", "v8")}
# table arguments before the 8 ray components of each replayed wrapper
TABLE_ARGS = {"traverse_bvh4": 3, "traverse_lanes": 1, "traverse_bvh4_multipop": 3, "traverse_bvh2": 3,
              "traverse_bvh16": 2, "traverse_bvh4_sidecar": 4, "traverse_bvh4_split": 3,
              "traverse_bvh4_leafqueue": 3}
# replayed wrappers timed beside traverse_bvh4 on the same lanes
BESIDE_BVH4 = ("traverse_bvh4_multipop", "traverse_bvh2", "traverse_bvh16", "traverse_bvh4_leafqueue")
# BVH4 kernels that walk traverse_bvh4's tree in another schedule, so that their closest-hit t
# equals traverse_bvh4's bit for bit: wrapper -> kernel value
SAME_TREE = {"traverse_bvh4_multipop": "v5", "traverse_bvh4_leafqueue": "v8"}
MEGA_DEPTHS = (1, 2, 5)
# the bound: H100 SXM peak HBM rate and dense FP32 rate, FLOPs per test
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
BOX_FLOPS, TRI_FLOPS, SHADE_FLOPS = 24, 55, 20
RAY_BYTES = (8 + 5) * 4  # 8 f32 ray components in, 5 outputs of 4 bytes out
DEAD_RAY_BYTES = (1 + 5) * 4  # a dead lane: tmax in, 5 outputs out
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


def require(cond, msg):
    if not cond:
        raise AssertionError(msg)


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this run needs an NVIDIA GPU")
    smi = gpu_line()
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
    return {src: kernel_resources(lib.compiler_log, src) for src in RESOURCES}


def kernel_resources(compiler_log, source):
    """Registers, spills and shared memory of every kernel instance of
    csrc/<source> (one of RESOURCES), from ptxas -v in the build log:
    instance -> dict. The walk's two instances are "walk closest" and
    "walk any" (v1's one walk, closest hit only, "walk closest"); the
    one-thread-per-lane kernel of bvh4_tuning.GENERIC (a
    tuning variant's walk before the redesign) is "walk (generic)", the
    megakernel "render_mega"."""
    out, name, section = {}, None, None
    for line in compiler_log.splitlines():
        if line.startswith("== "):
            section = line[3:].strip()
            continue
        if section != source:
            continue
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            w = re.search(r"walk_kernel(?:ILb([01])E)?", m.group(1))
            name = f"walk {('closest', 'any')[int(w.group(1) or 0)]}" if w else (
                "compact_lanes" if "compact_lanes" in m.group(1) else
                "render_mega" if "render_mega_kernel" in m.group(1) else
                "walk (generic)" if "traverse_bvh_kernel" in m.group(1) else m.group(1))
            out[name] = {}
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out[name].update(stack_frame=int(m.group(1)), spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            out[name]["smem"] = int(s.group(1)) if s else 0
    for inst, res in out.items():
        log(f"[build] {source} {inst}: {res}")
    return out


def helmet_renderer(tmp, device):
    from vk_gltf_renderer_tpu_torch.renderer import GltfRenderer
    from vk_gltf_renderer_tpu_torch.scenes import make_helmet_standin, write_synthetic_hdr

    scene = make_helmet_standin(tmp)
    hdr = write_synthetic_hdr(os.path.join(tmp, "sky.hdr"), 256, 512, seed=0)
    r = GltfRenderer(FRAME_W, FRAME_H, spp=SPP, max_depth=DEPTH, device=device)
    return r, scene, hdr


def probe_rays(r, device):
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
    if "entries" in stats:  # the lane walk: a box test or a triangle test per entry
        rows = int(stats["entry_rows"].sum())
        return (rows * 64, stats["box_entries"] * BOX_FLOPS + stats["tri_entries"] * TRI_FLOPS,
                f"{stats['entries']} entry visits ({stats['box_entries']} box, {stats['tri_entries']} "
                f"triangle; {stats['plus_one']} to the next entry; load rounds by window "
                f"{stats['rounds']}), {rows} distinct entries")
    nodes, leaves = int(stats["node_rows"].sum()), int(stats["leaf_rows"].sum())
    # the v1 walk's leaf nodes: their nodes_i rows (the other walks code leaves in the parent)
    metas = int(stats["leaf_node_rows"].sum()) if "leaf_node_rows" in stats else 0
    return (nodes * row_bytes + metas * LEAF_NODE_BYTES + leaves * leaf_bytes,
            stats["internal"] * arity * BOX_FLOPS + stats["tris"] * TRI_FLOPS,
            f"{stats['internal']} internal + {stats['leaf']} leaf visits, {stats['tris']} "
            f"triangle tests, {nodes} node rows + {metas} leaf node rows + {leaves} leaf rows "
            "touched")


def traversal_bound(stats, arity, row_bytes, n_rays, n_walked, leaf_bytes=512, n_dead=0):
    """Bound of one launch on n_rays from the plain version's counts on
    n_walked of them: distinct rows as counted, visits scaled. n_dead of
    the rays are dead lanes (!(tmax >= 0) at an internal root): their
    result is (tmax, -1, -1, 0, 0) whatever their other components, so
    they move only DEAD_RAY_BYTES."""
    table_bytes, flops, desc = _visits(stats, arity, row_bytes, leaf_bytes)
    ray_bytes = (n_rays - n_dead) * RAY_BYTES + n_dead * DEAD_RAY_BYTES
    ms, by = bound(table_bytes + ray_bytes, flops * n_rays / n_walked)
    return ms, by, f"{desc} on {n_walked} rays"


OUTPUTS = ("t", "rnode", "tri", "u", "v")


def same_bits(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def _require_bits(what, out, ref):
    """All five outputs equal bit for bit on every lane."""
    differ = [name for name, o, r in zip(OUTPUTS, out, ref) if not same_bits(o, r)]
    require(not differ, f"{what}: {differ} differ from v7's")


def _time_interleaved(calls, reps):
    """Device ms of each call (device_ms over reps), timed in two rounds,
    forward and backward, and averaged, so that no version has the card
    to itself at one end of the run."""
    ms = {k: [] for k in calls}
    for order in (list(calls), list(calls)[::-1]):
        for k in order:
            ms[k].append(device_ms(calls[k], reps))
    return {k: sum(v) / len(v) for k, v in ms.items()}


def _bvh4_vs_v7(bvh, rays, anyhit):
    """traverse_bvh4 and v7 on the same 8 ray components: equal bit for bit
    on every lane, then timed in interleaved rounds. Returns
    {"traverse_bvh4": ms, "v7": ms}."""
    from vk_gltf_renderer_tpu_torch.ops import traverse_bvh4 as tb4
    from vk_gltf_renderer_tpu_torch.ops import traverse_bvh4_sidecar as tbsc

    def v7():
        return tbsc.traverse_bvh4_sidecar(bvh.nodes4_fi, bvh.nodes4_sc, bvh.tris128, bvh.root4_code,
                                          *rays, anyhit=anyhit)

    def new():
        return tb4.traverse_bvh4(bvh.nodes4_fi, bvh.tris128, bvh.root4_code, *rays, anyhit=anyhit)

    _require_bits("traverse_bvh4", new(), v7())
    return _time_interleaved({"traverse_bvh4": new, "v7": v7}, 10)


def _bvh4_probe_vs_v7(tag, bvh, comps, tmin, far, shadow_tmax, resources):
    """traverse_bvh4 beside v7 on the probe rays, closest and any hit
    (bit-equal on every ray); resources: kernel_resources of the build,
    whose walk instances are printed."""
    for hit in ("closest", "any"):
        log(f"[{tag}] traverse_bvh4 walk, {hit} hit: {resources.get(f'walk {hit}', 'not in this build log')}; "
            f"compact_lanes: {resources.get('compact_lanes', 'not in this build log')}")
    res = {}
    for anyhit, tmax in ((False, far), (True, shadow_tmax)):
        times = _bvh4_vs_v7(bvh, (*comps, tmin, tmax), anyhit)
        hit = "any" if anyhit else "closest"
        log(f"[{tag}] traverse_bvh4 {hit} hit on {comps[0].shape[0]} rays, equal to v7 bit for bit: "
            f"{times['traverse_bvh4']:.4f} ms, v7 {times['v7']:.4f} ms "
            f"(v7 / traverse_bvh4 {times['v7'] / times['traverse_bvh4']:.2f}x)")
        res[hit] = times
    return res


def _same_tree_vs_bvh4(name, bvh, rays, anyhit):
    """BVH4 kernel `name` of SAME_TREE (v5, v8) beside traverse_bvh4 on the
    same 8 ray components: closest hit t equal bit for bit on every lane
    (ids, u and v may then differ only at equal-t ties, which are counted),
    any hit occlusion equal; both timed in interleaved rounds. Returns
    {name: ms, "traverse_bvh4": ms, "ties": lanes}."""
    mods = _traversal_modules()
    tables = (bvh.nodes4_fi, bvh.tris128, bvh.root4_code)
    tag = SAME_TREE[name]

    def own():
        return getattr(mods[name], name)(*tables, *rays, anyhit=anyhit)

    def bvh4():
        return mods["traverse_bvh4"].traverse_bvh4(*tables, *rays, anyhit=anyhit)

    out, ref = own(), bvh4()
    require(torch.equal(out[2] >= 0, ref[2] >= 0), f"{tag}: hit or occlusion differs from traverse_bvh4's")
    ties = 0
    if not anyhit:
        require(same_bits(out[0], ref[0]), f"{tag}: t differs from traverse_bvh4's on "
                f"{int((out[0].view(torch.int32) != ref[0].view(torch.int32)).sum())} lanes")
        ties = int(((out[1] != ref[1]) | (out[2] != ref[2]) | (out[3].view(torch.int32) != ref[3].view(torch.int32))
                    | (out[4].view(torch.int32) != ref[4].view(torch.int32))).sum())
    times = _time_interleaved({name: own, "traverse_bvh4": bvh4}, 10)
    return dict(times, ties=ties)


def _same_tree_probe_vs_bvh4(tag, name, bvh, comps, tmin, far, shadow_tmax):
    """_same_tree_vs_bvh4 on the probe rays, closest and any hit."""
    res = {}
    kv = SAME_TREE[name]
    for anyhit, tmax in ((False, far), (True, shadow_tmax)):
        r = _same_tree_vs_bvh4(name, bvh, (*comps, tmin, tmax), anyhit)
        hit = "any" if anyhit else "closest"
        log(f"[{tag}] {kv} {hit} hit on {comps[0].shape[0]} rays: "
            + ("t equal to traverse_bvh4's bit for bit on every lane, ids or u/v differ on "
               f"{r['ties']} (equal-t ties)" if not anyhit else "occlusion equal to traverse_bvh4's")
            + f"; {kv} {r[name]:.4f} ms, traverse_bvh4 {r['traverse_bvh4']:.4f} ms "
            f"({kv} / traverse_bvh4 {r[name] / r['traverse_bvh4']:.2f}x)")
        res[hit] = r
    return res


def _beside_bvh4(bvh, name, kern, rays, anyhit):
    """Kernel `name` (BVH2 or BVH16, another tree than traverse_bvh4's)
    beside traverse_bvh4 on the same 8 ray components, timed in
    interleaved rounds. Returns {name: ms, "traverse_bvh4": ms,
    "t_differs": lanes}: the lanes whose t bits differ, which only an
    equal-t tie or a leaf box that one tree's t_best culls at its face can
    make."""
    from vk_gltf_renderer_tpu_torch.ops import traverse_bvh4 as tb4

    def bvh4():
        return tb4.traverse_bvh4(bvh.nodes4_fi, bvh.tris128, bvh.root4_code, *rays, anyhit=anyhit)

    def own():
        return kern(*rays, anyhit=anyhit)

    out, ref = own(), bvh4()
    differs = int((out[0].view(torch.int32) != ref[0].view(torch.int32)).sum())
    return dict(_time_interleaved({name: own, "traverse_bvh4": bvh4}, 10), t_differs=differs)


def _v1_beside_v2(device, bvh, rays, anyhit, k):
    """v1 (traverse_bvh2_split, closest hit only) on one replayed launch of
    traverse_bvh2, the same binary tree walked in the same near-first
    order, beside traverse_bvh2 on the same 8 ray components: for a
    closest-hit launch t equal bit for bit on every lane and the (rnode,
    tri) pair after v1's row resolution equal except on equal-t ties (the
    lanes that differ counted); for an any-hit launch, which v1 traces
    closest hit, the occlusion equal. Both timed in interleaved rounds; v1
    held against its plain version on a fixed subset of SUBSET lanes, with
    its bound. Returns dict(ms, traverse_bvh2, id_ties, uv_differ,
    bound_ms, max_abs_err)."""
    from vk_gltf_renderer_tpu_torch.ops import traverse as tt
    from vk_gltf_renderer_tpu_torch.ops import traverse_bvh2 as tb2
    from vk_gltf_renderer_tpu_torch.ops import traverse_bvh2_split as tb2s

    name = "traverse_bvh2_split"
    tables = (bvh.nodes_f, bvh.nodes_i, bvh.tris)

    def v1(*a):
        return tb2s.traverse_bvh2_split(*tables, *(a or rays), root_leaf=bvh.bvh2_split_root_leaf)

    def v2():
        return tb2.traverse_bvh2(bvh.nodes_fi, bvh.tris128, bvh.root_code, *rays, anyhit=anyhit)

    (t1, _, row, u1, w1), (t2, rn2, tri2, u2, w2) = v1(), v2()
    require(torch.equal(row >= 0, tri2 >= 0), f"v1: hit or occlusion differs from traverse_bvh2's on "
            f"{int((row >= 0).ne(tri2 >= 0).sum())} lanes")
    id_ties = uv_differ = 0
    if not anyhit:
        require(same_bits(t1, t2), f"v1: t differs from traverse_bvh2's on "
                f"{int((t1.view(torch.int32) != t2.view(torch.int32)).sum())} lanes")
        safe = row.clamp(min=0).long()
        rn1 = torch.where(row >= 0, bvh.wtri_rnode[safe], -1)
        tri1 = torch.where(row >= 0, bvh.wtri_tri[safe], -1)
        id_ties = int(((rn1 != rn2) | (tri1 != tri2)).sum())
        uv_differ = int(((u1.view(torch.int32) != u2.view(torch.int32))
                         | (w1.view(torch.int32) != w2.view(torch.int32))).sum())
    times = _time_interleaved({name: v1, "traverse_bvh2": v2}, 10)
    n = rays[0].shape[0]
    live = int((rays[7] >= 0).sum())
    sub = torch.randperm(n, generator=torch.Generator(device="cpu").manual_seed(80 + k))[:SUBSET]
    sargs = tuple(a[sub.to(device)].contiguous() for a in rays)
    stats = {}
    err = _check_against_plain(name, v1(*sargs), tt.traverse_bvh2_split_plain(*tables, *sargs, stats=stats),
                               SUBSET, False)
    _, _, arity, row_bytes = SPLIT[name]
    n_dead = 0 if bvh.bvh2_split_root_leaf else n - live
    b_ms, b_by, visits = traversal_bound(stats, arity, row_bytes, n, SUBSET, SPLIT_LEAF_BYTES, n_dead=n_dead)
    return dict(ms=times[name], traverse_bvh2=times["traverse_bvh2"], id_ties=id_ties, uv_differ=uv_differ,
                bound_ms=b_ms, bound_by=b_by, max_abs_err=err, visits=visits)


def record_launches(r, wrapper):
    """One frame of renderer r through on_render, with
    ops.intersect.<wrapper> (a key of TABLE_ARGS) wrapped to record clones
    of each launch's 8 ray components; returns ([(components, anyhit)], the
    frame's aux). anyhit is False for a wrapper without the flag (packet4)."""
    from vk_gltf_renderer_tpu_torch.ops import intersect

    recorded = []
    traced = getattr(intersect, wrapper)
    skip = TABLE_ARGS[wrapper]

    def record(*args, **kw):
        recorded.append(([c.clone() for c in args[skip:]], kw.get("anyhit", False)))
        return traced(*args, **kw)

    setattr(intersect, wrapper, record)
    try:
        aux = r.on_render()
    finally:
        setattr(intersect, wrapper, traced)
    torch.cuda.synchronize()
    return recorded, aux


def phase_replay(device, scenes, smi):
    """The main path's traverse_bvh4 launches replayed: one (v3, v9) frame
    per scene through on_render with ops.intersect.traverse_bvh4 wrapped
    to record clones of each launch's 8 ray components; then every launch
    through traverse_bvh4 and v7 (bit-equal on every lane, timed in
    interleaved rounds), against the plain version on a fixed subset of
    SUBSET lanes (dead lanes included), with its bound."""
    from vk_gltf_renderer_tpu_torch.convert import add_kernel_tables_to_device
    from vk_gltf_renderer_tpu_torch.ops import traverse as tt
    from vk_gltf_renderer_tpu_torch.ops import traverse_bvh4 as tb4
    from vk_gltf_renderer_tpu_torch.ops.bvh_flatten import add_kernel_tables

    results = {}
    for label, r in scenes:
        add_kernel_tables(r.bvh, {"bvh4_sidecar"})
        add_kernel_tables_to_device(r.dev_bvh, r.bvh, device, {"bvh4_sidecar"})
        bvh = r.dev_bvh
        require(bvh.root4_code >= 0, f"{label}: the BVH4 root is a leaf")
        recorded, aux = record_launches(r, "traverse_bvh4")
        # a closest and a shadow launch per bounce while any path is alive
        require(0 < len(recorded) <= 2 * DEPTH, f"{label}: {len(recorded)} traverse_bvh4 launches in a frame")
        launches, frame = [], {}
        for k, (rays, anyhit) in enumerate(recorded):
            n = rays[0].shape[0]
            live = int((rays[7] >= 0).sum())
            times = _bvh4_vs_v7(bvh, rays, anyhit)
            sub = torch.randperm(n, generator=torch.Generator(device="cpu").manual_seed(50 + k))[:SUBSET]
            sargs = tuple(a[sub.to(device)].contiguous() for a in rays)
            stats = {}
            tables = (bvh.nodes4_fi, bvh.tris128, bvh.root4_code)
            err = _check_against_plain("traverse_bvh4", tb4.traverse_bvh4(*tables, *sargs, anyhit=anyhit),
                                       tt.traverse_bvh4_plain(*tables, *sargs, anyhit=anyhit, stats=stats),
                                       SUBSET, anyhit)
            b_ms, b_by, visits = traversal_bound(stats, 4, 128, n, SUBSET, n_dead=n - live)
            hit = "any" if anyhit else "closest"
            log(f"[replay] {label} launch {k} ({hit} hit): {n} lanes, {live} live ({100 * live / n:.2f}%): "
                f"traverse_bvh4 {times['traverse_bvh4']:.4f} ms, v7 {times['v7']:.4f} ms; bound {b_ms:.4f} ms "
                f"({b_by}); equal to v7 bit for bit on every lane; plain on {SUBSET} lanes "
                f"({int((sargs[7] >= 0).sum())} live), max err {err:.3g}; visits {visits}")
            launches.append(dict(hit=hit, lanes=n, live=live, bound_ms=b_ms, max_abs_err=err, **times))
            for key, v in times.items():
                frame[key] = frame.get(key, 0.0) + v
        frame_bound = sum(x["bound_ms"] for x in launches)
        live_sum = sum(x["live"] for x in launches)
        log(f"[replay] {label} frame ({len(launches)} launches, {live_sum} live lanes; the frame counted "
            f"{float(aux['rays']):.0f} rays): traverse_bvh4 {frame['traverse_bvh4']:.4f} ms, v7 "
            f"{frame['v7']:.4f} ms (v7 / traverse_bvh4 {frame['v7'] / frame['traverse_bvh4']:.2f}x), bound "
            f"{frame_bound:.4f} ms, on {smi}")
        later = {key: sum(x[key] for x in launches[1:]) for key in ("traverse_bvh4", "v7")}
        log(f"[replay] {label} the {len(launches) - 1} launches after bounce 0's closest hit: traverse_bvh4 "
            f"{later['traverse_bvh4']:.4f} ms, v7 {later['v7']:.4f} ms")
        results[label] = dict(frame=dict(frame, bound_ms=frame_bound, live=live_sum,
                                         rays=float(aux["rays"])),
                              launches=launches)
        del recorded
    return results


def phase_replay_selections(device, scenes, smi):
    """Phase 7b for the other redesigned kernels: per REPLAYS selection
    ((lane, lane_stream), (v5, v5), (v2, v2), (v6, v6), (v3, v8)) one 1080p
    frame per scene through on_render with the selection's wrapper recorded
    (10 launches: closest and shadow per bounce; v8 the 9 after bounce 0's
    closest hit, which goes to v3), then every launch timed, held
    against the plain version on a fixed subset of SUBSET lanes (dead lanes
    included), with its bound; the launches of BESIDE_BVH4 also beside
    traverse_bvh4 on the same lanes (v5, v8: _same_tree_vs_bvh4, closest-hit
    t bit for bit on every lane; v2, v6: _beside_bvh4), and the (v2, v2)
    launches also through v1 beside traverse_bvh2 (_v1_beside_v2). Nothing
    may be dropped.
    Returns wrapper -> scene -> dict(frame, launches), "traverse_bvh2_split"
    among the wrappers."""
    from vk_gltf_renderer_tpu_torch.convert import add_kernel_tables_to_device

    mods = _traversal_modules()
    results = {"traverse_bvh2_split": {}}
    mods["traverse_bvh2_split"].OVERFLOW.reset()
    for name, selection in REPLAYS.items():
        os.environ["VKGR_PRIMARY_KERNEL"], os.environ["VKGR_PACKET_KERNEL"] = selection
        mod = mods[name]
        mod.OVERFLOW.reset()
        results[name] = {}
        for label, r in scenes:
            recorded, aux = record_launches(r, name)
            require(0 < len(recorded) <= 2 * DEPTH, f"{label} {selection}: {len(recorded)} {name} launches")
            kern, plain, arity, row_bytes = _traversal_runs(r.dev_bvh)[name]
            if name == "traverse_bvh2":  # v1 on the same lanes: its split tables
                add_kernel_tables_to_device(r.dev_bvh, r.bvh, device, {"bvh2_split"})
            launches, v1_launches = [], []
            for k, (rays, anyhit) in enumerate(recorded):
                n = rays[0].shape[0]
                live = int((rays[7] >= 0).sum())
                if name in SAME_TREE:
                    times = _same_tree_vs_bvh4(name, r.dev_bvh, rays, anyhit)
                    ms = times[name]
                elif name in BESIDE_BVH4:
                    times = _beside_bvh4(r.dev_bvh, name, kern, rays, anyhit)
                    ms = times[name]
                else:
                    ms = device_ms(lambda rays=rays, anyhit=anyhit: kern(*rays, anyhit=anyhit), 10)
                    times = {}
                sub = torch.randperm(n, generator=torch.Generator(device="cpu").manual_seed(60 + k))[:SUBSET]
                sargs = tuple(a[sub.to(device)].contiguous() for a in rays)
                stats = {}
                err = _check_against_plain(name, kern(*sargs, anyhit=anyhit),
                                           plain(*sargs, anyhit=anyhit, stats=stats), SUBSET, anyhit)
                b_ms, b_by, visits = traversal_bound(stats, arity, row_bytes, n, SUBSET, n_dead=n - live)
                hit = "any" if anyhit else "closest"
                beside = (f", traverse_bvh4 {times['traverse_bvh4']:.4f} ms on the same lanes "
                          + (f"(t equal bit for bit, {times['ties']} equal-t ties)" if "ties" in times else
                             f"(t differs on {times['t_differs']} lanes)") if times else "")
                log(f"[replay] {selection} {label} launch {k} ({hit} hit): {n} lanes, {live} live "
                    f"({100 * live / n:.2f}%): {name} {ms:.4f} ms{beside}; bound {b_ms:.4f} ms ({b_by}); plain on "
                    f"{SUBSET} lanes ({int((sargs[7] >= 0).sum())} live), max err {err:.3g}; visits {visits}")
                launches.append(dict(hit=hit, lanes=n, live=live, ms=ms, bound_ms=b_ms, max_abs_err=err,
                                     **{k2: v for k2, v in times.items() if k2 != name}))
                if name == "traverse_bvh2":
                    v1 = _v1_beside_v2(device, r.dev_bvh, rays, anyhit, k)
                    log(f"[replay] {selection} {label} launch {k} ({hit} hit) through v1: traverse_bvh2_split "
                        f"{v1['ms']:.4f} ms, traverse_bvh2 {v1['traverse_bvh2']:.4f} ms on the same lanes ("
                        + (f"t equal bit for bit on every lane, (rnode, tri) differs on {v1['id_ties']} "
                           f"(equal-t ties), u/v on {v1['uv_differ']}" if not anyhit else
                           "occlusion equal; v1 traces the segments closest hit")
                        + f"); bound {v1['bound_ms']:.4f} ms ({v1['bound_by']}); plain on {SUBSET} lanes, "
                        f"max err {v1['max_abs_err']:.3g}; visits {v1.pop('visits')}")
                    v1_launches.append(dict(hit=hit, lanes=n, live=live, **v1))
            frame = dict(ms=sum(x["ms"] for x in launches), bound_ms=sum(x["bound_ms"] for x in launches),
                         live=sum(x["live"] for x in launches), rays=float(aux["rays"]))
            if name in BESIDE_BVH4:
                frame["traverse_bvh4_ms"] = sum(x["traverse_bvh4"] for x in launches)
            if name in SAME_TREE:
                frame["ties"] = sum(x["ties"] for x in launches)
            log(f"[replay] {selection} {label} frame ({len(launches)} launches, {frame['live']} live lanes; "
                f"the frame counted {frame['rays']:.0f} rays): {name} {frame['ms']:.4f} ms, bound "
                f"{frame['bound_ms']:.4f} ms" + (f", traverse_bvh4 on the same lanes {frame['traverse_bvh4_ms']:.4f} ms"
                                                 if "traverse_bvh4_ms" in frame else "") + f", on {smi}")
            results[name][label] = dict(frame=frame, launches=launches)
            if v1_launches:
                v1_frame = {key: sum(x[key] for x in v1_launches)
                            for key in ("ms", "traverse_bvh2", "bound_ms", "live", "id_ties", "uv_differ")}
                v1_frame.update(rays=frame["rays"], traverse_bvh2_ms=v1_frame.pop("traverse_bvh2"))
                log(f"[replay] {selection} {label} frame through v1 ({len(v1_launches)} launches): "
                    f"traverse_bvh2_split {v1_frame['ms']:.4f} ms, traverse_bvh2 on the same lanes "
                    f"{v1_frame['traverse_bvh2_ms']:.4f} ms, bound {v1_frame['bound_ms']:.4f} ms; "
                    f"(rnode, tri) equal-t ties {v1_frame['id_ties']}, on {smi}")
                results["traverse_bvh2_split"][label] = dict(frame=v1_frame, launches=v1_launches)
        dropped = mod.OVERFLOW.total()
        require(dropped == 0, f"{name}: the replay dropped {dropped} (stack overflow / bad link)")
    dropped = mods["traverse_bvh2_split"].OVERFLOW.total()
    require(dropped == 0, f"traverse_bvh2_split: the replay dropped {dropped}")
    for key in ("VKGR_PRIMARY_KERNEL", "VKGR_PACKET_KERNEL"):
        os.environ.pop(key, None)
    return results


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

    def most(x):  # max |x|, 0 over no element (a sparse replayed launch's subset may hit nothing)
        return float(x.abs().max()) if x.numel() else 0.0

    err = max(most((kt - pt)[hit]), most((ku - pu)[both]), most((kv - pv)[both]))
    require(bool(((kt - pt)[hit].abs() <= 1e-5 * (1 + pt[hit].abs())).all()), f"{name}: t beyond 1e-5")
    require(most((ku - pu)[both]) <= 1e-5 and most((kv - pv)[both]) <= 1e-5, f"{name}: u/v beyond 1e-5")
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


def phase_kernels(device, resources):
    from vk_gltf_renderer_tpu_torch.ops import gather as tgather

    with tempfile.TemporaryDirectory() as tmp:
        r, scene, _ = helmet_renderer(tmp, device)
        r.create_scene(scene)
        _all_tables(r, device)
        bvh = r.dev_bvh
        ro, rd = probe_rays(r, device)
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
    results["traverse_bvh4"]["against_v7"] = _bvh4_probe_vs_v7("kernels", bvh, comps, tmin, far, shadow_tmax,
                                                            resources["traverse_bvh4.cu"])
    for name in SAME_TREE:
        results[name]["against_traverse_bvh4"] = _same_tree_probe_vs_bvh4("kernels", name, bvh, comps, tmin, far,
                                                                          shadow_tmax)

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

    r, scene, hdr = helmet_renderer(tmp, device)
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


def terrain_renderer(glb, hdr, device, selection):
    from vk_gltf_renderer_tpu_torch.renderer import GltfRenderer

    os.environ["VKGR_PRIMARY_KERNEL"], os.environ["VKGR_PACKET_KERNEL"] = selection
    r = GltfRenderer(FRAME_W, FRAME_H, spp=SPP, max_depth=DEPTH, device=device)
    t0 = time.perf_counter()
    r.create_scene(glb)
    r.create_hdr(hdr)
    return r, time.perf_counter() - t0


def phase_large_kernels(device, glb, hdr, resources):
    """Every traversal kernel against its plain version on the terrain."""
    from vk_gltf_renderer_tpu_torch.ops.intersect import STACK_CAPACITY

    r, secs = terrain_renderer(glb, hdr, device, SELECTIONS[0])
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

    ro, rd = probe_rays(r, device)
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
    results = _run_kernels("large", names, _traversal_runs(bvh), comps, tmin, far, shadow_tmax, sub)
    results["traverse_bvh4"]["against_v7"] = _bvh4_probe_vs_v7("large", bvh, comps, tmin, far, shadow_tmax,
                                                            resources["traverse_bvh4.cu"])
    for name in SAME_TREE:
        results[name]["against_traverse_bvh4"] = _same_tree_probe_vs_bvh4("large", name, bvh, comps, tmin, far,
                                                                          shadow_tmax)
    return results, r, (ro, rd)


def phase_terrain_frames(device, glb, hdr, smi, tmp):
    """The terrain at the bench recipe under each kernel selection."""
    from vk_gltf_renderer_tpu_torch.ops import gather as tgather

    mods = _traversal_modules()
    runs = {}
    for selection in SELECTIONS:
        r, secs = terrain_renderer(glb, hdr, device, selection)
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
            ended = stats["ended"]
            require(sum(ended) == SUBSET, f"{label} depth {depth}: {ended} paths ended of {SUBSET}")
            table_bytes, flops, visits = _visits(stats, 4, 128)
            ray_bytes = (4 + 4 + 1 + 2) * 4  # ro, rd, seed in; radiance, t out
            b_ms, b_by = bound(table_bytes + n * ray_bytes, flops * n / SUBSET + n * depth * SHADE_FLOPS)
            rad = out_m[:, 0].reshape(-1)[:n]
            require(bool(torch.isfinite(out_m).all()) and float(rad.max()) > 0, "megakernel output")
            log(f"[mega] {label} depth {depth}, {n} camera rays: render_mega {mega_ms:.3f} ms "
                f"({n * depth / mega_ms / 1e3:.1f} Mrays/s), render_wavefront {wave_ms:.3f} ms "
                f"({n * depth / wave_ms / 1e3:.1f} Mrays/s), wavefront/mega {wave_ms / mega_ms:.2f}x on "
                f"{smi}; equal on every ray; plain {plain_ms:.1f} ms for {SUBSET} rays, max err {err:.3g}, "
                f"paths ended at bounces 0..{depth - 1}: {ended}; "
                f"visits on the subset {visits}; bound {b_ms:.4f} ms ({b_by}); mean radiance "
                f"{float(rad.mean()):.4f}; launches {launches}")
            results[(label, depth)] = dict(ms=mega_ms, wavefront_ms=wave_ms, plain_ms=plain_ms,
                                           max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
                                           launches=launches["render_mega"], rays=n, ended_subset=ended)
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
    kernels = {"traverse_bvh4_split": (tt.traverse_bvh4_split_plain, (bvh.nodes4_f, bvh.nodes4_i, bvh.tris), {}),
               "traverse_bvh2_split": (tt.traverse_bvh2_split_plain, (bvh.nodes_f, bvh.nodes_i, bvh.tris),
                                       {"root_leaf": bvh.bvh2_split_root_leaf})}
    results = {}
    for name, (plain, tables, fkw) in kernels.items():
        family, kw, arity, row_bytes = SPLIT[name]
        mod = mods[name]
        need, cap = bvh.stack_need[family], STACK_CAPACITY[family]
        require(need <= cap, f"{name}: the tree needs a {need}-entry stack of {cap}")
        mod.OVERFLOW.reset()
        args = (*comps, tmin, far)
        fn = getattr(mod, name)
        ms = device_ms(lambda: fn(*tables, *args, **fkw), 10)
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
        k = fn(*tables, *sargs, **fkw)
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
        recorded, aux = record_launches(r, "traverse_bvh4_split")
        runs[label] = dict(ms=ms, mrays=mrays, launches=launches["traverse_bvh4_split"],
                           replay=_replay_packet4(device, label, r.dev_bvh, recorded, aux, smi))
        del r, recorded
    os.environ.pop("VKGR_TRAVERSAL")
    return runs


def _replay_packet4(device, label, bvh, recorded, aux, smi):
    """Phase 7b for packet4: each recorded launch of one packet4 frame
    timed beside traverse_bvh4 (closest hit, the same lanes), against the
    plain version on a fixed subset of SUBSET lanes (dead lanes included),
    with its bound. Nothing may be dropped. Returns dict(frame, launches)."""
    from vk_gltf_renderer_tpu_torch.ops import traverse as tt
    from vk_gltf_renderer_tpu_torch.ops import traverse_bvh4_split as tb4s

    name = "traverse_bvh4_split"
    require(0 < len(recorded) <= 2 * DEPTH, f"packet4 {label}: {len(recorded)} {name} launches")
    tables = (bvh.nodes4_f, bvh.nodes4_i, bvh.tris)
    _, _, arity, row_bytes = SPLIT[name]
    tb4s.OVERFLOW.reset()
    launches = []
    for k, (rays, _) in enumerate(recorded):
        n = rays[0].shape[0]
        live = int((rays[7] >= 0).sum())
        times = _beside_bvh4(bvh, name, lambda *a, anyhit: tb4s.traverse_bvh4_split(*tables, *a), rays, False)
        sub = torch.randperm(n, generator=torch.Generator(device="cpu").manual_seed(70 + k))[:SUBSET]
        sargs = tuple(a[sub.to(device)].contiguous() for a in rays)
        stats = {}
        err = _check_against_plain(name, tb4s.traverse_bvh4_split(*tables, *sargs),
                                   tt.traverse_bvh4_split_plain(*tables, *sargs, stats=stats), SUBSET, False)
        b_ms, b_by, visits = traversal_bound(stats, arity, row_bytes, n, SUBSET, SPLIT_LEAF_BYTES, n_dead=n - live)
        log(f"[replay] packet4 {label} launch {k}: {n} lanes, {live} live ({100 * live / n:.2f}%): {name} "
            f"{times[name]:.4f} ms, traverse_bvh4 {times['traverse_bvh4']:.4f} ms on the same lanes (t differs "
            f"on {times['t_differs']}); bound {b_ms:.4f} ms ({b_by}); plain on {SUBSET} lanes "
            f"({int((sargs[7] >= 0).sum())} live), max err {err:.3g}; visits {visits}")
        launches.append(dict(hit="closest", lanes=n, live=live, ms=times[name], traverse_bvh4=times["traverse_bvh4"],
                             t_differs=times["t_differs"], bound_ms=b_ms, max_abs_err=err))
    dropped = tb4s.OVERFLOW.total()
    require(dropped == 0, f"{name}: the replay dropped {dropped} (stack overflow / bad link)")
    frame = {key: sum(x[key] for x in launches) for key in ("ms", "traverse_bvh4", "bound_ms", "live")}
    frame.update(rays=float(aux["rays"]), traverse_bvh4_ms=frame.pop("traverse_bvh4"))
    log(f"[replay] packet4 {label} frame ({len(launches)} launches, {frame['live']} live lanes; the frame "
        f"counted {frame['rays']:.0f} rays): {name} {frame['ms']:.4f} ms, traverse_bvh4 on the same lanes "
        f"{frame['traverse_bvh4_ms']:.4f} ms, bound {frame['bound_ms']:.4f} ms, on {smi}")
    return dict(frame=frame, launches=launches)


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


def _headless_record(out):
    """The BENCHMARK_JSON record of a headless run's stdout."""
    lines = [ln for ln in out.splitlines() if ln.startswith("BENCHMARK_JSON ")]
    require(len(lines) == 1, f"headless printed {len(lines)} BENCHMARK_JSON lines")
    return lines[0], json.loads(lines[0].split(" ", 1)[1])


def phase_frontends(device, tmp, glb, smi):
    """Phase 14: headless, the benchmark harness, the bench entry and the
    frame profiler on the card."""
    import io
    from contextlib import redirect_stdout

    from vk_gltf_renderer_tpu_torch import headless
    from vk_gltf_renderer_tpu_torch.benchmark.__main__ import main as benchmark_main
    from vk_gltf_renderer_tpu_torch.ops import gather as tgather
    from vk_gltf_renderer_tpu_torch.ops import traverse_bvh4 as tb4
    from vk_gltf_renderer_tpu_torch.renderer import GltfRenderer
    from vk_gltf_renderer_tpu_torch.utils.png import read_png
    from vk_gltf_renderer_tpu_torch.utils.profiler import format_table, profile_frames

    for key in ("VKGR_PRIMARY_KERNEL", "VKGR_PACKET_KERNEL", "VKGR_TRAVERSAL"):
        os.environ.pop(key, None)
    os.environ["VKGR_SETTINGS"] = os.path.join(tmp, "settings.json")
    scene, hdr = os.path.join(tmp, "helmet.gltf"), os.path.join(tmp, "sky.hdr")
    png = os.path.join(tmp, "headless.png")
    t0 = time.perf_counter()
    tb4.COUNTER.launches = 0
    tgather.COUNTER.launches = 0
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = headless.main(["--headless", "--scenefile", scene, "--hdrfile", hdr, "--envSystem", "1",
                            "--size", str(FRAME_W), str(FRAME_H), "--frames", "6", "--output", png])
    launches = {"traverse_bvh4": tb4.COUNTER.launches, "gather_channels": tgather.COUNTER.launches}
    line, rec = _headless_record(buf.getvalue())
    log(f"[frontends] headless rc {rc}: {line}")
    with open(png, "rb") as f:
        img = read_png(f.read())
    log(f"[frontends] headless PNG {img.shape}, mean {img.mean(axis=(0, 1)).round(2).tolist()}; kernel "
        f"launches {launches} ({time.perf_counter() - t0:.1f} s)")
    require(rc == 0 and rec["frames"] == 5 and rec["triangles"] == 9218 and rec["Mrays_per_sec"] > 0,
            f"headless record {rec}")
    require(img.shape == (FRAME_H, FRAME_W, 3) and img.mean() > 1, "headless PNG is wrong or black")
    require(all(v > 0 for v in launches.values()), f"a kernel of the headless path never launched: {launches}")

    t0 = time.perf_counter()
    cfg, csv_path = os.path.join(tmp, "frontends.cfg"), os.path.join(tmp, "frontends.csv")
    with open(cfg, "w") as f:
        for path in (scene, glb):
            f.write(f"--scenefile {path} --size 512 512 --frames 4 --envSystem 1 --hdrfile {hdr}\n")
    with redirect_stdout(io.StringIO()):
        rc_run = benchmark_main(["run", cfg, "--output", csv_path, "--device", str(device)])
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc_cmp = benchmark_main(["compare", csv_path, csv_path])
    with open(csv_path) as f:
        rows = f.read().splitlines()
    log(f"[frontends] benchmark run rc {rc_run}, compare rc {rc_cmp} ({time.perf_counter() - t0:.1f} s); "
        f"CSV: {rows}; compare: {buf.getvalue().splitlines()}")
    require(rc_run == 0 and rc_cmp == 0 and len(rows) == 3, "benchmark run / compare failed")

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    env = {k: v for k, v in os.environ.items() if not k.startswith("VKGR_BENCH_")}
    env["VKGR_BENCH_SCENE2_TIMEOUT"] = "300"
    proc = subprocess.run([sys.executable, "-m", "vk_gltf_renderer_tpu_torch.bench_impl"], cwd=str(ROOT),
                          env=env, capture_output=True, text=True, timeout=400)
    bench_line = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
    log(f"[frontends] bench_impl rc {proc.returncode} ({time.perf_counter() - t0:.1f} s): {bench_line}")
    require(proc.returncode == 0, f"bench_impl failed: {proc.stderr[-2000:]}")
    bench = json.loads(bench_line)
    require(bench["value"] > 0 and "error" not in bench["detail"].get("scene2", {"error": "missing"}),
            "bench_impl reported no rate or an error")

    profiles = {}
    for label, path in (("helmet", scene), ("terrain", glb)):
        t0 = time.perf_counter()
        r = GltfRenderer(FRAME_W, FRAME_H, spp=SPP, max_depth=DEPTH, device=device)
        r.create_scene(path)
        r.create_hdr(hdr)
        profiles[label] = profile_frames(r, PROFILED_FRAMES)
        del r
        log(format_table(profiles[label], f"[frontends] profile {label} {FRAME_W}x{FRAME_H} on {smi}, "))
        log(f"[frontends] profile {label} took {time.perf_counter() - t0:.1f} s")
    return dict(headless=rec, launches=launches, bench=bench, profiles=profiles)


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
    resources = phase_build()
    kern, helmet_r, helmet_rays = phase_kernels(device, resources)
    with tempfile.TemporaryDirectory() as tmp:
        launches, ms, mrays, helmet_first = phase_main_path(device, tmp, smi)
        phase_correctness(device, tmp)
        log(f"[time] helmet phases done at {time.perf_counter() - t_start:.1f} s")

        from vk_gltf_renderer_tpu_torch.scenes import write_large_glb, write_synthetic_hdr

        glb = os.path.join(tmp, "terrain.glb")
        hdr = write_synthetic_hdr(os.path.join(tmp, "sky.hdr"), 256, 512, seed=0)
        world = write_large_glb(glb, LARGE_TRIS)
        require(world == LARGE_WORLD_TRIS, f"terrain has {world} world triangles")
        large, terrain_r, terrain_rays = phase_large_kernels(device, glb, hdr, resources)
        log(f"[time] large-scene kernels done at {time.perf_counter() - t_start:.1f} s")
        frames = phase_terrain_frames(device, glb, hdr, smi, tmp)
        log(f"[time] terrain frames done at {time.perf_counter() - t_start:.1f} s")
        helmet, _, _ = helmet_renderer(tmp, device)
        helmet.create_scene(os.path.join(tmp, "helmet.gltf"))
        helmet.create_hdr(hdr)
        terrain, _ = terrain_renderer(glb, hdr, device, SELECTIONS[0])
        replay = phase_replay(device, (("helmet", helmet), ("terrain", terrain)), smi)
        log(f"[time] main-path launch replay done at {time.perf_counter() - t_start:.1f} s")
        replays = phase_replay_selections(device, (("helmet", helmet), ("terrain", terrain)), smi)
        log(f"[time] {', '.join(map(str, REPLAYS.values()))} launch replays done at "
            f"{time.perf_counter() - t_start:.1f} s")
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
        front = phase_frontends(device, tmp, glb, smi)
        log(f"[time] front ends done at {time.perf_counter() - t_start:.1f} s")
    probes = phase_probes(device)
    log(f"[time] probes done at {time.perf_counter() - t_start:.1f} s")
    probes.update(phase_stream_uarch(device))
    log(f"[time] stream and micro-op probes done at {time.perf_counter() - t_start:.1f} s")

    kernels = [
        _entry("traverse_bvh4", launches["traverse_bvh4"], kern["traverse_bvh4"],
               headless_launches=front["launches"]["traverse_bvh4"],
               terrain_launches=frames[SELECTIONS[0]]["launches"]["traverse_bvh4"],
               terrain=large["traverse_bvh4"], resources=resources["traverse_bvh4.cu"],
               replay={label: v["frame"] for label, v in replay.items()},
               replay_launches={label: [[x["hit"], x["lanes"], x["live"], x["traverse_bvh4"], x["v7"], x["bound_ms"]]
                                        for x in v["launches"]] for label, v in replay.items()},
               replay_launches_fields=["hit", "lanes", "live", "ms", "v7_ms", "bound_ms"]),
        _entry("gather_channels", launches["gather_channels"], kern["gather_channels"],
               headless_launches=front["launches"]["gather_channels"]),
    ]
    for name, sel in (("traverse_bvh2", ("v2", "v2")), ("traverse_bvh16", ("v6", "v6")),
                      ("traverse_lanes", ("lane", "lane_stream")),
                      ("traverse_bvh4_multipop", ("v5", "v5")), ("traverse_bvh4_sidecar", ("v7", "v7")),
                      ("traverse_bvh4_leafqueue", ("v3", "v8"))):
        extra = {"helmet": kern[name]} if name in BVH4_VARIANTS else {}
        if name == "traverse_bvh4_sidecar":  # phase 7b: v7 on the (v3, v9) frame's lanes
            extra.update(resources=resources[SOURCES[name][0]],
                         replay={label: dict(ms=v["frame"]["v7"], bound_ms=v["frame"]["bound_ms"],
                                             live=v["frame"]["live"], rays=v["frame"]["rays"],
                                             traverse_bvh4_ms=v["frame"]["traverse_bvh4"])
                                 for label, v in replay.items()},
                         replay_launches={label: [[x["hit"], x["lanes"], x["live"], x["v7"], x["bound_ms"]]
                                                  for x in v["launches"]] for label, v in replay.items()},
                         replay_launches_fields=["hit", "lanes", "live", "ms", "bound_ms"])
        if name in REPLAYS:
            beside = ["traverse_bvh4_ms"] if name in BESIDE_BVH4 else []
            extra.update(resources=resources[SOURCES[name][0]],
                         replay={label: v["frame"] for label, v in replays[name].items()},
                         replay_launches={label: [[x["hit"], x["lanes"], x["live"], x["ms"], x["bound_ms"]]
                                                  + [x["traverse_bvh4"] for _ in beside]
                                                  for x in v["launches"]] for label, v in replays[name].items()},
                         replay_launches_fields=["hit", "lanes", "live", "ms", "bound_ms"] + beside)
        kernels.append(_entry(name, frames[sel]["launches"][name], large[name], **extra))
    kernels.append(_entry("render_mega", mega[("terrain", 5)]["launches"], mega[("terrain", 5)],
                          resources=resources["megakernel.cu"],
                          runs={f"{label},depth{depth}": v for (label, depth), v in mega.items()}))
    kernels.append(_entry("traverse_bvh4_split", packet4["terrain"]["launches"],
                          split["terrain"]["traverse_bvh4_split"], helmet=split["helmet"]["traverse_bvh4_split"],
                          helmet_launches=packet4["helmet"]["launches"],
                          resources=resources["traverse_bvh4_split.cu"],
                          replay={label: v["replay"]["frame"] for label, v in packet4.items()},
                          replay_launches={label: [[x["hit"], x["lanes"], x["live"], x["ms"], x["traverse_bvh4"],
                                                    x["bound_ms"]] for x in v["replay"]["launches"]]
                                           for label, v in packet4.items()},
                          replay_launches_fields=["hit", "lanes", "live", "ms", "traverse_bvh4_ms", "bound_ms"]))
    # v1 has no renderer path: its launches are those of phase 9's two intersect_rays_packet
    # calls on the terrain; its replay is the (v2, v2) frames' launches (phase 7b)
    v1_replay = replays["traverse_bvh2_split"]
    kernels.append(_entry("traverse_bvh2_split", split["terrain"]["traverse_bvh2_split"]["launches"],
                          split["terrain"]["traverse_bvh2_split"], helmet=split["helmet"]["traverse_bvh2_split"],
                          launches_of="phase 9: intersect_rays_packet(v2=False), closest hit and "
                                      "anyhit=True, on the terrain's probe rays",
                          resources=resources["traverse_bvh2_split.cu"],
                          replay={label: v["frame"] for label, v in v1_replay.items()},
                          replay_launches={label: [[x["hit"], x["lanes"], x["live"], x["ms"], x["traverse_bvh2"],
                                                    x["bound_ms"], x["id_ties"]] for x in v["launches"]]
                                           for label, v in v1_replay.items()},
                          replay_launches_fields=["hit", "lanes", "live", "ms", "traverse_bvh2_ms", "bound_ms",
                                                  "id_ties"]))
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
                      "headless": front["headless"], "bench_impl": front["bench"],
                      "profiles": {label: {k: v for k, v in prof.items() if k != "top"}
                                   for label, prof in front["profiles"].items()},
                      "terrain_frame": f"{FRAME_W}x{FRAME_H} spp{SPP} depth{DEPTH} terrain "
                                       f"{LARGE_WORLD_TRIS} tris + HDR"}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
