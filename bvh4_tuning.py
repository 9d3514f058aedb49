"""Ablations and tuning runs of csrc/traverse_bvh4.cu on one NVIDIA GPU.

    python3 bvh4_tuning.py

Each entry of VARIANTS is the kernel's source with one design element
toggled (compaction, whole-row loads, any-hit as a template parameter,
the next node in a register, a shared-memory stack, refilling lanes whose
ray is done) or one tuning constant changed. A variant is a list of
source substitutions: each names the text it replaces (or the first and
last line of a span) and must match the source exactly once, so an edit
of the kernel that a variant no longer fits stops the run with the
variant's name (tests/test_torch_traverse.py checks this on the CPU).

The run builds the kernel library once per variant into
build/bvh4_tuning/ (the other sources of csrc/ compiled once, every
object in its own nvcc process, all started together) and launches each
through ops/traverse_bvh4.traverse_bvh4 with cuda_lib's loaded library
swapped for the variant's. It renders one (v3, v9) 1080p frame of the
helmet stand-in (HDR) and of the 1,059,968-triangle terrain, as
chip_smoke.py phase 7b does, recording the 8 ray components of each
traverse_bvh4 launch; then times every variant on those 10 launches and
on the probe rays of chip_smoke.py phases 3 and 6 (closest hit), in a
forward and a backward round, each variant held equal bit for bit to the
unchanged source on every launch. Last, torch.profiler splits a sparse,
a medium and an all-live launch of the unchanged source into its device
kernels (memset, compact_lanes, walk_kernel). Prints the registers of
each variant's walk, one line per variant and scene, the profile, the
card's name and power limit, and a JSON line of every number last.
Exits nonzero without CUDA.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from vk_gltf_renderer_tpu_torch import cuda_lib  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import traverse_bvh4 as tb4  # noqa: E402
from vk_gltf_renderer_tpu_torch.probes import device_ms  # noqa: E402
from vk_gltf_renderer_tpu_torch.scenes import write_large_glb  # noqa: E402

OUT = ROOT / "build" / "bvh4_tuning"
KERNEL = "traverse_bvh4.cu"

# whole-row loads off: the loads of traverse_bvh.cuh's expand_node (three float2
# per box, then the axes and the entered children's codes), one triangle at a time
FLOAT2_VISIT = """  const float* row = nodes + static_cast<size_t>(e) * 32;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const float2* bp = reinterpret_cast<const float2*>(row + 6 * s);
    const float2 b0 = __ldg(bp), b1 = __ldg(bp + 1), b2 = __ldg(bp + 2);
    if (slab(b0.x, b0.y, b1.x, b1.y, b2.x, b2.y, r, t_best)) hitmask |= 1u << s;
  }
  if (!hitmask) return Visit{0, 0, 0, 0, 0u};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (!axis_sign(__ldg(row + 28 + k), r.sx, r.sy, r.sz)) flip |= 1u << k;
  }
  if (hitmask & 1u) s0 = static_cast<int>(__ldg(row + 24));
  if (hitmask & 2u) s1 = static_cast<int>(__ldg(row + 25));
  if (hitmask & 4u) s2 = static_cast<int>(__ldg(row + 26));
  if (hitmask & 8u) s3 = static_cast<int>(__ldg(row + 27));
"""
NEXT_IN_REGISTER = """    if (v.enter) {  // descend into the nearest entered child; push the others, far first
      const unsigned rest = v.enter & (v.enter - 1u);
      if (rest & 8u) push(v.c3);
      if (rest & 4u) push(v.c2);
      if (rest & 2u) push(v.c1);
      e = pick(__ffs(v.enter) - 1, v.c0, v.c1, v.c2, v.c3);
      return false;
    }
"""
# refill: a warp fetches as soon as {at} of its lanes are idle, into those lanes, and
# its lanes walk {steps} steps between two checks (Aila and Laine's dynamic fetch)
REFILL = """  int i = -1, e = 0, sp = 0;  // the lane's lane index (-1: none), node, stack depth
  Ray r{{}};
  Hit h{{}};
  bool more = true;  // warp-uniform: the list may hold entries not yet taken
  const unsigned below = (1u << lane) - 1u;
  while (true) {{
    const unsigned idle = __ballot_sync(kFull, i < 0);
    const int n_idle = __popc(idle);
    if (more && n_idle >= {at}) {{
      const int want = n_idle < per ? n_idle : per;
      int base = 0;
      if (lane == 0) base = atomicAdd(header + 1, want);
      base = __shfl_sync(kFull, base, 0);
      more = base + want < count;
      const int rank = __popc(idle & below);
      if (i < 0 && rank < want && base + rank < count) {{
        i = list[base + rank];
        r = load_ray(i, rox, roy, roz, rdx, rdy, rdz, tmin);
        h = Hit{{tmax[i], -1.0f, -1.0f, 0.0f, 0.0f}};
        e = root;
        sp = 0;
      }}
    }}
    if (!__any_sync(kFull, i >= 0)) break;  // the list is done
    if (i >= 0) {{
      for (int k = 0; k < {steps}; ++k) {{
        if (step(nodes, tris128, r, kAny, stack, e, sp, h, dropped)) {{
          store_hit(i, h, out_t, out_rnode, out_tri, out_u, out_v);
          i = -1;
          break;
        }}
      }}
    }}
  }}
"""
WALK_LOOP = ("  while (true) {\n    int base = 0;\n",
             "      store_hit(i, h, out_t, out_rnode, out_tri, out_u, out_v);\n    }\n  }\n")
WALK_TEMPLATE = "template <bool kAny>\n__global__ void __launch_bounds__(kBlock)\nwalk_kernel("
PUSH = "    if (sp < kStackCap) {\n      stack[sp++] = code;"

# variant -> [(old text, new text) or ((first, last), new text of the span first..last)]
VARIANTS = {
    "source": [],
    "compaction off (every lane listed and walked)": [
        ("    live = tm >= 0.0f || (root < 0 && tmin[i] < tm);\n", "    live = true;\n")],
    "whole-row loads off": [
        (("  const float4* q = reinterpret_cast<const float4*>",
          "  if (!axis_sign(q7.z, r.sx, r.sy, r.sz)) flip |= 4u;\n"), FLOAT2_VISIT),
        ("    if (leaf(tris128, e, r, anyhit, h)) return true;",
         "    if (test_leaf(tris128, e, r, anyhit, h)) return true;")],
    "any-hit as a template off (a runtime flag)": [
        (WALK_TEMPLATE, WALK_TEMPLATE.replace("bool kAny", "bool kAnyT")),
        ("  const int count = header[0];  // final: compact_lanes ran before on this stream\n",
         "  const int count = header[0];  // final: compact_lanes ran before on this stream\n"
         "  const bool kAny = kAnyT != (count < 0);  // kAnyT, which the compiler cannot see\n")],
    "next node in a register": [
        (("    // every entered child, far first", "    if (v.enter & 1u) push(v.c0);\n"),
         NEXT_IN_REGISTER)],
    "stack in shared memory": [
        ("  int stack[kStackCap];\n",
         "  __shared__ int stack_columns[kStackCap * kBlock];  // entry d of thread t at d * kBlock + t\n"
         "  int* stack = stack_columns + threadIdx.x;\n"),
        ("      stack[sp++] = code;", "      stack[kBlock * sp++] = code;"),
        ("  e = stack[--sp];", "  e = stack[kBlock * --sp];")],
    "refill at 16 idle lanes, 4 steps": [(WALK_LOOP, REFILL.format(at=16, steps=4))],
    "refill at 16 idle lanes, 1 step": [(WALK_LOOP, REFILL.format(at=16, steps=1))],
    "refill at 8 idle lanes, 4 steps": [(WALK_LOOP, REFILL.format(at=8, steps=4))],
    "triangle batch 2": [("kTriBatch = 4;", "kTriBatch = 2;")],
    "triangle batch 8": [("kTriBatch = 4;", "kTriBatch = 8;")],
    "64 registers": [(WALK_TEMPLATE, WALK_TEMPLATE.replace("(kBlock)", "(kBlock, 8)"))],
    "fetch 32": [("const int per = min(32, max(1, (count + warps - 1) / warps));", "const int per = 32;")],
    "prefetch pushed rows": [
        (PUSH, "    if (code >= 0) prefetch_l1(nodes + static_cast<size_t>(code) * 32);\n" + PUSH)],
}


def variant_source(src, name):
    """The kernel source of variant `name`; raises unless each of its
    substitutions matches src exactly once."""
    for old, new in VARIANTS[name]:
        if isinstance(old, tuple):
            first, last = old
            if src.count(first) != 1:
                raise ValueError(f"{name}: {first!r} is not in {KERNEL} exactly once")
            a = src.index(first)
            b = src.find(last, a)
            if b < 0:
                raise ValueError(f"{name}: {last!r} does not follow {first!r} in {KERNEL}")
            src = src[:a] + new + src[b + len(last):]
        else:
            if src.count(old) != 1:
                raise ValueError(f"{name}: {old!r} is not in {KERNEL} exactly once")
            src = src.replace(old, new)
    return src


def _dir(name):
    return OUT / re.sub(r"\W+", "_", name).strip("_")


def _nvcc(nvcc, args):
    return subprocess.Popen([nvcc, *args], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _wait(procs):
    logs = {}
    for key, proc in procs.items():
        log, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {key}:\n{log}")
        logs[key] = log
    return logs


def build():
    """One library per variant: name -> cuda_lib.KernelLibrary, whose
    compiler log is the variant's traverse_bvh4.cu compile."""
    nvcc = cuda_lib._nvcc()
    src = (cuda_lib._CSRC / KERNEL).read_text()
    common = OUT / "common"
    common.mkdir(parents=True, exist_ok=True)
    others = [p for p in sorted(cuda_lib._CSRC.glob("*.cu")) if p.name != KERNEL]
    flags = [*cuda_lib.COMPILE_FLAGS, "-I", str(cuda_lib._CSRC), "-c"]
    procs = {p.name: _nvcc(nvcc, [*flags, "-o", str(common / f"{p.stem}.o"), str(p)]) for p in others}
    for name in VARIANTS:
        d = _dir(name)
        d.mkdir(parents=True, exist_ok=True)
        (d / KERNEL).write_text(variant_source(src, name))
        procs[name] = _nvcc(nvcc, [*flags, "-o", str(d / "traverse_bvh4.o"), str(d / KERNEL)])
    logs = _wait(procs)
    objs = [str(common / f"{p.stem}.o") for p in others]
    _wait({name: _nvcc(nvcc, [*cuda_lib.LINK_FLAGS, "-o", str(_dir(name) / "libvkgr_kernels.so"),
                              str(_dir(name) / "traverse_bvh4.o"), *objs]) for name in VARIANTS})
    return {name: cuda_lib.KernelLibrary(_dir(name) / "libvkgr_kernels.so", 0.0, f"== {KERNEL}\n{logs[name]}")
            for name in VARIANTS}


@contextlib.contextmanager
def loaded(lib):
    """ops/traverse_bvh4 (every wrapper) launches from lib inside the block."""
    saved = cuda_lib._loaded
    cuda_lib._loaded = lib
    try:
        yield
    finally:
        cuda_lib._loaded = saved


def call(bvh, rays, anyhit):
    return tb4.traverse_bvh4(bvh.nodes4_fi, bvh.tris128, bvh.root4_code, *rays, anyhit=anyhit)


def profile(bvh, rays, anyhit):
    """Device us per call of each kernel of one launch."""
    for _ in range(3):
        call(bvh, rays, anyhit)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            call(bvh, rays, anyhit)
        torch.cuda.synchronize()
    return {e.key.split("(")[0].replace("void ", ""): e.device_time_total / e.count
            for e in prof.key_averages() if e.device_time_total > 0}


def main():
    device, smi = cs.phase_device()
    libs = build()
    registers = {}
    for name, lib in libs.items():
        res = cs.bvh4_resources(lib.compiler_log)
        registers[name] = {hit: res.get(f"walk {hit}", {}).get("registers") for hit in ("closest", "any")}
        cs.log(f"[tuning] {name}: walk registers {registers[name]}, "
               f"shared memory {res.get('walk closest', {}).get('smem')} B")
    results = {"card": smi, "registers": registers, "scenes": {}}
    with tempfile.TemporaryDirectory() as tmp:
        helmet, scene, hdr = cs.helmet_renderer(tmp, device)
        helmet.create_scene(scene)
        helmet.create_hdr(hdr)
        glb = os.path.join(tmp, "terrain.glb")
        write_large_glb(glb, cs.LARGE_TRIS)
        terrain, _ = cs.terrain_renderer(glb, hdr, device, cs.SELECTIONS[0])
        for label, r in (("helmet", helmet), ("terrain", terrain)):
            ro, rd = cs.probe_rays(r, device)
            n = ro.shape[0]
            probe = ([ro[:, i].contiguous() for i in range(3)] + [rd[:, i].contiguous() for i in range(3)]
                     + [torch.zeros(n, device=device), torch.full((n,), 1e32, device=device)])
            launches, _ = cs.record_bvh4_launches(r)
            bvh = r.dev_bvh
            with loaded(libs["source"]):
                ref = [call(bvh, rays, a) for rays, a in launches]
            times = {name: [] for name in libs}
            for order in (list(libs), list(libs)[::-1]):
                for name in order:
                    with loaded(libs[name]):
                        for (rays, a), want in zip(launches, ref):
                            cs.require(all(cs.same_bits(g, w) for g, w in zip(call(bvh, rays, a), want)),
                                       f"{label} {name}: outputs differ from the source's")
                        probe_ms = device_ms(lambda: call(bvh, probe, False), 10)
                        frame = [device_ms(lambda rays=rays, a=a: call(bvh, rays, a), 10) for rays, a in launches]
                    times[name].append((probe_ms, frame))
            scene_res = {}
            base = None
            for name, runs in times.items():
                probe_ms = sum(p for p, _ in runs) / len(runs)
                frame = [sum(f[k] for _, f in runs) / len(runs) for k in range(len(launches))]
                scene_res[name] = dict(probe_ms=probe_ms, frame_ms=sum(frame), launches_ms=frame)
                base = base or scene_res[name]
                cs.log(f"[tuning] {label} {name}: probe rays {probe_ms:.4f} ms "
                       f"({100 * (probe_ms / base['probe_ms'] - 1):+.1f}%), replayed frame {sum(frame):.4f} ms "
                       f"({100 * (sum(frame) / base['frame_ms'] - 1):+.1f}%; launches "
                       f"{', '.join(f'{x:.4f}' for x in frame)}) on {smi}")
            live = [int((rays[7] >= 0).sum()) for rays, _ in launches]
            sparse = min(range(len(launches)), key=lambda k: live[k])
            prof = {}
            with loaded(libs["source"]):
                for what, (rays, a) in ((f"launch {sparse} ({live[sparse]} live)", launches[sparse]),
                                        (f"launch 1 ({live[1]} live)", launches[1]),
                                        (f"probe rays ({n} live)", (probe, False))):
                    prof[what] = profile(bvh, rays, a)
                    cs.log(f"[tuning] {label} {what}, device us per call: "
                           + ", ".join(f"{k} {v:.2f}" for k, v in prof[what].items()))
            results["scenes"][label] = dict(variants=scene_res, live=live, profile=prof)
    print(smi)
    print(json.dumps(results), flush=True)


if __name__ == "__main__":
    main()
