"""Ablations and tuning runs of the ten kernels redesigned on
csrc/live_lanes.cuh, on one NVIDIA GPU: csrc/traverse_bvh4.cu (v3/v9),
csrc/traverse_lanes.cu (the lane walk), csrc/traverse_bvh4_multipop.cu
(v5), csrc/traverse_bvh2.cu (v2), csrc/traverse_bvh16.cu (v6),
csrc/traverse_bvh4_sidecar.cu (v7), csrc/traverse_bvh4_split.cu (packet4),
csrc/traverse_bvh4_leafqueue.cu (v8), csrc/traverse_bvh2_split.cu (v1)
and csrc/megakernel.cu.

    python3 bvh4_tuning.py [KERNEL ...]

KERNEL is a source file name of VARIANTS (default: traverse_bvh4.cu); each
one named is tuned in turn. Each entry of VARIANTS[KERNEL] is the kernel's
source with one design element toggled or one tuning constant changed, and
"every element off ..." is the walk before the redesign. A variant is a
list of source substitutions: each names the text it replaces (or the
first and last line of a span) in the kernel's source, or in a header of
csrc/ that it names third (live_lanes.cuh, traverse_bvh.cuh,
sidecar_walk.cuh), and must match that file exactly once, so an edit of
the kernel that a variant no longer fits stops the run with the
variant's name (tests/test_torch_traverse.py checks this on the CPU).

The run builds the kernel library once per variant into
build/bvh4_tuning/<kernel>/ (the other sources of csrc/ compiled once,
every object in its own nvcc process, all started together; a variant
whose build fails is reported and left out) and launches each through the
kernel's wrapper with cuda_lib's loaded library swapped for the variant's.
It renders one 1080p frame of the helmet stand-in (HDR) and of the
1,059,968-triangle terrain under the kernel's selection ((v3, v9),
(lane, lane_stream), (v5, v5), (v2, v2), (v6, v6), (v7, v7) or (v3, v8);
packet4 under VKGR_TRAVERSAL=packet4; v1, which no frame launches, on the
(v2, v2) frame's launches of traverse_bvh2, the same binary tree), as
chip_smoke.py phase 7b does, recording
the 8 ray components of each of the wrapper's launches; then times every
variant on those launches and on the probe rays of chip_smoke.py phases
3 and 6 (closest hit), in a forward and a backward round. Every variant is held equal bit for bit to the unchanged
source on every launch and on the probe rays, closest hit and any hit
(phase 6's shadow tmax; packet4 and v1 have no any-hit mode and trace
those rays closest hit), except the ones that change the visit order
(ORDER), whose t must still equal the source's on every lane and whose
ids may differ only there (equal-t ties, counted). Last, torch.profiler splits a sparse,
a medium and an all-live launch of the unchanged source into its device
kernels (memset, compact_lanes, walk_kernel). The megakernel has no
recorded launches: its variants run chip_smoke.py phase 8's 2,073,600
camera rays of each scene at depths 1, 2 and 5, in pixel order and
shuffled (tune_mega), each held equal to the source bit for bit and
timed in the same two rounds. Prints
the registers and spills of each variant's walk, one line per variant and
scene, the profile, the card's name and power limit, and a JSON line of
every number last. Exits nonzero without CUDA.
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

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from vk_gltf_renderer_tpu_torch import cuda_lib  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import lane_traverse as tlane  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import megakernel as mk  # noqa: E402
from vk_gltf_renderer_tpu_torch.convert import add_kernel_tables_to_device  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import traverse_bvh2 as tb2  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import traverse_bvh2_split as tb2s  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import traverse_bvh4 as tb4  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import traverse_bvh4_leafqueue as tblq  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import traverse_bvh4_multipop as tbmp  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import traverse_bvh4_sidecar as tbsc  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import traverse_bvh4_split as tb4s  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import traverse_bvh16 as tb16  # noqa: E402
from vk_gltf_renderer_tpu_torch.probes import device_ms  # noqa: E402
from vk_gltf_renderer_tpu_torch.scenes import write_large_glb  # noqa: E402

OUT = ROOT / "build" / "bvh4_tuning"
LIVE = "live_lanes.cuh"
ROWS = "traverse_bvh.cuh"
SC = "sidecar_walk.cuh"

# shared by every kernel: compaction off (every lane listed and walked), any-hit at run time
COMPACTION_OFF = [("    live = tm >= 0.0f || (root < 0 && tmin[i] < tm);\n", "    live = true;\n", LIVE)]
WALK_TEMPLATE = "template <bool kAny>\n__global__ void __launch_bounds__(kBlock)\nwalk_kernel("
RUNTIME_ANY = "  const bool kAny = kAnyT != (header[0] < 0);  // kAnyT, which the compiler cannot see\n"


def runtime_anyhit(anchor):
    """Any-hit as a runtime flag: the template parameter renamed and kAny
    read from a value the compiler cannot see, after the line `anchor`."""
    return [(WALK_TEMPLATE, WALK_TEMPLATE.replace("bool kAny", "bool kAnyT")), (anchor, anchor + RUNTIME_ANY)]


# the generic walk's leaf, which traverse_bvh.cuh no longer holds: each triangle's loads, then its
# test (leaf's arithmetic and order)
TEST_LEAF = """template <bool kSplit = false>
__device__ __forceinline__ bool test_leaf(const float* __restrict__ tris, int e, const Ray& r,
                                          bool anyhit, Hit& h) {
  const int code = -e - 1;
  const int row = code / 16;
  const int cnt = code - row * 16;
  const float4* tr =
      reinterpret_cast<const float4*>(tris + static_cast<size_t>(row) * (kSplit ? 16 : 128));
  for (int c = 0; c < kLeafSlots && c < cnt; ++c) {
    // slot layout: v0.xyz v1.xyz v2.xyz rnode tri pad5 (split rows: pad from col 9)
    const float4 a = __ldg(tr + 4 * c);
    const float4 b = __ldg(tr + 4 * c + 1);
    const float4 d = __ldg(tr + 4 * c + 2);
    float uu, vv, tt;
    if (triangle(a.x, a.y, a.z, a.w - a.x, b.x - a.y, b.y - a.z, b.z - a.x, b.w - a.y,
                 d.x - a.z, r, h.t, uu, vv, tt)) {
      h.t = anyhit ? -1.0f : tt;
      if constexpr (kSplit) {
        h.tri = static_cast<float>(row + c);  // exact: the wrappers cap tris at 2^24 rows
      } else {
        h.rn = d.y;
        h.tri = d.z;
      }
      h.u = uu;
      h.v = vv;
      if (anyhit) return true;
    }
  }
  return false;
}

"""
# test_leaf put back into traverse_bvh.cuh (namespace vkgr), before the batched leaf's constants
TRI_BATCH = "constexpr int kTriBatch = 4;"
RESTORE_TEST_LEAF = (TRI_BATCH, TEST_LEAF + TRI_BATCH, ROWS)

# traverse_bvh4.cu and megakernel.cu (bvh4::step of traverse_bvh.cuh), whole-row loads off: the
# generic walk's loads (three float2 per box, then the axes and the entered children's codes),
# one triangle at a time
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
ROW_LOADS_OFF = [
    (("  const float4* q = reinterpret_cast<const float4*>",
      "  if (!axis_sign(q7.z, r.sx, r.sy, r.sz)) flip |= 4u;\n"), FLOAT2_VISIT, ROWS),
    ("    if (leaf(tris128, e, r, anyhit, h)) return true;",
     "    if (test_leaf(tris128, e, r, anyhit, h)) return true;", ROWS), RESTORE_TEST_LEAF]
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
REFILL = """  const int count = header[0];
  const int warps = gridDim.x * (kBlock / 32);
  const int per = min(32, max(1, (count + warps - 1) / warps));
  const int lane = threadIdx.x & 31;
  int i = -1, e = 0, sp = 0;  // the lane's lane index (-1: none), node, stack depth
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
BVH4_WALK = ("  walk_list<1>(header, list, [&](int i) {\n", "  });\n")
BVH4_STACK = "  int stack[kStackCap];\n  unsigned dropped = 0;\n"
PUSH = "    if (sp < kStackCap) {\n      stack[sp++] = code;"
# the generic walk (GENERIC below) put after a kernel's includes, outside its namespaces
AFTER_INCLUDES = '#include "traverse_bvh.cuh"\n'

# traverse_bvh4_multipop.cu, order off: the reference's order. Each member's internal
# tests see the t_best that the leaves of the members before it left (an exclusive
# prefix minimum over the group's threads), and the members' children are pushed
# member 0's first, so the last member's end on top (for one member a thread).
V5_ORDER_SPAN = ("      // this thread's members, all against the t_best",
                 "      sp = min(sp + total, kStack);\n")
V5_OLD_ORDER = """      static_assert(kPerLane == 1, "the reference's order is written for a member a thread");
      const float t_pop = h.t;
      Hit best{t_pop, -1.0f, kNoHit, 0.0f, 0.0f};
      const bool mine = q < k;
      if (mine && e[0] < 0) leaf(tris128, e[0], r, kAny, best);
      float upto = best.tri != kNoHit ? best.t : t_pop;  // min over threads 0 .. q
#pragma unroll
      for (int off = 1; off < kRayLanes; off <<= 1) {
        const float o = __shfl_up_sync(group, upto, off, kRayLanes);
        if (q >= off) upto = fminf(upto, o);
      }
      float t_before = __shfl_up_sync(group, upto, 1, kRayLanes);
      if (q == 0) t_before = t_pop;
      Visit v[kPerLane];
      v[0] = Visit{0, 0, 0, 0, 0u};
      if (mine && e[0] >= 0) v[0] = visit(nodes, e[0], r, t_before);
      float wt = best.tri != kNoHit ? best.t : __int_as_float(0x7f800000);
      int wq = best.tri != kNoHit ? q : kRayLanes;
#pragma unroll
      for (int off = 1; off < kRayLanes; off <<= 1) {
        const float ot = __shfl_xor_sync(group, wt, off, kRayLanes);
        const int oq = __shfl_xor_sync(group, wq, off, kRayLanes);
        if (ot < wt || (ot == wt && oq < wq)) {
          wt = ot;
          wq = oq;
        }
      }
      if (wq < kRayLanes) {
        h.t = __shfl_sync(group, best.t, wq, kRayLanes);
        h.rn = __shfl_sync(group, best.rn, wq, kRayLanes);
        h.tri = __shfl_sync(group, best.tri, wq, kRayLanes);
        h.u = __shfl_sync(group, best.u, wq, kRayLanes);
        h.v = __shfl_sync(group, best.v, wq, kRayLanes);
        if (kAny) break;
      }
      const int cnt = __popc(v[0].enter);
      int upto_n = cnt;  // pushes of threads 0 .. q
#pragma unroll
      for (int off = 1; off < kRayLanes; off <<= 1) {
        const int o = __shfl_up_sync(group, upto_n, off, kRayLanes);
        if (q >= off) upto_n += o;
      }
      const int total = __shfl_sync(group, upto_n, kRayLanes - 1, kRayLanes);
      int pos = sp + upto_n - cnt;
      auto push = [&](int code) {
        if (pos < kStack) {
          stack[pos] = code;
        } else {
          ++dropped;
        }
        ++pos;
      };
      if (v[0].enter & 8u) push(v[0].c3);
      if (v[0].enter & 4u) push(v[0].c2);
      if (v[0].enter & 2u) push(v[0].c1);
      if (v[0].enter & 1u) push(v[0].c0);
      sp = min(sp + total, kStack);
"""
# one thread per ray: the group is one thread, its stack in local memory
V5_THREAD = [("constexpr int kRayLanes = 4;", "constexpr int kRayLanes = 1;"),
             ("  __shared__ int stacks[kRays * kStackStride];\n", "  int stacks[kStack];\n"),
             ("  int* stack = stacks + (threadIdx.x / kRayLanes) * kStackStride;\n", "  int* stack = stacks;\n")]
# the walk before the redesign (the reference's order, every popped row prefetched into
# L1, then expand_node's and test_leaf's loads), one thread per listed lane
V5_OLD_WALK = """  walk_list<1>(header, list, [&](int i) {
    const Ray r = load_ray(i, rox, roy, roz, rdx, rdy, rdz, tmin);
    Hit h{tmax[i], -1.0f, -1.0f, 0.0f, 0.0f};
    stack[0] = root;
    int sp = 1;
    bool done = false;
    auto push = [&](int code) {
      if (sp < kStack) {
        stack[sp++] = code;
      } else {
        ++dropped;
      }
    };
    while (sp > 0 && !done) {
      const int k = sp < kMultipop ? sp : kMultipop;
      int grp[kMultipop];
#pragma unroll
      for (int j = 0; j < kMultipop; ++j) {
        grp[j] = j < k ? stack[sp - 1 - j] : 0;
        if (j < k) {
          if (grp[j] < 0) {
            prefetch_leaf(tris128, grp[j]);
          } else {
            prefetch_l1(nodes + static_cast<size_t>(grp[j]) * 32);
          }
        }
      }
      sp -= k;
#pragma unroll
      for (int j = 0; j < kMultipop; ++j) {
        if (j < k && !done) {
          if (grp[j] < 0) {
            done = before::test_leaf(tris128, grp[j], r, kAny, h);
          } else {
            before::expand_node<2, false>(nodes, nullptr, grp[j], r, h.t, push);
          }
        }
      }
    }
    store_hit(i, h, out_t, out_rnode, out_tri, out_u, out_v);
  });
"""
V5_WALK = ("  walk_list<kRayLanes>(header, list, [&](int i) {\n", "  });\n")

LANE_ANY = runtime_anyhit("  unsigned int stuck = 0;\n")

# the one-thread-per-lane generic walk that the redesigns replaced, as traverse_bvh.cuh held it
# (its sidecar and split branches and test_leaf included; the split walk's kernel folded into its
# kernel and launch): the "every element off" variants put it before the entry point, which
# launches it
GENERIC = """namespace vkgr {
namespace before {

""" + TEST_LEAF + """template <int kLevels, bool kSidecar, typename Push>
__device__ __forceinline__ void expand_node(const float* __restrict__ nodes,
                                            const int* __restrict__ sidecar, int e, const Ray& r,
                                            float t_best, Push&& push) {
  constexpr int kArity = 1 << kLevels;
  constexpr int kRow = 8 * kArity;
  static_assert(!kSidecar || kLevels == 2, "the sidecar describes BVH4 rows");
  const float* row = nodes + static_cast<size_t>(e) * kRow;
  unsigned int hitmask = 0;
#pragma unroll
  for (int s = 0; s < kArity; ++s) {
    const float2* bp = reinterpret_cast<const float2*>(row + 6 * s);
    const float2 b0 = __ldg(bp), b1 = __ldg(bp + 1), b2 = __ldg(bp + 2);
    if (slab(b0.x, b0.y, b1.x, b1.y, b2.x, b2.y, r, t_best)) hitmask |= 1u << s;
  }
  if (!hitmask) return;
  unsigned int flip = 0;
  int4 sc_codes = make_int4(0, 0, 0, 0);
  if constexpr (kSidecar) {
    const int4* sc = reinterpret_cast<const int4*>(sidecar + static_cast<size_t>(e) * 8);
    sc_codes = __ldg(sc);
    const int4 a = __ldg(sc + 1);
    if (!axis_sign(static_cast<float>(a.x), r.sx, r.sy, r.sz)) flip |= 1u;
    if (!axis_sign(static_cast<float>(a.y), r.sx, r.sy, r.sz)) flip |= 2u;
    if (!axis_sign(static_cast<float>(a.z), r.sx, r.sy, r.sz)) flip |= 4u;
  } else {
#pragma unroll
    for (int k = 0; k < kArity - 1; ++k) {
      if (!axis_sign(__ldg(row + 7 * kArity + k), r.sx, r.sy, r.sz)) flip |= 1u << k;
    }
  }
#pragma unroll
  for (int p = kArity - 1; p >= 0; --p) {
    int path = 0;
#pragma unroll
    for (int d = 0; d < kLevels; ++d) {
      const int bit = (p >> (kLevels - 1 - d)) & 1;
      path = path * 2 + (bit ^ static_cast<int>((flip >> ((1 << d) - 1 + path)) & 1u));
    }
    if ((hitmask >> path) & 1u) {
      if constexpr (kSidecar) {
        push(path == 0 ? sc_codes.x : path == 1 ? sc_codes.y : path == 2 ? sc_codes.z : sc_codes.w);
      } else {
        push(static_cast<int>(__ldg(row + 6 * kArity + path)));
      }
    }
  }
}

template <int kLevels, int kStack, bool kSidecar, bool kSplit>
__device__ __forceinline__ Hit walk(const float* __restrict__ nodes,
                                    const int* __restrict__ sidecar,
                                    const float* __restrict__ tris, int root_code, const Ray& r,
                                    float tmax, bool anyhit, unsigned int& dropped) {
  Hit h{tmax, -1.0f, -1.0f, 0.0f, 0.0f};
  int stack[kStack];
  stack[0] = root_code;
  int sp = 1;
  while (sp > 0) {
    const int e = stack[--sp];
    if (e < 0) {
      if (test_leaf<kSplit>(tris, e, r, anyhit, h)) break;
      continue;
    }
    expand_node<kLevels, kSidecar>(nodes, sidecar, e, r, h.t, [&](int code) {
      if (kSplit && code == -1) return;
      if (sp < kStack) {
        stack[sp++] = code;
      } else {
        ++dropped;
      }
    });
  }
  return h;
}

template <int kLevels, int kStack, bool kSidecar, bool kSplit>
__global__ void __launch_bounds__(kBlock)
traverse_bvh_kernel(const float* __restrict__ nodes, const int* __restrict__ sidecar,
                    const float* __restrict__ tris128, int root_code,
                    const float* __restrict__ rox, const float* __restrict__ roy,
                    const float* __restrict__ roz, const float* __restrict__ rdx,
                    const float* __restrict__ rdy, const float* __restrict__ rdz,
                    const float* __restrict__ tmin, const float* __restrict__ tmax, int n,
                    int anyhit, float* __restrict__ out_t, int* __restrict__ out_rnode,
                    int* __restrict__ out_tri, float* __restrict__ out_u,
                    float* __restrict__ out_v, unsigned int* __restrict__ overflow) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(i, rox, roy, roz, rdx, rdy, rdz, tmin);
  unsigned int dropped = 0;
  const Hit h = walk<kLevels, kStack, kSidecar, kSplit>(nodes, sidecar, tris128, root_code, r,
                                                        tmax[i], anyhit != 0, dropped);
  store_hit(i, h, out_t, out_rnode, out_tri, out_u, out_v);
  if (dropped) atomicAdd(overflow, dropped);
}

template <int kLevels, int kStack, bool kSidecar = false, bool kSplit = false>
int launch_traverse_bvh(const float* nodes, const int* sidecar, const float* tris128,
                        int root_code, const float* rox, const float* roy, const float* roz,
                        const float* rdx, const float* rdy, const float* rdz, const float* tmin,
                        const float* tmax, int n, int anyhit, float* out_t, int* out_rnode,
                        int* out_tri, float* out_u, float* out_v, unsigned int* overflow,
                        void* stream) {
  if (n <= 0) return 0;
  const int grid = (n + kBlock - 1) / kBlock;
  traverse_bvh_kernel<kLevels, kStack, kSidecar, kSplit>
      <<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
          nodes, sidecar, tris128, root_code, rox, roy, roz, rdx, rdy, rdz, tmin, tmax, n, anyhit,
          out_t, out_rnode, out_tri, out_u, out_v, overflow);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace before
}  // namespace vkgr

"""
ENTRY_END = "scratch, s);\n}\n"


def walk_before(entry, first, last, launch, kernel=""):
    """The "every element off" variant of a kernel whose C entry point
    `entry` runs from `first` to `last`: GENERIC and `kernel` (the old
    kernel on GENERIC's walk, if GENERIC's own does not serve) before the
    entry, whose body becomes `launch`."""
    head = f'extern "C" int {entry}('
    return [(head, GENERIC + kernel + head), ((first, last), launch)]


# traverse_bvh2.cu (v2)
V2_VISIT = """    const Visit2 v = visit2(nodes, e, r, h.t);
    if (v.enter) {  // descend into the nearer entered child; push the far one if it is entered too
      if (v.enter == 3u) push(v.c1);
      e = (v.enter & 1u) ? v.c0 : v.c1;
      return false;
    }
"""
# push both entered children, far first, and pop the nearer next (walk<1, ...>'s stack traffic)
V2_PUSH_BOTH = """    const Visit2 v = visit2(nodes, e, r, h.t);
    if (v.enter & 2u) push(v.c1);
    if (v.enter & 1u) push(v.c0);
"""
# visit2 with expand_node's loads: six float2 box loads, then the axis and the entered codes
V2_FLOAT2_VISIT = """  const float* row = nodes + static_cast<size_t>(e) * 16;
  const float2* bp = reinterpret_cast<const float2*>(row);
  const float2 a0 = __ldg(bp), a1 = __ldg(bp + 1), a2 = __ldg(bp + 2);
  const float2 a3 = __ldg(bp + 3), a4 = __ldg(bp + 4), a5 = __ldg(bp + 5);
  const bool h0 = slab(a0.x, a0.y, a1.x, a1.y, a2.x, a2.y, r, t_best);
  const bool h1 = slab(a3.x, a3.y, a4.x, a4.y, a5.x, a5.y, r, t_best);
  if (!h0 && !h1) return Visit2{0, 0, 0u};
  const bool flip = !axis_sign(__ldg(row + 14), r.sx, r.sy, r.sz);  // the right child is nearer
  const int s0 = h0 ? static_cast<int>(__ldg(row + 12)) : 0;
  const int s1 = h1 ? static_cast<int>(__ldg(row + 13)) : 0;
"""
V2_ROW_LOADS_OFF = [
    (("  const float4* row = reinterpret_cast<const float4*>(nodes + static_cast<size_t>(e) * 16);",
      "  const bool flip = !axis_sign(q3.z, r.sx, r.sy, r.sz);  // the right child is nearer\n"), V2_FLOAT2_VISIT, ROWS),
    ("    if (leaf(tris128, e, r, anyhit, h)) return true;",
     "    if (test_leaf(tris128, e, r, anyhit, h)) return true;"), RESTORE_TEST_LEAF]
V2_PUSH = "    if (sp < kStack) {\n      stack[sp++] = code;"
V2_ANY = runtime_anyhit("  int stack[kStack];\n  unsigned dropped = 0;\n")
# the walk before the redesign: the generic walk, one thread per lane
V2_OLD = walk_before("vkgr_traverse_bvh2", "  using namespace vkgr::bvh2;\n", ENTRY_END,
                     """  return vkgr::before::launch_traverse_bvh<1, 128>(nodes_fi, nullptr, tris128, root_code, rox, roy,
                                           roz, rdx, rdy, rdz, tmin, tmax, n, anyhit, out_t,
                                           out_rnode, out_tri, out_u, out_v, overflow, stream);
}
""")

# traverse_bvh16.cu (v6)
V6_GROUP_SPAN = ("  __shared__ int stacks[kRays * kStackStride];\n", "  if (dropped) atomicAdd(overflow, dropped);\n")
# one thread per listed lane walking GENERIC's walk<4, ...> (stack in local memory)
V6_THREAD = [(V6_GROUP_SPAN, """  unsigned dropped = 0;
  walk_list<1>(header, list, [&](int i) {
    const Ray r = load_ray(i, rox, roy, roz, rdx, rdy, rdz, tmin);
    const Hit h = before::walk<4, kStack, false, false>(nodes, nullptr, tris128, root, r, tmax[i], kAny,
                                                        dropped);
    store_hit(i, h, out_t, out_rnode, out_tri, out_u, out_v);
  });
  if (dropped) atomicAdd(overflow, dropped);
"""), ("static_cast<long long>(n) * kRayLanes", "n"), (AFTER_INCLUDES, AFTER_INCLUDES + "\n" + GENERIC)]
V6_ANY = runtime_anyhit("  unsigned dropped = 0;\n")
V6_OLD = walk_before("vkgr_traverse_bvh16", "  using namespace vkgr::bvh16;\n", ENTRY_END,
                     """  return vkgr::before::launch_traverse_bvh<4, 256>(nodes16_fi, nullptr, tris128, root_code, rox,
                                           roy, roz, rdx, rdy, rdz, tmin, tmax, n, anyhit, out_t,
                                           out_rnode, out_tri, out_u, out_v, overflow, stream);
}
""")
# the group's stacks in device memory (cached in L1, where local memory lives), a slice per
# ray of each block the persistent grid can hold (at most 16 blocks an SM)
V6_DEVICE_STACK = [
    (WALK_TEMPLATE, "__device__ int device_stacks[4096 * kRays * kStackStride];\n\n" + WALK_TEMPLATE),
    ("  __shared__ int stacks[kRays * kStackStride];\n", ""),
    ("  int* stack = stacks + (threadIdx.x / kRayLanes) * kStackStride;\n",
     "  int* stack = device_stacks + (blockIdx.x * kRays + threadIdx.x / kRayLanes) * kStackStride;\n")]

# traverse_bvh4_sidecar.cu (v7) and traverse_bvh4_split.cu (packet4), both on sidecar_walk.cuh;
# whole-row loads off: visit_sc with expand_node's loads (three float2 per box, then, where a box
# is entered, the int row's two int4), one triangle at a time
SC_FLOAT2_VISIT = """  const float* row = nodes + static_cast<size_t>(e) * 32;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const float2* bp = reinterpret_cast<const float2*>(row + 6 * s);
    const float2 b0 = __ldg(bp), b1 = __ldg(bp + 1), b2 = __ldg(bp + 2);
    if (slab(b0.x, b0.y, b1.x, b1.y, b2.x, b2.y, r, t_best)) hitmask |= 1u << s;
  }
  if (!hitmask) return Visit{0, 0, 0, 0, 0u};
  const int4* meta = reinterpret_cast<const int4*>(sidecar + static_cast<size_t>(e) * 8);
  const int4 codes = __ldg(meta), axes = __ldg(meta + 1);
  if (!axis_sign(axes.x, r.sx, r.sy, r.sz)) flip |= 1u;
  if (!axis_sign(axes.y, r.sx, r.sy, r.sz)) flip |= 2u;
  if (!axis_sign(axes.z, r.sx, r.sy, r.sz)) flip |= 4u;
"""
SC_ROW_LOADS_OFF = [
    (("  const float4* box = reinterpret_cast<const float4*>",
      "  if (!axis_sign(axes.z, r.sx, r.sy, r.sz)) flip |= 4u;\n"), SC_FLOAT2_VISIT, ROWS),
    ("    if (leaf<kSplit>(tris, e, r, anyhit, h)) return true;",
     "    if (test_leaf<kSplit>(tris, e, r, anyhit, h)) return true;", SC), RESTORE_TEST_LEAF]
SC_TEMPLATE = "template <bool kAny, bool kSplit>\n__global__ void __launch_bounds__(kBlock)\nwalk_kernel("
V7_ANY = [(SC_TEMPLATE, SC_TEMPLATE.replace("bool kAny", "bool kAnyT"), SC),
          (BVH4_STACK, BVH4_STACK + RUNTIME_ANY, SC)]
V7_OLD = walk_before("vkgr_traverse_bvh4_sidecar", "  using namespace vkgr::sc4;\n", ENTRY_END,
                     """  return vkgr::before::launch_traverse_bvh<2, 64, true>(nodes4_fi, nodes4_sc, tris128, root_code, rox,
                                                 roy, roz, rdx, rdy, rdz, tmin, tmax, n, anyhit,
                                                 out_t, out_rnode, out_tri, out_u, out_v, overflow,
                                                 stream);
}
""")
PACKET4_OLD = walk_before("vkgr_traverse_bvh4_split", "  using namespace vkgr::sc4;\n",
                          "static_cast<cudaStream_t>(stream));\n}\n",
                          """  return vkgr::before::launch_traverse_bvh<2, 64, true, true>(nodes4_f, nodes4_i, tris, 0, rox, roy,
                                                       roz, rdx, rdy, rdz, tmin, tmax, n, 0, out_t,
                                                       out_rnode, out_row, out_u, out_v, overflow,
                                                       stream);
}
""")

# traverse_bvh4_leafqueue.cu (v8)
V8_HINT = "  if (code < 0) prefetch_leaf(tris128, code);\n"
V8_LEAF = "  if (code < 0 && leaf(tris128, code, r, anyhit, h)) return true;\n"
V8_ROW_LOADS_OFF = [ROW_LOADS_OFF[0], (V8_LEAF, V8_LEAF.replace("leaf(", "test_leaf(")), RESTORE_TEST_LEAF]
# the queued leaf's first kTriBatch triangles loaded into registers before the internal row's
# tests, then tested (leaf's arithmetic and order); the rest of the leaf by leaf() from slot
# kTriBatch (the same row, read kTriBatch slots in)
V8_FIRST_BATCH_LOADS = """  int row = 0, cnt = 0;  // the queued leaf's row and triangle count
  if (code < 0) {
    row = (-code - 1) / 16;
    cnt = min(-code - 1 - row * 16, kLeafSlots);
  }
  const float4* tr = reinterpret_cast<const float4*>(tris128 + static_cast<size_t>(row) * 128);
  float4 a[kTriBatch], b[kTriBatch], d[kTriBatch];
#pragma unroll
  for (int k = 0; k < kTriBatch; ++k) {
    if (k < cnt) {
      a[k] = __ldg(tr + 4 * k);
      b[k] = __ldg(tr + 4 * k + 1);
      d[k] = __ldg(tr + 4 * k + 2);
    }
  }
"""
V8_FIRST_BATCH_TESTS = """#pragma unroll
  for (int k = 0; k < kTriBatch; ++k) {
    if (k >= cnt) break;
    float uu, vv, tt;
    if (triangle(a[k].x, a[k].y, a[k].z, a[k].w - a[k].x, b[k].x - a[k].y, b[k].y - a[k].z,
                 b[k].z - a[k].x, b[k].w - a[k].y, d[k].x - a[k].z, r, h.t, uu, vv, tt)) {
      h.t = anyhit ? -1.0f : tt;
      h.rn = d[k].y;
      h.tri = d[k].z;
      h.u = uu;
      h.v = vv;
      if (anyhit) return true;
    }
  }
  if (cnt > kTriBatch && leaf(tris128 + kTriBatch * 16, -(row * 16 + cnt - kTriBatch) - 1, r, anyhit, h)) {
    return true;
  }
"""
V8_ANY = runtime_anyhit("  int stack[kStackInternal];\n  int queue[kQueue];\n  unsigned dropped = 0;\n")
# the one-thread-per-lane v8 kernel that the redesign replaced, on GENERIC's expand_node
V8_OLD_KERNEL = """namespace vkgr {
namespace before {

__global__ void __launch_bounds__(kBlock)
traverse_bvh_kernel_lq(const float* __restrict__ nodes4_fi, const float* __restrict__ tris128,
                       int root_code, const float* __restrict__ rox, const float* __restrict__ roy,
                       const float* __restrict__ roz, const float* __restrict__ rdx,
                       const float* __restrict__ rdy, const float* __restrict__ rdz,
                       const float* __restrict__ tmin, const float* __restrict__ tmax, int n,
                       int anyhit, float* __restrict__ out_t, int* __restrict__ out_rnode,
                       int* __restrict__ out_tri, float* __restrict__ out_u,
                       float* __restrict__ out_v, unsigned int* __restrict__ overflow) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(i, rox, roy, roz, rdx, rdy, rdz, tmin);
  Hit h{tmax[i], -1.0f, -1.0f, 0.0f, 0.0f};
  unsigned int dropped = 0;
  int stack[v8::kStackInternal];
  int queue[v8::kQueue];
  int sp = 0, lq = 0;
  if (root_code >= 0) {
    stack[sp++] = root_code;
  } else {
    queue[lq++] = root_code;
  }
  auto push = [&](int code) {
    if (code < 0) {
      if (lq < v8::kQueue) {
        queue[lq++] = code;
      } else {
        ++dropped;
      }
    } else if (sp < v8::kStackInternal) {
      stack[sp++] = code;
    } else {
      ++dropped;
    }
  };
  while (sp > 0 || lq > 0) {
    const bool take_internal = sp > 0 && lq < v8::kGate;
    const int e = take_internal ? stack[--sp] : 0;
    const int code = lq > 0 ? queue[--lq] : 0;
    if (code < 0) prefetch_leaf(tris128, code);
    if (take_internal) expand_node<2, false>(nodes4_fi, nullptr, e, r, h.t, push);
    if (code < 0 && test_leaf(tris128, code, r, anyhit != 0, h)) break;
  }
  store_hit(i, h, out_t, out_rnode, out_tri, out_u, out_v);
  if (dropped) atomicAdd(overflow, dropped);
}

}  // namespace before
}  // namespace vkgr

"""
V8_OLD = walk_before("vkgr_traverse_bvh4_leafqueue", "  using namespace vkgr::v8;\n", ENTRY_END,
                     """  if (n <= 0) return 0;
  const int grid = (n + vkgr::kBlock - 1) / vkgr::kBlock;
  vkgr::before::traverse_bvh_kernel_lq<<<grid, vkgr::kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      nodes4_fi, tris128, root_code, rox, roy, roz, rdx, rdy, rdz, tmin, tmax, n, anyhit, out_t,
      out_rnode, out_tri, out_u, out_v, overflow);
  return static_cast<int>(cudaGetLastError());
}
""", V8_OLD_KERNEL)

# traverse_bvh2_split.cu (v1)
V1_DESCEND = """    if (near_hit || far_hit) {  // descend into the nearer entered child; push the far one if both are
      if (near_hit && far_hit) push(far_c);
      next = near_hit ? near_c : far_c;
    } else {
      if (sp == 0) return;
      next = stack[--sp];
    }
"""
# push both entered children, far first, and pop the nearer next (the kernel before's stack traffic)
V1_PUSH_BOTH = """    if (far_hit) push(far_c);
    if (near_hit) push(near_c);
    if (sp == 0) return;
    next = stack[--sp];
"""
V1_LEAF = """      leaf<true>(tris, -(nd.m.z * 16 + nd.m.w) - 1, r, false, h);
      if (sp == 0) return;
      nd = fetch(nodes_f, nodes_i, stack[--sp]);
"""
# the next node popped and its loads issued before the leaf's tests, which then run against the
# t_best the next node's slab tests will see (the same outputs)
V1_FETCH_BEFORE = """      const int code = -(nd.m.z * 16 + nd.m.w) - 1;
      const bool more = sp > 0;
      if (more) nd = fetch(nodes_f, nodes_i, stack[--sp]);
      leaf<true>(tris, code, r, false, h);
      if (!more) return;
"""
V1_WALK = "__global__ void __launch_bounds__(kBlock)\nwalk_kernel("
# the one-thread-per-lane kernel that the redesign replaced, on GENERIC's test_leaf
V1_OLD_KERNEL = """namespace vkgr {
namespace before {

__global__ void __launch_bounds__(kBlock)
traverse_bvh_kernel_split2(const float* __restrict__ nodes_f, const int* __restrict__ nodes_i,
                           const float* __restrict__ tris, const float* __restrict__ rox,
                           const float* __restrict__ roy, const float* __restrict__ roz,
                           const float* __restrict__ rdx, const float* __restrict__ rdy,
                           const float* __restrict__ rdz, const float* __restrict__ tmin,
                           const float* __restrict__ tmax, int n, float* __restrict__ out_t,
                           int* __restrict__ out_rnode, int* __restrict__ out_row,
                           float* __restrict__ out_u, float* __restrict__ out_v,
                           unsigned int* __restrict__ overflow) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(i, rox, roy, roz, rdx, rdy, rdz, tmin);
  Hit h{tmax[i], -1.0f, -1.0f, 0.0f, 0.0f};
  unsigned int dropped = 0;
  int stack[128];
  stack[0] = 0;
  int sp = 1;
  while (sp > 0) {
    const int node = stack[--sp];
    const int4* meta = reinterpret_cast<const int4*>(nodes_i + static_cast<size_t>(node) * 8);
    const float4* box = reinterpret_cast<const float4*>(nodes_f + static_cast<size_t>(node) * 16);
    const int4 m0 = __ldg(meta);  // left, right, first, count
    const int4 m1 = __ldg(meta + 1);  // parent, axis, pad, pad
    const float4 b0 = __ldg(box), b1 = __ldg(box + 1), b2 = __ldg(box + 2);
    if (m0.w > 0) {
      test_leaf<true>(tris, -(m0.z * 16 + m0.w) - 1, r, false, h);
      continue;
    }
    const bool hit_l = slab(b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, r, h.t);
    const bool hit_r = slab(b1.z, b1.w, b2.x, b2.y, b2.z, b2.w, r, h.t);
    const bool l_near = axis_sign(static_cast<float>(m1.y), r.sx, r.sy, r.sz);
    const int near_c = l_near ? m0.x : m0.y;
    const int far_c = l_near ? m0.y : m0.x;
    const bool near_hit = l_near ? hit_l : hit_r;
    const bool far_hit = l_near ? hit_r : hit_l;
    if (far_hit) {
      if (sp < 128) {
        stack[sp++] = far_c;
      } else {
        ++dropped;
      }
    }
    if (near_hit) {
      if (sp < 128) {
        stack[sp++] = near_c;
      } else {
        ++dropped;
      }
    }
  }
  store_hit(i, h, out_t, out_rnode, out_row, out_u, out_v);
  if (dropped) atomicAdd(overflow, dropped);
}

}  // namespace before
}  // namespace vkgr

"""
V1_OLD = walk_before("vkgr_traverse_bvh2_split", "  using namespace vkgr::bvh2s;\n",
                     "static_cast<cudaStream_t>(stream));\n}\n",
                     """  if (n <= 0) return 0;
  const int grid = (n + vkgr::kBlock - 1) / vkgr::kBlock;
  vkgr::before::traverse_bvh_kernel_split2<<<grid, vkgr::kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      nodes_f, nodes_i, tris, rox, roy, roz, rdx, rdy, rdz, tmin, tmax, n, out_t, out_rnode, out_row,
      out_u, out_v, overflow);
  return static_cast<int>(cudaGetLastError());
}
""", V1_OLD_KERNEL)

# megakernel.cu: refill off = a warp takes paths only when all 32 of its lanes are idle, and
# runs them to their end (while-while by path)
MEGA_REFILL = "    if (more && idle != 0u) {"
# the one-thread-per-ray megakernel that the redesign replaced, on GENERIC's walk
MEGA_OLD_KERNEL = """namespace vkgr {
namespace before {

__global__ void __launch_bounds__(kBlock)
render_mega_kernel(const float* __restrict__ nodes4_fi, const float* __restrict__ tris128,
                   int root_code, const float* __restrict__ ro, const float* __restrict__ rd,
                   const unsigned int* __restrict__ seeds, int n, int per, int depth,
                   float* __restrict__ out, unsigned int* __restrict__ overflow) {
  using namespace mega;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int g = i / per;
  const int l = i - g * per;
  const size_t b4 = static_cast<size_t>(g) * 4 * per + l;
  float ox = ro[b4], oy = ro[b4 + per], oz = ro[b4 + 2 * per];
  float dx = rd[b4], dy = rd[b4 + per], dz = rd[b4 + 2 * per];
  const float tmin = rd[b4 + 3 * per];
  unsigned int seed = seeds[static_cast<size_t>(g) * per + l];
  bool alive = true;
  float radiance = 0.0f, throughput = 1.0f, t = 0.0f;
  unsigned int dropped = 0;
  for (int b = 0; b < depth; ++b) {
    bool hit = false;
    if (alive) {
      const Ray r = make_ray(ox, oy, oz, dx, dy, dz, tmin);
      const Hit h = walk<2, 64, false, false>(nodes4_fi, nullptr, tris128, root_code, r, kFar, false,
                                              dropped);
      t = h.t;
      hit = h.tri >= 0.0f;
    } else {
      t = -1.0f;
    }
    radiance = radiance + ((alive && !hit) ? kSky : 0.0f) * throughput;
    alive = alive && hit;
    throughput = throughput * (alive ? kAlbedo : 1.0f);
    if (b < depth - 1) {
      if (alive) {
        ox = ox + t * dx;
        oy = oy + t * dy;
        oz = oz + t * dz;
      }
      const float u1 = lcg_uniform(seed);
      const float u2 = lcg_uniform(seed);
      const float u3 = lcg_uniform(seed);
      const float nx = 2.0f * u1 - 1.0f;
      const float ny = 2.0f * u2 - 1.0f;
      float nz = 2.0f * u3 - 1.0f;
      nz = nz + (nz >= 0.0f ? 0.05f : -0.05f);
      const float inv_len = 1.0f / sqrtf(nx * nx + ny * ny + nz * nz);
      if (alive) {
        dx = nx * inv_len;
        dy = ny * inv_len;
        dz = nz * inv_len;
      }
    }
  }
  const size_t b2 = static_cast<size_t>(g) * 2 * per + l;
  out[b2] = radiance;
  out[b2 + per] = t;
  if (dropped) atomicAdd(overflow, dropped);
}

}  // namespace before
}  // namespace vkgr

"""
MEGA_OLD = walk_before("vkgr_render_mega", "  using namespace vkgr::mega;\n",
                       "  return static_cast<int>(cudaGetLastError());\n}\n",
                       """  if (n <= 0) return 0;
  const int grid = (n + vkgr::kBlock - 1) / vkgr::kBlock;
  vkgr::before::render_mega_kernel<<<grid, vkgr::kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      nodes4_fi, tris128, root_code, ro, rd, seeds, n, per, depth, out, overflow);
  return static_cast<int>(cudaGetLastError());
}
""", MEGA_OLD_KERNEL)

# kernel source -> variant -> [(old text, new text[, header]) or ((first, last), new text of the
# span first..last[, header])]
VARIANTS = {
    "traverse_bvh4.cu": {
        "source": [],
        "compaction off (every lane listed and walked)": COMPACTION_OFF,
        "whole-row loads off": ROW_LOADS_OFF,
        "any-hit as a template off (a runtime flag)": runtime_anyhit(BVH4_STACK),
        "next node in a register": [
            (("    // every entered child, far first", "    if (v.enter & 1u) push(v.c0);\n"),
             NEXT_IN_REGISTER, ROWS)],
        "stack in shared memory": [
            ("  int stack[kStackCap];\n",
             "  __shared__ int stack_columns[kStackCap * kBlock];  // entry d of thread t at d * kBlock + t\n"
             "  int* stack = stack_columns + threadIdx.x;\n"),
            ("      stack[sp++] = code;", "      stack[kBlock * sp++] = code;", ROWS),
            ("  e = stack[--sp];", "  e = stack[kBlock * --sp];", ROWS)],
        "refill at 16 idle lanes, 4 steps": [(BVH4_WALK, REFILL.format(at=16, steps=4))],
        "refill at 16 idle lanes, 1 step": [(BVH4_WALK, REFILL.format(at=16, steps=1))],
        "refill at 8 idle lanes, 4 steps": [(BVH4_WALK, REFILL.format(at=8, steps=4))],
        "triangle batch 2": [("kTriBatch = 4;", "kTriBatch = 2;", ROWS)],
        "triangle batch 8": [("kTriBatch = 4;", "kTriBatch = 8;", ROWS)],
        "64 registers": [(WALK_TEMPLATE, WALK_TEMPLATE.replace("(kBlock)", "(kBlock, 8)"))],
        "fetch 32": [("const int per = min(32 / kGroup, max(1, (count + warps - 1) / warps));",
                      "const int per = 32 / kGroup;", LIVE)],
        "prefetch pushed rows": [
            (PUSH, "    if (code >= 0) prefetch_l1(nodes + static_cast<size_t>(code) * 32);\n" + PUSH, ROWS)],
        "every element off (compaction, whole-row loads, any-hit template)":
            COMPACTION_OFF + ROW_LOADS_OFF + runtime_anyhit(BVH4_STACK),
    },
    "traverse_lanes.cu": {
        "source": [],
        "compaction off (every lane listed and walked)": COMPACTION_OFF,
        "any-hit as a template off (a runtime flag)": LANE_ANY,
        "every element off (compaction, any-hit template)": COMPACTION_OFF + LANE_ANY,
    },
    "traverse_bvh4_multipop.cu": {
        "source": [],
        "order off (the reference's order)": [(V5_ORDER_SPAN, V5_OLD_ORDER)],
        "one thread per ray (whole-row loads, one member after the other)": V5_THREAD,
        "two threads per ray": [("constexpr int kRayLanes = 4;", "constexpr int kRayLanes = 2;")],
        "compaction off (every lane listed and walked)": COMPACTION_OFF,
        "any-hit as a template off (a runtime flag)": runtime_anyhit("  unsigned dropped = 0;\n"),
        "every element off (the walk before the redesign)":
            V5_THREAD + [(V5_WALK, V5_OLD_WALK), (AFTER_INCLUDES, AFTER_INCLUDES + "\n" + GENERIC)] + COMPACTION_OFF
            + runtime_anyhit("  unsigned dropped = 0;\n"),
    },
    "traverse_bvh16.cu": {
        "source": [],
        "four threads a ray": [("constexpr int kRayLanes = 8;", "constexpr int kRayLanes = 4;")],
        "one thread a ray, compaction only (the generic walk, its stack in local memory)": V6_THREAD,
        "one thread a ray, compaction only, 64 registers":
            V6_THREAD + [(WALK_TEMPLATE, WALK_TEMPLATE.replace("(kBlock)", "(kBlock, 8)"))],
        "stack in device memory (L1-cached, as local memory is)": V6_DEVICE_STACK,
        "compaction off (every lane listed and walked)": COMPACTION_OFF,
        "any-hit as a template off (a runtime flag)": V6_ANY,
        "every element off (the walk before the redesign)": V6_OLD,
    },
    "traverse_bvh2.cu": {
        "source": [],
        "compaction off (every lane listed and walked)": COMPACTION_OFF,
        "whole-row loads off": V2_ROW_LOADS_OFF,
        "any-hit as a template off (a runtime flag)": V2_ANY,
        "next node in a register off (push both, pop the nearer)": [(V2_VISIT, V2_PUSH_BOTH)],
        "prefetch pushed rows": [
            (V2_PUSH, "    if (code >= 0) prefetch_l1(nodes + static_cast<size_t>(code) * 16);\n" + V2_PUSH)],
        "every element off (the walk before the redesign)": V2_OLD,
    },
    "traverse_bvh4_sidecar.cu": {
        "source": [],
        "compaction off (every lane listed and walked)": COMPACTION_OFF,
        "whole-row loads off": SC_ROW_LOADS_OFF,
        "any-hit as a template off (a runtime flag)": V7_ANY,
        "every element off (the walk before the redesign)": V7_OLD,
    },
    "traverse_bvh4_split.cu": {
        "source": [],
        "compaction off (every lane listed and walked)": COMPACTION_OFF,
        "whole-row loads off": SC_ROW_LOADS_OFF,
        "triangle batch 2": [("kTriBatch = 4;", "kTriBatch = 2;", ROWS)],
        "triangle batch 8": [("kTriBatch = 4;", "kTriBatch = 8;", ROWS)],
        "every element off (the walk before the redesign)": PACKET4_OLD,
    },
    "traverse_bvh4_leafqueue.cu": {
        "source": [],
        "compaction off (every lane listed and walked)": COMPACTION_OFF,
        "whole-row loads off": V8_ROW_LOADS_OFF,
        "leaf's first triangle batch into registers (no L1 hint)": [
            (V8_HINT, V8_FIRST_BATCH_LOADS), (V8_LEAF, V8_FIRST_BATCH_TESTS)],
        "leaf's first triangle batch into registers, its lines also hinted": [
            (V8_HINT, V8_HINT + V8_FIRST_BATCH_LOADS), (V8_LEAF, V8_FIRST_BATCH_TESTS)],
        "queue 8": [("constexpr int kQueue = 16;", "constexpr int kQueue = 8;")],
        "queue 32": [("constexpr int kQueue = 16;", "constexpr int kQueue = 32;")],
        "any-hit as a template off (a runtime flag)": V8_ANY,
        "every element off (the walk before the redesign)": V8_OLD,
    },
    "traverse_bvh2_split.cu": {
        "source": [],
        "compaction off (every lane listed and walked)": COMPACTION_OFF,
        "descend off (push both, pop the nearer)": [(V1_DESCEND, V1_PUSH_BOTH)],
        "batched leaf off (test_leaf, one triangle at a time)": [
            RESTORE_TEST_LEAF, (V1_LEAF, V1_LEAF.replace("leaf<", "test_leaf<"))],
        "leaf-time prefetch on (the next node's loads before the leaf's tests)": [(V1_LEAF, V1_FETCH_BEFORE)],
        "triangle batch 2": [("kTriBatch = 4;", "kTriBatch = 2;", ROWS)],
        "64 registers": [(V1_WALK, V1_WALK.replace("(kBlock)", "(kBlock, 8)"))],
        "every element off (the walk before the redesign)": V1_OLD,
    },
    "megakernel.cu": {
        "source": [],
        "refill off (a warp runs 32 paths to their end, then takes 32 more)": [
            (MEGA_REFILL, MEGA_REFILL.replace("idle != 0u", "idle == kFull"))],
        "whole-row loads off": ROW_LOADS_OFF,
        "every element off (the walk before the redesign)": MEGA_OLD,
    },
}
# kernel -> its variants whose visit order differs from the source's: t equal on every lane, ids
# except ties
ORDER = {"traverse_bvh4_multipop.cu": {"order off (the reference's order)",
                                       "every element off (the walk before the redesign)"},
         # another queue gates at another length, so the internal visits see other t_bests
         "traverse_bvh4_leafqueue.cu": {"queue 8", "queue 32"}}


def _files(kernel):
    """The texts a variant of `kernel` may edit: the kernel and the shared headers."""
    return {name: (cuda_lib._CSRC / name).read_text() for name in (kernel, LIVE, ROWS, SC)}


def variant_sources(kernel, name, files=None):
    """{file name: text} of variant `name` of `kernel` (the kernel's source
    and every header it edits); files: the original texts (default: those
    of csrc/). Raises ValueError unless each substitution matches its file
    exactly once."""
    files = dict(files or _files(kernel))
    out = {kernel: files[kernel]}
    for old, new, *where in VARIANTS[kernel][name]:
        target = where[0] if where else kernel
        src = out.get(target, files[target])
        if isinstance(old, tuple):
            first, last = old
            if src.count(first) != 1:
                raise ValueError(f"{name}: {first!r} is not in {target} exactly once")
            a = src.index(first)
            b = src.find(last, a)
            if b < 0:
                raise ValueError(f"{name}: {last!r} does not follow {first!r} in {target}")
            src = src[:a] + new + src[b + len(last):]
        else:
            if src.count(old) != 1:
                raise ValueError(f"{name}: {old!r} is not in {target} exactly once")
            src = src.replace(old, new)
        out[target] = src
    return out


def _dir(kernel, name):
    return OUT / Path(kernel).stem / re.sub(r"\W+", "_", name).strip("_")


def _nvcc(nvcc, args):
    return subprocess.Popen([nvcc, *args], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _wait(procs):
    """name -> (return code, log) of each process."""
    out = {}
    for key, proc in procs.items():
        log, _ = proc.communicate(timeout=900)
        out[key] = (proc.returncode, log)
    return out


def build(kernel):
    """One library per variant of `kernel`: name -> cuda_lib.KernelLibrary,
    whose compiler log is the variant's kernel compile. A variant whose
    build fails is printed and left out; the source's must build."""
    nvcc = cuda_lib._nvcc()
    common = OUT / Path(kernel).stem / "common"
    common.mkdir(parents=True, exist_ok=True)
    others = [p for p in sorted(cuda_lib._CSRC.glob("*.cu")) if p.name != kernel]
    flags = [*cuda_lib.COMPILE_FLAGS, "-I", str(cuda_lib._CSRC), "-c"]
    procs = {p.name: _nvcc(nvcc, [*flags, "-o", str(common / f"{p.stem}.o"), str(p)]) for p in others}
    obj = f"{Path(kernel).stem}.o"
    for name in VARIANTS[kernel]:
        d = _dir(kernel, name)
        d.mkdir(parents=True, exist_ok=True)
        files = _files(kernel)
        files.update(variant_sources(kernel, name, files))
        for fname, text in files.items():  # every header beside the kernel, so that each includes the variant's
            (d / fname).write_text(text)
        procs[name] = _nvcc(nvcc, [*flags, "-o", str(d / obj), str(d / kernel)])
    done = _wait(procs)
    for p in others:
        if done[p.name][0] != 0:
            raise RuntimeError(f"nvcc failed on {p.name}:\n{done[p.name][1]}")
    names = [name for name in VARIANTS[kernel] if done[name][0] == 0]
    for name in VARIANTS[kernel]:
        if name not in names:
            cs.log(f"[tuning] {kernel} {name}: the build failed, left out:\n{done[name][1]}")
    cs.require("source" in names, f"{kernel}: the unchanged source does not build")
    objs = [str(common / f"{p.stem}.o") for p in others]
    linked = _wait({name: _nvcc(nvcc, [*cuda_lib.LINK_FLAGS, "-o", str(_dir(kernel, name) / "libvkgr_kernels.so"),
                                       str(_dir(kernel, name) / obj), *objs]) for name in names})
    cs.require(all(rc == 0 for rc, _ in linked.values()), f"{kernel}: a link failed: {linked}")
    return {name: cuda_lib.KernelLibrary(_dir(kernel, name) / "libvkgr_kernels.so", 0.0,
                                         f"== {kernel}\n{done[name][1]}") for name in names}


@contextlib.contextmanager
def loaded(lib):
    """Every wrapper launches from lib inside the block."""
    saved = cuda_lib._loaded
    cuda_lib._loaded = lib
    try:
        yield
    finally:
        cuda_lib._loaded = saved


# kernel source -> (kernel selection, VKGR_TRAVERSAL, recorded wrapper of ops.intersect,
# call(bvh, rays, anyhit))
KERNELS = {
    "traverse_bvh4.cu": (("v3", "v9"), "packet", "traverse_bvh4",
                         lambda bvh, rays, a: tb4.traverse_bvh4(bvh.nodes4_fi, bvh.tris128, bvh.root4_code,
                                                                *rays, anyhit=a)),
    "traverse_lanes.cu": (("lane", "lane_stream"), "packet", "traverse_lanes",
                          lambda bvh, rays, a: tlane.traverse_lanes(bvh.lane_entries, *rays, anyhit=a)),
    "traverse_bvh4_multipop.cu": (("v5", "v5"), "packet", "traverse_bvh4_multipop",
                                  lambda bvh, rays, a: tbmp.traverse_bvh4_multipop(
                                      bvh.nodes4_fi, bvh.tris128, bvh.root4_code, *rays, anyhit=a)),
    "traverse_bvh16.cu": (("v6", "v6"), "packet", "traverse_bvh16",
                          lambda bvh, rays, a: tb16.traverse_bvh16(bvh.nodes16_fi, bvh.tris128, *rays, anyhit=a)),
    "traverse_bvh2.cu": (("v2", "v2"), "packet", "traverse_bvh2",
                         lambda bvh, rays, a: tb2.traverse_bvh2(bvh.nodes_fi, bvh.tris128, bvh.root_code, *rays,
                                                                anyhit=a)),
    "traverse_bvh4_sidecar.cu": (("v7", "v7"), "packet", "traverse_bvh4_sidecar",
                                 lambda bvh, rays, a: tbsc.traverse_bvh4_sidecar(
                                     bvh.nodes4_fi, bvh.nodes4_sc, bvh.tris128, bvh.root4_code, *rays, anyhit=a)),
    # closest hit only: the any-hit rays are traced closest hit
    "traverse_bvh4_split.cu": (("v3", "v9"), "packet4", "traverse_bvh4_split",
                               lambda bvh, rays, a: tb4s.traverse_bvh4_split(bvh.nodes4_f, bvh.nodes4_i, bvh.tris,
                                                                             *rays)),
    # v8 takes the (v3, v8) frame's 9 launches after bounce 0's closest hit
    "traverse_bvh4_leafqueue.cu": (("v3", "v8"), "packet", "traverse_bvh4_leafqueue",
                                   lambda bvh, rays, a: tblq.traverse_bvh4_leafqueue(
                                       bvh.nodes4_fi, bvh.tris128, bvh.root4_code, *rays, anyhit=a)),
    # no frame launches v1: it takes the (v2, v2) frame's traverse_bvh2 launches (the same binary
    # tree), closest hit only
    "traverse_bvh2_split.cu": (("v2", "v2"), "packet", "traverse_bvh2",
                               lambda bvh, rays, a: tb2s.traverse_bvh2_split(
                                   bvh.nodes_f, bvh.nodes_i, bvh.tris, *rays, root_leaf=bvh.bvh2_split_root_leaf)),
}
# kernel source -> the split tables its call reads beside the frame's (convert.SPLIT_FAMILIES)
SPLIT_TABLES = {"traverse_bvh2_split.cu": {"bvh2_split"}}
MEGA = "megakernel.cu"  # no recorded launches: tune_mega runs phase 8's camera rays


def profile(call, bvh, rays, anyhit):
    """Device us per call of each kernel of one launch."""
    for _ in range(3):
        call(bvh, rays, anyhit)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            call(bvh, rays, anyhit)
        torch.cuda.synchronize()
    return {e.key.replace("(anonymous namespace)::", "").split("(")[0].replace("void ", ""):
            e.device_time_total / e.count for e in prof.key_averages() if e.device_time_total > 0}


def _check(label, kernel, name, out, want):
    """Variant outputs against the source's on one launch: bit for bit, or
    for an ORDER variant t bit for bit and the lanes whose ids differ
    (equal-t ties) counted; returns that count."""
    if name not in ORDER.get(kernel, ()):
        cs.require(all(cs.same_bits(g, w) for g, w in zip(out, want)), f"{label} {name}: outputs differ from the source's")
        return 0
    cs.require(cs.same_bits(out[0], want[0]), f"{label} {name}: t differs from the source's")
    return int(((out[1] != want[1]) | (out[2] != want[2])).sum())


def tune(kernel, device, smi, scenes):
    """Every variant of `kernel` on the scenes' recorded launches and probe rays."""
    selection, traversal, wrapper, call = KERNELS[kernel]
    libs = build(kernel)
    registers = {}
    for name, lib in libs.items():
        res = cs.kernel_resources(lib.compiler_log, kernel)
        # the walk the variant launches: the generic kernel where "every element off" put one
        # beside the unused redesigned walk (v1's is not a template, so it is still compiled)
        registers[name] = {hit: {k: (res.get("walk (generic)") or res.get(f"walk {hit}", {})).get(k)
                                 for k in ("registers", "spill_stores", "smem")}
                           for hit in ("closest", "any")}
        cs.log(f"[tuning] {kernel} {name}: walk {registers[name]}")
    results = {"registers": registers, "scenes": {}}
    os.environ["VKGR_PRIMARY_KERNEL"], os.environ["VKGR_PACKET_KERNEL"] = selection
    os.environ["VKGR_TRAVERSAL"] = traversal
    for label, r in scenes:
        ro, rd = cs.probe_rays(r, device)
        n = ro.shape[0]
        probe = ([ro[:, i].contiguous() for i in range(3)] + [rd[:, i].contiguous() for i in range(3)]
                 + [torch.zeros(n, device=device), torch.full((n,), 1e32, device=device)])
        g = torch.Generator(device="cpu").manual_seed(99)
        diag = float((r.dev_bvh.scene_hi - r.dev_bvh.scene_lo).norm())
        shadow = probe[:7] + [(torch.rand(n, generator=g) * diag).to(device)]  # phase 6's any-hit rays
        launches, _ = cs.record_launches(r, wrapper)
        bvh = add_kernel_tables_to_device(r.dev_bvh, r.bvh, device, SPLIT_TABLES.get(kernel, ()))
        checked = launches + [(probe, False), (shadow, True)]  # every variant is held to the source on these
        with loaded(libs["source"]):
            ref = [call(bvh, rays, a) for rays, a in checked]
        times = {name: [] for name in libs}
        ties = {name: 0 for name in libs}
        for order in (list(libs), list(libs)[::-1]):
            for name in order:
                with loaded(libs[name]):
                    for (rays, a), want in zip(checked, ref):
                        ties[name] = max(ties[name], _check(label, kernel, name, call(bvh, rays, a), want))
                    probe_ms = device_ms(lambda: call(bvh, probe, False), 10)
                    frame = [device_ms(lambda rays=rays, a=a: call(bvh, rays, a), 10) for rays, a in launches]
                times[name].append((probe_ms, frame))
        scene_res = {}
        base = None
        for name, runs in times.items():
            probe_ms = sum(p for p, _ in runs) / len(runs)
            frame = [sum(f[k] for _, f in runs) / len(runs) for k in range(len(launches))]
            scene_res[name] = dict(probe_ms=probe_ms, frame_ms=sum(frame), launches_ms=frame,
                                   tie_lanes=ties[name])
            base = base or scene_res[name]
            cs.log(f"[tuning] {kernel} {label} {name}: probe rays {probe_ms:.4f} ms "
                   f"({100 * (probe_ms / base['probe_ms'] - 1):+.1f}%), replayed frame {sum(frame):.4f} ms "
                   f"({100 * (sum(frame) / base['frame_ms'] - 1):+.1f}%; launches "
                   f"{', '.join(f'{x:.4f}' for x in frame)}); "
                   + ("equal to the source bit for bit" if name not in ORDER.get(kernel, ()) else
                      f"t equal to the source's on every lane, ids differ on {ties[name]} (ties)")
                   + f" on {smi}")
        live = [int((rays[7] >= 0).sum()) for rays, _ in launches]
        sparse = min(range(len(launches)), key=lambda k: live[k])
        prof = {}
        with loaded(libs["source"]):
            for what, (rays, a) in ((f"launch {sparse} ({live[sparse]} live)", launches[sparse]),
                                    (f"launch 1 ({live[1]} live)", launches[min(1, len(launches) - 1)]),
                                    (f"probe rays ({n} live)", (probe, False))):
                prof[what] = profile(call, bvh, rays, a)
                cs.log(f"[tuning] {kernel} {label} {what}, device us per call: "
                       + ", ".join(f"{k} {v:.2f}" for k, v in prof[what].items()))
        results["scenes"][label] = dict(variants=scene_res, live=live, profile=prof)
    os.environ.pop("VKGR_TRAVERSAL")
    return results


def tune_mega(kernel, device, smi, scenes):
    """Every variant of csrc/megakernel.cu through ops/megakernel.render_mega
    on the 2,073,600 camera rays of each scene's 1080p frame 0 (phase 8's
    rays and seeds) at depths 1, 2 and 5, in pixel order (a warp's 32
    paths are neighbouring pixels, which mostly hit or miss together) and
    shuffled (a warp's paths end at unrelated bounces): each held equal to
    the source bit for bit, nothing dropped, timed in a forward and a
    backward round."""
    libs = build(kernel)
    registers = {}
    for name, lib in libs.items():
        res = cs.kernel_resources(lib.compiler_log, kernel).get("render_mega", {})
        registers[name] = {k: res.get(k) for k in ("registers", "spill_stores", "smem")}
        cs.log(f"[tuning] {kernel} {name}: render_mega {registers[name]}")
    results = {"registers": registers, "scenes": {}}
    for label, r in scenes:
        ro, rd = (a.cpu().numpy() for a in cs._camera_rays(r, device))
        n = ro.shape[0]
        seeds = np.random.default_rng(42).integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
        bvh = r.dev_bvh
        for order, perm in (("in pixel order", np.arange(n)), ("shuffled", np.random.default_rng(7).permutation(n))):
            packed = mk.pack_rays(ro[perm], rd[perm], seeds[perm], device=device)[:3]

            def call(depth, packed=packed):
                return mk.render_mega(bvh.nodes4_fi, bvh.tris128, *packed, depth, bvh.root4_code)

            mk.OVERFLOW.reset()
            with loaded(libs["source"]):
                ref = {d: call(d) for d in cs.MEGA_DEPTHS}
            times = {name: {d: [] for d in cs.MEGA_DEPTHS} for name in libs}
            for rnd in (list(libs), list(libs)[::-1]):
                for name in rnd:
                    with loaded(libs[name]):
                        for d in cs.MEGA_DEPTHS:
                            cs.require(cs.same_bits(call(d), ref[d]),
                                       f"{label} {order} {name} depth {d}: outputs differ from the source's")
                            times[name][d].append(device_ms(lambda d=d: call(d), 5))
            dropped = mk.OVERFLOW.total()
            cs.require(dropped == 0, f"{label} {order}: the megakernel dropped {dropped} pushes")
            res = {name: {d: sum(v) / len(v) for d, v in per.items()} for name, per in times.items()}
            for name, per in res.items():
                cs.log(f"[tuning] {kernel} {label} {order} {name}: "
                       + ", ".join(f"depth {d} {ms:.4f} ms ({100 * (ms / res['source'][d] - 1):+.1f}%, "
                                   f"{n * d / ms / 1e3:.1f} Mrays/s)" for d, ms in per.items())
                       + f"; equal to the source bit for bit on {smi}")
            results["scenes"][f"{label} {order}"] = {name: {str(d): ms for d, ms in per.items()}
                                                     for name, per in res.items()}
    return results


def main():
    kernels = sys.argv[1:] or ["traverse_bvh4.cu"]
    for kernel in kernels:
        if kernel not in VARIANTS:
            raise SystemExit(f"bvh4_tuning: unknown kernel {kernel!r}; accepted: {sorted(VARIANTS)}")
    device, smi = cs.phase_device()
    results = {"card": smi, "kernels": {}}
    with tempfile.TemporaryDirectory() as tmp:
        helmet, scene, hdr = cs.helmet_renderer(tmp, device)
        helmet.create_scene(scene)
        helmet.create_hdr(hdr)
        glb = os.path.join(tmp, "terrain.glb")
        write_large_glb(glb, cs.LARGE_TRIS)
        terrain, _ = cs.terrain_renderer(glb, hdr, device, cs.SELECTIONS[0])
        for kernel in kernels:
            results["kernels"][kernel] = (tune_mega if kernel == MEGA else tune)(
                kernel, device, smi, (("helmet", helmet), ("terrain", terrain)))
    print(smi)
    print(json.dumps(results), flush=True)


if __name__ == "__main__":
    main()
