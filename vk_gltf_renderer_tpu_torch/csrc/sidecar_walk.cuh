// The persistent walk of traverse_bvh4_sidecar.cu (v7) and
// traverse_bvh4_split.cu (packet4): BVH4 rows whose 4 child boxes come
// from a float table (cols 0:24 of nodes4_fi or nodes4_f) and whose codes
// and split axes come from an int32 table (nodes4_sc or nodes4_i), one ray
// a thread on the live-lane list of live_lanes.cuh. A visit is visit_sc
// (one load round of 6 float4s and 2 int4s), a leaf the batched leaf of
// traverse_bvh.cuh. The two kernels differ only in what kSplit selects:
// packet4's leaves are rows of tris [T+8,16] and a hit records its row,
// and its missing children (code -1, an inverted box that every live ray
// enters) are never pushed. Each kernel's header comment gives its design
// and its dead-lane rule.

#pragma once

#include "live_lanes.cuh"
#include "traverse_bvh.cuh"

namespace vkgr {
namespace sc4 {
namespace {  // one copy per translation unit: a kernel's variant may edit it

constexpr int kStackCap = 64;  // ops/traverse.STACK_DEPTH and STACK_DEPTH_SPLIT4

// One step of a ray's walk: the leaf or internal row e, then the next e
// popped from the stack. Starts at e = root with sp = 0; returns true when
// the ray is done. Dropped pushes are added to `dropped`.
template <bool kSplit>
__device__ __forceinline__ bool step(const float* __restrict__ nodes,
                                     const int* __restrict__ sidecar,
                                     const float* __restrict__ tris, const Ray& r, bool anyhit,
                                     int* stack, int& e, int& sp, Hit& h, unsigned& dropped) {
  auto push = [&](int code) {
    if (kSplit && code == -1) return;  // packet4's missing child: entered, never pushed
    if (sp < kStackCap) {
      stack[sp++] = code;
    } else {
      ++dropped;
    }
  };
  if (e < 0) {
    if (leaf<kSplit>(tris, e, r, anyhit, h)) return true;
  } else {
    const Visit v = visit_sc(nodes, sidecar, e, r, h.t);
    // every entered child, far first, so that the nearest is popped next
    if (v.enter & 8u) push(v.c3);
    if (v.enter & 4u) push(v.c2);
    if (v.enter & 2u) push(v.c1);
    if (v.enter & 1u) push(v.c0);
  }
  if (sp == 0) return true;
  e = stack[--sp];
  return false;
}

// The persistent walk of the list: each warp takes up to `per` entries
// with one atomicAdd of lane 0 and a shuffle, walks them to their end and
// takes more until the list is done.
template <bool kAny, bool kSplit>
__global__ void __launch_bounds__(kBlock)
walk_kernel(const float* __restrict__ nodes, const int* __restrict__ sidecar,
            const float* __restrict__ tris, int root, const float* __restrict__ rox,
            const float* __restrict__ roy, const float* __restrict__ roz,
            const float* __restrict__ rdx, const float* __restrict__ rdy,
            const float* __restrict__ rdz, const float* __restrict__ tmin,
            const float* __restrict__ tmax, float* __restrict__ out_t,
            int* __restrict__ out_rnode, int* __restrict__ out_tri, float* __restrict__ out_u,
            float* __restrict__ out_v, unsigned int* __restrict__ overflow,
            int* __restrict__ header, const int* __restrict__ list) {
  int stack[kStackCap];
  unsigned dropped = 0;
  walk_list<1>(header, list, [&](int i) {
    const Ray r = load_ray(i, rox, roy, roz, rdx, rdy, rdz, tmin);
    Hit h{tmax[i], -1.0f, -1.0f, 0.0f, 0.0f};
    int e = root, sp = 0;
    while (!step<kSplit>(nodes, sidecar, tris, r, kAny, stack, e, sp, h, dropped)) {
    }
    store_hit(i, h, out_t, out_rnode, out_tri, out_u, out_v);
  });
  if (dropped) atomicAdd(overflow, dropped);
}

// Compact the lanes into scratch's list (its live count and work cursor
// zeroed here on the stream), then walk the list with a persistent grid.
template <bool kAny, bool kSplit>
int launch(const float* nodes, const int* sidecar, const float* tris, int root, const float* rox,
           const float* roy, const float* roz, const float* rdx, const float* rdy,
           const float* rdz, const float* tmin, const float* tmax, int n, float* out_t,
           int* out_rnode, int* out_tri, float* out_u, float* out_v, unsigned int* overflow,
           int* scratch, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int rc = begin_list(tmin, tmax, n, root, out_t, out_rnode, out_tri, out_u, out_v, scratch,
                            stream);
  if (rc != 0) return rc;
  static int per_device[64];
  int grid = 0;
  const int rg = persistent_grid(walk_kernel<kAny, kSplit>, per_device, n, &grid);
  if (rg != 0) return rg;
  walk_kernel<kAny, kSplit><<<grid, kBlock, 0, stream>>>(
      nodes, sidecar, tris, root, rox, roy, roz, rdx, rdy, rdz, tmin, tmax, out_t, out_rnode,
      out_tri, out_u, out_v, overflow, scratch, scratch + kScratchHeader);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace sc4
}  // namespace vkgr
