// BVH16 closest-hit / any-hit traversal over the dense rows nodes16_fi
// [M,128] (16 child boxes 0:96, 16 codes 96:112, the 15 axes of the
// collapsed 4-level binary subtree 112:127) and tris128 from root row 0,
// redesigned for the H100: a group of threads per ray with its stack in
// shared memory, live-lane compaction, persistent warps and any-hit as a
// template parameter.
//
// Replaces the TPU kernel traverse_packets6 (_traverse6_body,
// vk_gltf_renderer_tpu/ops/pallas_traverse.py), the kernel value "v6".
// The near-first order is the reference's hierarchical one, not a sort by
// tnear: per level of the collapsed subtree, the sign of the ray along the
// stored split axis picks which half is visited first. The Pallas kernel
// votes that sign per packet and runs 8 packed any() reductions per visit;
// here each ray uses its own signs. The order and arithmetic are those of
// the generic walk of arity 16 (one ray per thread, the design this
// replaces; bvh4_tuning.GENERIC carries it): every output equals it bit
// for bit on every lane.
//
// What bounds it on the card, and what each design element does about it
// (bvh4_tuning.py measures each one toggled; PERF.md keeps the numbers):
//  - A visit is a 512-byte row and 16 slab tests, and one thread per ray
//    issued them as 48 float2 box loads, then up to 15 axis and 16 code
//    loads, kept a 256-entry stack in local memory (1 KB a thread) and
//    rebuilt a 4-level path for each of the 16 visit positions. Here a
//    group of kRayLanes = 8 threads walks one ray (4 rays a warp): thread
//    g loads float4s 3g..3g+2 (its boxes 2g and 2g+1) and float4 24+g
//    (codes 4g..4g+3 for g < 4, axes 4(g-4).. for g >= 4), so the whole
//    row arrives in one round spread over 8 threads' registers; each
//    thread runs its 2 slab tests and its axes' sign tests, and one OR
//    over the group (3 shuffles) gives every thread the 16-bit enter mask
//    and the 15 flip bits. Each thread maps its own slots to their visit
//    positions (the generic walk's mapping, 4 levels a slot) and, after a
//    second OR of the entered positions, writes its entered children into
//    the ray's stack at sp + (entered positions after its own): the stack
//    generic walk's far-first pushes leave. Four threads a ray (80
//    registers), one thread a ray with compaction (the generic walk, 93
//    registers, and slower still when capped at 64, where it spills) and
//    the stacks in L1-cached device memory each measured slower on the
//    terrain: the row's loads and tests spread over 8 threads, not the
//    register count, are what shorten a visit.
//  - A leaf: thread g tests triangle slot g, and the group keeps the
//    smallest t, the lowest slot on equal t (-1 for every accepted any
//    hit, so the lowest accepted slot): what the sequential strict-'<'
//    loop over the slots gives, u, v and ids included.
//  - The stack: kStack = 256 entries a ray (the reference's STACK + 128,
//    ops/traverse.STACK_DEPTH16) in shared memory, where all 8 threads
//    read and write it: 16 KB for a block's 16 rays. The wrapper checks
//    the tree's deepest need (bvh_flatten.stack_need) before launching; a
//    push onto a full stack is dropped and counted in *overflow, never
//    silently.
//  - Dead lanes and divergence: live-lane compaction and a persistent grid
//    (live_lanes.cuh). The root is always internal row 0 (a leaf-only
//    scene becomes one row with one child, ops/bvh_flatten.py), whose slab
//    test caps tfar at tmax: a lane with !(tmax >= 0) enters nothing and
//    is dead, and compact_lanes gets that root.
//  - Any-hit is a template parameter, both instances behind the one entry
//    point.

#include "live_lanes.cuh"
#include "traverse_bvh.cuh"

namespace vkgr {
namespace bvh16 {

constexpr int kRayLanes = 8;  // threads that walk one ray
constexpr int kStack = 256;   // stack entries a ray (ops/traverse.STACK_DEPTH16)
constexpr int kRays = kBlock / kRayLanes;  // rays a block walks at once
constexpr int kStackStride = kStack + 1;   // words between two rays' stacks (spreads the banks)
constexpr int kSlots = 16 / kRayLanes;     // child boxes a thread tests
constexpr int kBoxVec = 6 * kSlots / 4;    // float4s of those boxes
constexpr int kMeta = 8 / kRayLanes;       // float4s of codes or axes a thread loads
constexpr int kTris = kLeafSlots / kRayLanes;  // triangle slots a thread tests
constexpr float kNoHit = -2.0f;  // Hit::tri of a thread whose triangles accepted nothing
static_assert(kRayLanes >= 2 && kRayLanes <= 8 && 32 % kRayLanes == 0 && (6 * kSlots) % 4 == 0,
              "a group splits a row's boxes, codes and axes into whole float4s");

// Visit position of child slot s from the flip bits (bit k: the right side
// of split k of the collapsed subtree is nearer): the generic walk's mapping,
// inverted level by level.
__device__ __forceinline__ int position_of(int s, unsigned flip) {
  int p = s;
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    p ^= static_cast<int>((flip >> ((1 << d) - 1 + (s >> (4 - d)))) & 1u) << (3 - d);
  }
  return p;
}

template <bool kAny>
__global__ void __launch_bounds__(kBlock)
walk_kernel(const float* __restrict__ nodes, const float* __restrict__ tris128, int root,
            const float* __restrict__ rox, const float* __restrict__ roy,
            const float* __restrict__ roz, const float* __restrict__ rdx,
            const float* __restrict__ rdy, const float* __restrict__ rdz,
            const float* __restrict__ tmin, const float* __restrict__ tmax,
            float* __restrict__ out_t, int* __restrict__ out_rnode, int* __restrict__ out_tri,
            float* __restrict__ out_u, float* __restrict__ out_v,
            unsigned int* __restrict__ overflow, int* __restrict__ header,
            const int* __restrict__ list) {
  __shared__ int stacks[kRays * kStackStride];
  const int q = threadIdx.x % kRayLanes;  // this thread's place in its ray's group
  const unsigned group = ((1u << kRayLanes) - 1u) << ((threadIdx.x & 31) & ~(kRayLanes - 1));
  int* stack = stacks + (threadIdx.x / kRayLanes) * kStackStride;
  unsigned dropped = 0;
  walk_list<kRayLanes>(header, list, [&](int i) {
    const Ray r = load_ray(i, rox, roy, roz, rdx, rdy, rdz, tmin);
    Hit h{tmax[i], -1.0f, -1.0f, 0.0f, 0.0f};
    int e = root, sp = 0;  // group-uniform
    while (true) {
      if (e < 0) {
        // a leaf: this thread's triangle slots in slot order, against the t_best of the leaf
        const int code = -e - 1;
        const int row = code / 16;
        const int cnt = min(code - row * 16, kLeafSlots);
        const float4* tr = reinterpret_cast<const float4*>(tris128 + static_cast<size_t>(row) * 128);
        float4 a[kTris], b[kTris], d[kTris];
#pragma unroll
        for (int k = 0; k < kTris; ++k) {
          const int c = q * kTris + k;
          if (c < cnt) {
            a[k] = __ldg(tr + 4 * c);
            b[k] = __ldg(tr + 4 * c + 1);
            d[k] = __ldg(tr + 4 * c + 2);
          }
        }
        Hit best{h.t, -1.0f, kNoHit, 0.0f, 0.0f};
#pragma unroll
        for (int k = 0; k < kTris; ++k) {
          if (q * kTris + k >= cnt) break;
          float uu, vv, tt;
          if (triangle(a[k].x, a[k].y, a[k].z, a[k].w - a[k].x, b[k].x - a[k].y, b[k].y - a[k].z,
                       b[k].z - a[k].x, b[k].w - a[k].y, d[k].x - a[k].z, r, best.t, uu, vv, tt)) {
            best.t = kAny ? -1.0f : tt;
            best.rn = d[k].y;
            best.tri = d[k].z;
            best.u = uu;
            best.v = vv;
            if (kAny) break;
          }
        }
        // the group's hit: the smallest t, the lowest thread (slot) on equal t
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
        if (wq < kRayLanes) {  // group-uniform
          h.t = __shfl_sync(group, best.t, wq, kRayLanes);
          h.rn = __shfl_sync(group, best.rn, wq, kRayLanes);
          h.tri = __shfl_sync(group, best.tri, wq, kRayLanes);
          h.u = __shfl_sync(group, best.u, wq, kRayLanes);
          h.v = __shfl_sync(group, best.v, wq, kRayLanes);
          if (kAny) break;
        }
      } else {
        // an internal row in one load round: this thread's boxes, and its codes or axes
        const float4* row = reinterpret_cast<const float4*>(nodes + static_cast<size_t>(e) * 128);
        float bx[6 * kSlots], m[4 * kMeta];
#pragma unroll
        for (int k = 0; k < kBoxVec; ++k) {
          const float4 x = __ldg(row + kBoxVec * q + k);
          bx[4 * k] = x.x;
          bx[4 * k + 1] = x.y;
          bx[4 * k + 2] = x.z;
          bx[4 * k + 3] = x.w;
        }
#pragma unroll
        for (int k = 0; k < kMeta; ++k) {
          const float4 x = __ldg(row + 24 + kMeta * q + k);
          m[4 * k] = x.x;
          m[4 * k + 1] = x.y;
          m[4 * k + 2] = x.z;
          m[4 * k + 3] = x.w;
        }
        // bits 0-15: the slots whose box the ray enters; bits 16-30: the flip bit of each axis
        unsigned word = 0;
#pragma unroll
        for (int k = 0; k < kSlots; ++k) {
          if (slab(bx[6 * k], bx[6 * k + 1], bx[6 * k + 2], bx[6 * k + 3], bx[6 * k + 4],
                   bx[6 * k + 5], r, h.t)) {
            word |= 1u << (kSlots * q + k);
          }
        }
#pragma unroll
        for (int c = 0; c < 4 * kMeta; ++c) {
          const int j = 4 * kMeta * q + c;  // meta column: codes 0-15, axes 16-30, pad 31
          if (j >= 16 && j < 31 && !axis_sign(m[c], r.sx, r.sy, r.sz)) word |= 1u << j;
        }
#pragma unroll
        for (int off = 1; off < kRayLanes; off <<= 1) word |= __shfl_xor_sync(group, word, off, kRayLanes);
        const unsigned enter = word & 0xffffu;
        if (enter) {  // group-uniform
          const unsigned flip = word >> 16;
          // this thread's slots' codes, from the thread that loaded them (q / 2, half q % 2)
          float cv[4 * kMeta];
#pragma unroll
          for (int c = 0; c < 4 * kMeta; ++c) cv[c] = __shfl_sync(group, m[c], q >> 1, kRayLanes);
          int pos[kSlots];
          unsigned entered = 0;  // visit positions of the entered children
#pragma unroll
          for (int k = 0; k < kSlots; ++k) {
            pos[k] = position_of(kSlots * q + k, flip);
            if ((enter >> (kSlots * q + k)) & 1u) entered |= 1u << pos[k];
          }
#pragma unroll
          for (int off = 1; off < kRayLanes; off <<= 1) {
            entered |= __shfl_xor_sync(group, entered, off, kRayLanes);
          }
          // far first: position p lands above the entered positions after it
#pragma unroll
          for (int k = 0; k < kSlots; ++k) {
            if ((enter >> (kSlots * q + k)) & 1u) {
              const int at = sp + __popc(entered >> (pos[k] + 1));
              if (at < kStack) {
                stack[at] = static_cast<int>((q & 1) ? cv[kSlots + k] : cv[k]);
              } else {
                ++dropped;
              }
            }
          }
          sp = min(sp + __popc(enter), kStack);
        }
      }
      if (sp == 0) break;
      __syncwarp(group);  // every push is written before the pop
      e = stack[--sp];
      __syncwarp(group);  // the pop is read before a push overwrites it
    }
    if (q == 0) store_hit(i, h, out_t, out_rnode, out_tri, out_u, out_v);
  });
  if (dropped) atomicAdd(overflow, dropped);
}

template <bool kAny>
int launch(const float* nodes, const float* tris128, int root, const float* rox, const float* roy,
           const float* roz, const float* rdx, const float* rdy, const float* rdz,
           const float* tmin, const float* tmax, int n, float* out_t, int* out_rnode,
           int* out_tri, float* out_u, float* out_v, unsigned int* overflow, int* scratch,
           cudaStream_t stream) {
  const int rc = begin_list(tmin, tmax, n, root, out_t, out_rnode, out_tri, out_u, out_v, scratch,
                            stream);
  if (rc != 0) return rc;
  static int per_device[64];
  int grid = 0;
  const int rg = persistent_grid(walk_kernel<kAny>, per_device,
                                 static_cast<long long>(n) * kRayLanes, &grid);
  if (rg != 0) return rg;
  walk_kernel<kAny><<<grid, kBlock, 0, stream>>>(nodes, tris128, root, rox, roy, roz, rdx, rdy,
                                                 rdz, tmin, tmax, out_t, out_rnode, out_tri,
                                                 out_u, out_v, overflow, scratch,
                                                 scratch + kScratchHeader);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bvh16
}  // namespace vkgr

// root_code: 0 from the wrapper (ops/traverse_bvh16.py). scratch:
// kScratchHeader + n int32 (the wrapper's scratch_words(n)); its live
// count and work cursor are zeroed here on the stream.
extern "C" int vkgr_traverse_bvh16(const float* nodes16_fi, const float* tris128, int root_code,
                                   const float* rox, const float* roy, const float* roz,
                                   const float* rdx, const float* rdy, const float* rdz,
                                   const float* tmin, const float* tmax, int n, int anyhit,
                                   float* out_t, int* out_rnode, int* out_tri, float* out_u,
                                   float* out_v, unsigned int* overflow, int* scratch,
                                   void* stream) {
  using namespace vkgr::bvh16;
  if (n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (anyhit) {
    return launch<true>(nodes16_fi, tris128, root_code, rox, roy, roz, rdx, rdy, rdz, tmin, tmax,
                        n, out_t, out_rnode, out_tri, out_u, out_v, overflow, scratch, s);
  }
  return launch<false>(nodes16_fi, tris128, root_code, rox, roy, roz, rdx, rdy, rdz, tmin, tmax, n,
                       out_t, out_rnode, out_tri, out_u, out_v, overflow, scratch, s);
}
