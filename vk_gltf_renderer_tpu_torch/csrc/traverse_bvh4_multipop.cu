// BVH4 closest-hit / any-hit traversal that pops several stack entries
// per step (the v5 schedule) over nodes4_fi + tris128, redesigned for the
// H100: the nearest member's children on top, a group of threads per ray
// with one popped entry's row each, live-lane compaction, persistent warps
// and any-hit as a template parameter.
//
// Replaces the TPU kernel traverse_packets5 (_traverse5_body) of
// vk_gltf_renderer_tpu/ops/pallas_traverse.py. There the packet pops up to
// four entries, fetches a node row AND a leaf row for each (one of the two
// is wasted) and runs both the slab and the triangle tests masked, because
// Mosaic cannot overlap scalar latency across a lax.cond. Here a ray pops
// a group of up to kMultipop = 4 entries (member 0 the top of its stack),
// and the sign of each code says which row it needs, so nothing is
// fetched speculatively.
//
// The schedule (ops/traverse.traverse_rows_plain with multipop > 1 follows
// it step for step): every internal member is tested against the t_best
// the group was popped with; the leaf members' triangles are tested
// against it too and the group keeps the smallest t, the lowest member on
// equal t (what testing them in member order with t_best chained gives);
// then the members' entered children are pushed, member k-1's first and
// member 0's last, each far first, so that the nearest child of the
// nearest member is popped next. The reference's order pushed each
// member's children as it was processed, which left the last, farthest
// member's children on top and tested members 2-4 against a t_best that
// member 1's subtree had not yet shrunk (+55% internal visits over the
// BVH4 walk on the terrain). Closest-hit results equal the single-pop
// walk's except at equal-t ties, and any-hit results its occlusion.
//
// What bounds it on the card, and what each design element does about it
// (bvh4_tuning.py measures each one toggled; PERF.md keeps the numbers):
//  - The latency of dependent row loads. A group of kRayLanes = 4 threads
//    walks one ray (8 rays a warp): thread q loads and tests member q, a
//    whole 128-byte row in one round (visit in traverse_bvh.cuh) or a
//    leaf's triangles kTriBatch at a time (leaf), so the group's four rows
//    are in flight at once and spread over four threads' registers. The
//    group reduces its leaf hits and merges its pushes with shuffles in
//    the order above. A stack of kStack entries a ray lives in shared
//    memory, where all four threads read and write it; kStack covers the
//    terrain's need (bvh_flatten.multipop_stack_need, checked at
//    dispatch) with margin. A push onto a full stack is dropped and
//    counted in *overflow, never silently.
//  - Dead lanes and divergence: live-lane compaction and a persistent grid
//    (live_lanes.cuh) with BVH4's dead-lane rule: a lane with
//    !(tmax >= 0) enters no child of an internal root, and at a leaf root
//    one with !(tmin < tmax) accepts no triangle.
//  - Any-hit is a template parameter, both instances behind the one entry
//    point.

#include "live_lanes.cuh"
#include "traverse_bvh.cuh"

namespace vkgr {
namespace multipop {

constexpr int kMultipop = 4;  // entries a ray pops per step
constexpr int kRayLanes = 4;  // threads that walk one ray
constexpr int kPerLane = kMultipop / kRayLanes;  // popped entries a thread handles
constexpr int kStack = 128;  // stack entries a ray
constexpr int kRays = kBlock / kRayLanes;  // rays a block walks at once
constexpr int kStackStride = kStack + 1;  // words between two rays' stacks (spreads the banks)
constexpr float kNoHit = -2.0f;  // Hit::tri of a thread whose leaves accepted nothing this step
static_assert(kMultipop % kRayLanes == 0 && 32 % kRayLanes == 0, "members tile the group");

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
  const unsigned group = ((kRayLanes == 32) ? kFull : ((1u << kRayLanes) - 1u))
                         << ((threadIdx.x & 31) & ~(kRayLanes - 1));
  int* stack = stacks + (threadIdx.x / kRayLanes) * kStackStride;
  unsigned dropped = 0;
  walk_list<kRayLanes>(header, list, [&](int i) {
    const Ray r = load_ray(i, rox, roy, roz, rdx, rdy, rdz, tmin);
    Hit h{tmax[i], -1.0f, -1.0f, 0.0f, 0.0f};
    stack[0] = root;  // every thread of the group writes the same value
    int sp = 1;
    __syncwarp(group);
    while (sp > 0) {
      // pop: member j is the j-th entry from the top; thread q takes members q*kPerLane ..
      const int k = min(sp, kMultipop);
      int e[kPerLane];
#pragma unroll
      for (int m = 0; m < kPerLane; ++m) {
        const int j = q * kPerLane + m;
        e[m] = j < k ? stack[sp - 1 - j] : 0;
      }
      __syncwarp(group);  // every pop is read before a push overwrites it
      sp -= k;
      // this thread's members, all against the t_best the group was popped with; its leaves
      // in member order with t chained
      const float t_pop = h.t;
      Hit best{t_pop, -1.0f, kNoHit, 0.0f, 0.0f};
      bool stop = false;  // an any-hit ray accepted a triangle here
      Visit v[kPerLane];
#pragma unroll
      for (int m = 0; m < kPerLane; ++m) {
        v[m] = Visit{0, 0, 0, 0, 0u};
        if (q * kPerLane + m < k) {
          if (e[m] >= 0) {
            v[m] = visit(nodes, e[m], r, t_pop);
          } else if (!stop) {
            stop = leaf(tris128, e[m], r, kAny, best);
          }
        }
      }
      // the group's leaf hit: the smallest t, the lowest thread (member) on equal t
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
      // push: the members after this thread's first (their pushes lie below), then its own
      // from its last member to its first, each far first
      int cnt = 0;
#pragma unroll
      for (int m = 0; m < kPerLane; ++m) cnt += __popc(v[m].enter);
      int from_here = cnt;  // pushes of threads q .. kRayLanes-1
#pragma unroll
      for (int off = 1; off < kRayLanes; off <<= 1) {
        const int o = __shfl_down_sync(group, from_here, off, kRayLanes);
        if (q + off < kRayLanes) from_here += o;
      }
      const int total = __shfl_sync(group, from_here, 0, kRayLanes);
      int pos = sp + from_here - cnt;
      auto push = [&](int code) {
        if (pos < kStack) {
          stack[pos] = code;
        } else {
          ++dropped;
        }
        ++pos;
      };
#pragma unroll
      for (int m = kPerLane - 1; m >= 0; --m) {
        if (v[m].enter & 8u) push(v[m].c3);
        if (v[m].enter & 4u) push(v[m].c2);
        if (v[m].enter & 2u) push(v[m].c1);
        if (v[m].enter & 1u) push(v[m].c0);
      }
      sp = min(sp + total, kStack);
      __syncwarp(group);  // every push is written before the next pops
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

}  // namespace multipop
}  // namespace vkgr

// scratch: kScratchHeader + n int32 (the wrapper's scratch_words(n)); its
// live count and work cursor are zeroed here on the stream.
extern "C" int vkgr_traverse_bvh4_multipop(const float* nodes4_fi, const float* tris128,
                                           int root_code, const float* rox, const float* roy,
                                           const float* roz, const float* rdx, const float* rdy,
                                           const float* rdz, const float* tmin, const float* tmax,
                                           int n, int anyhit, float* out_t, int* out_rnode,
                                           int* out_tri, float* out_u, float* out_v,
                                           unsigned int* overflow, int* scratch, void* stream) {
  using namespace vkgr::multipop;
  if (n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (anyhit) {
    return launch<true>(nodes4_fi, tris128, root_code, rox, roy, roz, rdx, rdy, rdz, tmin, tmax,
                        n, out_t, out_rnode, out_tri, out_u, out_v, overflow, scratch, s);
  }
  return launch<false>(nodes4_fi, tris128, root_code, rox, roy, roz, rdx, rdy, rdz, tmin, tmax, n,
                       out_t, out_rnode, out_tri, out_u, out_v, overflow, scratch, s);
}
