// BVH4 closest-hit / any-hit traversal with a leaf queue beside the stack
// (the v8 schedule) over nodes4_fi + tris128, redesigned for the H100:
// live-lane compaction, persistent warps, whole-row loads and any-hit as a
// template parameter.
//
// Replaces the TPU kernel traverse_packets8 (_traverse8_body) of
// vk_gltf_renderer_tpu/ops/pallas_traverse.py. There the packet's stack
// holds only internal codes, leaf children go to an SMEM queue, and every
// iteration pops one of each with masks instead of a lax.cond, so the
// vector work of a leaf's triangle tests hides the scalar latency of the
// internal visit's reduction. Here each ray does the same with its own
// stack (internal codes, kStackInternal = 64 entries) and its own queue
// (leaf codes, kQueue = 16 entries, last in first out as the reference's):
// a step visits one internal row against the t_best from before the step,
// then tests one queued leaf. The producer gate pauses internal pops while
// the queue holds kGate = kQueue - 4 or more entries (an internal visit
// adds at most 4), as LQ_HIGH does, so the queue never overflows and the
// ray ends only when both are empty; a push that did find either full
// would be dropped and counted in *overflow. Deferred leaves see a t_best
// that is stale but never too small and every queued leaf is drained, so
// the closest-hit t equals the BVH4 walk's (traverse_bvh4.cu) bit for bit;
// ids, u and v differ only at equal-t ties, and any-hit occlusion is equal.
// Every output equals the one-thread walk this replaces (the "every
// element off" variant of bvh4_tuning.py) bit for bit on every lane.
//
// What bounds it on the card is the BVH4 walk's bound, the latency of
// dependent row loads; what each design element does about it
// (bvh4_tuning.py measures each one toggled; PERF.md keeps the numbers):
//  - Dead lanes and divergence: live-lane compaction and a persistent grid
//    (live_lanes.cuh). The dead-lane rule is traverse_bvh4.cu's: a lane
//    with !(tmax >= 0) is dead, because its internal root is visited with
//    t_best = tmax and enters no child (tfar is capped at tmax < 0 <=
//    tnear, or is NaN), so nothing is pushed or queued and the result is
//    (tmax, -1, -1, 0, 0). A leaf root goes straight to the queue, where a
//    triangle with tmin < t < tmax < 0 could still be accepted, so there
//    the lane must also have !(tmin < tmax).
//  - Two independent loads in flight a step, the point of v8: the queued
//    leaf's lines are prefetched into L1 (prefetch_leaf: no register
//    written) before the internal row is loaded whole (visit: 8 float4s
//    in one round), and the leaf's batched loads (leaf) then find them in
//    L1. Loading the leaf's first triangle batch into registers before the
//    row's tests holds ~48 more registers across the visit; bvh4_tuning.py
//    measures it.
//  - Any-hit is a template parameter, both instances behind the one entry
//    point.
// The stack and the queue (80 ints, 320 bytes a thread) live in local
// memory (L1), as traverse_bvh4.cu's stack does.

#include "live_lanes.cuh"
#include "traverse_bvh.cuh"

namespace vkgr {
namespace v8 {

constexpr int kStackInternal = 64;
constexpr int kQueue = 16;
constexpr int kGate = kQueue - 4;

// One step of the v8 schedule: pop an internal code unless the gate holds
// and a queued leaf; visit the internal row against the t_best from before
// the step, pushing its entered internal children onto the stack and its
// entered leaves into the queue (far first, as the BVH4 walk pushes); then
// test the leaf. Returns true when the ray is done: an any-hit accepted,
// or the stack and the queue both empty. Dropped pushes are added to
// `dropped`.
__device__ __forceinline__ bool step(const float* __restrict__ nodes,
                                     const float* __restrict__ tris128, const Ray& r, bool anyhit,
                                     int* stack, int* queue, int& sp, int& lq, Hit& h,
                                     unsigned& dropped) {
  const bool take_internal = sp > 0 && lq < kGate;
  const int e = take_internal ? stack[--sp] : 0;
  const int code = lq > 0 ? queue[--lq] : 0;
  if (code < 0) prefetch_leaf(tris128, code);
  if (take_internal) {
    auto push = [&](int c) {
      if (c < 0) {
        if (lq < kQueue) {
          queue[lq++] = c;
        } else {
          ++dropped;
        }
      } else if (sp < kStackInternal) {
        stack[sp++] = c;
      } else {
        ++dropped;
      }
    };
    const Visit v = visit(nodes, e, r, h.t);
    if (v.enter & 8u) push(v.c3);
    if (v.enter & 4u) push(v.c2);
    if (v.enter & 2u) push(v.c1);
    if (v.enter & 1u) push(v.c0);
  }
  if (code < 0 && leaf(tris128, code, r, anyhit, h)) return true;
  return sp == 0 && lq == 0;
}

// The persistent walk of the list: each warp takes up to `per` entries
// with one atomicAdd of lane 0 and a shuffle, walks them to their end and
// takes more until the list is done.
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
  int stack[kStackInternal];
  int queue[kQueue];
  unsigned dropped = 0;
  walk_list<1>(header, list, [&](int i) {
    const Ray r = load_ray(i, rox, roy, roz, rdx, rdy, rdz, tmin);
    Hit h{tmax[i], -1.0f, -1.0f, 0.0f, 0.0f};
    int sp = 0, lq = 0;
    if (root >= 0) {
      stack[sp++] = root;
    } else {  // a one-leaf scene: its root is the only leaf
      queue[lq++] = root;
    }
    while (!step(nodes, tris128, r, kAny, stack, queue, sp, lq, h, dropped)) {
    }
    store_hit(i, h, out_t, out_rnode, out_tri, out_u, out_v);
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
  const int rg = persistent_grid(walk_kernel<kAny>, per_device, n, &grid);
  if (rg != 0) return rg;
  walk_kernel<kAny><<<grid, kBlock, 0, stream>>>(nodes, tris128, root, rox, roy, roz, rdx, rdy,
                                                 rdz, tmin, tmax, out_t, out_rnode, out_tri,
                                                 out_u, out_v, overflow, scratch,
                                                 scratch + kScratchHeader);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace v8
}  // namespace vkgr

// scratch: kScratchHeader + n int32 (the wrapper's scratch_words(n)); its
// live count and work cursor are zeroed here on the stream.
extern "C" int vkgr_traverse_bvh4_leafqueue(const float* nodes4_fi, const float* tris128,
                                            int root_code, const float* rox, const float* roy,
                                            const float* roz, const float* rdx, const float* rdy,
                                            const float* rdz, const float* tmin, const float* tmax,
                                            int n, int anyhit, float* out_t, int* out_rnode,
                                            int* out_tri, float* out_u, float* out_v,
                                            unsigned int* overflow, int* scratch, void* stream) {
  using namespace vkgr::v8;
  if (n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (anyhit) {
    return launch<true>(nodes4_fi, tris128, root_code, rox, roy, roz, rdx, rdy, rdz, tmin, tmax,
                        n, out_t, out_rnode, out_tri, out_u, out_v, overflow, scratch, s);
  }
  return launch<false>(nodes4_fi, tris128, root_code, rox, roy, roz, rdx, rdy, rdz, tmin, tmax, n,
                       out_t, out_rnode, out_tri, out_u, out_v, overflow, scratch, s);
}
