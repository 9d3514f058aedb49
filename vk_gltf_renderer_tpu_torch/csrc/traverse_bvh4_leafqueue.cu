// BVH4 closest-hit / any-hit traversal with a leaf queue beside the stack
// (the v8 schedule), one ray per thread over nodes4_fi + tris128.
//
// Replaces the TPU kernel traverse_packets8 (_traverse8_body) of
// vk_gltf_renderer_tpu/ops/pallas_traverse.py. There the packet's stack
// holds only internal codes, leaf children go to an SMEM queue, and every
// iteration pops one of each with masks instead of a lax.cond, so the
// vector work of a leaf's triangle tests hides the scalar latency of the
// internal visit's reduction. Here each ray does the same with its own
// stack (internal codes, 64 entries) and its own queue (leaf codes,
// kQueue = 16 entries, last in first out as the reference's): a step
// prefetches the queued leaf's row, visits one internal node against the
// t_best from before the step (so the row load and slab tests do not wait
// on the leaf), then tests the leaf. The producer gate pauses internal
// pops while the queue holds kQueue - 4 or more entries (an internal visit
// adds at most 4), as LQ_HIGH does, so the queue never overflows and the
// ray ends only when both are empty; any push that did find either full
// would be counted. Deferred leaves see a t_best that is stale but never
// too small, so hits equal the BVH4 walk's except for equal-t ties.
//
// Queue size: 16 x int32 lives in local memory beside the 64-entry stack
// (80 ints, 320 bytes per thread, L1-resident like the stack); a smaller
// queue gates more often, a larger one only grows the frame. What bounds it
// is the BVH4 walk's bound, the latency of dependent row loads: the point
// is two independent loads (an internal row, a leaf row) in flight per step.

#include "traverse_bvh.cuh"

namespace vkgr {

constexpr int kStackInternal = 64;
constexpr int kQueue = 16;
constexpr int kGate = kQueue - 4;

__global__ void __launch_bounds__(kBlock)
traverse_bvh4_leafqueue_kernel(const float* __restrict__ nodes4_fi,
                               const float* __restrict__ tris128, int root_code,
                               const float* __restrict__ rox, const float* __restrict__ roy,
                               const float* __restrict__ roz, const float* __restrict__ rdx,
                               const float* __restrict__ rdy, const float* __restrict__ rdz,
                               const float* __restrict__ tmin, const float* __restrict__ tmax,
                               int n, int anyhit, float* __restrict__ out_t,
                               int* __restrict__ out_rnode, int* __restrict__ out_tri,
                               float* __restrict__ out_u, float* __restrict__ out_v,
                               unsigned int* __restrict__ overflow) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(i, rox, roy, roz, rdx, rdy, rdz, tmin);
  Hit h{tmax[i], -1.0f, -1.0f, 0.0f, 0.0f};
  unsigned int dropped = 0;
  int stack[kStackInternal];
  int queue[kQueue];
  int sp = 0, lq = 0;
  if (root_code >= 0) {
    stack[sp++] = root_code;
  } else {  // a one-leaf scene: its root is the only leaf
    queue[lq++] = root_code;
  }
  auto push = [&](int code) {
    if (code < 0) {
      if (lq < kQueue) {
        queue[lq++] = code;
      } else {
        ++dropped;
      }
    } else if (sp < kStackInternal) {
      stack[sp++] = code;
    } else {
      ++dropped;
    }
  };

  while (sp > 0 || lq > 0) {
    const bool take_internal = sp > 0 && lq < kGate;
    const int e = take_internal ? stack[--sp] : 0;
    const int leaf = lq > 0 ? queue[--lq] : 0;
    if (leaf < 0) prefetch_leaf(tris128, leaf);
    if (take_internal) expand_node<2>(nodes4_fi, e, r, h.t, push);
    if (leaf < 0 && test_leaf(tris128, leaf, r, anyhit != 0, h)) break;
  }

  store_hit(i, h, out_t, out_rnode, out_tri, out_u, out_v);
  if (dropped) atomicAdd(overflow, dropped);
}

}  // namespace vkgr

extern "C" int vkgr_traverse_bvh4_leafqueue(const float* nodes4_fi, const float* tris128,
                                            int root_code, const float* rox, const float* roy,
                                            const float* roz, const float* rdx, const float* rdy,
                                            const float* rdz, const float* tmin, const float* tmax,
                                            int n, int anyhit, float* out_t, int* out_rnode,
                                            int* out_tri, float* out_u, float* out_v,
                                            unsigned int* overflow, void* stream) {
  if (n <= 0) return 0;
  const int grid = (n + vkgr::kBlock - 1) / vkgr::kBlock;
  vkgr::traverse_bvh4_leafqueue_kernel<<<grid, vkgr::kBlock, 0,
                                         static_cast<cudaStream_t>(stream)>>>(
      nodes4_fi, tris128, root_code, rox, roy, roz, rdx, rdy, rdz, tmin, tmax, n, anyhit, out_t,
      out_rnode, out_tri, out_u, out_v, overflow);
  return static_cast<int>(cudaGetLastError());
}
