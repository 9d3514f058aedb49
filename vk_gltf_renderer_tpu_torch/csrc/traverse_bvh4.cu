// BVH4 closest-hit / any-hit traversal over nodes4_fi [M,32] + tris128, the
// renderer's default kernel (values v3, v9, v9x4, v9x8), redesigned for the
// H100: live-lane compaction, persistent warps, whole-row loads and
// any-hit as a template parameter.
//
// Replaces the TPU kernels traverse_packets3 (_traverse3_body/_traverse3_core)
// and traverse_packets9 (_traverse9_body) of
// vk_gltf_renderer_tpu/ops/pallas_traverse.py. Those share one stack per
// 1024-ray packet and vote the near-first order per packet, because the
// TPU's scalar unit walks the tree and its vector unit tests 1024 rays at
// once. Here every thread walks its own ray with the walk of
// traverse_bvh.cuh: its own stack, near-first order from its own direction
// signs, the same slab and Moller-Trumbore arithmetic (-fmad=false), and an
// any-hit exit at the first accepted hit. Every output equals the v7 walk's
// (traverse_bvh4_sidecar.cu, the same walk with the codes read from the
// int32 sidecar) and the generic one-ray-per-thread walk this replaces
// bit for bit on every lane; against the packet kernels only equal-t ties
// may differ.
//
// What bounds it on the card, and what each design element does about it
// (bvh4_tuning.py measures each one toggled; PERF.md keeps the numbers):
//  - Dead lanes and divergence: live-lane compaction and a persistent grid
//    of warps that fetch from the list (live_lanes.cuh, shared by nine
//    kernels). Only a lane with !(tmax >= 0) is dead: the root's
//    slab test caps tfar at tmax < 0 <= tnear (or NaN) and enters nothing,
//    which is the rule of the plain version (ops/traverse.py). With a leaf
//    root a triangle with tmin < t < tmax < 0 could still be accepted, so
//    there the lane must also have !(tmin < tmax).
//  - Dependent row fetches: whole-row loads (visit and leaf in
//    traverse_bvh.cuh, shared with v5 and v8; the walk's step,
//    bvh4::step there, is also the megakernel's). This doubles the walk's
//    registers, which halves the warps an SM holds; a smaller batch or a
//    register cap measured slower.
//  - Stack traffic. The walk pushes every entered child far first and pops
//    the nearest, into a 64-entry stack in local memory (L1). Descending
//    straight into the nearest child (kept in a register) and a stack in
//    shared memory each measured a little slower. A push onto a full stack
//    is dropped and counted in *overflow, never silently.
//  - Any-hit is a template parameter, both instances behind the one entry
//    point.

#include "live_lanes.cuh"
#include "traverse_bvh.cuh"

namespace vkgr {
namespace bvh4 {

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
  int stack[kStackCap];
  unsigned dropped = 0;
  walk_list<1>(header, list, [&](int i) {
    const Ray r = load_ray(i, rox, roy, roz, rdx, rdy, rdz, tmin);
    Hit h{tmax[i], -1.0f, -1.0f, 0.0f, 0.0f};
    int e = root, sp = 0;
    while (!step(nodes, tris128, r, kAny, stack, e, sp, h, dropped)) {
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

}  // namespace bvh4
}  // namespace vkgr

// scratch: kScratchHeader + n int32 (the wrapper's scratch_words(n)); its
// live count and work cursor are zeroed here on the stream.
extern "C" int vkgr_traverse_bvh4(const float* nodes4_fi, const float* tris128, int root_code,
                                  const float* rox, const float* roy, const float* roz,
                                  const float* rdx, const float* rdy, const float* rdz,
                                  const float* tmin, const float* tmax, int n, int anyhit,
                                  float* out_t, int* out_rnode, int* out_tri, float* out_u,
                                  float* out_v, unsigned int* overflow, int* scratch,
                                  void* stream) {
  using namespace vkgr::bvh4;
  if (n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (anyhit) {
    return launch<true>(nodes4_fi, tris128, root_code, rox, roy, roz, rdx, rdy, rdz, tmin, tmax,
                        n, out_t, out_rnode, out_tri, out_u, out_v, overflow, scratch, s);
  }
  return launch<false>(nodes4_fi, tris128, root_code, rox, roy, roz, rdx, rdy, rdz, tmin, tmax, n,
                       out_t, out_rnode, out_tri, out_u, out_v, overflow, scratch, s);
}
