// BVH2 closest-hit / any-hit traversal, one ray per thread: the arity-2
// instance of the walk in traverse_bvh.cuh over the binary rows
// nodes_fi [N,16] (child boxes 0:12, child codes 12:14, split axis 14) and
// tris128, starting from root_code (a leaf code when the root is a leaf).
//
// Replaces the TPU kernel traverse_packets2 (_traverse2_body,
// vk_gltf_renderer_tpu/ops/pallas_traverse.py), the VKGR_PACKET_KERNEL /
// VKGR_PRIMARY_KERNEL value "v2". The Pallas kernel walks one shared stack
// per packet with one packed any() reduction per visit and poisons an
// any-hit lane with t = -1 until the stack drains; here each thread walks
// its own ray and stops at its first accepted any hit (t = -1 too, so the
// wrapper reads occlusion from tri >= 0, as the reference's caller does).
//
// What bounds it on the card: dependent loads, twice as many visits as
// BVH4 for the same tree. A visit reads one 64-byte row (two slab tests)
// and pushes at most 2; the stack is 128 x int32 in local memory, the
// reference's STACK, and the wrapper checks the tree's deepest need
// (bvh_flatten.stack_need) against it before launching.

#include "traverse_bvh.cuh"

extern "C" int vkgr_traverse_bvh2(const float* nodes_fi, const float* tris128, int root_code,
                                  const float* rox, const float* roy, const float* roz,
                                  const float* rdx, const float* rdy, const float* rdz,
                                  const float* tmin, const float* tmax, int n, int anyhit,
                                  float* out_t, int* out_rnode, int* out_tri, float* out_u,
                                  float* out_v, unsigned int* overflow, void* stream) {
  return vkgr::launch_traverse_bvh<1, 128>(nodes_fi, nullptr, tris128, root_code, rox, roy, roz, rdx, rdy,
                                           rdz, tmin, tmax, n, anyhit, out_t, out_rnode, out_tri,
                                           out_u, out_v, overflow, stream);
}
