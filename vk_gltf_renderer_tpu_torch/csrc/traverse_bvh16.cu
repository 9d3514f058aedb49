// BVH16 closest-hit / any-hit traversal, one ray per thread: the arity-16
// instance of the walk in traverse_bvh.cuh over the dense rows
// nodes16_fi [M,128] (16 child boxes 0:96, 16 codes 96:112, the 15 axes of
// the collapsed 4-level binary subtree 112:127) and tris128; root row 0.
//
// Replaces the TPU kernel traverse_packets6 (_traverse6_body,
// vk_gltf_renderer_tpu/ops/pallas_traverse.py), the kernel value "v6".
// The near-first order is the reference's hierarchical one, not a sort by
// tnear: per level of the collapsed subtree, the sign of the ray along the
// stored split axis picks which half is visited first. The Pallas kernel
// votes that sign per packet and runs 8 packed any() reductions per visit;
// here each thread uses its own signs and pushes its own hit children.
//
// What bounds it on the card: dependent loads. A visit reads one 512-byte
// row (16 slab tests) and halves the internal visits of BVH4, at four
// times the box tests per visit. A visit pushes up to 16 entries, so the
// stack is 256 x int32 in local memory (the reference's STACK + 128); the
// wrapper checks the tree's deepest need (bvh_flatten.stack_need) against
// it before launching.

#include "traverse_bvh.cuh"

extern "C" int vkgr_traverse_bvh16(const float* nodes16_fi, const float* tris128, int root_code,
                                   const float* rox, const float* roy, const float* roz,
                                   const float* rdx, const float* rdy, const float* rdz,
                                   const float* tmin, const float* tmax, int n, int anyhit,
                                   float* out_t, int* out_rnode, int* out_tri, float* out_u,
                                   float* out_v, unsigned int* overflow, void* stream) {
  return vkgr::launch_traverse_bvh<4, 256>(nodes16_fi, nullptr, tris128, root_code, rox, roy, roz, rdx,
                                           rdy, rdz, tmin, tmax, n, anyhit, out_t, out_rnode,
                                           out_tri, out_u, out_v, overflow, stream);
}
