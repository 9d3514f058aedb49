// BVH4 closest-hit / any-hit traversal, one ray per thread: the arity-4
// instance of the walk in traverse_bvh.cuh over nodes4_fi [M,32] + tris128.
//
// Replaces the TPU kernels traverse_packets3 (_traverse3_body/_traverse3_core)
// and traverse_packets9 (_traverse9_body) of
// vk_gltf_renderer_tpu/ops/pallas_traverse.py. Those share one traversal
// stack per 1024-ray packet and vote the near-first order per packet,
// because the TPU's scalar unit walks the tree and its vector unit tests
// 1024 rays at once. Here every thread walks its own ray: its own stack,
// near-first order from its own direction signs, and an any-hit exit at
// the first accepted hit. Results equal the packet kernels' except for
// equal-t ties, which any traversal order may resolve differently.
//
// What bounds it on the card: dependent loads. Each visit of an internal
// node reads one 128-byte row of nodes4_fi (4 child boxes, 4 child codes,
// 3 split axes) and each leaf one 512-byte row of tris128 (8 triangles
// with their render-node and triangle ids). The rays diverge, so a warp
// pays for its slowest ray and fetches many distinct rows per step. The
// design keeps the arithmetic per visit small (one row, four slab tests)
// and reads the tables through the read-only path (__ldg). The stack lives
// in local memory (64 x int32 per thread, L1-resident; a BVH4 visit pushes
// at most 4). Shared-memory staging of the top levels, persistent threads
// and ray reordering are for later measurement-driven work.

#include "traverse_bvh.cuh"

extern "C" int vkgr_traverse_bvh4(const float* nodes4_fi, const float* tris128, int root_code,
                                  const float* rox, const float* roy, const float* roz,
                                  const float* rdx, const float* rdy, const float* rdz,
                                  const float* tmin, const float* tmax, int n, int anyhit,
                                  float* out_t, int* out_rnode, int* out_tri, float* out_u,
                                  float* out_v, unsigned int* overflow, void* stream) {
  return vkgr::launch_traverse_bvh<2, 64>(nodes4_fi, nullptr, tris128, root_code, rox, roy, roz, rdx, rdy,
                                          rdz, tmin, tmax, n, anyhit, out_t, out_rnode, out_tri,
                                          out_u, out_v, overflow, stream);
}
