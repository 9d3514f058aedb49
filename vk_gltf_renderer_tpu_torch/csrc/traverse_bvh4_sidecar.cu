// BVH4 closest-hit / any-hit traversal reading each visited row's child
// codes and split axes from the int32 sidecar nodes4_sc [M,8] (the v7
// walk), one ray per thread: the walk of traverse_bvh.cuh with kSidecar.
//
// Replaces the TPU kernel traverse_packets3 called with its `sidecar`
// table (vk_gltf_renderer_tpu/ops/pallas_traverse.py, _traverse3_core's
// sc_ref branch). On the TPU the sidecar sits in SMEM, so the seven scalar
// reads of a visit become scalar-memory loads instead of vector-to-scalar
// extracts off the fetched row. On the card there is no such split: the
// visit reads the 96 bytes of boxes from nodes4_fi and one 32-byte int row
// (two 16-byte loads) from the sidecar, so the codes arrive as integers
// and need no float conversion. What bounds it is what bounds the
// one-ray-per-thread walk: the latency of dependent row loads, and warps
// that run as long as their slowest ray; the sidecar adds one independent
// load per visit and saves the float-to-int conversions. Results equal
// traverse_bvh4.cu's exactly (same order, same arithmetic), which keeps
// this walk the yardstick of that kernel's redesign.

#include "traverse_bvh.cuh"

extern "C" int vkgr_traverse_bvh4_sidecar(const float* nodes4_fi, const int* nodes4_sc,
                                          const float* tris128, int root_code, const float* rox,
                                          const float* roy, const float* roz, const float* rdx,
                                          const float* rdy, const float* rdz, const float* tmin,
                                          const float* tmax, int n, int anyhit, float* out_t,
                                          int* out_rnode, int* out_tri, float* out_u, float* out_v,
                                          unsigned int* overflow, void* stream) {
  return vkgr::launch_traverse_bvh<2, 64, true>(nodes4_fi, nodes4_sc, tris128, root_code, rox, roy,
                                                roz, rdx, rdy, rdz, tmin, tmax, n, anyhit, out_t,
                                                out_rnode, out_tri, out_u, out_v, overflow, stream);
}
