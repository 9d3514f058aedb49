// BVH4 closest-hit / any-hit traversal reading each visited row's child
// codes and split axes from the int32 sidecar nodes4_sc [M,8] (the v7
// walk) and its boxes from nodes4_fi, redesigned for the H100: live-lane
// compaction, persistent warps, whole-row loads and any-hit as a template
// parameter, in the walk it shares with packet4 (sidecar_walk.cuh).
//
// Replaces the TPU kernel traverse_packets3 called with its `sidecar`
// table (vk_gltf_renderer_tpu/ops/pallas_traverse.py, _traverse3_core's
// sc_ref branch), kernel value v7. On the TPU the sidecar sits in SMEM, so
// the seven scalar reads of a visit become scalar-memory loads instead of
// vector-to-scalar extracts off the fetched row. On the card there is no
// such split: the codes arrive as integers with the boxes and need no
// float conversion. Every output equals traverse_bvh4.cu's bit for bit on
// every lane (the same order and arithmetic; only the codes' table
// differs), and equals the one-ray-per-thread walk this replaces (the
// generic walk with the sidecar, bvh4_tuning.GENERIC; bvh4_tuning.py's
// "every element off").
//
// What bounds it on the card, and what each design element does about it
// (bvh4_tuning.py measures each one toggled; PERF.md keeps the numbers):
//  - Dependent row fetches: a visit is visit_sc (traverse_bvh.cuh), the
//    96 box bytes of the row as 6 float4s and its 32-byte int row as 2
//    int4s, all issued in one round, where the generic walk issued 12
//    float2 box loads and, after the slab tests, 2 int4 loads; a leaf
//    issues the loads of kTriBatch triangles of a 512-byte tris128 row
//    before testing them (leaf).
//  - Dead lanes and divergence: live-lane compaction and a persistent grid
//    (live_lanes.cuh). A lane with !(tmax >= 0) is dead where the root is
//    internal: the root's slab test caps tfar at tmax < 0 <= tnear (or
//    NaN) and enters nothing, and a missing child is the point box that no
//    ray enters. With a leaf root a triangle with tmin < t < tmax < 0
//    could still be accepted, so there the lane must also have
//    !(tmin < tmax); compact_lanes gets the real root.
//  - Stack traffic: every entered child is pushed far first and the
//    nearest popped next, into a 64-entry stack in local memory (L1), the
//    order of traverse_bvh4.cu. A push onto a full stack is dropped and
//    counted in *overflow, never silently.
//  - Any-hit is a template parameter, both instances behind the one entry
//    point.

#include "sidecar_walk.cuh"

// scratch: kScratchHeader + n int32 (the wrapper's scratch_words(n)); its
// live count and work cursor are zeroed here on the stream.
extern "C" int vkgr_traverse_bvh4_sidecar(const float* nodes4_fi, const int* nodes4_sc,
                                          const float* tris128, int root_code, const float* rox,
                                          const float* roy, const float* roz, const float* rdx,
                                          const float* rdy, const float* rdz, const float* tmin,
                                          const float* tmax, int n, int anyhit, float* out_t,
                                          int* out_rnode, int* out_tri, float* out_u, float* out_v,
                                          unsigned int* overflow, int* scratch, void* stream) {
  using namespace vkgr::sc4;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (anyhit) {
    return launch<true, false>(nodes4_fi, nodes4_sc, tris128, root_code, rox, roy, roz, rdx, rdy,
                               rdz, tmin, tmax, n, out_t, out_rnode, out_tri, out_u, out_v,
                               overflow, scratch, s);
  }
  return launch<false, false>(nodes4_fi, nodes4_sc, tris128, root_code, rox, roy, roz, rdx, rdy,
                              rdz, tmin, tmax, n, out_t, out_rnode, out_tri, out_u, out_v,
                              overflow, scratch, s);
}
