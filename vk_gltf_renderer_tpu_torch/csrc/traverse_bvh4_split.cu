// BVH4 closest-hit traversal over the split tables (the packet4 walk),
// redesigned for the H100: live-lane compaction, persistent warps and
// whole-row loads, in the walk it shares with v7 (sidecar_walk.cuh).
//
// Replaces the TPU kernel traverse_packets4
// (vk_gltf_renderer_tpu/ops/pallas_traverse.py, body _traverse4_body),
// reached through VKGR_TRAVERSAL=packet4. Tables: nodes4_f [M,32] f32 (4
// child boxes in cols 0:24), nodes4_i [M,8] i32 (codes c0..c3, axes 4:7),
// tris [T+8,16] f32 (one world triangle per 64-byte row, BVH order). The
// root is row 0. A leaf code -(first*16+count)-1 names tris rows first ..
// first+count-1; the walk writes the tris row of the hit and the wrapper
// resolves it to (render node, triangle id) through wtri_rnode / wtri_tri,
// as the reference does after its launch. Closest hit only: the
// reference's kernel has no any-hit mode, and the port adds none.
//
// On the TPU one packet of 1024 rays shares a scalar stack in SMEM and
// votes its near order; here each ray walks alone with its own direction
// signs (only equal-t ties differ). Every output equals the
// one-ray-per-thread walk this replaces (the generic walk over the split
// tables, bvh4_tuning.GENERIC; bvh4_tuning.py's "every element off") bit
// for bit on every lane.
//
// What bounds it on the card, and what each design element does about it
// (bvh4_tuning.py measures each one toggled; PERF.md keeps the numbers):
//  - Dead lanes and divergence: the renderer traces all of a frame's lanes
//    in every launch and marks finished paths with tmax = -1. Live-lane
//    compaction and a persistent grid (live_lanes.cuh) walk only the live
//    ones. A lane with !(tmax >= 0) is dead: every walk starts at row 0,
//    whose slab tests cap tfar at tmax < 0 <= tnear (or NaN), so the ray
//    enters no child. A missing child carries code -1 and an inverted box
//    (lo = +3e38, hi = -3e38), whose slab test gives tnear = 0 and tfar =
//    tmax: every live ray enters it (it is never pushed, which changes no
//    result; the reference pushes it and pops an empty leaf), and a dead
//    ray, whose tmax is negative or NaN, does not.
//  - Dependent row fetches: a visit is visit_sc (traverse_bvh.cuh), the 96
//    box bytes of a nodes4_f row as 6 float4s and its 32-byte nodes4_i row
//    as 2 int4s, all issued in one round, where the generic walk issued 12
//    float2 box loads and, after the slab tests, 2 int4 loads; a leaf
//    issues the loads of kTriBatch 64-byte tris rows, which need not start
//    on a 128-byte line, before testing them (leaf<true>).
//  - Stack traffic: every entered child is pushed far first and the
//    nearest popped next, into a 64-entry stack in local memory (L1). The
//    wrapper checks the tree's deepest need (bvh_flatten.stack_need)
//    before launching; a push onto a full stack is dropped and counted in
//    *overflow, never silently.

#include "sidecar_walk.cuh"

// scratch: kScratchHeader + n int32 (the wrapper's scratch_words(n)); its
// live count and work cursor are zeroed here on the stream. out_rnode is
// -1 and out_row the hit's tris row (-1: none).
extern "C" int vkgr_traverse_bvh4_split(const float* nodes4_f, const int* nodes4_i,
                                        const float* tris, const float* rox, const float* roy,
                                        const float* roz, const float* rdx, const float* rdy,
                                        const float* rdz, const float* tmin, const float* tmax,
                                        int n, float* out_t, int* out_rnode, int* out_row,
                                        float* out_u, float* out_v, unsigned int* overflow,
                                        int* scratch, void* stream) {
  using namespace vkgr::sc4;
  return launch<false, true>(nodes4_f, nodes4_i, tris, 0, rox, roy, roz, rdx, rdy, rdz, tmin,
                             tmax, n, out_t, out_rnode, out_row, out_u, out_v, overflow, scratch,
                             static_cast<cudaStream_t>(stream));
}
