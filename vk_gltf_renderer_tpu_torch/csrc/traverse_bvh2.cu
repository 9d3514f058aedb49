// BVH2 closest-hit / any-hit traversal over the binary rows nodes_fi
// [N,16] (child boxes 0:12, child codes 12:14, split axis 14) and tris128,
// starting from root_code (a leaf code when the root is a leaf),
// redesigned for the H100: live-lane compaction, persistent warps,
// whole-row loads and any-hit as a template parameter.
//
// Replaces the TPU kernel traverse_packets2 (_traverse2_body,
// vk_gltf_renderer_tpu/ops/pallas_traverse.py), the VKGR_PACKET_KERNEL /
// VKGR_PRIMARY_KERNEL value "v2". The Pallas kernel walks one shared stack
// per packet with one packed any() reduction per visit and poisons an
// any-hit lane with t = -1 until the stack drains; here each thread walks
// its own ray and stops at its first accepted any hit (t = -1 too, so the
// wrapper reads occlusion from tri >= 0, as the reference's caller does).
// The order and arithmetic are those of the generic walk of arity 2 (the
// one-ray-per-thread design this replaces; bvh4_tuning.GENERIC carries
// it): every output equals it bit for bit on every lane where no push is
// dropped.
//
// What bounds it on the card, and what each design element does about it
// (bvh4_tuning.py measures each one toggled; PERF.md keeps the numbers):
//  - The chain of dependent row loads, twice as long as BVH4's on the same
//    tree (one split a visit). Whole-row loads (visit2 in
//    traverse_bvh.cuh): a visit reads the 64-byte row as four float4s in
//    one round and takes both slab tests, the codes and the axis from
//    registers, instead of the generic walk's six float2 box loads followed,
//    after the slab tests, by the axis and code loads; a leaf issues the
//    loads of kTriBatch triangles before testing them (leaf).
//  - Dead lanes and divergence: live-lane compaction and a persistent grid
//    (live_lanes.cuh). A lane with !(tmax >= 0) is dead where the root is
//    internal: the root's slab test caps tfar at tmax < 0 <= tnear (or
//    NaN) and enters nothing. root_code may be a leaf (bvh_flatten's
//    one-leaf trees), where a triangle with tmin < t < tmax < 0 could
//    still be accepted; compact_lanes gets the real root and there also
//    requires !(tmin < tmax), the rule of the plain version.
//  - Stack traffic, on the dependent chain between two visits: the walk
//    descends into the nearer entered child from a register and pushes
//    only the far one (the generic walk pushes both and pops the nearer next,
//    so the visits are the same), into a kStack-entry stack in local
//    memory (L1), the reference's STACK. The wrapper checks the tree's
//    deepest need (bvh_flatten.stack_need with descend=True, one entry
//    less) against it before launching. A push onto a full stack is
//    dropped and counted in *overflow, never silently; the plain version
//    (ops/traverse.traverse_bvh2_plain) drops the same pushes. Prefetching
//    a pushed row into L1 measured no gain and is not kept.
//  - Any-hit is a template parameter, both instances behind the one entry
//    point.

#include "live_lanes.cuh"
#include "traverse_bvh.cuh"

namespace vkgr {
namespace bvh2 {

constexpr int kStack = 128;  // ops/traverse.STACK_DEPTH2

// One step of a ray's walk (the order and arithmetic of the generic walk): the
// leaf or internal row e, then the next e: the nearer entered child, or
// the top of the stack. Starts at e = root with sp = 0; returns true when
// the ray is done. Dropped pushes are added to `dropped`.
__device__ __forceinline__ bool step(const float* __restrict__ nodes,
                                     const float* __restrict__ tris128, const Ray& r, bool anyhit,
                                     int* stack, int& e, int& sp, Hit& h, unsigned& dropped) {
  auto push = [&](int code) {
    if (sp < kStack) {
      stack[sp++] = code;
    } else {
      ++dropped;
    }
  };
  if (e < 0) {
    if (leaf(tris128, e, r, anyhit, h)) return true;
  } else {
    const Visit2 v = visit2(nodes, e, r, h.t);
    if (v.enter) {  // descend into the nearer entered child; push the far one if it is entered too
      if (v.enter == 3u) push(v.c1);
      e = (v.enter & 1u) ? v.c0 : v.c1;
      return false;
    }
  }
  if (sp == 0) return true;
  e = stack[--sp];
  return false;
}

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
  int stack[kStack];
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

}  // namespace bvh2
}  // namespace vkgr

// scratch: kScratchHeader + n int32 (the wrapper's scratch_words(n)); its
// live count and work cursor are zeroed here on the stream.
extern "C" int vkgr_traverse_bvh2(const float* nodes_fi, const float* tris128, int root_code,
                                  const float* rox, const float* roy, const float* roz,
                                  const float* rdx, const float* rdy, const float* rdz,
                                  const float* tmin, const float* tmax, int n, int anyhit,
                                  float* out_t, int* out_rnode, int* out_tri, float* out_u,
                                  float* out_v, unsigned int* overflow, int* scratch,
                                  void* stream) {
  using namespace vkgr::bvh2;
  if (n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (anyhit) {
    return launch<true>(nodes_fi, tris128, root_code, rox, roy, roz, rdx, rdy, rdz, tmin, tmax, n,
                        out_t, out_rnode, out_tri, out_u, out_v, overflow, scratch, s);
  }
  return launch<false>(nodes_fi, tris128, root_code, rox, roy, roz, rdx, rdy, rdz, tmin, tmax, n,
                       out_t, out_rnode, out_tri, out_u, out_v, overflow, scratch, s);
}
