// Binary closest-hit traversal over the split tables (the v1 walk),
// redesigned for the H100: live-lane compaction, a persistent grid, descent
// into the nearer child from a register, and batched leaves.
//
// Replaces the TPU kernel traverse_packets, "v1"
// (vk_gltf_renderer_tpu/ops/pallas_traverse.py, body _traverse_body,
// _make_kernel), reached through ops/intersect.intersect_rays_packet with
// v2=False. Tables: nodes_i [Nn,8] i32 (left, right, first, count, parent,
// axis, pad), nodes_f [Nn,16] f32 (left box cols 0:6, right box 6:12),
// tris [T+8,16] f32. The walk holds binary node ids, root 0 (which may be
// a leaf). A visit reads nodes_i[node]: count > 0 tests tris rows
// first .. first+count-1; otherwise both child boxes are tested, and the
// near child (the left one where the ray's direction along `axis` is >= 0:
// the BVH build puts the smaller centroid on the left) is visited before
// the far one. The walk writes the tris row of the hit; the wrapper
// resolves it to (render node, triangle id). Closest hit only: the
// reference's body never reads its `anyhit` argument.
//
// The order and arithmetic are those of the one-ray-per-thread kernel this
// replaces (which pushed the far, then the near entered child and popped
// the next; bvh4_tuning.py's "every element off" carries it): every output
// equals it bit for bit on every lane where no push is dropped.
//
// What bounds it on the card, and what each design element does about it
// (bvh4_tuning.py measures each one toggled; PERF.md keeps the numbers):
//  - The chain of dependent visits: unlike the fused rows
//    (traverse_bvh2.cu), a leaf is not coded in its parent, so every visit
//    needs its meta row before it knows what it is. The node id is known
//    before its visit, so the meta row's int4, its axis and the 48 box
//    bytes are requested together (fetch: five independent loads in one
//    round; a leaf's box loads are wasted rather than serialised behind
//    the meta load). Popping the next node at a leaf and issuing its loads
//    before the leaf's tests (which changes no output: the addresses do
//    not depend on t_best) measured slower, at 14 more registers, and is
//    not kept (bvh4_tuning.py's "leaf-time prefetch on").
//  - Dead lanes and divergence: live-lane compaction and a persistent grid
//    (live_lanes.cuh). A lane with !(tmax >= 0) is dead where node 0 is
//    internal: its slab tests floor tnear at 0 and cap tfar at tmax < 0
//    (or NaN), so the ray enters neither child. Where node 0 is a leaf,
//    its triangles accept any t in (tmin, tmax), even a negative one, so
//    a lane is dead only where also !(tmin < tmax): the wrapper passes
//    root_leaf, read on the host when the tables were uploaded
//    (DeviceBvh.bvh2_split_root_leaf), and compact_lanes then gets a
//    negative root.
//  - Stack traffic: the walk descends into the nearer entered child from
//    a register and pushes only the far one when both are entered, into a
//    kStack-entry stack in local memory (L1), the reference's STACK. The
//    wrapper checks the tree's deepest need (bvh_flatten.split_stack_need,
//    which counts the same descending walk) against it before launching.
//    A push onto a full stack is dropped and counted in *overflow, never
//    silently; the plain version (ops/traverse.traverse_bvh2_split_plain)
//    drops the same pushes.
//  - Leaves: leaf<true> of traverse_bvh.cuh issues the loads of kTriBatch
//    64-byte tris rows before testing them, where the kernel before tested
//    one row after the other.

#include "live_lanes.cuh"
#include "traverse_bvh.cuh"

namespace vkgr {
namespace bvh2s {
namespace {  // one copy per translation unit: a kernel's variant may edit it

constexpr int kStack = 128;  // ops/traverse.STACK_DEPTH_SPLIT2

// The loads of one node, issued together before it is known to be
// internal: its meta row's first int4 (left, right, first, count), its
// split axis and its two child boxes (three float4s).
struct Node {
  int4 m;
  int axis;
  float4 b0, b1, b2;
};

__device__ __forceinline__ Node fetch(const float* __restrict__ nodes_f,
                                      const int* __restrict__ nodes_i, int e) {
  const int* meta = nodes_i + static_cast<size_t>(e) * 8;
  const float4* box = reinterpret_cast<const float4*>(nodes_f + static_cast<size_t>(e) * 16);
  Node nd;
  nd.m = __ldg(reinterpret_cast<const int4*>(meta));
  nd.axis = __ldg(meta + 5);
  nd.b0 = __ldg(box);
  nd.b1 = __ldg(box + 1);
  nd.b2 = __ldg(box + 2);
  return nd;
}

// One ray's walk from node 0 into h; dropped pushes are added to `dropped`.
__device__ __forceinline__ void walk(const float* __restrict__ nodes_f,
                                     const int* __restrict__ nodes_i,
                                     const float* __restrict__ tris, const Ray& r, int* stack,
                                     Hit& h, unsigned& dropped) {
  int sp = 0;
  auto push = [&](int c) {
    if (sp < kStack) {
      stack[sp++] = c;
    } else {
      ++dropped;
    }
  };
  Node nd = fetch(nodes_f, nodes_i, 0);
  while (true) {
    if (nd.m.w > 0) {  // a leaf: tris rows first .. first+count-1
      leaf<true>(tris, -(nd.m.z * 16 + nd.m.w) - 1, r, false, h);
      if (sp == 0) return;
      nd = fetch(nodes_f, nodes_i, stack[--sp]);
      continue;
    }
    const bool hit_l = slab(nd.b0.x, nd.b0.y, nd.b0.z, nd.b0.w, nd.b1.x, nd.b1.y, r, h.t);
    const bool hit_r = slab(nd.b1.z, nd.b1.w, nd.b2.x, nd.b2.y, nd.b2.z, nd.b2.w, r, h.t);
    const bool l_near = axis_sign(nd.axis, r.sx, r.sy, r.sz);
    const int near_c = l_near ? nd.m.x : nd.m.y;
    const int far_c = l_near ? nd.m.y : nd.m.x;
    const bool near_hit = l_near ? hit_l : hit_r;
    const bool far_hit = l_near ? hit_r : hit_l;
    int next;
    if (near_hit || far_hit) {  // descend into the nearer entered child; push the far one if both are
      if (near_hit && far_hit) push(far_c);
      next = near_hit ? near_c : far_c;
    } else {
      if (sp == 0) return;
      next = stack[--sp];
    }
    nd = fetch(nodes_f, nodes_i, next);
  }
}

// The persistent walk of the list: each warp takes up to `per` entries
// with one atomicAdd of lane 0 and a shuffle, walks them to their end and
// takes more until the list is done.
__global__ void __launch_bounds__(kBlock)
walk_kernel(const float* __restrict__ nodes_f, const int* __restrict__ nodes_i,
            const float* __restrict__ tris, const float* __restrict__ rox,
            const float* __restrict__ roy, const float* __restrict__ roz,
            const float* __restrict__ rdx, const float* __restrict__ rdy,
            const float* __restrict__ rdz, const float* __restrict__ tmin,
            const float* __restrict__ tmax, float* __restrict__ out_t,
            int* __restrict__ out_rnode, int* __restrict__ out_row, float* __restrict__ out_u,
            float* __restrict__ out_v, unsigned int* __restrict__ overflow,
            int* __restrict__ header, const int* __restrict__ list) {
  int stack[kStack];
  unsigned dropped = 0;
  walk_list<1>(header, list, [&](int i) {
    const Ray r = load_ray(i, rox, roy, roz, rdx, rdy, rdz, tmin);
    Hit h{tmax[i], -1.0f, -1.0f, 0.0f, 0.0f};
    walk(nodes_f, nodes_i, tris, r, stack, h, dropped);
    store_hit(i, h, out_t, out_rnode, out_row, out_u, out_v);
  });
  if (dropped) atomicAdd(overflow, dropped);
}

// Compact the lanes into scratch's list (its live count and work cursor
// zeroed here on the stream; compact_lanes gets root -1 where node 0 is a
// leaf, 0 otherwise), then walk the list with a persistent grid.
int launch(const float* nodes_f, const int* nodes_i, const float* tris, int root_leaf,
           const float* rox, const float* roy, const float* roz, const float* rdx,
           const float* rdy, const float* rdz, const float* tmin, const float* tmax, int n,
           float* out_t, int* out_rnode, int* out_row, float* out_u, float* out_v,
           unsigned int* overflow, int* scratch, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int rc = begin_list(tmin, tmax, n, root_leaf ? -1 : 0, out_t, out_rnode, out_row, out_u,
                            out_v, scratch, stream);
  if (rc != 0) return rc;
  static int per_device[64];
  int grid = 0;
  const int rg = persistent_grid(walk_kernel, per_device, n, &grid);
  if (rg != 0) return rg;
  walk_kernel<<<grid, kBlock, 0, stream>>>(nodes_f, nodes_i, tris, rox, roy, roz, rdx, rdy, rdz,
                                           tmin, tmax, out_t, out_rnode, out_row, out_u, out_v,
                                           overflow, scratch, scratch + kScratchHeader);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace bvh2s
}  // namespace vkgr

// root_leaf: nonzero where node 0 is a leaf. scratch: kScratchHeader + n
// int32 (the wrapper's scratch_words(n)). out_rnode is -1 and out_row the
// hit's tris row (-1: none).
extern "C" int vkgr_traverse_bvh2_split(const float* nodes_f, const int* nodes_i,
                                        const float* tris, int root_leaf, const float* rox,
                                        const float* roy, const float* roz, const float* rdx,
                                        const float* rdy, const float* rdz, const float* tmin,
                                        const float* tmax, int n, float* out_t, int* out_rnode,
                                        int* out_row, float* out_u, float* out_v,
                                        unsigned int* overflow, int* scratch, void* stream) {
  using namespace vkgr::bvh2s;
  return launch(nodes_f, nodes_i, tris, root_leaf, rox, roy, roz, rdx, rdy, rdz, tmin, tmax, n,
                out_t, out_rnode, out_row, out_u, out_v, overflow, scratch,
                static_cast<cudaStream_t>(stream));
}
