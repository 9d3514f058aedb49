// Binary closest-hit traversal over the split tables (the v1 walk), one ray
// per thread.
//
// Replaces the TPU kernel traverse_packets, "v1"
// (vk_gltf_renderer_tpu/ops/pallas_traverse.py, body _traverse_body,
// _make_kernel), reached through ops/intersect.intersect_rays_packet with
// v2=False. Tables: nodes_i [Nn,8] i32 (left, right, first, count, parent,
// axis, pad), nodes_f [Nn,16] f32 (left box cols 0:6, right box 6:12),
// tris [T+8,16] f32. The stack holds binary node ids, root 0 (which may be a
// leaf). A pop reads nodes_i[node]: count > 0 tests tris rows
// first .. first+count-1; otherwise both child boxes are tested and the far,
// then the near child is pushed if entered (near: the left child where the
// ray's direction along `axis` is >= 0, the builder putting the smaller
// centroid on the left). The walk writes the tris row of the hit; the
// wrapper resolves it to (render node, triangle id). Closest hit only: the
// reference's body never reads its `anyhit` argument.
//
// Unlike the fused rows (traverse_bvh2.cu), leaves are not sign-encoded in
// the stack, so every visit needs its 32-byte meta row before it knows what
// it is. The node id is known at the pop, so the meta row and the 48 box
// bytes are requested together (five independent 16-byte loads) and the
// box loads of a leaf visit are wasted rather than serialised behind the
// meta load. What bounds the walk on the card is the latency of those
// dependent loads (PERF.md §6), one round trip per visit.

#include "traverse_bvh.cuh"

namespace {

constexpr int kStackSplit2 = 128;  // ops/traverse.STACK_DEPTH_SPLIT2

__global__ void __launch_bounds__(vkgr::kBlock)
traverse_bvh2_split_kernel(const float* __restrict__ nodes_f, const int* __restrict__ nodes_i,
                           const float* __restrict__ tris, const float* __restrict__ rox,
                           const float* __restrict__ roy, const float* __restrict__ roz,
                           const float* __restrict__ rdx, const float* __restrict__ rdy,
                           const float* __restrict__ rdz, const float* __restrict__ tmin,
                           const float* __restrict__ tmax, int n, float* __restrict__ out_t,
                           int* __restrict__ out_rnode, int* __restrict__ out_row,
                           float* __restrict__ out_u, float* __restrict__ out_v,
                           unsigned int* __restrict__ overflow) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const vkgr::Ray r = vkgr::load_ray(i, rox, roy, roz, rdx, rdy, rdz, tmin);
  vkgr::Hit h{tmax[i], -1.0f, -1.0f, 0.0f, 0.0f};
  unsigned int dropped = 0;
  int stack[kStackSplit2];
  stack[0] = 0;
  int sp = 1;
  while (sp > 0) {
    const int node = stack[--sp];
    const int4* meta = reinterpret_cast<const int4*>(nodes_i + static_cast<size_t>(node) * 8);
    const float4* box = reinterpret_cast<const float4*>(nodes_f + static_cast<size_t>(node) * 16);
    const int4 m0 = __ldg(meta);  // left, right, first, count
    const int4 m1 = __ldg(meta + 1);  // parent, axis, pad, pad
    const float4 b0 = __ldg(box), b1 = __ldg(box + 1), b2 = __ldg(box + 2);
    if (m0.w > 0) {
      vkgr::test_leaf<true>(tris, -(m0.z * 16 + m0.w) - 1, r, false, h);
      continue;
    }
    const bool hit_l = vkgr::slab(b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, r, h.t);
    const bool hit_r = vkgr::slab(b1.z, b1.w, b2.x, b2.y, b2.z, b2.w, r, h.t);
    const bool l_near = vkgr::axis_sign(static_cast<float>(m1.y), r.sx, r.sy, r.sz);
    const int near_c = l_near ? m0.x : m0.y;
    const int far_c = l_near ? m0.y : m0.x;
    const bool near_hit = l_near ? hit_l : hit_r;
    const bool far_hit = l_near ? hit_r : hit_l;
    if (far_hit) {
      if (sp < kStackSplit2) {
        stack[sp++] = far_c;
      } else {
        ++dropped;
      }
    }
    if (near_hit) {
      if (sp < kStackSplit2) {
        stack[sp++] = near_c;
      } else {
        ++dropped;
      }
    }
  }
  out_t[i] = h.t;
  out_rnode[i] = -1;  // resolved from the row by the caller
  out_row[i] = static_cast<int>(h.tri);
  out_u[i] = h.u;
  out_v[i] = h.v;
  if (dropped) atomicAdd(overflow, dropped);
}

}  // namespace

extern "C" int vkgr_traverse_bvh2_split(const float* nodes_f, const int* nodes_i,
                                        const float* tris, const float* rox, const float* roy,
                                        const float* roz, const float* rdx, const float* rdy,
                                        const float* rdz, const float* tmin, const float* tmax,
                                        int n, float* out_t, int* out_rnode, int* out_row,
                                        float* out_u, float* out_v, unsigned int* overflow,
                                        void* stream) {
  if (n <= 0) return 0;
  const int grid = (n + vkgr::kBlock - 1) / vkgr::kBlock;
  traverse_bvh2_split_kernel<<<grid, vkgr::kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      nodes_f, nodes_i, tris, rox, roy, roz, rdx, rdy, rdz, tmin, tmax, n, out_t, out_rnode, out_row,
      out_u, out_v, overflow);
  return static_cast<int>(cudaGetLastError());
}
