// BVH4 closest-hit / any-hit traversal that pops several stack entries
// per step (the v5 schedule), one ray per thread over nodes4_fi + tris128.
//
// Replaces the TPU kernel traverse_packets5 (_traverse5_body) of
// vk_gltf_renderer_tpu/ops/pallas_traverse.py. There the packet pops up to
// four entries, fetches a node row AND a leaf row for each (one of the two
// is wasted) and runs both the slab and the triangle tests masked, because
// Mosaic cannot overlap scalar latency across a lax.cond. Here each ray
// pops up to kMultipop = 4 entries, and the sign of each code says which
// row it needs, so nothing is fetched speculatively: before using any of
// them it prefetches every popped entry's row into L1 (the 128-byte
// nodes4_fi row of an internal code, the lines of the tris128 row that a
// leaf's triangle count reads). Then it processes them in pop order with
// t_best chained through the group, each internal entry pushing its
// children as it is processed (the reference's order). Hits equal the
// single-pop walk's except for equal-t ties: every entry that is popped
// was on the stack, so nothing is skipped.
//
// What bounds it: the latency of dependent row loads (an L2-cold run of
// the BVH4 walk read within 1-11% of a warm one). The point of the group
// is to keep up to four independent row loads in flight per thread where
// the single-pop walk has one. The price is order: the second to fourth
// entries of a group are tested against a t_best that the first one's
// subtree has not yet shrunk, and the stack holds more entries (up to
// kStack = 256 here; bvh_flatten.multipop_stack_need gives a tree's need,
// which the dispatch checks). Dropped pushes are counted.

#include "traverse_bvh.cuh"

namespace vkgr {

constexpr int kMultipop = 4;
constexpr int kStackMultipop = 256;

__global__ void __launch_bounds__(kBlock)
traverse_bvh4_multipop_kernel(const float* __restrict__ nodes4_fi,
                              const float* __restrict__ tris128, int root_code,
                              const float* __restrict__ rox, const float* __restrict__ roy,
                              const float* __restrict__ roz, const float* __restrict__ rdx,
                              const float* __restrict__ rdy, const float* __restrict__ rdz,
                              const float* __restrict__ tmin, const float* __restrict__ tmax,
                              int n, int anyhit, float* __restrict__ out_t,
                              int* __restrict__ out_rnode, int* __restrict__ out_tri,
                              float* __restrict__ out_u, float* __restrict__ out_v,
                              unsigned int* __restrict__ overflow) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(i, rox, roy, roz, rdx, rdy, rdz, tmin);
  Hit h{tmax[i], -1.0f, -1.0f, 0.0f, 0.0f};
  unsigned int dropped = 0;
  int stack[kStackMultipop];
  stack[0] = root_code;
  int sp = 1;
  bool done = false;
  auto push = [&](int code) {
    if (sp < kStackMultipop) {
      stack[sp++] = code;
    } else {
      ++dropped;
    }
  };

  while (sp > 0 && !done) {
    const int k = sp < kMultipop ? sp : kMultipop;
    int group[kMultipop];
#pragma unroll
    for (int j = 0; j < kMultipop; ++j) {
      group[j] = j < k ? stack[sp - 1 - j] : 0;
      if (j < k) {
        if (group[j] < 0) {
          prefetch_leaf(tris128, group[j]);
        } else {
          prefetch_l1(nodes4_fi + static_cast<size_t>(group[j]) * 32);
        }
      }
    }
    sp -= k;
#pragma unroll
    for (int j = 0; j < kMultipop; ++j) {
      if (j < k && !done) {
        if (group[j] < 0) {
          done = test_leaf(tris128, group[j], r, anyhit != 0, h);
        } else {
          expand_node<2, false>(nodes4_fi, nullptr, group[j], r, h.t, push);
        }
      }
    }
  }

  store_hit(i, h, out_t, out_rnode, out_tri, out_u, out_v);
  if (dropped) atomicAdd(overflow, dropped);
}

}  // namespace vkgr

extern "C" int vkgr_traverse_bvh4_multipop(const float* nodes4_fi, const float* tris128,
                                           int root_code, const float* rox, const float* roy,
                                           const float* roz, const float* rdx, const float* rdy,
                                           const float* rdz, const float* tmin, const float* tmax,
                                           int n, int anyhit, float* out_t, int* out_rnode,
                                           int* out_tri, float* out_u, float* out_v,
                                           unsigned int* overflow, void* stream) {
  if (n <= 0) return 0;
  const int grid = (n + vkgr::kBlock - 1) / vkgr::kBlock;
  vkgr::traverse_bvh4_multipop_kernel<<<grid, vkgr::kBlock, 0,
                                        static_cast<cudaStream_t>(stream)>>>(
      nodes4_fi, tris128, root_code, rox, roy, roz, rdx, rdy, rdz, tmin, tmax, n, anyhit, out_t,
      out_rnode, out_tri, out_u, out_v, overflow);
  return static_cast<int>(cudaGetLastError());
}
