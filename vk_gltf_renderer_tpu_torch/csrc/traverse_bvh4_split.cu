// BVH4 closest-hit traversal over the split tables (the packet4 walk), one
// ray per thread: the walk of traverse_bvh.cuh with kSidecar and kSplit.
//
// Replaces the TPU kernel traverse_packets4
// (vk_gltf_renderer_tpu/ops/pallas_traverse.py, body _traverse4_body),
// reached through VKGR_TRAVERSAL=packet4. Tables: nodes4_f [M,32] f32 (4
// child boxes in cols 0:24), nodes4_i [M,8] i32 (codes c0..c3, axes 4:7),
// tris [T+8,16] f32 (one world triangle per 64-byte row, BVH order). A leaf
// code -(first*16+count)-1 names tris rows first .. first+count-1; the walk
// writes the tris row of the hit and the wrapper resolves it to (render
// node, triangle id) through wtri_rnode / wtri_tri, as the reference does
// after its launch. Closest hit only: the reference's kernel has no any-hit
// mode, and the port adds none.
//
// On the TPU one packet of 1024 rays shares a scalar stack in SMEM and
// votes its near order; here each ray walks alone with a 64-entry stack in
// local memory and its own direction signs (only equal-t ties differ). A
// visit reads the 96 box bytes of a nodes4_f row and one 32-byte nodes4_i
// row, as the v7 walk does; a leaf reads up to 8 rows of 64 bytes that
// need not start on a 128-byte line. What bounds it on the card is the
// latency of those dependent row loads, not their bytes (PERF.md §6). A
// missing child (code -1, inverted box) is not pushed (traverse_bvh.cuh).

#include "traverse_bvh.cuh"

namespace {

constexpr int kStackSplit4 = 64;  // ops/traverse.STACK_DEPTH_SPLIT4

__global__ void __launch_bounds__(vkgr::kBlock)
traverse_bvh4_split_kernel(const float* __restrict__ nodes4_f, const int* __restrict__ nodes4_i,
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
  unsigned int dropped = 0;
  const vkgr::Hit h = vkgr::walk<2, kStackSplit4, true, true>(nodes4_f, nodes4_i, tris, 0, r,
                                                              tmax[i], false, dropped);
  out_t[i] = h.t;
  out_rnode[i] = -1;  // resolved from the row by the caller
  out_row[i] = static_cast<int>(h.tri);
  out_u[i] = h.u;
  out_v[i] = h.v;
  if (dropped) atomicAdd(overflow, dropped);
}

}  // namespace

extern "C" int vkgr_traverse_bvh4_split(const float* nodes4_f, const int* nodes4_i,
                                        const float* tris, const float* rox, const float* roy,
                                        const float* roz, const float* rdx, const float* rdy,
                                        const float* rdz, const float* tmin, const float* tmax,
                                        int n, float* out_t, int* out_rnode, int* out_row,
                                        float* out_u, float* out_v, unsigned int* overflow,
                                        void* stream) {
  if (n <= 0) return 0;
  const int grid = (n + vkgr::kBlock - 1) / vkgr::kBlock;
  traverse_bvh4_split_kernel<<<grid, vkgr::kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      nodes4_f, nodes4_i, tris, rox, roy, roz, rdx, rdy, rdz, tmin, tmax, n, out_t, out_rnode,
      out_row, out_u, out_v, overflow);
  return static_cast<int>(cudaGetLastError());
}
