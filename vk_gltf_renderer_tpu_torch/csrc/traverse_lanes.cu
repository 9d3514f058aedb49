// Stackless skip-pointer traversal, one ray per thread, closest hit and
// any hit.
//
// Replaces the TPU kernels traverse_lanes (_lane_kernel_body) and
// traverse_lanes_stream (_lane_kernel_stream) of
// vk_gltf_renderer_tpu/ops/lane_traverse.py, the kernel values "lane" and
// "lane_stream". The tree is stored in DFS order with skip pointers: an
// internal entry whose box the ray hits steps to cur + 1 (its first
// child), a miss jumps to its skip pointer past the subtree, and a
// triangle entry (one triangle per entry, precomputed edges) is tested and
// then continues at its next pointer. Every ray's entry index only grows,
// so no stack is needed. Any accepted any hit jumps to the end; a ray with
// tmax < 0 starts at the end.
//
// The TPU kernels advance a lane only while its entry lies in the 128-entry
// page resident in VMEM (one min-reduction per page picks the next, and the
// stream variant DMAs that page from HBM). That is scheduling: each lane
// steps through the same sequence of entries as an independent walk, so
// both map to this one kernel and give identical results.
//
// Table: the reference's pages are field-major per page (entry e's field f
// at [(e >> 7) * 16 + f, e & 127], so one entry's 16 floats lie 512 bytes
// apart). The wrapper hands this kernel an entry-major [E,16] copy
// (convert.lane_entries): one 64-byte row per step, read as four 16-byte
// loads. Fields of an entry:
//   internal  lo.xyz hi.xyz 0 0 0  skip  0      0  0      0    0 0
//   triangle  v0.xyz e1.xyz e2.xyz next  triRow 1  rnode  tri  0 0
// with skip/next/rnode/tri exact f32 integers (< 2^24), decoded exactly.
// Order is the tree's DFS order, left child first, with no near-first
// ordering: equal-t ties resolve by tree order.
//
// Arithmetic carried over from _make_step: the slab test of the stack
// kernels and Moller-Trumbore on the stored edges e1/e2 (the stack kernels
// subtract v1 - v0 in the kernel), so its t/u/v can differ from theirs at
// the ulp level but match its plain version (ops/traverse.py
// traverse_lanes_plain) to the last bit or two.
//
// What bounds it on the card: dependent loads and walk length. Without a
// stack or near-first order a closest-hit ray visits every box its segment
// [0, t_best] crosses in tree order, so it takes more, cheaper steps than
// the stack kernels; each step is one 64-byte row, adjacent to the last
// on a hit. A link that does not advance (a malformed table) ends the ray
// and is counted in *bad, which the wrapper exposes and must read 0.

#include "traverse_bvh.cuh"

namespace {

constexpr int kFields = 16;

__global__ void __launch_bounds__(vkgr::kBlock)
traverse_lanes_kernel(const float* __restrict__ entries, int n_entries,
                      const float* __restrict__ rox, const float* __restrict__ roy,
                      const float* __restrict__ roz, const float* __restrict__ rdx,
                      const float* __restrict__ rdy, const float* __restrict__ rdz,
                      const float* __restrict__ tmin, const float* __restrict__ tmax, int n,
                      int anyhit, float* __restrict__ out_t, int* __restrict__ out_rnode,
                      int* __restrict__ out_tri, float* __restrict__ out_u,
                      float* __restrict__ out_v, unsigned int* __restrict__ bad) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  const vkgr::Ray r = vkgr::load_ray(i, rox, roy, roz, rdx, rdy, rdz, tmin);
  vkgr::Hit h{tmax[i], -1.0f, -1.0f, 0.0f, 0.0f};
  const int end = n_entries;
  int cur = h.t < 0.0f ? end : 0;
  unsigned int stuck = 0;

  while (cur < end) {
    const float4* ep = reinterpret_cast<const float4*>(entries + static_cast<size_t>(cur) * kFields);
    const float4 a = __ldg(ep), b = __ldg(ep + 1), c = __ldg(ep + 2), d = __ldg(ep + 3);
    // a = f0..3, b = f4..7, c = f8..11, d = f12..15
    const int link = static_cast<int>(c.y);  // f9: skip (internal) / next (triangle)
    int nxt;
    if (c.w > 0.5f) {  // f11: triangle entry
      float uu, vv, tt;
      const bool hit = vkgr::triangle(a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, r, h.t, uu, vv, tt);
      if (hit) {
        h.t = tt;
        h.rn = d.x;
        h.tri = d.y;
        h.u = uu;
        h.v = vv;
      }
      nxt = (anyhit && hit) ? end : link;
    } else {
      nxt = vkgr::slab(a.x, a.y, a.z, a.w, b.x, b.y, r, h.t) ? cur + 1 : link;
    }
    if (nxt <= cur) {
      ++stuck;
      break;
    }
    cur = nxt;
  }

  out_t[i] = h.t;
  out_rnode[i] = static_cast<int>(h.rn);
  out_tri[i] = static_cast<int>(h.tri);
  out_u[i] = h.u;
  out_v[i] = h.v;
  if (stuck) atomicAdd(bad, stuck);
}

}  // namespace

extern "C" int vkgr_traverse_lanes(const float* entries, int n_entries, const float* rox,
                                   const float* roy, const float* roz, const float* rdx,
                                   const float* rdy, const float* rdz, const float* tmin,
                                   const float* tmax, int n, int anyhit, float* out_t,
                                   int* out_rnode, int* out_tri, float* out_u, float* out_v,
                                   unsigned int* bad, void* stream) {
  if (n <= 0) return 0;
  const int grid = (n + vkgr::kBlock - 1) / vkgr::kBlock;
  traverse_lanes_kernel<<<grid, vkgr::kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      entries, n_entries, rox, roy, roz, rdx, rdy, rdz, tmin, tmax, n, anyhit, out_t, out_rnode,
      out_tri, out_u, out_v, bad);
  return static_cast<int>(cudaGetLastError());
}
