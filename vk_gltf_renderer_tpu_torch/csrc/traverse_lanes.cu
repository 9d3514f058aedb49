// Stackless skip-pointer traversal of the lane entries, closest hit and
// any hit, redesigned for the H100: live-lane compaction, persistent
// warps, whole-entry loads and any-hit as a template parameter.
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
// (convert.lane_entries): one 64-byte row per entry. Fields of an entry:
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
// What bounds it on the card, and what each design element does about it
// (bvh4_tuning.py measures each one toggled; PERF.md keeps the numbers):
//  - Dead lanes and divergence: live-lane compaction and a persistent grid
//    (live_lanes.cuh). A lane is dead where !(tmax >= 0), whatever the
//    root: a negative tmax starts at the end, and a NaN tmax can neither
//    enter a box (the slab test caps tfar at NaN) nor accept a triangle
//    (t < NaN is false), so both return (tmax, -1, -1, 0, 0), as the plain
//    version does (tests/test_torch_traverse.py holds it to that).
//  - Walk length in dependent loads. Without a stack or near-first order a
//    closest-hit ray visits every box its segment [0, t_best] crosses in
//    tree order, ~130 entries a terrain ray, each one dependent load of a
//    64-byte row; the entry table (79 MB on the 1M-triangle terrain) is
//    past the 50 MB L2. One load round reads kWindow = 1 entry, its
//    64-byte row as 4 float4s. A box hit steps to cur + 1 and a leaf run
//    to s + 1, so most steps read the entry right after the last, and a
//    window of 2 entries (the aligned 128-byte line, the walk stepping on
//    from registers while the next entry is the second) halves the rounds;
//    but its 13 extra registers cut the resident warps by a fifth, and it
//    measured 8-20% slower (bvh4_tuning.py; PERF.md), so the walk is
//    bound by the loads in flight, not by one ray's chain. The plain
//    version's stats count the rounds each window size would need (1, 2,
//    4 and 8).
//  - Any-hit is a template parameter, both instances behind the one entry
//    point.
// A link that does not advance (a malformed table) ends the ray and is
// counted in *bad, which the wrapper exposes and must read 0.

#include "live_lanes.cuh"
#include "traverse_bvh.cuh"

namespace vkgr {
namespace lanes {

constexpr int kFields = 16;
constexpr int kWindow = 1;  // entries one load round reads

template <bool kAny>
__global__ void __launch_bounds__(kBlock)
walk_kernel(const float* __restrict__ entries, int n_entries, const float* __restrict__ rox,
            const float* __restrict__ roy, const float* __restrict__ roz,
            const float* __restrict__ rdx, const float* __restrict__ rdy,
            const float* __restrict__ rdz, const float* __restrict__ tmin,
            const float* __restrict__ tmax, float* __restrict__ out_t,
            int* __restrict__ out_rnode, int* __restrict__ out_tri, float* __restrict__ out_u,
            float* __restrict__ out_v, unsigned int* __restrict__ bad, int* __restrict__ header,
            const int* __restrict__ list) {
  const int end = n_entries;
  unsigned int stuck = 0;
  walk_list<1>(header, list, [&](int i) {
    const Ray r = load_ray(i, rox, roy, roz, rdx, rdy, rdz, tmin);
    Hit h{tmax[i], -1.0f, -1.0f, 0.0f, 0.0f};
    int cur = h.t < 0.0f ? end : 0;
    while (cur < end) {
      // one load round: entry cur; a = f0..3, b = f4..7, c = f8..11, d = f12..15
      const float4* ep = reinterpret_cast<const float4*>(entries + static_cast<size_t>(cur) * kFields);
      const float4 a = __ldg(ep), b = __ldg(ep + 1), c = __ldg(ep + 2), d = __ldg(ep + 3);
      const int link = static_cast<int>(c.y);  // f9: skip (internal) / next (triangle)
      int nxt;
      if (c.w > 0.5f) {  // f11: triangle entry
        float uu, vv, tt;
        const bool hit = triangle(a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, r, h.t, uu, vv, tt);
        if (hit) {
          h.t = tt;
          h.rn = d.x;
          h.tri = d.y;
          h.u = uu;
          h.v = vv;
        }
        nxt = (kAny && hit) ? end : link;
      } else {
        nxt = slab(a.x, a.y, a.z, a.w, b.x, b.y, r, h.t) ? cur + 1 : link;
      }
      if (nxt <= cur) {
        ++stuck;
        nxt = end;
      }
      cur = nxt;
    }
    store_hit(i, h, out_t, out_rnode, out_tri, out_u, out_v);
  });
  if (stuck) atomicAdd(bad, stuck);
}

template <bool kAny>
int launch(const float* entries, int n_entries, const float* rox, const float* roy,
           const float* roz, const float* rdx, const float* rdy, const float* rdz,
           const float* tmin, const float* tmax, int n, float* out_t, int* out_rnode,
           int* out_tri, float* out_u, float* out_v, unsigned int* bad, int* scratch,
           cudaStream_t stream) {
  // root 0: a lane walk has no leaf-root exception to the dead-lane rule
  const int rc = begin_list(tmin, tmax, n, 0, out_t, out_rnode, out_tri, out_u, out_v, scratch,
                            stream);
  if (rc != 0) return rc;
  static int per_device[64];
  int grid = 0;
  const int rg = persistent_grid(walk_kernel<kAny>, per_device, n, &grid);
  if (rg != 0) return rg;
  walk_kernel<kAny><<<grid, kBlock, 0, stream>>>(entries, n_entries, rox, roy, roz, rdx, rdy, rdz,
                                                 tmin, tmax, out_t, out_rnode, out_tri, out_u,
                                                 out_v, bad, scratch, scratch + kScratchHeader);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lanes
}  // namespace vkgr

// scratch: kScratchHeader + n int32 (the wrapper's scratch_words(n)); its
// live count and work cursor are zeroed here on the stream.
extern "C" int vkgr_traverse_lanes(const float* entries, int n_entries, const float* rox,
                                   const float* roy, const float* roz, const float* rdx,
                                   const float* rdy, const float* rdz, const float* tmin,
                                   const float* tmax, int n, int anyhit, float* out_t,
                                   int* out_rnode, int* out_tri, float* out_u, float* out_v,
                                   unsigned int* bad, int* scratch, void* stream) {
  using namespace vkgr::lanes;
  if (n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (anyhit) {
    return launch<true>(entries, n_entries, rox, roy, roz, rdx, rdy, rdz, tmin, tmax, n, out_t,
                        out_rnode, out_tri, out_u, out_v, bad, scratch, s);
  }
  return launch<false>(entries, n_entries, rox, roy, roz, rdx, rdy, rdz, tmin, tmax, n, out_t,
                       out_rnode, out_tri, out_u, out_v, bad, scratch, s);
}
